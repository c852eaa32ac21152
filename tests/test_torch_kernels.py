"""The port's ``layer_agg`` (plain version, which the wrapper takes for CPU
tensors) against the JAX package's oracle ``layer_agg_ref`` and its Pallas
kernel in interpret mode, on the same numpy inputs.

Tolerance: rtol=1e-5, atol=1e-6 — single float32 reductions whose order
differs between the einsum and the kernel's loop.
"""
import numpy as np
import pytest
import torch

from repro.kernels.layer_agg import layer_agg_op, layer_agg_ref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.layer_agg import layer_agg, layer_agg_plain

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(N, R, D, seed, zero_rows=(), alpha=False):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(N, R, D)).astype(np.float32)
    M = (rng.random((N, R)) > 0.3).astype(np.float32)
    if alpha:
        M = M * rng.uniform(0.2, 1.0, size=(N, 1)).astype(np.float32)
    for r in zero_rows:
        M[:, r] = 0.0                 # a row no client trained
    w = (rng.random(N) * 10 + 0.1).astype(np.float32)
    return U, M, w


@pytest.mark.parametrize("N,R,D,zero_rows", [
    (1, 3, 64, ()),                  # a single client
    (5, 7, 128, (0, 4)),             # rows whose denominator is 0
    (70, 4, 32, (2,)),               # more clients than the TPU tile held
    (9, 6, 1024, (1,)),              # the main path's D (seg = 1024)
    (3, 5, 100, ()),                 # ragged D
])
def test_layer_agg_plain_matches_jax(N, R, D, zero_rows):
    U, M, w = _inputs(N, R, D, seed=N * 100 + R, zero_rows=zero_rows)
    got = layer_agg(torch.tensor(U), torch.tensor(M), torch.tensor(w))
    ref = np.asarray(layer_agg_ref(U, M, w))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    pallas = np.asarray(layer_agg_op(U, M, w, block_d=32, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    for r in zero_rows:
        assert np.all(got.numpy()[r] == 0.0)


def test_layer_agg_alpha_masks_match_jax():
    U, M, w = _inputs(6, 5, 64, seed=3, alpha=True)
    got = layer_agg_plain(torch.tensor(U), torch.tensor(M), torch.tensor(w))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(layer_agg_ref(U, M, w)), **TOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    U, M, w = _inputs(4, 3, 16, seed=1)
    before = LAUNCHES["layer_agg"]
    layer_agg(torch.tensor(U), torch.tensor(M), torch.tensor(w))
    assert LAUNCHES["layer_agg"] == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_layer_agg_wrapper_rejects_bad_inputs(bad):
    U, M, w = (torch.tensor(a) for a in _inputs(4, 3, 16, seed=2))
    if bad == "dtype":
        U = U.double()
    elif bad == "shape":
        M = M[:, :2]
    else:
        U = U.transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        layer_agg(U, M, w)
