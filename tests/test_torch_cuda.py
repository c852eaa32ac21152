"""The ``layer_agg`` CUDA kernel against its plain version, on the card.

These tests need an NVIDIA card and ``nvcc``; they skip elsewhere.  This
file imports neither jax nor the JAX package, so it also runs where jax is
not installed (pass ``--noconftest``, since ``tests/conftest.py`` imports
jax):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 relative to the largest output magnitude — float32 sums
over N in another order than the einsum's.
"""
import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.layer_agg import layer_agg, layer_agg_plain

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def _inputs(N, R, D, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    U = torch.randn((N, R, D), generator=g)
    M = (torch.rand((N, R), generator=g) > 0.3).float()
    M[:, 0] = 0.0                                  # an untrained row
    w = torch.rand((N,), generator=g) * 10 + 0.1
    return U.to(dev), M.to(dev), w.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("N,R,D", [(1, 5, 1024), (9, 64, 1024),
                                   (300, 7, 256), (5, 9, 1000), (3, 4, 3000)])
def test_kernel_matches_plain(cuda, N, R, D):
    U, M, w = _inputs(N, R, D, cuda)
    before = LAUNCHES["layer_agg"]
    got = layer_agg(U, M, w)
    torch.cuda.synchronize()
    assert LAUNCHES["layer_agg"] == before + 1
    ref = layer_agg_plain(U, M, w)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * max(ref.abs().max().item(), 1.0), err
    assert torch.all(got[0] == 0)


@pytest.mark.cuda
def test_kernel_rejects_mixed_devices(cuda):
    U, M, w = _inputs(2, 3, 64, cuda)
    with pytest.raises(ValueError):
        layer_agg(U, M.cpu(), w)
