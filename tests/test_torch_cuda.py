"""The CUDA kernels (``layer_agg``, ``rmsnorm``, ``flash_attention``,
forward and backward) against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc``; they skip elsewhere.  This
file imports neither jax nor the JAX package, so it also runs where jax is
not installed (pass ``--noconftest``, since ``tests/conftest.py`` imports
jax):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, relative to the largest magnitude of the plain result:
``layer_agg`` 1e-5 (float32 sums over N in another order than the
einsum's); ``rmsnorm`` and ``flash_attention`` 2e-5 in float32 (the JAX
sweep's), 2e-2 in bfloat16, forward and backward (the backward's oracle
is autograd through the plain version).
"""
import importlib

import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention_bhsd)
from repro_torch.kernels.layer_agg import layer_agg, layer_agg_plain
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

torch.set_num_threads(1)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1.0)).item()


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


def _leaves(shapes, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dev, dtype).requires_grad_()
            for s in shapes]


def _fwd_bwd(fn, plain, inputs, seed):
    """Forward and gradients of fn and of plain on the same inputs and the
    same output cotangent; returns [(got, ref), ...]."""
    out = fn(*inputs)
    g = torch.Generator().manual_seed(seed + 1)
    w = torch.randn(out.shape, generator=g).to(out.device, out.dtype)
    got = torch.autograd.grad((out.float() * w.float()).sum(), inputs)
    ref_in = [t.detach().clone().requires_grad_() for t in inputs]
    ref_out = plain(*ref_in)
    ref = torch.autograd.grad((ref_out.float() * w.float()).sum(), ref_in)
    return [(out, ref_out)] + list(zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("G,R,d", [(16, 512, 128), (1, 7, 64), (3, 11, 100),
                                   (2, 5, 8192), (4, 33, 40)])
def test_rmsnorm_forward_backward_match_plain(cuda, G, R, d, dtype):
    x, s = _leaves([(G, R, d), (G, d)], dtype, cuda, seed=G + R + d)
    pairs = _fwd_bwd(rmsnorm, rmsnorm_plain, [x, s], seed=d)
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert _rel_err(got, ref) <= TOL[dtype]


# (BH, BHkv, Sq, Sk, D, causal, window): the transformer path's shape,
# GQA, a window, D = 128, non-causal, the set mixer's rectangle, rows that
# see no key, odd sizes
ATTN = [(256, 256, 32, 32, 32, True, 0), (8, 4, 128, 128, 64, True, 0),
        (8, 1, 256, 256, 32, True, 0), (4, 4, 128, 128, 128, True, 32),
        (4, 4, 64, 64, 64, False, 0), (2, 2, 4, 4096, 32, False, 0),
        (2, 1, 40, 24, 16, True, 5), (3, 3, 33, 17, 20, False, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ATTN)
def test_flash_attention_forward_backward_match_plain(cuda, case, dtype):
    BH, BHkv, Sq, Sk, D, causal, window = case
    q, k, v = _leaves([(BH, Sq, D), (BHkv, Sk, D), (BHkv, Sk, D)], dtype,
                      cuda, seed=Sq + Sk + D)

    def fn(a, b, c):
        return flash_attention_bhsd(a, b, c, causal=causal, window=window)

    def plain(a, b, c):
        return attention_plain(a, b, c, causal=causal, window=window)
    pairs = _fwd_bwd(fn, plain, [q, k, v], seed=D)
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert torch.isfinite(got.float()).all()
        assert _rel_err(got, ref) <= TOL[dtype]


def _rmsnorm_call(dev):
    x, s = _leaves([(2, 3, 64), (2, 64)], torch.float32, dev, seed=0)
    return rmsnorm(x, s)


def _attention_call(dev):
    q, k, v = _leaves([(2, 8, 16)] * 3, torch.float32, dev, seed=0)
    return flash_attention_bhsd(q, k, v)


def _layer_agg_call(dev):
    return layer_agg(*_inputs(2, 3, 64, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("name,call", [
    ("rmsnorm", _rmsnorm_call), ("flash_attention", _attention_call),
    ("layer_agg", _layer_agg_call)], ids=["rmsnorm", "flash_attention",
                                          "layer_agg"])
def test_failed_build_raises_and_never_falls_back(cuda, name, call,
                                                  monkeypatch):
    def broken(lib_name, sources):
        raise RuntimeError(f"nvcc failed for {lib_name}")
    module = importlib.import_module(f"repro_torch.kernels.{name}.{name}")
    monkeypatch.setattr(module, "_LIB", None)
    monkeypatch.setattr(kbuild, "build_library", broken)
    before = dict(LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        call(cuda)
    assert LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("call,fwd_key", [
    (_rmsnorm_call, "rmsnorm"), (_attention_call, "flash_attention")],
    ids=["rmsnorm", "flash_attention"])
def test_launch_counts_move_only_on_a_launch(cuda, call, fwd_key):
    bwd_key = fwd_key + "_bwd"
    before = dict(LAUNCHES)
    call(torch.device("cpu")).sum().backward()      # plain versions
    assert LAUNCHES == before
    out = call(cuda)
    torch.cuda.synchronize()
    assert LAUNCHES[fwd_key] == before[fwd_key] + 1
    assert LAUNCHES[bwd_key] == before[bwd_key]
    out.sum().backward()
    torch.cuda.synchronize()
    assert LAUNCHES[fwd_key] == before[fwd_key] + 1
    assert LAUNCHES[bwd_key] == before[bwd_key] + 1
    with torch.no_grad():
        call(cuda)
    assert LAUNCHES[fwd_key] == before[fwd_key] + 2
    assert LAUNCHES[bwd_key] == before[bwd_key] + 1
