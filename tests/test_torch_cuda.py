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
is autograd through the plain version).  The ``rmsnorm`` backward is also
held against its CPU emulation (``rmsnorm_bwd_blocked``, the kernel's
order of sums) at 1e-6, and against itself bitwise; so are
``flash_attention``'s short-query kernels (``attention_split_blocked``
and ``attention_split_blocked_bwd``), forward and backward (1e-2 in
bfloat16, where the two may round an output to either side of a
bfloat16 tie).  The wgmma route's kernels (bf16, causal) are held against
the plain version at 2e-2 and against their CPU emulation of the route's
rounding (``attention_wgmma_blocked`` and ``_bwd``) at 1e-2: the
tensor cores sum in their own order, and a P or dS that lands on the
other side of a bf16 rounding moves an output by about its spacing.
"""
import importlib

import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention import (
    attention_plain, attention_plain_model, attention_route,
    attention_split_blocked, attention_split_blocked_bwd,
    attention_wgmma_blocked, attention_wgmma_blocked_bwd, flash_attention,
    flash_attention_bhsd, fused_backward)
from repro_torch.kernels.layer_agg import layer_agg, layer_agg_plain
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd_blocked,
                                         rmsnorm_op, rmsnorm_plain,
                                         rmsnorm_route)

fa_mod = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")

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


RMS_SHAPES = [(16, 512, 128), (1, 7, 64), (3, 11, 100), (2, 5, 8192),
              (4, 33, 40), (1, 1024, 128), (1, 1, 128), (5, 1, 64)]


def _rms_inputs(G, R, d, dtype, dev, placement, seed):
    """x [G, R, d] (times 3), scale [G, d] and dy on the card; ``offset``
    puts x one element past the 16-byte grid (a contiguous view that
    starts one element into its storage)."""
    g = torch.Generator().manual_seed(seed)
    flat = (torch.randn((G * R * d + 1,), generator=g) * 3).to(dev, dtype)
    lo = 1 if placement == "offset" else 0
    x = flat[lo:lo + G * R * d].view(G, R, d)
    s = torch.randn((G, d), generator=g).to(dev, dtype)
    dy = torch.randn((G, R, d), generator=g).to(dev, dtype)
    return x, s, dy


def _rms_route(x, s, extra=()):
    G, R, d = x.shape
    return rmsnorm_route(G, R, d, x.dtype, [x.data_ptr(), s.data_ptr(),
                                            *extra],
                         torch.cuda.get_device_properties(
                             x.device).multi_processor_count)


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["aligned", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("G,R,d", RMS_SHAPES)
def test_rmsnorm_routes_match_plain(cuda, G, R, d, dtype, placement):
    """Each route, forward and backward, against the plain version; the
    route counters move by one each way, on the route the shape and the
    pointers pick (offset x: the general route)."""
    x, s, dy = _rms_inputs(G, R, d, dtype, cuda, placement, seed=G + R + d)
    route, _ = _rms_route(x, s)
    assert route == ("vec" if placement == "aligned" and d <= 1024 and
                     d % (16 // x.element_size()) == 0 else "general")
    x.requires_grad_()
    s.requires_grad_()
    before = dict(LAUNCHES)
    out = rmsnorm(x, s)
    got = torch.autograd.grad(out, [x, s], dy)
    torch.cuda.synchronize()
    for key in ("rmsnorm", f"rmsnorm_{route}", "rmsnorm_bwd",
                f"rmsnorm_bwd_{route}"):
        assert LAUNCHES[key] == before[key] + 1, key
    assert sum(LAUNCHES[k] - before[k] for k in LAUNCHES) == 4
    ref_in = [t.detach().clone().requires_grad_() for t in (x, s)]
    ref_out = rmsnorm_plain(*ref_in)
    ref = torch.autograd.grad(ref_out, ref_in, dy)
    for a, b in [(out, ref_out), *zip(got, ref)]:
        assert torch.isfinite(a.float()).all()
        assert _rel_err(a, b) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["aligned", "offset"])
@pytest.mark.parametrize("G,R,d,dtype", [
    (1, 1024, 128, torch.float32), (16, 1024, 128, torch.float32),
    (16, 32, 128, torch.float32), (3, 37, 100, torch.float32),
    (2, 5, 8192, torch.float32), (16, 1024, 128, torch.bfloat16),
    (2, 1, 64, torch.float32)])
def test_rmsnorm_backward_is_deterministic_and_matches_blocked(
        cuda, G, R, d, dtype, placement):
    """No float atomics: two backward calls give the same bits, and they
    agree with the CPU emulation of the kernel's order of sums at 1e-6 of
    the largest magnitude."""
    rmsnorm_mod = importlib.import_module(
        "repro_torch.kernels.rmsnorm.rmsnorm")
    x, s, dy = _rms_inputs(G, R, d, dtype, cuda, placement, seed=d + R)
    rstd = torch.rsqrt(torch.mean(x.float() ** 2, dim=-1) + 1e-5)
    runs = [rmsnorm_mod._backward(x, s, dy, rstd) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    route, splits = _rms_route(x, s, [dy.data_ptr()])
    emu = rmsnorm_bwd_blocked(x.cpu(), s.cpu(), dy.cpu(), rstd.cpu(), route,
                              splits)
    for a, b in zip(runs[0], emu):
        assert _rel_err(a.cpu(), b) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["aligned", "offset"])
def test_rmsnorm_backward_is_one_launch(cuda, placement):
    """The backward runs one kernel on the card: no second pass, no memset
    (a warm call first: the tickets are made, zeroed, at first use)."""
    from torch.profiler import ProfilerActivity, profile
    x, s, dy = _rms_inputs(1, 1024, 128, torch.float32, cuda, placement, 5)
    x.requires_grad_()
    s.requires_grad_()
    out = rmsnorm(x, s)
    torch.autograd.grad(out, [x, s], dy, retain_graph=True)
    torch.cuda.synchronize()
    for _ in range(3):              # a read with no device activity retries
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(out, [x, s], dy, retain_graph=True)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert len(set(names)) == 1 and "rmsnorm_bwd" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("lo", [0, 1, 2])
def test_rmsnorm_op_on_unaligned_views(cuda, lo):
    """The model layout on a contiguous view ``lo`` elements into its
    storage: 1 and 2 are off the 16-byte grid and take the general
    route; the result is the plain version's."""
    B, S, d = 4, 32, 128
    g = torch.Generator().manual_seed(lo)
    flat = torch.randn((B * S * d + 2,), generator=g).to(cuda)
    x = flat[lo:lo + B * S * d].view(B, S, d).requires_grad_()
    s = torch.randn((d,), generator=g).to(cuda).requires_grad_()
    before = dict(LAUNCHES)
    out = rmsnorm_op(x, s)
    w = torch.randn(out.shape, generator=g).to(cuda)
    got = torch.autograd.grad(out, [x, s], w)
    torch.cuda.synchronize()
    route = "vec" if lo == 0 else "general"
    assert LAUNCHES[f"rmsnorm_{route}"] == before[f"rmsnorm_{route}"] + 1
    assert LAUNCHES[f"rmsnorm_bwd_{route}"] == \
        before[f"rmsnorm_bwd_{route}"] + 1
    ref_in = [t.detach().clone().requires_grad_() for t in (x, s)]
    ref_out = rmsnorm_plain(*ref_in)
    ref = torch.autograd.grad(ref_out, ref_in, w)
    for a, b in [(out, ref_out), *zip(got, ref)]:
        assert _rel_err(a, b) <= TOL[torch.float32]


# (BH, BHkv, Sq, Sk, D, causal, window): the transformer path's shape,
# GQA, a window, D = 128, non-causal, the set mixer's rectangle, rows that
# see no key, odd sizes; then the fused backward's length limit and one
# past it (three passes) at D 32, 64 and 128, and a GQA group with a
# window and a GQA rectangle inside the fused range
ATTN = [(256, 256, 32, 32, 32, True, 0), (8, 4, 128, 128, 64, True, 0),
        (8, 1, 256, 256, 32, True, 0), (4, 4, 128, 128, 128, True, 32),
        (4, 4, 64, 64, 64, False, 0), (2, 2, 4, 4096, 32, False, 0),
        (2, 1, 40, 24, 16, True, 5), (3, 3, 33, 17, 20, False, 3),
        (4, 4, 64, 64, 32, True, 0), (4, 4, 65, 65, 32, True, 0),
        (4, 4, 64, 64, 64, True, 0), (4, 4, 65, 65, 64, True, 0),
        (4, 4, 32, 32, 128, True, 0), (4, 4, 33, 33, 128, True, 0),
        (8, 2, 48, 48, 64, True, 16), (6, 2, 24, 40, 32, False, 0)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(256, 256, 32, 32, 32, True, 0),
                                  (8, 2, 48, 48, 64, True, 16),
                                  (4, 4, 65, 65, 32, True, 0)],
                         ids=["path", "gqa-window", "three-pass"])
def test_flash_attention_backward_is_deterministic(cuda, case):
    """No atomics: two backward runs give the same bits."""
    BH, BHkv, Sq, Sk, D, causal, window = case
    q, k, v = _leaves([(BH, Sq, D), (BHkv, Sk, D), (BHkv, Sk, D)],
                      torch.float32, cuda, seed=D)
    do = torch.randn((BH, Sq, D), generator=torch.Generator().manual_seed(1)
                     ).to(cuda)
    out = flash_attention_bhsd(q, k, v, causal=causal, window=window)
    runs = [torch.autograd.grad(out, [q, k, v], do, retain_graph=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _model_view(shape, how, dev, seed):
    """A [B, S, H, D] tensor on the card: contiguous (what the model hands
    over), a transpose of heads-first storage, a slice of a wider tensor,
    or one that starts one element in (off the 16-byte grid: the kernels'
    element-wise path)."""
    B, S, H, D = shape
    g = torch.Generator().manual_seed(seed)
    if how == "contiguous":
        return torch.randn(shape, generator=g).to(dev)
    if how == "transpose":
        return torch.randn((B, H, S, D), generator=g).to(dev).transpose(1, 2)
    lo = 0 if how == "wide-slice" else 1
    wide = torch.randn((B, S, H, 2 * D + 1), generator=g).to(dev)
    return wide[..., lo:lo + D]


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["contiguous", "transpose", "wide-slice",
                                 "offset-slice"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", [
    (16, 32, 32, 4, 4, 32, True, 0), (2, 80, 80, 4, 2, 64, True, 0),
    (2, 24, 40, 6, 2, 32, False, 0)], ids=["path", "three-pass", "gqa-rect"])
def test_flash_attention_model_layout_views_without_copies(
        cuda, how, B, Sq, Sk, Hq, Hkv, D, causal, window, monkeypatch):
    """The kernels receive the caller's tensors (their data pointers),
    and o and the gradients come back like their inputs."""
    seen = {}

    def recording(fn, device, *args):
        seen[fn.__name__] = args
        return launch(fn, device, *args)
    launch = kbuild.launch
    monkeypatch.setattr(kbuild, "launch", recording)
    q, k, v = (_model_view(s, how, cuda, seed=i).requires_grad_()
               for i, s in enumerate(((B, Sq, Hq, D), (B, Sk, Hkv, D),
                                      (B, Sk, Hkv, D))))
    assert q.is_contiguous() == (how == "contiguous")
    before = dict(LAUNCHES)
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.shape == (B, Sq, Hq, D) and out.stride(-1) == 1
    assert out.stride() == (q.stride() if how in ("contiguous", "transpose")
                            else out.contiguous().stride())
    assert list(seen["flash_attention_fwd_launch"][:4]) == [
        t.data_ptr() for t in (q, k, v, out)]
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(9)
                    ).to(cuda)
    got = torch.autograd.grad(out, [q, k, v], w)
    torch.cuda.synchronize()
    route = "fused" if fused_backward(Sq, Sk, D) else "three_pass"
    args = seen["flash_attention_bwd_fused_launch" if route == "fused"
                else "flash_attention_bwd_launch"]
    skip = 6 if route == "fused" else 7         # lse, and delta's workspace
    assert list(args[:4]) + list(args[skip:skip + 3]) == [
        t.data_ptr() for t in (q, k, v, out, *got)]
    assert LAUNCHES[f"flash_attention_bwd_{route}"] == \
        before[f"flash_attention_bwd_{route}"] + 1
    for t, g_ in zip((q, k, v), got):
        assert g_.stride(-1) == 1 and g_.shape == t.shape

    ref_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref_out = attention_plain_model(*ref_in, causal=causal, window=window)
    ref = torch.autograd.grad(ref_out, ref_in, w)
    assert _rel_err(out, ref_out) <= TOL[torch.float32]
    for g_, r in zip(got, ref):
        assert torch.isfinite(g_).all()
        assert _rel_err(g_, r) <= TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,D,fused", [
    (32, 32, 32, True), (64, 64, 32, True), (65, 65, 32, False),
    (64, 64, 64, True), (65, 64, 64, False), (32, 32, 128, True),
    (33, 33, 128, False), (4, 4096, 32, False), (1, 1, 8, True)])
def test_backward_route_depends_on_shape_alone(cuda, Sq, Sk, D, fused):
    assert fused_backward(Sq, Sk, D) is fused


# the short-query route (fwd_split.cu, bwd_short.cu): (BH, BHkv, Sq, Sk, D,
# causal, window).  The set mixer's shapes (BH 208 with Sk 1024 and 300;
# BH 12 with Sk 4096), then the edges: Sq 1 and 8; Sk one below, at and
# one above a split of 128 keys (D 32); GQA 4:1 and 8:1; D 64 and 128
# (splits of 64 and 32 keys); causal rows whose splits past the first are
# all masked; window rows that see no key (the plain mean of v); D 20 off
# the 16-byte copies
SHORT = [(208, 208, 4, 1024, 32, False, 0), (208, 208, 4, 300, 32, False, 0),
         (12, 12, 4, 4096, 32, False, 0), (16, 16, 1, 1000, 32, False, 0),
         (16, 16, 8, 129, 32, False, 0), (16, 16, 4, 127, 32, False, 0),
         (16, 16, 4, 128, 32, False, 0), (16, 4, 4, 300, 32, False, 0),
         (16, 2, 3, 257, 64, True, 0), (8, 8, 8, 200, 128, True, 0),
         (8, 2, 8, 33, 128, False, 0), (8, 8, 8, 300, 32, True, 4),
         (6, 3, 8, 5, 16, True, 2), (6, 6, 7, 3, 32, False, 2),
         (4, 4, 5, 150, 20, False, 0)]
SHORT_IDS = ["set-mixer", "set-mixer-ragged", "set-mixer-1M", "sq1",
             "sq8-split+1", "split-1", "split", "gqa4", "gqa8-causal-d64",
             "causal-d128", "gqa4-d128", "causal-window", "keyless-causal",
             "keyless-window", "d20"]


@pytest.fixture
def short_route(monkeypatch):
    """Every shape within the short route's row limits takes it, whatever
    its Sk (the cases with rows that see no key, Sk < 8, and the GQA D 128
    case, Sk 33, are below ``SHORT_MIN_SK``)."""
    monkeypatch.setattr(fa_mod, "SHORT_MIN_SK", 1)


def _short_launch(q, k, v, do, causal, window):
    """The short route's forward and backward launched directly on [BH, S,
    D] tensors (their model-layout views, as flash_attention_bhsd hands
    them over): o, lse, dq, dk, dv."""
    BH, BHkv = q.shape[0], k.shape[0]

    def model(t, heads):
        return t.unflatten(0, (BHkv, heads)).transpose(1, 2)
    qm, km, vm, dom = (model(q, BH // BHkv), model(k, 1), model(v, 1),
                       model(do, BH // BHkv))
    om, dqm, dkm, dvm = (torch.empty_like(t) for t in (qm, qm, km, vm))
    lse = fa_mod._forward(qm, km, vm, om, causal, window)
    fa_mod._backward(qm, km, vm, om, dom, lse, dqm, dkm, dvm, causal,
                     window)

    def bhsd(t):
        return t.transpose(1, 2).flatten(0, 1)
    return [bhsd(om), lse] + [bhsd(t) for t in (dqm, dkm, dvm)]


def _short_inputs(case, dtype, dev):
    BH, BHkv, Sq, Sk, D, causal, window = case
    q, k, v, do = (t.detach() for t in _leaves(
        [(BH, Sq, D), (BHkv, Sk, D), (BHkv, Sk, D), (BH, Sq, D)], dtype,
        "cpu", seed=BH + Sq + Sk + D))
    if D == 32:                     # the set mixer's slot -1
        q[..., -1] = 32 ** 0.5
        k[..., -1] = torch.randn((BHkv, Sk), generator=torch.Generator()
                                 .manual_seed(Sk)).to(dtype)
    return [t.to(dev) for t in (q, k, v, do)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SHORT, ids=SHORT_IDS)
def test_short_route_matches_blocked_emulation(cuda, short_route, case,
                                               dtype):
    """Each launch counts under its route; o, lse, dq, dk and dv equal the
    CPU emulation of the kernels' order of sums at 1e-6 of the largest
    magnitude (rows that see no key: lse -1e30 on both), and the plain
    version at the kernels' tolerance."""
    BH, BHkv, Sq, Sk, D, causal, window = case
    route, split = attention_route(Sq, Sk, D, BH // BHkv)
    assert route == "short"
    q, k, v, do = _short_inputs(case, dtype, cuda)
    before = dict(LAUNCHES)
    got = _short_launch(q, k, v, do, causal, window)
    torch.cuda.synchronize()
    for key in ("flash_attention_fwd_split", "flash_attention_bwd_short"):
        assert LAUNCHES[key] == before[key] + 1
    cpu = [t.cpu() for t in (q, k, v)]
    o, lse = attention_split_blocked(*cpu, causal=causal, window=window,
                                     split=split)
    emu = [o, lse, *attention_split_blocked_bwd(
        *cpu, got[0].cpu(), do.cpu(), got[1].cpu(), causal=causal,
        window=window, split=split)]
    seen = lse > -1e29
    assert torch.equal(got[1].cpu()[~seen], lse[~seen])
    assert _rel_err(got[1].cpu()[seen], lse[seen]) <= 1e-6
    for a, b in zip(got[:1] + got[2:], emu[:1] + emu[2:]):
        assert torch.isfinite(a.float()).all()
        assert _rel_err(a.cpu(), b) <= (1e-6 if dtype == torch.float32
                                        else 1e-2)
    ins = [t.detach().clone().requires_grad_() for t in cpu]
    ref = attention_plain(*ins, causal=causal, window=window)
    refs = [ref, *torch.autograd.grad(ref, ins, do.cpu())]
    for a, b in zip(got[:1] + got[2:], refs):
        assert _rel_err(a.cpu(), b) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [SHORT[0], SHORT[2], SHORT[8], SHORT[12]],
                         ids=["set-mixer", "set-mixer-1M", "gqa8-causal-d64",
                              "keyless-causal"])
def test_short_route_is_deterministic(cuda, short_route, case):
    """No float atomics: two launches give the same bits in o, lse, dq,
    dk and dv (the tickets are back at zero after each)."""
    q, k, v, do = _short_inputs(case, torch.float32, cuda)
    runs = [_short_launch(q, k, v, do, *case[5:]) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert not fa_mod._tickets(cuda, 1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,D,group,route", [
    (4, 1024, 32, 1, "short"), (4, 4096, 32, 1, "short"),
    (8, 300, 128, 4, "short"), (32, 32, 32, 1, "tiled"),
    (9, 1024, 32, 1, "tiled"), (8, 1024, 32, 5, "tiled")])
def test_short_route_depends_on_shape_alone(cuda, Sq, Sk, D, group, route):
    """The set mixer's shapes take the short route, the transformer's
    (Sq 32) never; the kernels take the route's split and no other."""
    assert attention_route(Sq, Sk, D, group)[0] == route
    lib = fa_mod.load_library()[0]
    q, k, v = (torch.zeros(s, device=cuda) for s in
               ((1, 4, 1, 32), (1, 256, 1, 32), (1, 256, 1, 32)))
    o = torch.empty_like(q)
    lse = torch.empty((1, 4), device=cuda)
    part = torch.empty((4 * 1024,), device=cuda)
    tail = fa_mod._args(q, k, (q, k, v, o), False, 0)
    split = attention_route(4, 256, 32, 1)[1]
    for bad in (split // 2, split * 2, 0):
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            kbuild.launch(lib.flash_attention_fwd_split_launch, cuda,
                          q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr(), part.data_ptr(),
                          fa_mod._tickets(cuda, 1).data_ptr(), *tail, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["contiguous", "transpose", "offset-slice"])
def test_short_route_on_model_layout_views(cuda, how, monkeypatch):
    """The short kernels receive the caller's tensors (their data
    pointers) in the model layout, strided or off the 16-byte grid."""
    seen = {}

    def recording(fn, device, *args):
        seen[fn.__name__] = args
        return launch(fn, device, *args)
    launch = kbuild.launch
    monkeypatch.setattr(kbuild, "launch", recording)
    B, Sq, Sk, Hq, Hkv, D = 3, 4, 300, 4, 2, 32
    q, k, v = (_model_view(s, how, cuda, seed=i).requires_grad_()
               for i, s in enumerate(((B, Sq, Hq, D), (B, Sk, Hkv, D),
                                      (B, Sk, Hkv, D))))
    out = flash_attention(q, k, v, causal=False)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(9)
                    ).to(cuda)
    got = torch.autograd.grad(out, [q, k, v], w)
    torch.cuda.synchronize()
    assert list(seen["flash_attention_fwd_split_launch"][:4]) == [
        t.data_ptr() for t in (q, k, v, out)]
    args = seen["flash_attention_bwd_short_launch"]
    assert list(args[:4]) + list(args[6:9]) == [
        t.data_ptr() for t in (q, k, v, out, *got)]
    ref_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref_out = attention_plain_model(*ref_in, causal=False)
    ref = torch.autograd.grad(ref_out, ref_in, w)
    assert _rel_err(out, ref_out) <= TOL[torch.float32]
    for g_, r in zip(got, ref):
        assert _rel_err(g_, r) <= TOL[torch.float32]


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


# the per-client executor's shapes: one client's block norms (G 1, R = 32
# sequences x 32 positions, d 128) and its attention (BH = 32 sequences x
# 4 heads, S 32, D 32, causal), forward and backward
@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rmsnorm", "flash_attention"])
def test_per_client_shapes_match_plain(cuda, kernel):
    if kernel == "rmsnorm":
        ins = _leaves([(1, 1024, 128), (1, 128)], torch.float32, cuda, 11)
        pairs = _fwd_bwd(rmsnorm, rmsnorm_plain, ins, seed=12)
    else:
        ins = _leaves([(128, 32, 32)] * 3, torch.float32, cuda, 13)
        pairs = _fwd_bwd(
            lambda a, b, c: flash_attention_bhsd(a, b, c, causal=True),
            lambda a, b, c: attention_plain(a, b, c, causal=True), ins,
            seed=14)
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert _rel_err(got, ref) <= TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("frac", [0.25, 0.5, 0.75, 1.0])
def test_width_slice_cnn_on_the_card(cuda, frac):
    """The HeteroFL slices of a tree on the card: views of its tensors
    (no copy), equal to the CPU tree's slices."""
    from repro_torch.core.baselines import width_slice_cnn
    from repro_torch.models import cnn
    from repro_torch.tree import tree_leaves, tree_map
    cpu = cnn.init(torch.Generator().manual_seed(0), 10, width_mult=0.25)
    dev = tree_map(lambda t: t.to(cuda), cpu)
    got, ref = width_slice_cnn(dev, frac), width_slice_cnn(cpu, frac)
    for g, r, full in zip(tree_leaves(got), tree_leaves(ref),
                          tree_leaves(dev)):
        assert g.is_cuda and g.shape == r.shape
        assert g.untyped_storage().data_ptr() == \
            full.untyped_storage().data_ptr()
        assert torch.equal(g.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("staleness", [0, 3])
def test_layer_agg_one_row_alpha_route(cuda, staleness):
    """The async engine's aggregation: one client's rows (N = 1), scaled
    by its staleness alpha when stale, one launch, against the plain
    version on the CPU."""
    from repro_torch.core.aggregation import stacked_masked_mean
    from repro_torch.fl.server import staleness_scale
    U, M, w = _inputs(1, 64, 1024, cuda, seed=staleness)
    a = torch.tensor([staleness_scale(staleness, 0.25)], device=cuda)
    alpha = a if staleness else None
    before = LAUNCHES["layer_agg"]
    got = stacked_masked_mean(U, M, w, alpha)
    torch.cuda.synchronize()
    assert LAUNCHES["layer_agg"] == before + 1
    ref = stacked_masked_mean(U.cpu(), M.cpu(), w.cpu(),
                              None if alpha is None else alpha.cpu())
    assert _rel_err(got.cpu(), ref) <= 1e-5
    if staleness:
        fresh = stacked_masked_mean(U.cpu(), M.cpu(), w.cpu(), None)
        assert torch.allclose(ref, fresh * a.item(), rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_async_bucketed_run_matches_the_cpu(cuda):
    """A small bucketed async DR-FL run on the card and on the CPU: the
    same task log, one ``layer_agg`` launch per aggregation on the card,
    sim times at rtol 1e-4; weights at the reference's tolerance for its
    two executors (atol 6e-3, ``tests/test_batch.py:111``): cuDNN's
    float32 convolutions are not deterministic on the card, and SGD over
    12 aggregations amplifies that past 1e-5."""
    import numpy as np
    from repro_torch.fl import FLConfig, run_simulation
    from repro_torch.kernels import reset_launches
    from repro_torch.tree import tree_leaves
    cfg = FLConfig(n_devices=8, n_rounds=3, participation=0.5,
                   local_epochs=1, batch_size=16, n_train=400, hw=8,
                   width_mult=0.125, seed=1, selector="greedy",
                   engine_mode="async", client_executor="batched")
    reset_launches()
    card = run_simulation(cfg)
    torch.cuda.synchronize()
    assert LAUNCHES["layer_agg"] == card["n_aggregations"] >= 1
    cpu = run_simulation(cfg, device="cpu")
    keys = ("device", "dispatch", "version", "staleness", "m")
    assert [[t[k] for k in keys] for t in card["task_log"]] == \
        [[t[k] for k in keys] for t in cpu["task_log"]]
    assert max(card["staleness"]) >= 1
    np.testing.assert_allclose(card["sim_time"], cpu["sim_time"], rtol=1e-4)
    diff = max((g.cpu() - c).abs().max().item() for g, c in
               zip(tree_leaves(card["params"]), tree_leaves(cpu["params"])))
    assert diff <= 6e-3, diff


#: the energy scenarios at ``tests/test_torch_energy_live.py``'s settings
ENERGY = dict(n_devices=8, n_rounds=3, participation=0.5, local_epochs=1,
              batch_size=16, n_train=400, hw=8, width_mult=0.125, seed=1,
              selector="greedy", energy_scale=0.005, charge_period=30.0,
              client_executor="batched")
ENERGY_SCENARIOS = {
    "solar": dict(charge_profile="solar", charge_rate=1.0),
    "diurnal": dict(availability_profile="diurnal", availability_duty=0.15,
                    seed=6),
    "carbon_window": dict(charge_profile="carbon_window", charge_rate=1.0,
                          seed=2),
    "global_budget": dict(charge_profile="solar", charge_rate=1.0,
                          global_budget_j=60.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("scenario", list(ENERGY_SCENARIOS))
def test_energy_scenario_run_matches_the_cpu(cuda, scenario, mode):
    """Each energy scenario on the bucketed executor, on the card and on
    the CPU: the same picks, model choices, task log, termination and
    budget trims; energy, sim times and the budget's joules at rtol 1e-4;
    weights at atol 6e-3 (cuDNN, as above); ``layer_agg`` once per
    aggregation on the card."""
    import numpy as np
    from repro_torch.fl import FLConfig, run_simulation
    from repro_torch.kernels import reset_launches
    from repro_torch.tree import tree_leaves
    cfg = FLConfig(**dict(ENERGY, **ENERGY_SCENARIOS[scenario],
                          engine_mode=mode))
    reset_launches()
    card = run_simulation(cfg)
    torch.cuda.synchronize()
    assert LAUNCHES["layer_agg"] == card["n_aggregations"] >= 1
    cpu = run_simulation(cfg, device="cpu")
    for key in ("participants", "model_choices", "alive", "dropouts",
                "n_aggregations"):
        assert card[key] == cpu[key], key
    keys = ("device", "dispatch", "version", "staleness", "m")
    assert [[t[k] for k in keys] for t in card.get("task_log", [])] == \
        [[t[k] for k in keys] for t in cpu.get("task_log", [])]
    assert card["terminated"]["reason"] == cpu["terminated"]["reason"]
    assert card["terminated"].get("budget") == cpu["terminated"].get(
        "budget")
    for key in ("energy", "sim_time"):
        np.testing.assert_allclose(card[key], cpu[key], rtol=1e-4)
    assert ("budget" in card) == ("budget" in cpu)
    if "budget" in cpu:
        assert card["budget"]["trimmed"] == cpu["budget"]["trimmed"]
        np.testing.assert_allclose(card["budget"]["spent"],
                                   cpu["budget"]["spent"], rtol=1e-4)
    assert ("wakes" in card) == ("wakes" in cpu)
    if "wakes" in cpu:
        assert len(card["wakes"]) == len(cpu["wakes"])
        np.testing.assert_allclose(card["wakes"], cpu["wakes"], rtol=1e-4)
    diff = max((g.cpu() - c).abs().max().item() for g, c in
               zip(tree_leaves(card["params"]), tree_leaves(cpu["params"])))
    assert diff <= 6e-3, diff


# the set mixer's attention (MARL at fleet scale): non-causal, Sq = 4
# seeds, D 32, Sk = the stored agents; the seeds carry sqrt(32) and the
# keys a log-weight in slot -1.  BH 208: the replay batch of Fig. 6's
# 1024-device row (B 1 x T 208); ragged Sk 300; Sk 4096 at the marl_train
# bench's BH 12; Sk 40, inside the fused backward's range
SET_MIXER = [(208, 1024), (208, 300), (12, 4096), (208, 40)]


def _set_mixer_qkv(BH, N, dev):
    q, k, v = _leaves([(BH, 4, 32), (BH, N, 32), (BH, N, 32)],
                      torch.float32, "cpu", seed=BH + N)
    with torch.no_grad():
        q[..., -1] = 32 ** 0.5
        k[..., -1] = torch.randn((BH, N), generator=torch.Generator()
                                 .manual_seed(N))
    return [t.detach().to(dev).requires_grad_() for t in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("BH,N", SET_MIXER)
def test_set_mixer_attention_matches_plain(cuda, BH, N):
    """``attention_reduce`` on the card launches the non-causal kernel
    once forward and once backward on the route ``attention_route``
    gives, and agrees with the plain version at 2e-5."""
    from repro_torch.core.marl.networks import attention_reduce
    q, k, v = _set_mixer_qkv(BH, N, cuda)
    before = dict(LAUNCHES)
    pairs = _fwd_bwd(attention_reduce,
                     lambda a, b, c: attention_plain(a, b, c, causal=False),
                     [q, k, v], seed=N)
    torch.cuda.synchronize()
    route, _ = attention_route(4, N, 32, 1)
    assert route == ("short" if N >= fa_mod.SHORT_MIN_SK else "tiled")
    fwd, bwd = (("fwd_split", "bwd_short") if route == "short" else
                ("fwd_tiled", "bwd_fused" if fused_backward(4, N, 32)
                 else "bwd_three_pass"))
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    for key in (f"flash_attention_{fwd}", f"flash_attention_{bwd}"):
        assert LAUNCHES[key] == before[key] + 1
    for got, ref in pairs:
        assert torch.isfinite(got).all()
        assert _rel_err(got, ref) <= TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1024, 300, 4096])
def test_set_mixer_on_the_card_matches_the_cpu(cuda, N, monkeypatch):
    """The set mixer forward and backward at BH 208 (B 1 x T 208) with
    log-weights: on the card through the kernel only (the plain version
    is made to raise there), against the CPU's plain run at 1e-4 of the
    largest magnitude (float32 matmuls in another order around the
    attention's 2e-5)."""
    from repro_torch.core.marl import networks as net
    from repro_torch.tree import tree_leaves, tree_map
    params = net.set_mixer_init(torch.Generator().manual_seed(0), 25, 5)
    g = torch.Generator().manual_seed(N)
    qs = torch.randn((1, 208, N), generator=g)
    obs = torch.rand((1, 208, N, 5), generator=g)
    state = torch.rand((1, 208, 25), generator=g)
    logw = torch.randn((1, 1, N), generator=g) * 0.1
    ct = torch.randn((1, 208), generator=g)

    def run(dev):
        p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
        q = qs.to(dev).requires_grad_()
        out = net.set_mixer_apply(p, q, obs.to(dev), state.to(dev),
                                  logw=logw.to(dev))
        grads = torch.autograd.grad((out * ct.to(dev)).sum(),
                                    tree_leaves(p) + [q])
        return [out] + list(grads)
    cpu = run("cpu")

    def refuse(*a, **kw):
        raise AssertionError("the plain attention ran on the card")
    monkeypatch.setattr(net, "attention_plain", refuse)
    before = dict(LAUNCHES)
    card = run(cuda)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert LAUNCHES["flash_attention_fwd_split"] == \
        before["flash_attention_fwd_split"] + 1
    assert LAUNCHES["flash_attention_bwd_short"] == \
        before["flash_attention_bwd_short"] + 1
    for a, b in zip(card, cpu):
        assert _rel_err(a.cpu(), b) <= 1e-4


@pytest.mark.cuda
def test_set_mode_qmix_update_on_the_card(cuda):
    """One set-mode QMIX update from a sampled-agent batch (B 1, T 208,
    1024 stored agents): two forward launches (online and target mixer),
    one backward, all on the short-query route; td_loss as the CPU's at
    1e-4, the updated params at rtol 1e-4 and an atol of 2 lr (the key
    bias's gradient is float32 noise, which AdamW steps by up to lr)."""
    import numpy as np
    from repro_torch.core.marl.qmix import QmixConfig, QmixLearner
    from repro_torch.tree import tree_leaves
    rng = np.random.default_rng(0)
    T, N = 208, 1024
    batch = {"obs": rng.random((1, T + 1, N, 5), np.float32),
             "state": rng.random((1, T + 1, 25), np.float32),
             "actions": rng.integers(0, 5, (1, T, N)),
             "rewards": rng.normal(size=(1, T)).astype(np.float32),
             "mask": np.ones((1, T), np.float32),
             "agent_logw": np.zeros((1, N), np.float32)}
    cfg = QmixConfig(n_agents=N, obs_dim=5, num_actions=5, state_dim=25,
                     mixer_mode="set")
    cpu = QmixLearner(cfg, 0, device="cpu")
    card = QmixLearner(cfg, 0, device=cuda)
    mc = cpu.update(batch)
    before = dict(LAUNCHES)
    mg = card.update(batch)
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + 2
    assert LAUNCHES["flash_attention_fwd_split"] == \
        before["flash_attention_fwd_split"] + 2
    assert LAUNCHES["flash_attention_bwd_short"] == \
        before["flash_attention_bwd_short"] + 1
    assert abs(mg["td_loss"] - mc["td_loss"]) <= 1e-4 * abs(mc["td_loss"])
    for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=2 * cfg.lr)


@pytest.mark.cuda
def test_bucketed_kill_and_resume_on_the_card_is_bitwise(cuda, tmp_path,
                                                         monkeypatch):
    """A bucketed sync DR-FL + MARL run on the card, killed after its
    first round's checkpoint and resumed from disk, ends bit for bit as the
    uninterrupted card run, with one ``layer_agg`` launch per resumed
    round.  cuDNN runs in its deterministic mode here (its default float32
    convolutions are not deterministic on the card); the package itself
    never sets it."""
    import dataclasses
    import numpy as np
    from repro_torch.checkpoint import CheckpointHalt, EngineCheckpointer
    from repro_torch.fl import FLConfig, run_simulation
    from repro_torch.kernels import reset_launches
    from repro_torch.tree import tree_leaves
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = FLConfig(n_devices=64, n_rounds=3, participation=0.1,
                   local_epochs=1, batch_size=16, n_train=1280, hw=8,
                   width_mult=0.125, seed=1)
    ref = run_simulation(cfg)
    ck = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / "ck"),
                             checkpoint_every=1)
    with pytest.raises(CheckpointHalt):
        run_simulation(ck, halt_after_saves=1)
    saved, _ = EngineCheckpointer(ck.checkpoint_dir).load()
    reset_launches()
    res = run_simulation(dataclasses.replace(ck, resume=True))
    torch.cuda.synchronize()
    assert LAUNCHES["layer_agg"] == res["n_aggregations"] - saved["n_agg"]
    assert res["n_aggregations"] > saved["n_agg"]
    for key in ("acc", "energy", "reward", "participants", "model_choices",
                "qmix", "sim_time"):
        a, b = ref[key], res[key]
        if key == "acc":
            a, b = np.stack(a).tobytes(), np.stack(b).tobytes()
        assert a == b, key
    for a, b in zip(tree_leaves(ref["params"]), tree_leaves(res["params"])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_mlp_bucketed_run_matches_the_cpu(cuda, mode):
    """The ``mlp`` family's bucketed DR-FL + MARL run (ε 0), given as a
    typed ``SimulationSpec``, on the card and on the CPU: the same picks
    and model choices, one ``layer_agg`` launch per aggregation on the
    card, weights at the live tests' rtol 1e-4, atol 1e-5.  The async run
    keeps to one virtual round, 16 tasks: SGD drift in float32 passes
    1e-4 on longer chains of single-client aggregations."""
    import dataclasses
    import numpy as np
    from repro_torch.fl import EngineSpec, ModelSpec, SimulationSpec
    from repro_torch.fl.engine import RoundEngine
    from repro_torch.fl.simulation import _make_buffer, _make_selector
    from repro_torch.kernels import reset_launches
    from repro_torch.tree import tree_leaves
    cfg = SimulationSpec(
        n_devices=64, n_rounds=3 if mode == "sync" else 1,
        participation=0.25, n_train=1280, seed=10,
        model=ModelSpec(family="mlp", width_mult=0.125, hw=8,
                        local_epochs=1, batch_size=16),
        engine=EngineSpec(mode=mode)).to_flat()
    hists = {}
    for dev in ("cuda", "cpu"):
        sel = _make_selector(cfg, 4, device=dev)
        sel.learner.cfg = dataclasses.replace(sel.learner.cfg, eps_start=0.0,
                                              eps_end=0.0)
        sel.reset_episode()
        reset_launches()
        hists[dev] = RoundEngine(cfg, sel, _make_buffer(cfg),
                                 device=dev).run()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES["layer_agg"] == hists[dev]["n_aggregations"] >= 1
    card, cpu = hists["cuda"], hists["cpu"]
    assert card["executor"] == "batched"
    assert card["participants"] == cpu["participants"]
    assert card["model_choices"] == cpu["model_choices"]
    for a, b in zip(tree_leaves(card["params"]), tree_leaves(cpu["params"])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_env_on_the_card_matches_the_cpu(cuda, mode):
    """``FLEnv`` (a float64 fleet) on the card against the CPU over 50
    seeded steps at 1024 devices: dropouts, alive counts and ``done``
    equal, rewards and energies at rtol 1e-9, observations equal."""
    import numpy as np
    from repro_torch.fl import FLEnv, FLEnvConfig
    cfg = FLEnvConfig.for_family("mlp", n_devices=1024, n_rounds=50,
                                 seed=0, mode=mode)
    card, cpu = FLEnv(cfg), FLEnv(cfg, device="cpu")
    assert card.fleet.remaining.is_cuda
    rng = np.random.default_rng(0)
    for _ in range(50):
        a = rng.integers(0, cfg.n_models + 1, cfg.n_devices)
        go, gr, gd, gi = card.step(a)
        co, cr, cd, ci = cpu.step(a)
        assert (gd, gi["alive"], gi["dropouts"]) == \
            (cd, ci["alive"], ci["dropouts"])
        np.testing.assert_allclose(gr, cr, rtol=1e-9)
        np.testing.assert_allclose(gi["energy"], ci["energy"], rtol=1e-9)
        np.testing.assert_allclose(go.cpu().numpy(), co.numpy(), rtol=1e-6,
                                   atol=0)
        if cd:
            break


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["none", "nccl-1"])
def test_fleet_mesh_on_one_card_is_a_noop(cuda, group, tmp_path):
    """One card is one rank: with no process group, and inside a one-rank
    NCCL group, ``maybe_shard_fleet`` returns the fleet itself for every
    ``fleet_mesh`` (the reference's no-op below two devices)."""
    import torch.distributed as dist
    from repro_torch.core.fleet import make_fleet_state
    from repro_torch.sharding.fleet import is_sharded, maybe_shard_fleet
    fleet = make_fleet_state(64, seed=0, device=cuda)
    if group == "nccl-1":
        dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
    try:
        for n_shards in (0, 1, -1, 2):
            out = maybe_shard_fleet(fleet, n_shards)
            assert out is fleet and not is_sharded(out)
    finally:
        if group == "nccl-1":
            dist.destroy_process_group()


# the LM substrate's shapes, bf16, causal, model layout [B, S, H, D]: (B,
# S, Hq, Hkv, D, window): phi3-mini's prefill (D 96, two TMA boxes of 64
# columns), minitron-8b's (GQA 4, D 128), phi3-mini's train step (and one
# rank's 8 local heads of it under a 4-way model axis), its FL
# steps' (B 4 masked, B 1 a bucket) and a 1024-key window at S 4096; mixtral-8x22b's prefill and train step (GQA
# 6, a 4096-key window past S) and qwen3-moe's (GQA 16); all on the wgmma
# route
LM_ATTN = {"phi3-mini prefill": (4, 2048, 32, 32, 96, 0),
           "minitron-8b prefill": (4, 2048, 32, 8, 128, 0),
           "phi3-mini train": (2, 1024, 32, 32, 96, 0),
           "phi3-mini train local heads": (2, 1024, 8, 8, 96, 0),
           "phi3-mini fl train": (4, 1024, 32, 32, 96, 0),
           "phi3-mini fl bucketed": (1, 1024, 32, 32, 96, 0),
           "phi3-mini SWA 1024": (2, 4096, 32, 32, 96, 1024),
           "mixtral prefill": (4, 2048, 48, 8, 128, 4096),
           "qwen3-moe prefill": (4, 2048, 64, 4, 128, 0),
           "mixtral train": (2, 1024, 48, 8, 128, 4096),
           "qwen3-moe train": (2, 1024, 64, 4, 128, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LM_ATTN))
def test_flash_attention_at_the_lm_shapes_matches_plain(cuda, case):
    """The model-layout wrapper, as the LM's ``attention_apply`` calls it
    under ``use_pallas``: forward and backward against the plain version
    at the bf16 tolerance, one wgmma forward and one wgmma backward launch
    and no other route's."""
    B, S, Hq, Hkv, D, window = LM_ATTN[case]
    q, k, v = _leaves([(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)],
                      torch.bfloat16, cuda, seed=S + D)
    before = dict(LAUNCHES)
    pairs = _fwd_bwd(
        lambda a, b, c: flash_attention(a, b, c, causal=True, window=window),
        lambda a, b, c: attention_plain_model(a, b, c, causal=True,
                                              window=window),
        [q, k, v], seed=D)
    torch.cuda.synchronize()
    for got, ref in pairs:
        assert torch.isfinite(got.float()).all()
        assert _rel_err(got, ref) <= TOL[torch.bfloat16]
    moved = {key: LAUNCHES[key] - before[key] for key in LAUNCHES
             if LAUNCHES[key] != before[key]}
    assert moved == {"flash_attention": 1, "flash_attention_fwd_wgmma": 1,
                     "flash_attention_bwd": 1, "flash_attention_bwd_wgmma": 1}


# the wgmma route's edges, bf16, causal, model layout: (B, Sq, Sk, Hq, Hkv,
# D, window, layout): Sq and Sk off the 64-row tiles (and Sq != Sk); a
# window that crosses the 128-key tiles; GQA 4; D 16, 64, 96 and 128; q,
# k and v as strided views of one fused [B, S, 3, H, D] tensor; and
# whisper-medium's decoder self-attention (B 4, S 448 = 3.5 key tiles, 16
# heads of 64), the exact shape its prefill and train step launch
WGMMA = [(2, 200, 200, 8, 2, 64, 0, "dense"),
         (1, 200, 136, 4, 2, 64, 0, "dense"),
         (2, 300, 300, 4, 4, 96, 100, "dense"),
         (1, 130, 130, 8, 2, 128, 0, "dense"),
         (2, 96, 96, 2, 2, 16, 0, "dense"),
         (2, 256, 256, 4, 4, 96, 0, "fused"),
         (1, 192, 192, 4, 4, 128, 48, "fused"),
         (4, 448, 448, 16, 16, 64, 0, "dense")]
WGMMA_IDS = ["gqa4-d64-ragged", "sq-ne-sk", "window-d96", "gqa4-d128",
             "d16", "fused-qkv-d96", "fused-qkv-d128-window",
             "whisper-decoder"]


def _wgmma_inputs(case, dev):
    """q, k, v and dO of a WGMMA case on ``dev``, bf16 leaves."""
    B, Sq, Sk, Hq, Hkv, D, window, layout = case
    g = torch.Generator().manual_seed(Sq + Sk + D)
    if layout == "fused":
        qkv = torch.randn((B, Sq, 3, Hq, D), generator=g).to(
            dev, torch.bfloat16).requires_grad_()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        leaves = [qkv]
    else:
        q, k, v = _leaves([(B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)],
                          torch.bfloat16, dev, seed=Sq + Sk + D)
        leaves = [q, k, v]
    do = torch.randn((B, Sq, Hq, D), generator=g).to(dev, torch.bfloat16)
    return q, k, v, do, leaves


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA, ids=WGMMA_IDS)
def test_wgmma_route_matches_plain_and_emulation(cuda, case):
    """The route's kernels through the model-layout wrapper: forward and
    backward against the plain version at 2e-2 (for the fused tensor, the
    gradient of the fused leaf), and o, lse, dq, dk, dv against the CPU
    emulation at 1e-2; each direction counted once under its route."""
    B, Sq, Sk, Hq, Hkv, D, window, layout = case
    q, k, v, do, leaves = _wgmma_inputs(case, cuda)
    route = fa_mod._route(q, k, v, True, window)[0]
    assert route == "wgmma"
    before = dict(LAUNCHES)
    out = flash_attention(q, k, v, causal=True, window=window)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd_wgmma"] == \
        before["flash_attention_fwd_wgmma"] + 1
    assert LAUNCHES["flash_attention_bwd_wgmma"] == \
        before["flash_attention_bwd_wgmma"] + 1
    ref_in = [t.detach().clone().requires_grad_() for t in leaves]
    rq, rk, rv = ((ref_in[0][:, :, i] for i in range(3))
                  if layout == "fused" else ref_in)
    ref_out = attention_plain_model(rq, rk, rv, causal=True, window=window)
    ref = torch.autograd.grad(ref_out, ref_in, do)
    assert _rel_err(out, ref_out) <= TOL[torch.bfloat16]
    for g_, r in zip(got, ref):
        assert torch.isfinite(g_.float()).all()
        assert _rel_err(g_, r) <= TOL[torch.bfloat16]

    # the kernels against the emulation, on the heads-first layout
    def bhsd(t):
        return t.detach().transpose(1, 2).flatten(0, 1).cpu()
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o = torch.empty_like(qd)
    lse = fa_mod._forward(qd, kd, vd, o, True, window)
    grads = [torch.empty_like(t) for t in (qd, kd, vd)]
    fa_mod._backward(qd, kd, vd, o, do, lse, *grads, True, window)
    torch.cuda.synchronize()
    eo, e_lse = attention_wgmma_blocked(bhsd(qd), bhsd(kd), bhsd(vd),
                                       causal=True, window=window)
    emu = attention_wgmma_blocked_bwd(bhsd(qd), bhsd(kd), bhsd(vd), bhsd(o),
                                      bhsd(do), lse.cpu(), causal=True,
                                      window=window)
    assert _rel_err(lse.cpu(), e_lse) <= 1e-5
    for a, b in zip([o, *grads], [eo, *emu]):
        assert _rel_err(bhsd(a), b) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("case", [LM_ATTN["phi3-mini train"], WGMMA[2],
                                  WGMMA[3], WGMMA[7]],
                         ids=["phi3-mini-train", "window-d96", "gqa4-d128",
                              "whisper-decoder"])
def test_wgmma_backward_is_deterministic(cuda, case):
    """No atomics: two backward launches give the same bits in dq, dk and
    dv (GQA heads and query tiles summed in one fixed order)."""
    if len(case) == 6:
        B, S, Hq, Hkv, D, window = case
        case = (B, S, S, Hq, Hkv, D, window, "dense")
    q, k, v, do, _ = _wgmma_inputs(case, cuda)
    q, k, v = (t.detach() for t in (q, k, v))
    window = case[6]
    o = torch.empty_like(q)
    lse = fa_mod._forward(q, k, v, o, True, window)
    runs = []
    for _ in range(2):
        grads = [torch.empty_like(t) for t in (q, k, v)]
        fa_mod._backward(q, k, v, o, do, lse, *grads, True, window)
        runs.append(grads)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wgmma_route_refuses_what_it_does_not_take(cuda):
    """The entry points refuse (cudaErrorInvalidValue) a problem outside
    the route instead of computing it: float32, non-causal, D 72, Sq 32,
    a window that leaves rows no key, a view off TMA's grid."""
    lib = fa_mod.load_library()[0]

    def call(q, k, causal=True, window=0, dtype=1):
        o = torch.empty_like(q)
        lse = torch.empty((q.shape[0] * q.shape[2], q.shape[1]),
                          device=cuda)
        tail = list(fa_mod._args(q, k, (q, k, k, o), causal, window))
        tail[-1] = dtype
        kbuild.launch(lib.flash_attention_fwd_wgmma_launch, cuda,
                      q.data_ptr(), k.data_ptr(), k.data_ptr(), o.data_ptr(),
                      lse.data_ptr(), *tail)

    def t(S, D, dtype=torch.bfloat16):
        return torch.zeros((1, S, 2, D), device=cuda, dtype=dtype)
    call(t(128, 64), t(128, 64))                    # taken
    torch.cuda.synchronize()
    flat = torch.zeros((128 * 2 * 64 + 1,), device=cuda,
                       dtype=torch.bfloat16)[1:].view(1, 128, 2, 64)
    for args in ((t(128, 64, torch.float32), t(128, 64, torch.float32),
                  True, 0, 0),
                 (t(128, 64), t(128, 64), False), (t(128, 72), t(128, 72)),
                 (t(32, 64), t(32, 64)), (t(128, 64), t(64, 64), True, 64),
                 (flat, t(128, 64))):
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            call(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b"])
def test_sub_quadratic_prefill_on_the_card_matches_the_plain_route(cuda,
                                                                   arch):
    """Each sub-quadratic family's prefill step at 2 layers and full
    width, bf16, B 2 x S 1024, random weights from seed 0: the kernel
    route's last-position logits against the ``use_pallas=False`` route's
    at the bf16 tolerance.  zamba2 (``shared_attn_every`` 2, so its 2
    Mamba blocks keep one attention site) launches one wgmma forward of
    ``flash_attention`` at head dim 64 a site and no other route; xLSTM
    launches no kernel."""
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models.hybrid import num_attn_sites
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=2, shared_attn_every=(
        2 if cfg.shared_attn_every else 0))
    model, kernel = build_prefill_step(cfg, TrainConfig(use_pallas=True))
    _, plain = build_prefill_step(cfg, TrainConfig(use_pallas=False))
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 1024),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks.to(cuda)}
    before = dict(LAUNCHES)
    got = kernel(params, batch)
    torch.cuda.synchronize()
    moved = {key: LAUNCHES[key] - before[key] for key in LAUNCHES
             if LAUNCHES[key] != before[key]}
    ref = plain(params, batch)
    assert got.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(got).all()
    assert _rel_err(got, ref) <= TOL[torch.bfloat16]
    if cfg.family == "mamba-hybrid":
        sites = num_attn_sites(cfg)
        assert sites == 1 and cfg.hd == 64
        assert moved == {"flash_attention": sites,
                         "flash_attention_fwd_wgmma": sites}
    else:
        assert moved == {}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-11b"])
def test_cross_attention_smoke_forward_on_the_card_matches_the_cpu(cuda,
                                                                   arch):
    """Each cross-attention family's smoke config (2 layers, d 256, 4
    heads of 64, float32) on the card against the CPU on the same params
    (drawn on the CPU; the VLM's gates drawn nonzero, so its cross layer
    counts) and the same stub embeddings, B 2 x S 64, ``use_pallas``:
    hidden states and logits at the float32 tolerance.  The card launches
    the tiled forward once for each causal self-attention layer (whisper's
    2 decoder layers, the VLM's 1 self layer) and nothing else: the
    encoder's and the cross-attention stay plain."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.api import build, extra_inputs
    from repro_torch.tree import tree_map
    cfg = get_smoke_config(arch)
    model = build(cfg)
    g = torch.Generator().manual_seed(0)
    params = model.init(g)
    if "cross_blocks" in params:
        for k in ("gate_attn", "gate_mlp"):
            params["cross_blocks"][k] = torch.randn(
                params["cross_blocks"][k].shape, generator=g)
    extras = {k: torch.randn(shape, generator=g)
              for k, (shape, _) in extra_inputs(cfg, 2, 64).items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        before = dict(LAUNCHES)
        with torch.no_grad():
            h, _ = model.apply(p, toks.to(dev),
                               {k: v.to(dev) for k, v in extras.items()},
                               remat="none", use_pallas=True)
            out[str(dev)] = (h.cpu(), model.logits(p, h).cpu())
        torch.cuda.synchronize()
        moved = {key: LAUNCHES[key] - before[key] for key in LAUNCHES
                 if LAUNCHES[key] != before[key]}
    n_self = 2 if cfg.family == "audio" else 1
    assert moved == {"flash_attention": n_self,
                     "flash_attention_fwd_tiled": n_self}
    for got, ref in zip(out["cuda"], out["cpu"]):
        assert torch.isfinite(got).all()
        assert _rel_err(got, ref) <= TOL[torch.float32]


#: a fresh interpreter whose first wgmma backward runs on autograd's worker
#: thread with the allocator's cache serving every tensor of the step, so
#: that the thread has made no call that binds a context (the cache warmed
#: by tensors of the same sizes, freed); prints the launches
_FRESH_THREAD = """
import torch
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import flash_attention
B, S, Hq, Hkv, D = 4, 2048, 48, 8, 128
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn((B, S, h, D), generator=g, device="cuda").bfloat16()
           .requires_grad_() for h in (Hq, Hkv, Hkv))
do = torch.randn((B, S, Hq, D), generator=g, device="cuda").bfloat16()
spare = [torch.empty_like(t) for t in (q, k, v, q)]
spare.append(torch.empty((B * Hq * 2 * S,), device="cuda"))
del spare
o = flash_attention(q, k, v, causal=True, window=4096)
grads = torch.autograd.grad(o, [q, k, v], do)
torch.cuda.synchronize()
assert all(torch.isfinite(t.float()).all() for t in grads)
print(*(LAUNCHES[f"flash_attention_{k}_wgmma"] for k in ("fwd", "bwd")))
"""


@pytest.mark.cuda
def test_wgmma_backward_launches_on_a_thread_with_no_context(cuda):
    """The wgmma kernels encode their TMA maps through the driver, which
    needs a context current in the calling thread: autograd's worker thread
    reaches the backward with none when the allocator's cache serves the
    step (mixtral's prefill shape failed so with ``CUDA_ERROR_INVALID_
    CONTEXT`` before the launch bound the context).  A fresh interpreter,
    so that no earlier test has bound one."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    proc = subprocess.run([sys.executable, "-c", _FRESH_THREAD],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["1", "1"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b"])
def test_moe_smoke_forward_on_the_card_matches_the_cpu(cuda, arch):
    """Each MoE config's smoke variant (2 layers, d 256, 4 heads of 64, 4
    experts top-2, float32) on the card against the CPU on the same params
    (drawn on the CPU), B 2 x S 64, ``use_pallas``: hidden states, logits
    and the router's aux loss at the float32 tolerance, the routing equal
    layer by layer, and two runs on the card bitwise equal (the dispatch's
    scatter adds).  The card launches the tiled forward once a layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.models.api import build
    from repro_torch.tree import tree_map
    cfg = get_smoke_config(arch)
    model = build(cfg)
    g = torch.Generator().manual_seed(0)
    params = model.init(g)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    out, moved, routes = [], [], []
    for dev in ("cpu", cuda, cuda):
        p = tree_map(lambda t: t.to(dev), params)
        before = dict(LAUNCHES)
        with torch.no_grad(), moe.routes() as seen:
            h, aux = model.apply(p, toks.to(dev), remat="none",
                                 use_pallas=True)
            out.append((h.cpu(), model.logits(p, h).cpu(), aux.cpu()))
        torch.cuda.synchronize()
        routes.append([i.cpu() for i in seen])
        moved.append({key: LAUNCHES[key] - before[key] for key in LAUNCHES
                      if LAUNCHES[key] != before[key]})
    assert moved[1] == {"flash_attention": 2, "flash_attention_fwd_tiled": 2}
    for got, ref in zip(out[1], out[0]):
        assert torch.isfinite(got).all()
        assert _rel_err(got, ref) <= TOL[torch.float32]
    assert len(routes[0]) == 2
    assert all(torch.equal(a, b) for a, b in zip(routes[1], routes[0]))
    assert all(torch.equal(a, b) for a, b in zip(out[2], out[1]))
    assert all(torch.equal(a, b) for a, b in zip(routes[2], routes[1]))


@pytest.mark.cuda
def test_fl_steps_launch_only_the_wgmma_route(cuda):
    """The FL-over-pods steps at phi3-mini's full width, 2 layers (exits
    (1, 2)), bf16, ``remat="full"``, ``use_pallas``, 4 clients of one row
    of S 1024 each, from the same init: the masked step launches two
    wgmma forwards (the forward and the remat recompute) and one wgmma
    backward a layer; the bucketed step (bucket-major ``[2, 2, 1024]``)
    the same for each bucket's layers, 1 + 2; no other route.  Their
    losses agree at the bf16 tolerance, and are finite."""
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.layerwise import layer_mask
    from repro_torch.launch.steps import (build_fl_bucketed_train_step,
                                          build_fl_train_step,
                                          make_train_state)
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), num_layers=2,
                              exit_points=(1, 2))
    tcfg = TrainConfig(remat="full", use_pallas=True, loss_chunk=512)
    B, S = 4, 1024
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    # clients 0, 1 on submodel 0 and 2, 3 on submodel 1 (bucket-major)
    gates = torch.stack([layer_mask(cfg, i // 2, device=cuda)
                         for i in range(B)], dim=1)
    masked = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
              "layer_gates": gates, "layer_counts": gates.sum(dim=1),
              "n_clients": float(B)}
    bucketed = {k: masked[k].reshape(2, B // 2, S)
                for k in ("tokens", "labels")}
    runs = []
    for build, batch, n in (
            (build_fl_train_step, masked, cfg.num_layers),
            (lambda c, t: build_fl_bucketed_train_step(c, t)[:2], bucketed,
             1 + 2)):
        model, step = build(cfg, tcfg)
        state = make_train_state(
            model, torch.Generator(device=cuda).manual_seed(0), tcfg)
        before = dict(LAUNCHES)
        _, m = step(state, batch)
        torch.cuda.synchronize()
        moved = {key: LAUNCHES[key] - before[key] for key in LAUNCHES
                 if LAUNCHES[key] != before[key]}
        assert moved == {"flash_attention": 2 * n,
                         "flash_attention_fwd_wgmma": 2 * n,
                         "flash_attention_bwd": n,
                         "flash_attention_bwd_wgmma": n}
        runs.append(float(m["loss"]))
        del state
    assert all(torch.isfinite(torch.tensor(runs)))
    assert abs(runs[1] - runs[0]) <= TOL[torch.bfloat16] * abs(runs[0])


@pytest.fixture
def one_rank_mesh(cuda, tmp_path):
    """A ``(1, 1)`` ``("data", "model")`` mesh in a one-rank NCCL group
    (one card is one rank), installed as the activation mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.sharding.rules import set_activation_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    set_activation_mesh(mesh)
    try:
        yield mesh
    finally:
        set_activation_mesh(None)
        dist.destroy_process_group()


def _attention_inputs(cuda, B, S, Hq, Hkv, D, seed=4):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn((B, S, h, D), generator=g, device=cuda).bfloat16()
            for h in (Hq, Hkv, Hkv, Hq)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["heads", "batch", "replicated"])
def test_local_shard_entry_equals_the_kernel(one_rank_mesh, cuda, layout):
    """``flash_attention`` on ``DTensor``s (its local-shard entry) on a
    ``(1, 1)`` mesh, q, k, v sharded on the heads, on the batch rows or
    replicated, at phi3-mini's train shape with GQA 4: the output and
    dq, dk, dv equal the direct kernel call's on the same tensors bit for
    bit, the output keeps q's placements, and the entry's forward and
    backward launches count under ``flash_attention_sharded`` and
    ``_bwd_sharded`` beside their route's."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = {"heads": (Shard(0), Shard(2)), "batch": (Shard(0), Shard(0)),
          "replicated": (Replicate(), Replicate())}[layout]
    q, k, v, do = _attention_inputs(cuda, 2, 1024, 32, 8, 96)
    direct = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*direct, causal=True)
    ref = [o] + list(torch.autograd.grad(o, direct, do))
    meshed = [DTensor.from_local(t.clone(), one_rank_mesh, pl,
                                 run_check=False).requires_grad_()
              for t in (q, k, v)]
    before = dict(LAUNCHES)
    o = flash_attention(*meshed, causal=True)
    assert isinstance(o, DTensor) and tuple(o.placements) == pl
    grads = torch.autograd.grad(o, meshed, DTensor.from_local(
        do, one_rank_mesh, pl, run_check=False))
    torch.cuda.synchronize()
    got = [o.to_local()] + [g.to_local() for g in grads]
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    moved = {key: LAUNCHES[key] - before[key] for key in LAUNCHES
             if LAUNCHES[key] != before[key]}
    assert moved == {"flash_attention": 1, "flash_attention_fwd_wgmma": 1,
                     "flash_attention_sharded": 1, "flash_attention_bwd": 1,
                     "flash_attention_bwd_wgmma": 1,
                     "flash_attention_bwd_sharded": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("foreign", ["q rows", "mixed", "head dim",
                                     "partial"])
def test_local_shard_entry_refuses_foreign_placements(one_rank_mesh, cuda,
                                                      foreign):
    """Placements the entry was not written for raise ``ValueError``
    before any launch: q sharded on its rows (the kernel takes no query
    offset), q and k on different dims, the head dim sharded, a partial
    sum.  Nothing is gathered and nothing falls back."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    q, k, v, _ = _attention_inputs(cuda, 2, 1024, 32, 8, 96)
    R = Replicate()
    pq, pk = {"q rows": ((R, Shard(1)), (R, R)),
              "mixed": ((R, Shard(2)), (R, R)),
              "head dim": ((R, Shard(3)), (R, Shard(3))),
              "partial": ((R, Partial()), (R, Partial()))}[foreign]
    dq, dk, dv = (DTensor.from_local(t, one_rank_mesh, p, run_check=False)
                  for t, p in ((q, pq), (k, pk), (v, pk)))
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="attention on local shards"):
        flash_attention(dq, dk, dv, causal=True)
    assert LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("fl", [False, True])
def test_tensor_parallel_step_on_one_card_is_the_one_device_step(
        one_rank_mesh, cuda, fl):
    """phi3-mini at full width, 2 layers, bf16, ``use_pallas``: the
    tensor-parallel meshed step (the state built leaf by leaf) on the
    ``(1, 1)`` mesh equals the one-device step bit for bit after 2 steps
    (losses, grad norms, every param and moment), and every attention
    launch of it goes through the local-shard entry."""
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.layerwise import layer_mask
    from repro_torch.launch.steps import (build_fl_train_step,
                                          build_train_step, make_train_state)
    from repro_torch.launch.train import meshed_step, sharded_train_state
    from repro_torch.sharding.rules import set_activation_mesh
    from repro_torch.tree import tree_leaves
    set_activation_mesh(None)
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), num_layers=2,
                              exit_points=(1, 2))
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=4,
                       remat="full", use_pallas=True, loss_chunk=512)
    model, step = (build_fl_train_step if fl else build_train_step)(cfg,
                                                                    tcfg)
    g = torch.Generator().manual_seed(2)
    batches = []
    for _ in range(2):
        toks = torch.randint(0, cfg.vocab_size, (4, 513), generator=g)
        b = {"tokens": toks[:, :-1].to(cuda), "labels": toks[:, 1:].to(cuda)}
        if fl:
            gates = torch.stack([layer_mask(cfg, i % 2, device=cuda)
                                 for i in range(4)], dim=1)
            b.update(layer_gates=gates, layer_counts=gates.sum(dim=1),
                     n_clients=4.0)
        batches.append(b)
    one = make_train_state(model, torch.Generator(cuda).manual_seed(0), tcfg)
    meshed = sharded_train_state(model, cuda, one_rank_mesh)
    run = meshed_step(step, one_rank_mesh)
    for b in batches:
        one, m1 = step(one, b)
        before = dict(LAUNCHES)
        meshed, m2 = run(meshed, b)
        torch.cuda.synchronize()
        assert (float(m1["loss"]), float(m1["grad_norm"])) == \
            (float(m2["loss"]), float(m2["grad_norm"]))
        sharded = LAUNCHES["flash_attention_sharded"] - \
            before["flash_attention_sharded"]
        total = LAUNCHES["flash_attention"] - before["flash_attention"]
        assert sharded == total == 2 * cfg.num_layers
    for a, b in zip(tree_leaves(meshed), tree_leaves(one)):
        assert a == b if isinstance(a, int) else torch.equal(a.to_local(), b)



@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b",
                                  "whisper-medium", "llama-3.2-vision-11b"])
def test_family_tensor_parallel_step_on_one_card_is_the_one_device_step(
        one_rank_mesh, cuda, arch):
    """Each family whose blocks are not only the dense decoder's (xLSTM,
    the Mamba2 hybrid, whisper, the VLM), its smoke config, ``use_pallas``
    and its stub inputs: one tensor-parallel meshed step (the state built
    leaf by leaf) on the ``(1, 1)`` mesh equals the one-device step bit
    for bit (loss, grad norm, every param and moment), and every
    attention launch of it goes through the local-shard entry."""
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.launch.steps import build_train_step, make_train_state
    from repro_torch.launch.train import meshed_step, sharded_train_state
    from repro_torch.models.api import extra_inputs
    from repro_torch.sharding.rules import set_activation_mesh
    from repro_torch.tree import tree_leaves
    set_activation_mesh(None)
    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=4,
                       remat="full", use_pallas=True, loss_chunk=16)
    model, step = build_train_step(cfg, tcfg)
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=g)
    batch = {"tokens": toks[:, :-1].to(cuda), "labels": toks[:, 1:].to(cuda)}
    for k, (shape, dt) in extra_inputs(cfg, 4, 32).items():
        batch[k] = torch.randn(shape, generator=g).to(dt).to(cuda)
    one = make_train_state(model, torch.Generator(cuda).manual_seed(0), tcfg)
    meshed = sharded_train_state(model, cuda, one_rank_mesh)
    one, m1 = step(one, batch)
    before = dict(LAUNCHES)
    meshed, m2 = meshed_step(step, one_rank_mesh)(meshed, batch)
    torch.cuda.synchronize()
    assert (float(m1["loss"]), float(m1["grad_norm"])) == \
        (float(m2["loss"]), float(m2["grad_norm"]))
    sharded = LAUNCHES["flash_attention_sharded"] - \
        before["flash_attention_sharded"]
    total = LAUNCHES["flash_attention"] - before["flash_attention"]
    assert sharded == total and (total > 0) == (cfg.family != "ssm")
    for a, b in zip(tree_leaves(meshed), tree_leaves(one)):
        assert a == b if isinstance(a, int) else torch.equal(a.to_local(), b)
