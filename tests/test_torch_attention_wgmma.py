"""The wgmma route of ``flash_attention`` (``csrc/fwd_wgmma.cu``,
``csrc/bwd_wgmma.cu``): its CPU emulation of the kernels' rounding
(``attention_wgmma_blocked``, ``attention_wgmma_blocked_bwd``) against the
JAX package's oracle ``attention_ref``, ``jax.grad`` of it and the Pallas
kernel in interpret mode; and the route choice (``attention_route``,
``tma_aligned``), branch by branch.  Inputs are numpy draws from a seed,
rounded to bf16.

The emulation plays the part ``interpret=True`` plays for a Pallas kernel:
the card's tests hold the kernels against it.  Tolerances: 2e-2 in bf16
(the JAX sweep's, ``tests/test_kernels.py``), forward and backward; the
row log-sum-exp, which the route keeps in float32, 2e-5.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_bhsd as pallas_bhsd)
from repro_torch.kernels.flash_attention import (attention_route,
                                                 attention_wgmma_blocked,
                                                 attention_wgmma_blocked_bwd,
                                                 tma_aligned)

fa_mod = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")

torch.set_num_threads(1)
BF16 = dict(rtol=2e-2, atol=2e-2)
LSE = dict(rtol=2e-5, atol=2e-5)

# (BH, BHkv, S, D, window, Pallas block or None), causal, bf16: B <= 2
# heads of GQA 2 at D 64 and 96; S 128 (one key tile), 192 and 160 (a
# ragged second tile of 64 and 32 keys); windows of 48 keys, which cross
# the tiles' edges
CASES = [(2, 1, 128, 64, 0, 64), (4, 2, 192, 96, 0, 64),
         (2, 1, 192, 64, 48, None), (4, 2, 160, 96, 48, None)]
IDS = ["gqa2-d64", "gqa2-d96-ragged", "window48-d64",
       "window48-d96-ragged"]


def _draws(BH, BHkv, S, D, seed):
    """q, k, v, dO as numpy draws rounded to bf16, in float32."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(n, S, D)).astype(np.float32)
           for n in (BH, BHkv, BHkv, BH)]
    return [np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
            for a in out]


def _jax_lse(q, k, window):
    """attention_ref's causal row log-sum-exp."""
    group = q.shape[0] // k.shape[0]
    S, D = q.shape[1], q.shape[2]
    s = jnp.einsum("bqd,bkd->bqk", q, jnp.repeat(k, group, axis=0))
    s = s / math.sqrt(D)
    qp, kp = jnp.arange(S)[:, None], jnp.arange(S)[None, :]
    mask = kp <= qp
    if window:
        mask &= kp > qp - window
    return np.asarray(jax.nn.logsumexp(jnp.where(mask[None], s, -1e30),
                                       axis=-1))


def _bf16(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulated_forward_matches_ref_and_interpret(case):
    BH, BHkv, S, D, window, block = case
    q, k, v, _ = _draws(BH, BHkv, S, D, seed=BH + S + D + window)
    assert attention_route(S, S, D, BH // BHkv, torch.bfloat16,
                           window=window)[0] == "wgmma"
    o, lse = attention_wgmma_blocked(*_bf16(q, k, v), causal=True,
                                     window=window)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = jax.jit(attention_ref, static_argnames=("causal", "window"))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(ref), **BF16)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(jnp.asarray(q),
                                                     jnp.asarray(k), window),
                               **LSE)
    if block is not None:
        pallas = pallas_bhsd(*(jnp.asarray(a).astype(jnp.bfloat16)
                               for a in (q, k, v)), causal=True,
                             window=window, block_q=block, block_k=block,
                             interpret=True)
        np.testing.assert_allclose(o.float().numpy(),
                                   np.asarray(pallas.astype(jnp.float32)),
                                   **BF16)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulated_backward_matches_jax_grad_of_ref(case):
    BH, BHkv, S, D, window, _ = case
    q, k, v, do = _draws(BH, BHkv, S, D, seed=BH + S + D + window + 1)
    jg = jax.jit(jax.grad(lambda a, b, c: jnp.sum(
        attention_ref(a, b, c, causal=True, window=window) * do),
        argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tdo = _bf16(q, k, v, do)
    o, lse = attention_wgmma_blocked(tq, tk, tv, causal=True, window=window)
    got = attention_wgmma_blocked_bwd(tq, tk, tv, o, tdo, lse, causal=True,
                                      window=window)
    for g, r, t in zip(got, jg, (tq, tk, tv)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        assert torch.isfinite(g.float()).all()
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r), **BF16)


def test_emulation_rounds_p_against_each_tiles_maximum():
    """Rounding P to bf16 is the route's only departure from the float32
    softmax: the emulation's o differs from the plain version by about
    bf16's spacing, and its lse, which never sees the rounding, by
    float32's."""
    q, k, v, _ = (torch.from_numpy(a) for a in
                  _draws(2, 2, 256, 64, seed=3))
    o, lse = attention_wgmma_blocked(q, k, v, causal=True)
    plain = fa_mod.attention_plain(q, k, v, causal=True)
    err = (o - plain).abs().max().item()
    assert 1e-6 < err < 2e-2
    s = (q @ k.transpose(1, 2)) / 8.0
    s = torch.where(fa_mod._visible(256, 256, True, 0, "cpu"), s,
                    s.new_tensor(-math.inf))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), **LSE)


# (Sq, Sk, D, group, dtype, window, aligned, route): the LM's four shapes
# in bf16 (phi3-mini's prefill and train step, minitron-8b's GQA 4, the
# 1024-key window); each in float32; Sq below 64 and at most 8; D not a
# multiple of 16 and past 128; off TMA's grid; a window that leaves the
# last rows no key, and one key more
ROUTES = [(2048, 2048, 96, 1, torch.bfloat16, 0, True, "wgmma"),
          (2048, 2048, 128, 4, torch.bfloat16, 0, True, "wgmma"),
          (1024, 1024, 96, 1, torch.bfloat16, 0, True, "wgmma"),
          (4096, 4096, 96, 1, torch.bfloat16, 1024, True, "wgmma"),
          (2048, 2048, 96, 1, torch.float32, 0, True, "tiled"),
          (2048, 2048, 128, 4, torch.float32, 0, True, "tiled"),
          (4096, 4096, 96, 1, torch.float32, 1024, True, "tiled"),
          (63, 63, 64, 1, torch.bfloat16, 0, True, "tiled"),
          (64, 64, 64, 1, torch.bfloat16, 0, True, "wgmma"),
          (8, 1024, 64, 1, torch.bfloat16, 0, True, "short"),
          (2048, 2048, 72, 1, torch.bfloat16, 0, True, "tiled"),
          (2048, 2048, 144, 1, torch.bfloat16, 0, True, "tiled"),
          (2048, 2048, 96, 1, torch.bfloat16, 0, False, "tiled"),
          (128, 64, 64, 1, torch.bfloat16, 64, True, "tiled"),
          (128, 65, 64, 1, torch.bfloat16, 64, True, "wgmma")]


@pytest.mark.parametrize("Sq,Sk,D,group,dtype,window,aligned,route", ROUTES)
def test_route_by_shape_dtype_and_layout(Sq, Sk, D, group, dtype, window,
                                         aligned, route):
    got, split = attention_route(Sq, Sk, D, group, dtype, window=window,
                                 aligned=aligned)
    assert got == route
    assert split == (fa_mod.short_split(D) if route == "short" else 0)


def test_non_causal_stays_off_the_route():
    assert attention_route(2048, 2048, 96, 1, torch.bfloat16,
                           causal=False)[0] == "tiled"
    # the old call, without a dtype, is float32's
    assert attention_route(2048, 2048, 96, 1)[0] == "tiled"


def _views(how, B=2, S=128, H=4, D=96):
    """[B, S, H, D] bf16 tensors laid out as the model or a caller may
    hand them over."""
    g = torch.Generator().manual_seed(0)
    if how == "contiguous":
        return torch.randn((B, S, H, D), generator=g).bfloat16()
    if how == "heads-first":
        return torch.randn((B, H, S, D),
                           generator=g).bfloat16().transpose(1, 2)
    if how == "fused-qkv":
        return torch.randn((B, S, 3, H, D), generator=g).bfloat16()[:, :, 1]
    if how == "odd-pitch":              # a row pitch of 2 D + 1 elements
        return torch.randn((B, S, H, 2 * D + 1),
                           generator=g).bfloat16()[..., :D]
    assert how == "offset"              # one element into its storage
    flat = torch.randn((B * S * H * D + 1,), generator=g).bfloat16()
    return flat[1:].view(B, S, H, D)


@pytest.mark.parametrize("how,ok", [("contiguous", True),
                                    ("heads-first", True),
                                    ("fused-qkv", True),
                                    ("odd-pitch", False), ("offset", False)])
def test_tma_alignment_of_views(how, ok):
    t = _views(how)
    assert tma_aligned(t) is ok
    dense = _views("contiguous")
    route = fa_mod._route(t, dense, dense, True, 0)[0]
    assert route == ("wgmma" if ok else "tiled")


def test_cpu_call_takes_the_plain_version_and_counts_nothing():
    """On CPU tensors the wrapper computes the plain version whatever the
    route, and no launch is counted."""
    from repro_torch.kernels import LAUNCHES
    q, k, v = (_views("fused-qkv") for _ in range(3))
    before = dict(LAUNCHES)
    o = fa_mod.flash_attention(q, k, v, causal=True)
    assert LAUNCHES == before
    torch.testing.assert_close(
        o, fa_mod.attention_plain_model(q, k, v, causal=True))
