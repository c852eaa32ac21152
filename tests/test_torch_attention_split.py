"""The short-query route of ``flash_attention`` (``csrc/fwd_split.cu``,
``csrc/bwd_short.cu``): its CPU emulation of the kernels' order of sums
(``attention_split_blocked``, ``attention_split_blocked_bwd``) against the
JAX package's oracle ``attention_ref``, ``jax.grad`` of it and the Pallas
kernel in interpret mode; and the route choice (``attention_route``),
branch by branch.  Inputs are numpy draws from a seed.

The emulation plays the part ``interpret=True`` plays for a Pallas kernel:
the card's tests hold the kernels against it at 1e-6.  Tolerances:
forward and lse 2e-5 in float32 (the JAX sweep's, ``tests/test_kernels.py``),
gradients ``tests/test_torch_norm_attention.py``'s (rtol 1e-4, atol 1e-5),
bfloat16 2e-2 (the JAX sweep's).
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
                                                 attention_split_blocked,
                                                 attention_split_blocked_bwd,
                                                 short_split)

fa_mod = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")

torch.set_num_threads(1)
FWD = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD = {"float32": dict(rtol=1e-4, atol=1e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}

# (BH, BHkv, Sq, Sk, D, causal, window, dtype, Pallas block_k or None):
# Sq 1, 4 and 8 over Sk 64 (one split, two warps empty at D 32), 300
# (ragged: 128 + 128 + 44) and 1024; the set mixer's slot -1 (every D 32
# case); GQA 4:1; causal rows, whose splits past the first are all
# masked; a window, whose rows see one split each; rows that see no key
# (window, Sk 5); D 64 and 128 (splits of 64 and 32 keys) and D 20; bf16
CASES = [
    (4, 4, 4, 1024, 32, False, 0, "float32", 128),
    (4, 4, 4, 300, 32, False, 0, "float32", 100),
    (4, 4, 1, 64, 32, False, 0, "float32", 16),
    (4, 4, 8, 1024, 32, False, 0, "float32", 256),
    (8, 2, 4, 300, 32, False, 0, "float32", 100),
    (8, 2, 8, 64, 64, True, 0, "float32", 32),
    (4, 4, 4, 300, 32, True, 0, "float32", None),
    (4, 1, 8, 1024, 128, True, 0, "float32", None),
    (4, 4, 8, 300, 32, False, 3, "float32", None),
    (6, 3, 8, 5, 16, True, 2, "float32", None),
    (4, 4, 7, 3, 32, False, 2, "float32", None),
    (4, 4, 4, 150, 20, False, 0, "float32", None),
    (4, 4, 4, 1024, 32, False, 0, "bfloat16", None),
    (8, 2, 8, 300, 128, True, 0, "bfloat16", None),
]
IDS = ["set-mixer", "set-mixer-ragged", "sq1-one-split", "sq8",
       "gqa4", "gqa4-causal-d64", "causal-masked-splits", "causal-d128",
       "window", "keyless-causal", "keyless-window", "d20", "bf16",
       "bf16-gqa4-causal-d128"]


def _draws(BH, BHkv, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    k = rng.normal(size=(BHkv, Sk, D)).astype(np.float32)
    v = rng.normal(size=(BHkv, Sk, D)).astype(np.float32)
    do = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    if D == 32:                 # the set mixer: sqrt(32) and a log-weight
        q[..., -1] = math.sqrt(D)
        k[..., -1] = rng.normal(size=(BHkv, Sk)).astype(np.float32)
    return q, k, v, do


def _round(a, dtype):
    """a rounded to dtype, back in float32 (both packages' inputs)."""
    return np.array(jnp.asarray(a).astype(dtype).astype(jnp.float32))


def _jax_lse(q, k, causal, window):
    """attention_ref's row log-sum-exp of the masked logits."""
    group = q.shape[0] // k.shape[0]
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[2]
    s = jnp.einsum("bqd,bkd->bqk", q, jnp.repeat(k, group, axis=0))
    s = s / math.sqrt(D)
    qp, kp = jnp.arange(Sq)[:, None], jnp.arange(Sk)[None, :]
    mask = jnp.ones((Sq, Sk), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return np.asarray(jax.nn.logsumexp(jnp.where(mask[None], s, -1e30),
                                       axis=-1))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocked_forward_matches_ref_and_interpret(case):
    BH, BHkv, Sq, Sk, D, causal, window, dtype, block_k = case
    q, k, v, _ = _draws(BH, BHkv, Sq, Sk, D, seed=BH + Sq * Sk + D)
    q, k, v = (_round(a, dtype) for a in (q, k, v))
    tdt = getattr(torch, dtype)
    o, lse = attention_split_blocked(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
        window=window, split=short_split(D))
    assert o.dtype == tdt and lse.dtype == torch.float32
    ref = jax.jit(attention_ref, static_argnames=("causal", "window"))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(ref),
                               **FWD[dtype])
    ref_lse = _jax_lse(jnp.asarray(q), jnp.asarray(k), causal, window)
    seen = ref_lse > -1e29
    np.testing.assert_allclose(lse.numpy()[seen], ref_lse[seen],
                               **FWD["float32"])
    # rows that see no key: the plain mean of v, lse -1e30
    assert np.all(lse.numpy()[~seen] == np.float32(-1e30))
    if not seen.all():
        mean_v = np.repeat(v.mean(axis=1), BH // BHkv, axis=0)
        rows = np.nonzero(~seen[0])[0]
        np.testing.assert_allclose(o.float().numpy()[:, rows],
                                   np.repeat(mean_v[:, None], len(rows), 1),
                                   **FWD[dtype])
    if block_k is not None:
        pallas = pallas_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, block_q=Sq,
                             block_k=block_k, interpret=True)
        np.testing.assert_allclose(o.numpy(), np.asarray(pallas),
                                   **FWD[dtype])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocked_backward_matches_jax_grad_of_ref(case):
    BH, BHkv, Sq, Sk, D, causal, window, dtype, _ = case
    q, k, v, do = (_round(a, dtype) for a in
                   _draws(BH, BHkv, Sq, Sk, D, seed=BH + Sq + Sk + D))
    jg = jax.jit(jax.grad(lambda a, b, c: jnp.sum(
        attention_ref(a, b, c, causal=causal, window=window) * do),
        argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    split = short_split(D)
    o, lse = attention_split_blocked(tq, tk, tv, causal=causal,
                                     window=window, split=split)
    got = attention_split_blocked_bwd(tq, tk, tv, o, tdo, lse,
                                      causal=causal, window=window,
                                      split=split)
    for g, r, t in zip(got, jg, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert torch.isfinite(g.float()).all()
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r),
                                   **GRAD[dtype])


@pytest.mark.parametrize("Sk", [127, 128, 129])
def test_blocked_order_is_the_split_order(Sk):
    """At a split boundary the emulation's forward agrees with itself at
    any split that divides it into warps (the order of sums is all that
    moves), and one split of every key is the plain softmax."""
    q, k, v, _ = _draws(2, 2, 4, Sk, 32, seed=Sk)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    outs = [attention_split_blocked(*t, causal=False, split=s)
            for s in (4, 32, 128, 4 * Sk)]
    plain = fa_mod.attention_plain(*t, causal=False)
    for o, lse in outs:
        torch.testing.assert_close(o, plain, rtol=2e-6, atol=2e-6)
        torch.testing.assert_close(lse, outs[0][1], rtol=1e-6, atol=1e-6)


# (Sq, Sk, D, group, route): the set mixer's shapes (Fig. 6's 1024 agents,
# marl_train's 4096, 300 ragged); Sq 1 and 8; the row limit of a GQA group
# (4 heads x 8 rows; 8 heads x 4 rows) and one head past it; Sq 9; the
# transformer's Sq 32 at every Sk; D past the kernels' 128
ROUTES = [(4, 1024, 32, 1, "short"), (4, 4096, 32, 1, "short"),
          (4, 300, 32, 1, "short"), (1, 4096, 32, 1, "short"),
          (8, 1024, 64, 1, "short"), (8, 1024, 128, 4, "short"),
          (4, 1024, 32, 8, "short"), (8, 1024, 32, 5, "tiled"),
          (4, 1024, 32, 9, "tiled"), (9, 1024, 32, 1, "tiled"),
          (32, 32, 32, 1, "tiled"), (32, 4096, 32, 1, "tiled"),
          (4, 1024, 256, 1, "tiled")]


@pytest.mark.parametrize("Sq,Sk,D,group,route", ROUTES)
def test_route_by_shape(Sq, Sk, D, group, route):
    got, split = attention_route(Sq, Sk, D, group)
    assert got == route
    assert split == (short_split(D) if route == "short" else 0)


def test_short_route_starts_at_its_measured_length():
    """Below ``SHORT_MIN_SK`` keys a short query stays on the tiled route;
    from it on it takes the short route."""
    n = fa_mod.SHORT_MIN_SK
    assert attention_route(4, n, 32, 1)[0] == "short"
    if n > 1:
        assert attention_route(4, n - 1, 32, 1)[0] == "tiled"


@pytest.mark.parametrize("D,split", [(1, 128), (20, 128), (32, 128),
                                     (33, 64), (64, 64), (65, 32),
                                     (128, 32)])
def test_split_by_head_dimension(D, split):
    assert short_split(D) == split
    assert split % fa_mod.SHORT_WARPS == 0
