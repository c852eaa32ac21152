"""The port's rmsnorm and flash-attention plain versions (what their
wrappers run on CPU tensors) against the JAX package: the oracles
``rmsnorm_ref`` / ``attention_ref``, the Pallas kernels in interpret
mode, and ``jax.grad`` through the oracles (the JAX kernels have no
backward, so the oracles' gradients are the reference for the port's
backward kernels).  Inputs are numpy draws from a seed.

Tolerances: rmsnorm forward 1e-6 in float32 and 2e-2 in bfloat16 (the
JAX sweep's, ``tests/test_kernels.py``); attention forward 2e-5 (the JAX
sweep's float32 tolerance); gradients rtol 1e-4, atol 1e-5 (float32
reductions over d or S in another order, then a backward through the
softmax or the normaliser).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.rmsnorm import rmsnorm_op as jax_rmsnorm_op
from repro.kernels.rmsnorm import rmsnorm_ref
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention,
                                                 flash_attention_bhsd)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_op, rmsnorm_plain

torch.set_num_threads(1)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.ascontiguousarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(8, 64), (3, 11, 128), (7, 64), (1, 256),
                                   (5, 100)])
def test_rmsnorm_plain_matches_ref_and_interpret(shape, dtype, tol):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    s = rng.normal(size=shape[-1:]).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jx, js = jnp.asarray(x).astype(jdt), jnp.asarray(s).astype(jdt)
    ref = rmsnorm_ref(jx.reshape(-1, shape[-1]), js).reshape(shape)
    pallas = jax_rmsnorm_op(jx, js, interpret=True)
    got = rmsnorm_op(_t(x, tdt), _t(s, tdt)).float().numpy()
    for r in (ref, pallas):
        np.testing.assert_allclose(got, np.asarray(r, np.float32), atol=tol,
                                   rtol=tol)


def test_rmsnorm_grads_match_jax_grad_of_ref():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(6, 96)) * 2).astype(np.float32)
    s = rng.normal(size=(96,)).astype(np.float32)
    w = rng.normal(size=(6, 96)).astype(np.float32)
    jgx, jgs = jax.grad(lambda a, b: jnp.sum(rmsnorm_ref(a, b) * w),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    tx, ts = _t(x).requires_grad_(), _t(s).requires_grad_()
    (rmsnorm_op(tx, ts) * _t(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgs), **GRAD)


def test_stacked_rmsnorm_matches_per_group_jax():
    """G > 1 (one scale row per participant) against one JAX call per
    group, forward and gradients."""
    G, R, d = 3, 5, 40
    rng = np.random.default_rng(1)
    x = rng.normal(size=(G, R, d)).astype(np.float32)
    s = rng.normal(size=(G, d)).astype(np.float32)
    w = rng.normal(size=(G, R, d)).astype(np.float32)
    tx, ts = _t(x).requires_grad_(), _t(s).requires_grad_()
    y = rmsnorm(tx, ts)
    (y * _t(w)).sum().backward()
    for g in range(G):
        ref = rmsnorm_ref(jnp.asarray(x[g]), jnp.asarray(s[g]))
        np.testing.assert_allclose(y[g].detach().numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-6)
        jgx, jgs = jax.grad(lambda a, b: jnp.sum(rmsnorm_ref(a, b) * w[g]),
                            argnums=(0, 1))(jnp.asarray(x[g]),
                                            jnp.asarray(s[g]))
        np.testing.assert_allclose(tx.grad[g].numpy(), np.asarray(jgx),
                                   **GRAD)
        np.testing.assert_allclose(ts.grad[g].numpy(), np.asarray(jgs),
                                   **GRAD)


# (B, Sq, Sk, Hq, Hkv, D, causal, window, block): causal GQA, a window, a
# non-causal square case, the set mixer's rectangular shape (Sq != Sk),
# and two cases whose last rows see no key (window with Sq > Sk)
CASES = [
    (2, 16, 16, 4, 2, 16, True, 0, 8),
    (1, 32, 32, 4, 1, 8, True, 0, 16),
    (2, 16, 16, 2, 2, 32, True, 4, 8),
    (1, 16, 16, 4, 4, 16, False, 0, 16),
    (2, 4, 64, 1, 1, 8, False, 0, 4),
    (1, 16, 8, 2, 2, 8, False, 2, 8),
    (1, 16, 8, 2, 1, 8, True, 3, 8),
]
CASE_IDS = ["causal-gqa", "causal-gqa8", "window", "noncausal", "rect",
            "empty-rows", "empty-rows-causal-gqa"]


def _qkv(B, Sq, Sk, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    w = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    return q, k, v, w


def _heads_first(a):
    B, S, H, D = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * H, S, D)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_attention_plain_matches_ref_and_interpret(case):
    B, Sq, Sk, Hq, Hkv, D, causal, window, blk = case
    q, k, v, _ = _qkv(B, Sq, Sk, Hq, Hkv, D, seed=Sq * Sk + D)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                          window=window).numpy()
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, window=window, block_q=blk,
                       block_k=blk, interpret=True)
    ref = attention_ref(*(jnp.asarray(_heads_first(a)) for a in (q, k, v)),
                        causal=causal, window=window)
    ref = np.asarray(ref).reshape(B, Hq, Sq, D).transpose(0, 2, 1, 3)
    for r in (np.asarray(pallas), ref):
        np.testing.assert_allclose(got, r, atol=2e-5, rtol=2e-5)
    if window and Sq > Sk:
        # rows q >= Sk - 1 + window see no key: the plain mean of v
        first = Sk - 1 + window
        mean_v = np.repeat(v.mean(axis=1), Hq // Hkv, axis=1)   # [B, Hq, D]
        np.testing.assert_allclose(
            got[:, first:], np.broadcast_to(mean_v[:, None],
                                            got[:, first:].shape),
            atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_attention_grads_match_jax_grad_of_ref(case):
    B, Sq, Sk, Hq, Hkv, D, causal, window, _ = case
    q, k, v, w = _qkv(B, Sq, Sk, Hq, Hkv, D, seed=Sq + Sk + D)
    qb, kb, vb, wb = (_heads_first(a) for a in (q, k, v, w))
    jg = jax.grad(lambda a, b, c: jnp.sum(
        attention_ref(a, b, c, causal=causal, window=window) * wb),
        argnums=(0, 1, 2))(jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(vb))
    ts = [_t(a).requires_grad_() for a in (qb, kb, vb)]
    out = flash_attention_bhsd(*ts, causal=causal, window=window)
    (out * _t(wb)).sum().backward()
    for t, r in zip(ts, jg):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **GRAD)


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    reset_launches()
    rng = np.random.default_rng(2)
    x = _t(rng.normal(size=(2, 3, 16)))
    s = _t(rng.normal(size=(2, 16)))
    torch.testing.assert_close(rmsnorm(x, s), rmsnorm_plain(x, s), rtol=0,
                               atol=0)
    q = _t(rng.normal(size=(4, 8, 8)))
    torch.testing.assert_close(flash_attention_bhsd(q, q, q),
                               attention_plain(q, q, q), rtol=0, atol=0)
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES


@pytest.mark.parametrize("call", [
    lambda: rmsnorm(torch.zeros(2, 3, 8), torch.zeros(3, 8)),
    lambda: rmsnorm(torch.zeros(2, 3, 8), torch.zeros(2, 8,
                                                     dtype=torch.float64)),
    lambda: rmsnorm(torch.zeros(2, 8, 3).transpose(1, 2), torch.zeros(2, 8)),
    lambda: flash_attention_bhsd(torch.zeros(3, 4, 8), torch.zeros(2, 4, 8),
                                 torch.zeros(2, 4, 8)),
    lambda: flash_attention_bhsd(torch.zeros(2, 4, 8), torch.zeros(2, 4, 8),
                                 torch.zeros(2, 4, 8), window=-1),
    lambda: flash_attention_bhsd(torch.zeros(2, 8, 4).transpose(1, 2),
                                 torch.zeros(2, 4, 8), torch.zeros(2, 4, 8)),
], ids=["rmsnorm-scale-shape", "rmsnorm-dtype", "rmsnorm-strided",
        "attention-group", "attention-window", "attention-strided"])
def test_wrappers_check_their_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()
