"""The port's xLSTM (``models/xlstm.py``, the ``ssm`` family) against the
JAX package's, at xlstm-1.3b's smoke config (2 layers: one mLSTM and one
sLSTM block, d 256, 4 heads, P 128, chunk 16): the chunkwise mLSTM scan
(from zero and from a carried state), its recurrent step, the sLSTM cell
and its time loop, ``apply`` and ``logits`` under a full, a prefix and a
zero layer mask, 12 decode steps against the JAX decode and the port's
own forward, the remat modes, two train steps, the slot server's tokens,
and ``lm_params_from_jax`` on the bf16 tree with its float32 leaves.

The JAX functions run under ``jit``; the params are numpy draws
(``tests/torch_lm.py``).  Tolerances: float32 rtol/atol 1e-5, decode
against the forward atol 2e-4 rtol 1e-3, losses and grad norms rtol
1e-5, served tokens equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build as jax_build
from repro.models import xlstm as jx
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import xlstm
from repro_torch.models.api import build
from repro_torch.tree import tree_leaves
from torch_lm import (DECODE, F32, assert_forward_matches_jax,
                      assert_trained_like_jax, assert_trees_close,
                      bf16_tree, both_params, configs, decode_runs,
                      remat_outputs, served_tokens, tokens, train_runs)

torch.set_num_threads(1)
ARCH = "xlstm-1.3b"
B, H, S, P, CHUNK = 2, 4, 32, 16, 8


def _draws(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _mlstm_inputs(seed=0):
    q, k, v, li, fr = _draws(seed, *[(B, H, S, P)] * 3, (B, H, S), (B, H, S))
    lf = np.asarray(jax.nn.log_sigmoid(fr + 2.0))
    return q, k, v, li, lf


@pytest.fixture(scope="module")
def jax_scan():
    return jax.jit(jx._mlstm_chunk_scan, static_argnums=(5,))


@pytest.mark.parametrize("carried", [False, True],
                         ids=["from zero", "carried state"])
def test_mlstm_chunk_scan_matches_jax(jax_scan, carried):
    """Four chunks of 8; the carried case starts from the state that
    another sequence of the same length leaves."""
    ins = _mlstm_inputs()
    state = None
    if carried:
        _, state = jax_scan(*_mlstm_inputs(2), CHUNK)
        state = tuple(np.asarray(t) for t in state)
    y, st = jax_scan(*ins, CHUNK, state)
    ty, tst = xlstm._mlstm_chunk_scan(
        *map(torch.from_numpy, ins), CHUNK,
        None if state is None else tuple(map(torch.from_numpy, state)))
    assert_trees_close([ty.numpy()] + [t.numpy() for t in tst],
                       [y] + list(st))


def test_mlstm_step_matches_jax_and_the_scan(jax_scan):
    """Eight recurrent steps from zero equal the JAX steps and the chunk
    scan's outputs and state."""
    q, k, v, li, lf = (a[..., :8, :] if a.ndim == 4 else a[..., :8]
                       for a in _mlstm_inputs(1))
    step = jax.jit(jx.mlstm_step)
    jst = (np.zeros((B, H, P, P), np.float32), np.zeros((B, H, P), np.float32),
           np.full((B, H), -1e30, np.float32))
    tst = tuple(map(torch.from_numpy, jst))
    ys, jys = [], []
    for t in range(8):
        args = (q[:, :, t], k[:, :, t], v[:, :, t], li[:, :, t], lf[:, :, t])
        jy, jst = step(*args, jst)
        ty, tst = xlstm.mlstm_step(*map(torch.from_numpy, args), tst)
        ys.append(ty.numpy())
        jys.append(np.asarray(jy))
    assert_trees_close([np.stack(ys, 2)] + [t.numpy() for t in tst],
                       [np.stack(jys, 2)] + list(jst))
    sy, sst = xlstm._mlstm_chunk_scan(*map(torch.from_numpy, (q, k, v, li,
                                                              lf)), 4)
    assert_trees_close([np.stack(ys, 2)] + [t.numpy() for t in tst],
                       [sy.numpy()] + [t.numpy() for t in sst], **DECODE)


@functools.lru_cache(maxsize=None)
def _slstm_setup():
    jcfg, tcfg = configs(ARCH)
    jp, tp = both_params(jcfg, seed=2)
    jsl = jax.tree.map(lambda a: a[0], jp["slstm"])
    tsl = xlstm._unstack(tp["slstm"], 1)[0]
    return jcfg, tcfg, jsl, tsl


def test_slstm_cell_matches_jax():
    jcfg, tcfg, jsl, tsl = _slstm_setup()
    d, Hs = tcfg.d_model, tcfg.num_heads
    gx, h, c, n = _draws(3, (B, 4 * d), (B, d), (B, d), (B, d))
    n = np.abs(n) + 0.5
    m = _draws(4, (B, d))[0]
    ref = jax.jit(jx._slstm_cell, static_argnums=(6, 7))(
        gx, jsl["r"], h, c, n, m, Hs, d // Hs)
    got = xlstm._slstm_cell(*map(torch.from_numpy, (gx, jsl["r"], h, c, n,
                                                    m)), Hs, d // Hs)
    assert_trees_close([t.numpy() for t in got], ref)


def test_slstm_apply_matches_jax():
    """The block over 16 steps from zero: its output and final state."""
    jcfg, tcfg, jsl, tsl = _slstm_setup()
    x = _draws(5, (B, 16, tcfg.d_model))[0]
    out, st = jax.jit(lambda p, a: jx.slstm_apply(p, jcfg, a))(jsl, x)
    tout, tst = xlstm.slstm_apply(tsl, tcfg, torch.from_numpy(x))
    assert_trees_close([tout.numpy()] + [t.numpy() for t in tst],
                       [out] + list(st))


@pytest.mark.parametrize("mask", [[1.0, 1.0], [1.0, 0.0], [0.0, 0.0]],
                         ids=["full", "prefix", "zero"])
def test_apply_and_logits_match_jax(mask):
    """The mask ``[L]`` is consumed pairwise: the prefix keeps the mLSTM
    block and gates off the sLSTM block; zero leaves the embedding."""
    assert_forward_matches_jax(ARCH, np.array(mask, np.float32))


def test_decode_matches_jax_and_the_forward():
    got, jgot, ref, cache = decode_runs(ARCH)
    np.testing.assert_allclose(got, ref, **DECODE)
    np.testing.assert_allclose(got, jgot, **F32)
    _, tcfg = configs(ARCH)
    C, n, m = cache["mlstm"]
    assert C.shape == (1, 2, tcfg.num_heads, 128, 128)
    assert all(t.dtype == torch.float32 for t in cache["mlstm"] +
               cache["slstm"])


def test_remat_modes_give_the_same_numbers():
    """``none`` and ``full`` (each pair recomputed) and ``dots`` (the
    reference checkpoints the pair with no policy: ``full``) give equal
    hidden states and gradients, bit for bit."""
    outs = remat_outputs(ARCH)
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


@pytest.fixture(scope="module")
def trained():
    return train_runs(ARCH)


def test_two_train_steps_match_jax(trained):
    assert_trained_like_jax(trained)


def test_slot_server_serves_the_jax_tokens():
    outs = served_tokens(ARCH)
    assert outs["port"] == outs["jax"]


def test_lm_params_from_jax_keeps_the_float32_leaves():
    """xlstm's bf16 tree: the ``mlstm`` and ``slstm`` stacks ``[L/2,
    ...]``, their gate and recurrent leaves float32, arrive leaf for leaf
    in their dtypes; both packages' bf16 forwards then agree at the bf16
    tolerance."""
    jcfg, tcfg = configs(ARCH, dtype="bfloat16")
    jp = bf16_tree(jcfg)
    tp = lm_params_from_jax(jp)
    f32 = {k for k, v in tp["mlstm"].items() if not isinstance(v, dict)
           and v.dtype == torch.float32} | \
        {"s." + k for k, v in tp["slstm"].items() if not isinstance(v, dict)
         and v.dtype == torch.float32}
    assert f32 == {"w_if", "b_if", "s.r", "s.b"}
    assert tp["mlstm"]["wq"].shape[0] == tcfg.num_layers // 2
    jl = jax.tree_util.tree_leaves(jp)
    assert len(jl) == len(tree_leaves(tp))
    for a, t in zip(jl, tree_leaves(tp)):
        assert str(t.dtype) == "torch." + a.dtype.name
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    toks = tokens(jcfg, 2, 16, seed=9)
    jh, _ = jax.jit(functools.partial(jax_build(jcfg).apply, remat="none"))(
        jp, jnp.asarray(toks))
    h, _ = build(tcfg).apply(tp, torch.from_numpy(toks), remat="none")
    ref = np.asarray(jh, np.float32)
    assert np.abs(h.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()


def test_three_heads_decode_and_forward_match_jax():
    """Heads that 4 does not divide (3, d 192: the mesh tests' config
    whose heads do not divide the model axis): each sLSTM gate's columns
    cross a head, and the decode and the forward equal the JAX model's."""
    got, jgot, ref, _ = decode_runs(ARCH, d_model=192, num_heads=3)
    np.testing.assert_allclose(got, ref, **DECODE)
    np.testing.assert_allclose(got, jgot, **F32)
