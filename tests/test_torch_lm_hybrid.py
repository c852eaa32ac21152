"""The port's Mamba2 block (``models/ssm.py``) and Zamba2-style hybrid
(``models/hybrid.py``, the ``mamba-hybrid`` family) against the JAX
package's, at zamba2-1.2b's smoke config (2 Mamba blocks, d 256, P 64,
H 8, N 16, chunk 16, the shared attention block after both): the SSD
chunk scan (from zero and from a carried state), the recurrent decode
step, ``F.softplus`` against ``jax.nn.softplus``, ``apply`` and
``logits`` under a full, a prefix and a zero layer mask, the prefill step
on the kernel route, 12 decode steps against the JAX decode
and the port's own forward, the remat modes, two train steps, the slot
server's tokens, and ``lm_params_from_jax`` on the bf16 tree.

The JAX functions run under ``jit`` (its Pallas attention in interpret
mode under ``use_pallas``); the params are numpy draws
(``tests/torch_lm.py``).  Tolerances: float32 rtol/atol 1e-5, decode and
the kernel route atol 2e-4 rtol 1e-3, losses and grad norms rtol 1e-5,
served tokens equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import TrainConfig as JaxTrainConfig
from repro.launch.steps import build_prefill_step as jax_prefill_step
from repro.models import build as jax_build
from repro.models import hybrid as jh
from repro.models import ssm as js
from repro_torch.configs import TrainConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import hybrid, ssm
from repro_torch.models.api import build
from repro_torch.models.transformer import _unstack
from repro_torch.tree import tree_leaves
from torch_lm import (DECODE, F32, assert_forward_matches_jax,
                      assert_trained_like_jax, assert_trees_close,
                      bf16_tree, both_params, configs, decode_runs,
                      remat_outputs, served_tokens, tokens, train_runs)

torch.set_num_threads(1)
ARCH = "zamba2-1.2b"
B, S, H, P, N, CHUNK = 2, 32, 4, 16, 8, 8
#: the whole forward's tolerance, atol 2e-5 (not 1e-5): the port sits up
#: to 1.34e-5 from the JAX forward at seeds 1-3 (one element of 32768
#: past 1e-5 + 1e-5 |ref| at seed 1), and perturbing the port's own
#: params by 1e-7 relative moves its output by up to 2.12e-5: float32
#: rounding, not a fault, sets that gap
FWD = dict(rtol=1e-5, atol=2e-5)


def _ssd_inputs(seed=0):
    rng = np.random.default_rng(seed)
    xh, Bm, Cm = (rng.normal(size=s).astype(np.float32)
                  for s in ((B, S, H, P), (B, S, N), (B, S, N)))
    dt = np.asarray(jax.nn.softplus(rng.normal(size=(B, S, H)) - 1.0),
                    np.float32)
    log_a = -dt * np.exp(0.1 * rng.normal(size=H)).astype(np.float32)
    D = rng.normal(size=H).astype(np.float32)
    return xh, Bm, Cm, dt, log_a.astype(np.float32), D


_jax_ssd = jax.jit(js._ssd_chunk_scan, static_argnums=(6,))


@pytest.mark.parametrize("carried", [False, True],
                         ids=["from zero", "carried state"])
def test_ssd_chunk_scan_matches_jax(carried):
    """Four chunks of 8; the carried case starts from the state that
    another sequence of the same length leaves."""
    ins = _ssd_inputs()
    state = None
    if carried:
        state = np.asarray(_jax_ssd(*_ssd_inputs(1), CHUNK)[1])
    y, st = _jax_ssd(*ins, CHUNK, state)
    ty, tst = ssm._ssd_chunk_scan(
        *map(torch.from_numpy, ins), CHUNK,
        None if state is None else torch.from_numpy(state))
    assert_trees_close([ty.numpy(), tst.numpy()], [y, st])


@functools.lru_cache(maxsize=None)
def _block():
    """The smoke config's first Mamba block in both packages."""
    jcfg, tcfg = configs(ARCH)
    jp, tp = both_params(jcfg, seed=2)
    return (jcfg, tcfg, jax.tree.map(lambda a: a[0], jp["mamba"]),
            _unstack(tp["mamba"], tcfg.num_layers)[0])


def test_mamba_decode_matches_jax_and_the_block():
    """Twelve decode steps of one block from zero: each step's delta and
    the final state equal the JAX steps'; the deltas equal the block's
    chunked forward over the same 12 positions."""
    jcfg, tcfg, jp, tp = _block()
    x = np.random.default_rng(3).normal(
        size=(B, 12, tcfg.d_model)).astype(np.float32)
    step = jax.jit(lambda p, a, s: js.mamba_decode(p, jcfg, a, s))
    jst = js.mamba_state_init(jcfg, B)
    tst = ssm.mamba_state_init(tcfg, B, "cpu")
    got, ref = [], []
    for t in range(12):
        jd, jst = step(jp, x[:, t:t + 1], jst)
        td, tst = ssm.mamba_decode(tp, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                   tst)
        ref.append(np.asarray(jd))
        got.append(td.numpy())
    assert_trees_close(
        [np.concatenate(got, 1), tst["ssm"].numpy(), tst["conv"].numpy()],
        [np.concatenate(ref, 1), jst["ssm"], jst["conv"]])
    fwd, _ = ssm.mamba_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(np.concatenate(got, 1), fwd.numpy(), **DECODE)


def test_softplus_agrees_with_jax_at_the_drawn_gates():
    """``F.softplus`` (x above 20, else ``log1p(exp(x))``) against
    ``jax.nn.softplus`` (``logaddexp(x, 0)``) at the block's gate inputs
    and across the threshold: within 2 float32 ulps (the two formulas
    round 1 ulp apart at some inputs)."""
    jcfg, tcfg, jp, tp = _block()
    h = np.random.default_rng(4).normal(size=(B, S, tcfg.d_model))
    dt_raw = (h.astype(np.float32) @ jp["w_in"])[..., -8:] + jp["dt_bias"]
    edge = np.linspace(-30.0, 30.0, 601, dtype=np.float32)
    for a in (dt_raw.astype(np.float32), edge):
        np.testing.assert_allclose(F.softplus(torch.from_numpy(a)).numpy(),
                                   np.asarray(jax.nn.softplus(a)),
                                   rtol=2 * np.finfo(np.float32).eps,
                                   atol=0)


@pytest.mark.parametrize("mask", [[1.0, 1.0], [1.0, 0.0], [0.0, 0.0]],
                         ids=["full", "prefix", "zero"])
def test_apply_and_logits_match_jax(mask):
    """The mask covers the Mamba blocks; the shared block runs whatever
    the mask."""
    assert_forward_matches_jax(ARCH, np.array(mask, np.float32), tol=FWD)


def test_prefill_step_kernel_route_matches_jax():
    """``build_prefill_step``'s last-position logits, B 2 x S 32, with
    ``use_pallas=True``: the JAX Pallas kernel in interpret mode at the
    shared block against the port's kernel wrapper, which takes its plain
    version on CPU tensors (the plain route is the forward above)."""
    jcfg, tcfg = configs(ARCH)
    jp, tp = both_params(jcfg, seed=5)
    toks = tokens(jcfg, 2, 32, seed=6)
    _, jstep = jax_prefill_step(jcfg, JaxTrainConfig(use_pallas=True))
    ref = jax.jit(jstep)(jp, {"tokens": jnp.asarray(toks)})
    _, step = build_prefill_step(tcfg, TrainConfig(use_pallas=True))
    got = step(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 1, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DECODE)


def test_decode_matches_jax_and_the_forward():
    got, jgot, ref, cache = decode_runs(ARCH)
    np.testing.assert_allclose(got, ref, **DECODE)
    np.testing.assert_allclose(got, jgot, **F32)
    _, tcfg = configs(ARCH)
    assert hybrid.num_attn_sites(tcfg) == 1
    assert cache["attn"]["pos"].tolist() == [12]
    assert cache["mamba"]["ssm"].shape == (2, 2, 8, 16, 64)
    assert cache["mamba"]["conv"].dtype == torch.float32


def test_remat_modes_give_the_same_numbers():
    """Only the Mamba body is recomputed (``full``; the reference's
    ``jax.checkpoint`` has no policy, so ``dots`` is ``full``): hidden
    states and gradients equal ``none``'s bit for bit."""
    outs = remat_outputs(ARCH)
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


def test_zamba2_segments_and_sites():
    """zamba2-1.2b's 38 blocks in segments of 6 and a last 2: 6 sites,
    as the JAX package counts them."""
    jcfg, tcfg = configs(ARCH, num_layers=38, shared_attn_every=6)
    assert hybrid._segments(tcfg) == jh._segments(jcfg) == [6] * 6 + [2]
    assert hybrid.num_attn_sites(tcfg) == jh.num_attn_sites(jcfg) == 6


@pytest.fixture(scope="module")
def trained():
    return train_runs(ARCH)


def test_two_train_steps_match_jax(trained):
    assert_trained_like_jax(trained)


def test_slot_server_serves_the_jax_tokens():
    outs = served_tokens(ARCH)
    assert outs["port"] == outs["jax"]


def test_lm_params_from_jax_carries_the_hybrid_tree():
    """zamba2's bf16 tree: the ``mamba`` stack ``[L, ...]`` (its
    ``A_log``, ``dt_bias`` and ``D`` float32) and the unstacked
    ``shared_attn`` block arrive leaf for leaf in their dtypes; both
    packages' bf16 forwards then agree at the bf16 tolerance."""
    jcfg, tcfg = configs(ARCH, dtype="bfloat16")
    jp = bf16_tree(jcfg)
    tp = lm_params_from_jax(jp)
    assert {k for k, v in tp["mamba"].items() if not isinstance(v, dict)
            and v.dtype == torch.float32} == {"A_log", "dt_bias", "D"}
    assert tp["mamba"]["w_in"].shape[0] == tcfg.num_layers
    assert tp["shared_attn"]["attn"]["wq"]["w"].shape == (256, 256)
    jl = jax.tree_util.tree_leaves(jp)
    assert len(jl) == len(tree_leaves(tp))
    for a, t in zip(jl, tree_leaves(tp)):
        assert str(t.dtype) == "torch." + a.dtype.name
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    toks = tokens(jcfg, 2, 16, seed=9)
    jhid, _ = jax.jit(functools.partial(jax_build(jcfg).apply, remat="none"))(
        jp, jnp.asarray(toks))
    h, _ = build(tcfg).apply(tp, torch.from_numpy(toks), remat="none")
    ref = np.asarray(jhid, np.float32)
    assert np.abs(h.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()
