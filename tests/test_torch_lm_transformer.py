"""The port's dense decoder (``models/transformer.py`` through
``models/api.build``) against the JAX package's: ``apply`` under
``layer_mask`` ``[L]`` and ``[L, B]`` and ``logits_fn`` for every dense
arch's smoke config, remat modes, cached decode against the teacher-forced
forward (with and without a sliding window whose ring cache wraps: the
port's twin of ``tests/test_models.py::test_swa_ring_cache_wraps``), and
the prefill step with and without the kernel route.

The JAX params are numpy draws carried across by ``lm_params_from_jax``.
Tolerances: float32 forward rtol 1e-5, atol 1e-5 (two blocks' sums in
another order), and for logits an atol of 1e-6 of their largest
magnitude (tied N(0, 1) embeddings put them in the hundreds); decode
against the forward atol 2e-4, rtol 1e-3, and the kernel route (the JAX
Pallas kernel in interpret mode against the port's plain version on the
CPU) the same, the reference's own
(``tests/test_models.py:134-145``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JaxTrainConfig
from repro.launch.steps import build_prefill_step as jax_prefill_step
from repro.models import build as jax_build
from repro_torch.configs import TrainConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models.api import build
from repro_torch.tree import tree_leaves
from torch_lm import DENSE, both_params, configs

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-5)
DECODE = dict(atol=2e-4, rtol=1e-3)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg):
    """The JAX model's ``apply`` then ``logits``, jitted once per config."""
    m = jax_build(jcfg)

    @jax.jit
    def fwd(params, tokens, mask):
        h, aux = m.apply(params, tokens, layer_mask=mask, remat="none")
        return h, m.logits(params, h), aux
    return fwd


@pytest.mark.parametrize("mask_kind", ["[L]", "[L, B]"])
@pytest.mark.parametrize("arch", DENSE)
def test_apply_and_logits_match_jax(arch, mask_kind):
    """Layer gates as DR-FL's depth-prefix submodels: ``[L]`` keeps block
    0 only; ``[L, B]`` gives the two rows of the batch different depths.
    The smoke configs keep each arch's own options (command-r: tied
    embeddings)."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, seed=1)
    toks = _tokens(jcfg, 2, 12)
    mask = (np.array([1.0, 0.0], np.float32) if mask_kind == "[L]" else
            np.array([[1.0, 1.0], [1.0, 0.0]], np.float32))
    jh, jl, jaux = _jax_forward(jcfg)(jp, jnp.asarray(toks),
                                      jnp.asarray(mask))
    m = build(tcfg)
    h, aux = m.apply(tp, torch.from_numpy(toks), remat="none",
                     layer_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **F32)
    ref = np.asarray(jl)
    np.testing.assert_allclose(m.logits(tp, h).detach().numpy(), ref,
                               rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    assert float(aux) == float(jaux) == 0.0


def test_remat_modes_give_the_same_numbers():
    """``none``, ``full`` (per-block recompute) and ``dots`` (the matrix
    products saved) give equal hidden states and gradients, bit for
    bit: the recompute repeats the same operations."""
    _, tcfg = configs("phi3-mini-3.8b", num_kv_heads=2)
    m = build(tcfg)
    toks = torch.from_numpy(_tokens(tcfg, 2, 8, seed=2))
    outs = []
    for remat in ("none", "full", "dots"):
        params = m.init(torch.Generator().manual_seed(0))
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        h, _ = m.apply(params, toks, remat=remat)
        loss = m.logits(params, h).square().mean()
        grads = torch.autograd.grad(loss, leaves)
        outs.append([h.detach()] + list(grads))
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


@pytest.mark.parametrize("window", [0, 8], ids=["full cache",
                                                "SWA ring wraps"])
def test_decode_matches_prefill_and_jax(window):
    """Decode 24 tokens one at a time: the logits equal the teacher-forced
    forward's (with ``window`` 8 the cache is 8 rows, so the ring buffer
    wraps twice), and every step's logits equal the JAX decode step's."""
    jcfg, tcfg = configs("phi3-mini-3.8b", num_kv_heads=2, window=window)
    jp, tp = both_params(jcfg, seed=3)
    B, S = 1, 24
    toks = _tokens(jcfg, B, S, seed=4)
    jm, m = jax_build(jcfg), build(tcfg)
    h, _ = m.apply(tp, torch.from_numpy(toks), remat="none")
    ref = m.logits(tp, h).detach().numpy()
    cache = m.decode_init(tp, B, S)
    assert cache["k"].shape[2] == (window or S)
    jstep = jax.jit(jm.decode_step)
    jcache = jm.decode_init(jp, B, S)
    got, jgot = [], []
    for t in range(S):
        tok = toks[:, t:t + 1]
        lg, cache = m.decode_step(tp, cache, torch.from_numpy(tok), t)
        jlg, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.int32(t))
        got.append(lg[:, 0].numpy())
        jgot.append(np.asarray(jlg)[:, 0])
    np.testing.assert_allclose(np.stack(got, 1), ref, **DECODE)
    np.testing.assert_allclose(np.stack(got, 1), np.stack(jgot, 1), **F32)
    assert cache["pos"].tolist() == [S] * tcfg.num_layers


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "kernel route"])
def test_prefill_step_matches_jax(use_pallas):
    """``build_prefill_step``'s last-position logits, B 2 x S 16, 4 query
    heads over 2 KV heads: ``use_pallas=True`` runs the JAX Pallas kernel
    in interpret mode and the port's kernel wrapper, which takes its
    plain version on CPU tensors."""
    jcfg, tcfg = configs("yi-34b", num_kv_heads=2)
    jp, tp = both_params(jcfg, seed=5)
    toks = _tokens(jcfg, 2, 16, seed=6)
    _, jstep = jax_prefill_step(jcfg, JaxTrainConfig(use_pallas=use_pallas))
    ref = jax.jit(jstep)(jp, {"tokens": jnp.asarray(toks)})
    _, step = build_prefill_step(tcfg, TrainConfig(use_pallas=use_pallas))
    got = step(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 1, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               **(DECODE if use_pallas else F32))


def test_moe_blocks_are_refused():
    """Refused until ``models/moe.py`` was ported; now a MoE block is
    built: its tree (``moe`` in place of ``mlp``) has the JAX block's
    leaves, shapes and dtypes, the router float32 in a bf16 model."""
    jcfg, tcfg = configs("mixtral-8x22b", dtype="bfloat16")
    from repro_torch.models import transformer
    params = transformer.init(torch.Generator().manual_seed(0), tcfg)
    assert "mlp" not in params["blocks"] and "moe" in params["blocks"]
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    ref = jax.tree_util.tree_leaves(shapes)
    got = tree_leaves(params)
    assert [(str(t.dtype), tuple(t.shape)) for t in got] == \
        [("torch." + a.dtype.name, a.shape) for a in ref]
    assert params["blocks"]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "command-r-35b"],
                         ids=["untied", "tied"])
def test_lm_params_from_jax_carries_bf16_exactly(arch):
    """The JAX package's bfloat16 params (numpy's ``ml_dtypes`` type), the
    stacked ``[L, ...]`` blocks and the unembedding (untied: its own leaf;
    tied: none), arrive as bfloat16 tensors with the same values and the
    same tree; the bf16 forwards of both packages then agree at the bf16
    tolerance."""
    jcfg, tcfg = configs(arch, dtype="bfloat16")
    jp = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      both_params(jcfg, seed=8)[0])
    tp = lm_params_from_jax(jp)
    assert ("unembed" in tp) == (not tcfg.tie_embeddings)
    jl = jax.tree_util.tree_leaves(jp)
    assert len(jl) == len(tree_leaves(tp))
    for a, t in zip(jl, tree_leaves(tp)):
        assert a.dtype.name == "bfloat16" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    toks = _tokens(jcfg, 2, 8, seed=9)
    jh, _ = jax_build(jcfg).apply(jp, jnp.asarray(toks), remat="none")
    h, _ = build(tcfg).apply(tp, torch.from_numpy(toks), remat="none")
    ref = np.asarray(jh, np.float32)
    assert np.abs(h.float().numpy() - ref).max() <= \
        2e-2 * np.abs(ref).max()
