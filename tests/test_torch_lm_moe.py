"""The port's mixture-of-experts FFN (``models/moe.py``) and the ``moe``
family through ``models/transformer.py`` against the JAX package's, at
mixtral-8x22b's and qwen3-moe-235b-a22b's smoke configs (2 layers, d 256,
4 experts top-2; mixtral's window 64, qwen3's ``qk_norm``) and at a wider
routing variant of qwen3's (32 experts top-8, d 64, d_ff 64), where top-8
and heavy dropping show: the router (indices equal, weights and aux
within 1e-6); the routing recorder and pin (``moe.routes``) and the
dispatch's ``capacity`` and ``slots``; the capacity dispatch, forward
and gradient as ``jax.grad`` gives it, at the default capacity factor
1.25 (the seeds drop tokens; the port drops the same ones) and at 100
(nothing drops); the gather decode and the dispatch decode; ``apply``
and ``logits`` under ``[L]`` and ``[L, B]`` layer masks; 12 decode steps against the JAX
decode and the port's own forward (at capacity 100, as the reference's
own test, so the forward drops nothing the decode keeps); the prefill
step on the kernel route; two train steps with the router's aux term
in the loss; the slot server's tokens; and ``lm_params_from_jax`` on the
bf16 tree, whose router stays float32.

The JAX functions run under ``jit``; the params are numpy draws
(``tests/torch_lm.py``; the router and experts N(0, 1/d_in)).
Tolerances: the router atol and rtol 1e-6; the MoE FFN and the whole
forward in float32 rtol/atol 1e-5; the FFN's gradients rtol 1e-5 and
atol the larger of 1e-5 and 1e-6 of the leaf's largest magnitude
(``_grad_tol``); the gather and dispatch decodes
against each other atol 2e-5 rtol 1e-4 (``tests/test_perf_knobs.py``'s);
decode against the forward atol 2e-4 rtol 1e-3; losses and grad norms
rtol 1e-5, params within 2 lr an update; tokens and indices equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JaxTrainConfig
from repro.launch.steps import build_prefill_step as jax_prefill_step
from repro.models import build as jax_build
from repro.models import moe as jmoe
from repro_torch.configs import TrainConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.steps import build_prefill_step, build_train_step
from repro_torch.models import moe
from repro_torch.models.api import build
from repro_torch.models.layers import normal_by_matrix
from repro_torch.optim.optimizers import adamw_init
from repro_torch.tree import tree_leaves
from torch_lm import (DECODE, F32, assert_forward_matches_jax,
                      assert_trained_like_jax, bf16_tree, both_params,
                      configs, decode_runs, served_tokens, tokens,
                      train_runs)

torch.set_num_threads(1)
MIXTRAL, QWEN = "mixtral-8x22b", "qwen3-moe-235b-a22b"
ROUTE = dict(rtol=1e-6, atol=1e-6)
#: the variants of the FFN tests: (arch, changes to its smoke config)
VARIANTS = {"mixtral": (MIXTRAL, {}), "qwen3": (QWEN, {}),
            "qwen3 32x8": (QWEN, dict(num_experts=32, experts_per_token=8,
                                      d_model=64, head_dim=16, d_ff=64))}


@functools.lru_cache(maxsize=None)
def _layer0(variant, seed=0):
    """(JAX config, port config, the first block's ``moe`` params as
    numpy and as tensors, x [2, 32, d] as numpy: N(0, 1) draws about one
    N(0, 1) offset that every token shares, so the router favours some
    experts, as a batch of like tokens does, and capacity 1.25 drops
    choices: 19, 3 and 185 of the variants' 128, 128 and 512)."""
    arch, over = VARIANTS[variant]
    jcfg, tcfg = configs(arch, **over)
    jp, tp = both_params(jcfg, seed=seed)
    jm = {k: v[0] for k, v in jp["blocks"]["moe"].items()}
    tm = {k: v[0] for k, v in tp["blocks"]["moe"].items()}
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(2, 32, tcfg.d_model)) + \
        rng.normal(size=(1, 1, tcfg.d_model))
    return jcfg, tcfg, jm, tm, x.astype(np.float32)


def _grad_tol(ref):
    """rtol 1e-5, atol 1e-5 or 1e-6 of the leaf's largest magnitude: the
    router's gradient sums 64 tokens' products of the shared offset, up
    to ~100, whose float32 rounding in another order reaches 6e-5 where
    they cancel."""
    return dict(rtol=1e-5, atol=max(1e-5, 1e-6 * float(np.abs(ref).max())))


def _capacity(cfg, S, factor):
    E, K = cfg.num_experts, cfg.experts_per_token
    return max(K, int(np.ceil(S * K / E * factor)))


def _dropped(topi, E, C):
    """[B, S*K] bool: the choices past their expert's capacity C, the
    rank of a choice being its place among the row's choices of that
    expert, token-major and choice-minor."""
    flat = topi.reshape(topi.shape[0], -1)
    rank = np.zeros(flat.shape, np.int64)
    for b in range(flat.shape[0]):
        seen = np.zeros(E, np.int64)
        for t, e in enumerate(flat[b]):
            rank[b, t] = seen[e]
            seen[e] += 1
    return rank >= C


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_route_matches_jax(variant):
    """The top-k indices in the same (descending) order, the renormalised
    weights and the Switch aux loss."""
    jcfg, tcfg, jm, tm, x = _layer0(variant)
    jw, ji, jaux = jax.jit(lambda p, a: jmoe._route(p, jcfg, a))(jm, x)
    w, i, aux = moe._route(tm, tcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **ROUTE)
    np.testing.assert_allclose(float(aux), float(jaux), **ROUTE)
    assert (np.diff(w.numpy(), axis=-1) <= 0).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_routes_records_and_pins_the_routing(variant):
    """``moe.routes`` records the JAX router's indices, and the dispatch's
    ``capacity`` and ``slots`` drop the choices ``_dropped`` counts at
    1.25.  Replaying a forward's own routing gives that forward bitwise;
    replaying it with each token's K choices reversed routes as told, at
    capacity 100 the same sum over K in another order."""
    jcfg, tcfg, jm, tm, x = _layer0(variant)
    _, ji, _ = jax.jit(lambda p, a: jmoe._route(p, jcfg, a))(jm, x)
    E, K = tcfg.num_experts, tcfg.experts_per_token
    C = moe.capacity(32, K, E, 1.25)
    assert C == _capacity(tcfg, 32, 1.25)
    xt = torch.from_numpy(x)
    with moe.routes() as seen:
        y, _ = moe.moe_apply(tm, tcfg, xt, capacity_factor=100.0)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        (moe.slots(seen[0].reshape(2, -1), E) >= C).numpy(),
        _dropped(np.asarray(ji), E, C))
    with moe.routes(seen) as again:
        y_again, _ = moe.moe_apply(tm, tcfg, xt, capacity_factor=100.0)
    assert torch.equal(y_again, y) and torch.equal(again[0], seen[0])
    flipped = [seen[0].flip(-1)]
    with moe.routes(flipped) as pinned:
        y_flip, _ = moe.moe_apply(tm, tcfg, xt, capacity_factor=100.0)
    assert torch.equal(pinned[0], flipped[0])
    np.testing.assert_allclose(y_flip.numpy(), y.numpy(), **F32)


@pytest.mark.parametrize("factor", [1.25, 100.0], ids=["drops", "no drops"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_apply_and_its_gradient_match_jax(variant, factor):
    """``moe_apply`` over B 2 x S 32 and the gradient of ``sum(y * r) +
    aux`` with respect to the four leaves and x.  At 1.25 each seed drops
    choices (counted from the JAX router's indices), and an overwriting
    scatter would let a dropped choice's zero row replace the kept token
    in slot C - 1; at 100 none drops."""
    jcfg, tcfg, jm, tm, x = _layer0(variant)
    r = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    _, ji, _ = jax.jit(lambda p, a: jmoe._route(p, jcfg, a))(jm, x)
    n_drop = int(_dropped(np.asarray(ji), tcfg.num_experts,
                          _capacity(tcfg, 32, factor)).sum())
    assert (n_drop > 0) == (factor == 1.25), n_drop

    def jloss(p, a):
        y, aux = jmoe.moe_apply(p, jcfg, a, capacity_factor=factor)
        return jnp.sum(y * r) + aux, y

    (jl, jy), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True))(jm, x)
    leaves = {k: v.clone().requires_grad_() for k, v in tm.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(leaves, tcfg, xt, capacity_factor=factor)
    loss = (y * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(loss, list(leaves.values()) + [xt])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **F32)
    for name, g in zip(list(leaves) + ["x"], grads):
        ref = np.asarray(jg[1] if name == "x" else jg[0][name])
        np.testing.assert_allclose(g.numpy(), ref, err_msg=name,
                                   **_grad_tol(ref))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gather_and_dispatch_decode_match_jax(variant):
    """S == 1 over 8 tokens: the gather path (the default) against the
    JAX gather; ``moe_decode_impl="dispatch"`` (the batch as one
    sequence, capacity 100) against the JAX dispatch and against the
    gather (``tests/test_perf_knobs.py``'s check)."""
    jcfg, tcfg, jm, tm, _ = _layer0(variant)
    x = np.random.default_rng(3).normal(
        size=(8, 1, tcfg.d_model)).astype(np.float32)
    got = {}
    for impl in ("gather", "dispatch"):
        jc = dataclasses.replace(jcfg, moe_decode_impl=impl)
        tc = dataclasses.replace(tcfg, moe_decode_impl=impl)
        jy, jaux = jax.jit(lambda p, a: jmoe.moe_apply(
            p, jc, a, capacity_factor=100.0))(jm, x)
        y, aux = moe.moe_apply(tm, tc, torch.from_numpy(x),
                               capacity_factor=100.0)
        assert y.shape == (8, 1, tcfg.d_model)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
        np.testing.assert_allclose(float(aux), float(jaux), **ROUTE)
        got[impl] = y.numpy()
    np.testing.assert_allclose(got["dispatch"], got["gather"], atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("mask_kind", ["full", "[L]", "[L, B]"])
@pytest.mark.parametrize("arch", [MIXTRAL, QWEN])
def test_apply_and_logits_match_jax(arch, mask_kind):
    """``apply`` and ``logits`` at B 2 x S 32, and the aux loss summed
    over the layers by their gates' means: every layer, block 0 only
    (``[L]``), and the two rows at different depths (``[L, B]``)."""
    mask = {"full": np.ones(2, np.float32),
            "[L]": np.array([1.0, 0.0], np.float32),
            "[L, B]": np.array([[1.0, 1.0], [1.0, 0.0]], np.float32)}
    assert_forward_matches_jax(arch, mask[mask_kind])


@pytest.mark.parametrize("arch", [MIXTRAL, QWEN])
def test_decode_matches_jax_and_the_forward(arch):
    got, jgot, ref, cache = decode_runs(arch, moe_capacity_factor=100.0)
    np.testing.assert_allclose(got, ref, **DECODE)
    np.testing.assert_allclose(got, jgot, **F32)
    assert cache["pos"].tolist() == [12, 12]


def test_prefill_step_kernel_route_matches_jax():
    """qwen3's smoke config (``qk_norm``), B 2 x S 32, ``use_pallas``: the
    JAX Pallas kernel in interpret mode against the port's wrapper, which
    takes its plain version on CPU tensors."""
    jcfg, tcfg = configs(QWEN)
    jp, tp = both_params(jcfg, seed=2)
    toks = tokens(jcfg, 2, 32, seed=6)
    _, jstep = jax_prefill_step(jcfg, JaxTrainConfig(use_pallas=True))
    ref = jax.jit(jstep)(jp, {"tokens": jnp.asarray(toks)})
    _, step = build_prefill_step(tcfg, TrainConfig(use_pallas=True))
    got = step(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DECODE)


@pytest.fixture(scope="module", params=[MIXTRAL, QWEN])
def trained(request):
    return request.param, train_runs(request.param)


def test_two_train_steps_match_jax(trained):
    """Losses (with ``moe_aux_coef * aux / L``), grad norms and params
    against the JAX train step; the router stays float32."""
    _, runs = trained
    assert_trained_like_jax(runs)
    tp = runs["params"][1]
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32


def test_train_loss_carries_the_aux_term(trained):
    """The first step's loss without the aux term (``moe_aux_coef`` 0)
    falls short of the JAX loss by the term, ``0.01 * aux / L``: far more
    than the 1e-5 the losses are held to."""
    arch, runs = trained
    jcfg, tcfg = configs(arch)
    _, tp = both_params(jcfg, seed=7)
    batch = {k: torch.from_numpy(v) for k, v in runs["batches"][0].items()}
    _, aux = build(tcfg).apply(tp, batch["tokens"], remat="none")
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
              loss_chunk=16)
    _, step = build_train_step(dataclasses.replace(tcfg, moe_aux_coef=0.0),
                               TrainConfig(**kw))
    _, m = step({"params": tp, "opt": adamw_init(tp)}, batch)
    term = runs["jax"][0][0] - float(m["loss"])
    np.testing.assert_allclose(term, 0.01 * float(aux) / 2, rtol=1e-3)
    assert term > 1e-3 * runs["jax"][0][0]


@pytest.mark.parametrize("arch", [MIXTRAL, QWEN])
def test_slot_server_serves_the_jax_tokens(arch):
    outs = served_tokens(arch)
    assert outs["port"] == outs["jax"]


def test_lm_params_from_jax_carries_the_moe_tree():
    """mixtral's bf16 tree: the ``moe`` leaves arrive leaf for leaf, the
    router float32 and the experts bf16 ``[L, E, ...]``; the port's own
    init makes the same tree in the same dtypes, each expert matrix drawn
    at its scale."""
    jcfg, tcfg = configs(MIXTRAL, dtype="bfloat16")
    jp = bf16_tree(jcfg)
    tp = lm_params_from_jax(jp)
    tm = tp["blocks"]["moe"]
    assert tm["router"].dtype == torch.float32
    assert tm["w_gate"].shape == (2, 4, 256, 512)
    assert tm["w_down"].shape == (2, 4, 512, 256)
    jl = jax.tree_util.tree_leaves(jp)
    assert len(jl) == len(tree_leaves(tp))
    for a, t in zip(jl, tree_leaves(tp)):
        assert str(t.dtype) == "torch." + a.dtype.name
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    own = build(tcfg).init(torch.Generator().manual_seed(0))
    assert [(t.dtype, t.shape) for t in tree_leaves(own)] == \
        [(t.dtype, t.shape) for t in tree_leaves(tp)]
    std = own["blocks"]["moe"]["w_down"].float().std().item()
    assert abs(std * np.sqrt(512) - 1.0) < 0.01


def test_normal_by_matrix_draws_each_matrix_into_the_dtype():
    """Made in the dtype, each trailing matrix its own draw: equal to
    drawing the matrices one after another at the scale and casting."""
    g = torch.Generator().manual_seed(3)
    got = normal_by_matrix(g, (3, 4, 5), 0.5, torch.bfloat16, lead=(2,))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 4, 5)
    g = torch.Generator().manual_seed(3)
    ref = torch.stack([(0.5 * torch.randn((4, 5), generator=g))
                       .to(torch.bfloat16) for _ in range(6)])
    assert torch.equal(got.reshape(6, 4, 5), ref)
