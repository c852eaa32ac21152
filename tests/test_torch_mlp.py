"""The ``mlp`` family and the family registry against the JAX package:
LayerNorm and the GELU MLP, the forward at every exit, the DR-FL loss and
its gradient against ``jax.grad``, the cost model, stack templates and
update masks, live runs of both engines and both
executors, a sync JAX ``mlp`` checkpoint resumed in the port, and a
family registered by its user in both packages.

Weights reach the port through ``repro_torch.convert.params_from_jax``
(leaf for leaf).  Tolerances: shapes, sizes, FLOPs, templates and masks
exact; one forward or gradient rtol=1e-5, atol=1e-6 (float32 sums in
another order); anything after SGD the live tests' rtol=1e-4, atol=1e-5;
picks identical.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointHalt as JaxCheckpointHalt
from repro.fl import simulation as jsim
from repro.fl.engine import RoundEngine as JaxRoundEngine
from repro.models import family as jfamily
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro_torch.convert import params_from_jax
from repro_torch.fl import simulation as tsim
from repro_torch.fl.spec import ModelSpec, SimulationSpec
from repro_torch.models import family as tfamily
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like
from torch_live import (BASE, assert_async_runs_agree, assert_runs_agree,
                        run_both)

torch.set_num_threads(1)
ONE = dict(rtol=1e-5, atol=1e-6)
SGD = dict(rtol=1e-4, atol=1e-5)


def _jax_params(width, hw, seed=0):
    return jmlp.init(jax.random.PRNGKey(seed), 10, width_mult=width, hw=hw)


def _batch(n, hw, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, hw, hw, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("shape", [(5, 16), (3, 7, 256)])
def test_layernorm_and_its_gradient_equal_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=shape[-1]).astype(np.float32),
         "bias": rng.normal(size=shape[-1]).astype(np.float32)}
    dy = rng.normal(size=shape).astype(np.float32)

    def jf(x, p):
        return jnp.sum(jlayers.layernorm_apply(p, x) * dy)
    jgx, jgp = jax.grad(jf, argnums=(0, 1))(x, p)
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    y = tlayers.layernorm_apply(tp, tx)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jlayers.layernorm_apply(p, x)),
                               **ONE)
    gx, gs, gb = torch.autograd.grad((y * torch.tensor(dy)).sum(),
                                     [tx, tp["scale"], tp["bias"]])
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **ONE)
    np.testing.assert_allclose(gs.numpy(), np.asarray(jgp["scale"]), **ONE)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgp["bias"]), **ONE)
    init = tlayers.layernorm_init(shape[-1])
    assert {k: v.tolist() for k, v in init.items()} == {
        k: np.asarray(v).tolist()
        for k, v in jlayers.layernorm_init(shape[-1], jnp.float32).items()}


def test_gelu_mlp_equals_jax():
    jp = jlayers.gelu_mlp_init(jax.random.PRNGKey(3), 32, 64, jnp.float32)
    x = np.random.default_rng(3).normal(size=(4, 32)).astype(np.float32)
    got = tlayers.gelu_mlp_apply(params_from_jax(jp), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jlayers.gelu_mlp_apply(jp, x)),
                               **ONE)


@pytest.mark.parametrize("width,hw", [(0.125, 8), (1.0, 32)])
def test_init_tree_and_param_shapes_equal_jax(width, hw):
    jshapes = jax.eval_shape(lambda k: jmlp.init(k, 10, width_mult=width,
                                                 hw=hw),
                             jax.random.PRNGKey(0))
    fam = tfamily.get_family("mlp")
    tp = fam.init(torch.Generator().manual_seed(0), 10, width_mult=width,
                  hw=hw)
    meta = fam.param_shapes(10, width_mult=width, hw=hw)
    want = [tuple(l.shape) for l in jax.tree.leaves(jshapes)]
    for tree in (tp, meta):
        assert [tuple(l.shape) for l in tree_leaves(tree)] == want
    assert all(l.is_meta for l in tree_leaves(meta))
    jt = jfamily.get_family("mlp").stack_template(jshapes)
    assert tuple(fam.stack_template(meta)) == tuple(jt)
    if width == 1.0:     # the full width the slice runs on the card
        assert sum(l.numel() for l in tree_leaves(meta)) == 2906920
        assert jt.n_rows == 2845


@pytest.mark.parametrize("width,hw", [(0.125, 8), (0.5, 16)])
def test_apply_all_exits_equal_jax(width, hw):
    jp = _jax_params(width, hw)
    x, _ = _batch(6, hw, 1)
    got = tmlp.apply_all_exits(params_from_jax(jp), torch.tensor(x))
    ref = jmlp.apply_all_exits(jp, x)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **ONE)
    for m in range(4):
        np.testing.assert_allclose(
            tmlp.apply(params_from_jax(jp), torch.tensor(x), m).numpy(),
            np.asarray(jmlp.apply(jp, x, m)), **ONE)


def test_stacked_forward_equals_one_participant_at_a_time():
    """``apply_all_exits_stacked`` over 3 participants' trees (truncated
    at submodel 2) and batches equals ``apply_all_exits`` on each."""
    trees = [params_from_jax(jfamily.get_family("mlp").submodel_tree(
        _jax_params(0.25, 8, seed=s), 2)) for s in range(3)]
    xs = [torch.tensor(_batch(5, 8, s)[0]) for s in range(3)]
    stacked = tree_map(lambda *ls: torch.stack(ls), *trees)
    got = tmlp.apply_all_exits_stacked(stacked, torch.stack(xs))
    assert len(got) == 3
    for p, (tree, x) in enumerate(zip(trees, xs)):
        for g, r in zip(got, tmlp.apply_all_exits(tree, x)):
            np.testing.assert_allclose(g[p].numpy(), r.numpy(), **ONE)


@pytest.mark.parametrize("model_idx", [0, 1, 2, 3])
def test_drfl_loss_and_gradient_equal_jax(model_idx):
    jfam, tfam = jfamily.get_family("mlp"), tfamily.get_family("mlp")
    jp = _jax_params(0.25, 8, seed=model_idx)
    x, y = _batch(12, 8, model_idx)

    def jloss(p):
        return jfam.loss_fn("drfl")(jfam.submodel_tree(p, model_idx), x, y)
    jl, jg = jax.value_and_grad(jloss)(jp)
    leaves = [l.requires_grad_() for l in tree_leaves(params_from_jax(jp))]
    tp = tree_unflatten_like(params_from_jax(jp), leaves)
    tl = tfam._drfl_step_loss(tp, torch.tensor(x), torch.tensor(y).long(),
                              model_idx)
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(tl.item(), float(jl), **ONE)
    for g, r in zip(grads, jax.tree.leaves(jg)):
        g = torch.zeros(r.shape) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **ONE)


def test_flops_cost_model_masks_and_summary_equal_jax():
    jfam, tfam = jfamily.get_family("mlp"), tfamily.get_family("mlp")
    assert tfam.cost_model(10) == jfam.cost_model(10)
    assert tfam.num_submodels() == jfam.num_submodels() == 4
    for m in range(4):
        for hw, width in ((32, 1.0), (8, 0.125)):
            assert tfam.flops_per_sample(m, hw, width) == \
                jfam.flops_per_sample(m, hw, width)
    jp = _jax_params(0.125, 8)
    tp = params_from_jax(jp)
    for m in range(4):
        for scale in (1.0, 0.5):
            got = [float(t) for t in tree_leaves(tfam.update_mask(tp, m,
                                                                  scale))]
            ref = [float(t) for t in jax.tree.leaves(jfam.update_mask(
                jp, m, scale))]
            assert got == ref
        assert tfam.held_groups(tp, m) == jfam.held_groups(jp, m)
        assert tfam.submodel_size_bytes(tp, m) == \
            jfam.submodel_size_bytes(jp, m)
    assert tfam.state_summary_width() == jfam.state_summary_width() == 25
    from repro.core.fleet import make_fleet_state as jax_fleet
    from repro_torch.core.fleet import make_fleet_state
    got = tfam.fleet_summary(make_fleet_state(
        40, 2, device="cpu", dtype=torch.float64), 3, 10)
    ref = jfam.fleet_summary(jax_fleet(40, 2, backend="numpy"), 3, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)


MLP = dict(BASE, model_family="mlp")
LIVE_ARMS = {
    "sync-perclient": (dict(MLP), "perclient"),
    "sync-batched": (dict(MLP, client_executor="batched"), "batched"),
    "async-perclient": (dict(MLP, engine_mode="async", n_rounds=2),
                        "perclient"),
}


@pytest.mark.parametrize("arm", list(LIVE_ARMS))
def test_live_mlp_run_agrees_with_jax(arm):
    """DR-FL + MARL (ε 0) on the ``mlp`` family, both packages from the
    JAX init: picks exact, weights and the QMIX state within the live
    tests' tolerances.  The batched arm's bucket programs run the
    written-out stacked forward in the port, a ``jax.vmap`` of the jitted
    step in the reference."""
    assert tfamily.get_family("mlp").stacked_forward
    kw, executor = LIVE_ARMS[arm]
    jh, th, jsel, tsel = run_both(kw)
    if kw.get("engine_mode") == "async":
        assert_async_runs_agree(kw, jh, th, jsel, tsel, executor)
    else:
        assert_runs_agree(kw, jh, th, jsel, tsel, executor)


def test_jax_mlp_checkpoint_resumes_in_the_port(tmp_path):
    """A sync JAX ``mlp`` run killed after its first save and resumed by
    the port's ``run_simulation(resume=True)`` (the weights carried leaf
    for leaf), against the JAX run uninterrupted."""
    kw = dict(MLP, selector="greedy")
    jh = JaxRoundEngine(jsim.FLConfig(**kw), jsim._make_selector(
        jsim.FLConfig(**kw), 4)).run()
    ck = dict(kw, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    with pytest.raises(JaxCheckpointHalt):
        JaxRoundEngine(jsim.FLConfig(**ck), jsim._make_selector(
            jsim.FLConfig(**ck), 4), halt_counter={"remaining": 1}).run()
    th = tsim.run_simulation(tsim.FLConfig(**ck, resume=True), device="cpu")
    assert th["phase_s"][0] == {} and th["phase_s"][-1]
    assert_runs_agree(kw, jh, th, None, None, "perclient")


# -- a family its user registers, in both packages --------------------------

TOY_D = 16


class _JaxToy(jfamily.LayerwiseFamily):
    """A tanh MLP with no biases in the canonical layout."""
    name = "toy"

    def init(self, key, num_classes=10, width_mult=1.0, hw=32):
        ks = jax.random.split(key, 9)

        def w(k, a, b):
            return jax.random.normal(k, (a, b)) / math.sqrt(a)
        return {"stem": {"w": w(ks[0], hw * hw * 3, TOY_D)},
                "stages": [{"w": w(ks[1 + i], TOY_D, TOY_D)}
                           for i in range(4)],
                "exits": [{"w": w(ks[5 + i], TOY_D, num_classes)}
                          for i in range(4)]}

    def num_submodels(self):
        return 4

    def apply_all_exits(self, params, x):
        h = jnp.tanh(x.reshape(x.shape[0], -1) @ params["stem"]["w"])
        outs = []
        for st, ex in zip(params["stages"], params["exits"]):
            h = jnp.tanh(h @ st["w"])
            outs.append(h @ ex["w"])
        return outs

    def flops_per_sample(self, model_idx, image_hw=32, width_mult=1.0):
        return 2.0 * (image_hw * image_hw * 3 * TOY_D
                      + (model_idx + 1) * TOY_D * TOY_D + TOY_D * 10)


class _TorchToy(tfamily.LayerwiseFamily):
    name = "toy"

    def init(self, gen, num_classes=10, width_mult=1.0, hw=32):
        def w(a, b):
            return torch.randn((a, b), generator=gen) / math.sqrt(a)
        return {"stem": {"w": w(hw * hw * 3, TOY_D)},
                "stages": [{"w": w(TOY_D, TOY_D)} for _ in range(4)],
                "exits": [{"w": w(TOY_D, num_classes)} for _ in range(4)]}

    def num_submodels(self):
        return 4

    def apply_all_exits(self, params, x):
        h = torch.tanh(x.reshape(x.shape[0], -1) @ params["stem"]["w"])
        outs = []
        for st, ex in zip(params["stages"], params["exits"]):
            h = torch.tanh(h @ st["w"])
            outs.append(h @ ex["w"])
        return outs

    flops_per_sample = _JaxToy.flops_per_sample


@pytest.fixture
def toy():
    jfamily.register_family(_JaxToy())
    fam = tfamily.register_family(_TorchToy())
    yield fam
    jfamily._REGISTRY.pop("toy")
    tfamily._REGISTRY.pop("toy")


def test_a_registered_family_runs_in_both_packages(toy):
    assert "toy" in tfamily.known_families()
    assert tfamily.resolve_family(toy) is toy is tfamily.get_family("toy")
    assert toy.cost_model(10) == jfamily.get_family("toy").cost_model(10)
    SimulationSpec(model=ModelSpec(family="toy"))          # validates
    kw = dict(BASE, model_family="toy", client_executor="batched")
    jh, th, jsel, tsel = run_both(kw)
    assert_runs_agree(kw, jh, th, jsel, tsel, "batched")
