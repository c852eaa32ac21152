"""The port's CNN family against the JAX package's, from converted JAX
weights: every exit's logits, the DR-FL loss and its gradients, the
paper-scale cost model and the stack template.

Width 0.125 and 8x8 images, so every stride-2 stage pads asymmetrically
(TF SAME) and the last stage runs at 1x1.  Tolerances: forward logits and
the loss rtol=1e-5, atol=1e-6 (float32, different reduction order);
gradients rtol=1e-4, atol=1e-5 (a backward pass through ~20 layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.family import get_family as jax_get_family
from repro_torch.convert import cnn_params_from_jax, cnn_params_to_jax_layout
from repro_torch.models import cnn as tcnn
from repro_torch.models.family import get_family
from repro_torch.tree import tree_leaves, tree_unflatten_like

torch.set_num_threads(1)
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def jax_layout_params(width, seed=0):
    """A JAX-layout CNN tree (HWIO convs) of numpy draws, shaped by the
    JAX family's own init."""
    shapes = jax.eval_shape(
        lambda k: jax_get_family("cnn").init(k, 10, width_mult=width, hw=8),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * 0.3).astype(np.float32),
        shapes)


@pytest.fixture(scope="module")
def setup():
    jfam = jax_get_family("cnn")
    jp = jax_layout_params(0.125)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)
    return jfam, jp, cnn_params_from_jax(jp), x, y


def test_apply_all_exits_matches_jax(setup):
    jfam, jp, tp, x, _ = setup
    ref = jax.jit(jfam.apply_all_exits)(jp, jnp.asarray(x))
    got = tcnn.apply_all_exits(tp, torch.tensor(x))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **FWD)


@pytest.mark.parametrize("model_idx", [0, 3])
def test_drfl_loss_and_grads_match_jax(setup, model_idx):
    jfam, jp, tp, x, y = setup
    fam = get_family("cnn")
    jsub = jfam.submodel_tree(jp, model_idx)
    jl, jg = jax.jit(jax.value_and_grad(jfam.loss_fn("drfl")))(
        jsub, jnp.asarray(x), jnp.asarray(y))
    tsub = fam.submodel_tree(tp, model_idx)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tsub)]
    tl = fam.loss_fn("drfl")(tree_unflatten_like(tsub, leaves),
                             torch.tensor(x), torch.tensor(y))
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), **FWD)
    tg_jax = tree_leaves(cnn_params_to_jax_layout(
        tree_unflatten_like(tsub, list(tg))))
    for g, r in zip(tg_jax, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g, np.asarray(r), **GRAD)


def test_cost_model_equals_jax_exactly():
    sizes, fracs = get_family("cnn").cost_model(10)
    assert sizes == (609064, 2736424, 11234600, 45204776)
    jsizes, jfracs = jax_get_family("cnn").cost_model(10)
    assert sizes == tuple(int(s) for s in jsizes)
    assert fracs == tuple(jfracs)


@pytest.mark.parametrize("width", [0.125, 1.0])
def test_stack_template_equals_jax(width):
    jfam = jax_get_family("cnn")
    jshapes = jax.eval_shape(
        lambda k: jfam.init(k, 10, width_mult=width, hw=32),
        jax.random.PRNGKey(0))
    jt = jfam.stack_template(jshapes)
    tt = get_family("cnn").stack_template(
        tcnn.param_shapes(10, width_mult=width))
    assert tuple(tt) == tuple(jt)
    if width == 1.0:
        assert tt.n_rows == 11084


def test_eval_fn_matches_jax(setup):
    jfam, jp, tp, x, y = setup
    ref = np.asarray(jfam.eval_fn()(jp, jnp.asarray(x), jnp.asarray(y)))
    got = get_family("cnn").eval_fn(tp, torch.tensor(x),
                                    torch.tensor(y).long())
    np.testing.assert_allclose(got.numpy(), ref, **FWD)
