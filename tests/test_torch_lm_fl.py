"""The FL-over-pods steps (``launch/steps.py``: ``build_fl_train_step``,
``build_fl_bucketed_train_step``, ``fl_batch_extras``) and the layer-wise
submodels (``core/layerwise.py``) against the JAX package's.

``core/layerwise.py`` for every config in ``list_archs()`` (full and
smoke): the exit table, each submodel's mask, layer count and fraction,
the stack sizes, and ``stacked_update_mask`` over each smoke config's
param tree, leaf for leaf.  The masked step on phi3-mini's and mixtral's
smoke configs (mixtral's router adds its aux term) and the bucketed step
on phi3-mini's, one step each from params carried by
``lm_params_from_jax``: loss, grad norm and the first moments (the
rescaled gradient, scaled by 1 - beta1) at rtol/atol 1e-5, the updated
params at 1e-5 but for the few whose gradient sits at AdamW's eps (held
within 2 lr, as ``tests/torch_lm.py`` holds train steps).
The port's bucketed step against its masked step at the reference's
tolerances (``tests/test_perf_knobs.py``: loss rel 1e-6, params atol 1e-6
rtol 1e-5), and the reference's ``tests/test_fl_step.py`` check on the
port: the masked gradient, rescaled, equals the explicit per-client
layer-aligned mean (atol 2e-4, rtol 2e-3, the reference's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JaxShapeConfig
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core import layerwise as jlw
from repro.launch import steps as jsteps
from repro.models import build as jax_build
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import ShapeConfig, TrainConfig, get_config, \
    list_archs, reduced
from repro_torch.core import layerwise as lw
from repro_torch.launch import steps
from repro_torch.models.api import build
from repro_torch.optim.optimizers import adamw_init
from repro_torch.tree import tree_leaves
from torch_lm import both_params, configs

torch.set_num_threads(1)
PHI3, MIXTRAL = "phi3-mini-3.8b", "mixtral-8x22b"
KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10, loss_chunk=8,
          remat="none")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", list_archs())
def test_layerwise_equals_the_reference(arch):
    for jcfg, cfg in ((jax_get_config(arch), get_config(arch)),
                      configs(arch)):
        assert tuple(lw.exit_points(cfg)) == tuple(jlw.exit_points(jcfg))
        assert lw.num_submodels(cfg) == jlw.num_submodels(jcfg)
        assert lw._stack_sizes(cfg) == jlw._stack_sizes(jcfg)
        for m in range(lw.num_submodels(cfg)):
            mask = lw.layer_mask(cfg, m, device="cpu")
            assert mask.dtype == torch.float32
            np.testing.assert_array_equal(mask.numpy(),
                                          np.asarray(jlw.layer_mask(jcfg, m)))
            assert lw.submodel_layer_count(cfg, m) == \
                jlw.submodel_layer_count(jcfg, m)
            assert lw.submodel_fraction(cfg, m) == \
                jlw.submodel_fraction(jcfg, m)
    # the smoke config's param tree, leaf for leaf
    params = build(cfg).init(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    for m in range(lw.num_submodels(cfg)):
        got = tree_leaves(lw.stacked_update_mask(cfg, m, params))
        ref = jax.tree_util.tree_leaves(jlw.stacked_update_mask(jcfg, m,
                                                                shapes))
        assert len(got) == len(ref) == len(tree_leaves(params))
        for a, b in zip(got, ref):
            assert a.dtype == torch.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _fl_batch(cfg, B=4, S=16, seed=5):
    """Four clients, one row each, on submodels 0, 1, 0, 1: numpy tokens,
    labels, gates [L, B], counts [L] and the client count."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    gates = np.stack([np.asarray(jlw.layer_mask(cfg, i % 2))
                      for i in range(B)], axis=1).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "layer_gates": gates, "layer_counts": gates.sum(axis=1),
            "n_clients": np.float32(B)}


def _one_step(arch, bucketed):
    """One FL step in both packages from the same params: ((loss, grad
    norm), mu, params) by package."""
    jcfg, cfg = configs(arch)
    jp, tp = both_params(jcfg, seed=4)
    batch = _fl_batch(jcfg)
    if bucketed:
        _, jstep, nb = jsteps.build_fl_bucketed_train_step(
            jcfg, JaxTrainConfig(**KW))
        _, step, tnb = steps.build_fl_bucketed_train_step(cfg,
                                                          TrainConfig(**KW))
        assert tnb == nb == 2
        batch = {k: batch[k].reshape((nb, -1) + batch[k].shape[1:])
                 for k in ("tokens", "labels")}
    else:
        _, jstep = jsteps.build_fl_train_step(jcfg, JaxTrainConfig(**KW))
        _, step = steps.build_fl_train_step(cfg, TrainConfig(**KW))
    js, jm = jax.jit(jstep)({"params": jax.tree.map(jnp.asarray, jp),
                             "opt": jax_adamw_init(jp)},
                            {k: jnp.asarray(v) for k, v in batch.items()})
    st, m = step({"params": tp, "opt": adamw_init(tp)},
                 {k: torch.as_tensor(v) for k, v in batch.items()})
    return ({"jax": (float(jm["loss"]), float(jm["grad_norm"])),
             "port": (float(m["loss"]), float(m["grad_norm"])),
             "lr": float(m["lr"])},
            (jax.tree.map(np.asarray, js["opt"]["mu"]), st["opt"]["mu"]),
            (jax.tree.map(np.asarray, js["params"]), st["params"]))


@pytest.mark.parametrize("arch,bucketed", [(PHI3, False), (MIXTRAL, False),
                                           (PHI3, True)])
def test_fl_step_matches_jax(arch, bucketed):
    """Loss, grad norm and the first moments at 1e-5; the params at 1e-5
    but where a gradient sits at AdamW's eps, which moves its param by up
    to lr either way on a rounding of the gradient (2 lr, as
    ``torch_lm.assert_trained_like_jax`` allows)."""
    metrics, mu, params = _one_step(arch, bucketed)
    np.testing.assert_allclose(metrics["port"], metrics["jax"], **TOL)
    for (ref, got), tol in ((mu, TOL), (params, dict(
            rtol=1e-5, atol=2 * metrics["lr"]))):
        ref = jax.tree_util.tree_leaves(ref)
        assert len(ref) == len(tree_leaves(got))
        for a, b in zip(tree_leaves(got), ref):
            a = a.detach().numpy()
            np.testing.assert_allclose(a, b, **tol)
            # all but a few elements at 1e-5
            assert np.mean(~np.isclose(a, b, **TOL)) < 1e-4


def test_fl_batch_extras_match_jax():
    jcfg, cfg = configs(PHI3)
    got = steps.fl_batch_extras(cfg, ShapeConfig("s", 16, 8, "train"))
    ref = jsteps.fl_batch_extras(jcfg, JaxShapeConfig("s", 16, 8, "train"))
    assert got == {k: (tuple(s.shape), getattr(torch, str(s.dtype)))
                   for k, s in ref.items()}


def test_fl_bucketed_step_equals_masked():
    """``tests/test_perf_knobs.py::test_fl_bucketed_step_bitwise_equals_
    masked`` on the port: the reference's config and client layout (two
    clients a bucket, contiguous)."""
    cfg = reduced(get_config(PHI3))
    tcfg = TrainConfig(loss_chunk=8, remat="none")
    model, fl_step = steps.build_fl_train_step(cfg, tcfg)
    _, bstep, nb = steps.build_fl_bucketed_train_step(cfg, tcfg)
    states = [{"params": p, "opt": adamw_init(p)} for p in (
        model.init(torch.Generator().manual_seed(0)) for _ in range(2))]
    B, S = 2 * nb, 16
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    exits = lw.exit_points(cfg)
    gates = torch.stack(sum(([lw.layer_mask(cfg, b, device="cpu")] *
                             (B // nb) for b in range(nb)), []), dim=1)
    counts = torch.tensor([sum(1 for k in exits if l < k)
                           for l in range(cfg.num_layers)],
                          dtype=torch.float32)
    s1, m1 = fl_step(states[0], {"tokens": tokens, "labels": labels,
                                 "layer_gates": gates, "layer_counts": counts,
                                 "n_clients": float(nb)})
    s2, m2 = bstep(states[1], {"tokens": tokens.reshape(nb, B // nb, S),
                               "labels": labels.reshape(nb, B // nb, S)})
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-6)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, rtol=1e-5)


def test_fl_step_grads_equal_explicit_layerwise_mean():
    """``tests/test_fl_step.py``'s check on the port: the FL step's
    gradient (the masked batch's, rescaled by ``n_clients / count``) is
    the per-client gradients' layer-aligned masked mean."""
    cfg = reduced(get_config(PHI3))
    tcfg = TrainConfig(loss_chunk=8, remat="none", grad_clip=0.0,
                       weight_decay=0.0)
    model, fl_step = steps.build_fl_train_step(cfg, tcfg)
    params = model.init(torch.Generator().manual_seed(0))
    n_clients, per = 2, 2
    B, S = n_clients * per, 16
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    m0 = lw.layer_mask(cfg, 0, device="cpu")      # client 0: shallow prefix
    m1 = lw.layer_mask(cfg, 1, device="cpu")      # client 1: full depth
    gates = torch.stack([m0] * per + [m1] * per, dim=1)     # [L, B]
    counts = m0 + m1
    _, g_fl = fl_step.grads(params, {
        "tokens": tokens, "labels": labels, "layer_gates": gates,
        "layer_counts": counts, "n_clients": float(n_clients)})

    def client_grads(sl, m):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        from repro_torch.tree import tree_unflatten_like
        p = tree_unflatten_like(params, leaves)
        hidden, _ = model.apply(p, tokens[sl], {}, layer_mask=m,
                                remat="none")
        loss = steps.chunked_cross_entropy(hidden, steps._unembed(model, p),
                                           labels[sl], 8)
        return torch.autograd.grad(loss, leaves)

    g0 = client_grads(slice(0, per), m0)
    g1 = client_grads(slice(per, None), m1)
    for i, (a, b, got) in enumerate(zip(g0, g1, tree_leaves(g_fl))):
        if a.dim() >= 1 and a.shape[0] == cfg.num_layers:
            den = counts.reshape((-1,) + (1,) * (a.dim() - 1))
            ref = (a + b) / torch.clamp_min(den, 1.0) * \
                torch.clamp_max(den, 1.0)
        else:
            ref = (a + b) / 2.0
        np.testing.assert_allclose(got.detach().numpy(), ref.numpy(),
                                   atol=2e-4, rtol=2e-3, err_msg=f"leaf {i}")
