"""The HeteroFL and ScaleFL baselines against the JAX package's: the width
slices in the port's OIHW layout, the ScaleFL distillation loss, one
client's local training for every submodel, the sliced scatter
aggregations (with a poisoned client), and live runs of both arms on the
per-client and the bucketed executor.

A slice that were right in HWIO and wrong in OIHW would still run (a cin
and a cout slice of a square conv have one shape), so the slices are held
to the JAX values, converted, exactly.  Tolerances: slices exact; losses
and gradients rtol=1e-5, atol=1e-6; after SGD rtol=1e-4, atol=1e-5;
picks identical.

Training is checked from the CNN's own init on 16x16 images.  At 8x8 the
last stage runs at 1x1, where the narrow slices' GroupNorm groups hold 2
to 4 values: there one HeteroFL update of the JAX package in float32 is
8e-3 away from the same update in float64, further than it is from the
port's, so no float32 implementation meets 1e-4 against it.  At 16x16
both packages are within 4e-6 of float64 for every slice.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.fl import server as jserver
from repro.models.family import get_family as jax_get_family
from repro_torch.convert import cnn_params_from_jax, cnn_params_to_jax_layout
from repro_torch.core import baselines as tbase
from repro_torch.fl import batch as tbatch
from repro_torch.fl import server as tserver
from repro_torch.fl.client import (heterofl_client_update,
                                   scalefl_client_update,
                                   scalefl_submodel_loss,
                                   slice_submodel_loss)
from repro_torch.models.family import get_family
from repro_torch.tree import tree_leaves, tree_unflatten_like
from torch_live import BASE, assert_runs_agree, run_both

torch.set_num_threads(1)
SGD = dict(rtol=1e-4, atol=1e-5)
ONE = dict(rtol=1e-5, atol=1e-6)


def _jax_tree(width, seed, scale=0.3):
    shapes = jax.eval_shape(
        lambda k: jax_get_family("cnn").init(k, 10, width_mult=width, hw=8),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * scale).astype(np.float32),
        shapes)


def _assert_tree_equal(got, ref):
    """A port tree (OIHW) equals a JAX one (HWIO) exactly."""
    g, r = tree_leaves(got), tree_leaves(cnn_params_from_jax(ref))
    assert len(g) == len(r)
    for a, b in zip(g, r):
        assert a.shape == b.shape
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def setup():
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda k: jax_get_family("cnn").init(k, 10, width_mult=0.125,
                                             hw=16))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 40).astype(np.int32)
    return jp, cnn_params_from_jax(jp), x, y


@pytest.mark.parametrize("frac", tbase.WIDTH_LEVELS)
def test_width_slice_matches_jax_exactly(setup, frac):
    jp, tp, _, _ = setup
    _assert_tree_equal(tbase.width_slice_cnn(tp, frac),
                       jbase.width_slice_cnn(jp, frac))


@pytest.mark.parametrize("model_idx", [0, 1, 2, 3])
def test_scalefl_submodel_matches_jax_exactly(setup, model_idx):
    jp, tp, _, _ = setup
    got = tbase.scalefl_submodel(tp, model_idx)
    assert len(got["stages"]) == len(got["exits"]) == model_idx + 1
    _assert_tree_equal(got, jbase.scalefl_submodel(jp, model_idx))


def test_width_slice_is_not_transposed():
    """A square conv whose cin and cout differ in value: the slice keeps
    the [cout, cin] prefix of OIHW, the JAX [.., cin, cout] one."""
    jp = _jax_tree(1.0, 3)
    tp = cnn_params_from_jax(jp)
    w = tbase.width_slice_cnn(tp, 0.5)["stages"][1][1]["conv1"]
    ref = jbase.width_slice_cnn(jp, 0.5)["stages"][1][1]["conv1"]
    assert w.shape == (64, 64, 3, 3)
    np.testing.assert_array_equal(w.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(ref))


def test_kd_loss_value_and_grad_match_jax():
    rng = np.random.default_rng(4)
    s = rng.normal(size=(16, 10)).astype(np.float32) * 3
    t = rng.normal(size=(16, 10)).astype(np.float32) * 3
    jl, jg = jax.value_and_grad(jbase.kd_loss)(jnp.asarray(s),
                                               jnp.asarray(t))
    st = torch.tensor(s, requires_grad=True)
    tl = tbase.kd_loss(st, torch.tensor(t))
    (tg,) = torch.autograd.grad(tl, st)
    np.testing.assert_allclose(tl.item(), float(jl), **ONE)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **ONE)


@pytest.mark.parametrize("method,model_idx", [
    ("heterofl", 0), ("heterofl", 3), ("scalefl", 0), ("scalefl", 2),
    ("scalefl", 3)])
def test_baseline_loss_and_grads_match_jax(setup, method, model_idx):
    jp, tp, x, y = setup
    jfam, fam = jax_get_family("cnn"), get_family("cnn")
    jsub = jfam.submodel_params(method, jp, model_idx)
    jl, jg = jax.jit(jax.value_and_grad(jfam.loss_fn(method)))(
        jsub, jnp.asarray(x[:16]), jnp.asarray(y[:16]))
    tsub = fam.submodel_params(method, tp, model_idx)
    leaves = [l.detach().clone().requires_grad_() for l in tree_leaves(tsub)]
    alias = slice_submodel_loss if method == "heterofl" \
        else scalefl_submodel_loss
    tl = alias(tree_unflatten_like(tsub, leaves), torch.tensor(x[:16]),
               torch.tensor(y[:16]).long())
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(tl.item(), float(jl), **ONE)
    grads = [torch.zeros_like(l) if g is None else g
             for l, g in zip(leaves, grads)]
    got = tree_leaves(cnn_params_to_jax_layout(
        tree_unflatten_like(tsub, grads)))
    for g, r in zip(got, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g, np.asarray(r), **SGD)


@pytest.mark.parametrize("method", ["heterofl", "scalefl"])
@pytest.mark.parametrize("model_idx", [0, 1, 2, 3])
def test_baseline_client_update_matches_jax(setup, method, model_idx):
    jp, tp, x, y = setup
    kw = dict(epochs=1, batch=16, lr=0.05, seed=7)
    jd, jl = jax_get_family("cnn").client_update(method, jp, model_idx, x, y,
                                                 **kw)
    update = heterofl_client_update if method == "heterofl" \
        else scalefl_client_update
    td, tl = update(tp, model_idx, x, y, **kw)
    np.testing.assert_allclose(float(tl), jl, **SGD)
    got, ref = tree_leaves(cnn_params_to_jax_layout(td)), jax.tree.leaves(jd)
    assert [g.shape for g in got] == [np.shape(r) for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **SGD)


def test_transformer_refuses_the_baselines():
    fam = get_family("transformer")
    assert not fam.supports("heterofl")
    with pytest.raises(ValueError, match="does not support method"):
        fam.submodel_params("scalefl", {}, 0)
    with pytest.raises(ValueError, match="unknown method"):
        fam.loss_fn("fedprox")


def _sliced_deltas(jp, method, model_idxs, seed):
    fam = jax_get_family("cnn")
    rng = np.random.default_rng(seed)
    return [jax.tree.map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.01).astype(np.float32),
        fam.submodel_params(method, jp, m)) for m in model_idxs]


@pytest.mark.parametrize("method", ["heterofl", "scalefl"])
def test_aggregate_sliced_quarantines_poisoned(setup, method):
    jp, tp, _, _ = setup
    idxs, w = [0, 3, 0, 3], [30.0, 90.0, 12.0, 51.0]
    deltas = _sliced_deltas(jp, method, idxs, 5)
    deltas[1]["stem"]["conv"][0, 0, 0, 0] = np.inf       # poisoned client
    ref, jvalid = jserver.aggregate_sliced(jp, deltas, w, with_stats=True)
    got, valid = tserver.aggregate_sliced(
        tp, [cnn_params_from_jax(d) for d in deltas], w)
    assert valid.tolist() == np.asarray(jvalid).tolist() == [True, False,
                                                             True, True]
    for g, r in zip(tree_leaves(cnn_params_to_jax_layout(got)),
                    jax.tree.leaves(ref)):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, np.asarray(r), **ONE)


@pytest.mark.parametrize("poisoned", [False, True],
                         ids=["clean", "poisoned"])
def test_heterofl_aggregate_matches_jax(setup, poisoned):
    """No quarantine here (the reference's has none): a poisoned client's
    inf reaches the same entries in both packages."""
    jp, tp, _, _ = setup
    idxs, w = [0, 3, 0], [5.0, 8.0, 2.0]
    deltas = _sliced_deltas(jp, "heterofl", idxs, 6)
    if poisoned:
        deltas[2]["stem"]["conv"][0, 0, 0, 0] = np.inf
    fracs = [tbase.WIDTH_LEVELS[m] for m in idxs]
    ref = jbase.heterofl_aggregate(jp, deltas, fracs, w)
    got = tbase.heterofl_aggregate(
        tp, [cnn_params_from_jax(d) for d in deltas], fracs, w)
    stem = cnn_params_to_jax_layout(got)["stem"]["conv"]
    assert np.isinf(stem[0, 0, 0, 0]) == poisoned
    for g, r in zip(tree_leaves(cnn_params_to_jax_layout(got)),
                    jax.tree.leaves(ref)):
        np.testing.assert_allclose(g, np.asarray(r), **ONE)


def test_unstacked_rows_are_the_bucket_rows(setup):
    _, tp, x, y = setup
    xt, yt = torch.tensor(x), torch.tensor(y).long()
    parts = [np.arange(0, 20), np.arange(20, 28), np.arange(28, 40)]
    res = tbatch.run_cohort("heterofl", tp, xt, yt, parts, [4, 1, 6],
                            [1, 1, 2], [3, 4, 5], epochs=1, batch=8, lr=0.05,
                            family="cnn")
    rows = res.unstacked()
    assert [(r[0], r[1], r[3]) for r in rows] == [(4, 1, 20.0), (1, 1, 8.0),
                                                  (6, 2, 12.0)]
    for b in res.buckets:
        for r, dev in enumerate(b.participants):
            row = next(c for c in rows if c[0] == dev)
            for a, s in zip(tree_leaves(row[2]),
                            tree_leaves(b.stacked_delta)):
                assert torch.equal(a, s[r])
            assert row[4] == float(b.losses[r])


# HeteroFL trains the full width in every arm here: with mixed widths at
# this size its trajectory is ill-conditioned (at seed 1, energy_scale
# 0.01, the JAX package's own two executors end 1.2e-2 apart on the same
# run; at seed 3 with full batteries, 2e-6), so no implementation can be
# held to 1e-4 there; the width slices are checked update by update above.
# ScaleFL's two JAX executors agree to 1.2e-7 with mixed widths: at
# energy_scale 0.01 some fresh batteries afford only the 0.75 slice, so the
# per-client arm trains two widths in rounds 0 and 1 (the bucketed arm
# keeps full batteries: one bucket shape, a third of the JAX compile time)
BASELINE_ARMS = {
    "heterofl-perclient": dict(method="heterofl", seed=3,
                               client_executor="perclient"),
    "heterofl-batched": dict(method="heterofl", seed=3,
                             client_executor="batched"),
    "scalefl-perclient": dict(method="scalefl", energy_scale=0.01,
                              client_executor="perclient"),
    "scalefl-batched": dict(method="scalefl", client_executor="batched"),
}


@pytest.mark.parametrize("arm", list(BASELINE_ARMS))
def test_live_run_matches_jax(arm):
    kw = dict(BASE, **BASELINE_ARMS[arm])
    jh, th, jsel, tsel = run_both(kw)
    assert_runs_agree(kw, jh, th, jsel, tsel, kw["client_executor"])
    if arm == "scalefl-perclient":
        assert any(len(set(m)) > 1 for m in th["model_choices"])
