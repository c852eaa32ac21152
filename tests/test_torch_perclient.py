"""The per-client executor against the JAX package's: the loaders, one
client's local training (CNN DR-FL at every submodel, the transformer's
masked full-depth step), the list aggregations (``layerwise_aggregate``,
``aggregate_drfl`` with staleness and quarantine, and its stacked route
``aggregate_drfl_from_list``), and live runs of the DR-FL arms on the
per-client executor.

Weights reach the port through ``repro_torch.convert``.  Tolerances: the
loaders and schedules exact; single aggregations rtol=1e-5, atol=1e-6;
anything after SGD rtol=1e-4, atol=1e-5 (float32 reductions in another
order); picks identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.aggregation import fedavg as jax_fedavg
from repro.core.aggregation import layerwise_aggregate as jax_layerwise
from repro.data.loader import epoch_batches as jax_epoch_batches
from repro.fl import server as jserver
from repro.models.family import get_family as jax_get_family
from repro_torch.convert import (cnn_params_from_jax,
                                 cnn_params_to_jax_layout, params_from_jax)
from repro_torch.core.aggregation import fedavg, layerwise_aggregate
from repro_torch.data.loader import (batch_iterator, client_schedule,
                                     epoch_batches)
from repro_torch.fl import server as tserver
from repro_torch.fl.client import drfl_client_update, drfl_submodel_loss
from repro_torch.kernels import LAUNCHES
from repro_torch.models.family import get_family
from repro_torch.tree import tree_leaves
from torch_live import BASE, assert_runs_agree, run_both

torch.set_num_threads(1)
SGD = dict(rtol=1e-4, atol=1e-5)
ONE = dict(rtol=1e-5, atol=1e-6)


def _jax_tree(fam, width, seed, scale=0.3):
    """A JAX-layout tree of numpy draws, shaped by the JAX family's init."""
    shapes = jax.eval_shape(
        lambda k: jax_get_family(fam).init(k, 10, width_mult=width, hw=8),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * scale).astype(np.float32),
        shapes)


def _cnn_flat(tree):
    return tree_leaves(cnn_params_to_jax_layout(tree))


@pytest.mark.parametrize("n,batch", [(1, 4), (3, 8), (8, 8), (37, 16),
                                     (100, 32)])
def test_epoch_batches_exact(n, batch):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    y = np.arange(n, dtype=np.int32)
    got = list(epoch_batches(x, y, batch, np.random.default_rng(5)))
    ref = list(jax_epoch_batches(x, y, batch, np.random.default_rng(5)))
    assert len(got) == len(ref)
    for (gx, gy), (rx, ry) in zip(got, ref):
        np.testing.assert_array_equal(gx, rx)
        np.testing.assert_array_equal(gy, ry)
    # client_schedule is the same sequence as indices, over epochs
    part = np.arange(1000, 1000 + n)
    sched = client_schedule(part, 9, 3, batch)
    rng = np.random.default_rng(9)
    ref_idx = [yb for _ in range(3)
               for _, yb in jax_epoch_batches(x, y, batch, rng)]
    assert sched.shape == (len(ref_idx), batch)
    for s, r in zip(sched, ref_idx):
        np.testing.assert_array_equal(s, part[r])


def test_batch_iterator_cycles_epochs():
    x = np.arange(20, dtype=np.float32)[:, None]
    y = np.arange(20)
    it = batch_iterator(x, y, 8, seed=3)
    got = [next(it)[1] for _ in range(5)]
    rng = np.random.default_rng(3)
    ref = [yb for _ in range(3) for _, yb in jax_epoch_batches(x, y, 8, rng)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.fixture(scope="module")
def cnn_setup():
    jp = _jax_tree("cnn", 0.125, 0)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 40).astype(np.int32)
    return jp, cnn_params_from_jax(jp), x, y


@pytest.mark.parametrize("model_idx", [0, 1, 2, 3])
def test_cnn_drfl_client_update_matches_jax(cnn_setup, model_idx):
    jp, tp, x, y = cnn_setup
    kw = dict(epochs=2, batch=16, lr=0.05, seed=7)
    jd, jl = jax_get_family("cnn").client_update("drfl", jp, model_idx, x, y,
                                                 **kw)
    td, tl = drfl_client_update(tp, model_idx, x, y, **kw)
    assert isinstance(tl, torch.Tensor) and tl.dim() == 0
    np.testing.assert_allclose(float(tl), jl, **SGD)
    got, ref = _cnn_flat(td), jax.tree.leaves(jd)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **SGD)
    # the full structure, exactly zero past the submodel
    for si in range(model_idx + 1, 4):
        for t in tree_leaves([td["stages"][si], td["exits"][si]]):
            assert not torch.any(t != 0)


@pytest.fixture(scope="module")
def transformer_setup():
    jp = jax_get_family("transformer").init(jax.random.PRNGKey(3), 10,
                                            width_mult=0.25, hw=8)
    rng = np.random.default_rng(2)
    x = rng.integers(0, 10, (40, 8)).astype(np.int32)
    y = rng.integers(0, 10, 40).astype(np.int32)
    return jp, params_from_jax(jp), x, y


@pytest.mark.parametrize("model_idx", [0, 1, 3])
def test_transformer_drfl_update_zero_past_m(transformer_setup, model_idx):
    jp, tp, x, y = transformer_setup
    kw = dict(epochs=1, batch=16, lr=0.05, seed=4)
    fam = get_family("transformer")
    jd, jl = jax_get_family("transformer").client_update(
        "drfl", jp, model_idx, x, y, **kw)
    td, tl = fam.client_update("drfl", tp, model_idx, x, y, **kw)
    np.testing.assert_allclose(float(tl), jl, **SGD)
    for g, r in zip(tree_leaves(td), jax.tree.leaves(jd)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **SGD)
    for si in range(model_idx + 1, 4):
        for t in tree_leaves([td["stages"][si], td["exits"][si]]):
            assert not torch.any(t != 0)
    for si in range(model_idx + 1):
        assert any(torch.any(t != 0)
                   for t in tree_leaves(td["stages"][si]))


def test_transformer_step_loss_equals_truncated_loss(transformer_setup):
    """The masked full-depth loss is the joint CE of the truncated tree."""
    _, tp, x, y = transformer_setup
    fam = get_family("transformer")
    xb, yb = torch.tensor(x[:16]).long(), torch.tensor(y[:16]).long()
    for m in range(4):
        full = fam._drfl_step_loss(tp, xb, yb, m)
        trunc = fam._drfl_loss(fam.submodel_tree(tp, m), xb, yb)
        np.testing.assert_allclose(float(full), float(trunc), **ONE)


def _cnn_deltas(model_idxs, seed):
    """Full-structure JAX-layout deltas, zero outside each submodel."""
    out = []
    for j, m in enumerate(model_idxs):
        d = _jax_tree("cnn", 0.125, seed + j, scale=0.01)
        for si in range(m + 1, 4):
            d["stages"][si] = jax.tree.map(np.zeros_like, d["stages"][si])
            d["exits"][si] = jax.tree.map(np.zeros_like, d["exits"][si])
        out.append(d)
    return out


@pytest.fixture(scope="module")
def agg_setup():
    jp = _jax_tree("cnn", 0.125, 11)
    idxs = [0, 3, 1, 3]
    deltas = _cnn_deltas(idxs, 20)
    return jp, idxs, deltas, [37.0, 120.0, 64.0, 9.0]


def test_layerwise_aggregate_matches_jax(agg_setup):
    jp, idxs, deltas, w = agg_setup
    jfam, fam = jax_get_family("cnn"), get_family("cnn")
    tp = cnn_params_from_jax(jp)
    ref = jax.jit(lambda p, d, m: jax_layerwise(p, d, m, w, server_lr=0.7))(
        jp, deltas, [jfam.update_mask(jp, m) for m in idxs])
    got = layerwise_aggregate(tp, [cnn_params_from_jax(d) for d in deltas],
                              [fam.update_mask(tp, m) for m in idxs], w,
                              server_lr=0.7)
    for g, r in zip(_cnn_flat(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(g, np.asarray(r), **ONE)


@pytest.mark.parametrize("weights", [None, [37.0, 120.0, 64.0, 9.0]],
                         ids=["uniform", "data-size"])
def test_fedavg_matches_jax(agg_setup, weights):
    _, _, deltas, _ = agg_setup
    ref = jax_fedavg(deltas, weights)
    got = fedavg([cnn_params_from_jax(d) for d in deltas], weights)
    for g, r in zip(_cnn_flat(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(g, np.asarray(r), **ONE)


def test_submodel_size_bytes_and_drfl_loss_alias(cnn_setup):
    jp, tp, x, y = cnn_setup
    jfam, fam = jax_get_family("cnn"), get_family("cnn")
    assert [fam.submodel_size_bytes(tp, m) for m in range(4)] == \
        [jfam.submodel_size_bytes(jp, m) for m in range(4)]
    sub = fam.submodel_tree(tp, 2)
    xb, yb = torch.tensor(x[:16]), torch.tensor(y[:16]).long()
    assert float(drfl_submodel_loss(sub, xb, yb)) == \
        float(fam._drfl_loss(sub, xb, yb))


def test_update_mask_scale_and_cache():
    fam = get_family("cnn")
    tp = cnn_params_from_jax(_jax_tree("cnn", 0.125, 0))
    m = fam.update_mask(tp, 1, scale=0.5)
    assert fam.update_mask(tp, 1, scale=0.5) is m
    vals = [float(t) for t in tree_leaves([m["stem"], m["stages"][1]])]
    assert set(vals) == {0.5}
    assert {float(t) for t in tree_leaves(m["exits"][2:])} == {0.0}


@pytest.mark.parametrize("staleness", [None, [0.0, 2.0, 0.0, 1.0]],
                         ids=["fresh", "stale"])
def test_aggregate_drfl_quarantines_and_decays(agg_setup, staleness):
    jp, idxs, deltas, w = agg_setup
    deltas = [jax.tree.map(np.copy, d) for d in deltas]
    deltas[2]["stem"]["conv"][0, 0, 0, 0] = np.nan      # poisoned client
    ref, jvalid = jserver.aggregate_drfl(
        jp, deltas, idxs, w, server_lr=0.7, staleness=staleness,
        family="cnn", with_stats=True)
    tp = cnn_params_from_jax(jp)
    got, valid = tserver.aggregate_drfl(
        tp, [cnn_params_from_jax(d) for d in deltas], idxs, w, server_lr=0.7,
        staleness=staleness, family="cnn")
    assert valid.dtype == torch.bool
    assert valid.tolist() == np.asarray(jvalid).tolist() == [True, True,
                                                             False, True]
    for g, r in zip(_cnn_flat(got), jax.tree.leaves(ref)):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, np.asarray(r), **ONE)


@pytest.mark.parametrize("staleness", [None, [1.0, 0.0, 3.0, 0.0]],
                         ids=["fresh", "stale"])
def test_aggregate_drfl_from_list_matches_list(agg_setup, staleness):
    """The P = 1 buckets through ``layer_agg``'s plain version (the CPU
    route of the kernel) against the list path and the JAX package's own
    ``aggregate_drfl_from_list``; no launch on the CPU."""
    jp, idxs, deltas, w = agg_setup
    tp = cnn_params_from_jax(jp)
    tdeltas = [cnn_params_from_jax(d) for d in deltas]
    before = LAUNCHES["layer_agg"]
    got, valid = tserver.aggregate_drfl_from_list(
        tp, tdeltas, idxs, w, server_lr=0.7, staleness=staleness,
        family="cnn")
    assert LAUNCHES["layer_agg"] == before
    lst, _ = tserver.aggregate_drfl(tp, tdeltas, idxs, w, server_lr=0.7,
                                    staleness=staleness, family="cnn")
    ref = jserver.aggregate_drfl_from_list(
        jp, deltas, idxs, w, server_lr=0.7, staleness=staleness,
        family="cnn")
    assert valid.tolist() == [True] * 4
    for g, l, r in zip(_cnn_flat(got), _cnn_flat(lst),
                       jax.tree.leaves(ref)):
        np.testing.assert_allclose(g, l, **ONE)
        np.testing.assert_allclose(g, np.asarray(r), **ONE)


# the DR-FL arms on the per-client executor ("auto" below 64 devices);
# seed 1 at 50% participation: MARL trains submodels 0-3 over its rounds,
# random and static draw mixed submodels, greedy trains the deepest
DRFL_ARMS = {
    "drfl-marl": dict(),
    "drfl-greedy": dict(selector="greedy"),
    "drfl-random": dict(selector="random"),
    "drfl-static": dict(selector="static"),
    "transformer-drfl-greedy": dict(selector="greedy",
                                    model_family="transformer",
                                    width_mult=0.25),
}


@pytest.mark.parametrize("arm", list(DRFL_ARMS))
def test_live_run_matches_jax(arm):
    kw = dict(BASE, **DRFL_ARMS[arm])
    jh, th, jsel, tsel = run_both(kw)
    assert_runs_agree(kw, jh, th, jsel, tsel, "perclient")
    if arm in ("drfl-marl", "drfl-random", "drfl-static"):
        assert any(len(set(m)) > 1 for m in th["model_choices"])
