"""The port's stacked DR-FL aggregation against the JAX package's on the
same numpy deltas: ``stacked_masked_mean`` (plain and with staleness
alphas) and ``aggregate_drfl_stacked`` end to end, including a poisoned
(NaN) client row that both sides must quarantine; and the staleness decay
of all three DR-FL aggregations at values other than the default.

Tolerance: rtol=1e-5, atol=1e-6 — one float32 masked mean and one add
per element, in a different reduction order.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.fl import server as jserver
from repro.models.family import get_family as jax_get_family
from repro_torch.convert import cnn_params_from_jax, cnn_params_to_jax_layout
from repro_torch.core import aggregation as tagg
from repro_torch.fl import server as tserver
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_alpha", [False, True])
def test_stacked_masked_mean_matches(with_alpha):
    rng = np.random.default_rng(int(with_alpha))
    N, R, D = 7, 9, 64
    U = rng.normal(size=(N, R, D)).astype(np.float32)
    m = (rng.random((N, R)) > 0.4).astype(np.float32)
    m[:, 3] = 0.0
    w = rng.uniform(1, 50, N).astype(np.float32)
    a = rng.uniform(0.3, 1.0, N).astype(np.float32) if with_alpha else None
    ref = jagg.stacked_masked_mean(U, m, w, a)
    got = tagg.stacked_masked_mean(
        torch.tensor(U), torch.tensor(m), torch.tensor(w),
        None if a is None else torch.tensor(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _jax_params(rng):
    shapes = jax.eval_shape(
        lambda k: jax_get_family("cnn").init(k, 10, width_mult=0.125, hw=8),
        jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("staleness", [None, (0, 3)])
def test_aggregate_drfl_stacked_matches_with_quarantine(staleness):
    rng = np.random.default_rng(7)
    jfam = jax_get_family("cnn")
    gp = _jax_params(rng)
    buckets_j, buckets_t = [], []
    for b, (m, p, n_real) in enumerate([(0, 2, 2), (2, 4, 3)]):
        sub = jfam.submodel_tree(gp, m)
        delta = jax.tree.map(
            lambda a: (rng.normal(size=(p,) + a.shape) * 0.01
                       ).astype(np.float32), sub)
        if b == 1:                       # poison one real client row
            delta["stages"][1][0]["conv1"][1, 0, 0, 0, 0] = np.nan
        weights = [float(rng.integers(10, 90)) for _ in range(n_real)]
        weights += [0.0] * (p - n_real)
        stal = None if staleness is None else [staleness[b]] * p
        buckets_j.append((m, delta, weights, stal))
        buckets_t.append((m, cnn_params_from_jax(delta, stacked=True),
                          weights, stal))
    jout, jvalid = jserver.aggregate_drfl_stacked(
        gp, buckets_j, server_lr=0.7, family=jfam, with_stats=True)
    tout, tvalid = tserver.aggregate_drfl_stacked(
        cnn_params_from_jax(gp), buckets_t, server_lr=0.7)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert not bool(tvalid[3])
    for g, r in zip(tree_leaves(cnn_params_to_jax_layout(tout)),
                    jax.tree.leaves(jout)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(r), **TOL)



@pytest.mark.parametrize("decay", [0.25, 1.0])
@pytest.mark.parametrize("fn", ["aggregate_drfl", "aggregate_drfl_stacked",
                                "aggregate_drfl_from_list"])
def test_staleness_decay_matches(fn, decay):
    """``staleness_decay`` (the config's, other than the default 0.5) on a
    fresh row and two stale ones, in each DR-FL aggregation; the default
    decay gives other weights, so the keyword reached the result."""
    for s in (0, 1, 2.5, 7):
        assert tserver.staleness_scale(s, decay) == \
            jserver.staleness_scale(s, decay)
    rng = np.random.default_rng(11)
    jfam = jax_get_family("cnn")
    gp = _jax_params(rng)
    idxs, stal, w = [0, 3, 1], [0, 2, 5], [37.0, 120.0, 64.0]
    subs = [jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.01
                                    ).astype(np.float32),
                         jfam.submodel_tree(gp, m)) for m in idxs]
    if fn == "aggregate_drfl_stacked":
        one = [jax.tree.map(lambda a: a[None], d) for d in subs]
        jargs = (gp, [(m, d, [wi], [s])
                      for m, d, wi, s in zip(idxs, one, w, stal)])
        targs = (cnn_params_from_jax(gp),
                 [(m, cnn_params_from_jax(d, stacked=True), [wi], [s])
                  for m, d, wi, s in zip(idxs, one, w, stal)])
        jkw = dict(family=jfam)
        tkw = {}
    else:
        # full-structure deltas: the submodel's leaves, zero elsewhere
        full = []
        for m, d in zip(idxs, subs):
            f = jax.tree.map(np.zeros_like, gp)
            f["stem"] = d["stem"]
            f["stages"][:m + 1] = d["stages"]
            f["exits"][:m + 1] = d["exits"]
            full.append(f)
        jargs = (gp, full, idxs, w)
        targs = (cnn_params_from_jax(gp),
                 [cnn_params_from_jax(f) for f in full], idxs, w)
        jkw = tkw = dict(staleness=stal, family="cnn")
    ref, _ = getattr(jserver, fn)(*jargs, server_lr=0.7,
                                  staleness_decay=decay, with_stats=True,
                                  **jkw)
    got, _ = getattr(tserver, fn)(*targs, server_lr=0.7,
                                  staleness_decay=decay, **tkw)
    for g, r in zip(tree_leaves(cnn_params_to_jax_layout(got)),
                    jax.tree.leaves(ref)):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)
    default, _ = getattr(tserver, fn)(*targs, server_lr=0.7, **tkw)
    assert not all(torch.allclose(a, b) for a, b in
                   zip(tree_leaves(got), tree_leaves(default)))
