"""The port's bucketed executor against the JAX package's: host schedules
and padded buckets must be EXACTLY equal (same numpy RNG, same padding);
one bucket program's stacked deltas and losses must agree with the JAX
``_bucket_program`` (through ``run_bucket``) from converted weights.

Tolerance for deltas and losses: rtol=1e-4, atol=1e-5 — several SGD steps
through a CNN, with float32 reductions in a different order (the JAX CPU
bucket program even convolves via patches + einsum).
"""
import jax
import numpy as np
import pytest
import torch

from repro.fl import batch as jbatch
from repro.fl import client as jclient
from repro.models.family import get_family as jax_get_family
from repro_torch.convert import cnn_params_from_jax, cnn_params_to_jax_layout
from repro_torch.fl import batch as tbatch
from repro_torch.fl.client import client_update_seed
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
SGD = dict(rtol=1e-4, atol=1e-5)


def test_client_update_seed_is_the_jax_packages():
    for args in [(0, 0, 0), (3, 7, 123), (12345, 99, 4095)]:
        assert client_update_seed(*args) == jclient.client_update_seed(*args)


@pytest.mark.parametrize("n_i,batch,epochs", [(70, 32, 2), (20, 32, 3),
                                              (64, 16, 1), (5, 8, 2)])
def test_client_schedule_exact(n_i, batch, epochs):
    part = np.arange(100, 100 + n_i)
    seed = client_update_seed(0, 3, 7)
    np.testing.assert_array_equal(
        tbatch.client_schedule(part, seed, epochs, batch),
        jbatch.client_schedule(part, seed, epochs, batch))


def test_bucket_cohort_exact():
    rng = np.random.default_rng(0)
    parts = [np.sort(rng.choice(500, n, replace=False))
             for n in (40, 7, 90, 33, 12)]
    kw = dict(participants=[3, 8, 1, 6, 4], model_idxs=[2, 0, 2, 2, 3],
              parts=parts, seeds=[11, 12, 13, 14, 15],
              weights=[float(len(p)) for p in parts], epochs=2, batch=16)
    tb = tbatch.bucket_cohort(**kw)
    jb = jbatch.bucket_cohort(**kw)
    assert [b.model_idx for b in tb] == [b.model_idx for b in jb] == [0, 2, 3]
    for t, j in zip(tb, jb):
        assert t.participants == j.participants
        assert t.weights == j.weights
        np.testing.assert_array_equal(t.gather, j.gather)
        np.testing.assert_array_equal(t.valid, j.valid)
    assert tb[1].gather.shape[0] == 4          # 3 clients, padded to pow2


def test_run_bucket_matches_jax():
    jfam = jax_get_family("cnn")
    shapes = jax.eval_shape(
        lambda k: jfam.init(k, 10, width_mult=0.125, hw=8),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    gp = jax.tree.map(lambda s: (rng.normal(size=s.shape) * 0.2
                                 ).astype(np.float32), shapes)
    x = rng.normal(size=(200, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 200).astype(np.int32)
    # 2 steps, 1 step and 1 wrap-around step: T pads to 2, P to 4
    parts = [np.arange(0, 17), np.arange(17, 30), np.arange(30, 35)]
    bucket = jbatch.bucket_cohort([0, 1, 2], [1, 1, 1], parts, [5, 6, 7],
                                  [17.0, 13.0, 5.0], epochs=1, batch=8)[0]
    assert bucket.gather.shape == (4, 2, 8)
    jres = jbatch.run_bucket("drfl", gp, x, y, bucket, lr=0.05, family=jfam)
    tres = tbatch.run_bucket("drfl", cnn_params_from_jax(gp),
                             torch.tensor(x), torch.tensor(y).long(), bucket,
                             lr=0.05)
    assert tres.weights == jres.weights == [17.0, 13.0, 5.0, 0.0]
    np.testing.assert_allclose(tres.losses, jres.losses, **SGD)
    got = tree_leaves(cnn_params_to_jax_layout(tres.stacked_delta,
                                               stacked=True))
    for g, r in zip(got, jax.tree.leaves(jres.stacked_delta)):
        np.testing.assert_allclose(g[:3], np.asarray(r)[:3], **SGD)
