"""The slice as a whole: the port's sync DR-FL + QMIX run against a live
JAX run of the same config (n=8, bucketed executor, 3 rounds), both driven
through ``RoundEngine(cfg, selector, buffer).run()`` with the selector
from ``_make_selector`` and the buffer from ``_make_buffer``.

The port starts from the JAX package's own weights: the CNN init exactly
as the JAX ``build_world`` makes it and the JAX selector's QMIX params,
converted.  ε is 0 on both sides (``jax.random`` draws cannot be
reproduced).  Picks and model choices must be identical every round;
per-exit accuracy within one validation sample; energy and reward
rtol=1e-4, atol=1e-5 and the final weights rtol=1e-4, atol=1e-5 (SGD and
QMIX updates over float32 reductions in a different order).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.fl import simulation as jsim
from repro.fl.engine import RoundEngine as JaxRoundEngine
from repro.models.family import get_family as jax_get_family
from repro_torch.convert import (cnn_params_from_jax, cnn_params_to_jax_layout,
                                 params_from_jax)
from repro_torch.fl import simulation as tsim
from repro_torch.fl.engine import RoundEngine
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
KW = dict(n_devices=8, n_rounds=3, participation=0.5, local_epochs=1,
          batch_size=16, n_train=400, hw=8, width_mult=0.125, seed=1,
          client_executor="batched")   # seed 1: round 1 trains two buckets,
                                       # one padded from 3 clients to 4


def _greedy(selector):
    selector.learner.cfg = dataclasses.replace(
        selector.learner.cfg, eps_start=0.0, eps_end=0.0)


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = jsim.FLConfig(**KW), tsim.FLConfig(**KW)
    jsel, jbuf = jsim._make_selector(jcfg, 4), jsim._make_buffer(jcfg)
    tsel = tsim._make_selector(tcfg, 4, device="cpu")
    tbuf = tsim._make_buffer(tcfg)
    tsel.learner.load_params(params_from_jax(jsel.learner.params))
    jp = jax_get_family("cnn").init(jax.random.PRNGKey(jcfg.seed),
                                    jcfg.num_classes,
                                    width_mult=jcfg.width_mult, hw=jcfg.hw)
    for sel in (jsel, tsel):
        _greedy(sel)
        sel.reset_episode()
    jhist = JaxRoundEngine(jcfg, jsel, jbuf).run()
    thist = RoundEngine(tcfg, tsel, tbuf, device="cpu",
                        global_params=cnn_params_from_jax(jp)).run()
    return jhist, thist, jsel, tsel


def test_picks_and_models_identical(runs):
    jh, th, _, _ = runs
    assert len(th["participants"]) == 3
    assert th["participants"] == jh["participants"]
    assert th["model_choices"] == jh["model_choices"]
    assert any(len(set(m)) > 1 for m in th["model_choices"])
    assert th["n_aggregations"] == jh["n_aggregations"] == 3
    assert th["executor"] == "batched"


def test_accuracy_within_one_validation_sample(runs):
    jh, th, _, _ = runs
    n_val = max(64, int(0.04 * KW["n_train"]))
    for a, b in zip(th["acc"], jh["acc"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1.0 / n_val + 1e-6)


def test_energy_reward_and_times_allclose(runs):
    jh, th, _, _ = runs
    for key in ("energy", "reward", "round_time", "sim_time", "idle"):
        np.testing.assert_allclose(th[key], jh[key], **TOL, err_msg=key)
    assert th["alive"] == jh["alive"]
    assert th["dropouts"] == jh["dropouts"]


def test_final_params_allclose(runs):
    jh, th, jsel, tsel = runs
    got = tree_leaves(cnn_params_to_jax_layout(th["params"]))
    for g, r in zip(got, jax.tree.leaves(jh["params"])):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)
    assert tsel.learner.updates == jsel.learner.updates == 2
    np.testing.assert_allclose(th["qmix"]["td_loss"], jh["qmix"]["td_loss"],
                               **TOL)
    for g, r in zip(tree_leaves(tsel.learner.params),
                    tree_leaves(params_from_jax(jsel.learner.params))):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)
