"""Live runs of one FL arm in both packages, and the checks that hold the
port's run to the JAX package's: the shared body of the parametrised
live-run tests in ``tests/test_torch_perclient.py`` and
``tests/test_torch_baselines.py`` (one arm per case, split over two files
so that the suite's per-file workers share the cost).

Both runs go through ``RoundEngine(cfg, selector, buffer).run()`` with
the selector of ``_make_selector`` (and, for DR-FL + MARL, the buffer of
``_make_buffer``).  The port starts from the JAX package's own weights:
the family init exactly as the JAX ``build_world`` makes it, converted,
and the JAX selector's QMIX params; ε is 0 on both sides (``jax.random``
draws cannot be reproduced).  Picks and model choices must be identical
every round; per-exit accuracy within one validation sample; energy,
reward, round times and the final weights allclose at rtol=1e-4,
atol=1e-5 (SGD over float32 reductions in another order).
"""
import dataclasses

import jax
import numpy as np

from repro.fl import simulation as jsim
from repro.fl.engine import RoundEngine as JaxRoundEngine
from repro.models.family import get_family as jax_get_family
from repro_torch.convert import (cnn_params_from_jax,
                                 cnn_params_to_jax_layout, params_from_jax)
from repro_torch.fl import simulation as tsim
from repro_torch.fl.engine import RoundEngine
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-5)
#: the tests' size: n=8, width 0.125, 8x8 images, one local epoch of
#: batches of 16, three rounds
BASE = dict(n_devices=8, n_rounds=3, participation=0.5, local_epochs=1,
            batch_size=16, n_train=400, hw=8, width_mult=0.125, seed=1)


def _eps_zero(selector):
    selector.learner.cfg = dataclasses.replace(
        selector.learner.cfg, eps_start=0.0, eps_end=0.0)


def run_both(kw):
    """(JAX hist, port hist, JAX selector, port selector) of one arm."""
    jcfg, tcfg = jsim.FLConfig(**kw), tsim.FLConfig(**kw)
    jsel, tsel = jsim._make_selector(jcfg, 4), tsim._make_selector(
        tcfg, 4, device="cpu")
    jbuf = tbuf = None
    if jcfg.method == "drfl" and jcfg.selector == "marl":
        jbuf, tbuf = jsim._make_buffer(jcfg), tsim._make_buffer(tcfg)
        tsel.learner.load_params(params_from_jax(jsel.learner.params))
        for sel in (jsel, tsel):
            _eps_zero(sel)
            sel.reset_episode()
    fam = jcfg.model_family
    jp = jax_get_family(fam).init(jax.random.PRNGKey(jcfg.seed),
                                  jcfg.num_classes,
                                  width_mult=jcfg.width_mult, hw=jcfg.hw)
    conv = cnn_params_from_jax if fam == "cnn" else params_from_jax
    jh = JaxRoundEngine(jcfg, jsel, jbuf).run()
    th = RoundEngine(tcfg, tsel, tbuf, device="cpu",
                     global_params=conv(jp)).run()
    return jh, th, jsel, tsel


def assert_runs_agree(kw, jh, th, jsel, tsel, executor):
    n_val = max(64, int(0.04 * kw["n_train"]))
    assert th["executor"] == executor
    assert len(th["participants"]) == kw["n_rounds"]
    assert th["participants"] == jh["participants"]
    assert th["model_choices"] == jh["model_choices"]
    assert th["n_aggregations"] == jh["n_aggregations"]
    for a, b in zip(th["acc"], jh["acc"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1.0 / n_val + 1e-6)
    for key in ("energy", "round_time", "sim_time", "idle"):
        np.testing.assert_allclose(th[key], jh[key], **TOL, err_msg=key)
    # the reward's accuracy term moves with the accuracy, which the check
    # above lets differ by one validation sample (1000 / 64 / 4 = 3.9 of
    # reward); its energy and time terms are held here, and the whole
    # reward where the accuracies are equal
    w1 = kw.get("reward_weights", jsim.FLConfig().reward_weights)[0]
    for h in (jh, th):
        acc = np.asarray(h["acc_mean"], np.float64)
        h["_reward_rest"] = np.asarray(h["reward"]) - w1 * (
            acc - np.concatenate([[0.0], acc[:-1]]))
    np.testing.assert_allclose(th["_reward_rest"], jh["_reward_rest"],
                               **TOL, err_msg="reward minus accuracy term")
    same = np.asarray(th["acc_mean"]) == np.asarray(jh["acc_mean"])
    np.testing.assert_allclose(np.asarray(th["reward"])[same],
                               np.asarray(jh["reward"])[same], **TOL,
                               err_msg="reward")
    assert th["alive"] == jh["alive"]
    assert th["dropouts"] == jh["dropouts"]
    assert th["faults"]["n_quarantined"] == jh["faults"]["n_quarantined"]
    got = (cnn_params_to_jax_layout(th["params"])
           if kw.get("model_family", "cnn") == "cnn"
           else [t.numpy() for t in tree_leaves(th["params"])])
    ref = jax.tree.leaves(jh["params"])
    got = tree_leaves(got)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)
    if "qmix" in jh:
        assert tsel.learner.updates == jsel.learner.updates >= 1
        np.testing.assert_allclose(th["qmix"]["td_loss"],
                                   jh["qmix"]["td_loss"], **TOL)
        for g, r in zip(tree_leaves(tsel.learner.params),
                        tree_leaves(params_from_jax(jsel.learner.params))):
            np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)
    else:
        assert "qmix" not in th
