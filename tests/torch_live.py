"""Live runs of one FL arm in both packages, and the checks that hold the
port's run to the JAX package's: the shared body of the parametrised
live-run tests in ``tests/test_torch_perclient.py``,
``tests/test_torch_baselines.py``, ``tests/test_torch_async.py``,
``tests/test_torch_faults.py``, ``tests/test_torch_energy_live.py``,
``tests/test_torch_fleet_scale_live.py`` and the three
``tests/test_torch_checkpoint_async*.py`` (one arm per case, split over
files so that the suite's per-file workers share the cost).

Both runs go through ``RoundEngine(cfg, selector, buffer).run()`` with
the selector of ``_make_selector`` (and, for DR-FL + MARL, the buffer of
``_make_buffer``).  The port starts from the JAX package's own weights:
the family init exactly as the JAX ``build_world`` makes it, converted,
and the JAX selector's QMIX params; ε is 0 on both sides (``jax.random``
draws cannot be reproduced), or, with ``explore=True``, ε as configured
and the port's learner given the JAX learner's actions call by call
(:func:`_replay_jax_actions`).  Picks and model choices must be identical
every round; per-exit accuracy within one validation sample; energy,
reward, round times and the final weights allclose at rtol=1e-4,
atol=1e-5 (SGD over float32 reductions in another order).  An async run
(:func:`assert_async_runs_agree`) is held to the same tolerances, with
its event record identical: the task log (device, dispatch, version,
staleness, submodel, lost), the termination, the hot-plug and every fault
event's outcome; the times in them at rtol=1e-4.  Its rows' rewards sum
many small energy terms, each a difference of two float32 sums of the
fleet's energy: their absolute tolerance is the float32 spacing there
(:func:`_energy_term_atol`).  Under an energy scenario both runs also
keep the same ``hist["terminated"]`` and ``hist["budget"]`` (``trimmed``
equal; ``spent``, ``overrun`` and ``limit`` at TOL).
"""
import dataclasses

import jax
import pytest
import numpy as np
import torch

from repro.checkpoint import CheckpointHalt as JaxCheckpointHalt
from repro.fl import simulation as jsim
from repro.fl.engine import RoundEngine as JaxRoundEngine
from repro.models.family import get_family as jax_get_family
from repro_torch.convert import (cnn_params_from_jax,
                                 cnn_params_to_jax_layout, params_from_jax)
from repro_torch.core.energy import BATTERY_JOULES
from repro_torch.core.marl.networks import agent_step
from repro_torch.fl import faults as tfaults
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


def _replay_jax_actions(jsel, tsel):
    """ε-exploration draws from ``jax.random``, which torch cannot
    reproduce: record the JAX learner's actions at every ``act`` and hand
    them, in call order, to the port's learner, whose Q values and hidden
    state stay its own.  Every replayed action must be one the port's own
    action mask allows."""
    taken = []
    jax_act = jsel.learner.act

    def record(*args, **kw):
        out = jax_act(*args, **kw)
        taken.append(np.array(out[0]))
        return out

    def replay(obs, hidden, eps, avail):
        q, h = agent_step(tsel.learner.params["agent"], obs, hidden)
        act = torch.as_tensor(taken.pop(0), dtype=torch.int64,
                              device=q.device)
        assert bool(avail.gather(-1, act[:, None]).all()), \
            "a JAX action outside the port's action mask"
        return act, q.gather(-1, act[:, None])[:, 0], h
    jsel.learner.act = record
    tsel.learner.act = replay


def run_both(kw, fault_plan=None, explore=False):
    """(JAX hist, port hist, JAX selector, port selector) of one arm;
    ``fault_plan`` (the JAX package's) goes to both engines; ``explore``
    keeps a MARL selector's ε and replays the JAX actions into the port."""
    jcfg, tcfg = jsim.FLConfig(**kw), tsim.FLConfig(**kw)
    jsel, tsel = jsim._make_selector(jcfg, 4), tsim._make_selector(
        tcfg, 4, device="cpu")
    jbuf = tbuf = None
    if jcfg.method == "drfl" and jcfg.selector == "marl":
        jbuf, tbuf = jsim._make_buffer(jcfg), tsim._make_buffer(tcfg)
        tsel.learner.load_params(params_from_jax(jsel.learner.params))
        qmix_init = params_from_jax(jsel.learner.params)
        for sel in (jsel, tsel):
            if not explore:
                _eps_zero(sel)
            sel.reset_episode()
        if explore:
            _replay_jax_actions(jsel, tsel)
    fam = jcfg.model_family
    jp = jax_get_family(fam).init(jax.random.PRNGKey(jcfg.seed),
                                  jcfg.num_classes,
                                  width_mult=jcfg.width_mult, hw=jcfg.hw)
    conv = cnn_params_from_jax if fam == "cnn" else params_from_jax
    tplan = None if fault_plan is None else tfaults.FaultPlan(tuple(
        tfaults.FaultEvent(**ev.as_dict()) for ev in fault_plan.events))
    jh = JaxRoundEngine(jcfg, jsel, jbuf, fault_plan=fault_plan).run()
    th = RoundEngine(tcfg, tsel, tbuf, device="cpu", global_params=conv(jp),
                     fault_plan=tplan).run()
    if jbuf is not None:      # for _assert_qmix_replays_reference
        jh["_buffer"], th["_buffer"] = jbuf, tbuf
        th["_qmix_init"] = qmix_init
    return jh, th, jsel, tsel


def _assert_rows_agree(kw, jh, th, executor, keys, reward_atol=TOL["atol"]):
    """The per-row record: accuracy within one validation sample, the
    ``keys`` at TOL and the reward's non-accuracy terms at TOL's rtol and
    ``reward_atol``, liveness and dropouts equal."""
    n_val = max(64, int(0.04 * kw["n_train"]))
    assert th["executor"] == executor
    assert th["participants"] == jh["participants"]
    assert th["model_choices"] == jh["model_choices"]
    assert th["n_aggregations"] == jh["n_aggregations"]
    for a, b in zip(th["acc"], jh["acc"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1.0 / n_val + 1e-6)
    for key in keys:
        np.testing.assert_allclose(th[key], jh[key], **TOL, err_msg=key)
    # the reward's accuracy term moves with the accuracy, which the check
    # above lets differ by one validation sample (1000 / 64 / 4 = 3.9 of
    # reward); its energy and time terms are held here, and the whole
    # reward where the accuracies are equal.  An async row's accuracy
    # terms telescope to the same difference of row accuracies
    w1 = kw.get("reward_weights", jsim.FLConfig().reward_weights)[0]
    for h in (jh, th):
        acc = np.asarray(h["acc_mean"], np.float64)
        h["_reward_rest"] = np.asarray(h["reward"]) - w1 * (
            acc - np.concatenate([[0.0], acc[:-1]]))
    tol = dict(TOL, atol=reward_atol)
    np.testing.assert_allclose(th["_reward_rest"], jh["_reward_rest"],
                               **tol, err_msg="reward minus accuracy term")
    same = np.asarray(th["acc_mean"]) == np.asarray(jh["acc_mean"])
    np.testing.assert_allclose(np.asarray(th["reward"])[same],
                               np.asarray(jh["reward"])[same], **tol,
                               err_msg="reward")
    assert th["alive"] == jh["alive"]
    assert th["dropouts"] == jh["dropouts"]
    assert th["faults"]["n_quarantined"] == jh["faults"]["n_quarantined"]


def _assert_final_state_agree(kw, jh, th, jsel, tsel, replay=False):
    """The final weights and, for MARL, the QMIX losses and params (with
    ``replay``: :func:`_assert_qmix_replays_reference`)."""
    got = (cnn_params_to_jax_layout(th["params"])
           if kw.get("model_family", "cnn") == "cnn"
           else [t.numpy() for t in tree_leaves(th["params"])])
    ref = jax.tree.leaves(jh["params"])
    got = tree_leaves(got)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)
    if "qmix" in jh and replay:
        _assert_qmix_replays_reference(kw, jh, th, jsel, tsel)
    elif "qmix" in jh:
        assert tsel.learner.updates == jsel.learner.updates >= 1
        np.testing.assert_allclose(th["qmix"]["td_loss"],
                                   jh["qmix"]["td_loss"], **TOL)
        for g, r in zip(tree_leaves(tsel.learner.params),
                        tree_leaves(params_from_jax(jsel.learner.params))):
            np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)
    else:
        assert "qmix" not in th


def _assert_qmix_replays_reference(kw, jh, th, jsel, tsel):
    """An async MARL episode's rewards carry the energy terms' float32
    spacing (:func:`_energy_term_atol`), which the QMIX updates amplify
    past TOL.  So the port's episode is held to the JAX one (observations
    and state at TOL, actions equal, rewards at that atol), and the port's
    learner, from the same initial params with a fresh buffer of the same
    seed, fed the JAX episode and sampled as often, to the JAX learner:
    td_loss at TOL, the params at TOL's rtol and an atol of two AdamW
    steps (2 lr) per update.  That atol is the bound of two trajectories,
    not slack for the learner: fed the same batch, a gradient element at
    the scale of AdamW's eps (1e-8) is float32 noise in either package,
    and a step of such an element, lr * m / (sqrt(v) + eps), can take any
    value in [-lr, lr] (one element of 12288 does so after the first
    update of the MARL arm).  td_loss after the first update holds the
    updated params to TOL where they matter."""
    jbuf, tbuf = jh["_buffer"], th["_buffer"]
    assert tsel.learner.updates == jsel.learner.updates >= 1
    assert len(tbuf) == len(jbuf) == 1
    t = int(jbuf.mask[0].sum())
    assert int(tbuf.mask[0].sum()) == t
    np.testing.assert_allclose(tbuf.obs, jbuf.obs, **TOL)
    np.testing.assert_allclose(tbuf.state, jbuf.state, **TOL)
    np.testing.assert_array_equal(tbuf.actions, jbuf.actions)
    np.testing.assert_allclose(tbuf.rewards, jbuf.rewards, rtol=TOL["rtol"],
                               atol=_energy_term_atol(kw, th))
    tcfg = tsim.FLConfig(**kw)
    learner = tsim._make_selector(tcfg, 4, device="cpu").learner
    learner.load_params(th["_qmix_init"])
    buf = tsim._make_buffer(tcfg)
    buf.add_episode(jbuf.obs[0, :t + 1], jbuf.state[0, :t + 1],
                    jbuf.actions[0, :t], jbuf.rewards[0, :t])
    losses = [learner.update(buf.sample(learner.cfg.batch_size))["td_loss"]
              for _ in jh["qmix"]["td_loss"]]
    np.testing.assert_allclose(losses, jh["qmix"]["td_loss"], **TOL)
    step = 2 * learner.cfg.lr * len(losses)
    for g, r in zip(tree_leaves(learner.params),
                    tree_leaves(params_from_jax(jsel.learner.params))):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=TOL["rtol"],
                                   atol=step)


def _assert_budget_agree(jh, th):
    """The global budget's record: present in both or neither, ``trimmed``
    equal, the joules at TOL."""
    assert ("budget" in th) == ("budget" in jh)
    if "budget" in jh:
        tb, jb = dict(th["budget"]), dict(jh["budget"])
        assert tb.pop("trimmed") == jb.pop("trimmed")
        _assert_records_equal([tb], [jb], "budget")


def assert_runs_agree(kw, jh, th, jsel, tsel, executor):
    if th["terminated"]["reason"] != "budget_exhausted":
        assert len(th["participants"]) == kw["n_rounds"]
    _assert_rows_agree(kw, jh, th, executor,
                       ("energy", "round_time", "sim_time", "idle"))
    _assert_records_equal([th["terminated"]], [jh["terminated"]],
                          "terminated")
    _assert_budget_agree(jh, th)
    _assert_final_state_agree(kw, jh, th, jsel, tsel)


def _assert_records_equal(got, ref, what):
    """Lists of dicts: the same keys, floats at TOL, the rest equal."""
    assert len(got) == len(ref), what
    for g, r in zip(got, ref):
        assert set(g) == set(r), (what, g, r)
        for k in r:
            if isinstance(r[k], float) and not isinstance(g[k], bool):
                np.testing.assert_allclose(g[k], r[k], **TOL,
                                           err_msg=f"{what}: {k}")
            else:
                assert g[k] == r[k], (what, k, g, r)


def _energy_term_atol(kw, th):
    """The reward's energy term of a dispatch tick is w2 times the drop of
    the fleet's total energy, a difference of two float32 sums, which the
    two packages add up in their own orders.  A row's rewards sum those
    terms over its ticks, so a row can differ by a few float32 spacings at
    the fleet's energy for each tick, whatever the tolerance: 4 spacings
    at its bound (every battery full: n x 7,560 J x energy_scale) per
    charging tick (at most one per task or dropout; a sync run's round is
    one tick)."""
    n = kw["n_devices"] + kw.get("hotplug_n", 0)
    bound = np.float32(n * BATTERY_JOULES * kw.get("energy_scale", 1.0))
    w2 = kw.get("reward_weights", jsim.FLConfig().reward_weights)[1]
    ticks = th.get("n_tasks", len(th["reward"])) + th["dropouts"]
    return max(TOL["atol"], 4 * w2 * float(np.spacing(bound)) * ticks)


def assert_async_runs_agree(kw, jh, th, jsel, tsel, executor):
    """An async run: the rows as :func:`assert_runs_agree`'s (the reward
    with :func:`_energy_term_atol`), and the event record identical (times
    at TOL)."""
    assert th["engine"] == jh["engine"] == "async"
    _assert_rows_agree(kw, jh, th, executor,
                       ("energy", "round_time", "sim_time", "idle"),
                       reward_atol=_energy_term_atol(kw, th))
    for key in ("staleness", "lost", "n_tasks", "k_final"):
        assert th[key] == jh[key], key
    for key in ("idle_time", "wait_for_work", "sim_time_total"):
        np.testing.assert_allclose(th[key], jh[key], **TOL, err_msg=key)
    _assert_records_equal(th["task_log"], jh["task_log"], "task_log")
    _assert_records_equal([th["terminated"]], [jh["terminated"]],
                          "terminated")
    _assert_budget_agree(jh, th)
    assert (th["hotplug"] is None) == (jh["hotplug"] is None)
    if jh["hotplug"] is not None:
        hp_t, hp_j = dict(th["hotplug"]), dict(jh["hotplug"])
        np.testing.assert_allclose(hp_t.pop("join_remaining"),
                                   hp_j.pop("join_remaining"), **TOL)
        _assert_records_equal([hp_t], [hp_j], "hotplug")
    for key in ("events", "quarantined"):
        _assert_records_equal(th["faults"][key], jh["faults"][key], key)
    assert th["faults"]["n_reaped"] == jh["faults"]["n_reaped"]
    _assert_final_state_agree(kw, jh, th, jsel, tsel, replay=True)


def _jax_async_run(cfg, halt=None):
    """One JAX engine run from a fresh selector (and buffer), ε = 0."""
    sel, buf = jsim._make_selector(cfg, 4), None
    if cfg.selector == "marl":
        buf = jsim._make_buffer(cfg)
        _eps_zero(sel)
        sel.reset_episode()
    return JaxRoundEngine(cfg, sel, buf, halt_counter=halt).run(), sel, buf


def assert_async_jax_checkpoint_resumes(kw, tmp_path, via_simulation):
    """A JAX async run of ``kw`` killed right after its first virtual
    round's save, carried into the port and resumed there on the CPU
    (``via_simulation``: through ``run_simulation(resume=True)``, which
    finds the JAX manifest by itself; else through ``load_resume_state``
    and the engine), held to the JAX package's uninterrupted run by
    :func:`assert_async_runs_agree`.  Returns both histories."""
    jh, jsel, jbuf = _jax_async_run(jsim.FLConfig(**kw))
    ck = dict(kw, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    with pytest.raises(JaxCheckpointHalt):
        _jax_async_run(jsim.FLConfig(**ck), halt={"remaining": 1})
    tcfg = tsim.FLConfig(**ck, resume=True)
    tsel = tbuf = None
    if via_simulation:
        th = tsim.run_simulation(tcfg, device="cpu")
    else:
        state, meta = tsim.load_resume_state(tcfg)
        assert meta["format"] == "drfl-engine" and state["mode"] == "async"
        assert state["state"]["vround"] == 1 and state["tasks"]
        tsel = tsim._make_selector(tcfg, 4, device="cpu")
        if tcfg.selector == "marl":
            _eps_zero(tsel)
            tbuf = tsim._make_buffer(tcfg)
        th = RoundEngine(tcfg, tsel, tbuf, device="cpu",
                         resume_state=state).run()
    if tbuf is not None:      # for _assert_qmix_replays_reference
        jh["_buffer"], th["_buffer"] = jbuf, tbuf
        th["_qmix_init"] = params_from_jax(
            jsim._make_selector(jsim.FLConfig(**kw), 4).learner.params)
    assert th["phase_s"][0] == {} and th["phase_s"][-1]
    assert_async_runs_agree(kw, jh, th, jsel, tsel, kw["client_executor"])
    return jh, th
