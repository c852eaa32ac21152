"""Seeded faults against the JAX package's: the fault plan itself (the
same events from the same seed), its validation, live faulted async runs
of both packages (``tests/torch_live.py``: every fault event's outcome,
the reaped tasks and the quarantined rows identical), the sync engine's
refusal, and the quarantine of one bad row by each aggregation.

Live runs at the tests' size (n 8, width 0.125, 8x8 images) with the
reference's churn settings (``tests/test_resilience.py:23-31``): full
participation and healthy batteries, so faults land on live, in-flight
devices.  Tolerances as ``tests/torch_live.py``; single aggregations
rtol=1e-5, atol=1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.selection import GreedySelector as JaxGreedySelector
from repro.fl import faults as jfaults
from repro.fl import server as jserver
from repro.fl import simulation as jsim
from repro.fl.engine import RoundEngine as JaxRoundEngine
from repro.models.family import get_family as jax_get_family
from repro_torch.convert import cnn_params_from_jax, cnn_params_to_jax_layout
from repro_torch.core.selection import GreedySelector
from repro_torch.fl import faults as tfaults
from repro_torch.fl import server as tserver
from repro_torch.fl import simulation as tsim
from repro_torch.fl.engine import RoundEngine
from repro_torch.tree import tree_leaves, tree_map
from torch_live import BASE, assert_async_runs_agree, run_both

torch.set_num_threads(1)
ONE = dict(rtol=1e-5, atol=1e-6)


def _events(plan):
    return [ev.as_dict() for ev in plan.events]


@pytest.mark.parametrize("n,horizon,counts,seed", [
    (16, 100.0, dict(crashes=2, timeouts=2, corrupts=2), 7),
    (16, 100.0, dict(crashes=2, timeouts=2, corrupts=2), 8),
    (64, 1234.5, dict(crashes=2, timeouts=2, disconnects=2, corrupts=2), 0),
    (5, 3.0, dict(disconnects=4, corrupts=6), 11),
    (300, 5e4, dict(crashes=7, timeouts=1, disconnects=3, corrupts=9), 3),
])
def test_fault_plan_equals_the_jax_packages(n, horizon, counts, seed):
    ref = jfaults.FaultPlan.sample(n, horizon, seed=seed, **counts)
    got = tfaults.FaultPlan.sample(n, horizon, seed=seed, **counts)
    assert _events(got) == _events(ref)
    assert len(got) == sum(counts.values())
    assert all(0.0 < e.time < horizon for e in got.events)


def test_fault_plan_from_config_and_validation():
    kw = dict(n_devices=12, seed=5, fault_crashes=1, fault_corrupts=3,
              async_time_horizon=80.0)
    for extra in (dict(), dict(fault_horizon=40.0, fault_seed=9)):
        ref = jfaults.FaultPlan.from_config(jsim.FLConfig(**kw, **extra))
        got = tfaults.FaultPlan.from_config(tsim.FLConfig(**kw, **extra))
        assert _events(got) == _events(ref)
    assert tfaults.FaultPlan.from_config(tsim.FLConfig()) is None
    with pytest.raises(ValueError, match="time window"):
        tfaults.FaultPlan.from_config(tsim.FLConfig(fault_crashes=1))
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfaults.FaultPlan(events=(tfaults.FaultEvent(1.0, "gremlin", 0),))
    with pytest.raises(ValueError, match="corrupt payload"):
        tfaults.FaultPlan(events=(tfaults.FaultEvent(
            1.0, "corrupt", 0, payload="zero"),))
    with pytest.raises(ValueError, match="horizon"):
        tfaults.FaultPlan.sample(4, 0.0, crashes=1)
    assert tfaults.poison_payload("huge") == jfaults.poison_payload("huge")


def test_sync_engine_refuses_a_fault_plan():
    kw = dict(BASE, selector="greedy", fault_crashes=1, fault_horizon=100.0)
    with pytest.raises(ValueError, match="async") as ref:
        JaxRoundEngine(jsim.FLConfig(**kw), JaxGreedySelector())
    with pytest.raises(ValueError, match="async") as got:
        RoundEngine(tsim.FLConfig(**kw), GreedySelector(), device="cpu")
    assert str(got.value) == str(ref.value)


#: the reference's churn config (full participation, so faults land on
#: in-flight devices) at the tests' size, cut to 2 rounds (16 tasks, about
#: 80 sim-seconds) with the faults spread over the first 60, and BASE's
#: batteries.  Its energy_scale of 50 makes greedy give every client the
#: full depth, whose last stage runs at 1x1 on 8x8 images: there float32
#: SGD is ill-conditioned (tests/test_torch_baselines.py), and the two
#: packages' weights end 5e-4 apart after 16 aggregations.  The plans of
#: :func:`_every_kind` strike the first wave, so their runs take 1 round
#: (8 tasks): over 2, the per-client executor's weights end 1.6e-5 apart
CHURN = dict(BASE, participation=1.0, n_rounds=2, engine_mode="async",
             async_time_horizon=400.0, fault_horizon=60.0, fault_crashes=1,
             fault_timeouts=2, fault_disconnects=1, fault_corrupts=3,
             selector="greedy")


def _every_kind(payload):
    """All four kinds on in-flight devices (every device is dispatched at
    t = 0), the corrupt one with ``payload``."""
    return jfaults.FaultPlan(events=(
        jfaults.FaultEvent(time=1.0, kind="crash", device=0),
        jfaults.FaultEvent(time=1.5, kind="timeout", device=1),
        jfaults.FaultEvent(time=2.0, kind="disconnect", device=2,
                           duration=30.0),
        jfaults.FaultEvent(time=2.5, kind="corrupt", device=3,
                           payload=payload)))


CASES = {
    "churn-batched": (dict(CHURN, client_executor="batched"), None),
    "churn-marl-perclient": (dict(CHURN, selector="marl",
                                  client_executor="perclient"), None),
    "nan-batched": (dict(CHURN, n_rounds=1, client_executor="batched"),
                    _every_kind("nan")),
    "inf-perclient": (dict(CHURN, n_rounds=1, client_executor="perclient"),
                      _every_kind("inf")),
    "huge-heterofl-batched": (dict(CHURN, n_rounds=1, method="heterofl",
                                   client_executor="batched"),
                              _every_kind("huge")),
    # every device crashes mid-first-wave (test_resilience.py:144-162)
    "all-in-flight-dead": (dict(CHURN, client_executor="perclient"),
                           jfaults.FaultPlan(events=tuple(
                               jfaults.FaultEvent(time=1.0 + 0.01 * i,
                                                  kind="crash", device=i)
                               for i in range(8)))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_faulted_run_matches_jax(case):
    kw, plan = CASES[case]
    jh, th, jsel, tsel = run_both(kw, fault_plan=plan)
    assert_async_runs_agree(kw, jh, th, jsel, tsel, kw["client_executor"])
    if plan is None:
        plan = tfaults.FaultPlan.from_config(tsim.FLConfig(**kw))
    faults = th["faults"]
    injected = [e for e in faults["events"] if e["injected"]]
    assert sorted((e["time"], e["kind"], e["device"]) for e in injected) \
        == sorted((e.time, e.kind, e.device) for e in plan.events)
    assert all("outcome" in e for e in faults["events"])
    # every poisoned delta is quarantined, and nothing else is
    poisoned = [(e["device"], e["poisoned_version"])
                for e in faults["events"] if e["outcome"] == "poisoned"]
    assert sorted(poisoned) == sorted(
        (q["device"], q["version"]) for q in faults["quarantined"])
    lost = [t for t in th["task_log"] if t.get("lost")]
    assert faults["n_reaped"] == len(lost) == sum(th["lost"]) \
        == th["terminated"]["lost"]
    for leaf in tree_leaves(th["params"]):
        assert torch.isfinite(leaf).all()
    if case == "all-in-flight-dead":
        assert th["terminated"]["reason"] == "fleet_dead"
        mid = [e for e in faults["events"]
               if e["outcome"] == "crash_mid_task"]
        assert mid and faults["n_reaped"] == len(mid)
    elif case != "churn-marl-perclient":
        assert poisoned and lost


def _jax_cnn(seed):
    shapes = jax.eval_shape(
        lambda k: jax_get_family("cnn").init(k, 10, width_mult=0.125, hw=8),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * 0.3).astype(np.float32),
        shapes)


def _assert_close(got, ref):
    got = tree_leaves(cnn_params_to_jax_layout(got))
    ref = jax.tree.leaves(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(r), **ONE)


@pytest.mark.parametrize("agg", ["drfl", "drfl_stacked", "sliced"])
@pytest.mark.parametrize("poison", [float("nan"), float("inf"), 1e30],
                         ids=["nan", "inf", "huge"])
def test_one_bad_row_is_quarantined(agg, poison):
    """A good and a poisoned full-width delta (``test_resilience.py:
    196-235``): the poisoned one is refused ([True, False]) and the new
    weights are those of the good one alone, in both packages."""
    gp = _jax_cnn(0)
    good = jax.tree.map(lambda a: np.full_like(a, 1e-3), gp)
    bad = jax.tree.map(lambda a: np.full_like(a, poison), gp)
    tgp, tgood, tbad = (cnn_params_from_jax(t) for t in (gp, good, bad))
    if agg == "drfl":
        ref, jv = jserver.aggregate_drfl(gp, [good, bad], [3, 3], [1.0, 1.0],
                                         server_lr=0.7, with_stats=True)
        got, tv = tserver.aggregate_drfl(tgp, [tgood, tbad], [3, 3],
                                         [1.0, 1.0], server_lr=0.7)
    elif agg == "drfl_stacked":
        stack = jax.tree.map(lambda a, b: jnp.stack([a, b]), good, bad)
        ref, jv = jserver.aggregate_drfl_stacked(
            gp, [(3, stack, [1.0, 1.0], None)], server_lr=0.7,
            with_stats=True)
        tstack = tree_map(lambda a, b: torch.stack([a, b]), tgood, tbad)
        got, tv = tserver.aggregate_drfl_stacked(
            tgp, [(3, tstack, [1.0, 1.0], None)], server_lr=0.7)
    else:
        ref, jv = jserver.aggregate_sliced(gp, [good, bad], [1.0, 1.0],
                                           with_stats=True)
        got, tv = tserver.aggregate_sliced(tgp, [tgood, tbad], [1.0, 1.0])
    assert tv.tolist() == np.asarray(jv).tolist() == [True, False]
    _assert_close(got, ref)
