"""The energy scenarios against the JAX package's, on live runs of both
(``tests/torch_live.py``): every charge, availability and budget scenario
on both engines and both client executors, plus hot-plug and a fault plan
under a diurnal wave, and the reference's own async budget config.  Picks,
model choices, the async task log, ``terminated`` and the budget's
``trimmed`` identical; energy, the budget's joules, rewards and weights at
``torch_live``'s tolerances.  Each arm also checks what it is there for:
harvesting adds energy, a gate keeps offline devices out (the host twin
over the fleet's phases) and bit at least once, the budget ends the run
within its limit.

The arms run at the tests' size (n 8, width 0.125, 8x8 images, greedy,
12 tasks) with batteries of 37.8 J (``energy_scale`` 0.005), so greedy
trains submodel 2 (about 20 J) and a battery binds after one or two
picks; a day of 30 sim-seconds is about three rounds.  At this size some
settings are ill-conditioned in the reference itself: perturbing its
initial weights by 1e-7 (relative) moves its final weights by 2.1e-4
(``carbon_window`` at seed 1, sync) or 5.8e-5 to 8.2e-4 (diurnal at duty
0.2, seed 2), past the tolerance, as Queue 3 of the ROADMAP records for
float32 SGD at 8x8.  Every arm below was checked against that probe: its
reference run moves by at most 3.1e-6.  So ``carbon_window`` runs seed 2
and the diurnal wave duty 0.15 at seed 6, where the async timeline
starves five times (wake events) and two sync rounds fast-forward.  The
reference's budget config (``tests/test_energy_profiles.py:255-261``,
16x16, 24 tasks, MARL) keeps its ε: the port's learner takes the JAX
learner's actions (``run_both(explore=True)``); there the run ends on the
task budget (``"tasks"``), as the live reference does under jax 0.9.0.
"""
import numpy as np
import pytest
import torch

from repro_torch.energy import scenario_from_config
from repro_torch.fl import FLConfig, run_simulation
from repro_torch.fl.engine import build_world
from torch_live import (BASE, assert_async_runs_agree, assert_runs_agree,
                        run_both)

torch.set_num_threads(1)

E = dict(BASE, energy_scale=0.005, charge_period=30.0, selector="greedy")
SCENARIOS = {
    "solar": dict(charge_profile="solar", charge_rate=1.0),
    "diurnal": dict(availability_profile="diurnal", availability_duty=0.15,
                    seed=6),
    "carbon_window": dict(charge_profile="carbon_window", charge_rate=1.0,
                          seed=2),
    # about three submodel-2 picks
    "global_budget": dict(charge_profile="solar", charge_rate=1.0,
                          global_budget_j=60.0),
}
DIURNAL = dict(availability_profile="diurnal", availability_duty=0.5)
ARMS = {f"{sc}-{mode}-{ex}": dict(E, **kw, engine_mode=mode,
                                  client_executor=ex)
        for sc, kw in SCENARIOS.items() for mode in ("sync", "async")
        for ex in ("perclient", "batched")}
# hot-plug at tests/test_torch_async.py's settings, under the wave
HOTPLUG = dict(E, **DIURNAL, n_devices=5, participation=0.6, n_rounds=4,
               seed=4, hotplug_round=2, hotplug_n=3,
               client_executor="perclient")
ARMS["hotplug-diurnal-sync"] = dict(HOTPLUG, engine_mode="sync")
ARMS["hotplug-diurnal-async"] = dict(HOTPLUG, engine_mode="async")
ARMS["faults-diurnal-async"] = dict(
    E, **DIURNAL, engine_mode="async", client_executor="perclient",
    fault_horizon=20.0, fault_crashes=1, fault_timeouts=1,
    fault_disconnects=1, fault_corrupts=1)
# tests/test_energy_profiles.py:244-261 (FLConfig's width and images)
ARMS["reference-budget-async"] = dict(
    n_devices=8, n_rounds=6, participation=0.5, n_train=400,
    local_epochs=1, method="drfl", selector="marl", energy_scale=0.05,
    seed=3, engine_mode="async", global_budget_j=150.0,
    client_executor="perclient")


def _open(kw, th):
    """(gated, offline picks): per round (sync) or task (async), the
    devices connected from the start that the scenario's host twin had
    offline at that sim time, and the picks that were offline."""
    cfg = FLConfig(**kw)
    sc = scenario_from_config(cfg)
    tz = build_world(cfg, device="cpu").fleet.tz_phase.numpy()
    if kw["engine_mode"] == "sync":
        starts = np.asarray(th["sim_time"]) - np.asarray(th["round_time"])
        ticks = list(zip(starts, th["participants"]))
    else:
        ticks = [(t["t_dispatch"], [t["device"]]) for t in th["task_log"]]
    gated = offline = 0
    for now, picks in ticks:
        ok = sc.available_host(tz.astype(np.float64), float(now))
        gated += int((~ok[:kw["n_devices"]]).sum())
        offline += sum(not ok[i] for i in picks)
    return gated, offline


@pytest.mark.parametrize("arm", list(ARMS))
def test_live_run_matches_jax(arm):
    kw = ARMS[arm]
    reference = arm.startswith("reference")
    jh, th, jsel, tsel = run_both(kw, explore=reference)
    if kw["engine_mode"] == "sync":
        assert_runs_agree(kw, jh, th, jsel, tsel, kw["client_executor"])
    else:
        assert_async_runs_agree(kw, jh, th, jsel, tsel,
                                kw["client_executor"])
    # what each arm is there to exercise
    if arm.startswith("solar"):
        flat = run_simulation(FLConfig(**dict(kw, charge_rate=0.0)),
                              device="cpu")
        assert th["energy"][-1] > flat["energy"][-1]
    if arm.startswith(("diurnal", "carbon_window", "hotplug", "faults")):
        gated, offline = _open(kw, th)
        assert gated >= 1 and offline == 0
    if arm.startswith("diurnal"):
        if kw["engine_mode"] == "async":
            assert len(th["wakes"]) >= 1
        else:   # a round that started after its predecessor ended
            ends = np.concatenate([[0.0], th["sim_time"][:-1]])
            starts = np.asarray(th["sim_time"]) - th["round_time"]
            assert np.any(starts > ends + 1e-6)
    if arm.startswith("global_budget"):
        b = th["budget"]
        assert th["terminated"]["reason"] == "budget_exhausted"
        assert th["terminated"]["budget"] == "energy"
        assert b["spent"] <= b["limit"] + 1e-6 and b["trimmed"] >= 1
    if arm.startswith("hotplug"):
        assert any(i >= kw["n_devices"] for p in th["participants"]
                   for i in p)
    if arm.startswith("faults"):
        assert any(e["injected"] for e in th["faults"]["events"])
    if reference:
        # the live reference's outcome under jax 0.9.0: the task budget
        # ran out first (the frozen expectation says "energy")
        assert th["terminated"]["reason"] == "budget_exhausted"
        assert th["terminated"]["budget"] == "tasks"
        assert th["budget"]["spent"] <= 150.0 + 1e-6
