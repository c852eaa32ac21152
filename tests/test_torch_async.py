"""The async engine and hot-plug against the JAX package's, on live runs
of both (``tests/torch_live.py``): the event record identical (task log,
picks, model choices, staleness, task and aggregation counts, termination,
hot-plug), times, energy, idle and the reward's non-accuracy terms at
rtol=1e-4, accuracy within one validation sample, final weights and the
QMIX losses allclose.  Every arm names its client executor (the JAX
``"auto"`` looks at the backend, the port's does not) and runs at the
tests' size (n <= 8, width 0.125, 8x8 images); a MARL arm acts with ε = 0
from the JAX selector's QMIX params.

The arms are the reference's own async and hot-plug tests
(``tests/test_engine.py:45-205``, ``tests/test_batch.py:260-270``) at that
size, plus the baselines, the transformer and a staleness decay other
than 0.5.  Then the per-client executor's snapshots: a task trains on the
weights it pulled at its dispatch, never on later ones.
"""
import pytest
import torch

from repro_torch.fl import FLConfig, run_simulation
from repro_torch.fl import server as tserver
from repro_torch.fl.engine import RoundEngine
from repro_torch.tree import tree_leaves
from torch_live import (BASE, assert_async_runs_agree, assert_runs_agree,
                        run_both)

torch.set_num_threads(1)

GREEDY = dict(engine_mode="async", selector="greedy")
MARL = dict(engine_mode="async", n_devices=6, client_executor="perclient")
# hot-plug at the reference's settings (test_engine.py:45-54, :159-205),
# cut to 4 rounds at 60%: over 6 rounds of 8 clients SGD drift in float32
# passes 1e-4 on some weights, as on any arm run that long
HOTPLUG = dict(GREEDY, n_devices=5, participation=0.6, n_rounds=4, seed=4,
               hotplug_round=2, hotplug_n=3, energy_scale=0.5,
               client_executor="perclient")
ARMS = {
    "drfl-greedy-perclient": dict(GREEDY, client_executor="perclient"),
    "drfl-marl-perclient": MARL,
    # a budget above the sync run's 9 tasks sizes the replay episode
    # (test_engine.py:138-145 takes 30).  Short: SGD drift in float32
    # grows with the aggregations, and after 15 of them at this size the
    # two packages' weights end 2.3e-5 apart, past 1e-4 relative
    "drfl-marl-task-budget": dict(MARL, async_task_budget=12),
    # about half of the full run's 109 sim-seconds
    "drfl-greedy-horizon": dict(GREEDY, client_executor="perclient",
                                async_time_horizon=55.0),
    "drfl-greedy-batched": dict(GREEDY, client_executor="batched"),
    # the baselines at the settings of tests/test_torch_baselines.py
    "heterofl-batched": dict(GREEDY, method="heterofl", seed=3,
                             client_executor="batched"),
    "scalefl-perclient": dict(GREEDY, method="scalefl", energy_scale=0.01,
                              client_executor="perclient"),
    "transformer-drfl-batched": dict(GREEDY, model_family="transformer",
                                     width_mult=0.25,
                                     client_executor="batched"),
    "staleness-decay-0.25": dict(GREEDY, client_executor="batched",
                                 staleness_decay=0.25),
    "hotplug": HOTPLUG,
    "hotplug-forced-join": dict(HOTPLUG, n_devices=4, participation=1.0,
                                n_rounds=6, seed=0, hotplug_round=4,
                                energy_scale=0.001),
    "sync-hotplug": dict(HOTPLUG, engine_mode="sync", n_rounds=3),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_live_run_matches_jax(arm):
    kw = dict(BASE, **ARMS[arm])
    jh, th, jsel, tsel = run_both(kw)
    if kw["engine_mode"] == "sync":
        assert_runs_agree(kw, jh, th, jsel, tsel, kw["client_executor"])
        assert any(i >= kw["n_devices"] for p in th["participants"]
                   for i in p)
        return
    assert_async_runs_agree(kw, jh, th, jsel, tsel, kw["client_executor"])
    # what each arm is there to exercise
    assert th["n_aggregations"] == len(th["staleness"]) >= 1
    if arm.startswith("drfl-greedy") or arm == "staleness-decay-0.25":
        assert max(th["staleness"]) >= 1
    if arm == "drfl-marl-task-budget":
        assert 9 < th["n_tasks"] <= 12
    if arm == "drfl-greedy-horizon":
        assert th["terminated"]["reason"] == "horizon_reached"
        assert th["sim_time_total"] <= kw["async_time_horizon"] + 1e-6
    if arm == "hotplug":
        hp = th["hotplug"]
        assert (hp["k_before"], hp["k_after"], th["k_final"]) == (3, 5, 5)
        assert any(t["device"] >= 5 for t in th["task_log"])
    if arm == "hotplug-forced-join":
        assert th["hotplug"]["vround"] < 4
        assert any(t["device"] >= 4 for t in th["task_log"])


def _copy(params):
    return [t.detach().clone() for t in tree_leaves(params)]


def test_perclient_task_trains_on_its_dispatch_snapshot(monkeypatch):
    """Every aggregation builds new tensors, so a task dispatched before
    one trains from the weights of its dispatch: the weights each
    completion trained from equal the global model at the task's version,
    and a stale task's differ from the model at its completion."""
    versions, trained = [], []
    aggregate = tserver.aggregate_drfl
    train_one = RoundEngine._train_one

    def recording_aggregate(gp, *args, **kw):
        if not versions:
            versions.append(_copy(gp))
        out = aggregate(gp, *args, **kw)
        versions.append(_copy(out[0]))
        return out

    def recording_train(self, params, *args):
        trained.append(_copy(params))
        return train_one(self, params, *args)
    monkeypatch.setattr(tserver, "aggregate_drfl", recording_aggregate)
    monkeypatch.setattr(RoundEngine, "_train_one", recording_train)
    hist = run_simulation(FLConfig(**dict(
        BASE, **ARMS["drfl-greedy-perclient"])), device="cpu")
    log = hist["task_log"]
    assert len(trained) == len(log) == hist["n_aggregations"]
    assert any(t["staleness"] > 0 for t in log)
    for got, task in zip(trained, log):
        at_dispatch = versions[task["version"]]
        assert all(torch.equal(a, b) for a, b in zip(got, at_dispatch))
        if task["staleness"] > 0:
            at_completion = versions[task["version"] + task["staleness"]]
            assert not all(torch.equal(a, b)
                           for a, b in zip(got, at_completion))
