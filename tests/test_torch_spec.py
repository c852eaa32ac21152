"""The typed ``SimulationSpec`` against the JAX package's: every bad knob
the reference rejects raises the same ``ValueError``, message for
message, from the port's spec and from its ``run_simulation``, before any
device work; ``from_flat``/``to_flat`` round-trip exactly over drawn
valid configs; the spec classes keep the reference's fields and
defaults; ``ensure_flat_config`` hands a flat config back by
identity; ``repro_torch.fl`` exports every public name of ``repro.fl``;
and the README's Public API example runs in the port.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.fl as jfl
from repro.fl import spec as jspec
import repro_torch.fl as tfl
from repro_torch.fl import spec as tspec

torch.set_num_threads(1)
SMALL = dict(n_devices=8, n_rounds=2, participation=0.5, local_epochs=1,
             batch_size=16, n_train=400, hw=8, width_mult=0.125, seed=1)

#: one flat change per check of the reference's specs (fl/spec.py:75-261)
BAD_KNOBS = {
    "n_devices": dict(n_devices=0),
    "n_rounds": dict(n_rounds=0),
    "participation=0": dict(participation=0.0),
    "participation>1": dict(participation=1.5),
    "method": dict(method="fedavg"),
    "server_lr": dict(server_lr=0.0),
    "n_train": dict(n_train=0),
    "alpha": dict(alpha=0.0),
    "n_val_fraction=0": dict(n_val_fraction=0.0),
    "n_val_fraction=1": dict(n_val_fraction=1.0),
    "noise": dict(noise=-1.0),
    "family": dict(model_family="resnet9000"),
    "family-method": dict(model_family="mlp", method="heterofl"),
    "transformer-scalefl": dict(model_family="transformer",
                                method="scalefl"),
    "width_mult": dict(width_mult=0.0),
    "hw": dict(hw=0),
    "num_classes": dict(num_classes=1),
    "local_epochs": dict(local_epochs=0),
    "batch_size": dict(batch_size=0),
    "lr": dict(lr=0.0),
    "engine_mode": dict(engine_mode="asynch"),
    "client_executor": dict(client_executor="vmap"),
    "staleness_decay": dict(staleness_decay=-0.5),
    "async_eval_every": dict(async_eval_every=0),
    "async_time_horizon": dict(async_time_horizon=-1.0),
    "async_task_budget": dict(async_task_budget=-1),
    "fleet_mesh": dict(fleet_mesh=-2),
    "selector": dict(selector="mral"),
    "state_mode": dict(state_mode="sparse"),
    "mixer_mode": dict(mixer_mode="dense"),
    "reward_weights": dict(reward_weights=(1.0, 2.0)),
    "marl_train_every": dict(marl_train_every=0),
    "marl_updates_per_round": dict(marl_updates_per_round=-1),
    "marl_episodes": dict(marl_episodes=0),
    "marl_agent_budget": dict(marl_agent_budget=0),
    "energy_scale": dict(energy_scale=0.0),
    "hotplug_round": dict(hotplug_round=-1),
    "hotplug_n": dict(hotplug_n=-1),
    "charge_profile": dict(charge_profile="fusion"),
    "availability_profile": dict(availability_profile="sometimes"),
    "charge_rate": dict(charge_rate=-1.0),
    "charge_period": dict(charge_period=0.0),
    "availability_duty=0": dict(availability_duty=0.0),
    "availability_duty>1": dict(availability_duty=1.5),
    "global_budget_j": dict(global_budget_j=-1.0),
    "checkpoint_every": dict(checkpoint_every=-1),
    "checkpoint_keep": dict(checkpoint_keep=0),
    "fault_crashes": dict(fault_crashes=-1),
    "fault_timeouts": dict(fault_timeouts=-1),
    "fault_disconnects": dict(fault_disconnects=-1),
    "fault_corrupts": dict(fault_corrupts=-1),
    "fault_horizon": dict(fault_horizon=-1.0),
    "task_deadline_factor": dict(task_deadline_factor=1.0),
    "resume-without-dir": dict(resume=True),
    "faults-on-sync": dict(fault_crashes=1, fault_horizon=100.0),
    "faults-without-window": dict(engine_mode="async", fault_timeouts=2),
}


@pytest.mark.parametrize("name", list(BAD_KNOBS))
def test_bad_knob_raises_the_references_error(name):
    """The reference's ``ensure_flat_config`` error, and the same type and
    message from the port's ``SimulationSpec.from_flat`` and from its
    ``run_simulation`` on the default device, the card: without one here,
    a check made after the device's would raise ``RuntimeError``."""
    kw = dict(SMALL, **BAD_KNOBS[name])
    with pytest.raises(ValueError) as ref:
        jspec.ensure_flat_config(jfl.FLConfig(**kw))
    with pytest.raises(ValueError) as spec:
        tspec.SimulationSpec.from_flat(tfl.FLConfig(**kw))
    with pytest.raises(ValueError) as run:
        tfl.run_simulation(tfl.FLConfig(**kw))
    assert str(spec.value) == str(run.value) == str(ref.value)


def _valid_flat(d):
    return dict(
        n_devices=d(st.integers(1, 4096)), n_rounds=d(st.integers(1, 500)),
        participation=d(st.floats(1e-3, 1.0)),
        local_epochs=d(st.integers(1, 10)), batch_size=d(st.integers(1, 256)),
        lr=d(st.floats(1e-4, 1.0)), alpha=d(st.floats(1e-3, 10.0)),
        num_classes=d(st.integers(2, 100)), n_train=d(st.integers(1, 10**6)),
        n_val_fraction=d(st.floats(0.001, 0.999)),
        noise=d(st.floats(0.0, 5.0)), hw=d(st.integers(1, 64)),
        width_mult=d(st.floats(0.01, 2.0)), seed=d(st.integers(0, 2**31)),
        model_family=d(st.sampled_from(("cnn", "mlp", "transformer"))),
        selector=d(st.sampled_from(tspec.SELECTORS)),
        reward_weights=d(st.tuples(*[st.floats(0.0, 1e3)] * 3)),
        marl_train_every=d(st.integers(1, 8)),
        marl_updates_per_round=d(st.integers(0, 8)),
        marl_episodes=d(st.integers(1, 4)),
        hotplug_round=d(st.integers(0, 50)), hotplug_n=d(st.integers(0, 64)),
        energy_scale=d(st.floats(1e-3, 10.0)),
        charge_profile=d(st.sampled_from(
            tfl.known_charge_profiles())),
        charge_rate=d(st.floats(0.0, 10.0)),
        charge_period=d(st.floats(1.0, 1e5)),
        availability_profile=d(st.sampled_from(
            tfl.known_availability_profiles())),
        availability_duty=d(st.floats(0.01, 1.0)),
        global_budget_j=d(st.floats(0.0, 1e6)),
        server_lr=d(st.floats(1e-3, 2.0)),
        engine_mode=d(st.sampled_from(tspec.ENGINE_MODES)),
        staleness_decay=d(st.floats(0.0, 2.0)),
        async_eval_every=d(st.integers(1, 16)),
        async_time_horizon=d(st.floats(0.0, 1e4)),
        async_task_budget=d(st.integers(0, 1000)),
        client_executor=d(st.sampled_from(tspec.CLIENT_EXECUTORS)),
        state_mode=d(st.sampled_from(tspec.STATE_MODES)),
        mixer_mode=d(st.sampled_from(tspec.MIXER_MODES)),
        marl_agent_budget=d(st.integers(1, 8192)),
        fleet_mesh=d(st.integers(-1, 8)),
        checkpoint_dir=d(st.sampled_from(("", "ckpt"))),
        checkpoint_every=d(st.integers(0, 5)),
        checkpoint_keep=d(st.integers(1, 5)),
        task_deadline_factor=d(st.floats(1.01, 10.0)))


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_round_trip_is_exact_over_valid_configs(data):
    kw = _valid_flat(data.draw)
    if kw["model_family"] != "cnn":
        kw["method"] = "drfl"
    else:
        kw["method"] = data.draw(st.sampled_from(tspec.METHODS))
    if kw["engine_mode"] == "async":
        kw["fault_crashes"] = data.draw(st.integers(0, 3))
        kw["fault_horizon"] = data.draw(st.floats(1.0, 100.0))
    kw["resume"] = bool(kw["checkpoint_dir"]) and data.draw(st.booleans())
    flat = tfl.FLConfig(**kw)
    spec = tfl.SimulationSpec.from_flat(flat)
    assert spec.to_flat() == flat
    assert tfl.SimulationSpec.from_flat(spec.to_flat()) == spec
    jflat = jfl.FLConfig(**kw)
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        jspec.SimulationSpec.from_flat(jflat))
    assert tfl.ensure_flat_config(spec) == flat


@pytest.mark.parametrize("name", ["ModelSpec", "EngineSpec", "MarlSpec",
                                  "EnergySpec", "ResilienceSpec",
                                  "SimulationSpec"])
def test_fields_and_defaults_equal_the_references(name):
    """Each spec class (``FLConfig``'s own are held by
    ``tests/test_torch_guards.py``)."""
    tcls, jcls = getattr(tfl, name), getattr(jfl, name)
    assert [f.name for f in dataclasses.fields(tcls)] == \
        [f.name for f in dataclasses.fields(jcls)]
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


def test_choice_tuples_equal_the_references():
    for name in ("METHODS", "SELECTORS", "ENGINE_MODES", "CLIENT_EXECUTORS",
                 "STATE_MODES", "MIXER_MODES"):
        assert getattr(tspec, name) == getattr(jspec, name), name


def test_ensure_flat_config_identity_and_type_error():
    flat = tfl.FLConfig(**SMALL)
    assert tfl.ensure_flat_config(flat) is flat
    spec = tfl.SimulationSpec.from_flat(flat)
    assert tfl.ensure_flat_config(spec) == flat
    with pytest.raises(TypeError) as got:
        tfl.ensure_flat_config({"n_devices": 2})
    with pytest.raises(TypeError) as ref:
        jspec.ensure_flat_config({"n_devices": 2})
    assert str(got.value) == str(ref.value)


JAX_PUBLIC = sorted(n for n in dir(jfl) if not n.startswith("_")
                    and not type(getattr(jfl, n)).__name__ == "module")


@pytest.mark.parametrize("name", JAX_PUBLIC)
def test_every_public_name_of_repro_fl_is_exported(name):
    assert hasattr(tfl, name), name
    assert callable(getattr(tfl, name)) == callable(getattr(jfl, name))


def test_spec_and_flat_runs_are_equal():
    flat = tfl.FLConfig(**dict(SMALL, selector="greedy"))
    a = tfl.run_simulation(flat, device="cpu")
    b = tfl.run_simulation(tfl.SimulationSpec.from_flat(flat), device="cpu")
    for key in ("participants", "model_choices", "acc_mean", "energy",
                "reward"):
        assert a[key] == b[key], key


def test_readme_public_api_example_runs_in_the_port():
    """README.md's example with ``repro.fl`` replaced by
    ``repro_torch.fl``, cut to 2 rounds for the CPU: the ``mlp`` family on
    the async engine, greedy, 64 devices at 20%, bucketed."""
    from repro_torch.fl import (EngineSpec, MarlSpec, ModelSpec,
                                SimulationSpec, run_simulation)
    spec = SimulationSpec(
        n_devices=64, n_rounds=10, participation=0.2, method="drfl",
        model=ModelSpec(family="mlp", hw=8),
        marl=MarlSpec(selector="greedy"),
        engine=EngineSpec(mode="async"),
    )
    hist = run_simulation(dataclasses.replace(spec, n_rounds=2),
                          device="cpu")
    assert hist["engine"] == "async" and hist["executor"] == "batched"
    assert hist["n_tasks"] == 2 * 13 and hist["n_aggregations"] >= 1
    assert np.isfinite(hist["acc_mean"]).all()
