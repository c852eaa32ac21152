"""Kill-and-resume within the port, bit for bit: the mirror of
``tests/test_resilience.py:76-115`` on ``repro_torch`` (CPU).

A run killed right after a checkpoint save (``halt_after_saves``) and
resumed from disk (``resume=True``) must end with the history and final
weights of an uninterrupted run of the same config, byte for byte: RNG
streams, the async event heap and its tasks, the MARL learner, its ε
generator and replay included.  Two records are exempt, as host clocks:
``wall_clock`` and the port's ``phase_s`` (host seconds by phase).

The reference's arms (sync MARL killed inside its second episode; async
greedy per-client; async MARL under churn, which must fault; async set
mixer, batched, 4 sampled agents; the config-drift refusal) run here at
width 0.125 and batches of 16 (the reference's: 0.25, 8), which keeps
the file's CPU time small.  Added: sync DR-FL on the bucketed executor
(64 devices, through ``layer_agg``'s plain version on the CPU), and an
energy scenario with a global joule budget, solar charging and a diurnal
gate on each engine, so that ``budget_spent``, ``budget_blocked`` and
``last_charge_t`` cross the save.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointHalt
from repro_torch.fl import FLConfig, run_simulation
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

SMALL = dict(n_devices=8, n_rounds=6, participation=0.5, local_epochs=1,
             batch_size=16, n_train=256, hw=8, width_mult=0.125, seed=3)
# faults must land on live, in-flight devices: healthy batteries and full
# participation (tests/test_resilience.py:28-33); 4 rounds, not 8: every
# planned fault fires in the first two virtual rounds at this size
CHURN = dict(SMALL, participation=1.0, energy_scale=50.0, n_rounds=4,
             engine_mode="async", async_time_horizon=400.0,
             fault_crashes=1, fault_timeouts=2, fault_disconnects=1,
             fault_corrupts=3)
# tests/test_torch_energy_live.py's size: 37.8 J batteries, a 30 s day;
# a budget of about ten submodel-2 picks, which ends both engines' runs
# (sync after 6 rounds, async after 4 virtual rounds)
ENERGY = dict(SMALL, n_train=400, energy_scale=0.005, charge_period=30.0,
              selector="greedy", charge_profile="solar", charge_rate=1.0,
              availability_profile="diurnal", availability_duty=0.5,
              global_budget_j=200.0, client_executor="perclient")
#: host clocks: the only records a resumed run may change
EXEMPT = ("wall_clock", "phase_s", "params")


def _canon(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if isinstance(x, np.ndarray):
        return ("arr", str(x.dtype), x.tobytes())
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    return x


def _assert_bit_identical(ref, res):
    assert set(ref) == set(res)
    for k in ref:
        if k not in EXEMPT:
            assert _canon(ref[k]) == _canon(res[k]), f"hist[{k!r}] diverged"
    ra, rb = tree_leaves(ref["params"]), tree_leaves(res["params"])
    assert len(ra) == len(rb)
    for a, b in zip(ra, rb):
        assert a.dtype == b.dtype and a.numpy().tobytes() == \
            b.numpy().tobytes()


def _kill_and_resume(cfg, tmp_path, halt_after=1, every=2):
    """An uninterrupted run, then a checkpointed run killed after
    ``halt_after`` saves, then the resumed run; resumed == uninterrupted
    bit for bit.  Returns the uninterrupted history."""
    ref = run_simulation(cfg, device="cpu")
    ck = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / "ck"),
                             checkpoint_every=every)
    with pytest.raises(CheckpointHalt):
        run_simulation(ck, device="cpu", halt_after_saves=halt_after)
    res = run_simulation(dataclasses.replace(ck, resume=True), device="cpu")
    _assert_bit_identical(ref, res)
    return ref


def test_sync_marl_kill_resume_parity(tmp_path):
    # halt_after=4 lands the kill inside episode 1: the resume restores the
    # mid-episode learner, replay, ε generator and numpy RNG streams
    cfg = FLConfig(**SMALL, marl_episodes=2)
    ref = _kill_and_resume(cfg, tmp_path, halt_after=4)
    assert ref["qmix"]["updates"] >= 1


def test_async_greedy_kill_resume_parity(tmp_path):
    cfg = FLConfig(**SMALL, engine_mode="async", selector="greedy",
                   client_executor="perclient")
    _kill_and_resume(cfg, tmp_path)


def test_async_faulted_marl_kill_resume_parity(tmp_path):
    # the heap mid-flight: reaps, rejoins and armed corruptions
    cfg = FLConfig(**CHURN)
    ref = _kill_and_resume(cfg, tmp_path)
    assert ref["faults"]["events"], "churn config must actually fault"


@pytest.mark.slow
def test_async_set_mixer_batched_kill_resume_parity(tmp_path):
    cfg = FLConfig(**SMALL, engine_mode="async", client_executor="batched",
                   mixer_mode="set", marl_agent_budget=4, marl_episodes=2)
    ref = _kill_and_resume(cfg, tmp_path, halt_after=3)
    assert ref["qmix"]["mixer_mode"] == "set"
    assert ref["qmix"]["replay_agents"] == 4


def test_resume_rejects_config_drift(tmp_path):
    cfg = FLConfig(**SMALL, selector="greedy",
                   checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    with pytest.raises(CheckpointHalt):
        run_simulation(cfg, device="cpu", halt_after_saves=1)
    drifted = dataclasses.replace(cfg, resume=True, seed=cfg.seed + 1)
    with pytest.raises(ValueError, match="refusing to resume"):
        run_simulation(drifted, device="cpu")


def test_sync_bucketed_drfl_kill_resume_parity(tmp_path):
    # 64 devices: "auto" takes the bucketed executor, whose DR-FL
    # aggregation is layer_agg's route (its plain version on the CPU)
    cfg = FLConfig(n_devices=64, n_rounds=3, participation=0.1,
                   local_epochs=1, batch_size=16, n_train=1280, hw=8,
                   width_mult=0.125, seed=1, selector="greedy")
    ref = _kill_and_resume(cfg, tmp_path, every=1)
    assert ref["executor"] == "batched" and ref["n_aggregations"] >= 2


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_energy_budget_kill_resume_parity(tmp_path, mode):
    cfg = FLConfig(**ENERGY, engine_mode=mode)
    ref = _kill_and_resume(cfg, tmp_path, every=1)
    assert 0 < ref["budget"]["spent"] <= cfg.global_budget_j
    assert ref["terminated"]["reason"] == "budget_exhausted"
