"""The fleet mesh on ``torch.distributed`` (:mod:`repro_torch.sharding.
fleet`) — the twin of ``tests/test_shard.py``.

In one process: the no-op with no group and with a group of one rank,
and the placements with the divisibility fallback.  Then, on 4 gloo
ranks spawned per test function (``tests/torch_shard_ranks.py``; a file
store under ``tmp_path``, so parallel workers never share a port; each
spawn killed after its timeout): placement and fallback, every fleet op
(affordability, charge, the factored summary bit for bit, the churn and
hot-plug updates, the total) and ``fleet_topk_mask`` with ties against
the unsharded results; ``dual_selection_energy_step`` on a sharded fleet
and hidden state against the unsharded step (picks and actions equal,
``remaining`` at rtol 1e-6, summary and hidden at rtol 1e-5, atol 1e-6,
the reference's tolerances) and against the JAX package's unsharded
``dual_selection_energy_step_jit`` on the same inputs, params converted;
and a trained set-mixer selector's update.  The engine does not shard:
its ``fleet_mesh`` is refused under the 4 ranks (``fleet_ops``) and is a
no-op in a one-rank group, where ``fleet_mesh=-1`` and ``2`` give the
``fleet_mesh=0`` run bit for bit, sync and async.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import torch_shard_ranks as ranks
from repro.core import fleet as jfleet
from repro.core import selection as jselection
from repro.energy.profiles import SolarCharge as JaxSolarCharge
from repro_torch.convert import params_from_jax
from repro_torch.core.fleet import make_fleet_state
from repro_torch.sharding.fleet import (fleet_mesh, fleet_spec_for,
                                        is_sharded, maybe_shard_fleet)


def test_maybe_shard_noop_below_two_shards():
    """No process group: every setting keeps the fleet as it is (one card
    runs ``fleet_mesh=-1`` unsharded, as the reference on one device)."""
    fleet = make_fleet_state(8, seed=0, device="cpu")
    for n_shards in (0, 1, -1, 2, 4):
        assert maybe_shard_fleet(fleet, n_shards) is fleet
    assert not is_sharded(fleet)
    with pytest.raises(RuntimeError, match="process group"):
        fleet_mesh()


def test_one_rank_group_spec_and_noop(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = fleet_mesh()
        # trivially divisible: the fleet axis still names the placement
        assert fleet_spec_for("remaining", (32,), mesh) == (Shard(0),)
        assert fleet_spec_for("scalar", (), mesh) == (Replicate(),)
        fleet = make_fleet_state(8, seed=0, device="cpu")
        for n_shards in (0, 1, -1, 2):
            assert maybe_shard_fleet(fleet, n_shards) is fleet
        with pytest.raises(ValueError, match="world size 1"):
            fleet_mesh(2)
    finally:
        dist.destroy_process_group()


def test_sharded_fleet_ops_under_four_ranks(tmp_path):
    ranks.launch(ranks.fleet_ops, tmp_path)


def test_sharded_selection_step_under_four_ranks(tmp_path):
    """The inputs of ``tests/test_torch_fleet_scale.py``'s step test (a
    solar charge, a budget, an availability wave) at n 256; the JAX
    package's outputs go to the ranks beside the inputs."""
    n, k = 256, 12
    rng = np.random.default_rng(4)
    rate = rng.uniform(0.0, 2.0, n).astype(np.float32)
    phase = rng.uniform(0.0, 1.0, n).astype(np.float32)
    wave = rng.uniform(size=n) > 0.2
    hidden = rng.normal(size=(n, 64)).astype(np.float32)
    js = jselection.MarlSelector(n, 4, 4, seed=1, state_mode="factored",
                                 mixer_mode="set")
    jf = jfleet.make_fleet_state(n, 2, backend="jax").replace(
        charge_rate=jnp.asarray(rate), tz_phase=jnp.asarray(phase))
    kw = dict(round_idx=2, n_rounds=5, local_epochs=5, batch_size=32,
              budget_left=250.0, sim_time=30.0, charge_dt=12.0,
              energy_scale=0.9)
    jfl, jh, jpart, jact, jsum = jselection.dual_selection_energy_step_jit(
        js.learner.params["agent"], jnp.asarray(hidden), jf, ranks.SIZES,
        ranks.FRACS, k, charge_profile=JaxSolarCharge(period=100.0),
        avail_mask=jnp.asarray(wave), **kw)
    path = tmp_path / "inputs.pt"
    torch.save({"n": n, "k": k, "kw": kw, "rate": rate, "phase": phase,
                "wave": wave, "hidden": hidden,
                "params": params_from_jax(js.learner.params["agent"]),
                "jax": {"participants": np.asarray(jpart),
                        "actions": np.asarray(jact),
                        "remaining": np.asarray(jfl.remaining),
                        "hidden": np.asarray(jh),
                        "summary": np.asarray(jsum)}}, path)
    ranks.launch(ranks.selection_step, tmp_path, str(path))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_engine_fleet_mesh_in_a_one_rank_group(mode, tmp_path):
    from repro_torch.fl import FLConfig, run_simulation
    from repro_torch.tree import tree_leaves
    cfg = FLConfig(n_devices=16, n_rounds=2, participation=0.5, n_train=400,
                   local_epochs=1, selector="greedy", seed=0,
                   engine_mode=mode)
    ref = run_simulation(cfg, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        for n_shards in (-1, 2):
            h = run_simulation(dataclasses.replace(cfg, fleet_mesh=n_shards),
                               device="cpu")
            for key in ("participants", "model_choices", "acc_mean",
                        "energy"):
                assert h[key] == ref[key], (n_shards, key)
            for g, r in zip(tree_leaves(h["params"]),
                            tree_leaves(ref["params"])):
                assert torch.equal(g, r)
    finally:
        dist.destroy_process_group()
