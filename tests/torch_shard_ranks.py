"""The rank programs of ``tests/test_torch_shard.py``: each runs on every
rank of a 4-rank gloo group (``launch``), inside ``implicit_replication()``
as a caller of a sharded fleet must be, holds a sharded fleet's results
to the unsharded ones it computes itself, and raises on a mismatch (the
spawning test re-raises it).  No jax here: the spawned ranks import only
torch and the port."""
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core import fleet as tfleet
from repro_torch.core.selection import (OBS_DIM, MarlSelector,
                                        dual_selection_energy_step)
from repro_torch.core.marl.buffer import ReplayBuffer
from repro_torch.device import to_host
from repro_torch.sharding.fleet import (FLEET_AXIS, fleet_mesh,
                                        fleet_shardings, is_sharded,
                                        maybe_shard_fleet, shard_agent_array,
                                        shard_fleet, unshard_fleet)

WORLD = 4
SIZES = (2.8e6, 8.4e6, 22.5e6, 44.8e6)
FRACS = (0.11, 0.3, 0.72, 1.0)
STEP = dict(rtol=1e-5, atol=1e-6)          # tests/test_shard.py's


def _entry(rank, fn, path, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=WORLD)
    try:
        with implicit_replication():
            fn(rank, *args)
    finally:
        dist.destroy_process_group()


def start(fn, tmp_path, *args):
    """``fn(rank, *args)`` spawned on 4 gloo ranks (a file store under
    ``tmp_path``: no port, so parallel test workers never meet); the
    caller goes on and then calls :func:`wait`."""
    return mp.start_processes(_entry, args=(fn, str(tmp_path / "pg"), args),
                              nprocs=WORLD, join=False, start_method="spawn")


def kill(ctx):
    for p in ctx.processes:
        p.kill()


def wait(ctx, name: str, timeout: float):
    """The spawned ranks' end (a rank's exception re-raised), or killed
    after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            kill(ctx)
            raise TimeoutError(f"{name} took over {timeout} s")


def launch(fn, tmp_path, *args, timeout: float = 150.0):
    """``fn(rank, *args)`` on 4 spawned gloo ranks, waited for: killed
    after ``timeout`` seconds."""
    wait(start(fn, tmp_path, *args), fn.__name__, timeout)


def _host(t):
    return to_host(t)[0]


def _fleet(n, seed, scale=0.05):
    f = tfleet.make_fleet_state(n, seed, device="cpu")
    return f.replace(remaining=f.battery * scale)


def _same_fleet(got, ref, rtol=0.0):
    for f in ("remaining", "alive", "busy_until", "battery"):
        g, r = _host(getattr(got, f)), _host(getattr(ref, f))
        if rtol:
            np.testing.assert_allclose(g, r, rtol=rtol, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


def fleet_ops(rank):
    """Placement and fallback, the no-op and the refusals (the engine's
    ``fleet_mesh`` too), and every fleet op on a sharded fleet against the
    unsharded one."""
    from repro_torch.fl import FLConfig
    from repro_torch.fl.engine import check_supported
    check_supported(FLConfig(fleet_mesh=0))
    for n_shards in (-1, 2, WORLD):
        try:
            check_supported(FLConfig(fleet_mesh=n_shards))
        except ValueError as e:
            assert f"group of {WORLD} ranks" in str(e)
        else:
            raise AssertionError(f"the engine took fleet_mesh={n_shards} "
                                 f"under {WORLD} ranks")
    mesh = fleet_mesh()
    assert mesh.mesh_dim_names == (FLEET_AXIS,) and mesh.size() == WORLD
    single = _fleet(32 * WORLD, 5)
    sharded = shard_fleet(single, mesh)
    assert is_sharded(sharded)
    assert sharded.remaining.placements == (Shard(0),)
    assert sharded.remaining.to_local().shape == (32,)
    assert set(fleet_shardings(single, mesh).values()) == {(Shard(0),)}
    odd = shard_fleet(_fleet(32 * WORLD + 1, 5), mesh)
    assert odd.remaining.placements == (Replicate(),) and is_sharded(odd)
    back = unshard_fleet(sharded)
    assert not isinstance(back.remaining, DTensor)
    np.testing.assert_array_equal(back.remaining.numpy(),
                                  single.remaining.numpy())
    # the config's entry: 0/1 off, -1 and >= world all ranks, else refused
    assert maybe_shard_fleet(single, 0) is single
    assert maybe_shard_fleet(single, 1) is single
    for n_shards in (-1, WORLD, 2 * WORLD):
        assert is_sharded(maybe_shard_fleet(single, n_shards))
    for n_shards in (2, 3):
        try:
            maybe_shard_fleet(single, n_shards)
        except ValueError as e:
            assert f"world size {WORLD}" in str(e)
        else:
            raise AssertionError(f"fleet_mesh={n_shards} was not refused")

    n = len(single)
    for a, b in ((single, sharded), (_fleet(32 * WORLD + 1, 5), odd)):
        np.testing.assert_array_equal(
            _host(tfleet.fleet_affordability(b, SIZES, FRACS, 5, 32)),
            _host(tfleet.fleet_affordability(a, SIZES, FRACS, 5, 32)))
        np.testing.assert_array_equal(
            _host(tfleet.fleet_summary(b, SIZES, FRACS, 2, n_rounds=10)),
            tfleet.fleet_summary(a, SIZES, FRACS, 2, n_rounds=10).numpy())
    need = torch.linspace(0.0, 400.0, n)
    active = torch.arange(n) % 3 != 1
    f_s, ok_s = tfleet.fleet_charge(single, need, active)
    f_p, ok_p = tfleet.fleet_charge(sharded, need, active)
    assert is_sharded(f_p)                 # sharding survives the op
    np.testing.assert_array_equal(_host(ok_p), ok_s.numpy())
    _same_fleet(f_p, f_s)
    np.testing.assert_allclose(tfleet.fleet_total_remaining(f_p),
                               tfleet.fleet_total_remaining(f_s), rtol=1e-6)
    # the factored summary bit for bit after deaths
    np.testing.assert_array_equal(
        _host(tfleet.fleet_summary(f_p, SIZES, FRACS, 3, n_rounds=10)),
        tfleet.fleet_summary(f_s, SIZES, FRACS, 3, n_rounds=10).numpy())
    # the churn updates, hot-plug's included, across shard boundaries
    for op in (lambda f: tfleet.fleet_disconnect(f, 50),
               lambda f: tfleet.fleet_connect(
                   tfleet.fleet_disconnect(f, 50), 50, 0.5, now=3.0),
               lambda f: tfleet.fleet_kill(f, [0, 31, 32, 127]),
               lambda f: tfleet.fleet_set_alive(
                   tfleet.fleet_kill(f, [5, 64]), [64, 70], True)):
        got, ref = op(sharded), op(single)
        assert is_sharded(got)
        _same_fleet(got, ref)
    np.testing.assert_array_equal(tfleet.fleet_idle(sharded, 1.0),
                                  tfleet.fleet_idle(single, 1.0))

    # Top-K with ties across the shard boundaries, -inf never picked
    rng = np.random.default_rng(7)          # the same on every rank
    for trial in range(6):
        scores = rng.integers(0, 5, size=n).astype(np.float32)
        scores[rng.uniform(size=n) < 0.3] = -np.inf
        if trial == 0:
            scores[:] = 1.0                         # one big tie
        for k in (0, 1, 5, 31, 32, 33, 77, n, n + 3):
            ref = tfleet.fleet_topk_mask(torch.tensor(scores), k).numpy()
            got = tfleet.fleet_topk_mask(
                shard_agent_array(torch.tensor(scores), mesh), k)
            assert isinstance(got, DTensor)
            np.testing.assert_array_equal(_host(got), ref,
                                          err_msg=f"k={k} trial={trial}")

    x = torch.zeros((16 * WORLD, 64))
    placed = shard_agent_array(x, mesh)
    assert placed.placements == (Shard(0),)
    assert placed.to_local().shape == (16, 64)
    assert shard_agent_array(torch.zeros((16 * WORLD + 1, 64)),
                             mesh).placements == (Replicate(),)


def selection_step(rank, inputs_path):
    """``dual_selection_energy_step`` on the sharded fleet and hidden
    state against the unsharded step, and against the JAX package's
    (``inputs_path``: its inputs and outputs, written by the test); then a
    set-mixer selector's update from episodes on either fleet."""
    from repro_torch.energy.profiles import SolarCharge
    mesh = fleet_mesh()
    data = torch.load(inputs_path, weights_only=False)
    n, k, kw = data["n"], data["k"], data["kw"]
    fleet = tfleet.make_fleet_state(n, 2, device="cpu").replace(
        charge_rate=torch.tensor(data["rate"]),
        tz_phase=torch.tensor(data["phase"]))
    hidden = torch.tensor(data["hidden"])
    wave = torch.tensor(data["wave"])
    step_kw = dict(kw, charge_profile=SolarCharge(period=100.0))
    f1, h1, p1, a1, s1 = dual_selection_energy_step(
        data["params"], hidden, fleet, SIZES, FRACS, k, avail_mask=wave,
        **step_kw)
    f2, h2, p2, a2, s2 = dual_selection_energy_step(
        data["params"], shard_agent_array(hidden, mesh),
        shard_fleet(fleet, mesh), SIZES, FRACS, k,
        avail_mask=shard_agent_array(wave, mesh), **step_kw)
    assert is_sharded(f2) and isinstance(h2, DTensor)
    assert not isinstance(s2, DTensor)     # every rank holds the summary
    np.testing.assert_array_equal(_host(p2), p1.numpy())
    np.testing.assert_array_equal(_host(a2), a1.numpy())
    assert 0 < int(p1.sum()) <= k
    np.testing.assert_allclose(_host(f2.remaining), f1.remaining.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), **STEP)
    np.testing.assert_allclose(_host(h2), h1.numpy(), **STEP)
    # the JAX package's unsharded step on the same inputs
    ref = data["jax"]
    np.testing.assert_array_equal(_host(p2), ref["participants"])
    np.testing.assert_array_equal(_host(a2), ref["actions"])
    np.testing.assert_allclose(_host(f2.remaining), ref["remaining"],
                               rtol=1e-6)
    np.testing.assert_allclose(_host(h2), ref["hidden"], **STEP)
    np.testing.assert_allclose(s2.numpy(), ref["summary"], **STEP)

    def td_loss(shard):
        m = 64 * WORLD
        sel = MarlSelector(m, len(SIZES), n_rounds=3, seed=0,
                           state_mode="factored", mixer_mode="set",
                           agent_budget=16, device="cpu")
        f = tfleet.make_fleet_state(m, seed=2, device="cpu")
        if shard:
            f = shard_fleet(f, mesh)
            sel.hidden = shard_agent_array(sel.hidden, mesh)
        buf = ReplayBuffer(4, 3, m, OBS_DIM, sel.learner.cfg.state_dim, 0,
                           agent_budget=16)
        for t in range(3):
            sel.select(f, t, 8, SIZES, FRACS)
            sel.observe_reward(1.0)
        buf.add_episode(*sel.episode_arrays(f, 3))
        return sel.learner.update(buf.sample(4))["td_loss"]
    np.testing.assert_allclose(td_loss(True), td_loss(False), **STEP)

