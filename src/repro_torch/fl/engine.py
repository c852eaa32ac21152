"""FL round engine — port of ``repro.fl.engine``: ``build_world``,
``resolve_client_executor``, ``sync_task_budget``, ``_marl_train`` and
``RoundEngine`` in both modes, with the energy-scenario hooks (charge and
availability profiles, the global joule budget: :mod:`repro_torch.energy`)
and the checkpoint hooks (:mod:`repro_torch.checkpoint`).

* ``engine_mode="sync"`` (``engine.py:492-798``): barrier rounds.  Per
  round: the hot-plug hook, selection, Eq. 5/7 costs and the energy charge
  on the device, ONE batched host pull at the round head (charge outcome
  and round times), the clients' local training, aggregation, evaluation,
  and ONE batched pull at the round tail (per-exit accuracy, fleet
  energy, liveness).
* ``engine_mode="async"`` (``engine.py:804-1576``): an event heap of
  ``(time, seq, kind, payload)`` over per-device virtual clocks kept on
  the host in float64.  A dispatch tick selects among the idle devices and
  charges them (two batched pulls: the task times, then the charge
  outcome); each completion aggregates its delta at once, down-weighted by
  its staleness (``cfg.staleness_decay``), and back-fills the freed slot.
  Completions are grouped into virtual rounds of k tasks (one pull per
  emitted row); rewards are committed to the selector in dispatch order;
  the MARL learner trains at the end of the episode.  Hot-plug joins and,
  with a fault plan (:mod:`repro_torch.fl.faults`), crashes, timeouts,
  disconnects and corrupt deltas are timeline events; a fault plan gives
  every task a deadline at ``task_deadline_factor x t_cost``, where a lost
  task is reaped.

The energy scenario (:mod:`repro_torch.energy`; ``engine.py:506-795`` and
``:817-1570``) hooks into both modes, each hook gated on the scenario's
Python flags, so the default scenario launches and pulls nothing more:
harvesting tops up the alive devices over each round's sim time (sync) or
over the gap since the last dispatch tick (async); an availability gate
hides offline devices from the selector (a host mask over a float64 copy
of ``tz_phase``), fast-forwards the sync clock when the whole surviving
fleet is offline, and pushes a ``"wake"`` event at the next opening when
the async timeline starves; a global joule budget masks every selector's
picks by its remainder, trims the picks in selection order to the
cumulative cap (the overrun paid in the reward) and ends the run with
``budget_exhausted``.  Host pulls: an availability gate adds one at setup
(sync; the async engine folds the phases into its setup pull); a budget
adds one per sync round (the picks' costs) and one on a round or tick
that picks nobody, and on the async engine rides the tick's first pull.

The client executor is the reference's choice
(:func:`resolve_client_executor`):

* ``"batched"``: one program per submodel bucket (:mod:`fl.batch`); DR-FL
  aggregates the stacked deltas through the ``layer_agg`` kernel (the
  async engine: one launch per completion, N = 1), the baselines take
  them apart for the sliced scatter average.  The async engine trains a
  dispatch tick's tasks at the tick, on the weights of that moment;
* ``"perclient"``: each client's SGD loop in turn, its batches gathered
  on the device from the resident training set through its
  ``client_schedule`` (one index copy per client, no host sync per
  step); DR-FL aggregates with ``aggregate_drfl`` (``layerwise_aggregate``
  per leaf, as the reference), the baselines with ``aggregate_sliced``.
  The async engine trains a task at its completion, on the weights it
  pulled at dispatch: every aggregation builds new tensors, so such a
  snapshot is never changed under it.

Checkpoints (opt-in: ``cfg.checkpoint_dir`` and ``cfg.checkpoint_every``;
``engine.py:325-456``, ``:777-786``, ``:1420-1468``): every N rounds (sync,
at the round's tail) or virtual rounds (async, after the event that
emitted the row) the whole run state is saved through
:class:`repro_torch.checkpoint.EngineCheckpointer`: the fleet's tensors,
the weights, the history, the partitions, the selector and the replay,
the energy scenario's budget state and, async, the event heap and its
tasks (a bucketed task's delta row saved as its own ``[1, ...]`` slice, a
per-client task's dispatch-time weights once per model version), the
cohorts, the host clocks and liveness, and the fault bookkeeping.  The
decoded state, passed back as ``resume_state``, continues the run bit for
bit as if it had never stopped; ``halt_counter`` raises
:class:`repro_torch.checkpoint.CheckpointHalt` after its N-th save (the
simulated crash of the tests and of ``chip_smoke.py``).

Each phase of a (virtual) round (select, charge, clients, aggregate,
evaluate, marl_train) is a ``torch.profiler.record_function`` span named
``round.<phase>`` and has its host seconds recorded in
``hist["phase_s"]`` (one dict per round or emitted row).  ``select``,
``charge``, ``evaluate`` and ``marl_train`` end in a host pull, and so do
the batched executor's ``clients`` (one losses pull per bucket), so their
host time covers their device work.  ``aggregate`` and the per-client
executor's ``clients`` pull nothing: their host seconds are enqueue time,
and their device work is waited for by the next pull.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.checkpoint.engine import (CheckpointHalt,
                                           EngineCheckpointer,
                                           config_fingerprint)
from repro_torch.checkpoint.io import FLEET_CHECKPOINT_FIELDS
from repro_torch.core.fleet import (FleetState, fleet_charge, fleet_connect,
                                    fleet_cost_matrix, fleet_disconnect,
                                    fleet_kill, fleet_set_alive,
                                    fleet_set_busy, fleet_total_remaining,
                                    make_fleet_state)
from repro_torch.core.selection import (MarlSelector, resolve_mixer_mode,
                                        resolve_state_mode)
from repro_torch.data.loader import client_schedule
from repro_torch.data.partition import dirichlet_partition
from repro_torch.device import resolve_device, to_host
from repro_torch.energy import EnergyScenario, scenario_from_config
from repro_torch.fl import batch as fl_batch
from repro_torch.fl import server as fl_server
from repro_torch.fl.client import client_update_seed
from repro_torch.fl.faults import FaultPlan, poison_payload
from repro_torch.models.family import ModelFamily, get_family
from repro_torch.tree import tree_map


@contextlib.contextmanager
def _span(phase: Dict[str, float], name: str):
    """A profiler span ``round.<name>`` plus its host seconds in
    ``phase[name]`` (two clock reads: nothing measurable per round)."""
    t0 = time.perf_counter()
    with record_function(f"round.{name}"):
        yield
    phase[name] = phase.get(name, 0.0) + time.perf_counter() - t0


#: the selectors ``FLConfig.selector`` names (``simulation._make_selector``)
SELECTORS = ("marl", "greedy", "random", "static")


def uses_marl(cfg) -> bool:
    """The MARL selector runs only for DR-FL: the baselines always take
    the greedy selector, as the reference's fair-comparison arm."""
    return cfg.method == "drfl" and cfg.selector == "marl"


def check_supported(cfg) -> None:
    """Refuse, up front, every configuration outside this port's slices:
    the sync and async engines, with hot-plug and (async) fault plans;
    DR-FL, HeteroFL and ScaleFL with any of the four selectors; every
    registered family (``cnn``, ``mlp``, ``transformer`` and any a user
    registers; an unknown name, or a family that lacks the method, raises
    the reference's ``ValueError``); either client executor; either QMIX
    state and mixer at every fleet size; every energy scenario (an unknown
    profile name raises the reference's ``ValueError``); checkpoints and
    resume on both engines; ``fleet_mesh``, a no-op with no
    ``torch.distributed`` group or a group of one rank, as the reference's
    below two devices.  Above one rank it raises ``ValueError``: every
    rank would run the whole engine, client training and QMIX updates
    included, for one result, so the engine runs unsharded, one per
    process (the selection step shards by itself:
    :mod:`repro_torch.sharding.fleet`).  No setting the reference accepts
    raises ``NotImplementedError``.  ``run_simulation`` validates the config
    through :func:`repro_torch.fl.spec.ensure_flat_config` first."""
    if cfg.engine_mode not in ("sync", "async"):
        raise ValueError(f"unknown engine_mode {cfg.engine_mode!r} "
                         "(expected 'sync' or 'async')")
    family = get_family(cfg.model_family)
    if not family.supports(cfg.method):
        raise family.unsupported(cfg.method)
    scenario_from_config(cfg)
    if cfg.selector not in SELECTORS:
        raise ValueError(f"unknown selector {cfg.selector!r} (expected one "
                         f"of {SELECTORS})")
    resolve_client_executor(cfg)
    if (cfg.fleet_mesh not in (0, 1) and dist.is_available()
            and dist.is_initialized() and dist.get_world_size() > 1):
        raise ValueError(
            f"fleet_mesh={cfg.fleet_mesh} under a group of "
            f"{dist.get_world_size()} ranks: the engine runs unsharded, one "
            "per process (fleet_mesh 0 or 1, or no group); shard the "
            "selection step itself with repro_torch.sharding.fleet")
    if uses_marl(cfg):
        n_agents = cfg.n_devices + cfg.hotplug_n
        resolve_state_mode(cfg.state_mode, n_agents)  # an unknown name
        resolve_mixer_mode(cfg.mixer_mode, n_agents)  # raises ValueError


class _RestoredBucket(NamedTuple):
    """A bucket result restored from a checkpoint (``engine.py:81-86``):
    the task's own row was saved as a ``[1, ...]`` slice, so row 0 of this
    bucket is the slice the uninterrupted run takes."""
    stacked_delta: Any


@dataclasses.dataclass
class World:
    """Everything one episode needs: data (host numpy, plus the device
    copies the executor and evaluation read), fleet, global model, family
    and the paper-scale cost calibration."""
    x_tr: np.ndarray
    y_tr: np.ndarray
    x_val: np.ndarray
    y_val: np.ndarray
    parts: List[np.ndarray]
    fleet: FleetState
    global_params: Any
    n_models: int
    sizes: tuple
    fractions: tuple
    n_total: int
    family: ModelFamily
    device: torch.device
    scenario: EnergyScenario


def _validate_energy_feasibility(cfg, fleet, sizes, fractions) -> None:
    """Fail fast when a FRESH battery cannot pay for even the cheapest
    submodel (survival in ``fleet_charge`` is strict ``>``)."""
    _, _, e_tra, e_com = fleet_cost_matrix(fleet, sizes, fractions,
                                           cfg.local_epochs, cfg.batch_size)
    need, battery = to_host(e_tra + e_com, fleet.battery)
    need = np.asarray(need, np.float64)
    fresh = np.asarray(battery, np.float64) * float(cfg.energy_scale)
    bad = np.flatnonzero(need.min(axis=1) >= fresh)
    if bad.size:
        raise ValueError(
            f"energy_scale={cfg.energy_scale} leaves {bad.size}/{len(fresh)}"
            " device(s) unable to afford even their cheapest submodel on a "
            f"FULL battery (devices {bad[:5].tolist()}); raise energy_scale,"
            " or lower local_epochs/model cost.")


def build_world(cfg, *, device="cuda", global_params=None) -> World:
    """Data, Dirichlet split, fleet, model init and cost model — the JAX
    ``build_world`` with the same numpy draws.  The corpus is the
    family's (``make_dataset``: images, or token windows for the
    transformer).  The ``hotplug_n`` joiners are in the fleet from the
    start, not yet connected (dead, no energy); a non-trivial energy
    scenario draws its profile arrays for all of them first, as the
    reference (``engine.py:166-172``).  The model init draws from
    a CPU ``torch.Generator(seed)`` (so it is the same on every device);
    tests inject converted JAX weights through ``global_params``."""
    dev = resolve_device(device)
    family = get_family(cfg.model_family)
    x, y = family.make_dataset(cfg.n_train, cfg.num_classes, hw=cfg.hw,
                               noise=cfg.noise, seed=cfg.seed)
    n_val = max(64, int(cfg.n_val_fraction * cfg.n_train))
    n_total = cfg.n_devices + cfg.hotplug_n
    parts = dirichlet_partition(y[n_val:], n_total, cfg.alpha, cfg.seed)
    fleet = make_fleet_state(n_total, cfg.seed,
                             data_sizes=[len(p) for p in parts], device=dev)
    fleet = fleet.replace(remaining=fleet.battery * cfg.energy_scale)
    scenario = scenario_from_config(cfg)
    if not scenario.is_trivial:
        fleet = scenario.init_fleet(fleet, cfg.seed)
    if cfg.hotplug_n:
        fleet = fleet_disconnect(fleet, cfg.n_devices)
    if global_params is None:
        global_params = family.init(torch.Generator().manual_seed(cfg.seed),
                                    cfg.num_classes,
                                    width_mult=cfg.width_mult, hw=cfg.hw)
    global_params = tree_map(lambda t: torch.as_tensor(t).to(dev),
                             global_params)
    sizes, fractions = family.cost_model(cfg.num_classes)
    _validate_energy_feasibility(cfg, fleet, sizes, fractions)
    return World(x_tr=x[n_val:], y_tr=y[n_val:], x_val=x[:n_val],
                 y_val=y[:n_val], parts=parts, fleet=fleet,
                 global_params=global_params,
                 n_models=family.num_submodels(), sizes=sizes,
                 fractions=fractions, n_total=n_total, family=family,
                 device=dev, scenario=scenario)


def _data_to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.as_tensor(a, device=dev)
    return t if t.is_floating_point() else t.long()


def resolve_client_executor(cfg) -> str:
    """"auto" is the bucketed executor from 64 devices up and the
    per-client path below, as the JAX package on a GPU
    (``engine.py:232-241``)."""
    mode = cfg.client_executor
    if mode == "auto":
        return "perclient" if cfg.n_devices < 64 else "batched"
    if mode in ("perclient", "batched"):
        return mode
    raise ValueError(f"unknown client_executor {mode!r} "
                     "(expected 'auto', 'perclient' or 'batched')")


def sync_task_budget(cfg) -> int:
    """Client tasks a sync run of ``cfg`` dispatches at most (the sum over
    rounds of the connected fleet's Top-K k): the async engine's default
    work budget, so both modes do the same amount of training."""
    k_pre = max(1, int(round(cfg.participation * cfg.n_devices)))
    if not cfg.hotplug_n:
        return cfg.n_rounds * k_pre
    hr = min(max(int(cfg.hotplug_round), 0), cfg.n_rounds)
    k_post = max(1, int(round(
        cfg.participation * (cfg.n_devices + cfg.hotplug_n))))
    return hr * k_pre + (cfg.n_rounds - hr) * k_post


def _check_selection(sel, n_total: int) -> None:
    if len(sel.model_choice) != n_total:
        raise ValueError(f"selector returned {len(sel.model_choice)} model "
                         f"choices for a fleet of {n_total}")


def _marl_train(marl, buffer, hist, fleet, round_idx, n_updates):
    """Flush the episode trace into replay, run QMIX updates and record the
    replay telemetry under ``hist["qmix"]`` (same call order as the JAX
    engine, so the buffer RNG consumes the same draws)."""
    obs, state, actions, rewards = marl.episode_arrays(fleet, round_idx)
    buffer.add_episode(obs, state, actions, rewards)
    losses = []
    for _ in range(n_updates):
        batch = buffer.sample(marl.learner.cfg.batch_size)
        if batch:
            losses.append(marl.learner.update(batch)["td_loss"])
    q = hist.setdefault("qmix", {
        "mixer_mode": marl.mixer_mode, "replay_capacity": buffer.capacity,
        "replay_episode_len": buffer.T, "replay_agents": buffer.N,
        "replay_episodes": 0, "updates": 0, "td_loss": []})
    q["replay_episodes"] = len(buffer)
    q["updates"] = marl.learner.updates
    q["td_loss"].extend(losses)


def _fund(picks, need: np.ndarray, left: float):
    """The global budget's cumulative cap: ``picks`` in selection order,
    each funded while the budget's remainder ``left`` covers its cost
    ``need[i]`` (J, to 1e-9).  Returns (funded picks, overrun J)."""
    funded, overrun = [], 0.0
    for i in picks:
        if need[i] <= left + 1e-9:
            left -= float(need[i])
            funded.append(i)
        else:
            overrun += float(need[i])
    return funded, overrun


def _poisoned(delta, value: float):
    """A corrupt device's delta: every element ``value``."""
    return tree_map(lambda a: torch.full_like(a, value), delta)


class RoundEngine:
    """Runs one FL episode under ``cfg.engine_mode``.  ``selector`` and
    ``buffer`` are owned by the caller (``run_simulation`` keeps them
    across episodes).  ``fault_plan`` (or the ``cfg.fault_*`` counts)
    injects seeded churn into the async timeline; the sync engine refuses
    one with the reference's ``ValueError``.  ``episode`` numbers the
    checkpoints; ``resume_state`` (a decoded checkpoint) continues a run;
    ``halt_counter``, a shared ``{"remaining": N}``, raises
    :class:`CheckpointHalt` right after the N-th save."""

    def __init__(self, cfg, selector, buffer=None, verbose: bool = False, *,
                 device="cuda", global_params=None,
                 fault_plan: Optional[FaultPlan] = None, episode: int = 0,
                 resume_state: Optional[dict] = None,
                 halt_counter: Optional[dict] = None):
        check_supported(cfg)
        self.cfg = cfg
        self.selector = selector
        self.buffer = buffer
        self.verbose = verbose
        self.device = resolve_device(device)
        self.executor = resolve_client_executor(cfg)
        self.faults = (fault_plan if fault_plan is not None
                       else FaultPlan.from_config(cfg))
        if self.faults is not None and not len(self.faults):
            self.faults = None
        if self.faults is not None and cfg.engine_mode == "sync":
            raise ValueError("fault injection needs the event timeline: "
                             "set engine_mode='async'")
        self._global_params = global_params
        self._qpend: List[Any] = []   # (info, device validity) pairs
        self.episode = int(episode)
        self.ckpt = (EngineCheckpointer(cfg.checkpoint_dir,
                                        keep=cfg.checkpoint_keep)
                     if cfg.checkpoint_dir else None)
        self.ckpt_every = int(cfg.checkpoint_every)
        self._halt = halt_counter
        self._resume = resume_state

    def run(self) -> Dict:
        self.world = build_world(self.cfg, device=self.device,
                                 global_params=self._global_params)
        rs = self._resume
        if rs is not None:
            if rs.get("mode") != self.cfg.engine_mode:
                raise ValueError(
                    f"checkpoint was taken in engine_mode={rs.get('mode')!r}"
                    f" but this engine runs {self.cfg.engine_mode!r}")
            # partitions, selector and replay are mode-independent
            self.world.parts = [np.asarray(p) for p in rs["parts"]]
            self.selector.load_state_dict(rs["selector"])
            if rs.get("buffer") is not None:
                if self.buffer is None:
                    raise ValueError("checkpoint carries replay-buffer state"
                                     " but the engine has no buffer")
                self.buffer.load_state_dict(rs["buffer"])
        if self.cfg.engine_mode == "async":
            return self._run_async()
        return self._run_sync()

    # ------------------------------------------------------------------
    # checkpoint plumbing, shared by both modes (engine.py:380-456)
    # ------------------------------------------------------------------

    def _ckpt_meta(self, step: int) -> dict:
        return {"episode": self.episode, "step": int(step),
                "engine_mode": self.cfg.engine_mode,
                "fingerprint": config_fingerprint(self.cfg)}

    def _base_snapshot(self, fleet, global_params, hist) -> dict:
        """The mode-independent run state; the fleet by
        ``FLEET_CHECKPOINT_FIELDS`` (set-equal to its tensor fields)."""
        return {
            "mode": self.cfg.engine_mode,
            "fleet": {f: getattr(fleet, f) for f in FLEET_CHECKPOINT_FIELDS},
            "global_params": global_params,
            "hist": hist,
            "parts": [np.asarray(p) for p in self.world.parts],
            "selector": self.selector.state_dict(),
            "buffer": (self.buffer.state_dict()
                       if self.buffer is not None else None),
        }

    def _on_device(self, tree):
        """A restored tree's tensors (CPU after the load) on the engine's
        device."""
        dev = self.world.device
        return tree_map(lambda t: torch.as_tensor(t).to(dev), tree)

    def _restore_fleet(self, fleet, arrays: dict):
        return fleet.replace(**self._on_device(dict(arrays)))

    @staticmethod
    def _encode_task(task: dict, params_table: dict) -> dict:
        """An async task in saveable form (``engine.py:413-431``): a
        bucketed task's shared ``(BucketResult, row)`` becomes its own
        ``[1, ...]`` row slice, a per-client task's dispatch-time weights
        go to ``params_table`` once per model version (the tasks of one
        tick share one snapshot)."""
        enc = {k: v for k, v in task.items()
               if k not in ("delta_row", "params")}
        if "delta_row" in task:
            dr = task["delta_row"]
            enc["has_delta_row"] = True
            enc["delta1"] = (None if dr is None else tree_map(
                lambda a: a[dr[1]:dr[1] + 1], dr[0].stacked_delta))
        elif "params" in task:
            v = int(task["version"])
            params_table[v] = task["params"]
            enc["params_version"] = v
        return enc

    def _decode_task(self, enc: dict, params_table: dict) -> dict:
        task = {k: v for k, v in enc.items()
                if k not in ("delta1", "has_delta_row", "params_version")}
        if enc.get("has_delta_row"):
            d1 = enc["delta1"]
            task["delta_row"] = (None if d1 is None else
                                 (_RestoredBucket(self._on_device(d1)), 0))
        elif "params_version" in enc:
            task["params"] = params_table[int(enc["params_version"])]
        return task

    def _after_save(self) -> None:
        if self._halt is None:
            return
        self._halt["remaining"] -= 1
        if self._halt["remaining"] <= 0:
            raise CheckpointHalt(
                "simulated crash: halted after checkpoint save")

    def _flush_quarantine(self, hist) -> None:
        """Pull every pending validity verdict in ONE batch (at finalize)
        and record each quarantined row under ``hist["faults"]``: every
        key of its aggregation's info but ``devices``/``models``, plus
        ``device`` and ``m`` (``engine.py:458-489``)."""
        if not self._qpend:
            return
        f = hist["faults"]
        vals = to_host(*[v for _, v in self._qpend])
        for (info, _), v in zip(self._qpend, vals):
            for j, dev in enumerate(info["devices"]):
                if dev is None or bool(v[j]):
                    continue
                rec = {k: info[k] for k in info
                       if k not in ("devices", "models")}
                rec["device"] = int(dev)
                rec["m"] = int(info["models"][j])
                f["quarantined"].append(rec)
                f["n_quarantined"] += 1
        self._qpend.clear()

    def _finalize(self, hist, global_params) -> Dict:
        self._flush_quarantine(hist)
        hist["final_acc"] = hist["acc"][-1] if hist["acc"] else np.zeros(4)
        hist["best_acc"] = (np.max(np.stack(hist["acc"]), axis=0)
                            if hist["acc"] else np.zeros(4))
        hist["params"] = global_params
        return hist

    def _device_data(self):
        """The training and validation sets on the device (tokens and
        labels as int64): the executors gather their mini-batches there."""
        w = self.world
        dev = w.device
        x_dev, x_val = (_data_to_device(a, dev) for a in (w.x_tr, w.x_val))
        y_dev = torch.as_tensor(w.y_tr, dtype=torch.int64, device=dev)
        y_val = torch.as_tensor(w.y_val, dtype=torch.int64, device=dev)
        return x_dev, y_dev, x_val, y_val

    def _cohort(self, params, devices, models, seeds, x_dev, y_dev):
        """The bucketed executor's pass over ``devices`` (all with data)."""
        cfg, w = self.cfg, self.world
        return fl_batch.run_cohort(
            cfg.method, params, x_dev, y_dev, [w.parts[i] for i in devices],
            devices, models, seeds, epochs=cfg.local_epochs,
            batch=cfg.batch_size, lr=cfg.lr, family=w.family)

    def _train_one(self, params, i, m, seed, x_dev, y_dev):
        """Client ``i``'s local SGD on submodel ``m`` from ``params`` (the
        per-client executor): its delta."""
        cfg, w = self.cfg, self.world
        steps = torch.as_tensor(
            client_schedule(w.parts[i], seed, cfg.local_epochs,
                            cfg.batch_size),
            dtype=torch.int64, device=x_dev.device)
        delta, _ = w.family.train_steps(cfg.method, params, m, x_dev[steps],
                                        y_dev[steps], lr=cfg.lr)
        return delta

    def _train_and_aggregate(self, t, cohort, choice, global_params, x_dev,
                             y_dev, phase, sim_time):
        """One round's local training on the resolved executor and its
        aggregation (``engine.py:659-716``); the validity verdicts go to
        ``self._qpend``, pulled once at the end.  Returns the new global
        params."""
        cfg, w = self.cfg, self.world
        seeds = [client_update_seed(cfg.seed, t, i) for i in cohort]
        models = [int(choice[i]) for i in cohort]
        if self.executor == "batched":
            with _span(phase, "clients"):
                res = self._cohort(global_params, cohort, models, seeds,
                                   x_dev, y_dev)
            if cfg.method == "drfl":
                with _span(phase, "aggregate"):
                    global_params, valid = \
                        fl_server.aggregate_drfl_stacked(
                            global_params,
                            [(b.model_idx, b.stacked_delta, b.weights, None)
                             for b in res.buckets], server_lr=cfg.server_lr,
                            family=w.family)
                devs, models = [], []
                for b in res.buckets:
                    pad = len(b.weights) - len(b.participants)
                    devs += list(b.participants) + [None] * pad
                    models += [b.model_idx] * len(b.weights)
            else:
                contribs = res.unstacked()
                with _span(phase, "aggregate"):
                    global_params, valid = fl_server.aggregate_sliced(
                        global_params, [c[2] for c in contribs],
                        [c[3] for c in contribs])
                devs = [c[0] for c in contribs]
                models = [c[1] for c in contribs]
        else:
            with _span(phase, "clients"):
                deltas = [self._train_one(global_params, i, m, seed, x_dev,
                                          y_dev)
                          for i, m, seed in zip(cohort, models, seeds)]
            weights = [float(len(w.parts[i])) for i in cohort]
            with _span(phase, "aggregate"):
                if cfg.method == "drfl":
                    global_params, valid = fl_server.aggregate_drfl(
                        global_params, deltas, models, weights,
                        server_lr=cfg.server_lr, family=w.family)
                else:
                    global_params, valid = fl_server.aggregate_sliced(
                        global_params, deltas, weights)
            devs = list(cohort)
        self._qpend.append(({"devices": devs, "models": models, "round": t,
                             "time": sim_time}, valid))
        return global_params

    def _run_sync(self) -> Dict:
        cfg, w = self.cfg, self.world
        dev = w.device
        fleet = w.fleet
        global_params = w.global_params
        M = w.n_models
        selector, buffer = self.selector, self.buffer
        marl = selector if isinstance(selector, MarlSelector) else None
        x_dev, y_dev, x_val, y_val = self._device_data()
        rs = self._resume
        if rs is not None:
            fleet = self._restore_fleet(fleet, rs["fleet"])
            global_params = self._on_device(rs["global_params"])

        # the energy scenario's hooks (engine.py:506-518): each is gated on
        # a Python flag, so the default scenario launches and pulls nothing
        # more than the scenario-free engine
        scenario = w.scenario
        gate_avail = not scenario.trivial_availability
        recharge = not scenario.trivial_charge
        budget_active = scenario.budget_active
        limit = float(cfg.global_budget_j)
        tz_host = alive_host = None
        if gate_avail:
            # one pull at setup: the host mirrors of the phases and liveness
            # (on a resume, of the restored fleet: the reference pulls them
            # before its restore, engine.py:514-518)
            tz_a, alive_a0 = to_host(fleet.tz_phase, fleet.alive)
            tz_host = tz_a.astype(np.float64)
            alive_host = alive_a0.copy()

        w1, w2, w3 = cfg.reward_weights
        if rs is None:
            hist = {"acc": [], "acc_mean": [], "energy": [],
                    "round_time": [], "alive": [], "participants": [],
                    "model_choices": [], "reward": [], "wall_clock": [],
                    "sim_time": [], "idle": [], "phase_s": [],
                    "dropouts": 0, "idle_time": 0.0, "engine": "sync",
                    "executor": self.executor,
                    "faults": {"events": [], "quarantined": [],
                               "n_reaped": 0, "n_quarantined": 0}}
            prev_acc = float(np.mean(to_host(fl_server.evaluate(
                global_params, x_val, y_val, family=w.family))[0]))
            e_prev = fleet_total_remaining(fleet)
            sim_time = 0.0
            n_agg = 0
            hotplug_done = False
            t_start = 0
            budget_spent = 0.0
        else:
            hist = rs["hist"]
            prev_acc = float(rs["prev_acc"])
            e_prev = float(rs["e_prev"])
            sim_time = float(rs["sim_time"])
            n_agg = int(rs["n_agg"])
            hotplug_done = bool(rs["hotplug_done"])
            t_start = int(rs["next_round"])
            budget_spent = float(rs["budget_spent"])
        fleet_dead = False
        budget_exhausted = False
        if budget_active and "budget" not in hist:
            hist["budget"] = {"limit": limit, "spent": 0.0, "overrun": 0.0,
                              "trimmed": 0}

        for t in range(t_start, cfg.n_rounds):
            t0 = time.time()
            phase: Dict[str, float] = {}
            if cfg.hotplug_n and not hotplug_done and t >= cfg.hotplug_round:
                # paper Step 1 hot-plug: the joiners connect with full
                # (scaled) batteries and pull the global model
                fleet = fleet_connect(fleet, cfg.n_devices, cfg.energy_scale)
                hotplug_done = True
                if alive_host is not None:
                    alive_host[cfg.n_devices:] = True
            # Top-K follows the connected fleet
            n_connected = cfg.n_devices + (cfg.hotplug_n if hotplug_done
                                           else 0)
            k = max(1, int(round(cfg.participation * n_connected)))
            sel_fleet = fleet
            if gate_avail:
                # offline devices (diurnal wave, carbon curfew) look dead to
                # the selector this round; when the whole surviving fleet
                # is offline, the clock jumps to the next opening
                av_host = scenario.available_host(tz_host, sim_time)
                if alive_host.any() and not (av_host & alive_host).any():
                    sim_time = scenario.next_available_host(
                        tz_host[alive_host], sim_time)
                sel_fleet = fleet.replace(
                    alive=fleet.alive & scenario.available(fleet, sim_time))
            sel_kw = {}
            budget_left = overrun = 0.0
            if budget_active:
                # no pick may cost more than the budget's remainder
                budget_left = limit - budget_spent
                sel_kw["budget_left"] = budget_left
            with _span(phase, "select"):
                sel = selector.select(sel_fleet, t, k, w.sizes, w.fractions,
                                      cfg.local_epochs, cfg.batch_size,
                                      **sel_kw)
            _check_selection(sel, w.n_total)
            choice = np.asarray(sel.model_choice, np.int64)
            active = choice >= 0
            m_col = torch.as_tensor(np.clip(choice, 0, M - 1),
                                    device=dev)[:, None]
            had_picks = bool(active.any())
            budget_starved = False
            with _span(phase, "charge"):
                t_tra_m, t_com_m, e_tra_m, e_com_m = fleet_cost_matrix(
                    fleet, w.sizes, w.fractions, cfg.local_epochs,
                    cfg.batch_size)
                t_cost_d = (t_tra_m + t_com_m).gather(1, m_col)[:, 0]
                need_d = (e_tra_m + e_com_m).gather(1, m_col)[:, 0]
                if budget_active and not had_picks:
                    # nobody picked: the budget closed the round (and every
                    # later one) if some alive device could pay for its
                    # cheapest submodel from its own battery but not from
                    # the budget's remainder; one pull, this round only
                    mn, rem, al = to_host((e_tra_m + e_com_m).amin(1),
                                          fleet.remaining, fleet.alive)
                    mn = mn.astype(np.float64)
                    own_ok = al & (mn < rem.astype(np.float64))
                    if own_ok.any() and mn[own_ok].min() > budget_left:
                        budget_starved = True
                if budget_active:
                    # the cumulative cap: each pick fits the remainder
                    # alone, together they may not; trimmed in selection
                    # order, the trimmed cost paid as an overrun penalty.
                    # One pull a round: the picks' costs
                    (need_h,) = to_host(need_d)
                    need_h = need_h.astype(np.float64)
                    funded, overrun = _fund(
                        [i for i in sel.participants if active[i]], need_h,
                        budget_left)
                    active = np.zeros(w.n_total, bool)
                    active[funded] = True
                    # an attempt's cost counts as spent (a death wastes no
                    # more than it), so the cap is never overdrawn
                    budget_spent += float(need_h[active].sum())
                fleet, ok_d = fleet_charge(
                    fleet, need_d, torch.as_tensor(active, device=dev))
                # the one batched pull of the round head
                t_cost, ok = to_host(t_cost_d, ok_d)
            hist["dropouts"] += int((active & ~ok).sum())
            survivors = active & ok
            t_round = float(t_cost[survivors].max()) if survivors.any() \
                else 0.0
            idle_round = float((t_round - t_cost[survivors]).sum())
            if recharge and t_round > 0.0:
                # harvest while the round runs: the midpoint rate over
                # [sim_time, sim_time + t_round], alive devices only
                with _span(phase, "charge"):
                    fleet = scenario.apply_charge(fleet, sim_time,
                                                  sim_time + t_round)

            # contributors: survivors with local data
            cohort = [i for i in sel.participants
                      if survivors[i] and len(w.parts[i])]
            if cohort:
                global_params = self._train_and_aggregate(
                    t, cohort, choice, global_params, x_dev, y_dev, phase,
                    sim_time)
                n_agg += 1

            with _span(phase, "evaluate"):
                accs_d = fl_server.evaluate(global_params, x_val,
                                                   y_val, family=w.family)
                # the one batched pull of the round tail
                accs, e_now_a, alive_a = to_host(
                    accs_d, fleet.remaining.sum(), fleet.alive)
            acc = float(np.mean(accs))
            e_now = float(e_now_a)
            reward = (w1 * (acc - prev_acc) - w2 * (e_prev - e_now)
                      - w3 * (t_round / 60.0))
            if budget_active and overrun:
                # the joules proposed past the cap, priced as wasted ones
                reward -= w2 * overrun
            sim_time += t_round
            selector.observe_reward(reward, sim_time=sim_time)
            prev_acc, e_prev = acc, e_now

            if marl and (t + 1) % cfg.marl_train_every == 0 \
                    and marl.ep_rewards:
                with _span(phase, "marl_train"):
                    _marl_train(marl, buffer, hist, fleet, t + 1,
                                cfg.marl_updates_per_round)

            alive_now = int(alive_a.sum())
            hist["acc"].append(np.asarray(accs))
            hist["acc_mean"].append(acc)
            hist["energy"].append(e_now)
            hist["round_time"].append(t_round)
            hist["alive"].append(alive_now)
            hist["participants"].append(list(sel.participants))
            hist["model_choices"].append(
                [sel.model_choice[i] for i in sel.participants])
            hist["reward"].append(reward)
            hist["wall_clock"].append(time.time() - t0)
            hist["phase_s"].append(phase)
            hist["sim_time"].append(sim_time)
            hist["idle"].append(idle_round)
            hist["idle_time"] += idle_round
            if alive_host is not None:
                alive_host = alive_a.copy()
            if budget_active:
                hist["budget"]["spent"] = budget_spent
                hist["budget"]["overrun"] += overrun
                if overrun:
                    hist["budget"]["trimmed"] += 1
            if self.verbose:
                print(f"  round {t:3d}: acc={acc:.3f} exits="
                      f"{np.round(np.asarray(accs), 3)} alive={alive_now}"
                      f" energy={e_now:,.0f}J time={t_round:.1f}s"
                      f" r={reward:+.2f}")
            if alive_now == 0:
                fleet_dead = True
                break
            if budget_active and (limit - budget_spent <= 1e-9
                                  or budget_starved
                                  or (had_picks and not active.any())):
                # nothing left to fund, or the cap trimmed every pick:
                # stop rather than tick unfunded rounds
                budget_exhausted = True
                break
            if self.ckpt is not None and self.ckpt_every > 0 \
                    and (t + 1) % self.ckpt_every == 0:
                self._flush_quarantine(hist)
                state = self._base_snapshot(fleet, global_params, hist)
                state.update(next_round=t + 1, prev_acc=prev_acc,
                             e_prev=e_prev, sim_time=sim_time, n_agg=n_agg,
                             hotplug_done=hotplug_done,
                             budget_spent=budget_spent)
                self.ckpt.save(state, self._ckpt_meta(t + 1))
                self._after_save()

        hist["terminated"] = {
            "reason": ("budget_exhausted" if budget_exhausted
                       else "fleet_dead" if fleet_dead else "completed"),
            "rounds": len(hist["acc_mean"]), "n_rounds": cfg.n_rounds,
            "sim_time": sim_time}
        if budget_exhausted:
            hist["terminated"]["budget"] = "energy"
        hist["n_aggregations"] = n_agg
        hist["sim_time_total"] = sim_time
        return self._finalize(hist, global_params)

    # ------------------------------------------------------------------
    # async mode: an event heap over per-device virtual clocks
    # (engine.py:804-1576)
    # ------------------------------------------------------------------

    def _run_async(self) -> Dict:
        cfg, w = self.cfg, self.world
        dev = w.device
        fleet = w.fleet
        global_params = w.global_params
        selector, buffer = self.selector, self.buffer
        marl = selector if isinstance(selector, MarlSelector) else None
        decay = cfg.staleness_decay
        eval_every = max(1, int(cfg.async_eval_every))
        horizon = float(cfg.async_time_horizon)
        budget = int(cfg.async_task_budget or sync_task_budget(cfg))
        w1, w2, w3 = cfg.reward_weights
        x_dev, y_dev, x_val, y_val = self._device_data()
        batched = self.executor == "batched"
        # the energy scenario's hooks, gated on Python flags as the sync
        # engine's (engine.py:817-830)
        scenario = w.scenario
        gate_avail = not scenario.trivial_availability
        recharge = not scenario.trivial_charge
        budget_active = scenario.budget_active
        limit = float(cfg.global_budget_j)

        deadline_factor = float(cfg.task_deadline_factor)
        # deadlines (and their reap events) exist only with a fault plan:
        # a reap pop reruns refill(), which can draw from the selector's
        # RNG, so a clean run must see no reap event at all
        reaping = self.faults is not None
        task_by_dev: Dict[int, dict] = {}  # device -> its in-flight task
        phase: Dict[str, float] = {}    # host seconds of the open row
        rs = self._resume
        if rs is None:
            hist = {"acc": [], "acc_mean": [], "energy": [],
                    "round_time": [], "alive": [], "participants": [],
                    "model_choices": [], "reward": [], "wall_clock": [],
                    "sim_time": [], "idle": [], "phase_s": [],
                    "staleness": [], "task_log": [], "lost": [],
                    "dropouts": 0, "idle_time": 0.0, "wait_for_work": 0.0,
                    "hotplug": None, "engine": "async",
                    "executor": self.executor,
                    "faults": {"events": [], "quarantined": [],
                               "n_reaped": 0, "n_quarantined": 0}}
            acc_prev = float(np.mean(to_host(fl_server.evaluate(
                global_params, x_val, y_val, family=w.family))[0]))
            state = dict(now=0.0, version=0, seq=0, vround=0,
                         tasks_started=0, completions=0, inflight=0,
                         n_cohorts=0, next_commit=0, last_event=0.0,
                         hotplug_done=not cfg.hotplug_n, acc_prev=acc_prev,
                         window_t0=0.0, window_wall0=time.time(),
                         window_reward=0.0, window_idle=0.0, window_lost=0,
                         budget_spent=0.0, budget_blocked=False,
                         last_charge_t=0.0)
            heap: list = []
            cohorts: Dict[int, dict] = {}   # one per selector.select call
            last_done: Dict[int, float] = {}
            window_devices: List[int] = []
            window_models: List[int] = []
            disconnected: set = set()
            corrupt_pending: Dict[int, list] = {}  # dev -> [(payload, ev)]
            # the authoritative virtual clocks and liveness, on the host in
            # float64 (fleet.busy_until is a float32 mirror, whose
            # resolution at large sim times could mark a mid-task device
            # idle); liveness is kept from values the loop pulls anyway, so
            # the per-event idle check costs no device sync.  An
            # availability gate adds the host mirror of the phases to the
            # same pull
            pulled = to_host(fleet.busy_until, fleet.alive,
                             *([fleet.tz_phase] if gate_avail else []))
            busy64 = pulled[0].astype(np.float64)
            alive_host = pulled[1].copy()
            tz_host = pulled[2].astype(np.float64) if gate_avail else None
            if gate_avail:
                hist["wakes"] = []      # the sim times of the wake events
            if self.faults is not None:
                # injected churn rides the heap with the completions; seq
                # numbers assigned up front break fault/completion ties
                for ev in self.faults.events:
                    heapq.heappush(heap, (float(ev.time), state["seq"],
                                          "fault",
                                          {"kind": ev.kind,
                                           "device": int(ev.device),
                                           "duration": float(ev.duration),
                                           "payload": ev.payload}))
                    state["seq"] += 1
        else:
            # the resume (engine.py:875-916): the heap list was saved
            # heap-ordered and is restored as it was, its done and reap
            # entries sharing one task object per task again
            fleet = self._restore_fleet(fleet, rs["fleet"])
            global_params = self._on_device(rs["global_params"])
            hist = rs["hist"]
            state = dict(rs["state"], window_wall0=time.time())
            cohorts = {int(k): dict(v) for k, v in rs["cohorts"].items()}
            last_done = {int(k): float(v)
                         for k, v in rs["last_done"].items()}
            window_devices = [int(i) for i in rs["window_devices"]]
            window_models = [int(m) for m in rs["window_models"]]
            busy64 = rs["busy64"]
            alive_host = rs["alive_host"]
            tz_host = (to_host(fleet.tz_phase)[0].astype(np.float64)
                       if gate_avail else None)
            disconnected = {int(i) for i in rs["disconnected"]}
            corrupt_pending = {int(k): [tuple(x) for x in v]
                               for k, v in rs["corrupt_pending"].items()}
            params_table = {int(v): self._on_device(p)
                            for v, p in rs["params_table"].items()}
            tasks = {int(tid): self._decode_task(enc, params_table)
                     for tid, enc in rs["tasks"].items()}
            heap = [(float(tt), int(sq), kind,
                     tasks[int(ref)] if kind in ("done", "reap")
                     else dict(ref) if kind == "fault" else None)
                    for tt, sq, kind, ref in rs["heap"]]
            for task in tasks.values():
                if not task.get("done") and not task.get("reaped"):
                    task_by_dev[task["device"]] = task
        if budget_active and "budget" not in hist:
            hist["budget"] = {"limit": limit, "spent": 0.0, "overrun": 0.0,
                              "trimmed": 0}

        def n_connected():
            return cfg.n_devices + (cfg.hotplug_n if state["hotplug_done"]
                                    else 0)

        def top_k():
            return max(1, int(round(cfg.participation * n_connected())))

        def credit(cid, amount):
            cohorts[cid]["reward"] += amount
            state["window_reward"] += amount

        def commit_ready():
            # rewards reach the selector IN DISPATCH ORDER, so the MARL
            # trace stays (obs_t, action_t, reward_t)-aligned even when
            # later dispatches complete first
            while (state["next_commit"] < state["n_cohorts"]
                   and cohorts[state["next_commit"]]["pending"] == 0):
                c = cohorts.pop(state["next_commit"])
                selector.observe_reward(c["reward"], sim_time=state["now"])
                state["next_commit"] += 1

        def maybe_hotplug(force: bool = False):
            nonlocal fleet
            if state["hotplug_done"] or (not force and state["vround"]
                                         < cfg.hotplug_round):
                return
            now = state["now"]
            k_before = top_k()
            fleet = fleet_connect(fleet, cfg.n_devices, cfg.energy_scale,
                                  now=now)
            busy64[cfg.n_devices:] = now
            alive_host[cfg.n_devices:] = True
            state["hotplug_done"] = True
            (remaining,) = to_host(fleet.remaining)   # once per run
            hist["hotplug"] = {
                "sim_time": now, "vround": state["vround"],
                "version": state["version"], "k_before": k_before,
                "k_after": top_k(),
                "join_remaining": [float(r)
                                   for r in remaining[cfg.n_devices:]]}

        def budget_blocked_check(idle, budget_left):
            """Nothing dispatched: blocked by the budget (not by drained
            batteries) if some idle device could pay for its cheapest
            submodel from its own battery but not from the remainder.  One
            pull, only on a tick that comes back empty."""
            _, _, e_tra, e_com = fleet_cost_matrix(
                fleet, w.sizes, w.fractions, cfg.local_epochs,
                cfg.batch_size)
            min_need, rem = to_host((e_tra + e_com).amin(1), fleet.remaining)
            min_need = min_need.astype(np.float64)
            own_ok = idle & (min_need < rem.astype(np.float64))
            if own_ok.any() and min_need[own_ok].min() > budget_left:
                state["budget_blocked"] = True

        def try_dispatch(n_sel) -> int:
            nonlocal fleet, alive_host
            now = state["now"]
            if recharge and now > state["last_charge_t"]:
                # harvest the gap since the last tick BEFORE costing and
                # charging, so e_before sees the topped-up fleet
                with _span(phase, "charge"):
                    fleet = scenario.apply_charge(
                        fleet, state["last_charge_t"], now)
                state["last_charge_t"] = now
            idle = alive_host & (busy64 <= now + 1e-9)
            if gate_avail:
                # offline devices are no candidates; when all are, a wake
                # event reopens the timeline (the heap loop below)
                idle &= scenario.available_host(tz_host, now)
            if not idle.any():
                return 0
            budget_left = 0.0
            if budget_active:
                budget_left = limit - state["budget_spent"]
                if budget_left <= 1e-9:
                    state["budget_blocked"] = True
                    return 0
            cid = state["n_cohorts"]
            state["n_cohorts"] += 1
            cohorts[cid] = {"pending": 0, "reward": 0.0}
            sel_kw = {"budget_left": budget_left} if budget_active else {}
            with _span(phase, "select"):
                sel = selector.select(
                    fleet.replace(alive=torch.as_tensor(idle, device=dev)),
                    state["vround"], n_sel, w.sizes, w.fractions,
                    cfg.local_epochs, cfg.batch_size, **sel_kw)
            _check_selection(sel, w.n_total)
            choice = np.asarray(sel.model_choice, np.int64)
            active = choice >= 0
            with _span(phase, "charge"):
                if active.any():
                    m_col = torch.as_tensor(np.clip(choice, 0,
                                                    w.n_models - 1),
                                            device=dev)[:, None]
                    t_tra, t_com, e_tra, e_com = fleet_cost_matrix(
                        fleet, w.sizes, w.fractions, cfg.local_epochs,
                        cfg.batch_size)
                    need_d = (e_tra + e_com).gather(1, m_col)[:, 0]
                    t_cost_d = (t_tra + t_com).gather(1, m_col)[:, 0]
                    # the first of the tick's two batched pulls: the task
                    # times for the event heap (and, under a budget, the
                    # picks' costs in the same pull)
                    if budget_active:
                        t_cost, need_h = to_host(t_cost_d, need_d)
                        need_h = need_h.astype(np.float64)
                    else:
                        (t_cost,) = to_host(t_cost_d)
                    if horizon > 0:
                        # only work that can land inside the time budget
                        active &= (now + t_cost) <= horizon + 1e-9
                    allow = budget - state["tasks_started"]
                    kept = [i for i in sel.participants if active[i]][:allow]
                    if budget_active:
                        # the cumulative cap (the sync rule), the overrun
                        # paid by the cohort
                        funded, overrun = _fund(kept, need_h, budget_left)
                        if overrun:
                            credit(cid, -w2 * overrun)
                            hist["budget"]["overrun"] += overrun
                            hist["budget"]["trimmed"] += 1
                        if kept and not funded:
                            state["budget_blocked"] = True
                        kept = funded
                    active = np.zeros(w.n_total, bool)
                    active[kept] = True
                if not active.any():
                    if budget_active and not state["budget_blocked"]:
                        budget_blocked_check(idle, budget_left)
                    return 0
                e_before_d = fleet.remaining.sum()
                fleet, ok_d = fleet_charge(fleet, need_d,
                                           torch.as_tensor(active, device=dev))
                # the second: charge outcome and the energy reward terms
                ok, e_before_a, e_after_a = to_host(
                    ok_d, e_before_d, fleet.remaining.sum())
            e_before, e_after = float(e_before_a), float(e_after_a)
            # fleet_charge kills the attempted-but-unaffordable devices
            alive_host &= ~(active & ~ok)
            hist["dropouts"] += int((active & ~ok).sum())
            # energy term at SEND time (batteries wasted by deaths included)
            credit(cid, -w2 * (e_before - e_after))
            if budget_active:
                # an attempt's cost counts as spent: the cap is never
                # overdrawn
                state["budget_spent"] += float(need_h[active].sum())
                state["budget_blocked"] = False
                hist["budget"]["spent"] = state["budget_spent"]
            started = [i for i in sel.participants if active[i] and ok[i]]
            if not started:
                return 0
            busy64[np.asarray(started)] = now + t_cost[np.asarray(started)]
            fleet = fleet_set_busy(fleet, started,
                                   now + t_cost[np.asarray(started)])
            # micro-bucket: the tick's tasks train against the same
            # snapshot, so the bucketed executor runs them now (one program
            # per bucket) and each completion takes its row
            rows_by_dev: Dict[int, Any] = {}
            if batched:
                with_data = [i for i in started if len(w.parts[i])]
                if with_data:
                    with _span(phase, "clients"):
                        res = self._cohort(
                            global_params, with_data,
                            [int(choice[i]) for i in with_data],
                            [client_update_seed(cfg.seed, cid, i)
                             for i in with_data], x_dev, y_dev)
                    for b in res.buckets:
                        for r, d in enumerate(b.participants):
                            rows_by_dev[d] = (b, r)
            for i in started:
                if i in last_done:            # wait-for-work since last task
                    hist["wait_for_work"] += now - last_done[i]
                task = {"device": i, "m": int(choice[i]),
                        "version": state["version"], "cid": cid, "t0": now,
                        "t_cost": float(t_cost[i])}
                if batched:
                    task["delta_row"] = rows_by_dev.get(i)
                else:
                    # trains at its completion, on the weights pulled now
                    task["params"] = global_params
                task_by_dev[i] = task
                heapq.heappush(heap, (now + float(t_cost[i]), state["seq"],
                                      "done", task))
                state["seq"] += 1
                if reaping:
                    # strictly after the completion: a lost task's slot is
                    # reclaimed here, a healthy task's reap is a no-op
                    task["deadline"] = now + deadline_factor * float(
                        t_cost[i])
                    heapq.heappush(heap, (task["deadline"], state["seq"],
                                          "reap", task))
                    state["seq"] += 1
            cohorts[cid]["pending"] = len(started)
            state["tasks_started"] += len(started)
            state["inflight"] += len(started)
            return len(started)

        def refill():
            while (state["tasks_started"] < budget
                   and state["inflight"] < top_k()):
                if horizon > 0 and state["now"] >= horizon:
                    break
                n_sel = min(top_k() - state["inflight"],
                            budget - state["tasks_started"])
                if try_dispatch(n_sel) == 0:
                    break

        def emit_row():
            now = state["now"]
            with _span(phase, "evaluate"):
                accs_d = fl_server.evaluate(global_params, x_val, y_val,
                                            family=w.family)
                # the one batched pull of a virtual round
                accs, e_now_a, alive_a = to_host(
                    accs_d, fleet.remaining.sum(), fleet.alive)
            acc = float(np.mean(accs))
            # re-baseline the accuracy term, so eval_every > 1 leaks no
            # uncredited progress into later rewards
            state["window_reward"] += w1 * (acc - state["acc_prev"])
            state["acc_prev"] = acc
            e_now, alive_now = float(e_now_a), int(alive_a.sum())
            hist["acc"].append(np.asarray(accs))
            hist["acc_mean"].append(acc)
            hist["energy"].append(e_now)
            hist["round_time"].append(now - state["window_t0"])
            hist["alive"].append(alive_now)
            hist["participants"].append(list(window_devices))
            hist["model_choices"].append(list(window_models))
            hist["reward"].append(state["window_reward"])
            hist["wall_clock"].append(time.time() - state["window_wall0"])
            hist["phase_s"].append(dict(phase))
            hist["sim_time"].append(now)
            hist["idle"].append(state["window_idle"])
            hist["lost"].append(state["window_lost"])
            if self.verbose:
                print(f"  vround {state['vround']:3d}: acc={acc:.3f}"
                      f" alive={alive_now} energy={e_now:,.0f}J"
                      f" t={now:.1f}s r={state['window_reward']:+.2f}")
            window_devices.clear()
            window_models.clear()
            phase.clear()
            state.update(window_t0=now, window_wall0=time.time(),
                         window_reward=0.0, window_idle=0.0, window_lost=0)
            state["vround"] += 1

        def maybe_emit():
            # lost (reaped) tasks count toward the row's quota, so heavy
            # churn still advances the virtual rounds
            if len(window_devices) + state["window_lost"] >= top_k():
                emit_row()
                maybe_hotplug()

        def process_completion(task):
            nonlocal global_params
            now = state["now"]
            i = task["device"]
            task["done"] = True
            if task_by_dev.get(i) is task:
                del task_by_dev[i]
            state["inflight"] -= 1
            last_done[i] = now
            staleness = state["version"] - task["version"]
            cid = task["cid"]
            cohorts[cid]["pending"] -= 1
            # the time term pays the virtual time this event advanced: the
            # gaps telescope to the row's duration (sync's t_round)
            credit(cid, -w3 * ((now - state["last_event"]) / 60.0))
            state["last_event"] = now
            # straggler wait: the update is aggregated at this very event
            agg_wait = now - (task["t0"] + task["t_cost"])
            hist["idle_time"] += agg_wait
            state["window_idle"] += agg_wait
            n_i = len(w.parts[i])
            aggregated = False
            if n_i:
                poison_val = None
                if corrupt_pending.get(i):
                    # an armed "corrupt" fault poisons this delta; the
                    # aggregation's quarantine must keep it out
                    payload, ev_idx = corrupt_pending[i].pop(0)
                    poison_val = poison_payload(payload)
                    ev_rec = hist["faults"]["events"][ev_idx]
                    ev_rec["outcome"] = "poisoned"
                    ev_rec["poisoned_version"] = state["version"]
                if batched:
                    bucket, row = task["delta_row"]
                else:
                    with _span(phase, "clients"):
                        delta = self._train_one(
                            task["params"], i, task["m"],
                            client_update_seed(cfg.seed, cid, i), x_dev,
                            y_dev)
                qinfo = {"devices": [i], "models": [task["m"]],
                         "version": state["version"], "time": now}
                with _span(phase, "aggregate"):
                    if cfg.method == "drfl" and batched:
                        delta_1 = tree_map(lambda a: a[row:row + 1],
                                           bucket.stacked_delta)
                        if poison_val is not None:
                            delta_1 = _poisoned(delta_1, poison_val)
                        global_params, valid = \
                            fl_server.aggregate_drfl_stacked(
                                global_params,
                                [(task["m"], delta_1, [float(n_i)],
                                  [staleness])], server_lr=cfg.server_lr,
                                staleness_decay=decay, family=w.family)
                    elif cfg.method == "drfl":
                        if poison_val is not None:
                            delta = _poisoned(delta, poison_val)
                        global_params, valid = fl_server.aggregate_drfl(
                            global_params, [delta], [task["m"]],
                            [float(n_i)], server_lr=cfg.server_lr,
                            staleness=[staleness], staleness_decay=decay,
                            family=w.family)
                    else:
                        if batched:
                            delta = tree_map(lambda a: a[row],
                                             bucket.stacked_delta)
                        if poison_val is not None:
                            delta = _poisoned(delta, poison_val)
                        # the sliced scatter takes no staleness: the
                        # delta comes pre-scaled by its alpha
                        a = fl_server.staleness_scale(staleness, decay)
                        if a != 1.0:
                            delta = tree_map(lambda u: (u * a).to(u.dtype),
                                             delta)
                        global_params, valid = fl_server.aggregate_sliced(
                            global_params, [delta], [float(n_i)])
                self._qpend.append((qinfo, valid))
                state["version"] += 1
                aggregated = True
            hist["staleness"].append(staleness)
            hist["task_log"].append({
                "device": i, "dispatch": cid, "version": task["version"],
                "staleness": staleness, "m": task["m"],
                "t_dispatch": task["t0"], "t_done": now})
            # the per-aggregation evaluations feed event-time rewards, which
            # only the MARL selector learns from
            if marl and aggregated and state["version"] % eval_every == 0:
                with _span(phase, "evaluate"):
                    (accs,) = to_host(fl_server.evaluate(
                        global_params, x_val, y_val, family=w.family))
                acc = float(np.mean(accs))
                credit(cid, w1 * (acc - state["acc_prev"]))
                state["acc_prev"] = acc
            window_devices.append(i)
            window_models.append(task["m"])
            state["completions"] += 1
            maybe_emit()

        def process_reap(task):
            # a lost task's deadline passed: reclaim its slot and settle its
            # cohort; a healthy task's reap pops as a no-op
            nonlocal fleet
            if task.get("done") or task.get("reaped") \
                    or not task.get("lost"):
                return
            task["reaped"] = True
            now = state["now"]
            i = task["device"]
            if task_by_dev.get(i) is task:
                del task_by_dev[i]
            state["inflight"] -= 1
            cohorts[task["cid"]]["pending"] -= 1
            # the cohort pays for the virtual time its silence stalled
            credit(task["cid"], -w3 * ((now - state["last_event"]) / 60.0))
            state["last_event"] = now
            busy64[i] = min(busy64[i], now)
            fleet = fleet_set_busy(fleet, [i], float(busy64[i]))
            hist["faults"]["n_reaped"] += 1
            state["window_lost"] += 1
            hist["task_log"].append({
                "device": i, "dispatch": task["cid"],
                "version": task["version"], "staleness": None,
                "m": task["m"], "t_dispatch": task["t0"], "t_done": None,
                "lost": True, "reaped_at": now})
            maybe_emit()

        def process_fault(ev):
            nonlocal fleet
            now = state["now"]
            i = int(ev["device"])
            kind = ev["kind"]
            entry = {"time": now, "kind": kind, "device": i,
                     "injected": kind != "rejoin"}
            task = task_by_dev.get(i)
            if kind == "rejoin":
                if i in disconnected:
                    disconnected.discard(i)
                    fleet = fleet_set_alive(fleet, [i], True)
                    alive_host[i] = True
                    busy64[i] = now
                    fleet = fleet_set_busy(fleet, [i], now)
                    entry["outcome"] = "rejoined"
                else:
                    # it crashed while disconnected: it stays dead
                    entry["outcome"] = "noop"
            elif kind == "crash":
                if not alive_host[i]:
                    entry["outcome"] = "already_dead"
                else:
                    # one scalar pull per injected crash (plan-bounded)
                    (e_lost,) = to_host(fleet.remaining[i])
                    e_lost = float(e_lost)
                    fleet = fleet_kill(fleet, [i])
                    alive_host[i] = False
                    entry["e_lost"] = e_lost
                    if task is not None and not task.get("lost"):
                        # mid-task: the cohort that picked this device eats
                        # the wasted battery, so MARL learns flakiness
                        task["lost"] = True
                        credit(task["cid"], -w2 * e_lost)
                        entry["outcome"] = "crash_mid_task"
                    else:
                        entry["outcome"] = "crash_idle"
            elif kind == "timeout":
                if task is None or task.get("lost"):
                    entry["outcome"] = "no_inflight_task"
                else:
                    # a straggler: silent until its deadline reaps the task;
                    # the device keeps its battery
                    task["lost"] = True
                    busy64[i] = task["deadline"]
                    fleet = fleet_set_busy(fleet, [i], task["deadline"])
                    entry["outcome"] = "timed_out"
                    entry["reap_at"] = task["deadline"]
            elif kind == "disconnect":
                if not alive_host[i]:
                    entry["outcome"] = "already_dead"
                else:
                    alive_host[i] = False
                    fleet = fleet_set_alive(fleet, [i], False)
                    disconnected.add(i)
                    if task is not None and not task.get("lost"):
                        task["lost"] = True
                        entry["outcome"] = "disconnect_mid_task"
                    else:
                        entry["outcome"] = "disconnected"
                    t_back = now + max(float(ev.get("duration", 0.0)), 1e-6)
                    heapq.heappush(heap, (t_back, state["seq"], "fault",
                                          {"kind": "rejoin", "device": i}))
                    state["seq"] += 1
                    entry["rejoin_at"] = t_back
            elif kind == "corrupt":
                entry["payload"] = ev.get("payload") or "nan"
                entry["outcome"] = "armed"
            hist["faults"]["events"].append(entry)
            if kind == "corrupt":
                corrupt_pending.setdefault(i, []).append(
                    (entry["payload"], len(hist["faults"]["events"]) - 1))

        def save_checkpoint():
            # the quarantine verdicts first, so the saved hist is whole; a
            # heap entry names its task by number (a done and a reap entry
            # share one task)
            self._flush_quarantine(hist)
            params_table: Dict[int, Any] = {}
            tids: Dict[int, int] = {}
            tasks_enc: Dict[int, dict] = {}
            heap_enc = []
            for tt, sq, kind, payload in heap:
                if kind == "wake":
                    heap_enc.append((float(tt), int(sq), kind, None))
                elif kind == "fault":
                    heap_enc.append((float(tt), int(sq), kind,
                                     dict(payload)))
                else:
                    tid = tids.setdefault(id(payload), len(tids))
                    if tid not in tasks_enc:
                        tasks_enc[tid] = self._encode_task(payload,
                                                           params_table)
                    heap_enc.append((float(tt), int(sq), kind, tid))
            snap = self._base_snapshot(fleet, global_params, hist)
            snap.update(
                state=dict(state),
                cohorts={int(k): dict(v) for k, v in cohorts.items()},
                last_done=dict(last_done),
                window_devices=list(window_devices),
                window_models=list(window_models),
                busy64=busy64.copy(), alive_host=alive_host.copy(),
                disconnected=sorted(int(x) for x in disconnected),
                corrupt_pending={int(k): [tuple(x) for x in v]
                                 for k, v in corrupt_pending.items()},
                tasks=tasks_enc, heap=heap_enc, params_table=params_table)
            self.ckpt.save(snap, self._ckpt_meta(state["vround"]))
            self._after_save()

        last_ckpt = {"vround": state["vround"]}

        def maybe_checkpoint():
            if self.ckpt is None or self.ckpt_every <= 0:
                return
            v = state["vround"]
            if v > last_ckpt["vround"] and v % self.ckpt_every == 0:
                last_ckpt["vround"] = v
                save_checkpoint()

        # --- timeline -------------------------------------------------
        if rs is None:
            maybe_hotplug()     # hotplug_round == 0 joins before dispatch
            refill()
            commit_ready()
        while True:
            if not heap:
                if not state["hotplug_done"] \
                        and state["tasks_started"] < budget:
                    # no event can advance the virtual rounds to the join
                    # (the whole initial fleet is too drained to take a
                    # task), where sync would tick empty rounds: connect
                    # the joiners now, so both modes tell the same story
                    maybe_hotplug(force=True)
                    refill()
                    commit_ready()
                    if heap:
                        continue
                if gate_avail and state["tasks_started"] < budget \
                        and not state["budget_blocked"]:
                    # the timeline starved only because every idle device
                    # is offline: wake at the next opening and dispatch
                    now = state["now"]
                    idle_u = alive_host & (busy64 <= now + 1e-9)
                    if idle_u.any() and not (
                            scenario.available_host(tz_host, now)
                            & idle_u).any():
                        t_wake = scenario.next_available_host(
                            tz_host[idle_u], now)
                        if horizon <= 0 or t_wake < horizon - 1e-9:
                            heapq.heappush(heap, (float(t_wake),
                                                  state["seq"], "wake",
                                                  None))
                            state["seq"] += 1
                            hist["wakes"].append(float(t_wake))
                            continue
                break
            t_ev, _, kind, payload = heapq.heappop(heap)
            state["now"] = t_ev
            if kind == "done":
                # a task marked lost settles at its reap event instead
                if not payload.get("lost"):
                    process_completion(payload)
            elif kind == "reap":
                process_reap(payload)
            elif kind == "fault":
                process_fault(payload)
            # a "wake" pops as a tick: refill() below dispatches
            refill()
            commit_ready()
            maybe_checkpoint()

        if window_devices or state["window_lost"]:
            emit_row()
        # flush the cohorts whose tasks the horizon or budget cut
        for c in cohorts.values():
            c["pending"] = 0
        commit_ready()

        if marl and buffer is not None and marl.ep_rewards:
            # no mid-run barrier to train at: the learner trains at the
            # episode's end, with the update count a sync run would use
            n_updates = cfg.marl_updates_per_round * max(
                1, state["vround"] // max(1, cfg.marl_train_every))
            with _span(hist["phase_s"][-1] if hist["phase_s"] else phase,
                       "marl_train"):
                _marl_train(marl, buffer, hist, fleet, state["vround"],
                            n_updates)

        budget_kind = None
        if state["tasks_started"] >= budget:
            reason, budget_kind = "budget_exhausted", "tasks"
        elif not alive_host.any():
            # every device, in-flight work included, died
            reason = "fleet_dead"
        elif budget_active and state["budget_blocked"]:
            # the global budget can fund no dispatch any more
            reason, budget_kind = "budget_exhausted", "energy"
        elif horizon > 0:
            reason = "horizon_reached"
        else:
            reason = "starved"
        hist["terminated"] = {
            "reason": reason, "vrounds": state["vround"],
            "tasks_started": state["tasks_started"],
            "completions": state["completions"],
            "lost": hist["faults"]["n_reaped"], "sim_time": state["now"]}
        if budget_kind is not None:
            hist["terminated"]["budget"] = budget_kind
        hist["n_tasks"] = state["tasks_started"]
        hist["n_aggregations"] = state["version"]
        hist["sim_time_total"] = state["now"]
        hist["k_final"] = top_k()
        return self._finalize(hist, global_params)
