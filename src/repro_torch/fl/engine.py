"""Sync FL round engine — port of ``repro.fl.engine`` (``build_world``,
``resolve_client_executor``, ``_marl_train`` and ``RoundEngine._run_sync``,
``engine.py:492-798``, without the scenario, budget, hot-plug and
checkpoint hooks, which are not ported).

Per round: selection, Eq. 5/7 costs and the energy charge on the device,
ONE batched host pull at the round head (charge outcome and round times),
the clients' local training, aggregation, evaluation, and ONE batched pull
at the round tail (per-exit accuracy, fleet energy, liveness).  The client
executor is the reference's choice (:func:`resolve_client_executor`):

* ``"batched"``: one program per submodel bucket (:mod:`fl.batch`); DR-FL
  aggregates the stacked deltas through the ``layer_agg`` kernel, the
  baselines take them apart for the sliced scatter average;
* ``"perclient"``: each client's SGD loop in turn, its batches gathered
  on the device from the resident training set through its
  ``client_schedule`` (one index copy per client, no host sync per
  step); DR-FL aggregates with ``aggregate_drfl`` (``layerwise_aggregate``
  per leaf, as the reference), the baselines with ``aggregate_sliced``.

Each phase of a round (select, charge, clients, aggregate, evaluate,
marl_train) is a ``torch.profiler.record_function`` span named
``round.<phase>`` and has its host seconds recorded in
``hist["phase_s"]`` (one dict per round).  ``select``, ``charge``,
``evaluate`` and ``marl_train`` end in a host pull, and so do the
batched executor's ``clients`` (one losses pull per bucket), so their
host time covers their device work.  ``aggregate`` and the per-client
executor's ``clients`` pull nothing: their host seconds are enqueue time,
and their device work is waited for inside ``evaluate``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.fleet import (FleetState, fleet_charge,
                                    fleet_cost_matrix, fleet_total_remaining,
                                    make_fleet_state)
from repro_torch.core.selection import (MarlSelector, resolve_mixer_mode,
                                        resolve_state_mode)
from repro_torch.data.loader import client_schedule
from repro_torch.data.partition import dirichlet_partition
from repro_torch.device import resolve_device, to_host
from repro_torch.fl import batch as fl_batch
from repro_torch.fl import server as fl_server
from repro_torch.fl.client import client_update_seed
from repro_torch.models.family import LayerwiseFamily, get_family
from repro_torch.tree import tree_map


@contextlib.contextmanager
def _span(phase: Dict[str, float], name: str):
    """A profiler span ``round.<name>`` plus its host seconds in
    ``phase[name]`` (two clock reads: nothing measurable per round)."""
    t0 = time.perf_counter()
    with record_function(f"round.{name}"):
        yield
    phase[name] = phase.get(name, 0.0) + time.perf_counter() - t0


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1, "
        f"'{item}')")


#: the selectors ``FLConfig.selector`` names (``simulation._make_selector``)
SELECTORS = ("marl", "greedy", "random", "static")


def uses_marl(cfg) -> bool:
    """The MARL selector runs only for DR-FL: the baselines always take
    the greedy selector, as the reference's fair-comparison arm."""
    return cfg.method == "drfl" and cfg.selector == "marl"


def check_supported(cfg) -> None:
    """Refuse, up front, every configuration outside this port's slices:
    the sync engine; DR-FL, HeteroFL and ScaleFL with any of the four
    selectors; the ``cnn`` and ``transformer`` families (a family that
    lacks the method raises the reference's ``ValueError``); either client
    executor; the flat QMIX state/mixer and the trivial energy
    scenario."""
    checks = [
        (cfg.engine_mode != "sync", f"engine_mode={cfg.engine_mode!r}",
         "async engine"),
        (cfg.model_family not in ("cnn", "transformer"),
         f"model_family={cfg.model_family!r}", "other families"),
        (cfg.hotplug_n > 0, "hotplug_n > 0", "hot-plug"),
        (cfg.charge_profile != "constant" or cfg.charge_rate != 0.0
         or cfg.availability_profile != "always"
         or cfg.availability_duty != 1.0,
         "a non-trivial energy scenario", "energy scenarios"),
        (cfg.global_budget_j != 0.0, "global_budget_j", "energy scenarios"),
        (bool(cfg.checkpoint_dir) or cfg.checkpoint_every or cfg.resume,
         "checkpointing", "checkpoints and faults"),
        (cfg.fault_crashes or cfg.fault_timeouts or cfg.fault_disconnects
         or cfg.fault_corrupts, "fault injection", "checkpoints and faults"),
        (cfg.fleet_mesh not in (0, 1), "fleet_mesh", "fleet sharding"),
    ]
    for bad, what, item in checks:
        if bad:
            raise not_ported(what, item)
    family = get_family(cfg.model_family)
    if not family.supports(cfg.method):
        raise family.unsupported(cfg.method)
    if cfg.selector not in SELECTORS:
        raise ValueError(f"unknown selector {cfg.selector!r} (expected one "
                         f"of {SELECTORS})")
    resolve_client_executor(cfg)
    if uses_marl(cfg):
        n_agents = cfg.n_devices + cfg.hotplug_n
        resolve_state_mode(cfg.state_mode, n_agents)  # raise above 256
        resolve_mixer_mode(cfg.mixer_mode, n_agents)


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
    family: LayerwiseFamily
    device: torch.device


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
    transformer).  The model init draws from a CPU
    ``torch.Generator(seed)`` (so it is the same on every device); tests
    inject converted JAX weights through ``global_params``."""
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
                 device=dev)


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


class RoundEngine:
    """Runs one sync FL episode.  ``selector`` and ``buffer`` are owned by
    the caller (``run_simulation`` keeps them across episodes)."""

    def __init__(self, cfg, selector, buffer=None, verbose: bool = False, *,
                 device="cuda", global_params=None):
        check_supported(cfg)
        self.cfg = cfg
        self.selector = selector
        self.buffer = buffer
        self.verbose = verbose
        self.device = resolve_device(device)
        self.executor = resolve_client_executor(cfg)
        self._global_params = global_params
        self._qpend: List[Any] = []   # (info, device validity) pairs

    def run(self) -> Dict:
        self.world = build_world(self.cfg, device=self.device,
                                 global_params=self._global_params)
        return self._run_sync()

    def _flush_quarantine(self, hist) -> None:
        """Pull every pending validity verdict in ONE batch (at finalize)
        and record the quarantined rows under ``hist["faults"]``."""
        if not self._qpend:
            return
        f = hist["faults"]
        vals = to_host(*[v for _, v in self._qpend])
        for (info, _), v in zip(self._qpend, vals):
            for j, dev in enumerate(info["devices"]):
                if dev is None or bool(v[j]):
                    continue
                f["quarantined"].append({"round": info["round"],
                                         "time": info["time"],
                                         "device": int(dev),
                                         "m": int(info["models"][j])})
                f["n_quarantined"] += 1
        self._qpend.clear()

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
                res = fl_batch.run_cohort(
                    cfg.method, global_params, x_dev, y_dev,
                    [w.parts[i] for i in cohort], cohort, models, seeds,
                    epochs=cfg.local_epochs, batch=cfg.batch_size,
                    lr=cfg.lr, family=w.family)
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
            deltas, weights = [], []
            with _span(phase, "clients"):
                for i, m, seed in zip(cohort, models, seeds):
                    steps = torch.as_tensor(
                        client_schedule(w.parts[i], seed, cfg.local_epochs,
                                        cfg.batch_size),
                        dtype=torch.int64, device=x_dev.device)
                    delta, _ = w.family.train_steps(
                        cfg.method, global_params, m, x_dev[steps],
                        y_dev[steps], lr=cfg.lr)
                    deltas.append(delta)
                    weights.append(float(len(w.parts[i])))
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
        # the training and validation sets stay on the device: the
        # executor gathers its mini-batches there (tokens as int64)
        x_dev, x_val = (_data_to_device(a, dev) for a in (w.x_tr, w.x_val))
        y_dev = torch.as_tensor(w.y_tr, dtype=torch.int64, device=dev)
        y_val = torch.as_tensor(w.y_val, dtype=torch.int64, device=dev)

        w1, w2, w3 = cfg.reward_weights
        hist = {"acc": [], "acc_mean": [], "energy": [], "round_time": [],
                "alive": [], "participants": [], "model_choices": [],
                "reward": [], "wall_clock": [], "sim_time": [], "idle": [],
                "phase_s": [], "dropouts": 0, "idle_time": 0.0, "engine": "sync",
                "executor": self.executor,
                "faults": {"events": [], "quarantined": [],
                           "n_reaped": 0, "n_quarantined": 0}}
        prev_acc = float(np.mean(to_host(fl_server.evaluate(
            global_params, x_val, y_val, family=w.family))[0]))
        e_prev = fleet_total_remaining(fleet)
        sim_time = 0.0
        n_agg = 0
        fleet_dead = False
        k = max(1, int(round(cfg.participation * cfg.n_devices)))

        for t in range(cfg.n_rounds):
            t0 = time.time()
            phase: Dict[str, float] = {}
            with _span(phase, "select"):
                sel = selector.select(fleet, t, k, w.sizes, w.fractions,
                                      cfg.local_epochs, cfg.batch_size)
            if len(sel.model_choice) != w.n_total:
                raise ValueError(
                    f"selector returned {len(sel.model_choice)} model "
                    f"choices for a fleet of {w.n_total}")
            choice = np.asarray(sel.model_choice, np.int64)
            active = choice >= 0
            m_col = torch.as_tensor(np.clip(choice, 0, M - 1),
                                    device=dev)[:, None]
            with _span(phase, "charge"):
                t_tra_m, t_com_m, e_tra_m, e_com_m = fleet_cost_matrix(
                    fleet, w.sizes, w.fractions, cfg.local_epochs,
                    cfg.batch_size)
                t_cost_d = (t_tra_m + t_com_m).gather(1, m_col)[:, 0]
                need_d = (e_tra_m + e_com_m).gather(1, m_col)[:, 0]
                fleet, ok_d = fleet_charge(
                    fleet, need_d, torch.as_tensor(active, device=dev))
                # the one batched pull of the round head
                t_cost, ok = to_host(t_cost_d, ok_d)
            hist["dropouts"] += int((active & ~ok).sum())
            survivors = active & ok
            t_round = float(t_cost[survivors].max()) if survivors.any() \
                else 0.0
            idle_round = float((t_round - t_cost[survivors]).sum())

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
            if self.verbose:
                print(f"  round {t:3d}: acc={acc:.3f} exits="
                      f"{np.round(np.asarray(accs), 3)} alive={alive_now}"
                      f" energy={e_now:,.0f}J time={t_round:.1f}s"
                      f" r={reward:+.2f}")
            if alive_now == 0:
                fleet_dead = True
                break

        hist["terminated"] = {
            "reason": "fleet_dead" if fleet_dead else "completed",
            "rounds": len(hist["acc_mean"]), "n_rounds": cfg.n_rounds,
            "sim_time": sim_time}
        hist["n_aggregations"] = n_agg
        hist["sim_time_total"] = sim_time
        self._flush_quarantine(hist)
        hist["final_acc"] = hist["acc"][-1] if hist["acc"] else np.zeros(4)
        hist["best_acc"] = (np.max(np.stack(hist["acc"]), axis=0)
                            if hist["acc"] else np.zeros(4))
        hist["params"] = global_params
        return hist
