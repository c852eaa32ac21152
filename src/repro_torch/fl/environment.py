"""Gym-style environment over the DR-FL energy simulation — port of
``repro.fl.environment``.

For MARL research: the paper's MDP (§4.3) — per-agent observations
(Eq. 9), joint actions (a submodel or abstain per device), the team
reward (Eq. 10) — without model training.  The reward's accuracy term
comes from a pluggable *accuracy proxy* (default: a diminishing-returns
curve of useful aggregated work); :func:`repro_torch.fl.run_simulation`
swaps in real training.

The fleet is a float64 :class:`repro_torch.core.fleet.FleetState` on
``device``, the precision of the reference's numpy backend
(``make_fleet_state(..., backend="numpy")``), so a step's energies and
times are the reference's to float64 rounding, on the card as on the
CPU.  The cost matrix is priced once per episode (the profiles it reads
never change within one).  A step is a fixed number of batched tensor
ops whatever the fleet's size and ends in ONE batched host pull, of the
scalars the reward and ``info`` need; observations and states stay
tensors on ``device``.

``FLEnvConfig.mode`` selects the reward clock: ``"sync"`` pays the round
barrier (the longest participant), ``"async"`` mirrors the event-driven
engine — busy devices auto-abstain by their ``busy_until`` clocks and the
time term pays only the gap to the next completion event.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.core.fleet import (FleetState, fleet_charge,
                                    fleet_cost_matrix, fleet_summary,
                                    fleet_total_remaining, make_fleet_state,
                                    true_div)
from repro_torch.core.selection import OBS_DIM, fleet_obs
from repro_torch.device import resolve_device, to_host


def default_accuracy_proxy(progress: float) -> float:
    """Diminishing-returns accuracy curve: acc in [0.1, ~0.95]."""
    return 0.1 + 0.85 * (1.0 - np.exp(-progress))


@dataclasses.dataclass
class FLEnvConfig:
    n_devices: int = 20
    n_rounds: int = 50
    k_fraction: float = 0.1            # Top-K participation
    n_models: int = 4
    model_bytes: Tuple[float, ...] = (2.8e6, 8.4e6, 22.5e6, 44.8e6)
    model_fractions: Tuple[float, ...] = (0.11, 0.3, 0.72, 1.0)
    reward_weights: Tuple[float, float, float] = (1000.0, 0.01, 1.0)
    energy_scale: float = 0.15
    local_epochs: int = 5
    seed: int = 0
    mode: str = "sync"                 # sync (barrier) | async (event-time)

    @classmethod
    def for_family(cls, family: str = "cnn", num_classes: int = 10,
                   **kwargs) -> "FLEnvConfig":
        """The config whose action space and cost model are a registered
        family's (the paper-scale Eq. 5/7 calibration ``build_world``
        charges), so a policy researched here transfers to
        ``run_simulation`` on that family."""
        from repro_torch.models.family import get_family
        fam = get_family(family)
        sizes, fractions = fam.cost_model(num_classes)
        return cls(n_models=fam.num_submodels(),
                   model_bytes=tuple(float(s) for s in sizes),
                   model_fractions=tuple(float(f) for f in fractions),
                   **kwargs)


class FLEnv:
    """step(actions) -> (obs, reward, done, info).

    actions: int array or tensor [n_devices]; a value in [0, n_models)
    trains that submodel, n_models abstains.  Top-K filtering is the
    caller's job.  ``mode="sync"`` advances the clock by the round barrier
    ``max(t_cost)``, which the reward's time term pays; ``mode="async"``
    lets devices still mid-task auto-abstain, advances the clock to the
    next completion event and pays only that gap.  ``info`` carries
    ``acc``, ``energy``, ``round_time``, ``alive``, ``dropouts``,
    ``sim_time`` and the round's ``idle_time`` (the straggler wait at the
    barrier; zero in async mode).  Observations are float32 [n, OBS_DIM]
    tensors on ``device`` (the card unless the caller asks for
    ``"cpu"``)."""

    def __init__(self, cfg: FLEnvConfig,
                 accuracy_proxy: Callable[[float], float] =
                 default_accuracy_proxy, *, device="cuda"):
        self.cfg = cfg
        self.proxy = accuracy_proxy
        self.obs_dim = OBS_DIM
        self.device = resolve_device(device)
        self.reset()

    def reset(self) -> torch.Tensor:
        cfg = self.cfg
        fleet = make_fleet_state(cfg.n_devices, cfg.seed, device=self.device,
                                 dtype=torch.float64)
        self.fleet: FleetState = fleet.replace(
            remaining=fleet.battery * cfg.energy_scale)
        t_tra, t_com, e_tra, e_com = fleet_cost_matrix(
            self.fleet, cfg.model_bytes, cfg.model_fractions,
            cfg.local_epochs)
        self._need, self._t_cost = e_tra + e_com, t_tra + t_com
        # useful work per device and submodel: data size x depth fraction
        self._work = (true_div(self.fleet.data_size.double(), 1000.0)[:, None]
                      * torch.as_tensor(cfg.model_fractions,
                                        dtype=torch.float64,
                                        device=self.device)[None, :])
        self.t = 0
        self.sim_time = 0.0
        self.progress = 0.0
        self.acc = self.proxy(0.0)
        self.e_prev = fleet_total_remaining(self.fleet)
        return self._obs()

    def _obs(self) -> torch.Tensor:
        return fleet_obs(self.fleet, self.t, self.cfg.n_rounds)

    @property
    def state(self) -> torch.Tensor:
        return self._obs().reshape(-1)

    @property
    def state_factored(self) -> torch.Tensor:
        """The fixed-width factored global state (``fleet_summary`` priced
        with the env's cost model): what ``MarlSelector(state_mode=
        "factored")`` sees, whatever the fleet's size."""
        cfg = self.cfg
        return fleet_summary(self.fleet, cfg.model_bytes, cfg.model_fractions,
                             self.t, cfg.n_rounds, cfg.local_epochs)

    def step(self, actions):
        cfg = self.cfg
        fleet = self.fleet
        a = torch.as_tensor(actions, device=self.device).long()
        active = (a < cfg.n_models) & fleet.alive
        if cfg.mode == "async":
            # event semantics: devices still mid-task cannot be dispatched
            active &= fleet.busy_until <= self.sim_time + 1e-9
        m_idx = a.clamp(0, cfg.n_models - 1)[:, None]
        fleet, ok = fleet_charge(fleet, self._need.gather(1, m_idx)[:, 0],
                                 active)
        t_cost = self._t_cost.gather(1, m_idx)[:, 0]
        zero = torch.zeros_like(t_cost)
        t_round = torch.where(ok, t_cost, zero).max()
        if cfg.mode == "async":
            # dispatched tasks run on per-device virtual clocks; the server
            # wakes at the NEXT completion event instead of the barrier
            done_at = torch.where(ok, self.sim_time + t_cost,
                                  fleet.busy_until)
            fleet = fleet.replace(busy_until=done_at)
            clock = torch.where(done_at > self.sim_time + 1e-9, done_at,
                                torch.full_like(done_at, np.inf)).min()
        else:
            clock = torch.where(ok, t_round - t_cost, zero).sum()
        useful = torch.where(ok, self._work.gather(1, m_idx)[:, 0],
                             zero).sum()
        self.fleet = fleet
        (host,) = to_host(torch.stack([
            (active & ~ok).sum().double(), t_round, clock, useful,
            fleet.remaining.sum(), fleet.alive.sum().double()]))
        dropouts, t_round, clock, useful, e_now, alive = host.tolist()
        if cfg.mode == "async":
            t_step = clock - self.sim_time if np.isfinite(clock) else 0.0
            idle_time = 0.0                # no barrier: no straggler wait
        else:
            t_step, idle_time = t_round, clock
        self.progress += 0.25 * useful
        new_acc = self.proxy(self.progress)
        w1, w2, w3 = cfg.reward_weights
        # event-time reward: the time term pays the elapsed virtual time of
        # THIS event (the barrier in sync mode, the event gap in async)
        reward = (w1 * (new_acc - self.acc) - w2 * (self.e_prev - e_now)
                  - w3 * (t_step / 60.0))
        self.acc, self.e_prev = new_acc, e_now
        self.t += 1
        self.sim_time += t_step
        done = self.t >= cfg.n_rounds or alive == 0
        info = {"acc": self.acc, "energy": e_now, "round_time": t_round,
                "alive": int(alive), "dropouts": int(dropouts),
                "sim_time": self.sim_time, "idle_time": idle_time}
        return self._obs(), float(reward), done, info
