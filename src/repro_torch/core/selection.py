"""Dual selection (paper §4.3) and its baselines — port of
``repro.core.selection``: the flat-state, flat-mixer ``MarlSelector`` and
the ``greedy``, ``random`` and ``static`` selectors.

MARL, per round: Eq. 9 observations on the device, the affordability
action mask (under a global budget, also of the actions its remainder
cannot cover), the agent Q-net with ε-greedy, ONE batched pull of actions,
Q values, liveness and observations, dead devices forced to abstain, then
Top-K over the chosen Q values with a stable argsort (ties go to the lower
device index), as ``selection.py:304-349``.  The baselines decide on the
host after one batched pull each, with the reference's stable sorts and
numpy draw order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.fleet import (FleetState, fleet_affordability,
                                    fleet_cost_matrix)
from repro_torch.core.marl.qmix import QmixConfig, QmixLearner, epsilon
from repro_torch.device import to_host

OBS_DIM = 5
#: largest fleet for which "auto" keeps the flat QMIX state and mixer
FACTORED_AUTO_N = 256


def _not_ported_scale(what: str, mode: str):
    return NotImplementedError(
        f"{what}={mode!r} is not ported; only 'flat' (fleets of at most "
        f"{FACTORED_AUTO_N} devices) is (ROADMAP Queue 1, "
        "'MARL at fleet scale')")


def resolve_state_mode(state_mode: str, n_agents: int) -> str:
    if state_mode == "auto":
        state_mode = "factored" if n_agents > FACTORED_AUTO_N else "flat"
    if state_mode == "factored":
        raise _not_ported_scale("state_mode", state_mode)
    if state_mode != "flat":
        raise ValueError(f"unknown state_mode {state_mode!r} "
                         "(expected 'auto', 'flat' or 'factored')")
    return state_mode


def resolve_mixer_mode(mixer_mode: str, n_agents: int) -> str:
    if mixer_mode == "auto":
        mixer_mode = "set" if n_agents > FACTORED_AUTO_N else "flat"
    if mixer_mode == "set":
        raise _not_ported_scale("mixer_mode", mixer_mode)
    if mixer_mode != "flat":
        raise ValueError(f"unknown mixer_mode {mixer_mode!r} "
                         "(expected 'auto', 'flat' or 'set')")
    return mixer_mode


def marl_state_dim(state_mode: str, n_agents: int, n_models: int) -> int:
    resolve_state_mode(state_mode, n_agents)
    return n_agents * OBS_DIM


@dataclasses.dataclass
class Selection:
    participants: List[int]          # device indices
    model_choice: List[int]          # per-device submodel index (-1 = none)
    q_values: Optional[np.ndarray] = None

    def __post_init__(self):
        n = len(self.model_choice)
        bad = [int(i) for i in self.participants if not 0 <= int(i) < n]
        if bad:
            raise ValueError(
                f"Selection.participants {bad} out of range for "
                f"model_choice of length {n}")


class SelectorBase:
    name = "base"

    def select(self, fleet: FleetState, round_idx: int, k: int,
               model_sizes: Sequence[float],
               model_fractions: Sequence[float], local_epochs: int = 5,
               batch_size: int = 32,
               budget_left: Optional[float] = None) -> Selection:
        """``budget_left`` (J): the remaining fleet-wide budget; no pick may
        cost more than it.  ``None``: no budget."""
        raise NotImplementedError

    def observe_reward(self, reward: float,
                       sim_time: Optional[float] = None):
        """Credit the reward of the latest ``select`` (baselines: no-op)."""


class GreedySelector(SelectorBase):
    """Energy-aware greedy (the paper's baseline): every device picks the
    LARGEST submodel it can afford this round; Top-K by remaining energy."""

    name = "greedy"

    def select(self, fleet, round_idx, k, model_sizes, model_fractions,
               local_epochs=5, batch_size=32, budget_left=None):
        M = len(model_sizes)
        _, _, e_tra, e_com = fleet_cost_matrix(
            fleet, model_sizes, model_fractions, local_epochs, batch_size)
        # one batched pull: costs, energy and liveness for the host sort
        e_need, remaining, alive = to_host(e_tra + e_com, fleet.remaining,
                                           fleet.alive)
        afford = (e_need < remaining[:, None]) & alive[:, None]   # [n, M]
        if budget_left is not None:
            afford &= e_need <= float(budget_left)
        best = np.where(afford.any(axis=1),
                        M - 1 - np.argmax(afford[:, ::-1], axis=1), -1)
        cand = np.flatnonzero(best >= 0)
        order = cand[np.argsort(-remaining[cand], kind="stable")]
        chosen = [int(i) for i in order[:k]]
        model_choice = [-1] * len(fleet)
        for i in chosen:
            model_choice[i] = int(best[i])
        return Selection(participants=chosen, model_choice=model_choice)


def _budget_filter(fleet, chosen, model_choice, model_sizes,
                   model_fractions, local_epochs, batch_size, budget_left):
    """Drop picks whose cost alone exceeds the remaining fleet-wide budget
    (for the selectors that pick models without pricing them); the RNG
    draws are untouched, so runs without a budget are unaffected."""
    _, _, e_tra, e_com = fleet_cost_matrix(
        fleet, model_sizes, model_fractions, local_epochs, batch_size)
    (e_need,) = to_host(e_tra + e_com)
    kept = [i for i in chosen
            if e_need[i, model_choice[i]] <= float(budget_left)]
    out_choice = [-1] * len(model_choice)
    for i in kept:
        out_choice[i] = model_choice[i]
    return kept, out_choice


class _RandomCohort(SelectorBase):
    """K alive devices in a uniformly shuffled order, each given the model
    of :meth:`_model` (numpy draws in the reference's order)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def _model(self, fleet, i: int, n_models: int) -> int:
        raise NotImplementedError

    def select(self, fleet, round_idx, k, model_sizes, model_fractions,
               local_epochs=5, batch_size=32, budget_left=None):
        (alive_h,) = to_host(fleet.alive)
        alive = [int(i) for i in np.flatnonzero(alive_h)]
        self.rng.shuffle(alive)
        chosen = alive[:k]
        model_choice = [-1] * len(fleet)
        for i in chosen:
            model_choice[i] = self._model(fleet, i, len(model_sizes))
        if budget_left is not None:
            chosen, model_choice = _budget_filter(
                fleet, chosen, model_choice, model_sizes, model_fractions,
                local_epochs, batch_size, budget_left)
        return Selection(participants=chosen, model_choice=model_choice)


class RandomSelector(_RandomCohort):
    """Vanilla-FL style: K random alive clients, each a random model."""

    name = "random"

    def _model(self, fleet, i, n_models):
        return int(self.rng.integers(0, n_models))


class StaticTierSelector(_RandomCohort):
    """HeteroFL-style static assignment: the submodel is fixed by the
    device's tier."""

    name = "static"
    TIER_MODEL = {"small": 0, "medium": 1, "large": 3}

    def _model(self, fleet, i, n_models):
        return min(self.TIER_MODEL[fleet.tiers[i]], n_models - 1)


def fleet_obs(fleet: FleetState, round_idx: int,
              n_rounds: int) -> torch.Tensor:
    """[n, OBS_DIM] float32 on the fleet's device: Eq. 9's [L_n, C_n, E_n,
    t] plus liveness, with the reference's precisions (data size divided
    in float64, the rest in float32)."""
    t = round_idx / max(n_rounds, 1)
    return torch.stack([
        (fleet.data_size.double() / 1000.0).float(),
        fleet.compute * fleet.mode_compute / 500.0,
        fleet.remaining / fleet.battery,
        torch.full((len(fleet),), t, dtype=torch.float32,
                   device=fleet.remaining.device),
        fleet.alive.float(),
    ], dim=1)


class MarlSelector(SelectorBase):
    """The paper's MARL dual selection (QMIX, Fig. 3), flat state and
    mixer: per-agent ε-greedy Q picks the model action (action M = do not
    participate), Top-K over the chosen Q values picks participants."""

    name = "marl"

    def __init__(self, n_devices: int, n_models: int, n_rounds: int,
                 seed: int = 0, state_mode: str = "flat",
                 mixer_mode: str = "flat", *, device="cuda"):
        self.n_models = n_models
        self.n_rounds = n_rounds
        self.state_mode = resolve_state_mode(state_mode, n_devices)
        self.mixer_mode = resolve_mixer_mode(mixer_mode, n_devices)
        cfg = QmixConfig(
            n_agents=n_devices, obs_dim=OBS_DIM, num_actions=n_models + 1,
            state_dim=marl_state_dim(self.state_mode, n_devices, n_models),
            eps_decay_rounds=max(10, n_rounds // 2),
            mixer_mode=self.mixer_mode)
        self.learner = QmixLearner(cfg, seed, device=device)
        self.hidden = self.learner.init_hidden()
        self.total_rounds = 0   # ε decays on TOTAL experience
        self.ep_obs: List[np.ndarray] = []
        self.ep_state: List[np.ndarray] = []
        self.ep_actions: List[np.ndarray] = []
        self.ep_rewards: List[float] = []

    def reset_episode(self):
        self.hidden = self.learner.init_hidden()
        self.ep_obs, self.ep_state = [], []
        self.ep_actions, self.ep_rewards = [], []

    def select(self, fleet: FleetState, round_idx: int, k: int, model_sizes,
               model_fractions, local_epochs: int = 5, batch_size: int = 32,
               budget_left: Optional[float] = None) -> Selection:
        obs_d = fleet_obs(fleet, round_idx, self.n_rounds)
        eps = epsilon(self.learner.cfg, self.total_rounds)
        self.total_rounds += 1
        # affordability action mask (paper §4.2 Step 3), priced at the
        # round the engine will charge; a global budget also masks every
        # action its remainder cannot cover
        avail = fleet_affordability(
            fleet, model_sizes, model_fractions, local_epochs, batch_size,
            budget_left=None if budget_left is None else float(budget_left))
        actions_d, qv_d, self.hidden = self.learner.act(
            obs_d, self.hidden, eps, avail)
        actions, qv, alive, obs = to_host(actions_d, qv_d, fleet.alive,
                                          obs_d)
        actions = np.where(alive, actions, self.n_models)   # dead abstain
        willing = np.flatnonzero(actions < self.n_models)
        order = willing[np.argsort(-qv[willing], kind="stable")]
        chosen = [int(i) for i in order[:k]]
        model_choice = [-1] * len(fleet)
        for i in chosen:
            model_choice[i] = int(actions[i])
        self.ep_obs.append(obs)
        self.ep_state.append(obs.reshape(-1))
        self.ep_actions.append(actions.copy())
        return Selection(participants=chosen, model_choice=model_choice,
                         q_values=qv)

    def observe_reward(self, reward: float, sim_time=None):
        self.ep_rewards.append(float(reward))

    def episode_arrays(self, fleet: FleetState, round_idx: int):
        """(obs [T+1, n, OBS_DIM], state [T+1, n*OBS_DIM], actions [T, n],
        rewards [T]) for the replay buffer, as host numpy."""
        (final_obs,) = to_host(fleet_obs(fleet, round_idx, self.n_rounds))
        obs = np.stack(self.ep_obs + [final_obs])
        state = obs.reshape(obs.shape[0], -1)
        rewards = np.asarray(self.ep_rewards, np.float32)
        return obs, state, np.stack(self.ep_actions), rewards
