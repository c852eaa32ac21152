"""Dual selection (paper §4.3) and its baselines — port of
``repro.core.selection``: the ``MarlSelector`` with either QMIX state
(``"flat"``, the n * OBS_DIM concatenation; ``"factored"``, the
fixed-width :func:`repro_torch.core.fleet.fleet_summary`) and either mixer
(``"flat"``; ``"set"``, with episode traces cut to ``agent_budget``
agents drawn per episode), the ``greedy``, ``random`` and ``static``
selectors, and :func:`dual_selection_energy_step`, the greedy selection
and energy step as one function of device tensors.

MARL, per round: Eq. 9 observations on the device, the affordability
action mask (under a global budget, also of the actions its remainder
cannot cover; the factored state is summarised from the same mask), the
agent Q-net with ε-greedy, ONE batched pull of actions, Q values,
liveness, observations and the factored state, dead devices forced to
abstain, then Top-K over the chosen Q values with a stable argsort (ties
go to the lower device index), as ``selection.py:304-349``.  The sampled
agents come from numpy, ``default_rng((seed, 0xA6E))``, so they are the
reference's.  The baselines decide on the host after one batched pull
each, with the reference's stable sorts and numpy draw order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.fleet import (FleetState, fleet_affordability,
                                    fleet_charge, fleet_cost_matrix,
                                    fleet_summary, fleet_topk_mask,
                                    summary_width, true_div)
from repro_torch.core.marl.networks import agent_step
from repro_torch.core.marl.qmix import QmixConfig, QmixLearner, epsilon
from repro_torch.device import (set_torch_rng_state, to_host,
                                torch_rng_state)

OBS_DIM = 5
#: largest fleet for which "auto" keeps the flat QMIX state and mixer;
#: strictly above it the factored state and the set mixer take over
FACTORED_AUTO_N = 256

STATE_MODES = ("flat", "factored")
MIXER_MODES = ("flat", "set")

#: default sampled-agent budget of set-mixer replay: an episode's trace
#: stores at most this many agents, drawn uniformly without replacement
SAMPLE_AGENT_BUDGET = 4096


def resolve_state_mode(state_mode: str, n_agents: int) -> str:
    """``"auto"``: flat at or below :data:`FACTORED_AUTO_N` agents,
    factored above."""
    if state_mode == "auto":
        return "factored" if n_agents > FACTORED_AUTO_N else "flat"
    if state_mode in STATE_MODES:
        return state_mode
    raise ValueError(f"unknown state_mode {state_mode!r} "
                     "(expected 'auto', 'flat' or 'factored')")


def resolve_mixer_mode(mixer_mode: str, n_agents: int) -> str:
    """``"auto"``: the flat mixer at or below :data:`FACTORED_AUTO_N`
    agents, the set mixer above."""
    if mixer_mode == "auto":
        return "set" if n_agents > FACTORED_AUTO_N else "flat"
    if mixer_mode in MIXER_MODES:
        return mixer_mode
    raise ValueError(f"unknown mixer_mode {mixer_mode!r} "
                     "(expected 'auto', 'flat' or 'set')")


def marl_state_dim(state_mode: str, n_agents: int, n_models: int) -> int:
    """The mixer's ``state_dim``: ``n_agents * OBS_DIM`` flat,
    :func:`summary_width` factored."""
    if resolve_state_mode(state_mode, n_agents) == "factored":
        return summary_width(n_models)
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

    def state_dict(self) -> dict:
        """The selector's mutable state for a checkpoint
        (``selection.py:113-131``); restored into a fresh selector of the
        same config it continues the decisions bit for bit."""
        return {"kind": "stateless"}

    def load_state_dict(self, state: dict) -> None:
        if state.get("kind") != "stateless":
            raise ValueError(f"selector snapshot kind {state.get('kind')!r}"
                             f" does not match selector {self.name!r}")


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

    def state_dict(self) -> dict:
        return {"kind": "rng", "rng": self.rng.bit_generator.state}

    def load_state_dict(self, state: dict) -> None:
        if state.get("kind") != "rng":
            raise ValueError(f"selector snapshot kind {state.get('kind')!r}"
                             f" does not match selector {self.name!r}")
        self.rng.bit_generator.state = state["rng"]

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
    in float64, the rest in the fleet's dtype: float32, or float64 on a
    float64 fleet, as the reference's numpy backend, then rounded)."""
    t = round_idx / max(n_rounds, 1)
    return torch.stack([
        (fleet.data_size.double() / 1000.0).float(),
        true_div(fleet.compute * fleet.mode_compute, 500.0),
        fleet.remaining / fleet.battery,
        torch.full((len(fleet),), t, dtype=torch.float32,
                   device=fleet.remaining.device),
        fleet.alive.float(),
    ], dim=1).float()


def fleet_obs_batch(fleet: FleetState, round_idx,
                    n_rounds: int) -> torch.Tensor:
    """The reference's device twin of :func:`fleet_obs`
    (``selection.py:508-523``): every column in float32, data size
    included."""
    dt = fleet.remaining.dtype
    t = np.float32(round_idx) / np.float32(max(int(n_rounds), 1))
    return torch.stack([
        true_div(fleet.data_size.to(dt), 1000.0),
        true_div(fleet.compute * fleet.mode_compute, 500.0),
        fleet.remaining / fleet.battery,
        torch.full((len(fleet),), float(t), dtype=dt,
                   device=fleet.remaining.device),
        fleet.alive.to(dt),
    ], dim=1)


def dual_selection_energy_step(agent_params, hidden, fleet: FleetState,
                               model_sizes, model_fractions, k: int,
                               round_idx=0, n_rounds: int = 1,
                               local_epochs: int = 5, batch_size: int = 32,
                               budget_left=None, charge_profile=None,
                               sim_time=0.0, charge_dt: float = 0.0,
                               energy_scale: float = 1.0, avail_mask=None):
    """One greedy MARL dual selection and energy step on device tensors,
    no host pull (``selection.py:526-598``): observations, the shared
    agent's Q values, the affordability-masked argmax, Top-K over the
    chosen Qs of the willing devices, the Eq. 5/7 charge, then the
    factored summary of the charged fleet.  ``budget_left`` tightens the
    action mask, ``avail_mask`` ([n] bool) gates willingness like
    liveness, and ``charge_profile`` harvests ``charge_dt`` sim-seconds
    after the charge (midpoint rate, alive devices, capped at ``battery *
    energy_scale``).  Returns ``(new_fleet, new_hidden, participants[n]
    bool, actions[n], summary)``."""
    M = len(model_sizes)
    obs = fleet_obs_batch(fleet, round_idx, n_rounds)
    q, h = agent_step(agent_params, obs, hidden)               # [n, M+1]
    avail = fleet_affordability(fleet, model_sizes, model_fractions,
                                local_epochs, batch_size,
                                budget_left=budget_left)
    actions = torch.argmax(torch.where(avail, q, -1e9), dim=-1)
    q_chosen = q.gather(-1, actions[:, None])[:, 0]
    willing = (actions < M) & fleet.alive
    if avail_mask is not None:
        willing = willing & avail_mask
    scores = torch.where(willing, q_chosen.to(fleet.remaining.dtype),
                         -torch.inf)
    participants = fleet_topk_mask(scores, k)
    m_idx = torch.clamp(actions, 0, M - 1)
    _, _, e_tra, e_com = fleet_cost_matrix(
        fleet, model_sizes, model_fractions, local_epochs, batch_size)
    need = (e_tra + e_com).gather(-1, m_idx[:, None])[:, 0]
    fleet, ok = fleet_charge(fleet, need, participants)
    if charge_profile is not None and charge_dt > 0:
        rate = charge_profile.rate(fleet, sim_time + 0.5 * charge_dt)
        cap = fleet.battery * energy_scale
        topped = torch.minimum(fleet.remaining + rate * charge_dt,
                               torch.maximum(cap, fleet.remaining))
        fleet = fleet.replace(remaining=torch.where(fleet.alive, topped,
                                                    fleet.remaining))
    # the summary prices the charged fleet (what the next decision sees)
    summary = fleet_summary(fleet, model_sizes, model_fractions, round_idx,
                            n_rounds, local_epochs, batch_size)
    return fleet, h, participants & ok, actions, summary


class MarlSelector(SelectorBase):
    """The paper's MARL dual selection (QMIX, Fig. 3): per-agent ε-greedy
    Q picks the model action (action M = do not participate), Top-K over
    the chosen Q values picks participants.

    ``state_mode``: ``"flat"`` or ``"factored"`` (the mixer state of
    :func:`fleet_summary`); ``mixer_mode``: ``"flat"`` or ``"set"``, which
    also cuts the episode trace to ``agent_budget`` agents (``_ep_idx``,
    drawn anew each episode, fixed within one); ``"auto"`` resolves
    either.  ``select`` always acts on the whole fleet."""

    name = "marl"

    def __init__(self, n_devices: int, n_models: int, n_rounds: int,
                 seed: int = 0, state_mode: str = "flat",
                 mixer_mode: str = "flat",
                 agent_budget: int = SAMPLE_AGENT_BUDGET, *, device="cuda"):
        self.n_models = n_models
        self.n_rounds = n_rounds
        self.state_mode = resolve_state_mode(state_mode, n_devices)
        self.mixer_mode = resolve_mixer_mode(mixer_mode, n_devices)
        self.agent_budget = int(agent_budget)
        self.n_sampled = (min(n_devices, self.agent_budget)
                          if self.mixer_mode == "set" else n_devices)
        cfg = QmixConfig(
            n_agents=n_devices, obs_dim=OBS_DIM, num_actions=n_models + 1,
            state_dim=marl_state_dim(self.state_mode, n_devices, n_models),
            eps_decay_rounds=max(10, n_rounds // 2),
            mixer_mode=self.mixer_mode)
        self.learner = QmixLearner(cfg, seed, device=device)
        self.hidden = self.learner.init_hidden()
        self.total_rounds = 0   # ε decays on TOTAL experience
        # the pricing of the latest select: the terminal factored summary
        # of episode_arrays is priced the same way
        self._last_pricing = None
        self._sample_rng = np.random.default_rng((seed, 0xA6E))
        self._ep_idx: Optional[np.ndarray] = None
        self._draw_agent_sample()
        self.ep_obs: List[np.ndarray] = []
        self.ep_state: List[np.ndarray] = []
        self.ep_actions: List[np.ndarray] = []
        self.ep_rewards: List[float] = []

    def _draw_agent_sample(self):
        """The episode's sampled agents (set mixer with fewer stored than
        alive agents only): sorted, uniform without replacement."""
        n = self.learner.cfg.n_agents
        if self.mixer_mode == "set" and self.n_sampled < n:
            self._ep_idx = np.sort(self._sample_rng.choice(
                n, self.n_sampled, replace=False))
        else:
            self._ep_idx = None

    def _trace_agents(self, arr: np.ndarray) -> np.ndarray:
        """A per-agent [n, ...] row cut to the episode's sampled agents."""
        return arr if self._ep_idx is None else arr[self._ep_idx]

    def reset_episode(self):
        self.hidden = self.learner.init_hidden()
        self._draw_agent_sample()
        self.ep_obs, self.ep_state = [], []
        self.ep_actions, self.ep_rewards = [], []

    def select(self, fleet: FleetState, round_idx: int, k: int, model_sizes,
               model_fractions, local_epochs: int = 5, batch_size: int = 32,
               budget_left: Optional[float] = None) -> Selection:
        obs_d = fleet_obs(fleet, round_idx, self.n_rounds)
        self._last_pricing = (tuple(model_sizes), tuple(model_fractions),
                              local_epochs, batch_size)
        eps = epsilon(self.learner.cfg, self.total_rounds)
        self.total_rounds += 1
        # affordability action mask (paper §4.2 Step 3), priced at the
        # round the engine will charge; a global budget also masks every
        # action its remainder cannot cover
        avail = fleet_affordability(
            fleet, model_sizes, model_fractions, local_epochs, batch_size,
            budget_left=None if budget_left is None else float(budget_left))
        # the factored state reuses the mask the actions see
        extra = []
        if self.state_mode == "factored":
            extra = [fleet_summary(fleet, model_sizes, model_fractions,
                                   round_idx, self.n_rounds, local_epochs,
                                   batch_size, afford=avail)]
        actions_d, qv_d, self.hidden = self.learner.act(
            obs_d, self.hidden, eps, avail)
        actions, qv, alive, obs, *summary = to_host(
            actions_d, qv_d, fleet.alive, obs_d, *extra)
        actions = np.where(alive, actions, self.n_models)   # dead abstain
        willing = np.flatnonzero(actions < self.n_models)
        order = willing[np.argsort(-qv[willing], kind="stable")]
        chosen = [int(i) for i in order[:k]]
        model_choice = [-1] * len(fleet)
        for i in chosen:
            model_choice[i] = int(actions[i])
        # the learning trace: the whole fleet, or the episode's sampled
        # agents under the set mixer; a flat state stays the whole fleet's
        self.ep_obs.append(self._trace_agents(obs))
        self.ep_state.append(summary[0] if summary else obs.reshape(-1))
        self.ep_actions.append(self._trace_agents(actions).copy())
        return Selection(participants=chosen, model_choice=model_choice,
                         q_values=qv)

    def observe_reward(self, reward: float, sim_time=None):
        self.ep_rewards.append(float(reward))

    def episode_arrays(self, fleet: FleetState, round_idx: int):
        """(obs [T+1, N, OBS_DIM], state [T+1, state_dim], actions [T, N],
        rewards [T]) for the replay buffer, as host numpy; N is the
        episode's sampled agents under the set mixer.  The terminal
        factored state is priced as the latest select, without its
        budget mask (``selection.py:357-383``)."""
        final = [fleet_obs(fleet, round_idx, self.n_rounds)]
        if self.state_mode == "factored":
            if self._last_pricing is None:
                raise ValueError("episode_arrays() before any select(): "
                                 "no round pricing to build the terminal "
                                 "factored summary from")
            sizes, fracs, epochs, batch = self._last_pricing
            final.append(fleet_summary(fleet, sizes, fracs, round_idx,
                                       self.n_rounds, epochs, batch))
        final_obs_full, *final_state = to_host(*final)
        obs = np.stack(self.ep_obs + [self._trace_agents(final_obs_full)])
        if final_state:
            state = np.stack(self.ep_state + final_state)
        elif self._ep_idx is not None:
            # sampled trace, flat state: the state stays the whole fleet's
            # observations; only the per-agent columns were cut
            state = np.stack(self.ep_state + [final_obs_full.reshape(-1)])
        else:
            state = obs.reshape(obs.shape[0], -1)
        rewards = np.asarray(self.ep_rewards, np.float32)
        return obs, state, np.stack(self.ep_actions), rewards

    def state_dict(self) -> dict:
        """The whole mid-episode state (``selection.py:384-425``): the
        QMIX learner, the ε generator's state (in place of the JAX act
        key), the GRU hidden state, the ε schedule's position, the last
        pricing, the sampled-agent RNG and sample, and the episode trace."""
        return {
            "kind": "marl",
            "learner": self.learner.state_dict(),
            "act_gen": torch_rng_state(self.learner.act_gen),
            "hidden": self.hidden,
            "total_rounds": self.total_rounds,
            "last_pricing": self._last_pricing,
            "sample_rng": self._sample_rng.bit_generator.state,
            "ep_idx": self._ep_idx,
            "ep_obs": list(self.ep_obs),
            "ep_state": list(self.ep_state),
            "ep_actions": list(self.ep_actions),
            "ep_rewards": list(self.ep_rewards),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`.  A generator state made on another
        device type raises ``ValueError``; ``act_gen=None`` (a carried JAX
        checkpoint, whose key torch cannot use) keeps the generator as
        constructed, seeded from the learner's seed."""
        if state.get("kind") != "marl":
            raise ValueError("checkpoint selector snapshot is "
                             f"{state.get('kind')!r}, not 'marl': the "
                             "selector config drifted since the save")
        if state.get("act_gen") is not None:
            set_torch_rng_state(self.learner.act_gen, state["act_gen"])
        self.learner.load_state_dict(state["learner"])
        self.hidden = torch.as_tensor(state["hidden"]).to(
            self.learner.device)
        self.total_rounds = int(state["total_rounds"])
        lp = state["last_pricing"]
        self._last_pricing = tuple(lp) if lp is not None else None
        self._sample_rng.bit_generator.state = state["sample_rng"]
        ep_idx = state["ep_idx"]
        self._ep_idx = None if ep_idx is None else np.asarray(ep_idx)
        self.ep_obs = list(state["ep_obs"])
        self.ep_state = list(state["ep_state"])
        self.ep_actions = list(state["ep_actions"])
        self.ep_rewards = [float(r) for r in state["ep_rewards"]]
