"""Episode replay buffer for QMIX (host-side numpy ring buffer).

Stores whole episodes (one FL run = one episode) so the GRU hidden state can
be unrolled from t=0 during learning.  Episodes are fixed-length ``T`` with
a validity mask (FL runs end early when the fleet dies).

Sampled-agent replay (``agent_budget=``): at fleet scale the per-agent
observation block ``[T+1, n, obs_dim]`` is the only O(n) axis left in QMIX
training, so the buffer can cap its stored agent width at a fixed budget.
Episodes wider than the budget are column-subsampled uniformly without
replacement (one draw per episode, so the GRU unroll sees a consistent
agent set across its timesteps) and the batch carries per-agent log
importance weights (``agent_logw``; zero under uniform sampling — softmax
attention pooling is self-normalising, so equal weights cancel exactly,
and a future non-uniform sampler stays unbiased through the same slot).
Replay memory then stops scaling with fleet size.

Copied from ``repro.core.marl.buffer``: host numpy, so replay sampling
draws exactly the indices the JAX package draws from the same seed.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, episode_len: int, n_agents: int,
                 obs_dim: int, state_dim: int, seed: int = 0,
                 agent_budget: Optional[int] = None):
        self.capacity = capacity
        self.T = episode_len
        self.n_full = n_agents
        self.agent_budget = agent_budget
        n_store = min(n_agents, agent_budget) if agent_budget else n_agents
        self.N = n_store
        self.size = 0
        self.ptr = 0
        self.rng = np.random.default_rng(seed)
        self.obs = np.zeros((capacity, episode_len + 1, n_store, obs_dim), np.float32)
        self.state = np.zeros((capacity, episode_len + 1, state_dim), np.float32)
        self.actions = np.zeros((capacity, episode_len, n_store), np.int64)
        self.rewards = np.zeros((capacity, episode_len), np.float32)
        self.mask = np.zeros((capacity, episode_len), np.float32)
        if agent_budget is not None:
            self.agent_idx = np.zeros((capacity, n_store), np.int64)
            self.agent_logw = np.zeros((capacity, n_store), np.float32)
        else:
            self.agent_idx = None
            self.agent_logw = None

    def add_episode(self, obs, state, actions, rewards, agent_idx=None,
                    agent_logw=None):
        """obs: [t+1, N, obs_dim]; state: [t+1, state_dim];
        actions: [t, N]; rewards: [t] — t <= T.

        ``N`` may exceed the stored agent width (a full-fleet episode fed
        to a budgeted buffer): the columns are then subsampled here.
        Callers that pre-sample (``MarlSelector`` in set-mixer mode) pass
        already-narrow episodes plus their ``agent_idx``/``agent_logw``.
        """
        obs = np.asarray(obs)
        actions = np.asarray(actions)
        if obs.shape[1] > self.N:
            # uniform without replacement: equal self-normalised importance
            # weights, so the stored log-weights stay zero
            agent_idx = np.sort(self.rng.choice(obs.shape[1], self.N,
                                                replace=False))
            obs = obs[:, agent_idx]
            actions = actions[:, agent_idx]
            agent_logw = None
        t = len(rewards)
        i = self.ptr
        self.obs[i, :t + 1] = obs
        self.obs[i, t + 1:] = obs[-1]
        self.state[i, :t + 1] = state
        self.state[i, t + 1:] = state[-1]
        self.actions[i, :t] = actions
        self.actions[i, t:] = 0
        self.rewards[i, :t] = rewards
        self.rewards[i, t:] = 0.0
        self.mask[i, :t] = 1.0
        self.mask[i, t:] = 0.0
        if self.agent_idx is not None:
            self.agent_idx[i] = (np.arange(self.N) if agent_idx is None
                                 else agent_idx)
            self.agent_logw[i] = 0.0 if agent_logw is None else agent_logw
        self.ptr = (self.ptr + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def sample(self, batch: int) -> Optional[Dict[str, np.ndarray]]:
        if self.size == 0:
            return None
        idx = self.rng.integers(0, self.size, size=min(batch, self.size))
        out = {
            "obs": self.obs[idx],
            "state": self.state[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "mask": self.mask[idx],
        }
        if self.agent_logw is not None:
            out["agent_logw"] = self.agent_logw[idx]
        return out

    def state_dict(self) -> Dict:
        """Checkpointable snapshot incl. the sampled-agent columns and the
        numpy Generator state (arbitrary-precision ints, JSON-able)."""
        return {
            "obs": self.obs, "state": self.state, "actions": self.actions,
            "rewards": self.rewards, "mask": self.mask,
            "agent_idx": self.agent_idx, "agent_logw": self.agent_logw,
            "ptr": self.ptr, "size": self.size,
            "rng": self.rng.bit_generator.state,
        }

    def load_state_dict(self, state: Dict) -> None:
        for name in ("obs", "state", "actions", "rewards", "mask"):
            arr = np.asarray(state[name])
            if arr.shape != getattr(self, name).shape:
                raise ValueError(f"replay buffer {name} shape mismatch: "
                                 f"ckpt {arr.shape} vs "
                                 f"{getattr(self, name).shape}")
            setattr(self, name, arr)
        for name in ("agent_idx", "agent_logw"):
            have = getattr(self, name) is not None
            got = state.get(name) is not None
            if have != got:
                raise ValueError(f"replay buffer {name} presence mismatch "
                                 "(agent_budget differs from checkpoint)")
            if got:
                setattr(self, name, np.asarray(state[name]))
        self.ptr = int(state["ptr"])
        self.size = int(state["size"])
        self.rng.bit_generator.state = state["rng"]

    @property
    def nbytes(self) -> int:
        """Resident replay bytes (the BENCH_marl_train 'replay RSS' row)."""
        total = (self.obs.nbytes + self.state.nbytes + self.actions.nbytes
                 + self.rewards.nbytes + self.mask.nbytes)
        if self.agent_idx is not None:
            total += self.agent_idx.nbytes + self.agent_logw.nbytes
        return total

    def __len__(self):
        return self.size
