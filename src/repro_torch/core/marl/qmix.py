"""QMIX learner (Rashid et al. 2018) — port of ``repro.core.marl.qmix``,
with either mixer: the flat hypernet mixer or the set/attention mixer
(``mixer_mode="set"``), which trains on sampled-agent replay batches
(their ``agent_logw`` column, broadcast over T, enters its logits).

TD target (paper §3.2), double-Q with the online net's argmax:
    y_t = r_t + gamma * Q_tot^target(s_{t+1}, argmax_a Q(s_{t+1}, a))
    L   = E[(y_t - Q_tot(s_t, a_t))^2]
The target net is a copy of the online net every ``target_update_every``
updates.  Parameters live on the learner's device; ε-exploration draws from
a ``torch.Generator`` seeded ``seed + 1`` like the JAX act key (the numbers
differ from ``jax.random``; with ε = 0 both sides act greedily).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.marl.networks import (agent_init, agent_step,
                                            mixer_apply, mixer_init,
                                            set_mixer_apply, set_mixer_init)
from repro_torch.device import resolve_device, to_host
from repro_torch.optim.optimizers import adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


@dataclasses.dataclass(frozen=True)
class QmixConfig:
    n_agents: int
    obs_dim: int
    num_actions: int          # M submodels + 1 no-participate
    state_dim: int
    hidden: int = 64
    mixer_embed: int = 32
    gamma: float = 0.95
    lr: float = 5e-4
    target_update_every: int = 20
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_rounds: int = 200
    batch_size: int = 16
    # "flat": the per-agent hypernet mixer (O(n_agents) params); "set":
    # the set/attention mixer (params independent of n_agents)
    mixer_mode: str = "flat"
    n_seeds: int = 4          # set-mixer seed queries


def epsilon(cfg: QmixConfig, round_idx: int) -> float:
    frac = min(1.0, round_idx / max(1, cfg.eps_decay_rounds))
    return cfg.eps_start + (cfg.eps_end - cfg.eps_start) * frac


def _copy(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


class QmixLearner:
    """Online + target params, the AdamW state and the act/update steps."""

    def __init__(self, cfg: QmixConfig, seed: int, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        agent = agent_init(gen, cfg.obs_dim, cfg.num_actions, cfg.hidden)
        if cfg.mixer_mode == "set":
            mixer = set_mixer_init(gen, cfg.state_dim, cfg.obs_dim,
                                   cfg.mixer_embed, cfg.n_seeds)
        else:
            mixer = mixer_init(gen, cfg.n_agents, cfg.state_dim,
                               cfg.mixer_embed)
        params = {"agent": agent, "mixer": mixer}
        self.load_params(params)
        self.act_gen = torch.Generator(device=self.device).manual_seed(
            int(seed) + 1)

    def load_params(self, params) -> None:
        """Install ``params`` (e.g. converted JAX weights) as online and
        target nets, with a fresh optimizer state."""
        self.params = tree_map(lambda t: t.to(self.device, torch.float32),
                               params)
        self.target = _copy(self.params)
        self.opt = adamw_init(self.params)
        self.updates = 0

    def init_hidden(self) -> torch.Tensor:
        return torch.zeros((self.cfg.n_agents, self.cfg.hidden),
                           device=self.device)

    @torch.no_grad()
    def act(self, obs, hidden, eps: float, avail
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """obs [N, obs_dim], avail [N, A] bool -> (actions [N],
        q_chosen [N], new_hidden).  Unaffordable actions are never taken;
        exploration picks uniformly among the available ones."""
        q, h = agent_step(self.params["agent"], obs, hidden)
        greedy = torch.argmax(torch.where(avail, q, -1e9), dim=-1)
        u = torch.rand(q.shape, generator=self.act_gen, device=q.device)
        rand_a = torch.argmax(torch.where(avail, u, -1.0), dim=-1)
        explore = torch.rand(greedy.shape, generator=self.act_gen,
                             device=q.device) < eps
        act = torch.where(explore, rand_a, greedy)
        return act, q.gather(-1, act[:, None])[:, 0], h

    def update(self, batch: Dict) -> Dict[str, float]:
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(self.params)]
        loss = td_loss(self.cfg, tree_unflatten_like(self.params, leaves),
                       self.target, batch)
        grads = torch.autograd.grad(loss, leaves)
        self.params, self.opt, m = adamw_update(
            tree_unflatten_like(self.params, list(grads)), self.opt,
            self.params, lr=self.cfg.lr, weight_decay=0.0, grad_clip=10.0)
        self.updates += 1
        if self.updates % self.cfg.target_update_every == 0:
            self.target = _copy(self.params)
        td, gn = to_host(loss.detach(), m["grad_norm"])
        return {"td_loss": float(td), "grad_norm": float(gn)}


def _unroll(cfg: QmixConfig, params, obs_seq):
    """obs_seq [B, T+1, N, obs] -> qs [B, T+1, N, A] via the GRU unroll."""
    h = torch.zeros(obs_seq.shape[:1] + obs_seq.shape[2:3] + (cfg.hidden,),
                    device=obs_seq.device)
    qs = []
    for t in range(obs_seq.shape[1]):
        q, h = agent_step(params["agent"], obs_seq[:, t], h)
        qs.append(q)
    return torch.stack(qs, dim=1)


def _mix(cfg: QmixConfig, mix_params, q_agents, obs_steps, state_steps,
         logw):
    """The configured mixer on per-agent Qs (``qmix.py:131-139``)."""
    if cfg.mixer_mode == "set":
        return set_mixer_apply(mix_params, q_agents, obs_steps, state_steps,
                               n_seeds=cfg.n_seeds, embed=cfg.mixer_embed,
                               logw=logw)
    return mixer_apply(mix_params, q_agents, state_steps, cfg.n_agents,
                       cfg.mixer_embed)


def td_loss(cfg: QmixConfig, params, target, batch) -> torch.Tensor:
    """The reference's ``_update`` loss (``qmix.py:142-169``).  N is the
    batch's agent axis: ``cfg.n_agents``, or the stored agents of
    sampled-agent replay, whose ``agent_logw`` [B, N] (absent from flat
    batches) is broadcast over T."""
    obs, state = batch["obs"], batch["state"]            # [B, T+1, ...]
    actions, rewards, mask = batch["actions"], batch["rewards"], batch["mask"]
    logw = batch.get("agent_logw")
    if logw is not None:
        logw = logw[:, None, :]
    qs = _unroll(cfg, params, obs)                       # [B, T+1, N, A]
    q_taken = qs[:, :-1].gather(-1, actions[..., None])[..., 0]   # [B, T, N]
    q_tot = _mix(cfg, params["mixer"], q_taken, obs[:, :-1], state[:, :-1],
                 logw)                                   # [B, T]
    with torch.no_grad():
        tq = _unroll(cfg, target, obs)
        next_best = torch.argmax(qs[:, 1:], dim=-1)      # double-Q
        tq_next = tq[:, 1:].gather(-1, next_best[..., None])[..., 0]
        tq_tot = _mix(cfg, target["mixer"], tq_next, obs[:, 1:],
                      state[:, 1:], logw)
    y = rewards + cfg.gamma * tq_tot * mask
    td = (y - q_tot) * mask
    return torch.sum(td ** 2) / torch.clamp_min(mask.sum(), 1.0)
