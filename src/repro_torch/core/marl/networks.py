"""MARL networks (paper Fig. 3): the shared-weight agent and the flat QMIX
mixer — port of ``repro.core.marl.networks`` (``networks.py:37-84``).

The set/attention mixer (above 256 devices) is not in this slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import gru_apply, gru_init, mlp_apply, mlp_init


def agent_init(gen: torch.Generator, obs_dim: int, num_actions: int,
               hidden: int = 64):
    return {"enc": mlp_init(gen, [obs_dim, hidden, hidden]),
            "gru": gru_init(gen, hidden, hidden),
            "head": mlp_init(gen, [hidden, hidden, num_actions])}


def agent_step(params, obs, h):
    """obs [..., N, obs_dim], h [..., N, hidden] -> (q [..., N, A], h').
    One set of weights serves every agent; leading axes broadcast."""
    z = mlp_apply(params["enc"], obs)
    h_new = gru_apply(params["gru"], h, z)
    return mlp_apply(params["head"], h_new), h_new


def mixer_init(gen: torch.Generator, n_agents: int, state_dim: int,
               embed: int = 32):
    return {"hyper_w1": mlp_init(gen, [state_dim, embed, n_agents * embed]),
            "hyper_b1": mlp_init(gen, [state_dim, embed]),
            "hyper_w2": mlp_init(gen, [state_dim, embed, embed]),
            "hyper_b2": mlp_init(gen, [state_dim, embed, 1])}


def mixer_apply(params, qs, state, n_agents: int, embed: int = 32):
    """qs [..., N], state [..., state_dim] -> Q_tot [...]; every weight on
    a q path goes through abs(), so Q_tot is monotone in each q_i."""
    w1 = torch.abs(mlp_apply(params["hyper_w1"], state))
    w1 = w1.reshape(state.shape[:-1] + (n_agents, embed))
    b1 = mlp_apply(params["hyper_b1"], state)
    hid = F.elu(torch.einsum("...n,...ne->...e", qs, w1) + b1)
    w2 = torch.abs(mlp_apply(params["hyper_w2"], state))
    b2 = mlp_apply(params["hyper_b2"], state)[..., 0]
    return torch.einsum("...e,...e->...", hid, w2) + b2
