"""MARL networks (paper Fig. 3): the shared-weight agent and the two QMIX
mixers — port of ``repro.core.marl.networks``.

* ``mixer_init`` / ``mixer_apply`` (``networks.py:57-84``): the flat
  hypernet mixer, one weight row per agent (parameters grow with the
  fleet).
* ``set_mixer_init`` / ``set_mixer_apply`` (``networks.py:117-179``): the
  permutation-invariant set/attention mixer.  Each agent's Q value is
  embedded into a monotone value vector, a few state-conditioned seed
  queries pool those vectors by softmax attention over the agents' keys
  (:func:`attention_reduce`, on the card the hand-written non-causal
  ``flash_attention``), and ``|w2(s)|`` mixes the pooled vectors.  Its
  parameter count does not depend on the number of agents.

Every weight on a q path goes through ``abs()``, so Q_tot is monotone in
each q_i under either mixer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention_bhsd)
from repro_torch.models.layers import (dense_apply, dense_bias_init,
                                       gru_apply, gru_init, mlp_apply,
                                       mlp_init)


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


#: the reference's agent count at which its attention pooling leaves the
#: jnp oracle for the Pallas kernel on a TPU (``networks.py:87-91``).  A
#: TPU fact: the port does not read it.  On the card every agent count
#: takes the CUDA kernel, whose times at the set mixer's shapes PERF.md
#: sets beside the plain version's and SDPA's
FLASH_ATTENTION_MIN_AGENTS = 65536


def attention_reduce(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Softmax-attention pooling over the agent axis: q [B, Sq, D] (the
    seed queries), k, v [B, N, D] (per-agent keys and values) ->
    [B, Sq, D].  On a CUDA tensor the non-causal ``flash_attention``
    kernel at every N (forward and backward); on a CPU tensor its plain
    version, the reference's ``attention_ref``."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=False)
    return flash_attention_bhsd(q, k, v, causal=False)


def set_mixer_init(gen: torch.Generator, state_dim: int, obs_dim: int,
                   embed: int = 32, n_seeds: int = 4):
    """The set mixer's parameters, whose count does not depend on the
    number of agents (the reference's names and shapes)."""
    d = embed
    return {
        # per-agent observation features: keys and value context
        "obs_embed": mlp_init(gen, [obs_dim, d, d]),
        # keys use d - 1 learned dims; slot -1 carries the agent's log
        # importance weight (set_mixer_apply)
        "key_proj": dense_bias_init(gen, d, d - 1),
        "hyper_q": mlp_init(gen, [state_dim, d, n_seeds * (d - 1)]),
        # abs-constrained per-dim scale on the scalar q_i (monotone path)
        "hyper_w1": mlp_init(gen, [state_dim, d, d]),
        "hyper_b1": mlp_init(gen, [state_dim, d]),
        "val_obs": dense_bias_init(gen, d, d),
        "hyper_w2": mlp_init(gen, [state_dim, d, n_seeds * d]),
        "hyper_b2": mlp_init(gen, [state_dim, d, 1]),
    }


def set_mixer_apply(params, qs, obs, state, n_seeds: int = 4,
                    embed: int = 32, logw=None):
    """qs [..., N], obs [..., N, obs_dim], state [..., state_dim] and
    ``logw`` (optional, broadcastable to [..., N]: per-agent log importance
    weights of sampled-agent replay) -> Q_tot [...].

    Monotone in every q_i (its only path is ``elu(q_i * |w1(s)| + ...)``
    into non-negative attention weights and ``|w2(s)|``) and invariant to
    the agents' order.  The seeds' constant sqrt(d) in slot -1 cancels the
    attention's 1/sqrt(d) logit scale, so the keys' slot -1 adds
    ``logw_i`` to the logits: self-normalised importance weighting, with
    no gradient into ``logw``."""
    d = embed
    batch = qs.shape[:-1]
    n = qs.shape[-1]
    z = mlp_apply(params["obs_embed"], obs)                    # [..., N, d]
    keys = dense_apply(params["key_proj"], z)                  # [..., N, d-1]
    if logw is None:
        logw_col = torch.zeros(batch + (n, 1), dtype=qs.dtype,
                               device=qs.device)
    else:
        logw_col = torch.as_tensor(logw, dtype=qs.dtype, device=qs.device)
        logw_col = logw_col[..., None].expand(batch + (n, 1))
    keys = torch.cat([keys, logw_col], dim=-1)                 # [..., N, d]
    seeds = mlp_apply(params["hyper_q"], state).reshape(
        batch + (n_seeds, d - 1))
    const = torch.full(batch + (n_seeds, 1), math.sqrt(d),
                       dtype=seeds.dtype, device=seeds.device)
    seeds = torch.cat([seeds, const], dim=-1)                  # [..., S, d]
    w1 = torch.abs(mlp_apply(params["hyper_w1"], state))       # [..., d]
    b1 = mlp_apply(params["hyper_b1"], state)
    vals = F.elu(qs[..., None] * w1[..., None, :]
                 + dense_apply(params["val_obs"], z)
                 + b1[..., None, :])                           # [..., N, d]
    pooled = attention_reduce(seeds.reshape(-1, n_seeds, d),
                              keys.reshape(-1, n, d),
                              vals.reshape(-1, n, d))
    pooled = pooled.reshape(batch + (n_seeds * d,))
    w2 = torch.abs(mlp_apply(params["hyper_w2"], state))
    b2 = mlp_apply(params["hyper_b2"], state)[..., 0]
    return torch.sum(pooled * w2, dim=-1) + b2
