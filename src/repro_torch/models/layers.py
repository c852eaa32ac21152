"""Dense, MLP, GRU, embedding, RMSNorm-init, LayerNorm, RoPE and GELU-MLP
primitives — port of the parts of ``repro.models.layers`` that the MARL
agents and the ``transformer`` and ``mlp`` families use.

Parameters are plain dicts of tensors with the JAX names and shapes
(``w`` is ``[d_in, d_out]`` and applies as ``x @ w``), so converted JAX
weights drop in unchanged.  Initialisers draw from an explicit CPU
``torch.Generator``: the numbers differ from ``jax.random`` for the same
seed, the distributions do not.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None):
    """``w ~ N(0, scale^2)``, ``scale`` 1/sqrt(d_in) unless given
    (``layers.py:26``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": torch.randn((d_in, d_out), generator=gen) * scale}


def dense_bias_init(gen: torch.Generator, d_in: int, d_out: int,
                    bias: bool = True, scale: Optional[float] = None):
    p = dense_init(gen, d_in, d_out, scale)
    if bias:
        p["b"] = torch.zeros((d_out,))
    return p


def dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def stacked_dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    """``dense_apply`` with the participant axis written out: x [P, ...,
    d_in], w [P, d_in, d_out], b [P, d_out]; one batched product per
    call."""
    P, d_in = x.shape[0], x.shape[-1]
    w = p["w"]
    y = torch.bmm(x.reshape(P, -1, d_in), w).reshape(
        x.shape[:-1] + (w.shape[-1],))
    if "b" in p:
        y = y + p["b"].reshape((P,) + (1,) * (x.dim() - 2) + (w.shape[-1],))
    return y


def embed_init(gen: torch.Generator, vocab: int, d: int):
    return {"emb": torch.randn((vocab, d), generator=gen)}


def rmsnorm_init(d: int):
    return {"scale": torch.ones((d,))}


def layernorm_init(d: int):
    return {"scale": torch.ones((d,)), "bias": torch.zeros((d,))}


def layernorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's expression (``layers.py:104-109``), written out:
    float32 mean, the biased variance of ``x - mean``, ``rsqrt``; ATen's
    fused ``layer_norm`` sums in another order."""
    xf = x.float()
    centered = xf - xf.mean(dim=-1, keepdim=True)
    var = (centered * centered).mean(dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, H, D]; positions broadcastable to [..., S] (int).  The
    reference rotates the two HALVES of the head dimension, not
    interleaved pairs, with angles in float32 (``layers.py:121-129``)."""
    freqs = rope_freqs(x.shape[-1], theta).to(x.device)      # [D/2]
    angles = positions[..., None].float() * freqs            # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                    # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu_mlp_init(gen: torch.Generator, d: int, f: int):
    """With biases, the reference's default (``layers.py:368``)."""
    return {"w_in": dense_bias_init(gen, d, f),
            "w_out": dense_bias_init(gen, f, d, scale=1.0 / math.sqrt(f))}


def gelu_mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """``w_out(gelu(w_in(x)))``; ``jax.nn.gelu`` is the tanh approximation
    by default (``layers.py:374-375``)."""
    return dense_apply(p["w_out"], F.gelu(dense_apply(p["w_in"], x),
                                          approximate="tanh"))


def stacked_gelu_mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """The GELU MLP with the participant axis written out (x [P, ...,
    d]); ``jax.nn.gelu`` is the tanh approximation by default
    (``layers.py:375``)."""
    return stacked_dense_apply(
        p["w_out"], F.gelu(stacked_dense_apply(p["w_in"], x),
                           approximate="tanh"))


def mlp_init(gen: torch.Generator, net_dims):
    return {f"l{i}": dense_bias_init(gen, net_dims[i], net_dims[i + 1])
            for i in range(len(net_dims) - 1)}


def mlp_apply(p, x: torch.Tensor, act=torch.relu) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = dense_apply(p[f"l{i}"], x)
        if i < n - 1:
            x = act(x)
    return x


def gru_init(gen: torch.Generator, d_in: int, d_h: int):
    return {"wx": dense_bias_init(gen, d_in, 3 * d_h),
            "wh": dense_bias_init(gen, d_h, 3 * d_h, bias=False)}


def gru_apply(p, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference cell (``layers.py:407-415``): the hidden projection
    has NO bias, which ``nn.GRUCell`` cannot express, so it is written
    out."""
    gx = dense_apply(p["wx"], x)
    gh = dense_apply(p["wh"], h)
    xr, xz, xn = torch.chunk(gx, 3, dim=-1)
    hr, hz, hn = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h
