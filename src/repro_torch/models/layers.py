"""Dense, MLP and GRU primitives — port of the parts of
``repro.models.layers`` the MARL agents use.

Parameters are plain dicts of tensors with the JAX names and shapes
(``w`` is ``[d_in, d_out]`` and applies as ``x @ w``), so converted JAX
weights drop in unchanged.  Initialisers draw from an explicit CPU
``torch.Generator``: the numbers differ from ``jax.random`` for the same
seed, the distributions do not.
"""
from __future__ import annotations

import math

import torch


def dense_bias_init(gen: torch.Generator, d_in: int, d_out: int,
                    bias: bool = True):
    p = {"w": torch.randn((d_in, d_out), generator=gen) / math.sqrt(d_in)}
    if bias:
        p["b"] = torch.zeros((d_out,))
    return p


def dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


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
