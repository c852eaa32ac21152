"""Early-exit decoder-only transformer — port of
``repro.models.transformer_family`` (``model_family="transformer"``).

Depth is the submodel axis: the global model is ``N_BLOCKS`` pre-norm
decoder blocks (rmsnorm -> causal RoPE attention -> rmsnorm -> GELU MLP,
residuals) over a token-embedding stem, with one rmsnorm + linear
next-token head per block; submodel m = stem + blocks[:m+1] + exits[:m+1].

The participant axis is written out.  :func:`apply_all_exits_stacked`
takes a tree whose leaves are stacked [P, ...] and tokens [P, B, S]: each
participant has its own embedding table (a gather from [P, V, d]), its
own dense weights (one batched product per layer), its own norm scales
(``rmsnorm`` with G = P) and its attention runs as BH = P*B*H rows of one
``flash_attention`` call.  The bucket program differentiates it with
plain autograd (``LayerwiseFamily.stacked_forward``), because the CUDA
kernels are bound through ctypes and ``torch.func.vmap`` cannot see inside
them.  :func:`apply_all_exits` is the same forward at P = 1.

On CUDA tensors the block's norms and attention run the hand-written
kernels (``repro_torch.kernels.rmsnorm``, ``.flash_attention``); on the
CPU their plain versions, the oracles the JAX family runs off the TPU.
Numerics follow the reference: GELU is the tanh approximation, RoPE
rotates the two halves of each head in float32, the exit head reads the
last position only.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.family import (LayerwiseFamily, cross_entropy,
                                       register_family)
from repro_torch.models.layers import (apply_rope, dense_bias_init,
                                       dense_init, embed_init,
                                       gelu_mlp_init, rmsnorm_init,
                                       stacked_dense_apply,
                                       stacked_gelu_mlp_apply)
from repro_torch.tree import tree_map

N_BLOCKS = 4              # one exit head per block = 4 submodels (paper M)
BASE_WIDTH = 128          # d_model at width_mult=1.0
N_HEADS = 4
MLP_RATIO = 4             # hidden = MLP_RATIO * d
ROPE_THETA = 10000.0


def _width(width_mult: float) -> int:
    """d_model: multiple of 2*N_HEADS so every head splits evenly for
    RoPE's half-dim rotation."""
    step = 2 * N_HEADS
    d = max(32, int(BASE_WIDTH * width_mult))
    return ((d + step - 1) // step) * step


def init(gen: torch.Generator, num_classes: int = 10,
         width_mult: float = 1.0):
    """The reference's tree and distributions, drawn from ``gen`` on the
    CPU: embedding N(0, 1), dense N(0, 1/d_in) (``wo`` and the heads
    N(0, 1/d)), unit norm scales, zero biases."""
    d = _width(width_mult)
    f = MLP_RATIO * d
    params = {"stem": {"embed": embed_init(gen, num_classes, d)},
              "stages": [], "exits": []}
    for _ in range(N_BLOCKS):
        params["stages"].append({
            "attn_norm": rmsnorm_init(d),
            "attn": {"wq": dense_init(gen, d, d),
                     "wk": dense_init(gen, d, d),
                     "wv": dense_init(gen, d, d),
                     "wo": dense_init(gen, d, d, scale=1.0 / math.sqrt(d))},
            "mlp_norm": rmsnorm_init(d),
            "mlp": gelu_mlp_init(gen, d, f),
        })
        params["exits"].append({
            "norm": rmsnorm_init(d),
            "head": dense_bias_init(gen, d, num_classes,
                                    scale=1.0 / math.sqrt(d)),
        })
    return params


def _rmsnorm(p, h):
    """rmsnorm over the trailing dim of h [P, ..., d], one scale row per
    participant."""
    P, d = h.shape[0], h.shape[-1]
    return rmsnorm(h.contiguous().reshape(P, -1, d),
                   p["scale"]).reshape(h.shape)


def _attention(bp, h):
    P, B, S, d = h.shape
    hd = d // N_HEADS

    def heads(name):
        return stacked_dense_apply(bp[name], h).reshape(P * B, S, N_HEADS, hd)
    pos = torch.arange(S, device=h.device)
    q = apply_rope(heads("wq"), pos, ROPE_THETA)
    k = apply_rope(heads("wk"), pos, ROPE_THETA)
    o = flash_attention(q, k, heads("wv"), causal=True)
    return stacked_dense_apply(bp["wo"], o.reshape(P, B, S, d))


def _block(bp, h):
    h = h + _attention(bp["attn"], _rmsnorm(bp["attn_norm"], h))
    return h + stacked_gelu_mlp_apply(bp["mlp"], _rmsnorm(bp["mlp_norm"], h))


def _exit_head(ep, h):
    """Next-token logits at the LAST position (the window's label slot)."""
    return stacked_dense_apply(ep["head"],
                               _rmsnorm(ep["norm"], h[:, :, -1, :]))


def apply_all_exits_stacked(params, x) -> List[torch.Tensor]:
    """params with leaves [P, ...], x [P, B, S] integer tokens -> logits
    [P, B, V] of every exit the (truncated) tree holds."""
    emb = params["stem"]["embed"]["emb"]                      # [P, V, d]
    P, V, d = emb.shape
    offs = (torch.arange(P, device=x.device) * V).view(P, 1, 1)
    h = F.embedding(x.long() + offs, emb.reshape(P * V, d))   # [P, B, S, d]
    outs = []
    for si in range(len(params["stages"])):
        h = _block(params["stages"][si], h)
        outs.append(_exit_head(params["exits"][si], h))
    return outs


def apply_all_exits(params, x) -> List[torch.Tensor]:
    """x [B, S] integer tokens -> logits [B, V] of every exit held by
    ``params`` (truncated trees ok): the stacked forward at P = 1."""
    one = tree_map(lambda a: a.unsqueeze(0), params)
    return [o[0] for o in apply_all_exits_stacked(one, x.unsqueeze(0))]


def flops_per_sample(model_idx: int, image_hw: int = 32,
                     width_mult: float = 1.0, num_classes: int = 10) -> float:
    """Analytic forward FLOPs for Model_{idx+1}, the reference's formula;
    ``image_hw`` is the sequence length."""
    d = _width(width_mult)
    f = MLP_RATIO * d
    S = image_hw
    per_block = (4 * 2.0 * S * d * d        # q/k/v/o projections
                 + 2 * 2.0 * S * S * d      # scores + weighted values
                 + 2.0 * S * (d * f + f * d))  # GELU MLP in + out
    return (model_idx + 1) * per_block + 2.0 * d * num_classes


class TransformerFamily(LayerwiseFamily):
    name = "transformer"
    ref_hw = 32          # paper-scale sequence length (cost calibration)
    stacked_forward = True

    def init(self, gen: torch.Generator, num_classes: int = 10,
             width_mult: float = 1.0, hw: int = 32):
        # rotary positions: the parameters do not depend on the length
        return init(gen, num_classes, width_mult)

    def num_submodels(self) -> int:
        return N_BLOCKS

    def apply_all_exits(self, params, x):
        return apply_all_exits(params, x)

    def apply_all_exits_stacked(self, params, x):
        return apply_all_exits_stacked(params, x)

    def flops_per_sample(self, model_idx: int, image_hw: int = 32,
                         width_mult: float = 1.0) -> float:
        return flops_per_sample(model_idx, image_hw, width_mult)

    def make_dataset(self, n: int, num_classes: int = 10, hw: int = 32,
                     noise: float = 1.0, seed: int = 0):
        from repro_torch.data.synthetic import synthetic_token_dataset
        return synthetic_token_dataset(n, num_classes, seq_len=hw,
                                       noise=noise, seed=seed)

    def _drfl_step_loss(self, params, x, y, model_idx: int):
        """The reference's ``_masked_drfl_loss``: a full-depth forward with
        per-exit weights 1.0 at the held depth, 0.3 shallower and exactly
        0.0 deeper, normalised by ``1 + 0.3 m`` in float32.  Every block
        and exit runs forward and backward whatever ``m`` (12 ``rmsnorm``
        and 4 ``flash_attention`` launches each way a step); the zero
        weights give the deeper leaves exactly zero gradient."""
        outs = self.apply_all_exits(params, x)
        ces = torch.stack([cross_entropy(o, y) for o in outs])
        idx = torch.arange(len(outs), device=ces.device)
        w = torch.where(idx == model_idx, 1.0,
                        torch.where(idx < model_idx, 0.3, 0.0)
                        ).to(torch.float32)
        # the reference's traced float32 arithmetic, on the host
        den = np.float32(1.0) + np.float32(0.3) * np.float32(model_idx)
        return torch.sum(w * ces) / float(den)


register_family(TransformerFamily())
