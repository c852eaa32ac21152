"""Early-exit residual MLP — port of ``repro.models.mlp``, the ``mlp``
family (``model_family="mlp"``, DR-FL only).

A layer-wise model in the canonical ``{"stem", "stages", "exits"}``
layout: the stem flattens the image and projects it to d (LayerNorm
after), each of the ``N_STAGES`` stages is ``BLOCKS_PER_STAGE`` pre-norm
residual GELU-MLP blocks, each exit a LayerNorm and a dense head.
Submodel m = stem + stages[:m+1] + exits[:m+1].

Two forms of one forward: :func:`apply_all_exits` (one participant: the
per-client executor and evaluation) and :func:`apply_all_exits_stacked`
(the participant axis written out: leaves [P, ...], images [P, B, H, W,
C], one batched product per layer, one LayerNorm row per participant),
which the bucketed executor differentiates with plain autograd
(``stacked_forward``).  ``torch.func.vmap`` over ``grad`` of the first
form gives the same weights bit for bit on the card in a slower warm
round (``scripts/mlp_route_ab.py``; PERF.md).  Numerics
follow the reference: LayerNorm written out in float32
(:func:`repro_torch.models.layers.layernorm_apply`), GELU the tanh
approximation.

Paper-scale calibration (``cost_model``): width 1.0 on 32x32x3 inputs
(d 256, about 2.9 M float32 parameters).
"""
from __future__ import annotations

import math
from typing import List

import torch

from repro_torch.models.family import LayerwiseFamily, register_family
from repro_torch.models.layers import (dense_apply, dense_bias_init,
                                       gelu_mlp_apply, gelu_mlp_init,
                                       layernorm_apply, layernorm_init,
                                       stacked_dense_apply,
                                       stacked_gelu_mlp_apply)

N_STAGES = 4
BLOCKS_PER_STAGE = 2
BASE_WIDTH = 256          # d_model at width_mult=1.0
MLP_RATIO = 2             # hidden = MLP_RATIO * d


def _width(width_mult: float) -> int:
    return max(16, int(BASE_WIDTH * width_mult))


def init(gen: torch.Generator, num_classes: int = 10,
         width_mult: float = 1.0, hw: int = 32, in_channels: int = 3):
    """The reference's tree and distributions, drawn from ``gen`` on the
    CPU: dense N(0, 1/d_in) (``w_out`` N(0, 1/f), the heads N(0, 1/d)),
    unit LayerNorm scales, zero biases."""
    d = _width(width_mult)
    f = MLP_RATIO * d
    params = {"stem": {"proj": dense_bias_init(gen, hw * hw * in_channels,
                                               d),
                       "ln": layernorm_init(d)},
              "stages": [], "exits": []}
    for _ in range(N_STAGES):
        params["stages"].append([{"ln": layernorm_init(d),
                                  "mlp": gelu_mlp_init(gen, d, f)}
                                 for _ in range(BLOCKS_PER_STAGE)])
        params["exits"].append({
            "ln": layernorm_init(d),
            "head": dense_bias_init(gen, d, num_classes,
                                    scale=1.0 / math.sqrt(d))})
    return params


def _stem(params, x):
    h = dense_apply(params["stem"]["proj"], x.reshape(x.shape[0], -1))
    return layernorm_apply(params["stem"]["ln"], h)


def _block(bp, h):
    return h + gelu_mlp_apply(bp["mlp"], layernorm_apply(bp["ln"], h))


def _exit_head(ep, h):
    return dense_apply(ep["head"], layernorm_apply(ep["ln"], h))


def apply(params, x, model_idx: int):
    """x [B, H, W, C] -> logits at exit ``model_idx``."""
    h = _stem(params, x)
    for si in range(model_idx + 1):
        for bp in params["stages"][si]:
            h = _block(bp, h)
    return _exit_head(params["exits"][model_idx], h)


def apply_all_exits(params, x) -> List[torch.Tensor]:
    """Logits from every exit held by ``params`` (truncated trees ok)."""
    h = _stem(params, x)
    outs = []
    for si, stage in enumerate(params["stages"]):
        for bp in stage:
            h = _block(bp, h)
        outs.append(_exit_head(params["exits"][si], h))
    return outs


def _stacked_ln(p, h):
    """LayerNorm of h [P, B, d], one scale and bias row per participant."""
    return layernorm_apply({k: v[:, None, :] for k, v in p.items()}, h)


def apply_all_exits_stacked(params, x) -> List[torch.Tensor]:
    """params with leaves [P, ...], x [P, B, H, W, C] -> logits [P, B, C]
    of every exit the (truncated) tree holds."""
    P, B = x.shape[:2]
    h = _stacked_ln(params["stem"]["ln"], stacked_dense_apply(
        params["stem"]["proj"], x.reshape(P, B, -1)))
    outs = []
    for si, stage in enumerate(params["stages"]):
        for bp in stage:
            h = h + stacked_gelu_mlp_apply(bp["mlp"],
                                           _stacked_ln(bp["ln"], h))
        ep = params["exits"][si]
        outs.append(stacked_dense_apply(ep["head"],
                                        _stacked_ln(ep["ln"], h)))
    return outs


def flops_per_sample(model_idx: int, image_hw: int = 32,
                     width_mult: float = 1.0, in_channels: int = 3,
                     num_classes: int = 10) -> float:
    """Analytic forward FLOPs for Model_{idx+1}, the reference's formula."""
    d = _width(width_mult)
    f = MLP_RATIO * d
    total = 2.0 * image_hw * image_hw * in_channels * d          # stem proj
    per_block = 2.0 * (d * f + f * d)                            # in + out
    total += (model_idx + 1) * BLOCKS_PER_STAGE * per_block
    total += 2.0 * d * num_classes                               # exit head
    return total


class MlpFamily(LayerwiseFamily):
    """DR-FL only, as the reference: width-slicing residual dense blocks
    is another baseline design, so ``SimulationSpec`` refuses HeteroFL and
    ScaleFL on this family up front."""

    name = "mlp"
    supported_methods = ("drfl",)
    stacked_forward = True

    def init(self, gen: torch.Generator, num_classes: int = 10,
             width_mult: float = 1.0, hw: int = 32):
        return init(gen, num_classes, width_mult=width_mult, hw=hw)

    def num_submodels(self) -> int:
        return N_STAGES

    def apply_all_exits(self, params, x):
        return apply_all_exits(params, x)

    def apply_all_exits_stacked(self, params, x):
        return apply_all_exits_stacked(params, x)

    def flops_per_sample(self, model_idx: int, image_hw: int = 32,
                         width_mult: float = 1.0) -> float:
        return flops_per_sample(model_idx, image_hw, width_mult)


register_family(MlpFamily())
