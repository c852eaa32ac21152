"""Layer-wise (depth-prefix) submodels, the paper's §4.2 mechanism — port
of ``repro.core.layerwise``.

A *layer-wise model* ``Model_m`` is the global model truncated to its first
``exit_points[m]`` layers plus an exit head.  On the LM's stacked ``[L,
...]`` params a submodel is a float ``[L]`` mask (1 = layer present): the
masked forward is the identity on skipped layers, and masked aggregation
averages each layer over exactly the clients that trained it.  (The CNN's
stage prefixes live in :mod:`repro_torch.models.cnn`.)

Masks change values, never the params' structure, so one step serves all
M submodels.  They are float32 tensors on the device the caller names
(:func:`layer_mask`) or on each leaf's device
(:func:`stacked_update_mask`).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_map


def exit_points(cfg: ModelConfig) -> Sequence[int]:
    if cfg.exit_points:
        return cfg.exit_points
    L = cfg.num_layers
    return (max(1, L // 4), max(1, L // 2), max(1, 3 * L // 4), L)


def num_submodels(cfg: ModelConfig) -> int:
    return len(exit_points(cfg))


def layer_mask(cfg: ModelConfig, model_idx: int, *,
               device) -> torch.Tensor:
    """Float32 ``[num_layers]`` mask of depth-prefix submodel
    ``model_idx``, on ``device``."""
    k = exit_points(cfg)[model_idx]
    return (torch.arange(cfg.num_layers, device=device) < k).float()


def submodel_layer_count(cfg: ModelConfig, model_idx: int) -> int:
    return int(exit_points(cfg)[model_idx])


def submodel_fraction(cfg: ModelConfig, model_idx: int) -> float:
    """Fraction of backbone layers a submodel trains (size/energy proxy)."""
    return submodel_layer_count(cfg, model_idx) / cfg.num_layers


def stacked_update_mask(cfg: ModelConfig, model_idx: int, params) -> dict:
    """Per-leaf masks (broadcastable to each stacked param) marking which
    layer slices this submodel contributes to during aggregation, each on
    its leaf's device.

    Leaves without a stacked layer dim (embed, final norm, unembed, shared
    blocks) get mask 1 — every client trains them.
    """
    def leaf_mask(leaf):
        # stacked leaves have leading dim == num stacked units
        if leaf.dim() >= 1 and leaf.shape[0] in _stack_sizes(cfg):
            units = leaf.shape[0]
            lm = layer_mask(cfg, model_idx, device=leaf.device)
            return _unit_mask(cfg, lm, units).reshape(
                (units,) + (1,) * (leaf.dim() - 1))
        return torch.ones((), dtype=torch.float32, device=leaf.device)

    return tree_map(leaf_mask, params)


def _stack_sizes(cfg: ModelConfig):
    """Possible leading stack sizes for this family."""
    L = cfg.num_layers
    sizes = {L}
    if cfg.family == "ssm":
        sizes.add(L // 2)                   # mLSTM/sLSTM pair stacks
    if cfg.family == "vlm" and cfg.cross_attn_every:
        sizes.add(L // cfg.cross_attn_every)  # group stacks
    return sizes


def _unit_mask(cfg: ModelConfig, lm: torch.Tensor,
               units: int) -> torch.Tensor:
    """Collapse the [L] layer mask to a [units] stack mask (a stacked unit is
    'trained' if ANY of its layers is)."""
    L = cfg.num_layers
    if units == L:
        return lm
    return lm.reshape(units, L // units).amax(dim=1)
