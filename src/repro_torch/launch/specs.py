"""Input shapes and shardings for every (architecture x input shape x
mesh) — port of ``repro.launch.specs``, with no allocation.

Shapes are ``(shape, dtype)`` pairs, or trees of ``meta`` tensors: the
params and decode caches come from the model's own ``init`` and
``decode_init`` run on the meta device (:func:`_params_shape`).  A
sharding is a leaf's ``DTensor`` placements on the mesh
(:func:`repro_torch.sharding.rules.placements` of its spec); like the
spec functions, these read only the mesh's axis names and sizes.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.api import extra_inputs
from repro_torch.sharding.rules import (batch_axes, cache_specs,
                                        get_sharding_policy, param_specs,
                                        placements)


class _MetaGenerator(torch.Generator):
    """A generator whose device is ``meta``: a model's ``init`` draws on
    its generator's device, so it makes meta tensors, shapes and dtypes
    without storage."""

    @property
    def device(self):
        return torch.device("meta")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_spec(mesh) -> tuple:
    b = batch_axes(mesh)
    return (b if len(b) > 1 else b[0],)


def train_inputs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """name -> (shape, dtype) of a train batch."""
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": ((B, S), torch.int32), "labels": ((B, S), torch.int32)}
    out.update(extra_inputs(cfg, B, S))
    return out


def train_input_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh):
    bs = batch_spec(mesh)
    out = {"tokens": placements(bs + (None,), mesh),
           "labels": placements(bs + (None,), mesh)}
    for k in extra_inputs(cfg, shape.global_batch, shape.seq_len):
        out[k] = placements(bs + (None, None), mesh)
    return out


def decode_inputs(model, cfg: ModelConfig, shape: ShapeConfig,
                  window_override=None) -> Tuple[Any, Any, Any]:
    """(the cache as meta tensors, tokens, pos) of ``serve_step``; tokens
    and pos as (shape, dtype)."""
    B, S = shape.global_batch, shape.seq_len
    extras = {k: _meta(shp, dt)
              for k, (shp, dt) in extra_inputs(cfg, B, S).items()}
    kw = {}
    if window_override is not None:
        kw["window"] = window_override
    cache = model.decode_init(_params_shape(model), B, S, extras=extras, **kw)
    return cache, ((B, 1), torch.int32), ((), torch.int32)


def _params_shape(model):
    return model.init(_MetaGenerator())


def _placed(specs, mesh):
    """A spec tree as a placements tree (spec tuples are its leaves)."""
    if isinstance(specs, dict):
        return {k: _placed(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_placed(v, mesh) for v in specs]
    return placements(specs, mesh)


def decode_cache_shardings(cache_shape, mesh):
    return _placed(cache_specs(cache_shape, mesh), mesh)


def state_shardings(state_shape, mesh):
    """Placements for a {'params', 'opt'} train state.  Moments follow
    their parameters, except under ZeRO-1 (replicated weights,
    data-sharded optimizer state); the step is replicated."""
    pol = get_sharding_policy()
    pspecs = param_specs(state_shape["params"], mesh)
    mspecs = (param_specs(state_shape["params"], mesh, force_fsdp=True)
              if pol.get("zero1") else pspecs)
    return {"params": _placed(pspecs, mesh),
            "opt": {"step": placements((), mesh),
                    "mu": _placed(mspecs, mesh),
                    "nu": _placed(mspecs, mesh)}}


def params_shardings(params_shape, mesh):
    return _placed(param_specs(params_shape, mesh), mesh)

