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



def _local_numel(shape, pl, sizes) -> int:
    """Elements of one rank's shard of ``shape`` under placements ``pl``
    on a mesh of ``sizes`` (the rules shard only dims their axes
    divide)."""
    dims = list(shape)
    for p, n in zip(pl, sizes):
        if p.is_shard():
            dims[p.dim] //= n
    out = 1
    for d in dims:
        out *= d
    return out


def state_bytes(cfg: ModelConfig, mesh) -> Dict[str, int]:
    """Each rank's bytes of ``cfg``'s train state on ``mesh`` (``params``
    in the config's dtype, ``grads`` like the params, AdamW's two float32
    ``moments``) beside the whole state's (``whole_params``,
    ``whole_grads``, ``whole_moments``), from the meta device's shapes
    and :func:`state_shardings`: nothing is allocated, and ``mesh`` may
    be a stand-in with ``axis_names`` and a ``shape`` mapping."""
    from repro_torch.models.api import build
    from repro_torch.sharding.rules import _axes
    from repro_torch.tree import tree_leaves
    shapes = _params_shape(build(cfg))
    sh = state_shardings({"params": shapes, "opt": {"step": 0}}, mesh)
    sizes = tuple(_axes(mesh).values())
    out = dict.fromkeys(("params", "grads", "moments", "whole_params",
                         "whole_grads", "whole_moments"), 0)
    for t, pl, mpl in zip(tree_leaves(shapes),
                          [p for p in _leaves_of(sh["params"])],
                          [p for p in _leaves_of(sh["opt"]["mu"])]):
        item = t.element_size()
        local = _local_numel(t.shape, pl, sizes) * item
        out["params"] += local
        out["grads"] += local
        out["moments"] += 2 * 4 * _local_numel(t.shape, mpl, sizes)
        out["whole_params"] += t.numel() * item
        out["whole_grads"] += t.numel() * item
        out["whole_moments"] += 2 * 4 * t.numel()
    return out


def _leaves_of(placed):
    """A placements tree's leaves (the placements tuples), in
    ``tree_leaves`` order."""
    if isinstance(placed, dict):
        return [p for k in sorted(placed) for p in _leaves_of(placed[k])]
    if isinstance(placed, list):
        return [p for v in placed for p in _leaves_of(v)]
    return [placed]
