"""Unified model API: ``build(cfg)`` -> a :class:`Model` namespace — port of
``repro.models.api``.

Every family exposes the same surface:
    init(gen) -> params          (gen: a torch.Generator; params on its
                                  device, in cfg.dtype)
    apply(params, tokens, extras, layer_mask=..., remat=..., use_pallas=...)
        -> (hidden [B,S,d], aux_loss)
    logits(params, hidden) -> [B,S,V] float32
    decode_init(params, batch, seq_len, **extras) -> cache
    decode_step(params, cache, tokens, pos, layer_mask=...) -> (logits, cache)

The port builds the ``dense`` family (``models/transformer.py``),
``ssm`` (``models/xlstm.py``) and ``mamba-hybrid`` (``models/hybrid.py``).
The others (``moe``, ``vlm``, ``audio``) raise ``NotImplementedError``
until their modules are ported (ROADMAP Queue 1); an unknown family keeps
the reference's ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, transformer, xlstm

#: the reference's families that the port has not ported yet
UNPORTED_FAMILIES = ("moe", "vlm", "audio")

#: the ported families' modules
_MODULES = {"dense": transformer, "ssm": xlstm, "mamba-hybrid": hybrid}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    apply: Callable            # (params, tokens, extras, ...) -> (hidden, aux)
    logits: Callable
    decode_init: Callable
    decode_step: Callable
    sub_quadratic: bool        # native O(S) decode state / windowed attention


def extra_inputs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, tuple]:
    """name -> (shape, dtype) of stub-frontend inputs."""
    if cfg.family == "vlm":
        return {"image_embeds": ((batch, cfg.num_image_tokens, cfg.d_model),
                                 getattr(torch, cfg.dtype))}
    if cfg.family == "audio":
        return {"audio_frames": ((batch, cfg.num_audio_frames, cfg.d_model),
                                 getattr(torch, cfg.dtype))}
    return {}


def build(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"family {fam!r} ({cfg.name}) is not ported yet: the port builds "
            "the dense, ssm and mamba-hybrid families; the others follow in "
            "ROADMAP Queue 1")
    if fam not in _MODULES:
        raise ValueError(f"unknown family {fam!r}")
    mod = _MODULES[fam]

    def init(gen):
        return mod.init(gen, cfg)

    def apply(params, tokens, extras=None, **kw):
        return mod.apply(params, cfg, tokens, **kw)

    def logits(params, hidden):
        return mod.logits_fn(params, cfg, hidden)

    def decode_init(params, batch, seq_len, extras=None, **kw):
        return mod.decode_init(params, cfg, batch, seq_len, **kw)

    def decode_step(params, cache, tokens, pos, **kw):
        return mod.decode_step(params, cfg, cache, tokens, pos, **kw)

    return Model(cfg=cfg, init=init, apply=apply, logits=logits,
                 decode_init=decode_init, decode_step=decode_step,
                 sub_quadratic=fam in ("ssm", "mamba-hybrid") or
                 cfg.window > 0)
