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

The port builds every family of the reference: ``dense`` and ``moe``
(``models/transformer.py``, its MoE blocks from ``models/moe.py``),
``ssm`` (``models/xlstm.py``), ``mamba-hybrid`` (``models/hybrid.py``),
``vlm`` (``models/vlm.py``) and ``audio`` (``models/encdec.py``).  The
last two read their stub frontend's embeddings from ``extras``
(``image_embeds``, ``audio_frames``; :func:`extra_inputs`): ``apply``
raises ``KeyError`` without them, as the reference does, and
``decode_init`` takes zeros.  An unknown family keeps the reference's
``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, transformer, vlm, xlstm

#: the families' modules
_MODULES = {"dense": transformer, "moe": transformer, "ssm": xlstm,
            "mamba-hybrid": hybrid, "vlm": vlm, "audio": encdec}

#: the stub-frontend input each cross-attention family reads
_EXTRA = {"vlm": "image_embeds", "audio": "audio_frames"}


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
    if fam not in _MODULES:
        raise ValueError(f"unknown family {fam!r}")
    mod = _MODULES[fam]
    extra = _EXTRA.get(fam)

    def init(gen):
        return mod.init(gen, cfg)

    def apply(params, tokens, extras=None, **kw):
        if extra:
            return mod.apply(params, cfg, tokens, (extras or {})[extra], **kw)
        return mod.apply(params, cfg, tokens, **kw)

    def logits(params, hidden):
        return mod.logits_fn(params, cfg, hidden)

    def decode_init(params, batch, seq_len, extras=None, **kw):
        if extra:
            kw[extra] = (extras or {}).get(extra)
        return mod.decode_init(params, cfg, batch, seq_len, **kw)

    def decode_step(params, cache, tokens, pos, **kw):
        return mod.decode_step(params, cfg, cache, tokens, pos, **kw)

    return Model(cfg=cfg, init=init, apply=apply, logits=logits,
                 decode_init=decode_init, decode_step=decode_step,
                 sub_quadratic=fam in ("ssm", "mamba-hybrid") or
                 cfg.window > 0)
