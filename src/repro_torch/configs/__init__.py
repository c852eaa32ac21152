"""Architecture config registry.

``get_config(arch)`` returns the full-size :class:`ModelConfig`;
``get_smoke_config(arch)`` returns the reduced same-family variant used by
CPU smoke tests.  ``--arch`` flags resolve through :data:`REGISTRY`.

Copied from ``repro.configs`` with the module paths moved into the port.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig, ShapeConfig,
                                TrainConfig, reduced)

_MODULES = {
    "xlstm-1.3b": "xlstm_1_3b",
    "yi-34b": "yi_34b",
    "zamba2-1.2b": "zamba2_1_2b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "phi3-mini-3.8b": "phi3_mini",
    "mixtral-8x22b": "mixtral_8x22b",
    "minitron-8b": "minitron_8b",
    "command-r-35b": "command_r_35b",
    "whisper-medium": "whisper_medium",
    # the paper's own backbone (ResNet-18 + 4 exits) lives in drfl_resnet
    "drfl-resnet18": "drfl_resnet",
}


def list_archs():
    return [a for a in _MODULES if a != "drfl-resnet18"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))


REGISTRY: Dict[str, str] = dict(_MODULES)

__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "INPUT_SHAPES",
           "get_config", "get_smoke_config", "list_archs", "reduced",
           "REGISTRY"]
