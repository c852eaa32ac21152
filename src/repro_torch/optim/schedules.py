"""Learning-rate schedules (pure functions of the step) — port of
``repro.optim.schedules``, computed in float32 as the reference does."""
from __future__ import annotations

import math

import torch


def make_schedule(kind: str, base_lr: float, warmup_steps: int,
                  total_steps: int):
    """``fn(step)`` -> the learning rate, a 0-d float32 CPU tensor: a linear
    warm-up from step 0 (nonzero at step 0), then ``constant``,
    ``linear`` or ``cosine`` decay to ``total_steps``."""
    warmup_steps = max(1, warmup_steps)
    if kind not in ("constant", "linear", "cosine"):
        raise ValueError(f"unknown schedule {kind!r}")

    def fn(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = (s + 1.0) / warmup_steps
        frac = (s - warmup_steps) / max(1, total_steps - warmup_steps)
        if kind == "constant":
            decay = torch.ones_like(s)
        elif kind == "linear":
            decay = torch.clamp(1.0 - frac, 0.0, 1.0)
        else:
            decay = 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(frac, 0.0,
                                                                 1.0)))
        return base_lr * torch.where(s < warmup_steps, warm, decay)

    return fn
