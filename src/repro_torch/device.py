"""Device resolution and the batched device-to-host pull."""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``"cuda"`` (the default of every entry point) must find a card: the
    port never falls back to the CPU on its own.  Pass ``"cpu"`` to run
    there on purpose (the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for CUDA but torch.cuda."
            "is_available() is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """One batched pull: every copy is queued before the single wait, so a
    call costs one host sync however many tensors it brings back."""
    outs = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    return [o.numpy() for o in outs]
