"""Device resolution, the batched device-to-host pull and the
checkpointable state of a ``torch.Generator``; :func:`to_host` also
gathers a ``DTensor`` (a field of a fleet sharded over a
``torch.distributed`` mesh, :mod:`repro_torch.sharding.fleet`)."""
from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch.distributed.tensor import DTensor


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
    call costs one host sync however many tensors it brings back.  A
    ``DTensor`` (a sharded fleet's field) is gathered first, with one
    collective each (``full_tensor``): the one place where host code reads
    a sharded fleet whole, so every rank must make the same calls."""
    tensors = [t.full_tensor() if isinstance(t, DTensor) else t
               for t in tensors]
    outs = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    return [o.numpy() for o in outs]


def torch_rng_state(gen: torch.Generator) -> dict:
    """A ``torch.Generator``'s state with its device type: a CPU state
    (Mersenne Twister) and a CUDA one (Philox seed and offset) are
    different things and cannot stand in for each other."""
    return {"device": gen.device.type, "state": gen.get_state()}


def set_torch_rng_state(gen: torch.Generator, state: dict) -> None:
    if state["device"] != gen.device.type:
        raise ValueError(
            f"the checkpoint's generator state was made on a "
            f"{state['device']!r} device and cannot be restored into a "
            f"{gen.device.type!r} generator: resume on a {state['device']!r}"
            " device")
    gen.set_state(torch.as_tensor(state["state"]).cpu())
