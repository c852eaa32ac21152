"""Masked weighted mean over clients: the hand-written Hopper kernel
(``csrc/layer_agg.cu``), its plain PyTorch version and the wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/layer_agg/layer_agg.py``
(``layer_agg``; its oracle is ``layer_agg/ref.py``).  For U [N, R, D], M
[N, R], w [N], all float32:

    out[r, d] = sum_n w_n M[n,r] U[n,r,d] / max(sum_n w_n M[n,r], 1e-12)

and 0 where the denominator is 0.  The kernel reads U once, so it is
bound by memory bandwidth; the source note gives the bound.

:func:`layer_agg` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCHES, build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "layer_agg.cu",)
_LIB = None
_MAX_D = 65535 * 1024          # grid.y limit x the kernel's d chunk


def load_library():
    """Build (first call) and load the kernel library; returns
    ``(library, build seconds, nvcc log)``."""
    global _LIB
    if _LIB is None:
        _LIB = build.bind_library("layer_agg", SOURCES, {
            "layer_agg_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                 + [ctypes.c_void_p])})
    return _LIB


def layer_agg_plain(U: torch.Tensor, M: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """The plain version: a torch port of ``layer_agg/ref.py``."""
    wm = w[:, None].float() * M.float()                        # [N, R]
    num = torch.einsum("nl,nld->ld", wm, U.float())
    den = wm.sum(dim=0)[:, None]
    return torch.where(den > 0, num / torch.clamp_min(den, 1e-12),
                       torch.zeros_like(num))


def _check(U, M, w):
    for name, t in (("U", U), ("M", M), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"layer_agg: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != U.device:
            raise ValueError(f"layer_agg: {name} is on {t.device}, "
                             f"U on {U.device}")
        if not t.is_contiguous():
            raise ValueError(f"layer_agg: {name} must be contiguous")
    if U.dim() != 3 or M.dim() != 2 or w.dim() != 1:
        raise ValueError("layer_agg: expected U [N,R,D], M [N,R], w [N]; "
                         f"got {tuple(U.shape)}, {tuple(M.shape)}, "
                         f"{tuple(w.shape)}")
    N, R, D = U.shape
    if tuple(M.shape) != (N, R) or tuple(w.shape) != (N,):
        raise ValueError(f"layer_agg: M {tuple(M.shape)} / w "
                         f"{tuple(w.shape)} do not match U {tuple(U.shape)}")
    if D > _MAX_D or max(N, R, D) >= 2 ** 31:
        raise ValueError(f"layer_agg: shape {tuple(U.shape)} exceeds the "
                         "kernel's launch limits")


def layer_agg(U: torch.Tensor, M: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """[N,R,D], [N,R], [N] float32 -> [R,D] float32."""
    _check(U, M, w)
    if U.device.type == "cpu":
        return layer_agg_plain(U, M, w)
    if U.device.type != "cuda":
        raise ValueError(f"layer_agg: unsupported device {U.device}")
    lib = load_library()[0]
    N, R, D = U.shape
    out = torch.empty((R, D), dtype=torch.float32, device=U.device)
    build.launch(lib.layer_agg_launch, U.device, U.data_ptr(),
                 M.data_ptr(), w.data_ptr(), out.data_ptr(), N, R, D)
    LAUNCHES["layer_agg"] += 1
    return out
