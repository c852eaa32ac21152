"""RMSNorm: the hand-written Hopper kernels (``csrc/rmsnorm.cu``, forward
and backward), their plain PyTorch version and the wrappers.

Replaces the Pallas TPU kernel ``src/repro/kernels/rmsnorm/rmsnorm.py``
(``rmsnorm``; its oracle is ``rmsnorm/ref.py``; the model-layout wrapper
is ``rmsnorm/ops.py``).  For x [G, R, d] and one scale row per group,
scale [G, d]:

    y = x * rsqrt(mean(x^2, -1) + eps) * scale[g]

in float32, returned in x's type (float32 or bfloat16).  G is the
participant axis written out (each client trains its own scales); G = 1
with a [d] scale is the JAX interface, kept by :func:`rmsnorm_op` for the
model layout [..., d].

:func:`rmsnorm` takes the plain version only for tensors on the CPU.  For
CUDA tensors it runs ``_RMSNormFn``, whose forward launches the forward
kernel and whose backward launches the backward kernels, or raises;
nothing falls back.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCHES, build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu",)
EPS = 1e-5
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def load_library():
    """Build (first call) and load the kernel library; returns
    ``(library, build seconds, nvcc log)``."""
    global _LIB
    if _LIB is None:
        _LIB = build.bind_library("rmsnorm", SOURCES, {
            "rmsnorm_fwd_launch": [_P] * 4 + [_I] * 3 + [_F, _I, _P],
            "rmsnorm_bwd_launch": [_P] * 6 + [_I] * 4 + [_P]})
    return _LIB


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = EPS) -> torch.Tensor:
    """The plain version: ``rmsnorm/ref.py`` in torch.  x [..., d] with
    scale [d], or x [G, R, d] with scale [G, d]."""
    xf = x.float()
    s = scale.float()
    if s.dim() == 2:
        s = s[:, None, :]
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * s).to(x.dtype)


def _check(x, scale):
    if x.dtype not in DTYPES or scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm: x and scale must share float32 or "
                        f"bfloat16, got {x.dtype} and {scale.dtype}")
    if scale.device != x.device:
        raise ValueError(f"rmsnorm: scale is on {scale.device}, x on "
                         f"{x.device}")
    if x.dim() != 3 or scale.dim() != 2 or \
            tuple(scale.shape) != (x.shape[0], x.shape[2]):
        raise ValueError("rmsnorm: expected x [G,R,d] and scale [G,d]; got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    G, R, d = x.shape
    if G > 65535 or G * R * d >= 2 ** 62 or max(G * R, d) >= 2 ** 31:
        raise ValueError(f"rmsnorm: shape {tuple(x.shape)} exceeds the "
                         "kernel's launch limits")


def _forward(x, scale, eps):
    lib = load_library()[0]
    G, R, d = x.shape
    y = torch.empty_like(x)
    rstd = torch.empty((G, R), dtype=torch.float32, device=x.device)
    build.launch(lib.rmsnorm_fwd_launch, x.device, x.data_ptr(),
                 scale.data_ptr(), y.data_ptr(), rstd.data_ptr(), G, R, d,
                 float(eps), DTYPES[x.dtype])
    LAUNCHES["rmsnorm"] += 1
    return y, rstd


def _backward(x, scale, dy, rstd):
    lib = load_library()[0]
    G, R, d = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    build.launch(lib.rmsnorm_bwd_launch, x.device, x.data_ptr(),
                 scale.data_ptr(), dy.data_ptr(), rstd.data_ptr(),
                 dx.data_ptr(), dscale.data_ptr(), G, R, d, DTYPES[x.dtype])
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dscale


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        y, rstd = _forward(x, scale, eps)
        ctx.save_for_backward(x, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = _backward(x, scale, dy.contiguous(), rstd)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = EPS) -> torch.Tensor:
    """x [G, R, d], scale [G, d] -> [G, R, d], differentiable in both."""
    _check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    return _RMSNormFn.apply(x, scale, eps)


def rmsnorm_op(x: torch.Tensor, scale: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """Model layout: x [..., d], scale [d] (``rmsnorm/ops.py``)."""
    d = x.shape[-1]
    return rmsnorm(x.contiguous().reshape(1, -1, d), scale.reshape(1, d),
                   eps).reshape(x.shape)
