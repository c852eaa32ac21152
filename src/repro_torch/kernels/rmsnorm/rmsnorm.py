"""RMSNorm: the hand-written Hopper kernels (``csrc/rmsnorm.cu``, forward
and backward), their plain PyTorch version, the CPU emulation of the
backward's reduction order and the wrappers.

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
kernel and whose backward launches the backward kernel (one launch), or
raises; nothing falls back.  :func:`rmsnorm_route` picks each launch's
route (``vec`` or ``general``) from the shape and the pointers, and the
backward's split count from the card's SM count; ``LAUNCHES`` counts each
route (``rmsnorm_vec``, ``rmsnorm_general``, ``rmsnorm_bwd_vec``,
``rmsnorm_bwd_general``) beside the totals ``rmsnorm`` and
``rmsnorm_bwd``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels import LAUNCHES, build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu",)
EPS = 1e-5
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's constants (``csrc/rmsnorm.cu``): the vec route's widest
#: row, the backward's warps a block, its most splits of a group's rows,
#: the rows a warp takes at least (four, one batch of loads in flight:
#: fewer rows do not pay for the ticket's round trip), and the blocks an
#: SM should hold
VEC_MAX_D = 1024
BWD_WARPS = 8
MAX_SPLITS = 32
_MIN_ROWS_PER_WARP = 4
_BLOCKS_PER_SM = 4
_LIB = None
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def load_library():
    """Build (first call) and load the kernel library; returns
    ``(library, build seconds, nvcc log)``."""
    global _LIB
    if _LIB is None:
        _LIB = build.bind_library("rmsnorm", SOURCES, {
            "rmsnorm_fwd_launch": [_P] * 4 + [_I] * 3 + [_F, _I, _I, _P],
            "rmsnorm_bwd_launch": [_P] * 8 + [_I] * 6 + [_P]})
    return _LIB


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def rmsnorm_route(G: int, R: int, d: int, dtype: torch.dtype,
                  ptrs: Sequence[int], sms: int) -> Tuple[str, int]:
    """The route of a launch and the backward's splits of a group's rows.

    ``vec`` where a row is a whole number of 16-byte vectors (d a multiple
    of 4 in float32, of 8 in bfloat16), at most ``VEC_MAX_D`` wide, and
    every pointer (``ptrs``: the launch's tensors' addresses) is 16-byte
    aligned; else ``general``.  Splits: enough blocks of ``BWD_WARPS``
    warps for ``_BLOCKS_PER_SM`` a multiprocessor (``sms``) over the G
    groups, at most ``MAX_SPLITS`` and at least ``_MIN_ROWS_PER_WARP``
    rows a warp, then as few as cover R with the same rows a split (so no
    split is empty)."""
    vec = 16 // dtype.itemsize
    route = "vec" if (d % vec == 0 and d <= VEC_MAX_D
                      and all(p % 16 == 0 for p in ptrs)) else "general"
    if R == 0 or G == 0:
        return route, 1
    want = min(_cdiv(R, BWD_WARPS * _MIN_ROWS_PER_WARP),
               _cdiv(_BLOCKS_PER_SM * sms, G), MAX_SPLITS)
    return route, _cdiv(R, _cdiv(R, want))


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


def rmsnorm_bwd_blocked(x: torch.Tensor, scale: torch.Tensor,
                        dy: torch.Tensor, rstd: torch.Tensor, route: str,
                        splits: int, warps: int = BWD_WARPS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic in its order, in torch: (dx,
    dscale) for x, dy [G, R, d], scale [G, d] and the forward's rstd
    [G, R], as ``route`` and ``splits`` (:func:`rmsnorm_route`) launch it.

    Per row, c = sum of dy * s * x: each lane adds its own columns in
    order (on the vec route lane l holds the 16-byte vectors l, l + 32,
    ...; on the general route the columns l, l + 32, ...), then the xor
    shuffle adds the lanes.  dscale: each warp adds dy * x * r over its
    contiguous rows in row order, each block its warps in warp order, and
    the group's splits are added in split order.  Every product and sum is
    rounded on its own, as the kernel's ``__fmul_rn`` / ``__fadd_rn``."""
    G, R, d = x.shape
    if R == 0:
        return torch.empty_like(x), torch.zeros_like(scale)
    xf, dyf = x.float(), dy.float()
    sf = scale.float()[:, None, :]
    r = rstd.float()[..., None]
    vec = 16 // x.dtype.itemsize if route == "vec" else 1
    width = _cdiv(d, 32 * vec) * 32 * vec
    prod = torch.nn.functional.pad((dyf * sf) * xf, (0, width - d))
    prod = prod.reshape(G, R, width // (32 * vec), 32, vec)
    part = torch.zeros((G, R, 32), device=x.device)
    for k in range(prod.shape[2]):
        for e in range(vec):
            part = part + prod[:, :, k, :, e]
    lanes = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        part = part + part[..., lanes ^ o]
    kk = ((r * r) * r) * (part[..., :1] / d)
    dx = r * (dyf * sf) - xf * kk

    rps = _cdiv(R, splits)
    rpw = _cdiv(rps, warps)
    t = torch.nn.functional.pad((dyf * xf) * r, (0, 0, 0, splits * rps - R))
    t = torch.nn.functional.pad(t.reshape(G, splits, rps, d),
                                (0, 0, 0, warps * rpw - rps))
    t = t.reshape(G, splits, warps, rpw, d)
    acc = torch.zeros((G, splits, warps, d), device=x.device)
    for i in range(rpw):
        acc = acc + t[:, :, :, i]
    block = acc[:, :, 0]
    for w in range(1, warps):
        block = block + acc[:, :, w]
    dscale = block[:, 0]
    for s in range(1, splits):
        dscale = dscale + block[:, s]
    return dx.to(x.dtype), dscale.to(scale.dtype)


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
    # 32-bit row and column indices; the backward's G * splits blocks
    # (splits <= R) on grid.x
    if G * R * d >= 2 ** 62 or max(G, G * R, d) >= 2 ** 31:
        raise ValueError(f"rmsnorm: shape {tuple(x.shape)} exceeds the "
                         "kernel's launch limits")


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tickets(device, G: int) -> torch.Tensor:
    """The backward's per-group tickets on ``device`` and its current
    stream: zeros once, put back to zero by every launch."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < G:
        t = _TICKETS[key] = torch.zeros(max(G, 64), dtype=torch.int32,
                                        device=device)
    return t


def _forward(x, scale, eps):
    lib = load_library()[0]
    G, R, d = x.shape
    y = torch.empty_like(x)
    rstd = torch.empty((G, R), dtype=torch.float32, device=x.device)
    route, _ = rmsnorm_route(G, R, d, x.dtype, (x.data_ptr(),
                             scale.data_ptr(), y.data_ptr()),
                             _sm_count(x.device))
    build.launch(lib.rmsnorm_fwd_launch, x.device, x.data_ptr(),
                 scale.data_ptr(), y.data_ptr(), rstd.data_ptr(), G, R, d,
                 float(eps), int(route == "vec"), DTYPES[x.dtype])
    LAUNCHES["rmsnorm"] += 1
    LAUNCHES[f"rmsnorm_{route}"] += 1
    return y, rstd


def _backward(x, scale, dy, rstd):
    lib = load_library()[0]
    G, R, d = x.shape
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    route, splits = rmsnorm_route(
        G, R, d, x.dtype, (x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                           dx.data_ptr()), _sm_count(x.device))
    rows = G * splits * (1 + (BWD_WARPS if route == "general" else 0))
    scratch = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    build.launch(lib.rmsnorm_bwd_launch, x.device, x.data_ptr(),
                 scale.data_ptr(), dy.data_ptr(), rstd.data_ptr(),
                 dx.data_ptr(), dscale.data_ptr(), scratch.data_ptr(),
                 _tickets(x.device, G).data_ptr(), G, R, d, splits,
                 int(route == "vec"), DTYPES[x.dtype])
    LAUNCHES["rmsnorm_bwd"] += 1
    LAUNCHES[f"rmsnorm_bwd_{route}"] += 1
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
