"""Flash attention: the hand-written Hopper kernels (``csrc/``: a
pipelined persistent forward, a one-launch fused backward for short
sequences and a three-pass backward for long ones), their plain PyTorch
version and the wrappers.

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/flash_attention.py``
(``flash_attention_bhsd``; its oracle is ``flash_attention/ref.py``; the
model-layout wrapper is ``flash_attention/ops.py``).  For q [BH, Sq, D]
and k, v [BHkv, Sk, D] (GQA: query row bh reads KV row bh // group):

    o = softmax(mask(q k^T / sqrt(D))) v

with masked logits set to the finite -1e30, so a row that sees no key
gets the plain mean of v.  Masks count both positions from 0 (top-left
alignment): ``causal`` keeps k_pos <= q_pos, ``window`` keeps k_pos >
q_pos - window.

The kernels address every tensor through (batch, head, position) strides
with D contiguous, so :func:`flash_attention` on the model layout
[B, S, H, D] launches them on the caller's tensors, views included, and
allocates o, dq, dk and dv like their inputs: nothing is copied.
:func:`flash_attention_bhsd` is a view of its tensors in that layout.
Both wrappers take the plain version only for tensors on the CPU.  For
CUDA tensors they run an ``autograd.Function`` whose forward launches the
forward kernel (which also writes the row log-sum-exp) and whose backward
launches the fused or the three-pass backward, chosen by shape alone
(:func:`fused_backward`), or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCHES, build

SOURCES = tuple(Path(__file__).resolve().parent / "csrc" / f
                for f in ("fwd.cu", "bwd_fused.cu", "bwd_three_pass.cu"))
MASKED = -1e30          # the TPU kernel's NEG_INF
MAX_D = 128             # the kernels' largest register layout
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_S = ctypes.POINTER(ctypes.c_longlong)
_TAIL = [_S] + [_I] * 8 + [_F, _I, _P]


def load_library():
    """Build (first call) and load the kernel library; returns
    ``(library, build seconds, nvcc log)``."""
    global _LIB
    if _LIB is None:
        _LIB = build.bind_library("flash_attention", SOURCES, {
            "flash_attention_fwd_launch": [_P] * 5 + _TAIL,
            "flash_attention_bwd_fused_launch": [_P] * 9 + _TAIL,
            "flash_attention_bwd_fused_fits": [_I] * 3,
            "flash_attention_bwd_launch": [_P] * 10 + _TAIL})
    return _LIB


def fused_backward(Sq: int, Sk: int, D: int) -> bool:
    """Whether the backward of this shape runs the one-launch fused
    kernel (else the three-pass kernels): whether one of the
    shared-memory layouts that ``bwd_fused.cu`` compiles
    (``FA_FUSED_LAYOUTS``, the one place they are written) holds it.
    Asks the kernel library, so its first call builds it."""
    return bool(load_library()[0].flash_attention_bwd_fused_fits(Sq, Sk, D))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """The plain version: ``flash_attention/ref.py`` in torch (full
    softmax; GQA by repeating each KV row over its group)."""
    BH, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    group = BH // BHkv
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None], s, s.new_tensor(MASKED))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def attention_plain_model(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """:func:`attention_plain` on the model layout: q [B, Sq, Hq, D], k,
    v [B, Sk, Hkv, D] -> [B, Sq, Hq, D]."""
    B, Sq, Hq, D = q.shape

    def heads_first(t):
        return t.transpose(1, 2).reshape(-1, t.shape[1], D)
    o = attention_plain(heads_first(q), heads_first(k), heads_first(v),
                        causal=causal, window=window)
    return o.reshape(B, Hq, Sq, D).transpose(1, 2)


def _check(q, k, v, window):
    """q [B, Sq, Hq, D], k and v [B, Sk, Hkv, D]: one dtype and device,
    each contiguous in D, its other strides free."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} must be float32 or "
                            f"bfloat16 like q, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D "
                             f"[B, S, H, D], got {tuple(t.shape)}")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"in D, got strides {t.stride()}")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if tuple(v.shape) != (Bk, Sk, Hkv, Dk) or Bk != B or Dk != D or \
            Hkv == 0 or Hq % Hkv or Sk == 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         "(need k == v, the same B and D, Hq a multiple of "
                         "Hkv and Sk > 0)")
    if int(window) < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    if q.device.type == "cuda" and (D > MAX_D or B * Hq >= 2 ** 31 or
                                    B * Hq * Sq >= 2 ** 62):
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} exceeds "
                         f"the kernel's limits (D <= {MAX_D})")


def _args(q, k, tensors, causal, window):
    """The entry points' trailing arguments, stream excepted: each
    tensor's (batch, head, position) strides, in the entry point's order,
    then the problem."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    strides = [s for t in tensors for s in (t.stride(0), t.stride(2),
                                             t.stride(1))]
    return ((ctypes.c_longlong * len(strides))(*strides), B, Hq, Hkv, Sq,
            Sk, D, int(bool(causal)), int(window), 1.0 / math.sqrt(D),
            DTYPES[q.dtype])


def _forward(q, k, v, o, causal, window):
    """Launch the forward kernel on q, k, v into o; returns lse
    [B * Hq, Sq]."""
    lib = load_library()[0]
    B, Sq, Hq, _ = q.shape
    lse = torch.empty((B * Hq, Sq), dtype=torch.float32, device=q.device)
    build.launch(lib.flash_attention_fwd_launch, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 *_args(q, k, (q, k, v, o), causal, window))
    LAUNCHES["flash_attention"] += 1
    return lse


def _backward(q, k, v, o, do, lse, dq, dk, dv, causal, window):
    """Launch the backward kernels into dq, dk, dv: the fused one where
    the shape fits it, else the three passes.  Each launch also counts
    under its route, ``flash_attention_bwd_fused`` or ``_three_pass``."""
    lib = load_library()[0]
    tail = _args(q, k, (q, k, v, o, do, dq, dk, dv), causal, window)
    ptrs = [t.data_ptr() for t in (q, k, v, o, do)]
    outs = [t.data_ptr() for t in (dq, dk, dv)]
    if fused_backward(q.shape[1], k.shape[1], q.shape[3]):
        build.launch(lib.flash_attention_bwd_fused_launch, q.device, *ptrs,
                     lse.data_ptr(), *outs, *tail)
        LAUNCHES["flash_attention_bwd_fused"] += 1
    else:
        delta = torch.empty_like(lse)
        build.launch(lib.flash_attention_bwd_launch, q.device, *ptrs,
                     lse.data_ptr(), delta.data_ptr(), *outs, *tail)
        LAUNCHES["flash_attention_bwd_three_pass"] += 1
    LAUNCHES["flash_attention_bwd"] += 1


class _FlashAttentionFn(torch.autograd.Function):
    """q [B, Sq, Hq, D], k, v [B, Sk, Hkv, D], any strides with D
    contiguous.  o and the gradients are allocated like their inputs
    (``torch.empty_like``: the same strides where the input is dense,
    else contiguous)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o = torch.empty_like(q)
        lse = _forward(q, k, v, o, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1 and do.shape[-1] > 1:
            do = do.contiguous()             # the kernels need D contiguous
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        _backward(q, k, v, o, do, lse, dq, dk, dv, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout (``flash_attention/ops.py``): q [B, Sq, Hq, D]; k, v
    [B, Sk, Hkv, D] -> [B, Sq, Hq, D], differentiable in q, k and v.  Views
    are taken as they are (D contiguous, other strides free): on the card
    nothing is copied."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_plain_model(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttentionFn.apply(q, k, v, bool(causal), int(window))


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q [BH, Sq, D]; k, v [BHkv, Sk, D] -> [BH, Sq, D], differentiable in
    q, k and v; D contiguous, other strides free.  Query row bh reads KV
    row bh // (BH / BHkv), so these are the model layout's
    [BHkv, S, BH / BHkv, D] and [BHkv, S, 1, D] views of the same
    tensors, taken without a copy."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"flash_attention: {name} must be 3-D "
                             f"[BH, S, D], got {tuple(t.shape)}")
    BH, BHkv = q.shape[0], k.shape[0]
    if BHkv == 0 or BH % BHkv:
        raise ValueError(f"flash_attention: BH {BH} is not a multiple of "
                         f"BHkv {BHkv}")
    o = flash_attention(q.unflatten(0, (BHkv, BH // BHkv)).transpose(1, 2),
                        k.unsqueeze(2), v.unsqueeze(2), causal=causal,
                        window=window)
    return o.transpose(1, 2).flatten(0, 1)
