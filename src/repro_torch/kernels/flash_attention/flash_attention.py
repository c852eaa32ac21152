"""Flash attention: the hand-written Hopper kernels
(``csrc/flash_attention.cu``, forward and an FA2-style backward), their
plain PyTorch version and the wrappers.

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

:func:`flash_attention_bhsd` takes the plain version only for tensors on
the CPU.  For CUDA tensors it runs ``_FlashAttentionFn``, whose forward
launches the forward kernel (which also writes the row log-sum-exp) and
whose backward launches the backward kernels, or raises; nothing falls
back.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCHES, build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)
MASKED = -1e30          # the TPU kernel's NEG_INF
MAX_D = 128             # the kernel's largest register layout
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def load_library():
    """Build (first call) and load the kernel library; returns
    ``(library, build seconds, nvcc log)``."""
    global _LIB
    if _LIB is None:
        _LIB = build.bind_library("flash_attention", SOURCES, {
            "flash_attention_fwd_launch": [_P] * 5 + [_I] * 7 + [_F, _I, _P],
            "flash_attention_bwd_launch": [_P] * 10 + [_I] * 7 + [_F, _I,
                                                                  _P]})
    return _LIB


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


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} must be float32 or "
                            f"bfloat16 like q, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
        if t.dim() != 3:
            raise ValueError(f"flash_attention: {name} must be 3-D "
                             f"[BH, S, D], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    BH, Sq, D = q.shape
    BHkv, Sk, Dk = k.shape
    if tuple(v.shape) != (BHkv, Sk, Dk) or Dk != D or BHkv == 0 or \
            BH % BHkv or Sk == 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         "(need k == v, the same D, BH a multiple of BHkv "
                         "and Sk > 0)")
    if int(window) < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    if q.device.type == "cuda" and (
            D > MAX_D or max(BH, BHkv) >= 2 ** 31 or
            max(q.numel(), k.numel()) >= 2 ** 62):
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} exceeds "
                         f"the kernel's limits (D <= {MAX_D})")


def _dims(q, k, causal, window):
    """The entry points' trailing arguments, stream excepted."""
    BH, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    return (BH, BHkv, Sq, Sk, D, int(bool(causal)), int(window),
            1.0 / math.sqrt(D), DTYPES[q.dtype])


def _forward(q, k, v, causal, window):
    lib = load_library()[0]
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    build.launch(lib.flash_attention_fwd_launch, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 *_dims(q, k, causal, window))
    LAUNCHES["flash_attention"] += 1
    return o, lse


def _backward(q, k, v, o, do, lse, causal, window):
    lib = load_library()[0]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    build.launch(lib.flash_attention_bwd_launch, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), *_dims(q, k, causal, window))
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = _forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, do.contiguous(), lse, ctx.causal,
                               ctx.window)
        return dq, dk, dv, None, None


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q [BH, Sq, D]; k, v [BHkv, Sk, D] -> [BH, Sq, D], differentiable in
    q, k and v."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttentionFn.apply(q, k, v, bool(causal), int(window))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout (``flash_attention/ops.py``): q [B, Sq, Hq, D]; k, v
    [B, Sk, Hkv, D] -> [B, Sq, Hq, D]."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape

    def heads_first(t, S, H):
        return t.transpose(1, 2).reshape(B * H, S, D).contiguous()
    o = flash_attention_bhsd(heads_first(q, Sq, Hq), heads_first(k, Sk, Hkv),
                             heads_first(v, Sk, Hkv), causal=causal,
                             window=window)
    return o.reshape(B, Hq, Sq, D).transpose(1, 2)
