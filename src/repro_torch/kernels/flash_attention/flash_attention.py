"""Flash attention: the hand-written Hopper kernels (``csrc/``: the tiled
route's pipelined persistent forward, one-launch fused backward for short
sequences and three-pass backward for long ones; the short-query route's
split-Sk forward and backward for Sq <= 8 over long key sets; the wgmma
route's TMA and tensor-core forward and backward for bf16 causal
attention), their plain PyTorch version, the CPU emulations of the
short-query route's order of sums and of the wgmma route's rounding, and
the wrappers.

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
route's forward kernel (which also writes the row log-sum-exp) and whose
backward launches the route's backward (on the tiled route the fused or
the three-pass one, chosen by shape alone, :func:`fused_backward`), or
raises; nothing falls back.
:func:`attention_route` picks the route of both directions from the
shape, the dtype and the layout: ``short`` (``fwd_split.cu``,
``bwd_short.cu``: blocks split the keys, an integer ticket per row set
lets the last block of each combine the splits in a fixed order) for a
few query rows over a long key set; ``wgmma`` (``fwd_wgmma.cu``,
``bwd_wgmma.cu``: TMA loads, wgmma products on bf16 operands with
float32 accumulators, a deterministic two-launch backward) for bf16
causal attention at the LM's shapes; else ``tiled``.  ``LAUNCHES``
counts each forward under ``flash_attention_fwd_split``, ``_fwd_wgmma``
or ``_fwd_tiled`` and each backward under ``flash_attention_bwd_short``,
``_wgmma``, ``_fused`` or ``_three_pass``.

On the mesh, :func:`flash_attention` takes ``DTensor``s (its local-shard
entry, :func:`_flash_attention_local_shards`): the kernel runs on each
rank's local heads (q, k, v sharded on the head dim over a mesh dim,
Hq and Hkv both divisible by its ranks) or batch rows, or on the whole
tensors where they are replicated; the output keeps q's placements, and
the backward goes through the same entry.  Any other placements (the
query rows sharded: the kernel has no query offset, as the TPU kernel
has none) raise.  Its launches count also under
``flash_attention_sharded`` and ``flash_attention_bwd_sharded``.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import LAUNCHES, build
from repro_torch.sharding import tp

SOURCES = tuple(Path(__file__).resolve().parent / "csrc" / f
                for f in ("fwd.cu", "bwd_fused.cu", "bwd_three_pass.cu",
                          "fwd_split.cu", "bwd_short.cu", "fwd_wgmma.cu",
                          "bwd_wgmma.cu"))
MASKED = -1e30          # the TPU kernel's NEG_INF
MAX_D = 128             # the kernels' largest register layout
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the short-query route's constants (``csrc/short.cuh``): the most query
#: rows a head, the most rows of a GQA group (group x Sq padded to 4 or
#: 8), the warps of a block, each owning 32 x 32 / DM keys (DM: D rounded
#: up to 32, 64 or 128)
SHORT_MAX_SQ = 8
SHORT_MAX_ROWS = 32
SHORT_WARPS = 4
#: the shortest key set the short route takes: from 64 keys on it beats
#: the tiled route on the card at Sq 1, 4 and 8, forward and forward plus
#: backward, at the set mixer's BH 208 and 12 (PERF.md, PR 20:
#: ``scripts/attention_routes.py``); below, the tiled kernels' one block
#: a head is the shorter path
SHORT_MIN_SK = 64
#: the wgmma route's constants (``csrc/fwd_wgmma.cu``, ``bwd_wgmma.cu``):
#: the fewest query rows it takes (one warpgroup's 64 rows), the keys of
#: a forward tile (the online softmax rescales once a tile, so the
#: emulation rounds P against the same running maximum) and the rows of
#: one record of the backward's row statistics
WGMMA_MIN_SQ = 64
WGMMA_KT = 128
WGMMA_ROWS = 64
_LIB = None
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
#: set while the local-shard entry launches: its launches count there too
_LOCAL_SHARDS = False
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_S = ctypes.POINTER(ctypes.c_longlong)
_TAIL = [_S] + [_I] * 8 + [_F, _I, _P]
_SPLIT_TAIL = [_S] + [_I] * 8 + [_F, _I, _I, _P]


def load_library():
    """Build (first call) and load the kernel library; returns
    ``(library, build seconds, nvcc log)``."""
    global _LIB
    if _LIB is None:
        _LIB = build.bind_library("flash_attention", SOURCES, {
            "flash_attention_fwd_launch": [_P] * 5 + _TAIL,
            "flash_attention_bwd_fused_launch": [_P] * 9 + _TAIL,
            "flash_attention_bwd_fused_fits": [_I] * 3,
            "flash_attention_bwd_launch": [_P] * 10 + _TAIL,
            "flash_attention_fwd_split_launch": [_P] * 7 + _SPLIT_TAIL,
            "flash_attention_bwd_short_launch": [_P] * 11 + _SPLIT_TAIL,
            "flash_attention_fwd_wgmma_launch": [_P] * 5 + _TAIL,
            "flash_attention_bwd_wgmma_launch": [_P] * 10 + _TAIL})
    return _LIB


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def attention_route(Sq: int, Sk: int, D: int, group: int,
                    dtype: torch.dtype = torch.float32, *,
                    causal: bool = True, window: int = 0,
                    aligned: bool = True) -> Tuple[str, int]:
    """The route of a problem of Sq query rows a head over Sk keys at
    head dimension D, with ``group`` query heads a KV head, in ``dtype``
    under the mask (``causal``, ``window``), its tensors on TMA's 16-byte
    grid or not (``aligned``, :func:`tma_aligned`), and the short route's
    split (keys a block; 0 on the other routes).

    ``short`` where Sq <= ``SHORT_MAX_SQ``, the group's rows padded to 4
    or 8 a head are at most ``SHORT_MAX_ROWS``, D <= ``MAX_D`` and Sk >=
    ``SHORT_MIN_SK``; its split is :func:`short_split`'s (128 keys at D <=
    32, 64 at D <= 64, 32 at D <= 128), the one value the kernels take.
    ``wgmma`` where the dtype is bf16, the mask causal, D a multiple of 16
    up to ``MAX_D``, Sq >= ``WGMMA_MIN_SQ``, every row sees a key (a
    window leaves the last rows none where Sq - window >= Sk) and the
    tensors are aligned.  Else ``tiled``, whose backward is fused or three
    passes (:func:`fused_backward`)."""
    padded = 4 if Sq <= 4 else 8
    if Sq <= SHORT_MAX_SQ and group * padded <= SHORT_MAX_ROWS and \
            D <= MAX_D and Sk >= SHORT_MIN_SK:
        return "short", short_split(D)
    if dtype == torch.bfloat16 and causal and D % 16 == 0 and \
            D <= MAX_D and Sq >= WGMMA_MIN_SQ and aligned and \
            not (window and Sq - window >= Sk):
        return "wgmma", 0
    return "tiled", 0


def tma_aligned(*tensors: torch.Tensor) -> bool:
    """Whether [B, S, H, D] tensors (D contiguous) sit on TMA's 16-byte
    grid: each base address and each batch, head and position stride (in
    bytes, positive) a multiple of 16, and a row of D elements too (the
    condition of ``csrc/wgmma.cuh``'s ``takes``)."""
    for t in tensors:
        esize = t.element_size()
        if t.data_ptr() % 16 or (t.shape[-1] * esize) % 16:
            return False
        for d in (0, 1, 2):
            if t.stride(d) <= 0 or (t.stride(d) * esize) % 16:
                return False
    return True


def short_split(D: int) -> int:
    """The short route's split at head dimension D <= ``MAX_D``: the keys
    of a block, ``SHORT_WARPS`` warps of 32 x 32 / DM keys each (DM: D
    rounded up to 32, 64 or 128)."""
    dm = 32 if D <= 32 else 64 if D <= 64 else 128
    return SHORT_WARPS * 32 * 32 // dm


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


def _visible(Sq: int, Sk: int, causal: bool, window: int, device):
    """[Sq, Sk]: whether query position q sees key position k."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    vis = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        vis &= k_pos <= q_pos
    if window:
        vis &= k_pos > q_pos - window
    return vis


def _fma(a, b, c):
    """fmaf(a, b, c) on float32 tensors: a * b + c in float64 (the product
    is exact there) rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _dot_in_order(x, y):
    """sum_i x[..., i] y[..., i] (x and y broadcast against each other) as
    the kernels chain it: fmaf over i in index order from 0.  In the
    emulation's place ``torch.einsum`` would leave the order of sums and
    the fusing to the host's BLAS kernel, which differ between CPUs."""
    out = x[..., 0] * y[..., 0]
    for i in range(1, x.shape[-1]):
        out = _fma(x[..., i], y[..., i], out)
    return out


def _lanes_per_key(D: int) -> int:
    """The short route's CPK: lanes sharing a key, DM / 32 (DM: D rounded
    up to 32, 64 or 128)."""
    return 128 // short_split(D)


def _lane_dots(x, y, D: int):
    """The kernels' dot product over the head dimension: CPK lanes share a
    key, lane c chaining the columns of its 4-column chunks c, c + CPK, c
    + 2 CPK, .. (``short.cuh``), then the lanes' sums added as
    ``key_sum``'s butterfly adds them ((0 + 1) + (2 + 3))."""
    cpk = _lanes_per_key(D)
    parts = []
    for c in range(cpk):
        cols = [col for u in range(c, 32 * cpk // 4, cpk)
                for col in range(4 * u, 4 * u + 4) if col < D]
        parts.append(_dot_in_order(x[..., cols], y[..., cols]))
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _warp_sum(x):
    """x [..., 32] summed as ``warp_sum``'s butterfly sums a warp's lanes
    (offsets 16, 8, 4, 2, 1): the value lane 0 ends with."""
    lanes = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ off]
    return x[..., 0]


def _merge_in_order(m, l, acc):
    """Softmax partials (m, l [..., n]; acc [..., n, D]) merged over n in
    index order against their common maximum, as the kernel merges its
    warps (``lb += l * wt`` and ``ab += acc * wt``, each one fmaf)."""
    mx = m.amax(-1)
    wt = torch.exp(m - mx[..., None])
    lt = torch.zeros_like(mx)
    at = torch.zeros_like(acc[..., 0, :])
    for i in range(m.shape[-1]):
        lt = _fma(l[..., i], wt[..., i], lt)
        at = _fma(acc[..., i, :], wt[..., i, None], at)
    return mx, lt, at


def _merge_online(m, l, acc):
    """The same merge online, as the kernel's last block merges the
    splits: a running maximum rescales the running sums (``lt * a + l *
    wt``, the first product fused into the sum)."""
    mx = torch.full_like(m[..., 0], MASKED)
    lt = torch.zeros_like(mx)
    at = torch.zeros_like(acc[..., 0, :])
    for i in range(m.shape[-1]):
        mn = torch.maximum(mx, m[..., i])
        a, wt = torch.exp(mx - mn), torch.exp(m[..., i] - mn)
        lt = _fma(lt, a, l[..., i] * wt)
        at = _fma(at, a[..., None], acc[..., i, :] * wt[..., None])
        mx = mn
    return mx, lt, at


def _sum_in_order(x, dim):
    """x summed over ``dim`` one index after the other."""
    out = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        out = out + x.select(dim, i)
    return out


def attention_split_blocked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, split: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The short-query forward kernel's arithmetic in its order, in torch:
    (o, lse) for q [BH, Sq, D] and k, v [BHkv, Sk, D], as ``split``
    (:func:`attention_route`) launches it.

    Block s of a head holds keys s * split .. s * split + split - 1, its
    ``SHORT_WARPS`` warps one tile of split / ``SHORT_WARPS`` keys each.
    A score is the lanes' chained products (:func:`_lane_dots`) times
    1/sqrt(D).  A warp's partial is its tile's row maximum m (keys past Sk
    left out, -1e30 the floor), l = the sum of p = exp(s - m) in key order
    and acc = P V chained in key order; the warps' partials merge in warp
    order into the block's, against their common maximum, and the blocks'
    in split order, online (a running maximum rescales the running sums);
    then o = acc / max(l, 1e-30) and lse = m + log(l).  Every product
    chain is fmaf in the kernel's order (:func:`_fma`), so the emulation
    gives the same bits on every host."""
    BH, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    group = BH // BHkv
    W, kt, S = SHORT_WARPS, split // SHORT_WARPS, _cdiv(Sk, split)
    n = S * split
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    kf = k.float().repeat_interleave(group, dim=0)
    vf = F.pad(v.float().repeat_interleave(group, dim=0), (0, 0, 0, n - Sk))
    s = _lane_dots(q.float()[:, :, None], kf[:, None], D) * scale
    s = torch.where(_visible(Sq, Sk, causal, window, q.device), s,
                    s.new_tensor(MASKED))
    s = F.pad(s, (0, n - Sk), value=MASKED).reshape(BH, Sq, S, W, kt)
    valid = (torch.arange(n, device=q.device) < Sk).reshape(S, W, kt)
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), s.new_tensor(0.0))
    # acc[b, q, s, w, d] = sum_k p[b, q, s, w, k] v[b, s, w, k, d]
    acc = _dot_in_order(p[..., None, :], vf.reshape(BH, S, W, kt, D)
                        .transpose(-1, -2)[:, None])
    m, l, acc = _merge_online(*_merge_in_order(m, _sum_in_order(p, -1),
                                               acc))
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.to(q.dtype), m + torch.log(l)


def attention_split_blocked_bwd(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, o: torch.Tensor,
                                do: torch.Tensor, lse: torch.Tensor, *,
                                causal: bool = True, window: int = 0,
                                split: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor,
                                                     torch.Tensor]:
    """The short-query backward kernel's arithmetic in its order, in
    torch: (dq, dk, dv) for the forward's o and lse [BH, Sq] and the
    cotangent do, as ``split`` launches it.

    With q scaled by 1/sqrt(D) first, delta = rowsum(dO * O) (each lane's
    columns chained, the lanes summed as ``warp_sum``), p = exp(s - lse)
    on the keys a row sees (1/Sk on every key for a row that sees none),
    dS = p (dP - delta) on the keys it sees (s and dP as the forward's
    scores): dV and dK chain the group's heads and rows in order; dQ
    chains each warp's tile, sums the warps in warp order and the splits
    in split order, then scales by 1/sqrt(D).  Every product chain is
    fmaf in the kernel's order (:func:`_fma`)."""
    BH, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    group = BH // BHkv
    W, kt, S = SHORT_WARPS, split // SHORT_WARPS, _cdiv(Sk, split)
    n = S * split
    cpk = _lanes_per_key(D)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    qs, dof = q.float() * scale, do.float()
    # lane l chains columns l, l + 32, ..; the lanes then meet by butterfly
    po = F.pad(o.float(), (0, 32 * cpk - D)).unflatten(-1, (cpk, 32))
    pg = F.pad(dof, (0, 32 * cpk - D)).unflatten(-1, (cpk, 32))
    delta = _warp_sum(_dot_in_order(po.transpose(-1, -2),
                                    pg.transpose(-1, -2)))
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    s = _lane_dots(qs[:, :, None], kf[:, None], D)
    dp = _lane_dots(dof[:, :, None], vf[:, None], D)
    vis = _visible(Sq, Sk, causal, window, q.device)
    zero = s.new_tensor(0.0)
    p = torch.where(vis, torch.exp(s - lse[..., None]), zero)
    p = torch.where(vis.any(-1)[:, None], p,
                    s.new_tensor(1.0) / s.new_tensor(float(Sk)))
    ds = torch.where(vis, p * (dp - delta[..., None]), zero)

    def over_rows(a, b):
        """[BHkv, k, d]: a[h, q, k] b[h, q, d] chained over the group's
        heads and their rows, in order."""
        a = a.reshape(BHkv, group * Sq, Sk).transpose(1, 2)
        b = b.reshape(BHkv, group * Sq, D).transpose(1, 2)
        return _dot_in_order(a[:, :, None], b[:, None])
    dv, dk = over_rows(p, dof), over_rows(ds, qs)
    dsp = F.pad(ds, (0, n - Sk)).reshape(BH, Sq, S, W, kt)
    kp = F.pad(kf, (0, 0, 0, n - Sk)).reshape(BH, S, W, kt, D)
    dq = _dot_in_order(dsp[..., None, :], kp.transpose(-1, -2)[:, None])
    dq = _sum_in_order(_sum_in_order(dq, 3), 2) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _exact_bmm(a, b):
    """a @ b over the last two dims, summed in float64 and rounded once to
    float32: the emulation of a tensor-core product with a float32
    accumulator, whose order of sums it leaves out (the host's BLAS order
    can then move no float32 bit)."""
    return torch.matmul(a.double(), b.double()).float()


def _bf16(x):
    """x rounded to bf16, back in float32: P and dS as the wgmma route
    feeds them to its second products."""
    return x.to(torch.bfloat16).float()


def attention_wgmma_blocked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wgmma route's forward arithmetic in torch: (o, lse) for bf16 q
    [BH, Sq, D] and k, v [BHkv, Sk, D], as ``fwd_wgmma.cu`` rounds it.

    S = q k^T in float32 (the bf16 products summed exactly), masked
    scores -inf; over key tiles of ``WGMMA_KT`` keys from key 0, the
    running maximum m of S scale log2(e) (0 stands in for a row's -inf),
    p = exp2(S scale log2(e) - m), l = l alpha + rowsum(p) in float32, and
    acc = acc alpha + bf16(p) v: P is rounded to bf16 once, against the
    running maximum of its tile.  Then o = acc / max(l, 1e-30), lse = (m +
    log2(l)) ln 2.  A row that sees no key is outside the route."""
    BH, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    group = BH // BHkv
    sl2 = torch.tensor(1.0 / math.sqrt(D) * math.log2(math.e),
                       dtype=torch.float32)
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    s = _exact_bmm(q.float(), kf.transpose(1, 2))
    s = torch.where(_visible(Sq, Sk, causal, window, q.device), s,
                    s.new_tensor(-math.inf))
    m = torch.full((BH, Sq), -math.inf)
    l = torch.zeros((BH, Sq))
    acc = torch.zeros((BH, Sq, D))
    for n0 in range(0, Sk, WGMMA_KT):
        st = s[..., n0:n0 + WGMMA_KT]
        mn = torch.maximum(m, st.amax(-1) * sl2)
        mu = torch.where(mn == -math.inf, torch.zeros_like(mn), mn)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(st * sl2 - mu[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _exact_bmm(_bf16(p),
                                                  vf[:, n0:n0 + WGMMA_KT])
        m = mn
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.to(q.dtype), (m + torch.log2(l)) * math.log(2.0)


def attention_wgmma_blocked_bwd(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, o: torch.Tensor,
                                do: torch.Tensor, lse: torch.Tensor, *,
                                causal: bool = True, window: int = 0
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The wgmma route's backward arithmetic in torch: (dq, dk, dv) for
    the forward's o and lse and the cotangent do, as ``bwd_wgmma.cu``
    rounds it.

    delta = rowsum(dO o) in float32; P = exp2(S scale log2(e) - lse
    log2(e)) on the keys a row sees, else 0, rounded to bf16; dP = dO
    v^T; dS = P (dP - delta) rounded to bf16; then dv = P^T dO, dk =
    scale dS^T q (both summed over the group's heads) and dq = scale dS k:
    P and dS are rounded to bf16 once, everything else is float32."""
    BH, Sq, D = q.shape
    BHkv, Sk, _ = k.shape
    group = BH // BHkv
    scale = 1.0 / math.sqrt(D)
    log2e = math.log2(math.e)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    s = _exact_bmm(qf, kf.transpose(1, 2))
    p = torch.exp2(s * torch.tensor(scale * log2e, dtype=torch.float32)
                   - (lse * log2e)[..., None])
    p = torch.where(_visible(Sq, Sk, causal, window, q.device), p,
                    p.new_tensor(0.0))
    p = _bf16(p)
    delta = (dof.double() * o.double()).sum(-1).float()
    ds = _bf16(p * (_exact_bmm(dof, vf.transpose(1, 2)) - delta[..., None]))
    dq = _exact_bmm(ds, kf) * scale

    def over_group(x):
        return x.reshape(BHkv, group, Sk, D).double().sum(1).float()
    dv = over_group(_exact_bmm(p.transpose(1, 2), dof))
    dk = over_group(_exact_bmm(ds.transpose(1, 2), qf)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _tickets(device, n: int) -> torch.Tensor:
    """The short route's tickets (one per row set) on ``device`` and its
    current stream: zeros once, put back to zero by every launch."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 256), dtype=torch.int32,
                                        device=device)
    return t


def _route(q, k, v, causal, window):
    B, Sq, Hq, D = q.shape
    return attention_route(Sq, k.shape[1], D, Hq // k.shape[2], q.dtype,
                           causal=causal, window=window,
                           aligned=tma_aligned(q, k, v))


def _wgmma_rows_see_keys(q, k, window):
    """The wgmma kernels leave out the -1e30 of a row that sees no key:
    :func:`attention_route` keeps such problems off the route."""
    Sq, Sk = q.shape[1], k.shape[1]
    assert not (window and Sq - window >= Sk), \
        f"wgmma route: a row sees no key (Sq {Sq}, Sk {Sk}, window {window})"


def _forward(q, k, v, o, causal, window):
    """Launch the forward kernel of the shape's route on q, k, v into o;
    returns lse [B * Hq, Sq].  Counts under ``flash_attention`` and the
    route, ``flash_attention_fwd_split``, ``_fwd_wgmma`` or
    ``_fwd_tiled``."""
    lib = load_library()[0]
    B, Sq, Hq, D = q.shape
    lse = torch.empty((B * Hq, Sq), dtype=torch.float32, device=q.device)
    tail = _args(q, k, (q, k, v, o), causal, window)
    ptrs = [t.data_ptr() for t in (q, k, v, o, lse)]
    route, split = _route(q, k, v, causal, window)
    if route == "short":
        part = torch.empty((B * Hq * _cdiv(k.shape[1], split) * Sq
                            * (D + 2),), dtype=torch.float32,
                           device=q.device)
        build.launch(lib.flash_attention_fwd_split_launch, q.device, *ptrs,
                     part.data_ptr(), _tickets(q.device, B * Hq).data_ptr(),
                     *tail, split)
        LAUNCHES["flash_attention_fwd_split"] += 1
    elif route == "wgmma":
        _wgmma_rows_see_keys(q, k, window)
        build.launch(lib.flash_attention_fwd_wgmma_launch, q.device, *ptrs,
                     *tail)
        LAUNCHES["flash_attention_fwd_wgmma"] += 1
    else:
        build.launch(lib.flash_attention_fwd_launch, q.device, *ptrs, *tail)
        LAUNCHES["flash_attention_fwd_tiled"] += 1
    LAUNCHES["flash_attention"] += 1
    return lse


def _backward(q, k, v, o, do, lse, dq, dk, dv, causal, window):
    """Launch the backward kernels of the shape's route into dq, dk, dv:
    on the short route its one launch; on the wgmma route its two (dq
    with the row statistics, then dk and dv), dO first copied onto the
    16-byte grid where it is off it; on the tiled route the fused one
    where the shape fits it, else the three passes.  Each launch also
    counts under its route, ``flash_attention_bwd_short``, ``_wgmma``,
    ``_fused`` or ``_three_pass``."""
    lib = load_library()[0]
    route, split = _route(q, k, v, causal, window)
    if route == "wgmma" and not tma_aligned(do):
        do = do.contiguous()
    tail = _args(q, k, (q, k, v, o, do, dq, dk, dv), causal, window)
    ptrs = [t.data_ptr() for t in (q, k, v, o, do)]
    outs = [t.data_ptr() for t in (dq, dk, dv)]
    if route == "short":
        B, Sq, Hq, D = q.shape
        part = torch.empty((B * Hq * _cdiv(k.shape[1], split) * Sq * D,),
                           dtype=torch.float32, device=q.device)
        build.launch(lib.flash_attention_bwd_short_launch, q.device, *ptrs,
                     lse.data_ptr(), *outs, part.data_ptr(),
                     _tickets(q.device, B * k.shape[2]).data_ptr(), *tail,
                     split)
        LAUNCHES["flash_attention_bwd_short"] += 1
    elif route == "wgmma":
        _wgmma_rows_see_keys(q, k, window)
        B, Sq, Hq, _ = q.shape
        rows = _cdiv(Sq, WGMMA_ROWS) * WGMMA_ROWS
        stats = torch.empty((B * Hq * 2 * rows,), dtype=torch.float32,
                            device=q.device)
        build.launch(lib.flash_attention_bwd_wgmma_launch, q.device, *ptrs,
                     lse.data_ptr(), stats.data_ptr(), *outs, *tail)
        LAUNCHES["flash_attention_bwd_wgmma"] += 1
    elif fused_backward(q.shape[1], k.shape[1], q.shape[3]):
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
        ctx.local_shards = _LOCAL_SHARDS
        if _LOCAL_SHARDS:
            LAUNCHES["flash_attention_sharded"] += 1
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1 and do.shape[-1] > 1:
            do = do.contiguous()             # the kernels need D contiguous
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        _backward(q, k, v, o, do, lse, dq, dk, dv, ctx.causal, ctx.window)
        if ctx.local_shards:
            LAUNCHES["flash_attention_bwd_sharded"] += 1
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout (``flash_attention/ops.py``): q [B, Sq, Hq, D]; k, v
    [B, Sk, Hkv, D] -> [B, Sq, Hq, D], differentiable in q, k and v.  Views
    are taken as they are (D contiguous, other strides free): on the card
    nothing is copied.  ``DTensor``s on a mesh go through the local-shard
    entry (:func:`_flash_attention_local_shards`)."""
    if isinstance(q, DTensor):
        return _flash_attention_local_shards(q, k, v, causal, window)
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_plain_model(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttentionFn.apply(q, k, v, bool(causal), int(window))


def _local_kernel(q, k, v, *, causal, window):
    global _LOCAL_SHARDS
    outer, _LOCAL_SHARDS = _LOCAL_SHARDS, True
    try:
        return flash_attention(q, k, v, causal=causal, window=window)
    finally:
        _LOCAL_SHARDS = outer


def _flash_attention_local_shards(q, k, v, causal, window):
    """The local-shard entry: q [B, Sq, Hq, D], k and v [B, Sk, Hkv, D]
    ``DTensor``s whose placements on each mesh dim are all ``Replicate``,
    all ``Shard(0)`` (batch rows) or all ``Shard(2)`` (heads; Hq and Hkv
    divisible by the dim's ranks, so each rank's query heads read its own
    KV heads).  The kernel (its plain version on CPU tensors) runs on
    each rank's local tensors, forward and backward, the output in q's
    placements.  Other placements raise ``ValueError``
    (``sharding.tp.attention_layout``): nothing is gathered here and
    nothing falls back."""
    return tp.attend_local(_local_kernel, q, k, v, seq_ok=False,
                           causal=bool(causal), window=int(window))


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
