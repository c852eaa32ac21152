"""Mamba2 (SSD) block: a chunkwise-parallel scan for prefill and
training, an O(1)-state recurrent step for decode — port of
``repro.models.ssm``.

State-space recurrence per head h (head dim P, state dim N, ngroups=1):
    S_t = a_t * S_{t-1} + dt_t * B_t x_t^T          (S in R^{N x P})
    y_t = C_t^T S_t + D * x_t
with a_t = exp(-softplus(dt_raw) * exp(A_log)) in (0, 1).

The chunkwise algorithm (``ssm.py:74-115``) evaluates the interactions
within a chunk of ``cfg.ssm_chunk`` positions as a masked quadratic form
and carries the state between chunks; the reference's ``lax.scan`` over
chunks is a Python loop here.  Its three-operand ``einsum`` is two
products.  Params are plain dicts of tensors with the reference's names
and shapes; every function is ``nn``-free.  ``F.softplus`` returns x
above its threshold of 20 where ``jax.nn.softplus`` computes
``logaddexp(x, 0)``: the two differ there by under exp(-20), below
float32's spacing at 20.

On the production mesh (``launch/train.py::meshed_step``) the block's
params are ``DTensor``s and it runs as one tensor-parallel region
(:func:`_mamba_sharded`); its decode step too, on the state's shards
(:func:`_mamba_decode_sharded`, ``launch/train.py::meshed_serve_step``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import layers as L
from repro_torch.sharding import tp

CONV_K = 4  # causal depthwise conv kernel width


def mamba_dims(cfg):
    inner = cfg.ssm_expand * cfg.d_model
    P = 64 if inner % 64 == 0 else inner // max(1, cfg.num_heads)
    H = inner // P
    N = cfg.ssm_state
    return inner, H, P, N


def mamba_init(gen: torch.Generator, cfg, dtype, *, lead=()):
    """One Mamba2 block's params (``lead=(L,)``: the stack of L)."""
    d = cfg.d_model
    inner, H, P, N = mamba_dims(cfg)
    conv_dim = inner + 2 * N
    dev, lead = gen.device, tuple(lead)
    s = 1.0 / math.sqrt(d)

    def const(value, n):
        return L._leaf(torch.full(lead + (n,), value, dtype=torch.float32,
                                  device=dev))
    return {
        "norm": L.rmsnorm_init(d, dtype=dtype, device=dev, lead=lead),
        "w_in": L._normal(gen, (d, 2 * inner + 2 * N + H), s, dtype, lead),
        "conv_w": L._normal(gen, (conv_dim, CONV_K), 0.5, dtype, lead),
        "conv_b": L._leaf(torch.zeros(lead + (conv_dim,), dtype=dtype,
                                      device=dev)),
        "A_log": const(0.0, H),
        "dt_bias": const(-2.0, H),      # softplus(-2) ~ 0.13
        "D": const(1.0, H),
        "out_norm": L.rmsnorm_init(inner, dtype=dtype, device=dev, lead=lead),
        "w_out": L._normal(gen, (inner, d), 1.0 / math.sqrt(inner), dtype,
                           lead),
    }


def _causal_conv(x, w, b):
    """x: [B, S, C]; depthwise causal conv, kernel CONV_K, summed in the
    reference's order."""
    pad = F.pad(x, (0, 0, CONV_K - 1, 0))
    S = x.shape[1]
    out = sum(pad[:, i:i + S, :] * w[:, i] for i in range(CONV_K))
    return F.silu(out + b)


def _mamba_in(p, cfg, x):
    """The input norm and ``w_in``'s product z | xBC | dt (on the mesh:
    the norm's region and a column-parallel product)."""
    h = L.rmsnorm_apply(p["norm"], x, cfg.norm_eps)
    return L.dense_apply({"w": p["w_in"]}, h)


def _gates(p, dt_raw):
    dt = F.softplus(dt_raw + p["dt_bias"])                   # [B,S,H]
    log_a = -dt * torch.exp(p["A_log"])                      # [B,S,H] <= 0
    return dt, log_a


def _ssd_chunk_scan(xh, Bm, Cm, dt, log_a, D, chunk, state=None):
    """xh: [B, S, H, P]; Bm/Cm: [B, S, N]; dt/log_a: [B, S, H].

    Returns y [B, S, H, P] and the final state [B, H, N, P], float32."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0
    xf, Bf, Cf = xh.float(), Bm.float(), Cm.float()
    Sst = (torch.zeros((B, H, N, P), dtype=torch.float32, device=xh.device)
           if state is None else state)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=xh.device))[None, :, :, None]
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xc, Bc, Cc, dtc, lac = xf[:, sl], Bf[:, sl], Cf[:, sl], dt[:, sl], \
            log_a[:, sl]
        b = torch.cumsum(lac, dim=1)                          # [B,Q,H]
        total = b[:, -1]                                      # [B,H]
        # intra-chunk: scores[b,i,j,h] = (C_i . B_j) exp(b_i - b_j) dt_j
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)             # [B,Q,Q]
        dec = b[:, :, None, :] - b[:, None, :, :]             # [B,Q,Q,H]
        w = torch.where(tri, torch.exp(dec), 0.0) * dtc[:, None, :, :]
        scores = cb[..., None] * w
        y = torch.einsum("bijh,bjhp->bihp", scores, xc)       # [B,Q,H,P]
        # inter-chunk: y_i += exp(b_i) C_i . S_prev
        y = y + torch.exp(b)[..., None] * torch.einsum(
            "bin,bhnp->bihp", Cc, Sst)
        # the state at the chunk's end: the reference's "bjh,bjn,bjhp"
        # as two products
        wj = torch.exp(total[:, None] - b) * dtc              # [B,Q,H]
        Sst = torch.exp(total)[..., None, None] * Sst + torch.einsum(
            "bjn,bjhp->bhnp", Bc, wj[..., None] * xc)
        ys.append(y)
    y = torch.cat(ys, dim=1) + D[None, None, :, None] * xf
    return y, Sst


def _mamba_scan(p, cfg, zxbcdt, h0, h1, state=None):
    """The depthwise conv over every xBC channel and the SSD scan of heads
    [h0, h1) from the whole product ``zxbcdt`` [B, S, 2 inner + 2N + H]:
    (y [B, S, (h1 - h0) P] float32, the final state)."""
    inner, H, P, N = mamba_dims(cfg)
    B, S = zxbcdt.shape[:2]
    xbc = _causal_conv(zxbcdt[..., inner:inner + inner + 2 * N],
                       p["conv_w"], p["conv_b"])
    xh = xbc[..., :inner].reshape(B, S, H, P)[:, :, h0:h1]
    Bm = xbc[..., inner:inner + N]
    Cm = xbc[..., inner + N:]
    dt, log_a = _gates({k: p[k][h0:h1] for k in ("dt_bias", "A_log")},
                       zxbcdt[..., -H:].float()[..., h0:h1])
    y, Sf = _ssd_chunk_scan(xh, Bm, Cm, dt, log_a, p["D"][h0:h1],
                            cfg.ssm_chunk, state)
    return y.reshape(B, S, -1), Sf


def _mamba_out(p, cfg, y, z, rows=slice(None)):
    """``out_norm`` over the whole inner width, the z gate, and the
    product with ``w_out`` (the ``rows`` of y that ``p`` holds)."""
    y = L.rmsnorm_apply(p["out_norm"], y, cfg.norm_eps) * F.silu(z)
    return y[..., rows] @ p["w_out"]


def mamba_apply(p, cfg, x, state=None):
    """x: [B, S, d] -> (delta [B, S, d], the final SSM state).  On the
    mesh (``p`` and ``x`` ``DTensor``s) :func:`_mamba_sharded`'s region,
    from a zero state; the final state is not returned (None).  Decode
    carries its state through :func:`mamba_decode`, on the mesh too."""
    if isinstance(p["w_in"], DTensor):
        if state is not None:
            raise NotImplementedError("the Mamba2 block's chunked scan on "
                                      "the mesh starts from a zero state; "
                                      "a carried state steps through "
                                      "mamba_decode")
        return _mamba_sharded(p, cfg, x), None
    inner, H, _, _ = mamba_dims(cfg)
    zxbcdt = _mamba_in(p, cfg, x)
    y, Sf = _mamba_scan(p, cfg, zxbcdt, 0, H, state)
    return _mamba_out(p, cfg, y.to(x.dtype), zxbcdt[..., :inner]), Sf


def _mamba_sharded(p, cfg, x):
    """:func:`mamba_apply`'s stages on the mesh, x in the residual's
    placements.  The norm is ``rmsnorm_apply``'s region and ``w_in``
    column-parallel (``("embed", "mlp")``), whose even column blocks do
    not line up with the z | xBC | dt split: the product's columns are
    gathered over ``model`` once (an activation; no param is gathered).
    The depthwise conv (``conv_w`` replicated) runs on every channel, the
    SSD scan on this rank's heads where H divides the model axis, else on
    all of them; the scan's output is gathered for ``out_norm``, an RMS
    over the whole inner width, and ``w_out`` is row-parallel: the output
    a partial sum over ``model``.  Each rank feeds only its slice of the
    whole tensors into its heads and its rows of ``w_out``, so their
    gradients are partial over ``model``; where ``w_out`` is whole on
    every rank the block is replicated compute."""
    inner, H, _, _ = mamba_dims(cfg)
    m, r = tp.model_size(), tp.model_rank()
    rows = tp.model_shard_dim(p["w_out"]) == p["w_out"].ndim - 2
    G = Partial() if rows else Replicate()
    split = rows and H % m == 0
    zxbcdt = tp.local(_mamba_in(p, cfg, x), grad=G)
    w = {k: tp.weight(p[k], G) for k in ("conv_w", "conv_b", "A_log",
                                          "dt_bias", "D")}
    h0, h1 = (r * H // m, (r + 1) * H // m) if split else (0, H)
    y, _ = _mamba_scan(w, cfg, zxbcdt, h0, h1)
    y = y.to(x.dtype)
    if split:
        y = tp.local(tp.wrap(y, Shard(2)), grad=G)
    out = {"out_norm": {"scale": tp.weight(p["out_norm"]["scale"], G)},
           "w_out": tp.weight(p["w_out"])}
    lo, hi = tp.model_range(p["w_out"], p["w_out"].ndim - 2)
    return tp.wrap(_mamba_out(out, cfg, y, zxbcdt[..., :inner],
                              slice(lo, hi)), G)


def mamba_state_init(cfg, batch: int, device, *, lead=()):
    """``ssm`` [B, H, N, P] and the conv history ``conv`` [B, K-1, C],
    both float32 (``lead=(L,)``: one per layer)."""
    inner, H, P, N = mamba_dims(cfg)
    lead = tuple(lead)
    return {
        "ssm": L.cache_leaf(lead + (batch, H, N, P), 0, torch.float32,
                            device),
        "conv": L.cache_leaf(lead + (batch, CONV_K - 1, inner + 2 * N), 0,
                             torch.float32, device),
    }


def _conv_step(p, hist, xbc, c0, c1):
    """The depthwise conv's step on channels [c0, c1): ``hist`` [B, K-1,
    c1-c0] float32 the carried history of those channels, ``xbc`` [B, 1,
    C] the step's whole xBC.  Returns (the conv's output [B, c1-c0]
    float32, the new history)."""
    hist = torch.cat([hist, xbc[..., c0:c1].float()], dim=1)  # [B,K,c]
    out = sum(hist[:, i, :] * p["conv_w"][c0:c1, i].float()
              for i in range(CONV_K))
    return F.silu(out + p["conv_b"][c0:c1].float()), hist[:, 1:]


def _ssm_step(p, cfg, conv, dt_raw, S, h0, h1):
    """The SSM's step on heads [h0, h1) from the conv's whole output
    ``conv`` [B, C] and ``dt_raw`` [B, H] float32, ``S`` [B, h1-h0, N, P]
    those heads' state.  Returns (y [B, 1, (h1-h0) P] float32, the new
    state)."""
    inner, H, P, N = mamba_dims(cfg)
    B = conv.shape[0]
    xh = conv[:, :inner].reshape(B, H, P)[:, h0:h1]
    Bm, Cm = conv[:, inner:inner + N], conv[:, inner + N:]
    dt, log_a = _gates({k: p[k][h0:h1] for k in ("dt_bias", "A_log")},
                       dt_raw[:, h0:h1])
    a = torch.exp(log_a)
    # the reference's "bh,bn,bhp->bhnp" as two products
    S = a[..., None, None] * S + \
        Bm[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :]
    y = torch.einsum("bn,bhnp->bhp", Cm, S) + p["D"][h0:h1][None, :, None] * xh
    return y.reshape(B, 1, -1), S


def mamba_decode(p, cfg, x, state):
    """x: [B, 1, d]; one recurrent step.  Returns (delta, the new
    state); ``state`` is not written.  On the mesh
    (:func:`_mamba_decode_sharded`) the state's ``DTensor``s are written
    in place and returned."""
    if isinstance(p["w_in"], DTensor):
        return _mamba_decode_sharded(p, cfg, x, state), state
    inner, H, _, N = mamba_dims(cfg)
    zxbcdt = _mamba_in(p, cfg, x)
    conv, hist = _conv_step(p, state["conv"],
                            zxbcdt[..., inner:inner + inner + 2 * N], 0,
                            inner + 2 * N)
    y, Sst = _ssm_step(p, cfg, conv, zxbcdt[:, 0, -H:].float(),
                       state["ssm"], 0, H)
    return _mamba_out(p, cfg, y.to(x.dtype), zxbcdt[..., :inner]), \
        {"ssm": Sst, "conv": hist}


def _mamba_decode_sharded(p, cfg, x, state):
    """:func:`mamba_decode` on the mesh, x in the residual's placements
    and the state's leaves ``DTensor``s in the reference's placements
    (``rules.cache_specs``: ``conv`` [B, K-1, C] on its channels, ``ssm``
    [B, H, N, P] on its heads, each in even blocks where they divide the
    model axis).  ``w_in``'s column-parallel product z | xBC | dt is
    gathered over ``model`` once (an activation); each rank steps the
    depthwise conv on its block of the channels (which need not line up
    with the xBC split), writes its block of the history back, and the
    conv's output is gathered for the split; the SSM steps this rank's
    heads of the state, written back, and its output is gathered for
    ``out_norm`` (an RMS over the whole inner width); ``w_out`` is
    row-parallel: the delta a partial sum over ``model``.  No state
    leaf is gathered.  Returns the delta."""
    inner, H, _, N = mamba_dims(cfg)
    zxbcdt = tp.local(_mamba_in(p, cfg, x))
    z, xbc = zxbcdt[..., :inner], zxbcdt[..., inner:inner + inner + 2 * N]
    conv, ssm = state["conv"], state["ssm"]
    for t, ok in ((conv, (None, 2)), (ssm, (None, 1))):
        if tp.model_shard_dim(t) not in ok and tp.model_size() > 1:
            raise NotImplementedError(
                f"a Mamba2 decode state of shape {tuple(t.shape)} in "
                f"{tuple(t.placements)}: the mesh steps the conv on its "
                f"channels and the SSM on its heads")
    c0, c1 = tp.model_range(conv, conv.ndim - 1)
    w = {k: tp.weight(p[k]) for k in ("conv_w", "conv_b", "A_log",
                                       "dt_bias", "D")}
    out, hist = _conv_step(w, tp.local_of(conv), xbc, c0, c1)
    tp.put(conv, hist)
    if c1 - c0 < conv.shape[-1]:
        out = tp.whole(out, 1)
    h0, h1 = tp.model_range(ssm, 1)
    y, Sst = _ssm_step(w, cfg, out, zxbcdt[:, 0, -H:].float(),
                       tp.local_of(ssm), h0, h1)
    tp.put(ssm, Sst)
    y = y.to(zxbcdt.dtype)
    if h1 - h0 < H:
        y = tp.whole(y, 2)
    o = {"out_norm": {"scale": tp.weight(p["out_norm"]["scale"])},
         "w_out": tp.weight(p["w_out"])}
    rows = tp.model_shard_dim(p["w_out"]) == p["w_out"].ndim - 2
    lo, hi = tp.model_range(p["w_out"], p["w_out"].ndim - 2)
    return tp.wrap(_mamba_out(o, cfg, y, z, slice(lo, hi)),
                   Partial() if rows else Replicate())
