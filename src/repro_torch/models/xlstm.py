"""xLSTM backbone (arXiv:2405.04517): alternating mLSTM / sLSTM blocks —
port of ``repro.models.xlstm`` (the ``ssm`` family: xlstm-1.3b).

* Even blocks: **mLSTM**, a per-head matrix memory ``C`` in R^{P x P}
  with an exponential input gate and a sigmoid forget gate; the
  chunkwise-parallel stabilised algorithm for prefill and training (a
  Python loop over ``S / ssm_chunk`` chunks carrying ``(C, n, m)``, where
  the reference runs ``lax.scan``), the O(1)-state recurrent step for
  decode.  P is ``ssm_expand * d / H`` (1024 at xlstm-1.3b), not the
  config's ``head_dim``.
* Odd blocks: **sLSTM**, scalar memory with block-diagonal (per-head)
  recurrent weights and an exponential-gating max-stabiliser; a Python
  loop over time (the recurrence is not associative).

The reference's three-operand ``einsum`` (the chunk's state update) is
two products, so no ``[B, H, Q, P, P]`` tensor is made.  The reference's
float32 upcasts are kept: the gate logits (``w_if``, float32), the sLSTM
input product (``w_in`` upcast), its float32 ``r`` and ``b``, and every
state.

Params are the reference's tree, ``nn``-free: ``mlstm`` and ``slstm``
stacks with a leading ``[L/2]`` axis.  The DR-FL ``layer_mask`` has
length ``num_layers`` and is consumed pairwise; ``remat != "none"``
recomputes each (mLSTM, sLSTM) pair in the backward (the reference's
``jax.checkpoint`` of the pair, no policy, so ``"dots"`` is ``"full"``).
The decode state is written in place, with the reference's step counter
``pos``.

On the production mesh (``launch/train.py::meshed_step``) the params are
``DTensor``s: the embedding is vocab-parallel and each block is a
tensor-parallel region (:func:`_mlstm_sharded`, :func:`_slstm_sharded`;
the sLSTM's time loop runs whole on every rank, with no collective in
it).  Decode runs there too, on the state's shards (:func:`_mlstm_decode_sharded`,
:func:`_slstm_decode_sharded`; ``launch/train.py::meshed_serve_step``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import layers as L
from repro_torch.models.layers import _normal
from repro_torch.models.transformer import (_dt, _gates, _remat_wrap,
                                            _residual, _unstack,
                                            decode_embed)
from repro_torch.sharding import tp
from repro_torch.sharding.rules import constrain

#: the reference's stabiliser floor, the initial ``m``
M_INIT = -1e30


def _pair_gates(cfg, layer_mask, device):
    """The ``[L]`` layer mask as ``[L/2, 2]``: (mLSTM, sLSTM) a pair."""
    return _gates(cfg, layer_mask, device).reshape(cfg.num_layers // 2, 2)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg):
    inner = cfg.ssm_expand * cfg.d_model
    return inner, cfg.num_heads, inner // cfg.num_heads


def mlstm_init(gen: torch.Generator, cfg, dtype, *, lead=()):
    d = cfg.d_model
    inner, H, _ = _mlstm_dims(cfg)
    dev, lead = gen.device, tuple(lead)
    s, si = 1.0 / math.sqrt(d), 1.0 / math.sqrt(inner)
    b_if = torch.cat([torch.zeros((H,)), 3.0 * torch.ones((H,))]).to(dev)
    return {
        "norm": L.rmsnorm_init(d, dtype=dtype, device=dev, lead=lead),
        "w_up": _normal(gen, (d, 2 * inner), s, dtype, lead),   # u ++ z(gate)
        "wq": _normal(gen, (inner, inner), si, dtype, lead),
        "wk": _normal(gen, (inner, inner), si, dtype, lead),
        "wv": _normal(gen, (inner, inner), si, dtype, lead),
        "w_if": _normal(gen, (d, 2 * H), s, torch.float32, lead),  # i, f
        "b_if": L._leaf(b_if.expand(lead + (2 * H,)).clone()),
        "out_norm": L.rmsnorm_init(inner, dtype=dtype, device=dev, lead=lead),
        "w_down": _normal(gen, (inner, d), si, dtype, lead),
    }


def _mlstm_chunk_scan(q, k, v, log_i, log_f, chunk, state=None):
    """The stabilised chunkwise mLSTM (``xlstm.py:57-113``).

    q, k, v: [B, H, S, P]; log_i, log_f: [B, H, S].  Returns y [B, H, S, P]
    (float32) and the final (C [B,H,P,P], n [B,H,P], m [B,H])."""
    B, H, S, P = q.shape
    Q = min(chunk, S)
    assert S % Q == 0, f"seq {S} not divisible by chunk {Q}"
    dev = q.device
    if state is None:
        C = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev)
        n = torch.zeros((B, H, P), dtype=torch.float32, device=dev)
        m = torch.full((B, H), M_INIT, dtype=torch.float32, device=dev)
    else:
        C, n, m = state
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    scale = 1.0 / math.sqrt(P)
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        qb, kb, vb = (t[:, :, sl].float() for t in (q, k, v))
        li, lf = log_i[..., sl], log_f[..., sl]
        b = torch.cumsum(lf, dim=-1)                          # [B,H,Q]
        total = b[..., -1]                                    # [B,H]
        # the intra-chunk log weights a_ij = b_i - b_j + li_j (j <= i)
        aij = b[..., :, None] - b[..., None, :] + li[..., None, :]
        aij = torch.where(tri, aij, -math.inf)
        inter_log = m[..., None] + b                          # [B,H,Q]
        m_i = torch.maximum(inter_log, aij.amax(dim=-1))
        m_i = torch.clamp_min(m_i, M_INIT)
        w_intra = torch.exp(aij - m_i[..., None])             # [B,H,Q,Q]
        w_inter = torch.exp(inter_log - m_i)                  # [B,H,Q]
        qs = qb * scale
        s_ij = (qs @ kb.transpose(-1, -2)) * w_intra
        num = s_ij @ vb + w_inter[..., None] * (qs @ C)
        den = s_ij.sum(dim=-1) + w_inter * (qs @ n[..., None])[..., 0]
        ys.append(num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None])
        # the state at the chunk's end; "bhj,bhjp,bhjq" as two products
        lw = total[..., None] - b + li                        # [B,H,Q]
        m_new = torch.maximum(m + total, lw.amax(dim=-1))
        w_old = torch.exp(m + total - m_new)                  # [B,H]
        kw = torch.exp(lw - m_new[..., None])[..., None] * kb  # [B,H,Q,P]
        C = w_old[..., None, None] * C + kw.transpose(-1, -2) @ vb
        n = w_old[..., None] * n + kw.sum(dim=-2)
        m = m_new
    return torch.cat(ys, dim=2), (C, n, m)


def mlstm_step(q, k, v, log_i, log_f, state, block=None, group=None):
    """One recurrent step (``xlstm.py:116-130``).  q, k, v: [B, H, P];
    gates [B, H].  Returns y [B, H, P] and the new (C, n, m).  On the
    mesh C and n may hold only the rows ``block`` = (k0, k1) of their key
    dim (q, k, v, the gates and m whole): they are updated on those rows,
    and ``C q`` and ``n q``, partial sums, are summed over ``group``
    before the normaliser."""
    C, n, m = state
    P = q.shape[-1]
    k0, k1 = block or (0, P)
    q, k, v = q.float(), k.float(), v.float()
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + m - m_new)
    k = k[..., k0:k1]
    C = f_p[..., None, None] * C + \
        i_p[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * k
    qs = (q * (1.0 / math.sqrt(P)))[..., k0:k1]
    num = (qs[..., None, :] @ C)[..., 0, :]
    den = (qs * n).sum(dim=-1)
    if group is not None:
        nd = torch.cat([num, den[..., None]], dim=-1)
        dist.all_reduce(nd, group=group)
        num, den = nd[..., :P], nd[..., P]
    y = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return y, (C, n, m_new)


def _mlstm_up(p, cfg, x):
    """The input norm h and ``w_up``'s product u ++ z (on the mesh: the
    norm's region and a column-parallel product)."""
    h = L.rmsnorm_apply(p["norm"], x, cfg.norm_eps)
    return h, L.dense_apply({"w": p["w_up"]}, h)


def _mlstm_heads(p, u, h, S, P, h0, h1, reduce=None):
    """q, k, v [B, H', S, P] from u's products with ``wq``, ``wk``,
    ``wv`` (the rows of them that ``p`` holds, each product through
    ``reduce``), and the gate logs [B, H', S] of heads [h0, h1) from h."""
    B = u.shape[0]

    def heads(w):
        t = u @ w
        return (t if reduce is None else reduce(t)).reshape(
            B, S, -1, P).transpose(1, 2)
    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    gl = h.float() @ p["w_if"] + p["b_if"]                     # [B,S,2H]
    i_raw, f_raw = torch.chunk(gl, 2, dim=-1)
    log_i = i_raw[..., h0:h1].transpose(1, 2)                 # [B,H',S]
    log_f = F.logsigmoid(f_raw[..., h0:h1]).transpose(1, 2)
    return q, k, v, log_i, log_f


def _mlstm_pre(p, cfg, x):
    """The shared projections.  x: [B, S, d] -> q, k, v [B, H, S, P], the
    gate logs [B, H, S], the z gate."""
    B, S, d = x.shape
    inner, H, P = _mlstm_dims(cfg)
    h, up = _mlstm_up(p, cfg, x)
    u, z = torch.chunk(up, 2, dim=-1)                         # [B,S,inner]
    return (*_mlstm_heads(p, u, h, S, P, 0, H), z, (B, S, inner))


def _mlstm_out(p, cfg, y, z, x, rows=slice(None)):
    """``out_norm`` over the whole inner width, the z gate, and the
    product with ``w_down`` (the ``rows`` of y that ``p`` holds)."""
    y = L.rmsnorm_apply(p["out_norm"], y.to(x.dtype), cfg.norm_eps) * F.silu(z)
    return y[..., rows] @ p["w_down"]


def mlstm_apply(p, cfg, x, state=None):
    if isinstance(p["w_up"], DTensor):
        if state is not None:
            raise NotImplementedError("the mLSTM's chunk scan on the mesh "
                                      "starts from a zero state; a carried "
                                      "state steps through mlstm_decode")
        return _mlstm_sharded(p, cfg, x), None
    q, k, v, log_i, log_f, z, (B, S, inner) = _mlstm_pre(p, cfg, x)
    y, new_state = _mlstm_chunk_scan(q, k, v, log_i, log_f, cfg.ssm_chunk,
                                     state)
    y = y.transpose(1, 2).reshape(B, S, inner)
    return _mlstm_out(p, cfg, y, z, x), new_state


def _mlstm_sharded(p, cfg, x):
    """:func:`mlstm_apply`'s stages on the mesh, x in the residual's
    placements.  ``w_up`` [d, 2 inner] is column-parallel, and its even
    column blocks put u on the first half of the model ranks and z on the
    rest, so its product's columns are gathered over ``model`` once (an
    activation).  ``wq``, ``wk``, ``wv`` are sharded on their input rows
    (``("mlp", "heads")``: the heads lose the model axis to ``mlp``), so
    each rank contracts its even chunk of u and q, k, v come out partial
    sums, reduced to this rank's heads where H divides the model axis
    (the chunk scan on local heads), else to whole heads (the scan on
    every rank, as xlstm-1.3b's 4 heads on 16 must).  ``w_if`` and
    ``b_if`` are replicated.  The scan's output is gathered for
    ``out_norm`` (an RMS over the whole inner width) and ``w_down`` is
    row-parallel: the output a partial sum over ``model``.  Where the
    inner width does not divide the model axis every product is whole
    on every rank and the block is replicated compute."""
    S = x.shape[1]
    inner, H, P = _mlstm_dims(cfg)
    m, r = tp.model_size(), tp.model_rank()
    # wq, wk, wv and w_down shard their inner rows over model together
    # (the rules' "mlp" on the same width)
    rows = tp.model_shard_dim(p["w_down"]) == 0
    G = Partial() if rows else Replicate()
    split = rows and H % m == 0
    h, up = _mlstm_up(p, cfg, x)
    u, z = torch.chunk(tp.local(up, grad=G), 2, dim=-1)

    def reduce(t):
        if not rows:
            return t
        t = tp.wrap(t, Partial())
        return tp.local(t, Shard(2)) if split else tp.local(t, grad=G)
    w = {k: tp.weight(p[k]) for k in ("wq", "wk", "wv")}
    w.update(w_if=tp.weight(p["w_if"], G), b_if=tp.weight(p["b_if"], G))
    lo, hi = tp.model_range(p["wq"], 0)
    h0, h1 = (r * H // m, (r + 1) * H // m) if split else (0, H)
    q, k, v, log_i, log_f = _mlstm_heads(
        w, u[..., lo:hi], tp.local(h, grad=G), S, P, h0, h1, reduce)
    y, _ = _mlstm_chunk_scan(q, k, v, log_i, log_f, cfg.ssm_chunk)
    y = y.transpose(1, 2).reshape(u.shape[0], S, -1).to(x.dtype)
    if split:
        y = tp.local(tp.wrap(y, Shard(2)), grad=G)
    out = {"out_norm": {"scale": tp.weight(p["out_norm"]["scale"], G)},
           "w_down": tp.weight(p["w_down"])}
    return tp.wrap(_mlstm_out(out, cfg, y, z, x,
                              slice(*tp.model_range(p["w_down"], 0))), G)


def mlstm_decode(p, cfg, x, state):
    """x: [B, 1, d] -> (delta, the new (C, n, m)); ``state`` is not
    written.  On the mesh (:func:`_mlstm_decode_sharded`) the state's
    ``DTensor``s are written in place and returned."""
    if isinstance(p["w_up"], DTensor):
        return _mlstm_decode_sharded(p, cfg, x, state), state
    q, k, v, log_i, log_f, z, (B, S, inner) = _mlstm_pre(p, cfg, x)
    y, new_state = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                              log_i[:, :, 0], log_f[:, :, 0], state)
    return _mlstm_out(p, cfg, y.reshape(B, 1, inner), z, x), new_state


def _mlstm_decode_sharded(p, cfg, x, state):
    """:func:`mlstm_decode` on the mesh, x in the residual's placements,
    the state (C [B, H, P, P], n [B, H, P], m [B, H]) ``DTensor``s in the
    reference's placements (``rules.cache_specs``: on ``model`` the heads
    where H divides it, else C and n on their key dim (dk, a contraction
    dim of ``C q`` and ``n q``) with m replicated).  ``w_up``'s product
    is gathered over ``model`` once, as in training, and ``wq``, ``wk``,
    ``wv`` (row-parallel) give partial sums: reduced to this rank's heads
    where the state shards its heads (the step on local heads, its output
    gathered), else whole.  On dk each rank updates its rows of C and n
    (C <- f C + i k v^T on its k rows), and ``C q`` and ``n q``, partial
    over ``model``, are summed before the normaliser ``max(|n q|,
    exp(-m))``; m is updated alike on every rank.  ``out_norm`` over the
    whole inner width, ``w_down`` row-parallel: the delta a partial sum
    over ``model``.  The state is written in place; no state leaf is
    gathered.  Returns the delta."""
    inner, H, P = _mlstm_dims(cfg)
    C, n, m = state
    cdim = tp.model_shard_dim(C)
    if cdim not in (None, 1, 2) or (cdim == 2) != (tp.model_shard_dim(n)
                                                   == 2) or \
            (cdim == 2 and tp.model_shard_dim(m) is not None):
        raise NotImplementedError(
            f"an mLSTM decode state in {tuple(C.placements)}, "
            f"{tuple(n.placements)}, {tuple(m.placements)}")
    rows = tp.model_shard_dim(p["w_down"]) == 0
    h0, h1 = tp.model_range(C, 1)
    h, up = _mlstm_up(p, cfg, x)
    u, z = torch.chunk(tp.local(up), 2, dim=-1)

    def reduce(t):
        if rows:
            return tp.reduced(t, 2 if cdim == 1 else None)
        return t[..., h0 * P:h1 * P] if cdim == 1 else t
    w = {k: tp.weight(p[k]) for k in ("wq", "wk", "wv", "w_if", "b_if")}
    lo, hi = tp.model_range(p["wq"], 0)
    q, k, v, log_i, log_f = (t[:, :, 0] for t in _mlstm_heads(
        w, u[..., lo:hi], tp.local(h), 1, P, h0, h1, reduce))
    local = [tp.local_of(t) for t in state]
    if cdim == 2:
        y, new = mlstm_step(q, k, v, log_i, log_f, local,
                            tp.model_range(C, 2), tp.model_group())
    else:
        y, new = mlstm_step(q, k, v, log_i, log_f, local)
    for dst, t in zip(state, new):
        tp.put(dst, t)
    y = y.reshape(y.shape[0], 1, -1)
    if h1 - h0 < H:
        y = tp.whole(y, 2)
    out = {"out_norm": {"scale": tp.weight(p["out_norm"]["scale"])},
           "w_down": tp.weight(p["w_down"])}
    return tp.wrap(_mlstm_out(out, cfg, y, z, x,
                              slice(*tp.model_range(p["w_down"], 0))),
                   Partial() if rows else Replicate())


def mlstm_state_init(cfg, batch: int, device, *, lead=()):
    _, H, P = _mlstm_dims(cfg)
    lead = tuple(lead)
    return (L.cache_leaf(lead + (batch, H, P, P), 0, torch.float32, device),
            L.cache_leaf(lead + (batch, H, P), 0, torch.float32, device),
            L.cache_leaf(lead + (batch, H), M_INIT, torch.float32, device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(gen: torch.Generator, cfg, dtype, *, lead=()):
    d, H = cfg.d_model, cfg.num_heads
    P = d // H
    f = max(1, int(d * 4 / 3) // 8 * 8)
    dev, lead = gen.device, tuple(lead)
    b = torch.cat([torch.zeros((2 * d,)), 3.0 * torch.ones((d,)),
                   torch.zeros((d,))]).to(dev)
    return {
        "norm": L.rmsnorm_init(d, dtype=dtype, device=dev, lead=lead),
        "w_in": _normal(gen, (d, 4 * d), 1.0 / math.sqrt(d), dtype, lead),
        "r": _normal(gen, (H, P, 4 * P), 1.0 / math.sqrt(P), torch.float32,
                     lead),
        "b": L._leaf(b.expand(lead + (4 * d,)).clone()),
        "out_norm": L.rmsnorm_init(d, dtype=dtype, device=dev, lead=lead),
        "ffn": L.swiglu_init(gen, d, f, dtype, lead=lead),
    }


def _slstm_cell(gates_x, r, h, c, n, m, H, P):
    """One sLSTM step (``xlstm.py:202-218``).  gates_x: [B, 4d] input
    pre-activations; the state float32 [B, d] each.

    The time loop launches this cell at every position, so it is written
    in few launches: the per-head recurrent product and the input added in
    one ``baddbmm`` over heads ([H, B, 4P] views of the reference's
    ``[B, 4HP]`` layout), the gates the reference's four column blocks of
    ``[B, 4d]`` (a gate's columns may cross a head where 4 does not
    divide H; a view when H is 4), ``log_f + m`` taken once, the
    products-and-sums as ``addcmul``."""
    B = gates_x.shape[0]
    pre = torch.baddbmm(gates_x.view(B, H, 4 * P).transpose(0, 1),
                        h.view(B, H, P).transpose(0, 1), r)   # [H, B, 4P]
    return _slstm_update(*pre.transpose(0, 1).reshape(B, 4, -1).unbind(1),
                         c, n, m)


def _slstm_update(z_r, i_r, f_r, o_r, c, n, m):
    """The sLSTM cell's elementwise update from its four gates'
    pre-activations: (h, c, n, m)."""
    lfm = F.logsigmoid(f_r) + m
    m_new = torch.maximum(lfm, i_r)
    i_p = torch.exp(i_r - m_new)
    f_p = torch.exp(lfm - m_new)
    c_new = torch.addcmul(f_p * c, i_p, torch.tanh(z_r))
    n_new = torch.addcmul(i_p, f_p, n)
    h_new = torch.sigmoid(o_r) * c_new / torch.clamp_min(n_new, 1.0)
    return h_new, c_new, n_new, m_new


def _slstm_gates(p, cfg, x):
    hin = L.rmsnorm_apply(p["norm"], x, cfg.norm_eps)
    return hin.float() @ p["w_in"].float() + p["b"]            # [B,S,4d]


def _slstm_out(p, cfg, y, x):
    y = L.rmsnorm_apply(p["out_norm"], y.to(x.dtype), cfg.norm_eps)
    return L.swiglu_apply(p["ffn"], y)


def _slstm_loop(gx, r, state, H, P):
    """The time loop over gx [B, S, 4d]: (the outputs [B, S, d], the
    final state)."""
    h, c, n, m = state
    hs = []
    for t in range(gx.shape[1]):
        h, c, n, m = _slstm_cell(gx[:, t], r, h, c, n, m, H, P)
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c, n, m)


def slstm_apply(p, cfg, x, state=None):
    B, S, d = x.shape
    H = cfg.num_heads
    if isinstance(p["w_in"], DTensor):
        if state is not None:
            raise NotImplementedError("the sLSTM's time loop on the mesh "
                                      "starts from a zero state; a carried "
                                      "state steps through slstm_decode")
        return _slstm_sharded(p, cfg, x), None
    gx = _slstm_gates(p, cfg, x)
    y, state = _slstm_loop(gx, p["r"], slstm_state_init(cfg, B, x.device)
                           if state is None else state, H, d // H)
    return _slstm_out(p, cfg, y, x), state


def _slstm_sharded(p, cfg, x):
    """:func:`slstm_apply` on the mesh, x in the residual's placements.
    ``w_in`` [d, 4d] is column-parallel, but the cell reads columns j,
    d+j, 2d+j and 3d+j and the recurrent product of a whole head, so a
    column shard cannot run its own loop: the input product's columns are
    gathered over ``model`` once, before the loop, and the loop runs
    whole on every rank with the replicated ``r`` and ``b`` (no
    collective inside it; ``r``'s gradient is whole on each rank and is
    reduced over the batch axes once, at the region's boundary).  The
    output norm and the SwiGLU FFN are their own regions."""
    d, H = x.shape[-1], cfg.num_heads
    gx = _slstm_gx_sharded(p, cfg, x)
    y, _ = _slstm_loop(gx, tp.weight(p["r"]),
                       slstm_state_init(cfg, gx.shape[0], gx.device), H,
                       d // H)
    return _slstm_out(p, cfg, tp.wrap(y.to(x.dtype)), x)


def _slstm_gx_sharded(p, cfg, x):
    """The sLSTM's input pre-activations on the mesh: ``w_in``'s
    column-parallel product gathered over ``model`` once, plus ``b``:
    [B, S, 4d], whole on every rank (local)."""
    h = L.rmsnorm_apply(p["norm"], x, cfg.norm_eps)
    w_in = p["w_in"]
    if tp.model_shard_dim(w_in) == w_in.ndim - 1:
        gx = tp.wrap(tp.local(h, grad=Partial()).float() @
                     tp.weight(w_in).float(), Shard(2))
    else:
        gx = tp.wrap(tp.local(h).float() @ tp.weight(w_in).float())
    return tp.local(gx) + tp.weight(p["b"])


def _slstm_decode_sharded(p, cfg, x, state):
    """:func:`slstm_decode` on the mesh, x in the residual's placements,
    the state (h, c, n, m [B, d] each) ``DTensor``s sharding d over
    ``model`` in even blocks (``rules.cache_specs``), which need not line
    up with the heads.  gx is gathered over ``model`` once, as in
    training; ``r`` stays replicated.  The recurrent product is
    block-diagonal over the heads, so each rank takes its h block's part
    of every head's product (a partial sum, summed over ``model``: the
    pre-activations whole on every rank), the cell's update runs on this
    rank's d block of (c, n, m) and is written back in place, and the
    new h is gathered for the output norm and the FFN's regions.  No
    state leaf is gathered.  Returns the delta."""
    d, H = x.shape[-1], cfg.num_heads
    P = d // H
    gx = _slstm_gx_sharded(p, cfg, x)[:, 0]                     # [B, 4d]
    r = tp.weight(p["r"])
    local = [tp.local_of(t) for t in state]
    d0, d1 = tp.model_range(state[0], 1)
    if d1 - d0 == d:
        new = _slstm_cell(gx, r, *local, H, P)
        h = new[0]
    else:
        B = gx.shape[0]
        hm = local[0].new_zeros((B, d))
        hm[:, d0:d1] = local[0]
        pre = torch.bmm(hm.view(B, H, P).transpose(0, 1), r)  # [H, B, 4P]
        dist.all_reduce(pre, group=tp.model_group())
        pre = gx.view(B, H, 4 * P).transpose(0, 1) + pre
        gates = pre.transpose(0, 1).reshape(B, 4, -1)[..., d0:d1].unbind(1)
        new = _slstm_update(*gates, *local[1:])
        h = tp.whole(new[0], 1)
    for dst, t in zip(state, new):
        tp.put(dst, t)
    return _slstm_out(p, cfg, tp.wrap(h[:, None, :].to(x.dtype)), x)


def slstm_decode(p, cfg, x, state):
    """x: [B, 1, d] -> (delta, the new (h, c, n, m)); ``state`` is not
    written.  On the mesh (:func:`_slstm_decode_sharded`) the state's
    ``DTensor``s are written in place and returned."""
    if isinstance(p["w_in"], DTensor):
        return _slstm_decode_sharded(p, cfg, x, state), state
    d = x.shape[-1]
    gx = _slstm_gates(p, cfg, x)
    h, c, n, m = _slstm_cell(gx[:, 0], p["r"], *state, cfg.num_heads,
                             d // cfg.num_heads)
    return _slstm_out(p, cfg, h[:, None, :], x), (h, c, n, m)


def slstm_state_init(cfg, batch: int, device, *, lead=()):
    shape = tuple(lead) + (batch, cfg.d_model)
    return tuple(L.cache_leaf(shape, v, torch.float32, device)
                 for v in (0, 0, 0, M_INIT))


# ---------------------------------------------------------------------------
# the full model
# ---------------------------------------------------------------------------


def init(gen: torch.Generator, cfg):
    """The model's params on ``gen``'s device, in ``cfg.dtype`` (the gate
    and recurrent weights float32)."""
    dtype = _dt(cfg)
    assert cfg.num_layers % 2 == 0
    lead = (cfg.num_layers // 2,)
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=dtype),
        "mlstm": mlstm_init(gen, cfg, dtype, lead=lead),
        "slstm": slstm_init(gen, cfg, dtype, lead=lead),
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype=dtype,
                                     device=gen.device),
        "unembed": L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                dtype=dtype),
    }


def unembed_matrix(params, cfg):
    return params["unembed"]["w"]


def apply(params, cfg, tokens, *, layer_mask=None, window=None,
          use_pallas=False, attn_chunk=0, remat="full"):
    """tokens: [B, S] int -> (hidden [B, S, d], aux_loss 0).  No
    attention: ``window``, ``use_pallas`` and ``attn_chunk`` are taken for
    the common signature and change nothing."""
    x = constrain(L.embed_apply(params["embed"], tokens))
    npairs = cfg.num_layers // 2
    mask = _pair_gates(cfg, layer_mask, x.device)

    def body(x, mp, sp, gate):
        dm, _ = mlstm_apply(mp, cfg, x)
        x = _residual(x, dm, gate[0].to(x.dtype))
        ds, _ = slstm_apply(sp, cfg, x)
        return constrain(_residual(x, ds, gate[1].to(x.dtype)))

    body = _remat_wrap(body, "none" if remat == "none" else "full")
    for i, (mp, sp) in enumerate(zip(_unstack(params["mlstm"], npairs),
                                     _unstack(params["slstm"], npairs))):
        x = body(x, mp, sp, mask[i])
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(params, cfg, hidden):
    return L.logits_apply(hidden, unembed_matrix(params, cfg))


def decode_init(params, cfg, batch: int, seq_len: int, *, window=None):
    """The recurrent state on the params' device: ``mlstm`` (C, n, m) and
    ``slstm`` (h, c, n, m), each stacked ``[L/2, B, ...]``, float32, and
    ``pos``, the reference's int32 count of decoded steps."""
    dev = params["embed"]["emb"].device
    lead = (cfg.num_layers // 2,)
    return {"mlstm": mlstm_state_init(cfg, batch, dev, lead=lead),
            "slstm": slstm_state_init(cfg, batch, dev, lead=lead),
            "pos": L.cache_leaf((), 0, torch.int32, dev)}


def _step(fn, p, cfg, x, stack, i, gate):
    """One block's decode step on layer ``i`` of the state ``stack``
    (views, ``tp.layer``), its new state written back in place, and the
    gated residual add."""
    state = [tp.layer(t, i) for t in stack]
    delta, new = fn(p, cfg, x, state)
    for dst, t in zip(state, new):
        tp.put(dst, t)
    return constrain(_residual(x, delta, gate.to(x.dtype)))


@torch.no_grad()
def decode_step(params, cfg, cache, tokens, pos, *, layer_mask=None,
                window=None):
    """tokens: [B, 1].  Returns (logits [B, 1, V], cache), the cache
    updated in place."""
    x, _ = decode_embed(params, tokens, pos)
    npairs = cfg.num_layers // 2
    mask = _pair_gates(cfg, layer_mask, tokens.device)
    for i, (mp, sp) in enumerate(zip(_unstack(params["mlstm"], npairs),
                                     _unstack(params["slstm"], npairs))):
        x = _step(mlstm_decode, mp, cfg, x, cache["mlstm"], i, mask[i, 0])
        x = _step(slstm_decode, sp, cfg, x, cache["slstm"], i, mask[i, 1])
    tp.local_of(cache["pos"]).add_(1)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x), cache
