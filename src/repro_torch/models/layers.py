"""Dense, MLP, GRU, embedding, RMSNorm, LayerNorm, RoPE and GELU-MLP
primitives, and the LM substrate's attention and SwiGLU — port of
``repro.models.layers``.

Parameters are plain dicts of tensors with the JAX names and shapes
(``w`` is ``[d_in, d_out]`` and applies as ``x @ w``), so converted JAX
weights drop in unchanged.  Initialisers draw from an explicit
``torch.Generator``, on the generator's device: the numbers differ from
``jax.random`` for the same seed, the distributions do not.  ``lead``
prepends axes to every leaf of an initialiser (the LM's ``[L]`` layer
stack, which the reference makes with ``jax.vmap`` over keys).

The LM half (:func:`rmsnorm_apply` to :func:`swiglu_apply`) follows
``layers.py:88-366``.  Its RMSNorm is plain float32 ops, as the
reference's is (it reaches no Pallas kernel); the reference's dtype
barrier there (``:57-86``) only steers XLA's SPMD partitioner and is an
identity here, as is ``attn_seq_shard`` (``:309-310``) on one card.
Attention is the grouped einsum of ``gqa_attend``, or, under the
sharding policy's ``repeat_kv`` (``repro_torch.sharding.rules``, off by
default), the reference's branch (``:199-215``) with the KV heads
repeated.  Prefill and training take the
hand-written ``flash_attention`` kernel under ``use_pallas``, as the
reference takes its Pallas kernel; decode attention stays plain torch,
as the reference computes it outside any kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import get_sharding_policy


def _normal(gen: torch.Generator, shape, scale: float, dtype, lead=()):
    """``layers.py:22``: N(0, scale^2) drawn in float32 and cast to
    ``dtype``, with ``lead`` axes in front."""
    w = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                    device=gen.device)
    return (scale * w).to(dtype)


def normal_by_matrix(gen: torch.Generator, shape, scale: float, dtype,
                     lead=()):
    """:func:`_normal`'s distribution drawn one trailing matrix at a time
    into a tensor made in ``dtype``: a stack of bf16 experts (mixtral's
    ``w_gate`` at 4 layers is 3.2 G elements) never exists in float32
    whole."""
    out = torch.empty(tuple(lead) + tuple(shape), dtype=dtype,
                      device=gen.device)
    if out.is_meta:                # shapes only (launch/specs.py)
        return out
    for m in out.view((-1,) + tuple(shape[-2:])):
        m.copy_(torch.randn(m.shape, generator=gen,
                            device=gen.device).mul_(scale))
    return out


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, *, dtype=torch.float32,
               lead: Tuple[int, ...] = ()):
    """``w ~ N(0, scale^2)``, ``scale`` 1/sqrt(d_in) unless given
    (``layers.py:26``), drawn in float32 and cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn(lead + (d_in, d_out), generator=gen, device=gen.device)
    return {"w": (w * scale).to(dtype)}


def dense_bias_init(gen: torch.Generator, d_in: int, d_out: int,
                    bias: bool = True, scale: Optional[float] = None, *,
                    dtype=torch.float32, lead: Tuple[int, ...] = ()):
    p = dense_init(gen, d_in, d_out, scale, dtype=dtype, lead=lead)
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=gen.device)
    return p


def dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def stacked_dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    """``dense_apply`` with the participant axis written out: x [P, ...,
    d_in], w [P, d_in, d_out], b [P, d_out]; one batched product per
    call."""
    P, d_in = x.shape[0], x.shape[-1]
    w = p["w"]
    y = torch.bmm(x.reshape(P, -1, d_in), w).reshape(
        x.shape[:-1] + (w.shape[-1],))
    if "b" in p:
        y = y + p["b"].reshape((P,) + (1,) * (x.dim() - 2) + (w.shape[-1],))
    return y


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.float32):
    return {"emb": torch.randn((vocab, d), generator=gen,
                               device=gen.device).to(dtype)}


def rmsnorm_init(d: int, *, dtype=torch.float32, device="cpu",
                 lead: Tuple[int, ...] = ()):
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def layernorm_init(d: int, *, dtype=torch.float32, device="cpu",
                   lead: Tuple[int, ...] = ()):
    """``layers.py:100``: unit scale, zero bias (``lead``: the stack)."""
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device),
            "bias": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def layernorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's expression (``layers.py:104-109``), written out:
    float32 mean, the biased variance of ``x - mean``, ``rsqrt``; ATen's
    fused ``layer_norm`` sums in another order."""
    xf = x.float()
    centered = xf - xf.mean(dim=-1, keepdim=True)
    var = (centered * centered).mean(dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, H, D]; positions broadcastable to [..., S] (int).  The
    reference rotates the two HALVES of the head dimension, not
    interleaved pairs, with angles in float32 (``layers.py:121-129``)."""
    freqs = rope_freqs(x.shape[-1], theta).to(x.device)      # [D/2]
    angles = positions[..., None].float() * freqs            # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                    # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu_mlp_init(gen: torch.Generator, d: int, f: int, *,
                  dtype=torch.float32, bias: bool = True,
                  lead: Tuple[int, ...] = ()):
    """With biases by default, as the reference (``layers.py:368``)."""
    kw = dict(bias=bias, dtype=dtype, lead=lead)
    return {"w_in": dense_bias_init(gen, d, f, **kw),
            "w_out": dense_bias_init(gen, f, d, scale=1.0 / math.sqrt(f),
                                     **kw)}


def gelu_mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """``w_out(gelu(w_in(x)))``; ``jax.nn.gelu`` is the tanh approximation
    by default (``layers.py:374-375``)."""
    return dense_apply(p["w_out"], F.gelu(dense_apply(p["w_in"], x),
                                          approximate="tanh"))


def stacked_gelu_mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """The GELU MLP with the participant axis written out (x [P, ...,
    d]); ``jax.nn.gelu`` is the tanh approximation by default
    (``layers.py:375``)."""
    return stacked_dense_apply(
        p["w_out"], F.gelu(stacked_dense_apply(p["w_in"], x),
                           approximate="tanh"))


def mlp_init(gen: torch.Generator, net_dims):
    return {f"l{i}": dense_bias_init(gen, net_dims[i], net_dims[i + 1])
            for i in range(len(net_dims) - 1)}


def mlp_apply(p, x: torch.Tensor, act=torch.relu) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = dense_apply(p[f"l{i}"], x)
        if i < n - 1:
            x = act(x)
    return x


def gru_init(gen: torch.Generator, d_in: int, d_h: int):
    return {"wx": dense_bias_init(gen, d_in, 3 * d_h),
            "wh": dense_bias_init(gen, d_h, 3 * d_h, bias=False)}


def gru_apply(p, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference cell (``layers.py:407-415``): the hidden projection
    has NO bias, which ``nn.GRUCell`` cannot express, so it is written
    out."""
    gx = dense_apply(p["wx"], x)
    gh = dense_apply(p["wh"], h)
    xr, xz, xn = torch.chunk(gx, 3, dim=-1)
    hr, hz, hn = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


# ---------------------------------------------------------------------------
# the LM substrate: RMSNorm, GQA attention (causal / sliding-window /
# cross, cached decode), SwiGLU
# ---------------------------------------------------------------------------

#: masked logits, the reference's finite -1e30: a row that sees no key
#: gets the plain mean of v
MASKED = -1e30


def rmsnorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``layers.py:88-98``: float32 statistics, the output in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def attention_init(gen: torch.Generator, cfg, dtype, *,
                   lead: Tuple[int, ...] = ()):
    """``wq``, ``wk``, ``wv``, ``wo`` (each with ``b`` under
    ``cfg.attn_bias``), and ``q_norm``/``k_norm`` under ``cfg.qk_norm``
    (``layers.py:137-152``)."""
    d, nh, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    kw = dict(bias=cfg.attn_bias, dtype=dtype, lead=lead)
    p = {"wq": dense_bias_init(gen, d, nh * hd, **kw),
         "wk": dense_bias_init(gen, d, nkv * hd, **kw),
         "wv": dense_bias_init(gen, d, nkv * hd, **kw),
         "wo": dense_bias_init(gen, nh * hd, d,
                               scale=1.0 / math.sqrt(nh * hd), **kw)}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype=dtype, device=gen.device,
                                   lead=lead)
        p["k_norm"] = rmsnorm_init(hd, dtype=dtype, device=gen.device,
                                   lead=lead)
    return p


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _visible(Sq: int, Sk: int, causal: bool, window: int, q_offset,
             kv_len, device) -> torch.Tensor:
    """``gqa_attend``'s mask, [B or 1, Sq, Sk]: ``q_offset`` (an int or a
    0-d or [B] tensor) is the absolute position of q[0]; ``kv_len`` (None,
    an int or a 0-d or [B] tensor) the valid cache entries."""
    q_pos = torch.as_tensor(q_offset, device=device)[..., None] + \
        torch.arange(Sq, device=device)                        # [..., Sq]
    qp = q_pos[..., :, None]                                   # [(B,)Sq,1]
    kp = torch.arange(Sk, device=device)[None, :]
    valid = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                       dtype=torch.bool, device=device)
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & (kp > qp - window)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=device)
        kl = kl[..., None, None] if kl.dim() == 1 else kl
        valid = valid & (kp < kl)
    while valid.dim() < 3:
        valid = valid[None]
    return valid


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, window: int = 0, q_offset=0,
               kv_len=None) -> torch.Tensor:
    """Grouped-query attention, the reference's grouped einsum
    (``layers.py:157-226``): q [B, Sq, Hq, D], k and v [B, Sk, Hkv, D] ->
    [B, Sq, Hq, D].  The scores are float32 products of q and k upcast
    first (the reference's bf16 operands with
    ``preferred_element_type=float32``); p is rounded to v's dtype before
    the second product, which also accumulates in float32 (TF32 stays
    off, ``repro_torch/__init__.py``).  Under the ``repeat_kv`` policy
    the KV heads are repeated (each ``G`` times in a row) and the query
    heads are a pure batch dim of both products, as in the reference."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    valid = _visible(Sq, Sk, causal, window, q_offset, kv_len, q.device)
    if get_sharding_policy()["repeat_kv"] and G > 1:
        kr = k.repeat_interleave(G, dim=2)
        vr = v.repeat_interleave(G, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
        s = torch.where(valid[:, None], s, s.new_tensor(MASKED))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                         vr.float())
        return o.to(q.dtype)
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    s = torch.where(valid[:, None, None], s, s.new_tensor(MASKED))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def gqa_attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool, window: int = 0,
                       chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``chunk`` keys
    (``layers.py:228-280``, its ``lax.scan`` a loop): never holds the
    [Sq, Sk] scores.  Key counts that ``chunk`` does not divide, or that
    fit in one chunk, take :func:`gqa_attend`, as in the reference."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Sk % chunk or Sk <= chunk:
        return gqa_attend(q, k, v, causal=causal, window=window)
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    acc = q.new_zeros((B, Hkv, G, Sq, D), dtype=torch.float32)
    m = q.new_full((B, Hkv, G, Sq, 1), MASKED, dtype=torch.float32)
    l = q.new_zeros((B, Hkv, G, Sq, 1), dtype=torch.float32)
    for j in range(Sk // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj.float()) * scale
        k_pos = j * chunk + torch.arange(chunk, device=q.device)[None, :]
        valid = torch.ones((Sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            valid = valid & (k_pos <= q_pos)
        if window:
            valid = valid & (k_pos > q_pos - window)
        s = torch.where(valid, s, s.new_tensor(MASKED))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vj.dtype).float(), vj.float())
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)
    return o.movedim(3, 1).reshape(B, Sq, Hq, D).to(q.dtype)


def attention_apply(p, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                    causal: bool = True, window: int = 0, cache=None,
                    kv_src: Optional[torch.Tensor] = None,
                    use_pallas: bool = False, attn_chunk: int = 0,
                    norm_eps: float = 1e-5):
    """``layers.py:282-338``; returns ``(out, cache)``.

    ``cache`` (decode: ``{"k", "v"}`` [B, clen, Hkv, hd] and ``"pos"``, a
    0-d int tensor) is written IN PLACE: the step's keys and values go
    into the ring slot ``pos % clen`` and ``pos`` advances, the port's
    form of the reference's donated cache; the step then attends to the
    ``min(pos + S, clen)`` valid entries.  A cross-attention cache is
    read as it is.  With ``use_pallas``, causal self-attention without a
    cache launches the hand-written ``flash_attention`` kernel (on CPU
    tensors its plain version)."""
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _split_heads(dense_apply(p["wq"], x), nh, hd)
    src = x if kv_src is None else kv_src
    k = _split_heads(dense_apply(p["wk"], src), nkv, hd)
    v = _split_heads(dense_apply(p["wv"], src), nkv, hd)
    if "q_norm" in p:
        q = rmsnorm_apply(p["q_norm"], q, norm_eps)
        k = rmsnorm_apply(p["k_norm"], k, norm_eps)
    if kv_src is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and kv_src is None:
        pos, S = cache["pos"], x.shape[1]
        clen = cache["k"].shape[1]
        # dynamic_update_slice's start, clamped so the S rows fit
        start = torch.clamp(torch.remainder(pos, clen), max=clen - S)
        rows = (start + torch.arange(S, device=x.device)).long()
        cache["k"].index_copy_(1, rows, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, rows, v.to(cache["v"].dtype))
        o = gqa_attend(q, cache["k"], cache["v"], causal=False, window=0,
                       q_offset=pos, kv_len=torch.clamp(pos + S, max=clen))
        pos.add_(S)
    elif cache is not None:     # cross-attention with a precomputed cache
        o = gqa_attend(q, cache["k"], cache["v"], causal=False)
    elif use_pallas and kv_src is None and causal:
        from repro_torch.kernels.flash_attention import flash_attention
        o = flash_attention(q, k, v, causal=True, window=window)
    elif attn_chunk and kv_src is None:
        o = gqa_attend_chunked(q, k, v, causal=causal, window=window,
                               chunk=attn_chunk)
    else:
        o = gqa_attend(q, k, v, causal=causal and kv_src is None,
                       window=window)
    out = dense_apply(p["wo"], o.reshape(x.shape[:-1] + (nh * hd,)))
    return out, cache


def make_kv_cache(cfg, batch: int, length: int, dtype, device="cpu"):
    return {"k": torch.zeros((batch, length, cfg.num_kv_heads, cfg.hd),
                             dtype=dtype, device=device),
            "v": torch.zeros((batch, length, cfg.num_kv_heads, cfg.hd),
                             dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def swiglu_init(gen: torch.Generator, d: int, f: int, dtype,
                bias: bool = False, *, lead: Tuple[int, ...] = ()):
    kw = dict(bias=bias, dtype=dtype, lead=lead)
    return {"w_gate": dense_bias_init(gen, d, f, **kw),
            "w_up": dense_bias_init(gen, d, f, **kw),
            "w_down": dense_bias_init(gen, f, d, scale=1.0 / math.sqrt(f),
                                      **kw)}


def swiglu_apply(p, x: torch.Tensor) -> torch.Tensor:
    return dense_apply(p["w_down"], F.silu(dense_apply(p["w_gate"], x))
                       * dense_apply(p["w_up"], x))
