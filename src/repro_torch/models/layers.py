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

On the production mesh (``launch/train.py::meshed_step``) every LM
family's params arrive as the ``DTensor``s the rules place (which
selects these paths) and their activations as ``DTensor``s, and
:func:`dense_apply`, :func:`swiglu_apply`, :func:`gelu_mlp_apply`,
:func:`rmsnorm_apply`, :func:`layernorm_apply`, :func:`embed_apply`,
:func:`attention_apply` (self- and cross-attention), :func:`gqa_attend`
and :func:`gqa_attend_chunked` split the compute as the reference's
GSPMD does (``sharding/tp.py``'s regions, each running the one-device
code on its local tensors): the q/k/v, SwiGLU gate/up and GELU input
products column-parallel, the output, down and GELU output products
row-parallel, attention on each rank's local heads, the activation
hooks at the reference's call sites.  Initialisers hand each leaf they
make to :func:`leaf_hook`'s function where one is installed (the
sharded state build, ``launch/train.py``), and every family's
``decode_init`` makes its cache leaves through :func:`cache_leaf` (the
sharded cache build).  With a decode cache on the mesh,
:func:`attention_apply` reads and writes the cache's shards in each of
the reference's layouts (:func:`_attention_cached_sharded`), and
:func:`logits_apply` gives each rank its vocab shard's logits.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding import tp
from repro_torch.sharding.rules import (attn_head_shard, attn_seq_shard,
                                        get_sharding_policy)

#: what :func:`leaf_hook` installs: each initialiser's leaf goes through
#: it and is replaced by what it returns
_LEAF_HOOK = None


@contextlib.contextmanager
def leaf_hook(fn):
    """Within ``with``: every param leaf an initialiser of this module
    makes is passed to ``fn`` as soon as it is made, and the tree holds
    what ``fn`` returns (``launch/train.py`` keeps each leaf's shard)."""
    global _LEAF_HOOK
    outer, _LEAF_HOOK = _LEAF_HOOK, fn
    try:
        yield
    finally:
        _LEAF_HOOK = outer


def _leaf(t: torch.Tensor):
    return t if _LEAF_HOOK is None else _LEAF_HOOK(t)


#: what :func:`cache_hook` installs: it makes each decode-cache leaf
_CACHE_HOOK = None


@contextlib.contextmanager
def cache_hook(fn):
    """Within ``with``: every decode-cache leaf that :func:`cache_leaf`
    makes is ``fn(shape, value, dtype, device)`` instead
    (``launch/train.py::sharded_decode_cache`` makes each as this rank's
    shard)."""
    global _CACHE_HOOK
    outer, _CACHE_HOOK = _CACHE_HOOK, fn
    try:
        yield
    finally:
        _CACHE_HOOK = outer


def cache_leaf(shape, value, dtype, device):
    """A decode-cache or recurrent-state leaf of ``shape`` filled with
    ``value`` (every family's ``decode_init`` makes its leaves here)."""
    if _CACHE_HOOK is not None:
        return _CACHE_HOOK(tuple(shape), value, dtype, device)
    return torch.full(tuple(shape), value, dtype=dtype, device=device)


def _normal(gen: torch.Generator, shape, scale: float, dtype, lead=()):
    """``layers.py:22``: N(0, scale^2) drawn in float32 and cast to
    ``dtype``, with ``lead`` axes in front."""
    w = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                    device=gen.device)
    return _leaf((scale * w).to(dtype))


def normal_by_matrix(gen: torch.Generator, shape, scale: float, dtype,
                     lead=()):
    """:func:`_normal`'s distribution drawn one trailing matrix at a time
    into a tensor made in ``dtype``: a stack of bf16 experts (mixtral's
    ``w_gate`` at 4 layers is 3.2 G elements) never exists in float32
    whole."""
    out = torch.empty(tuple(lead) + tuple(shape), dtype=dtype,
                      device=gen.device)
    if not out.is_meta:            # meta: shapes only (launch/specs.py)
        for m in out.view((-1,) + tuple(shape[-2:])):
            m.copy_(torch.randn(m.shape, generator=gen,
                                device=gen.device).mul_(scale))
    return _leaf(out)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, *, dtype=torch.float32,
               lead: Tuple[int, ...] = ()):
    """``w ~ N(0, scale^2)``, ``scale`` 1/sqrt(d_in) unless given
    (``layers.py:26``), drawn in float32 and cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn(lead + (d_in, d_out), generator=gen, device=gen.device)
    return {"w": _leaf((w * scale).to(dtype))}


def dense_bias_init(gen: torch.Generator, d_in: int, d_out: int,
                    bias: bool = True, scale: Optional[float] = None, *,
                    dtype=torch.float32, lead: Tuple[int, ...] = ()):
    p = dense_init(gen, d_in, d_out, scale, dtype=dtype, lead=lead)
    if bias:
        p["b"] = _leaf(torch.zeros(lead + (d_out,), dtype=dtype,
                                   device=gen.device))
    return p


def dense_apply(p, x: torch.Tensor) -> torch.Tensor:
    if isinstance(p["w"], DTensor):
        return _dense_sharded(p, x)
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def _column_params(p):
    """A column-parallel product's local params: ``w``'s model shard (its
    output columns), the bias's matching slice (each rank uses a part
    of it: its gradient is partial over ``model``)."""
    out = {"w": tp.weight(p["w"])}
    if "b" in p:
        lo, hi = tp.model_range(p["w"], p["w"].ndim - 1)
        out["b"] = tp.weight(p["b"], Partial())[..., lo:hi]
    return out


def _row_params(p):
    """A row-parallel product's local params: ``w``'s model shard (its
    input rows); the bias counted on model rank 0 only (zero on the
    others), so the partial sums add it once."""
    out = {"w": tp.weight(p["w"])}
    if "b" in p:
        b = tp.weight(p["b"], Partial())
        out["b"] = b if tp.model_rank() == 0 else b * 0.0
    return out


def _dense_sharded(p, x):
    """``x @ w (+ b)`` on the mesh as the rules place ``w``, x [..., d_in]
    in the compute layout: column-parallel where ``model`` shards w's
    output dim (the ``("embed", "heads")`` and ``("embed", "mlp")``
    specs: x whole, out sharded on its last dim), row-parallel where it
    shards w's input dim (``("heads", "embed")``, ``("mlp", "embed")``: x
    sharded on its last dim, out a partial sum over ``model``), else
    replicated compute."""
    last = x.ndim - 1
    dim = tp.model_shard_dim(p["w"])
    if dim == p["w"].ndim - 1:
        y = dense_apply(_column_params(p), tp.local(x, grad=Partial()))
        return tp.wrap(y, Shard(last))
    if dim == p["w"].ndim - 2:
        y = dense_apply(_row_params(p), tp.local(x, Shard(last)))
        return tp.wrap(y, Partial())
    local = {k: tp.weight(v) for k, v in p.items()}
    return tp.wrap(dense_apply(local, tp.local(x)))


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
    return {"emb": _leaf(torch.randn((vocab, d), generator=gen,
                                     device=gen.device).to(dtype))}


def embed_apply(p, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding lookup ``emb[tokens]``.  On the mesh (``emb`` a
    ``DTensor``, ``tokens`` this rank's rows) a vocab-parallel lookup:
    each model rank looks up the tokens in its vocab shard (the
    ``("vocab", "embed")`` spec) and the rows come back a partial sum
    over ``model``, which the caller's :func:`~repro_torch.sharding.
    rules.constrain` reduces."""
    emb = p["emb"]
    if not isinstance(emb, DTensor):
        return emb[tokens]
    tok = tp.group_rows(tokens)
    if tp.model_shard_dim(emb) != 0:
        return tp.wrap(tp.weight(emb)[tok])
    lo, hi = tp.model_range(emb, 0)
    e = tp.weight(emb)
    idx = tok.long() - lo
    inside = (idx >= 0) & (idx < hi - lo)
    x = e[idx.clamp(0, hi - lo - 1)] * inside[..., None].to(e.dtype)
    return tp.wrap(x, Partial())


def rmsnorm_init(d: int, *, dtype=torch.float32, device="cpu",
                 lead: Tuple[int, ...] = ()):
    return {"scale": _leaf(torch.ones(lead + (d,), dtype=dtype,
                                      device=device))}


def layernorm_init(d: int, *, dtype=torch.float32, device="cpu",
                   lead: Tuple[int, ...] = ()):
    """``layers.py:100``: unit scale, zero bias (``lead``: the stack)."""
    return {"scale": _leaf(torch.ones(lead + (d,), dtype=dtype,
                                      device=device)),
            "bias": _leaf(torch.zeros(lead + (d,), dtype=dtype,
                                      device=device))}


def layernorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's expression (``layers.py:104-109``), written out:
    float32 mean, the biased variance of ``x - mean``, ``rsqrt``; ATen's
    fused ``layer_norm`` sums in another order.  On the mesh (``p`` and
    ``x`` ``DTensor``s): the norm of the whole feature dim, replicated
    over ``model``, in the compute layout, as :func:`rmsnorm_apply`'s."""
    if isinstance(p["scale"], DTensor):
        local = {k: tp.weight(p[k]) for k in ("scale", "bias")}
        return tp.wrap(layernorm_apply(local, tp.local(x), eps))
    # the view makes the norm's uses of x one term of x's gradient, as in
    # rmsnorm_apply
    xf = x.view_as(x) if x.dtype == torch.float32 else x.float()
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
    by default (``layers.py:374-375``).  On the mesh, one region as
    :func:`swiglu_apply`'s: ``w_in`` column-parallel (its bias sliced),
    ``w_out`` row-parallel (its bias added once), the output a partial
    sum over ``model``; else replicated compute."""
    if isinstance(p["w_in"]["w"], DTensor):
        return _mlp_sharded(gelu_mlp_apply, p, x, ("w_in",), "w_out")
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
    """``layers.py:88-98``: float32 statistics, the output in x's dtype.
    On the mesh (``p`` and ``x`` ``DTensor``s): the norm of the whole
    feature dim, replicated over ``model``, in the compute layout (where
    GSPMD gathers the residual for it, or ``gather_block_input`` already
    has)."""
    if isinstance(p["scale"], DTensor):
        return tp.wrap(rmsnorm_apply({"scale": tp.weight(p["scale"])},
                                     tp.local(x), eps))
    # in float32 ``x.float()`` is x itself; the view makes the norm's
    # three uses of x one term of x's gradient, as the cast does in bf16
    # and as a region's local tensor does on the mesh, so the sum of x's
    # gradient terms (this one and the residual's) is the same on one
    # device and on a one-rank mesh, bit for bit
    xf = x.view_as(x) if x.dtype == torch.float32 else x.float()
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
    if isinstance(q, DTensor):
        return _gqa_attend_sharded(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len)
    G = q.shape[2] // k.shape[2]
    if get_sharding_policy()["repeat_kv"] and G > 1:
        kr = k.repeat_interleave(G, dim=2)
        vr = v.repeat_interleave(G, dim=2)
        return _attend_repeated(q, kr, vr, causal=causal, window=window,
                                q_offset=q_offset, kv_len=kv_len)
    return _attend_grouped(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, kv_len=kv_len)


def _attend_repeated(q, kr, vr, *, causal, window=0, q_offset=0,
                     kv_len=None):
    """The ``repeat_kv`` branch's products: the query heads a pure batch
    dim, kr and vr [B, Sk, Hq, D]."""
    Sq, Sk, D = q.shape[1], kr.shape[1], q.shape[3]
    valid = _visible(Sq, Sk, causal, window, q_offset, kv_len, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) \
        * (1.0 / math.sqrt(D))
    s = torch.where(valid[:, None], s, s.new_tensor(MASKED))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(vr.dtype).float(), vr.float())
    return o.to(q.dtype)


def _attend_grouped(q, k, v, *, causal, window=0, q_offset=0, kv_len=None):
    """The grouped einsum: query head h reads KV head h // G."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    valid = _visible(Sq, Sk, causal, window, q_offset, kv_len, q.device)
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    s = torch.where(valid[:, None, None], s, s.new_tensor(MASKED))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def _gqa_attend_sharded(q, k, v, *, causal, window, q_offset, kv_len):
    """:func:`gqa_attend` on the mesh: each rank's local shards
    (``tp.attend_local``: heads, batch rows, or, under ``attn_seq``, its
    query rows at their offset), with one ``q_offset`` and ``kv_len`` for
    every row (a decode cache's).  The ``repeat_kv`` branch repeats each
    rank's local KV heads, then calls ``attn_head_shard`` on q and the
    repeated KV, as the reference's branch does (``layers.py:199-205``)."""
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if isinstance(t, torch.Tensor) and t.dim():
            raise NotImplementedError(f"attention on the mesh takes one "
                                      f"{name} for every row, not {name} "
                                      f"{tuple(t.shape)}")
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    G = q.shape[2] // k.shape[2]
    if get_sharding_policy()["repeat_kv"] and G > 1:
        tp.attention_layout(q, k, v, seq_ok=True)
        kr, vr = (tp.from_local(
            tp.to_local(t, t.placements).repeat_interleave(G, dim=2),
            t.placements, (t.shape[0], t.shape[1], q.shape[2], t.shape[3]),
            mesh=t.device_mesh) for t in (k, v))
        q, kr, vr = attn_head_shard(q, kr, vr)
        return tp.attend_local(_attend_repeated, q, kr, vr, seq_ok=True,
                               **kw)
    return tp.attend_local(_attend_grouped, q, k, v, seq_ok=True, **kw)


def gqa_attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool, window: int = 0,
                       chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``chunk`` keys
    (``layers.py:228-280``, its ``lax.scan`` a loop): never holds the
    [Sq, Sk] scores.  Key counts that ``chunk`` does not divide, or that
    fit in one chunk, take :func:`gqa_attend`, as in the reference."""
    if isinstance(q, DTensor):
        # the query rows' offsets are not taken here: attn_seq's q comes
        # gathered, as to the kernel (attention_apply)
        return tp.attend_local(gqa_attend_chunked, q, k, v, seq_ok=False,
                               causal=causal, window=window, chunk=chunk)
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
    tensors its plain version).  On the mesh the cache's leaves are
    ``DTensor``s in the reference's placements
    (``launch/specs.py::decode_cache_shardings``), written and read on
    each rank's shard (:func:`_attention_cached_sharded`)."""
    if isinstance(p["wq"]["w"], DTensor):
        if cache is not None:
            return _attention_cached_sharded(
                p, cfg, x, positions, cache, cross=kv_src is not None,
                norm_eps=norm_eps), cache
        return _attention_sharded(
            p, cfg, x, positions, causal=causal, window=window,
            use_pallas=use_pallas, attn_chunk=attn_chunk,
            norm_eps=norm_eps, kv_src=kv_src), cache
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _split_heads(dense_apply(p["wq"], x), nh, hd)
    # a cross-attention's source (the encoder's output, which every
    # decoder layer reads) as a view: its two uses here are one term of
    # its gradient, as a region's local tensor makes them on the mesh
    src = x if kv_src is None else kv_src.view_as(kv_src)
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


def _heads(flat, norms, cfg, positions, nq: int, nkv: int, norm_eps,
           rope: bool = True):
    """attention_apply's q, k, v from the products' outputs (k and v None
    where their products are): the heads split, ``qk_norm``, RoPE
    (self-attention only), in the one-device order."""
    hd = cfg.hd
    q = _split_heads(flat[0], nq, hd)
    k, v = (None if f is None else _split_heads(f, nkv, hd)
            for f in flat[1:])
    if norms:
        q = rmsnorm_apply(norms["q_norm"], q, norm_eps)
        if k is not None:
            k = rmsnorm_apply(norms["k_norm"], k, norm_eps)
    if not rope:
        return q, k, v
    return (apply_rope(q, positions, cfg.rope_theta),
            None if k is None else apply_rope(k, positions, cfg.rope_theta),
            v)


def _merge_heads(o):
    """o [B, S, H, D] (a ``DTensor``) as [B, S, H*D] in the same
    placements; a head shard that is uneven over its ranks is gathered
    first (its flat columns would not be the flat tensor's even shard)."""
    m = o.device_mesh
    H = o.shape[2]
    even = tuple(Replicate() if p == Shard(2) and H % m.size(i) else p
                 for i, p in enumerate(o.placements))
    if even != tuple(o.placements):
        o = o.redistribute(m, even)
    local = tp.to_local(o, even)
    flat = local.reshape(local.shape[:2] + (-1,))
    return tp.from_local(flat, even, tuple(o.shape[:2]) + (H * o.shape[3],),
                         mesh=m)


def _sources(x, cols):
    """A region's local tensors of ``x`` for the products that read it:
    x's gradient is partial over model through the column-sharded
    products and whole through the replicated ones, one boundary for
    each kind; (the first, the second; None where no product needs
    it)."""
    return (tp.local(x, grad=Partial()) if any(cols) else None,
            None if all(cols) else tp.local(x))


def _attention_sharded(p, cfg, x, positions, *, causal, window,
                       use_pallas, attn_chunk, norm_eps, kv_src=None):
    """``attention_apply`` on the mesh: x (and a cross-attention's
    ``kv_src``) in the compute layout.  The q/k/v products column-parallel
    as the rules place wq, wk, wv (``("embed", "heads")``, a cross
    layer's too): q from x, k and v from ``kv_src`` where it is given;
    where Hq and Hkv both divide the model axis each rank keeps its local
    heads, else the products' columns are gathered to whole heads (the
    reference's GSPMD replicates around an indivisible head axis).  Then
    ``attn_seq_shard`` (``layers.py:308-310``), attention on local shards
    (causal self-attention takes the ``flash_attention`` kernel under
    ``use_pallas``, which like the reference's takes no query offset:
    under ``attn_seq`` its q is gathered; the plain path attends on the
    local query rows, a cross-attention's on all the keys, non-causal and
    without RoPE, as the reference), and ``wo`` row-parallel: the output
    a partial sum over ``model``."""
    q, k, v = attn_seq_shard(*_qkv_sharded(p, cfg, x, positions, kv_src,
                                           norm_eps))
    kernel = use_pallas and causal and kv_src is None
    chunked = attn_chunk and kv_src is None
    if kernel or chunked:
        rows = tuple(Replicate() if pl == Shard(1) else pl
                     for pl in q.placements)
        if rows != tuple(q.placements):
            q = q.redistribute(q.device_mesh, rows)
    if kernel:
        from repro_torch.kernels.flash_attention import flash_attention
        o = flash_attention(q, k, v, causal=True, window=window)
    elif chunked:
        o = gqa_attend_chunked(q, k, v, causal=causal, window=window,
                               chunk=attn_chunk)
    else:
        o = gqa_attend(q, k, v, causal=causal and kv_src is None,
                       window=window)
    return dense_apply(p["wo"], _merge_heads(o))


def kv_heads(flat: torch.Tensor, nkv: int, hd: int) -> torch.Tensor:
    """A k or v product [B, T, nkv * hd] as heads [B, T, nkv, hd]; on the
    mesh (a ``DTensor`` whose columns ``model`` may shard) gathered to
    whole heads in the compute layout (an activation: the cross K/V that
    a ``decode_init`` writes into its cache's placements)."""
    if not isinstance(flat, DTensor):
        return flat.reshape(flat.shape[0], flat.shape[1], nkv, hd)
    t = tp.local(flat)
    return tp.wrap(t.reshape(t.shape[0], t.shape[1], nkv, hd))


def _qkv_sharded(p, cfg, x, positions, kv_src, norm_eps, kv=True):
    """:func:`_attention_sharded`'s q, k and v (``DTensor``s [B, S, H,
    hd]; k and v None without ``kv``): the q/k/v products column-parallel
    as the rules place wq, wk, wv, q from x, k and v from ``kv_src``
    where it is given; where Hq and Hkv both divide the model axis each
    rank keeps its local heads (``Shard(2)``), else the products' columns
    are gathered to whole heads (``Replicate``)."""
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    m = tp.model_size()
    names = ("wq", "wk", "wv")
    cols = [tp.model_shard_dim(p[n]["w"]) == p[n]["w"].ndim - 1
            for n in names]
    if kv_src is None:
        srcs = [_sources(x, cols)] * 3
    else:
        srcs = [_sources(x, cols[:1])] + [_sources(kv_src, cols[1:])] * 2
    used = names if kv else names[:1]
    flat = [dense_apply(_column_params(p[n]), xs) if c else
            dense_apply({k: tp.weight(t) for k, t in p[n].items()}, xr)
            for n, c, (xs, xr) in zip(used, cols, srcs)]
    flat += [None] * (3 - len(flat))
    norm_names = [n for n in ("q_norm", "k_norm") if n in p and
                  (kv or n == "q_norm")]
    if all(cols) and nh % m == 0 and nkv % m == 0:
        # each rank's heads: the q/k norms' scales act on every rank's
        # heads, so their gradients are partial over model
        norms = {n: {"scale": tp.weight(p[n]["scale"], Partial())}
                 for n in norm_names}
        out = _heads(flat, norms, cfg, positions, nh // m, nkv // m,
                     norm_eps, rope=kv_src is None)
        return tuple(None if t is None else tp.wrap(t, Shard(2))
                     for t in out)
    whole = [None if f is None else
             tp.local(tp.wrap(f, Shard(2) if c else Replicate()))
             for f, c in zip(flat, cols)]
    norms = {n: {"scale": tp.weight(p[n]["scale"])} for n in norm_names}
    return tuple(None if t is None else tp.wrap(t) for t in _heads(
        whole, norms, cfg, positions, nh, nkv, norm_eps,
        rope=kv_src is None))


def _attention_cached_sharded(p, cfg, x, positions, cache, *, cross,
                              norm_eps):
    """``attention_apply`` with a decode cache on the mesh: x in the
    compute layout, the cache's ``k`` and ``v`` [B, clen, Hkv, hd]
    ``DTensor``s in the reference's placements (``rules.cache_specs``:
    the batch over the batch axes, and on ``model`` the KV heads where
    they divide it, else the cache rows, else the head dim), its ``pos``
    replicated.  q (and, for self-attention, the step's k and v) come
    from the column-parallel products (:func:`_qkv_sharded`), on local
    heads where the cache shards its heads, else whole; the self-
    attention's k and v go into the ring slot ``pos % clen`` on the rank
    whose shard holds it, written into the cache's local tensor; ``pos``
    advances on every rank alike.  Then, by the cache's layout:

    * **heads** (or none): each rank attends its heads to its local
      cache, :func:`gqa_attend` on local shards, no collective;
    * **rows**: the softmax over the cache rows of every rank, in
      float32: the max and the sum of the exponentials merged over
      ``model``, the probabilities rounded to v's dtype as one device
      rounds them, each rank's ``p @ v`` over its rows summed;
    * **head dim**: float32 partial scores over each rank's columns of
      the head dim, summed over ``model``, the softmax on every rank
      alike, and ``p @ v`` on the local columns, which are gathered for
      ``wo``.

    ``wo`` is row-parallel: the output a partial sum over ``model``."""
    q, k, v = _qkv_sharded(p, cfg, x, positions, x if cross else None,
                           norm_eps, kv=not cross)
    K, V = cache["k"], cache["v"]
    dim = tp.model_shard_dim(K)
    if dim == 0:
        raise NotImplementedError("decode on the mesh with the batch over "
                                  "the model axis (dp2d) is not ported")
    if cross:
        q_offset, kv_len = 0, None
    else:
        pos = tp.local_of(cache["pos"])
        S, clen = q.shape[1], K.shape[1]
        start = torch.clamp(torch.remainder(pos, clen), max=clen - S)
        rows = (start + torch.arange(S, device=pos.device)).long()
        q_offset, kv_len = pos, torch.clamp(pos + S, max=clen)
        _write_cache(K, k, rows, dim)
        _write_cache(V, v, rows, dim)
    if dim in (None, 2):
        for t in (K, V):
            if tuple(t.placements) != tuple(q.placements):
                raise ValueError(f"a decode cache in {tuple(t.placements)} "
                                 f"beside q in {tuple(q.placements)}")
        o = gqa_attend(q, K, V, causal=False, q_offset=q_offset,
                       kv_len=kv_len)
    else:
        ql = tp.to_local(q, q.placements)
        o = (_attend_cache_rows if dim == 1 else _attend_cache_cols)(
            ql, K, V, kv_len)
    if not cross:
        pos.add_(S)
    return dense_apply(p["wo"], _merge_heads(o))


def _write_cache(C, t, rows, dim):
    """The step's keys or values ``t`` ([B, S, Hkv, hd], a ``DTensor`` in
    the compute layout, local heads or whole) into cache rows ``rows`` of
    ``C``'s local tensor, as ``C``'s layout holds them: its heads, its
    head-dim columns, or, over the cache rows, the rows its range holds
    (a row outside it writes back what is there)."""
    Cl, tl = C.to_local(), tp.to_local(t, t.placements).to(C.dtype)
    if dim == 3:
        lo, hi = tp.model_range(C, 3)
        tl = tl[..., lo:hi]
    if dim != 1:
        Cl.index_copy_(1, rows, tl)
        return
    lo, hi = tp.model_range(C, 1)
    for j in range(rows.shape[0]):
        r = rows[j:j + 1] - lo
        inside = (r >= 0) & (r < hi - lo)
        r = r.clamp(0, hi - lo - 1)
        Cl.index_copy_(1, r, torch.where(inside, tl[:, j:j + 1],
                                         Cl.index_select(1, r)))


def _cache_scores(q, k, lo):
    """q [B, Sq, Hq, D], k [B, n, Hkv, D] (a cache's local rows from
    ``lo``) -> float32 products [B, Hkv, G, Sq, n], and the rows'
    positions [n]."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    return s, lo + torch.arange(k.shape[1], device=q.device)


def _attend_cache_rows(q, K, V, kv_len):
    """The rows layout: q whole [B, Sq, Hq, D] (local tensor); ``K`` and
    ``V`` ``DTensor``s sharding the cache rows over ``model``.  The
    softmax's max and sum over each rank's rows, each merged over
    ``model`` (a max, then a sum), the probabilities rounded to v's dtype
    as the one-device attention rounds them, and each rank's partial
    ``p @ v`` over its rows summed over ``model``; returns o [B, Sq, Hq,
    D] whole on every rank (a ``DTensor`` in q's layout)."""
    B, Sq, Hq, D = q.shape
    lo, _ = tp.model_range(K, 1)
    s, kp = _cache_scores(q, K.to_local(), lo)
    s = s * (1.0 / math.sqrt(D))
    if kv_len is not None:
        s = torch.where(kp < kv_len, s, s.new_tensor(MASKED))
    group = tp.model_group()
    mx = s.amax(dim=-1, keepdim=True)
    if group is not None:
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(s - mx)
    total = e.sum(dim=-1, keepdim=True)
    if group is not None:
        dist.all_reduce(total, group=group)
    Vl = V.to_local()
    o = torch.einsum("bhgqk,bkhd->bhgqd", (e / total).to(Vl.dtype).float(),
                     Vl.float())
    if group is not None:
        dist.all_reduce(o, group=group)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    return tp.wrap(o)


def _attend_cache_cols(q, K, V, kv_len):
    """The head-dim layout: q whole [B, Sq, Hq, D] (local tensor); ``K``
    and ``V`` ``DTensor``s sharding the head dim over ``model``.  The
    scores' partial sums over each rank's columns summed over ``model``,
    the softmax alike on every rank, ``p @ v`` on the local columns:
    returns o [B, Sq, Hq, D] sharding its head dim as ``V`` does."""
    B, Sq, Hq, D = q.shape
    lo, hi = tp.model_range(K, 3)
    s, kp = _cache_scores(q[..., lo:hi], K.to_local(), 0)
    group = tp.model_group()
    if group is not None:
        dist.all_reduce(s, group=group)
    s = s * (1.0 / math.sqrt(D))
    if kv_len is not None:
        s = torch.where(kp < kv_len, s, s.new_tensor(MASKED))
    pr = torch.softmax(s, dim=-1)
    Vl = V.to_local()
    o = torch.einsum("bhgqk,bkhd->bqhgd", pr.to(Vl.dtype).float(),
                     Vl.float())
    return tp.wrap(tp.whole(o.reshape(B, Sq, Hq, hi - lo).to(q.dtype), 3))


def make_kv_cache(cfg, batch: int, length: int, dtype, device="cpu"):
    shape = (batch, length, cfg.num_kv_heads, cfg.hd)
    return {"k": cache_leaf(shape, 0, dtype, device),
            "v": cache_leaf(shape, 0, dtype, device),
            "pos": cache_leaf((), 0, torch.int32, device)}


def logits_apply(hidden: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(hidden @ w).float()``, the unembedding's float32 logits.  On the
    mesh (``w`` a ``DTensor``, hidden in the compute layout) each rank's
    logits for its vocab shard where ``model`` shards ``w``'s vocab (the
    ``("embed", "vocab")`` spec): a ``DTensor`` sharding its last dim
    over ``model``; no logits are gathered."""
    if not isinstance(w, DTensor):
        return (hidden @ w).float()
    y = (tp.local(hidden) @ tp.weight(w)).float()
    if tp.model_shard_dim(w) == w.ndim - 1:
        return tp.wrap(y, Shard(y.ndim - 1))
    return tp.wrap(y)


def swiglu_init(gen: torch.Generator, d: int, f: int, dtype,
                bias: bool = False, *, lead: Tuple[int, ...] = ()):
    kw = dict(bias=bias, dtype=dtype, lead=lead)
    return {"w_gate": dense_bias_init(gen, d, f, **kw),
            "w_up": dense_bias_init(gen, d, f, **kw),
            "w_down": dense_bias_init(gen, f, d, scale=1.0 / math.sqrt(f),
                                      **kw)}


def swiglu_apply(p, x: torch.Tensor) -> torch.Tensor:
    if isinstance(p["w_gate"]["w"], DTensor):
        return _mlp_sharded(swiglu_apply, p, x, ("w_gate", "w_up"),
                            "w_down")
    return dense_apply(p["w_down"], F.silu(dense_apply(p["w_gate"], x))
                       * dense_apply(p["w_up"], x))


def _mlp_sharded(fn, p, x, cols, row):
    """An MLP ``fn`` (:func:`swiglu_apply`, :func:`gelu_mlp_apply`) on the
    mesh, x in the compute layout, as one region: its ``cols`` products
    column-parallel and its ``row`` product row-parallel where ``model``
    shards the MLP width (the ``("embed", "mlp")`` and ``("mlp",
    "embed")`` specs; the output a partial sum over ``model``), else
    replicated compute."""
    w = p[cols[0]]["w"]
    if tp.model_shard_dim(w) == w.ndim - 1:
        local = {k: _column_params(p[k]) for k in cols}
        local[row] = _row_params(p[row])
        return tp.wrap(fn(local, tp.local(x, grad=Partial())), Partial())
    local = {k: {n: tp.weight(t) for n, t in v.items()} for k, v in p.items()}
    return tp.wrap(fn(local, tp.local(x)))
