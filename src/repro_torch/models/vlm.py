"""Llama-3.2-Vision-style VLM backbone (hf:meta-llama/Llama-3.2-11B-Vision)
— port of ``repro.models.vlm`` (the ``vlm`` family:
llama-3.2-vision-11b).

40 decoder layers = 8 groups of (4 self-attention layers + 1 gated
cross-attention layer), ``cross_attn_every`` 5.  The vision frontend (ViT
and projector) is a stub, as in the reference: ``image_embeds`` arrive as
precomputed patch embeddings ``[B, num_image_tokens, d_model]``.

The self layers are the dense family's blocks (``transformer.block_init``
and ``block_apply``), stacked ``[n_groups, n_self, ...]``; under
``use_pallas`` each launches the hand-written ``flash_attention`` kernel,
as the reference's launch its Pallas kernel (``vlm.py:93-95``).  The
cross layers ``[n_groups, ...]``: RMSNorm, plain cross-attention to the
image tokens (no RoPE), SwiGLU, each residual gated by ``tanh`` of a
float32 scalar (``gate_attn``, ``gate_mlp``; zero at init, so a fresh
model ignores the image, as the reference model does) cast to the
activations' dtype.

Remat (``vlm.py:104``): ``jax.checkpoint`` with no policy around a WHOLE
group, so any mode but ``"none"`` recomputes the group's 4 self layers
and its cross layer in the backward: a train step launches two
``flash_attention`` forwards a self layer and one backward.

Decode: self caches ``[n_groups, n_self, B, clen, Hkv, hd]`` written in
place, and each group's cross K/V of the image tokens ``[n_groups, B,
T_img, Hkv, hd]`` (``k_norm`` applied where ``qk_norm``), made once by
:func:`decode_init`.  The reference's step counters that nothing reads
are not kept.

DR-FL: the layer mask ``[num_layers]`` is read as ``(n_groups, n_self +
1)``: each group's self layers, then its cross layer.

On the production mesh (``launch/train.py::meshed_step``) the params are
``DTensor``s: the embedding is vocab-parallel, the self layers are the
dense family's regions, the cross layer's q column-parallel from the
text and k and v from the image tokens (``image_embeds``, this rank's
rows, as a ``DTensor`` in the own-rows layout), attention on local heads,
``wo`` and the SwiGLU's down product row-parallel; the gates' gradients
are partial sums reduced once.  Decode runs there too
(``launch/train.py::meshed_serve_step``): ``decode_init`` projects the
image tokens through the same regions and writes the cross K/V into the
cache's placements, and each step reads and writes the caches' shards.
"""
from __future__ import annotations

import torch

from torch.distributed.tensor import DTensor

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import tp
from repro_torch.sharding.rules import constrain


def group_shape(cfg):
    """(n_groups, self layers a group)."""
    k = cfg.cross_attn_every
    n_self_per_group = k - 1
    n_groups = cfg.num_layers // k
    assert n_groups * k == cfg.num_layers
    return n_groups, n_self_per_group


def cross_block_init(gen: torch.Generator, cfg, dtype, *, lead=()):
    dev = gen.device
    return {
        "attn_norm": L.rmsnorm_init(cfg.d_model, dtype=dtype, device=dev,
                                    lead=lead),
        "attn": L.attention_init(gen, cfg, dtype, lead=lead),
        "mlp_norm": L.rmsnorm_init(cfg.d_model, dtype=dtype, device=dev,
                                   lead=lead),
        "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype, lead=lead),
        "gate_attn": L._leaf(torch.zeros(lead, dtype=torch.float32,
                                         device=dev)),
        "gate_mlp": L._leaf(torch.zeros(lead, dtype=torch.float32,
                                        device=dev)),
    }


def _gated(x, a, gate, g):
    """``x + gate * tanh(g) * a``, ``g`` a float32 scalar param cast to
    x's dtype.  On the mesh the sum is taken on x's local shards
    (``transformer._residual``), where ``g``'s gradient is each rank's
    share of a sum over its rows and features: partial on the mesh dims
    that shard x, reduced once (``tp.pointwise_param``)."""
    if isinstance(g, DTensor):
        g = tp.pointwise_param(g, x)
    return T._residual(x, a, gate * torch.tanh(g).to(x.dtype))


def cross_block_apply(p, cfg, x, img, gate, *, cache=None):
    """The gated cross layer.  With ``cache`` (decode: the image tokens'
    K/V), ``img`` only selects the cross-attention branch, which reads
    the cache."""
    h = L.rmsnorm_apply(p["attn_norm"], x, cfg.norm_eps)
    a, _ = L.attention_apply(p["attn"], cfg, h,
                             torch.arange(x.shape[1], device=x.device),
                             causal=False, kv_src=img, cache=cache,
                             norm_eps=cfg.norm_eps)
    x = _gated(x, a, gate, p["gate_attn"])
    h = L.rmsnorm_apply(p["mlp_norm"], x, cfg.norm_eps)
    return _gated(x, L.swiglu_apply(p["mlp"], h), gate, p["gate_mlp"])


def init(gen: torch.Generator, cfg):
    """The model's params on ``gen``'s device, in ``cfg.dtype`` (the cross
    layers' gates float32)."""
    dtype = T._dt(cfg)
    n_groups, n_self = group_shape(cfg)
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=dtype),
        "self_blocks": T.block_init(gen, cfg, dtype, lead=(n_groups, n_self)),
        "cross_blocks": cross_block_init(gen, cfg, dtype, lead=(n_groups,)),
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype=dtype,
                                     device=gen.device),
        "unembed": L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                dtype=dtype),
    }


def unembed_matrix(params, cfg):
    return params["unembed"]["w"]


def _group_gates(cfg, layer_mask, device):
    n_groups, n_self = group_shape(cfg)
    return T._gates(cfg, layer_mask, device).reshape(n_groups, n_self + 1)


def apply(params, cfg, tokens, image_embeds, *, layer_mask=None, window=None,
          use_pallas=False, attn_chunk=0, remat="full"):
    """tokens: [B, S]; image_embeds: [B, T_img, d] -> (hidden [B, S, d],
    aux_loss 0)."""
    x = constrain(L.embed_apply(params["embed"], tokens))
    img = image_embeds.to(x.dtype)
    if isinstance(x, DTensor):
        img = tp.batch_input(img)
    positions = torch.arange(tokens.shape[1], device=x.device)
    n_groups, n_self = group_shape(cfg)
    mask = _group_gates(cfg, layer_mask, x.device)

    def group_body(x, img, sp, cp, gates):
        for j, bp in enumerate(T._unstack(sp, n_self)):
            x, _, _ = T.block_apply(bp, cfg, x, positions,
                                    gates[j].to(x.dtype), window=window,
                                    use_pallas=use_pallas,
                                    attn_chunk=attn_chunk)
        return constrain(cross_block_apply(cp, cfg, x, img,
                                           gates[n_self].to(x.dtype)))

    body = T._remat_wrap(group_body, "none" if remat == "none" else "full")
    for sp, cp, gates in zip(T._unstack(params["self_blocks"], n_groups),
                             T._unstack(params["cross_blocks"], n_groups),
                             mask):
        x = body(x, img, sp, cp, gates)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(params, cfg, hidden):
    return L.logits_apply(hidden, unembed_matrix(params, cfg))


@torch.no_grad()
def decode_init(params, cfg, batch: int, seq_len: int, *, window=None,
                image_embeds=None):
    """Self-attention KV caches and each group's static cross K/V, on the
    params' device: ``self`` (``k``, ``v`` [G, n_self, B, clen, Hkv, hd],
    ``pos`` [G, n_self] int32) and ``cross`` (``k``, ``v`` [G, B, T_img,
    Hkv, hd]; zero image tokens when none are given; ``pos`` [G] zeros),
    and ``pos``, the reference's int32 count of decoded steps."""
    w = cfg.window if window is None else window
    clen = min(seq_len, w) if w else seq_len
    dtype, dev = T._dt(cfg), params["embed"]["emb"].device
    n_groups, n_self = group_shape(cfg)
    Hkv, hd, Ti = cfg.num_kv_heads, cfg.hd, cfg.num_image_tokens
    if image_embeds is None:
        image_embeds = torch.zeros((batch, Ti, cfg.d_model), dtype=dtype,
                                   device=dev)
    img = image_embeds.to(dtype)
    if isinstance(params["embed"]["emb"], DTensor):
        img = tp.batch_input(img)
    cross = {n: L.cache_leaf((n_groups, batch, Ti, Hkv, hd), 0, dtype, dev)
             for n in ("k", "v")}
    for g, cp in enumerate(T._unstack(params["cross_blocks"], n_groups)):
        k = L.kv_heads(L.dense_apply(cp["attn"]["wk"], img), Hkv, hd)
        if "k_norm" in cp["attn"]:
            k = L.rmsnorm_apply(cp["attn"]["k_norm"], k, cfg.norm_eps)
        tp.put(tp.layer(cross["k"], g), k)
        tp.put(tp.layer(cross["v"], g),
               L.kv_heads(L.dense_apply(cp["attn"]["wv"], img), Hkv, hd))
    shape = (n_groups, n_self, batch, clen, Hkv, hd)
    return {
        "self": {"k": L.cache_leaf(shape, 0, dtype, dev),
                 "v": L.cache_leaf(shape, 0, dtype, dev),
                 "pos": L.cache_leaf((n_groups, n_self), 0, torch.int32,
                                     dev)},
        "cross": dict(cross, pos=L.cache_leaf((n_groups,), 0, torch.int32,
                                              dev)),
        "pos": L.cache_leaf((), 0, torch.int32, dev),
    }


@torch.no_grad()
def decode_step(params, cfg, cache, tokens, pos, *, layer_mask=None,
                window=None):
    """tokens: [B, 1]; pos: the absolute position (an int or a 0-d
    tensor).  Returns (logits [B, 1, V], cache), the self caches updated
    in place."""
    x, positions = T.decode_embed(params, tokens, pos)
    n_groups, n_self = group_shape(cfg)
    mask = _group_gates(cfg, layer_mask, tokens.device)
    sc, cc = cache["self"], cache["cross"]
    for g, (sp, cp) in enumerate(zip(
            T._unstack(params["self_blocks"], n_groups),
            T._unstack(params["cross_blocks"], n_groups))):
        group = T.layer_cache(sc, g)
        for j, bp in enumerate(T._unstack(sp, n_self)):
            x, _, _ = T.block_apply(
                bp, cfg, x, positions, mask[g, j].to(x.dtype), window=window,
                cache=T.layer_cache(group, j))
        x = constrain(cross_block_apply(
            cp, cfg, x, x, mask[g, n_self].to(x.dtype),
            cache=T.layer_cache(cc, g, ("k", "v"))))
    tp.local_of(cache["pos"]).add_(1)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x), cache
