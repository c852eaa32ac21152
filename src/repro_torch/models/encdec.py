"""Whisper-style encoder-decoder backbone (arXiv:2212.04356) — port of
``repro.models.encdec`` (the ``audio`` family: whisper-medium).

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: ``audio_frames`` arrive as precomputed frame embeddings
``[B, num_audio_frames, d_model]``.

Encoder: bidirectional self-attention, LayerNorm, biases and a GELU MLP
(the GELU MLPs always carry biases, the reference's ``gelu_mlp_init``
default, whatever ``cfg.mlp_bias`` says).  Decoder: causal
self-attention, cross-attention to the encoder output, the GELU MLP.
Positions: RoPE over the frame and token positions (the reference's
deviation from Whisper's learned embeddings).  Only the decoder's causal
self-attention takes the hand-written ``flash_attention`` kernel under
``use_pallas`` (``encdec.py:87-89``); the encoder's attention and the
cross-attention stay plain ``gqa_attend``, as in the reference.

The stacks keep the reference's ``[L, ...]`` layout (``encoder``
``[encoder_layers, ...]``, ``decoder`` ``[num_layers, ...]``), walked in
loops where the reference runs ``lax.scan``.  Remat (``encdec.py:79``,
``:118``): ``jax.checkpoint`` with no policy, so any mode but ``"none"``
recomputes each encoder and each decoder layer in the backward; a train
step then launches two ``flash_attention`` forwards a decoder layer (the
forward and the recompute) and one backward.

Decode: ``decode_init`` encodes once and keeps each decoder layer's
cross K/V ``[L, B, T_a, Hkv, hd]``, never advanced; the self caches
``[L, B, clen, Hkv, hd]`` are written in place by :func:`decode_step`.
The reference's step counters that nothing reads are not kept.

DR-FL: the layer mask covers the decoder only (an early-exited encoder
cannot feed cross-attention).  ``window`` is accepted by :func:`apply`
and not passed to the blocks, as in the reference.

On the production mesh (``launch/train.py::meshed_step``) the params are
``DTensor``s: the stub frames enter as this rank's rows (a ``DTensor`` in
the own-rows layout), the LayerNorms run in the compute layout, the
attention products and the GELU MLP split over the model axis
(``models/layers.py``'s regions: the encoder's attention on local heads
over all frames, the decoder's causal self-attention through
``flash_attention``'s local-shard entry under ``use_pallas``, the cross
layer's k and v from the encoder's output), and the embedding is
vocab-parallel where the vocabulary divides the model axis.  Decode runs
there too (``launch/train.py::meshed_serve_step``): ``decode_init``
encodes through the same regions and writes the cross K/V into the
cache's placements, and each step reads and writes the caches' shards.
"""
from __future__ import annotations

import torch

from torch.distributed.tensor import DTensor

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import tp
from repro_torch.sharding.rules import constrain


def enc_block_init(gen: torch.Generator, cfg, dtype, *, lead=()):
    dev = gen.device
    return {
        "attn_norm": L.layernorm_init(cfg.d_model, dtype=dtype, device=dev,
                                      lead=lead),
        "attn": L.attention_init(gen, cfg, dtype, lead=lead),
        "mlp_norm": L.layernorm_init(cfg.d_model, dtype=dtype, device=dev,
                                     lead=lead),
        "mlp": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                               lead=lead),
    }


def dec_block_init(gen: torch.Generator, cfg, dtype, *, lead=()):
    p = enc_block_init(gen, cfg, dtype, lead=lead)
    p["cross_norm"] = L.layernorm_init(cfg.d_model, dtype=dtype,
                                       device=gen.device, lead=lead)
    p["cross"] = L.attention_init(gen, cfg, dtype, lead=lead)
    return p


def init(gen: torch.Generator, cfg):
    """The model's params on ``gen``'s device, in ``cfg.dtype``."""
    dtype = T._dt(cfg)
    dev = gen.device
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=dtype),
        "encoder": enc_block_init(gen, cfg, dtype,
                                  lead=(cfg.encoder_layers,)),
        "enc_norm": L.layernorm_init(cfg.d_model, dtype=dtype, device=dev),
        "decoder": dec_block_init(gen, cfg, dtype, lead=(cfg.num_layers,)),
        "final_norm": L.layernorm_init(cfg.d_model, dtype=dtype, device=dev),
        "unembed": L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                dtype=dtype),
    }


def unembed_matrix(params, cfg):
    return params["unembed"]["w"]


def _remat(fn, remat):
    return T._remat_wrap(fn, "none" if remat == "none" else "full")


def encode(params, cfg, audio_frames, *, remat="full"):
    """audio_frames: [B, T_a, d] (the stub frontend's output) -> [B, T_a,
    d]."""
    x = audio_frames.to(T._dt(cfg))
    if isinstance(params["enc_norm"]["scale"], DTensor):
        x = tp.batch_input(x)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, bp):
        h = L.layernorm_apply(bp["attn_norm"], x, cfg.norm_eps)
        a, _ = L.attention_apply(bp["attn"], cfg, h, positions, causal=False,
                                 norm_eps=cfg.norm_eps)
        x = T._residual(x, a)
        h = L.layernorm_apply(bp["mlp_norm"], x, cfg.norm_eps)
        return constrain(T._residual(x, L.gelu_mlp_apply(bp["mlp"], h)))

    body = _remat(body, remat)
    for bp in T._unstack(params["encoder"], cfg.encoder_layers):
        x = body(x, bp)
    return L.layernorm_apply(params["enc_norm"], x, cfg.norm_eps)


def _dec_block(bp, cfg, x, enc_out, positions, gate, *, self_cache=None,
               cross_cache=None, use_pallas=False, attn_chunk=0):
    """One decoder layer.  With ``cross_cache``, ``kv_src`` is ``h`` (as in
    the reference): it only selects the cross-attention branch, which
    reads the cache."""
    h = L.layernorm_apply(bp["attn_norm"], x, cfg.norm_eps)
    a, _ = L.attention_apply(bp["attn"], cfg, h, positions, causal=True,
                             cache=self_cache, use_pallas=use_pallas,
                             attn_chunk=attn_chunk, norm_eps=cfg.norm_eps)
    x = T._residual(x, a, gate)
    h = L.layernorm_apply(bp["cross_norm"], x, cfg.norm_eps)
    c, _ = L.attention_apply(bp["cross"], cfg, h, positions, causal=False,
                             kv_src=enc_out if cross_cache is None else h,
                             cache=cross_cache, norm_eps=cfg.norm_eps)
    x = T._residual(x, c, gate)
    h = L.layernorm_apply(bp["mlp_norm"], x, cfg.norm_eps)
    return T._residual(x, L.gelu_mlp_apply(bp["mlp"], h), gate)


def apply(params, cfg, tokens, audio_frames, *, layer_mask=None, window=None,
          use_pallas=False, attn_chunk=0, remat="full"):
    """tokens: [B, S] decoder input; audio_frames: [B, T_a, d] -> (hidden
    [B, S, d], aux_loss 0).  ``layer_mask`` [L] gates the decoder
    layers."""
    enc_out = encode(params, cfg, audio_frames, remat=remat)
    x = constrain(L.embed_apply(params["embed"], tokens))
    positions = torch.arange(tokens.shape[1], device=x.device)
    mask = T._gates(cfg, layer_mask, x.device)

    def body(x, enc_out, bp, gate):
        return constrain(_dec_block(bp, cfg, x, enc_out, positions,
                                    gate.to(x.dtype), use_pallas=use_pallas,
                                    attn_chunk=attn_chunk))

    body = _remat(body, remat)
    for i, bp in enumerate(T._unstack(params["decoder"], cfg.num_layers)):
        x = body(x, enc_out, bp, mask[i])
    x = L.layernorm_apply(params["final_norm"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(params, cfg, hidden):
    return L.logits_apply(hidden, unembed_matrix(params, cfg))


@torch.no_grad()
def decode_init(params, cfg, batch: int, seq_len: int, *, window=None,
                audio_frames=None):
    """The decode cache on the params' device: ``self`` (``k``, ``v`` [L,
    B, clen, Hkv, hd], ``pos`` [L] int32) and ``cross`` (``k``, ``v`` [L,
    B, T_a, Hkv, hd], the encoder output projected once; zero frames when
    none are given; ``pos`` [L] zeros), and ``pos``, the reference's int32
    count of decoded steps."""
    w = cfg.window if window is None else window
    clen = min(seq_len, w) if w else seq_len
    dtype, dev = T._dt(cfg), params["embed"]["emb"].device
    Ld, Hkv, hd, Ta = cfg.num_layers, cfg.num_kv_heads, cfg.hd, \
        cfg.num_audio_frames
    if audio_frames is None:
        audio_frames = torch.zeros((batch, Ta, cfg.d_model), dtype=dtype,
                                   device=dev)
    enc_out = encode(params, cfg, audio_frames, remat="none")
    cross = {n: L.cache_leaf((Ld, batch, Ta, Hkv, hd), 0, dtype, dev)
             for n in ("k", "v")}
    for i, cp in enumerate(T._unstack(params["decoder"]["cross"], Ld)):
        for n in ("k", "v"):
            tp.put(tp.layer(cross[n], i),
                   L.kv_heads(L.dense_apply(cp["w" + n], enc_out), Hkv, hd))
    shape = (Ld, batch, clen, Hkv, hd)
    return {
        "self": {"k": L.cache_leaf(shape, 0, dtype, dev),
                 "v": L.cache_leaf(shape, 0, dtype, dev),
                 "pos": L.cache_leaf((Ld,), 0, torch.int32, dev)},
        "cross": dict(cross, pos=L.cache_leaf((Ld,), 0, torch.int32, dev)),
        "pos": L.cache_leaf((), 0, torch.int32, dev),
    }


@torch.no_grad()
def decode_step(params, cfg, cache, tokens, pos, *, layer_mask=None,
                window=None):
    """tokens: [B, 1]; pos: the absolute position (an int or a 0-d
    tensor).  Returns (logits [B, 1, V], cache), the self caches updated
    in place."""
    x, positions = T.decode_embed(params, tokens, pos)
    mask = T._gates(cfg, layer_mask, tokens.device)
    sc, cc = cache["self"], cache["cross"]
    for i, bp in enumerate(T._unstack(params["decoder"], cfg.num_layers)):
        x = constrain(_dec_block(bp, cfg, x, None, positions,
                                 mask[i].to(x.dtype),
                                 self_cache=T.layer_cache(sc, i),
                                 cross_cache=T.layer_cache(cc, i,
                                                           ("k", "v"))))
    tp.local_of(cache["pos"]).add_(1)
    x = L.layernorm_apply(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x), cache
