"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block
(arXiv:2411.15242) — port of ``repro.models.hybrid`` (the
``mamba-hybrid`` family: zamba2-1.2b).

The shared transformer block (full attention and a SwiGLU MLP, one set
of params for every application) is applied after every
``cfg.shared_attn_every`` Mamba2 blocks: zamba2-1.2b's 38 blocks run in
segments of 6, 6, 6, 6, 6, 6, 2, so the block runs at 6 sites (the last
segment, shorter, has none).  Under ``use_pallas`` each site launches the
hand-written ``flash_attention`` kernel, as the reference launches its
Pallas kernel (``hybrid.py:85-88``).

Remat (``hybrid.py:77``): only the Mamba block body is recomputed in the
backward; the shared block is not, so a train step runs one attention
forward and one backward a site.  Decode keeps one KV cache a site,
``[sites, B, clen, Hkv, hd]``, written in place where the reference
stacks new ones; the Mamba states ``[L, ...]`` likewise, and the
reference's step counter ``pos``.

DR-FL: the layer mask covers the Mamba blocks; the shared block is part
of every submodel.

On the production mesh (``launch/train.py::meshed_step``) the params are
``DTensor``s: the embedding is vocab-parallel, each Mamba2 block is
``models/ssm.py``'s region, and the shared block is the dense family's
(its attention on local heads, through ``flash_attention``'s local-shard
entry under ``use_pallas``).  Decode runs there too, on the Mamba
states' and the sites' KV caches' shards
(``launch/train.py::meshed_serve_step``).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.ssm import (mamba_apply, mamba_decode, mamba_init,
                                    mamba_state_init)
from repro_torch.sharding import tp
from repro_torch.sharding.rules import constrain


def _segments(cfg):
    """The Mamba blocks' segment sizes; a shared-attention application
    follows every full segment of ``shared_attn_every``."""
    k = cfg.shared_attn_every or cfg.num_layers
    sizes, rest = [], cfg.num_layers
    while rest > 0:
        sizes.append(min(k, rest))
        rest -= k
    return sizes


def _site_after(cfg, size: int) -> bool:
    return size == (cfg.shared_attn_every or cfg.num_layers)


def num_attn_sites(cfg) -> int:
    return sum(1 for s in _segments(cfg) if _site_after(cfg, s))


def init(gen: torch.Generator, cfg):
    """The model's params on ``gen``'s device, in ``cfg.dtype`` (the Mamba
    gate constants float32)."""
    dtype = T._dt(cfg)
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=dtype),
        "mamba": mamba_init(gen, cfg, dtype, lead=(cfg.num_layers,)),
        "shared_attn": T.block_init(gen, cfg, dtype),    # one block, reused
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype=dtype,
                                     device=gen.device),
        "unembed": L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                dtype=dtype),
    }


def unembed_matrix(params, cfg):
    return params["unembed"]["w"]


def apply(params, cfg, tokens, *, layer_mask=None, window=None,
          use_pallas=False, attn_chunk=0, remat="full"):
    """tokens: [B, S] int -> (hidden [B, S, d], aux_loss 0)."""
    B, S = tokens.shape
    x = constrain(L.embed_apply(params["embed"], tokens))
    positions = torch.arange(S, device=x.device)
    mask = T._gates(cfg, layer_mask, x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)

    def body(x, mp, gate):
        d, _ = mamba_apply(mp, cfg, x)
        return constrain(T._residual(x, d, gate.to(x.dtype)))

    body = T._remat_wrap(body, "none" if remat == "none" else "full")
    blocks = T._unstack(params["mamba"], cfg.num_layers)
    lo = 0
    for size in _segments(cfg):
        for i in range(lo, lo + size):
            x = body(x, blocks[i], mask[i])
        lo += size
        if _site_after(cfg, size):
            x, _, _ = T.block_apply(params["shared_attn"], cfg, x, positions,
                                    one, window=window, use_pallas=use_pallas,
                                    attn_chunk=attn_chunk)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(params, cfg, hidden):
    return L.logits_apply(hidden, unembed_matrix(params, cfg))


def decode_init(params, cfg, batch: int, seq_len: int, *, window=None):
    """The decode state on the params' device: ``mamba`` (``ssm``,
    ``conv``; ``[L, B, ...]`` float32) and ``attn`` (``k``, ``v`` [sites,
    B, clen, Hkv, hd] in ``cfg.dtype``, ``pos`` [sites] int32) and
    ``pos``, the reference's int32 count of decoded steps."""
    w = cfg.window if window is None else window
    clen = min(seq_len, w) if w else seq_len
    dev = params["embed"]["emb"].device
    n_sites = num_attn_sites(cfg)
    shape = (n_sites, batch, clen, cfg.num_kv_heads, cfg.hd)
    return {
        "mamba": mamba_state_init(cfg, batch, dev, lead=(cfg.num_layers,)),
        "attn": {"k": L.cache_leaf(shape, 0, T._dt(cfg), dev),
                 "v": L.cache_leaf(shape, 0, T._dt(cfg), dev),
                 "pos": L.cache_leaf((n_sites,), 0, torch.int32, dev)},
        "pos": L.cache_leaf((), 0, torch.int32, dev),
    }


@torch.no_grad()
def decode_step(params, cfg, cache, tokens, pos, *, layer_mask=None,
                window=None):
    """tokens: [B, 1]; pos: the absolute position (an int or a 0-d
    tensor).  Returns (logits [B, 1, V], cache), the cache updated in
    place (on the mesh each Mamba2 block's state by its region, each
    site's KV cache by the attention's)."""
    x, positions = T.decode_embed(params, tokens, pos)
    mask = T._gates(cfg, layer_mask, tokens.device)
    one = torch.ones((), dtype=x.dtype, device=tokens.device)
    blocks = T._unstack(params["mamba"], cfg.num_layers)
    states, attn = cache["mamba"], cache["attn"]
    lo, site = 0, 0
    for size in _segments(cfg):
        for i in range(lo, lo + size):
            st = T.layer_cache(states, i, ("ssm", "conv"))
            d, new = mamba_decode(blocks[i], cfg, x, st)
            for k, v in new.items():
                tp.put(st[k], v)
            x = constrain(T._residual(x, d, mask[i].to(x.dtype)))
        lo += size
        if _site_after(cfg, size):
            x, _, _ = T.block_apply(params["shared_attn"], cfg, x, positions,
                                    one, window=window,
                                    cache=T.layer_cache(attn, site))
            site += 1
    tp.local_of(cache["pos"]).add_(1)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x), cache
