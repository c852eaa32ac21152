"""Dense / MoE decoder-only transformer with stacked block params — port
of ``repro.models.transformer`` (the dense family: yi-34b, phi3-mini,
minitron, command-r; the moe family: mixtral-8x22b, qwen3-moe, whose
blocks hold ``models/moe.py``'s FFN in place of the SwiGLU).

The blocks keep the reference's STACKED layout: every block leaf carries
a leading ``[L]`` axis (the reference makes it with ``jax.vmap`` over
per-layer keys, ``transformer.py:62-63``), and :func:`apply` walks the
blocks' views (``torch.unbind``) in a loop where the reference runs
``lax.scan``.

DR-FL integration: ``apply`` takes ``layer_mask``, ``[L]`` or ``[L, B]``,
multiplying every block's residual delta, so a depth-prefix submodel
(paper §4.2) is ``mask = [1]*k + [0]*(L-k)``.

Remat (``transformer.py:78-84``): ``"full"`` recomputes each block in the
backward (``torch.utils.checkpoint``, non-reentrant), ``"dots"`` saves
the block's matrix products and recomputes the rest (a selective-
checkpoint policy), ``"none"`` saves everything.  The numbers are the
same under each.  A MoE block returns its router's aux loss, which
:func:`apply` sums over the layers, each weighted by its gate's mean, as
the reference's scan does.

On the production mesh (``launch/train.py::meshed_step``) the params are
``DTensor``s and so is the residual stream: the activation hooks sit at
the reference's call sites (``constrain`` after the embedding and after
each block, ``gather_block_input`` at block entry, ``transformer.py:42,
98, 110``), the embedding is vocab-parallel
(:func:`~repro_torch.models.layers.embed_apply`), the blocks' branches
split over the model axis (``models/layers.py``, ``models/moe.py``) and
each residual add reduces its branch's partial sums to the residual's
placements.  Without a mesh the hooks are the identity.  Decode runs
there too (``launch/train.py::meshed_serve_step``, the mesh installed
with ``model_axis_ok=False``): the cache's leaves are ``DTensor``s in
the reference's placements, each layer's a view of this rank's shard
(:func:`layer_cache`), written in place by the attention's region.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from torch.distributed.tensor import DTensor

from repro_torch.models import layers as L
from repro_torch.models.moe import batch_mean, moe_apply, moe_init
from repro_torch.sharding import tp
from repro_torch.sharding.rules import constrain, gather_block_input

#: the ops whose outputs ``remat="dots"`` keeps (the reference's
#: ``dots_with_no_batch_dims_saveable``: the matrix products)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def block_init(gen: torch.Generator, cfg, dtype, *, lead=()):
    """One pre-norm block's params (``lead=(L,)``: the stack of L): the
    MoE FFN under ``num_experts``, else the SwiGLU."""
    dev = gen.device
    p = {
        "attn_norm": L.rmsnorm_init(cfg.d_model, dtype=dtype, device=dev,
                                    lead=lead),
        "attn": L.attention_init(gen, cfg, dtype, lead=lead),
        "mlp_norm": L.rmsnorm_init(cfg.d_model, dtype=dtype, device=dev,
                                   lead=lead),
    }
    if cfg.num_experts:
        p["moe"] = moe_init(gen, cfg, dtype, lead=lead)
    else:
        p["mlp"] = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                 bias=cfg.mlp_bias, lead=lead)
    return p


def _residual(x, a, gate=None):
    """``x + gate * a`` (``x + a`` where ``gate`` is None).  On the mesh
    the branch's output ``a`` (a partial sum over ``model``) is reduced
    to the residual's placements, and the sum is taken on the local
    shards: the gate holds this rank's rows, which the residual's batch
    placements keep."""
    if not isinstance(x, DTensor):
        return x + a if gate is None else x + gate * a
    if tuple(a.placements) != tuple(x.placements):
        a = a.redistribute(x.device_mesh, x.placements)
    xl, al = tp.to_local(x, x.placements), tp.to_local(a, a.placements)
    y = xl + al if gate is None else xl + gate * al
    return tp.from_local(y, x.placements, x.shape, mesh=x.device_mesh)


def block_apply(p, cfg, x, positions, gate, *, window=None,
                use_pallas=False, attn_chunk=0, cache=None):
    """One pre-norm residual block.  Returns (x, cache, aux_loss)."""
    window = cfg.window if window is None else window
    x = gather_block_input(x)
    h = L.rmsnorm_apply(p["attn_norm"], x, cfg.norm_eps)
    a, cache = L.attention_apply(
        p["attn"], cfg, h, positions, causal=True, window=window,
        cache=cache, use_pallas=use_pallas, attn_chunk=attn_chunk,
        norm_eps=cfg.norm_eps)
    x = _residual(x, a, gate)
    h = L.rmsnorm_apply(p["mlp_norm"], x, cfg.norm_eps)
    if cfg.num_experts:
        m, aux = moe_apply(p["moe"], cfg, h)
    else:
        m = L.swiglu_apply(p["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=positions.device)
    x = _residual(x, m, gate)
    return x, cache, aux


def init(gen: torch.Generator, cfg):
    """The model's params on ``gen``'s device, in ``cfg.dtype``."""
    dtype = _dt(cfg)
    params = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=dtype),
        "blocks": block_init(gen, cfg, dtype, lead=(cfg.num_layers,)),
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype=dtype,
                                     device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dtype=dtype)
    return params


def unembed_matrix(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"]["emb"].T
    return params["unembed"]["w"]


def _unstack(blocks, n: int):
    """The n blocks' views of the stacked params, by ``torch.unbind``:
    its backward stacks the blocks' gradients once, where indexing each
    block would pad each gradient to the whole stack.  A ``DTensor``
    leaf's layers are views of this rank's shard (``tp.unstack``)."""
    layers = [{} for _ in range(n)]
    for k, v in blocks.items():
        parts = (_unstack(v, n) if isinstance(v, dict) else
                 tp.unstack(v, n) if isinstance(v, DTensor) else
                 torch.unbind(v))
        for layer, part in zip(layers, parts):
            layer[k] = part
    return layers


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, mode):
    if mode == "none" or not torch.is_grad_enabled():
        return fn
    if mode == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if mode == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"unknown remat mode {mode!r}")


def _gates(cfg, layer_mask, device):
    return (torch.ones((cfg.num_layers,), dtype=torch.float32, device=device)
            if layer_mask is None else layer_mask.float())


def apply(params, cfg, tokens, *, layer_mask=None, window=None,
          use_pallas=False, attn_chunk=0, remat="full"):
    """tokens: [B, S] int -> (hidden [B, S, d], aux_loss scalar).

    ``layer_mask`` is ``[L]`` (one submodel for the whole batch) or
    ``[L, B]`` (per-example depth-prefix gates).  Final logits are not
    computed here: the train step takes a sequence-chunked cross-entropy.
    """
    B, S = tokens.shape
    x = constrain(L.embed_apply(params["embed"], tokens))
    positions = torch.arange(S, device=tokens.device)
    mask = _gates(cfg, layer_mask, tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)

    def body(x, bp, gate):
        g = gate if gate.dim() == 0 else gate[:, None, None]   # [B]->[B,1,1]
        x, _, a = block_apply(bp, cfg, x, positions, g.to(x.dtype),
                              window=window, use_pallas=use_pallas,
                              attn_chunk=attn_chunk)
        return constrain(x), a

    body = _remat_wrap(body, remat)
    for i, bp in enumerate(_unstack(params["blocks"], cfg.num_layers)):
        x, a = body(x, bp, mask[i])
        # the gate's mean over the whole batch, as the reference's is
        # (each rank holds its rows' gates under a mesh)
        aux = aux + (batch_mean(mask[i].mean()) if cfg.num_experts
                     else mask[i].mean()) * a
    return L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps), aux


def logits_fn(params, cfg, hidden):
    return L.logits_apply(hidden, unembed_matrix(params, cfg))


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------


def decode_cache_len(cfg, seq_len: int) -> int:
    """SWA models keep a ring-sized window cache; full attention keeps all."""
    return min(seq_len, cfg.window) if cfg.window else seq_len


def decode_init(params, cfg, batch: int, seq_len: int, *, window=None):
    """The decode cache on the params' device: ``k``, ``v`` [L, B, clen,
    Hkv, hd] and ``pos`` [L] (int32), written in place by
    :func:`decode_step`."""
    w = cfg.window if window is None else window
    clen = min(seq_len, w) if w else seq_len
    dev = params["embed"]["emb"].device
    shape = (cfg.num_layers, batch, clen, cfg.num_kv_heads, cfg.hd)
    return {"k": L.cache_leaf(shape, 0, _dt(cfg), dev),
            "v": L.cache_leaf(shape, 0, _dt(cfg), dev),
            "pos": L.cache_leaf((cfg.num_layers,), 0, torch.int32, dev)}


def layer_cache(cache, i, keys=("k", "v", "pos")):
    """Layer ``i``'s entries of a stacked cache (views: ``tp.layer``)."""
    return {k: tp.layer(cache[k], i) for k in keys}


def decode_embed(params, tokens, pos):
    """A decode step's input: the embedding of ``tokens`` [B, 1]
    (vocab-parallel on the mesh, :func:`~repro_torch.models.layers.
    embed_apply`) under the residual's constraint, and the step's
    positions [1] from ``pos`` (an int or a 0-d tensor)."""
    x = constrain(L.embed_apply(params["embed"], tokens))
    positions = (torch.full((1,), pos, dtype=torch.int32,
                            device=tokens.device)
                 if isinstance(pos, int) else pos.reshape(1))
    return x, positions


@torch.no_grad()
def decode_step(params, cfg, cache, tokens, pos, *, layer_mask=None,
                window=None):
    """tokens: [B, 1]; pos: the absolute position (an int or a 0-d
    tensor).  Returns (logits [B, 1, V], cache), the cache updated in
    place."""
    x, positions = decode_embed(params, tokens, pos)
    mask = _gates(cfg, layer_mask, tokens.device)
    for i, bp in enumerate(_unstack(params["blocks"], cfg.num_layers)):
        x, _, _ = block_apply(bp, cfg, x, positions, mask[i].to(x.dtype),
                              window=window, cache=layer_cache(cache, i))
        x = constrain(x)
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x), cache
