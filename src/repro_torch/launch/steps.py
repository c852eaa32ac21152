"""Step builders: train_step / prefill_step / serve_step — port of
``repro.launch.steps`` for the families :func:`repro_torch.models.api.build`
builds.

A batch carries ``tokens`` (and ``labels`` to train); its other entries
are the family's stub-frontend inputs (``extra_inputs``), passed to the
model as ``extras``.  The train step computes a sequence-chunked
cross-entropy (never
materialises the full ``[B, S, V]`` logits tensor), per-layer remat
happens inside the model's ``apply``, and AdamW updates the state IN
PLACE (:func:`repro_torch.optim.optimizers.adamw_update_`), the port's
form of the reference's donated state.  Each train step is a
:class:`TrainStep`: its gradient function, then that update, so a
sharded caller (``launch/train.py::meshed_step``) runs the same two
halves around its collectives.

The FL-over-pods steps (:func:`build_fl_train_step`,
:func:`build_fl_bucketed_train_step`, :func:`fl_batch_extras`) are the
paper's Step 2 inside the LM train loop: each client trains a
depth-prefix submodel (:mod:`repro_torch.core.layerwise`), and the
layer-aligned masked mean falls out of the batch-mean gradient, rescaled
per layer.

On the production mesh every family's steps run on the params'
``DTensor``s (``launch/train.py::meshed_step``): the model splits its
compute over the model axis (``sharding/tp.py``), and the
cross-entropy is vocab-parallel (each rank's logits only for its vocab
shard of the unembedding, a logsumexp across the shards, no gather of
the logits); the FL steps' per-layer gates and rescale stay replicated.
The prefill and serve steps run there too (``launch/train.py``'s
``meshed_prefill_step`` and ``meshed_serve_step``): the serve step's
argmax is vocab-parallel (:func:`greedy`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.layerwise import exit_points
from repro_torch.models import transformer as T
from repro_torch.models.api import build
from repro_torch.optim.optimizers import adamw_init, adamw_update_
from repro_torch.optim.schedules import make_schedule
from repro_torch.sharding import tp
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of vocab shards, one on each
    of ``group``'s ranks, in ATen's own steps (the max, zero where
    infinite; the sum of the exponentials of the differences; its log
    plus the max), the max and the sum all-reduced, and with ATen's
    backward (``grad * exp(x - lse)``)."""

    @staticmethod
    def forward(ctx, x, group):
        m = torch.amax(x, dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        m.masked_fill_(m.abs() == float("inf"), 0)
        s = torch.exp(x - m).sum(dim=-1)
        dist.all_reduce(s, group=group)
        lse = s.log_().add_(m.squeeze(-1))
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g.unsqueeze(-1) * (x - lse.unsqueeze(-1)).exp(), None


def argmax_merge(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The shards' (local max, global index of its first occurrence),
    [m, ...] each, in vocab order, merged into ``torch.argmax``'s answer
    over the whole vocabulary: the largest value, NaN above all (as
    ``torch.argmax`` takes it), on a tie the smallest index."""
    nan = torch.isnan(vals)
    key = torch.where(nan, torch.full_like(vals, float("inf")), vals)
    best = key.amax(dim=0, keepdim=True)
    pick = (key == best) & (nan | ~nan.any(dim=0, keepdim=True))
    big = torch.iinfo(idx.dtype).max
    return torch.where(pick, idx, torch.full_like(idx, big)).amin(dim=0)


def vocab_argmax(x: torch.Tensor, lo: int, group) -> torch.Tensor:
    """``torch.argmax`` over the last dim of vocab shards, one on each of
    ``group``'s ranks (``x`` this rank's, starting at vocab index
    ``lo``): each rank's local max and its index, gathered over ``group``
    as (value, global index) pairs and merged by :func:`argmax_merge`;
    int64 indices, as ``torch.argmax`` gives.  ``group`` None: the local
    ``torch.argmax``."""
    if group is None:
        return torch.argmax(x, dim=-1)
    i = torch.argmax(x, dim=-1)
    v = torch.gather(x, -1, i[..., None])[..., 0]
    pair = torch.stack([v.double(), (i + lo).double()])
    parts = [torch.empty_like(pair) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, pair.contiguous(), group=group)
    both = torch.stack(parts, dim=1)                         # [2, m, ...]
    return argmax_merge(both[0], both[1].long())


def greedy(logits) -> torch.Tensor:
    """The next tokens [B] (int32) of a decode step's logits [B, S, V]:
    the argmax at the last position.  On the mesh (a ``DTensor`` whose
    vocab ``model`` shards, ``models.layers.logits_apply``) the
    vocab-parallel argmax (:func:`vocab_argmax`) of each rank's shard:
    this rank's rows of the compute layout, a plain tensor; no logits
    are gathered."""
    if not isinstance(logits, DTensor):
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    vocab = tp.model_shard_dim(logits) == logits.ndim - 1
    lo, _ = tp.model_range(logits, logits.ndim - 1)
    local = tp.local(logits, Shard(logits.ndim - 1)) if vocab else \
        tp.local(logits)
    return vocab_argmax(local[:, -1, :], lo,
                        tp.model_group() if vocab else None).to(torch.int32)


def chunked_cross_entropy(hidden, w_unembed, labels, chunk: int):
    """hidden: [B,S,d]; w_unembed: [d,V]; labels: [B,S] int -> mean nll.

    Walks the sequence in chunks; each step makes only [B,chunk,V]
    logits.  Labels < 0 are masked out; lengths that ``chunk`` does not
    divide take one chunk.

    On the mesh (``w_unembed`` a ``DTensor``) it is vocab-parallel where
    ``model`` shards the unembedding's vocab (the ``("embed", "vocab")``
    spec): each rank's logits [B, c, V / m] for its vocab shard
    [lo, hi), the logsumexp across the shards (:class:`_LogSumExp`), the
    target logit from the shard that holds it; no [B, S, V] logits are
    gathered.  ``hidden`` is in the compute layout, and each position's
    loss is summed on this rank's own rows, so the mean over the batch
    ranks is the batch's."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    if isinstance(w_unembed, DTensor):
        w = w_unembed
        vocab = tp.model_shard_dim(w) == w.ndim - 1
        lo, hi = tp.model_range(w, w.ndim - 1)
        group = tp.model_group() if vocab else None
        hidden = tp.local(hidden, grad=Partial() if vocab else Replicate())
        w_unembed = tp.weight(w)
        rows = tp.group_rows(labels)

        def total(nll):
            return tp.own_rows(tp.wrap(nll)).sum()
    else:
        lo, hi, group, rows, total = 0, w_unembed.shape[-1], None, labels, \
            torch.sum
    tot = torch.zeros((), dtype=torch.float32, device=labels.device)
    cnt = torch.zeros((), dtype=torch.float32, device=labels.device)
    for i in range(S // chunk):
        c = slice(i * chunk, (i + 1) * chunk)
        lab = rows[:, c]
        logits = (hidden[:, c] @ w_unembed).float()            # [B,c,V]
        lse = (torch.logsumexp(logits, dim=-1) if group is None else
               _LogSumExp.apply(logits, group))
        idx = lab.clamp_min(0).long() - lo
        tgt = torch.gather(logits, -1,
                           idx.clamp(0, hi - lo - 1)[..., None])[..., 0]
        if group is not None:
            inside = (idx >= 0) & (idx < hi - lo)
            tgt = tp.sum_over_model(torch.where(inside, tgt, 0.0))
        tot = tot + total((lse - tgt) * (lab >= 0).float())
        cnt = cnt + (labels[:, c] >= 0).float().sum()
    return tot / torch.clamp_min(cnt, 1.0)


def _unembed(model, params):
    if model.cfg.tie_embeddings:
        return params["embed"]["emb"].T
    return params["unembed"]["w"]


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def make_train_state(model, gen: torch.Generator, tcfg: TrainConfig):
    params = model.init(gen)
    return {"params": params, "opt": adamw_init(params)}


@dataclasses.dataclass(frozen=True)
class TrainStep:
    """A train step: ``grads(params, batch) -> (loss, grads)``, then the
    in-place AdamW at ``schedule``'s rate.  ``step(state, batch)`` ->
    (state, metrics), ``state`` updated in place and returned.
    ``grads`` takes plain tensors or, on the mesh, the params'
    ``DTensor``s; ``batch_dim``: the dim of ``tokens`` and ``labels``
    that holds the batch rows (the bucketed step's are bucket-major)."""
    grads: Callable
    schedule: Callable
    tcfg: TrainConfig
    batch_dim: int = 0

    def update_(self, grads, opt, params, grad_norm=None):
        """AdamW on ``params`` and ``opt`` in place; (lr, metrics)."""
        t = self.tcfg
        lr = self.schedule(opt["step"])
        m = adamw_update_(grads, opt, params, lr=lr, beta1=t.beta1,
                          beta2=t.beta2, eps=t.eps,
                          weight_decay=t.weight_decay,
                          grad_clip=t.grad_clip, grad_norm=grad_norm)
        return lr, m

    def __call__(self, state, batch):
        loss, grads = self.grads(state["params"], batch)
        lr, m = self.update_(grads, state["opt"], state["params"])
        return state, {"loss": loss.detach(), "lr": lr, **m}


def _value_and_grad(loss_fn):
    """``loss_fn``'s (loss, grads by leaf) at ``params``, which become
    leaves that require grad."""
    def grads(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, batch)
        return loss, tree_unflatten_like(params,
                                         torch.autograd.grad(loss, leaves))
    return grads


def _schedule(tcfg: TrainConfig):
    return make_schedule(tcfg.schedule, tcfg.learning_rate,
                         tcfg.warmup_steps, tcfg.total_steps)


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """(model, train_step), a :class:`TrainStep`."""
    model = build(cfg)

    def loss_fn(params, batch):
        extras = {k: batch[k] for k in batch
                  if k not in ("tokens", "labels")}
        hidden, aux = model.apply(params, batch["tokens"], extras,
                                  remat=tcfg.remat, use_pallas=tcfg.use_pallas,
                                  attn_chunk=tcfg.attn_chunk)
        loss = chunked_cross_entropy(hidden, _unembed(model, params),
                                     batch["labels"], tcfg.loss_chunk)
        if cfg.num_experts:
            loss = loss + cfg.moe_aux_coef * aux / max(cfg.num_layers, 1)
        return loss

    return model, TrainStep(_value_and_grad(loss_fn), _schedule(tcfg), tcfg)


# ---------------------------------------------------------------------------
# FL-over-pods train step (the paper's Step 2 as one step)
# ---------------------------------------------------------------------------


def _rescale(grads, scale: torch.Tensor, L: int):
    """Each leaf whose leading dim is ``L`` times ``scale`` [L], in
    float32, cast back to the grad's dtype (a ``DTensor``'s local shard:
    the layer dim is never sharded, so the rescale is replicated)."""
    def local(g):
        return (g.float() * scale.reshape((-1,) + (1,) * (g.dim() - 1))
                ).to(g.dtype)

    def leaf(g):
        if g.dim() < 1 or g.shape[0] != L:
            return g
        if isinstance(g, DTensor):
            return DTensor.from_local(local(g.to_local()), g.device_mesh,
                                      g.placements, run_check=False,
                                      shape=g.shape, stride=g.stride())
        return local(g)
    return tree_map(leaf, grads)


def build_fl_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """DR-FL in the multi-pod mapping: every pod (client) trains a
    depth-prefix submodel of the replicated global model.

    The batch carries ``layer_gates [L, B]`` — per-example submodel masks
    (constant within a client's rows, so under a mesh they shard with the
    tokens' batch axes) — ``layer_counts [L]``, how many clients train
    each layer, and ``n_clients``.  Masked-out layers are exact
    identities, so their parameter gradients vanish for the clients that
    skip them: the batch-mean gradient is the DR-FL masked SUM over the
    contributing clients divided by the client count, and rescaling the
    stacked-layer grads by ``n_clients / count_l`` makes it the paper's
    layer-aligned masked MEAN (Eq. 2 generalised).  Only the dense and
    MoE decoder families take per-example gates.  (model, a
    :class:`TrainStep`)."""
    model = build(cfg)

    def loss_fn(params, batch):
        hidden, aux = model.apply(params, batch["tokens"], {},
                                  layer_mask=batch["layer_gates"],
                                  remat=tcfg.remat, use_pallas=tcfg.use_pallas,
                                  attn_chunk=tcfg.attn_chunk)
        loss = chunked_cross_entropy(hidden, _unembed(model, params),
                                     batch["labels"], tcfg.loss_chunk)
        if cfg.num_experts:
            loss = loss + cfg.moe_aux_coef * aux / max(cfg.num_layers, 1)
        return loss

    value_and_grad = _value_and_grad(loss_fn)

    def grads(params, batch):
        loss, g = value_and_grad(params, batch)
        counts = batch["layer_counts"].float()
        n = torch.as_tensor(batch["n_clients"], dtype=torch.float32,
                            device=counts.device)
        return loss, _rescale(g, n / torch.clamp_min(counts, 1.0),
                              cfg.num_layers)

    return model, TrainStep(grads, _schedule(tcfg), tcfg)


def build_fl_bucketed_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """The FL-over-pods step without the masked layers' work.

    The masked step (:func:`build_fl_train_step`) computes every layer for
    every client and multiplies the masked ones by 0.  DR-FL submodels are
    depth prefixes from a fixed exit table, so clients are bucketed by
    submodel: the batch arrives bucket-major, ``[n_exits, B/n_exits, S]``,
    and bucket ``b`` runs only its first ``exit_points[b]`` layers (views
    of the stacked params, so their gradients land in the stacked leaves
    and the unsliced layers' are exact zeros).  The per-layer rescale to
    the masked mean uses the static exit table.  As in the reference, the
    buckets call the transformer directly, with no extras and no aux
    loss.  (model, a :class:`TrainStep`, the number of buckets)."""
    model = build(cfg)
    exits = list(exit_points(cfg))
    nb = len(exits)
    L = cfg.num_layers
    # static per-layer coverage counts
    counts = [sum(1 for k in exits if l < k) for l in range(L)]

    def _slice_blocks(params, k):
        sliced = dict(params)
        sliced["blocks"] = tree_map(
            lambda a: tp.first_layers(a, k) if isinstance(a, DTensor)
            else a[:k], params["blocks"])
        return sliced, dataclasses.replace(cfg, num_layers=k)

    def loss_fn(params, batch):
        tokens = batch["tokens"]                # [nb, B/nb, S]
        labels = batch["labels"]
        total = 0.0
        for b, k in enumerate(exits):
            sub, cfg_b = _slice_blocks(params, k)
            hidden, _ = T.apply(sub, cfg_b, tokens[b], remat=tcfg.remat,
                                use_pallas=tcfg.use_pallas,
                                attn_chunk=tcfg.attn_chunk)
            total = total + chunked_cross_entropy(
                hidden, _unembed(model, params), labels[b], tcfg.loss_chunk)
        return total / nb

    value_and_grad = _value_and_grad(loss_fn)

    def grads(params, batch):
        loss, g = value_and_grad(params, batch)
        scale = torch.tensor([nb / max(c, 1) for c in counts],
                             dtype=torch.float32, device=loss.device)
        return loss, _rescale(g, scale, L)

    return model, TrainStep(grads, _schedule(tcfg), tcfg, batch_dim=1), nb


def fl_batch_extras(cfg: ModelConfig, shape: ShapeConfig, n_clients: int = 4):
    """name -> (shape, dtype) of the FL step's extra inputs, as
    :func:`repro_torch.models.api.extra_inputs` gives a family's."""
    B = shape.global_batch
    return {"layer_gates": ((cfg.num_layers, B), torch.float32),
            "layer_counts": ((cfg.num_layers,), torch.float32),
            "n_clients": ((), torch.float32)}


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def build_prefill_step(cfg: ModelConfig, tcfg: Optional[TrainConfig] = None):
    """Batched scoring/prefill: forward pass + last-position logits."""
    model = build(cfg)
    tcfg = tcfg or TrainConfig()

    @torch.no_grad()
    def prefill_step(params, batch):
        extras = {k: batch[k] for k in batch if k != "tokens"}
        hidden, _ = model.apply(params, batch["tokens"], extras,
                                remat="none", use_pallas=tcfg.use_pallas,
                                attn_chunk=tcfg.attn_chunk)
        return model.logits(params, hidden[:, -1:, :])

    return model, prefill_step


def build_serve_step(cfg: ModelConfig, window_override: Optional[int] = None):
    """One-token greedy decode with a persistent cache, updated in place
    (the reference donates it).  ``serve_step(params, cache, tokens,
    pos)`` -> (next tokens [B, 1], cache); with ``logits=True`` the
    step's logits [B, 1, V] come third."""
    model = build(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos, logits=False):
        kw = {}
        if window_override is not None:
            kw["window"] = window_override
        out, cache = model.decode_step(params, cache, tokens, pos, **kw)
        next_tok = greedy(out)[:, None]
        return (next_tok, cache, out) if logits else (next_tok, cache)

    return model, serve_step


# ---------------------------------------------------------------------------
# long-context handling
# ---------------------------------------------------------------------------


def adapt_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Auto-enable the SWA long-context variant for full-attention archs on
    ``long_500k`` (the reference's documented deviation)."""
    full_attn = cfg.family in ("dense", "moe", "vlm", "audio") and \
        cfg.window == 0
    if shape.name == "long_500k" and full_attn:
        return dataclasses.replace(cfg, window=8192)
    return cfg
