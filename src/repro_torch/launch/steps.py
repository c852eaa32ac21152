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
form of the reference's donated state.  The FL-over-pods steps
(``build_fl_train_step``, ``build_fl_bucketed_train_step``,
``fl_batch_extras``) feed only the dry-run and wait for that slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models.api import build
from repro_torch.optim.optimizers import adamw_init, adamw_update_
from repro_torch.optim.schedules import make_schedule
from repro_torch.tree import tree_leaves, tree_unflatten_like


def chunked_cross_entropy(hidden, w_unembed, labels, chunk: int):
    """hidden: [B,S,d]; w_unembed: [d,V]; labels: [B,S] int -> mean nll.

    Walks the sequence in chunks; each step makes only [B,chunk,V]
    logits.  Labels < 0 are masked out; lengths that ``chunk`` does not
    divide take one chunk."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // chunk):
        h = hidden[:, i * chunk:(i + 1) * chunk]
        lab = labels[:, i * chunk:(i + 1) * chunk]
        logits = (h @ w_unembed).float()                       # [B,c,V]
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           lab.clamp_min(0).long()[..., None])[..., 0]
        mask = (lab >= 0).float()
        tot = tot + ((lse - tgt) * mask).sum()
        cnt = cnt + mask.sum()
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


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """(model, train_step): ``train_step(state, batch)`` -> (state,
    metrics), ``state`` updated in place and returned."""
    model = build(cfg)
    schedule = make_schedule(tcfg.schedule, tcfg.learning_rate,
                             tcfg.warmup_steps, tcfg.total_steps)

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

    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, batch)
        grads = tree_unflatten_like(params, torch.autograd.grad(loss, leaves))
        lr = schedule(state["opt"]["step"])
        m = adamw_update_(grads, state["opt"], params, lr=lr,
                          beta1=tcfg.beta1, beta2=tcfg.beta2, eps=tcfg.eps,
                          weight_decay=tcfg.weight_decay,
                          grad_clip=tcfg.grad_clip)
        return state, {"loss": loss.detach(), "lr": lr, **m}

    return model, train_step


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
    (the reference donates it)."""
    model = build(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        kw = {}
        if window_override is not None:
            kw["window"] = window_override
        logits, cache = model.decode_step(params, cache, tokens, pos, **kw)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], cache

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
