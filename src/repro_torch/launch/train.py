"""Training launcher — port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --smoke --steps 20 --batch 8 --seq 64 --device cpu

    # the production mesh (256 ranks; 512 with --mesh multi); every rank
    # holds the whole model's state and gradients (see below):
    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
        --arch phi3-mini-3.8b --shape train_4k --mesh single \
        --ckpt-dir /ckpt/phi3

Runs on the card (``--device cuda``, the default) unless told otherwise.
``--use-pallas`` launches the hand-written ``flash_attention`` kernel in
every block (forward, the remat recompute and backward).  The state is
updated in place (the reference donates it).  Checkpoints are the
reference's files (``repro_torch.checkpoint``'s ``save_pytree``), so a
run resumes from either package's ``--ckpt-dir``.  The cross-attention
families train on zero stub-frontend inputs, as in the reference.  The
reference's ``--fl-clients``/``--fl-agg-every`` are parsed there but
drive nothing; the port leaves them out.

``--mesh single|multi`` initialises the default group from torchrun's
environment (NCCL with each rank on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``), builds the production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`; another world
size raises ``ValueError``) and installs it as the activation mesh.  What
this mapping is: it reproduces the reference's values and its state
layout, not its compute layout.  The params and AdamW moments are
``DTensor``s placed by :func:`repro_torch.launch.specs.state_shardings`
(each rank holds the shards the rules name), and :func:`meshed_step` is
data parallelism over the batch axes: each step gathers the params
whole, takes the gradient of this rank's batch shard, averages it over
the batch ranks, clips by the whole gradient's norm and updates each
rank's shards in place.  So the mesh saves no memory yet: every rank
builds the whole state before it keeps its shards, and holds the whole
params and gradients in each step, so it runs only models whose whole
state and gradients fit one device.  The model axis's tensor-parallel
compute and the MoE experts' parallelism (the dispatch's all-to-all) are a later
slice's.  Under a mesh ``--ckpt-dir`` gathers the state, rank 0 writes
the reference's files, and every rank loads them whole and keeps its
shards.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.checkpoint import latest_step, load_pytree, save_pytree
from repro_torch.configs import (INPUT_SHAPES, TrainConfig, get_config,
                                 get_smoke_config)
from repro_torch.data.synthetic import lm_batches, synthetic_lm_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import state_shardings
from repro_torch.launch.steps import (TrainStep, adapt_for_shape,
                                      build_train_step, make_train_state)
from repro_torch.models.api import extra_inputs
from repro_torch.optim.optimizers import global_norm
from repro_torch.sharding.rules import (activation_mesh, batch_axes,
                                        mesh_size, set_activation_mesh)
from repro_torch.tree import tree_leaves, tree_map


def _on_disk(state):
    """The state as the reference saves it: the step an int32 scalar."""
    return {"params": state["params"],
            "opt": dict(state["opt"], step=np.int32(state["opt"]["step"]))}


@torch.no_grad()
def _restore(state, path):
    """Load ``path`` into ``state``'s tensors in place."""
    loaded = load_pytree(path, _on_disk(state))
    for dst, src in zip(tree_leaves(_on_disk(state)), tree_leaves(loaded)):
        if isinstance(dst, torch.Tensor):
            dst.copy_(torch.as_tensor(src))
    state["opt"]["step"] = int(np.asarray(loaded["opt"]["step"]))


# ---------------------------------------------------------------------------
# the state and the batch on a mesh
# ---------------------------------------------------------------------------

#: the batch dim of each batch entry that is not ``[B, ...]``: the FL
#: step's gates ``[L, B]`` shard with the batch, its counts are global
_BATCH_DIM = {"layer_gates": 1, "layer_counts": None, "n_clients": None}


def local_shard(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The view of ``x``, which every rank holds whole, that this rank
    keeps under ``placements``: each ``Shard(d)`` splits dim ``d`` over
    its mesh dim, in mesh order."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            x = x.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    return x


def place_state(state, mesh):
    """``state`` (every rank holds it whole, made from the same seed) as
    ``DTensor``s placed by :func:`state_shardings`: each rank keeps a copy
    of its shards, with no collective."""
    shardings = state_shardings(state, mesh)

    def put(x, pl):
        local = local_shard(x, mesh, pl)
        if local is not x:
            local = local.clone()     # let the whole tensor go
        return DTensor.from_local(local, mesh, pl, run_check=False)
    return {"params": tree_map(put, state["params"], shardings["params"]),
            "opt": {"step": state["opt"]["step"],
                    "mu": tree_map(put, state["opt"]["mu"],
                                   shardings["opt"]["mu"]),
                    "nu": tree_map(put, state["opt"]["nu"],
                                   shardings["opt"]["nu"])}}


@torch.no_grad()
def gather_state(state):
    """The state with every ``DTensor`` gathered whole (a collective each:
    every rank calls it)."""
    return tree_map(
        lambda t: t.full_tensor() if isinstance(t, DTensor) else t, state)


def _batch_index(mesh, axes):
    """This rank's shard of the batch: its coordinates on ``axes``,
    row-major in mesh order."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx = 0
    for a in axes:
        i = names.index(a)
        idx = idx * mesh.size(i) + coord[i]
    return idx


def batch_shard(batch, mesh):
    """This rank's shard of a global batch (every rank holds it whole)
    over :func:`batch_axes`: tokens, labels and stub inputs split dim 0,
    the FL gates dim 1."""
    axes = batch_axes(mesh)
    n = mesh_size(mesh, axes)
    idx = _batch_index(mesh, axes)
    out = {}
    for k, v in batch.items():
        d = _BATCH_DIM.get(k, 0)
        if d is None:
            out[k] = v
            continue
        if v.shape[d] % n:
            raise ValueError(f"batch entry {k!r} has {v.shape[d]} rows on "
                             f"dim {d}, which {n} batch shards "
                             f"({'x'.join(axes)}) do not divide")
        out[k] = v.chunk(n, dim=d)[idx]
    return out


def meshed_step(step: TrainStep, mesh):
    """``step`` (:func:`build_train_step`'s or
    :func:`~repro_torch.launch.steps.build_fl_train_step`'s) on a state
    placed by :func:`place_state`, as data parallelism over the batch
    axes of ``mesh``: it computes what ``step`` computes on the whole
    batch.  The mean of equal shards' mean losses is the batch's; the one
    term that is not such a mean, the MoE load-balance loss (a product of
    token means), takes its means over the batch axes of the activation
    mesh, which the step installs while it runs (``models/moe.py``).
    Every rank passes the whole global batch; returns (state, metrics),
    the state's shards updated in place.

    Each step gathers the params whole, takes the gradient of this rank's
    batch shard, all-reduces it (and the loss) over the batch axes and
    divides by their size, clips by the norm of that whole gradient, and
    runs AdamW on each rank's shards.  Where a moment is sharded finer
    than its param (``zero1``), the rank updates the moment's region of
    the param and the param's shard is gathered back from the ranks'
    regions (``redistribute``)."""
    axes = batch_axes(mesh)
    groups = [mesh.get_group(a) for a in axes]
    n = mesh_size(mesh, axes)

    def run(state, batch):
        params, opt = state["params"], state["opt"]
        with torch.no_grad():
            whole = tree_map(lambda p: p.full_tensor(), params)
        outer = activation_mesh()
        set_activation_mesh(mesh)
        try:
            loss, grads = step.grads(whole, batch_shard(batch, mesh))
        finally:
            set_activation_mesh(outer)
        loss = loss.detach()
        for t in [loss] + tree_leaves(grads):
            for g in groups:
                dist.all_reduce(t, group=g)
            t.div_(n)
        gnorm = global_norm(grads)
        mu, nu = opt["mu"], opt["nu"]
        # each leaf's update region: its moments' shard
        region = tree_map(lambda m: m.placements, mu)
        local_grads = tree_map(lambda g, pl: local_shard(g, mesh, pl),
                               grads, region)
        targets = tree_map(
            lambda p, w, pl: p.to_local() if p.placements == pl
            else local_shard(w.detach(), mesh, pl).clone(),
            params, whole, region)
        local_opt = {"step": opt["step"],
                     "mu": tree_map(lambda t: t.to_local(), mu),
                     "nu": tree_map(lambda t: t.to_local(), nu)}
        lr, m = step.update_(local_grads, local_opt, targets, grad_norm=gnorm)
        opt["step"] = local_opt["step"]
        _write_back(params, targets, region, mesh)
        return state, {"loss": loss, "lr": lr, **m}

    return run


@torch.no_grad()
def _write_back(params, targets, region, mesh):
    """The updated regions of params that their moments shard finer,
    gathered into each param's own shard."""
    def back(p, t, pl):
        if p.placements != pl:
            upd = DTensor.from_local(t, mesh, pl, run_check=False)
            p.to_local().copy_(upd.redistribute(mesh, p.placements)
                               .to_local())
        return p
    tree_map(back, params, targets, region)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def train(cfg, tcfg: TrainConfig, *, batch: int, seq: int, steps: int,
          device, mesh=None, ckpt_dir=None, ckpt_every: int = 100):
    """``steps`` train steps of ``cfg`` on ``lm_batches`` (resumed from
    ``ckpt_dir``'s latest checkpoint), on one device or, under ``mesh``,
    by :func:`meshed_step`.  Returns ``{"state", "losses"}``; under a mesh
    the state holds ``DTensor``s."""
    B, S = batch, seq
    model, train_step = build_train_step(cfg, tcfg)
    state = make_train_state(model, torch.Generator(device).manual_seed(0),
                             tcfg)
    lead = mesh is None or dist.get_rank() == 0
    start = 0
    if ckpt_dir:
        ck = latest_step(ckpt_dir)
        if ck:
            _restore(state, ck)
            start = state["opt"]["step"]
            if lead:
                print(f"resumed from {ck} (step {start})")
    if mesh is not None:
        state = place_state(state, mesh)
        train_step = meshed_step(train_step, mesh)

    toks = synthetic_lm_dataset(max(S * B * 4, 100_000), cfg.vocab_size,
                                seed=0)
    it = lm_batches(toks, B, S, seed=0)
    extras = {k: torch.zeros(shp, dtype=dt, device=device) for k, (shp, dt)
              in extra_inputs(cfg, B, S).items()}

    def save(step):
        whole = state if mesh is None else gather_state(state)
        path = None
        if lead:
            path = save_pytree(ckpt_dir, _on_disk(whole), step=step)
        if mesh is not None:
            dist.barrier()
        return path

    history = []
    t0 = time.time()
    for step in range(start, steps):
        b = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
        b.update(extras)
        state, metrics = train_step(state, b)
        history.append(metrics)
        if lead and (step % 10 == 0 or step == steps - 1):
            per_step = (time.time() - t0) / max(step - start + 1, 1)
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"({per_step:.2f}s/step)", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save(step + 1)
    if ckpt_dir:
        p = save(steps)
        if lead:
            print("saved", p)
    return {"state": state, "losses": [float(m["loss"]) for m in history]}


def _init_group(device: str) -> bool:
    """Initialise the default group from torchrun's environment (NCCL on
    ``cuda:LOCAL_RANK``, gloo on the CPU) unless there is one or no
    torchrun; True if this call made it."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    if torch.device(device).type == "cuda":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method="env://",
                                device_id=local)
    else:
        dist.init_process_group("gloo", init_method="env://")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    ap.add_argument("--use-pallas", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.shape:
        shape = INPUT_SHAPES[args.shape]
        cfg = adapt_for_shape(cfg, shape)
        B, S = shape.global_batch, shape.seq_len
    else:
        B, S = args.batch, args.seq
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps, remat=args.remat,
                       loss_chunk=min(512, S), use_pallas=args.use_pallas)
    device, mesh, own_group = args.device, None, False
    if args.mesh:
        own_group = _init_group(device)
        if own_group and dist.get_backend() == "nccl":
            device = f"cuda:{torch.cuda.current_device()}"
    try:
        if args.mesh:
            mesh = make_production_mesh(multi_pod=args.mesh == "multi")
            set_activation_mesh(mesh)
        return train(cfg, tcfg, batch=B, seq=S, steps=args.steps,
                     device=resolve_device(device), mesh=mesh,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    finally:
        set_activation_mesh(None)
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
