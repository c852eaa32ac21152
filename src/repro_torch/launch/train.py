"""Training launcher — port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --smoke --steps 20 --batch 8 --seq 64 --device cpu

    # the production mesh (256 ranks; 512 with --mesh multi); a rank
    # holds only its shards (see below):
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
size raises ``ValueError``) and installs it as the activation mesh.  The
params and AdamW moments are ``DTensor``s placed by
:func:`repro_torch.launch.specs.state_shardings` (each rank holds the
shards the rules name).  For every family the state is built leaf by
leaf (:func:`sharded_train_state`: each leaf drawn as one process draws
it and cut to this rank's shard at once), and :func:`meshed_step` runs
the step on the shards: the model splits its compute over the model
axis as the reference's GSPMD does (``sharding/tp.py``; the dense and
MoE decoders, xLSTM, the Mamba2 hybrid, whisper and the VLM), no param
is gathered over it, and each rank updates its shards in place.  A rank
holds its shards, one layer's weights gathered over the FSDP axis, and
its activations.  Under a mesh ``--ckpt-dir`` gathers the state, rank 0
writes the reference's files, and every rank loads them whole and keeps
its shards.

Prefill and decode run on the mesh too (:func:`meshed_prefill_step`,
:func:`meshed_serve_step` on the steps of ``launch/steps.py``'s
``build_prefill_step`` and ``build_serve_step``): the decode cache is
built as each rank's shards in the reference's placements
(:func:`sharded_decode_cache`) and written in place, decode runs with
the mesh installed as the reference's dry-run lowers it
(``model_axis_ok=False``), and no param, cache or state leaf is
gathered over ``model``.
"""
from __future__ import annotations

import argparse
import contextlib
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
from repro_torch.launch.specs import (_MetaGenerator, decode_cache_shardings,
                                      state_shardings)
from repro_torch.launch.steps import (TrainStep, adapt_for_shape,
                                      build_train_step, make_train_state)
from repro_torch.models import layers as L
from repro_torch.models.api import extra_inputs
from repro_torch.sharding import tp
from repro_torch.sharding.rules import (activation_mesh, batch_axes,
                                        map_with_path, mesh_size,
                                        model_axis_ok, placements,
                                        set_activation_mesh, spec_for)
from repro_torch.tree import tree_leaves, tree_map


def _on_disk(state):
    """The state as the reference saves it: the step an int32 scalar."""
    return {"params": state["params"],
            "opt": dict(state["opt"], step=np.int32(state["opt"]["step"]))}


@torch.no_grad()
def _restore(state, path):
    """Load ``path`` into ``state``'s tensors in place (a ``DTensor``'s
    shard from the whole leaf)."""
    loaded = load_pytree(path, _on_disk(state))
    for dst, src in zip(tree_leaves(_on_disk(state)), tree_leaves(loaded)):
        if isinstance(dst, DTensor):
            dst.to_local().copy_(local_shard(
                torch.as_tensor(src), dst.device_mesh, dst.placements))
        elif isinstance(dst, torch.Tensor):
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


def _placed_zeros(shape, mesh, placements, device):
    """A float32 ``DTensor`` of zeros of the global ``shape``, each rank
    making only its shard."""
    local = local_shard(torch.empty(shape, device="meta"), mesh,
                        placements).shape
    return DTensor.from_local(
        torch.zeros(local, dtype=torch.float32, device=device), mesh,
        placements, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def sharded_train_state(model, device, mesh, seed: int = 0):
    """The train state that ``place_state(make_train_state(model,
    Generator(device).manual_seed(seed)), mesh)`` gives, built leaf by
    leaf: the leaves' order and paths from the model's ``init`` on the
    meta device, then the same ``init`` on ``device``, each leaf cut to
    this rank's shard as soon as its initialiser makes it
    (``models.layers.leaf_hook``) and the moments made as shards.  A
    rank holds its shards and one whole leaf at a time, never the whole
    state."""
    made = []
    with L.leaf_hook(lambda t: made.append(t) or t):
        shapes = model.init(_MetaGenerator())
    paths = {}
    map_with_path(lambda path, t: paths.setdefault(id(t), path), shapes)
    order = [paths.get(id(t)) for t in made]
    if None in order or sorted(order) != sorted(paths.values()):
        raise RuntimeError(f"{model.cfg.name}: its init makes a leaf outside "
                           "the initialisers' leaf hook (models/layers.py)")
    shardings = state_shardings({"params": shapes, "opt": {"step": 0}}, mesh)
    where = {}
    map_with_path(lambda path, t: where.setdefault(
        path, placements(spec_for(path, t.shape, mesh), mesh)), shapes)
    queue = iter(order)

    def cut(t):
        pl = where[next(queue)]
        local = local_shard(t, mesh, pl)
        if local is not t:
            local = local.clone()     # let the whole leaf go
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    with L.leaf_hook(cut):
        params = model.init(torch.Generator(device).manual_seed(seed))

    def moments():
        return tree_map(lambda s, pl: _placed_zeros(s.shape, mesh, pl,
                                                    device),
                        shapes, shardings["opt"]["mu"])
    return {"params": params,
            "opt": {"step": 0, "mu": moments(), "nu": moments()}}


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


def batch_shard(batch, mesh, rows: int = 0):
    """This rank's shard of a global batch (every rank holds it whole)
    over :func:`batch_axes`: tokens, labels and stub inputs split dim
    ``rows`` (1 for the bucketed FL step's bucket-major batch), the FL
    gates dim 1."""
    axes = batch_axes(mesh)
    n = mesh_size(mesh, axes)
    idx = _batch_index(mesh, axes)
    out = {}
    for k, v in batch.items():
        d = _BATCH_DIM.get(k, rows if k in ("tokens", "labels") else 0)
        if d is None:
            out[k] = v
            continue
        if v.shape[d] % n:
            raise ValueError(f"batch entry {k!r} has {v.shape[d]} rows on "
                             f"dim {d}, which {n} batch shards "
                             f"({'x'.join(axes)}) do not divide")
        out[k] = v.chunk(n, dim=d)[idx]
    return out


def _sharded_norm(grads, mesh) -> torch.Tensor:
    """The whole gradient's global norm from each rank's shards: each
    leaf's sum of squares summed over the mesh dims that shard it."""
    leaves = tree_leaves(grads)
    sq = torch.stack([torch.sum(torch.square(g.to_local().float()))
                      for g in leaves])
    for i in range(mesh.ndim):
        sharded = torch.tensor([g.placements[i].is_shard() for g in leaves],
                               device=sq.device)
        if mesh.size(i) == 1 or not bool(sharded.any()):
            continue
        part = torch.where(sharded, sq, torch.zeros_like(sq))
        dist.all_reduce(part, group=mesh.get_group(i))
        sq = torch.where(sharded, part, sq)
    return torch.sqrt(sq.sum())


def meshed_step(step: TrainStep, mesh):
    """``step`` (any of ``launch/steps.py``'s train steps) on a state
    placed by :func:`place_state` (or :func:`sharded_train_state`): it
    computes what ``step`` computes on the whole batch.  Every rank
    passes the whole global batch; returns (state, metrics), the
    state's shards updated in place.

    The step runs on the params' ``DTensor``s with the activation mesh
    installed: the model splits its compute over the model axis
    (``sharding/tp.py``; every family) and never gathers a param over
    it; the gradients come back in the params' placements, summed over
    the batch ranks, and are divided by their count (the mean of equal
    shards' mean losses is the batch's); the clip reads the whole
    gradient's norm (:func:`_sharded_norm`); AdamW updates each rank's
    shards in place, and where a moment is sharded finer than its param
    (``zero1``) the moment's region of the param, gathered back into the
    param's shard (:func:`_write_back`)."""
    axes = batch_axes(mesh)
    groups = [mesh.get_group(a) for a in axes]
    n = mesh_size(mesh, axes)

    def run(state, batch):
        params, opt = state["params"], state["opt"]
        with _installed(mesh):
            loss, grads = step.grads(params,
                                     batch_shard(batch, mesh, step.batch_dim))
        loss = loss.detach()
        for g in groups:
            dist.all_reduce(loss, group=g)
        loss.div_(n)
        if n > 1:
            for g in tree_leaves(grads):
                g.to_local().div_(n)
        region = tree_map(lambda m: tuple(m.placements), opt["mu"])
        with torch.no_grad():
            local_grads = tree_map(
                lambda g, pl: (g if tuple(g.placements) == pl else
                               g.redistribute(mesh, pl)).to_local(),
                grads, region)
            targets = tree_map(
                lambda p, pl: p.to_local() if tuple(p.placements) == pl
                else p.redistribute(mesh, pl).to_local().clone(),
                params, region)
        lr, m = _update_shards(step, state, local_grads, targets, region,
                               mesh, _sharded_norm(grads, mesh))
        return state, {"loss": loss, "lr": lr, **m}

    return run


@contextlib.contextmanager
def _installed(mesh, axis_ok=None):
    """``mesh`` as the activation mesh while a step runs, with
    ``model_axis_ok`` ``axis_ok`` (by default kept where the caller
    installed this mesh, else True)."""
    outer, ok = activation_mesh(), model_axis_ok()
    if axis_ok is None:
        axis_ok = ok if outer is mesh else True
    set_activation_mesh(mesh, axis_ok)
    try:
        yield
    finally:
        set_activation_mesh(outer, ok)


# ---------------------------------------------------------------------------
# prefill and decode on a mesh
# ---------------------------------------------------------------------------


def _by_path(tree, path=""):
    """{path: leaf} of a spec or placements tree (dicts and lists; its
    tuples are leaves), paths as ``map_with_path`` joins them."""
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_by_path(v, f"{path}/{k}" if path else str(k)))
    return out


def sharded_decode_cache(model, params, batch: int, seq_len: int, mesh,
                         extras=None, **kw):
    """The decode cache of ``model.decode_init(params, batch, seq_len,
    extras=extras, **kw)`` on the params' ``DTensor``s, each leaf a
    ``DTensor`` in the placements ``specs.decode_cache_shardings`` names
    (the reference's ``cache_specs``), made as this rank's shard: the
    leaves' order and paths from ``decode_init`` on the meta device, then
    ``decode_init`` itself with each leaf made as its shard as it is
    made (``models.layers.cache_hook``); the whole cache never exists on
    one rank.  Whisper's encoder and the VLM's image projection run
    through their regions (the mesh installed in decode mode,
    ``model_axis_ok=False``) and their cross K/V are written into the
    cache's placements.  ``extras``: the stub-frontend inputs, whole on
    every rank (zeros where absent), of which each rank takes its rows
    (:func:`batch_shard`)."""
    cfg = model.cfg
    shapes = extra_inputs(cfg, batch, seq_len)
    made = []

    def record(shape, value, dtype, device):
        made.append(torch.empty(shape, dtype=dtype, device="meta"))
        return made[-1]
    with L.cache_hook(record):
        meta = model.decode_init(
            model.init(_MetaGenerator()), batch, seq_len,
            extras={k: torch.empty(s, dtype=d, device="meta")
                    for k, (s, d) in shapes.items()}, **kw)
    paths = {}
    map_with_path(lambda path, t: paths.setdefault(id(t), path), meta)
    order = [paths.get(id(t)) for t in made]
    if None in order or sorted(order) != sorted(paths.values()):
        raise RuntimeError(f"{cfg.name}: its decode_init makes a cache leaf "
                           "outside models.layers.cache_leaf")
    where = _by_path(decode_cache_shardings(meta, mesh))
    queue = iter(order)

    def make(shape, value, dtype, device):
        pl = where[next(queue)]
        whole = torch.empty(shape, device="meta")
        local = local_shard(whole, mesh, pl).shape
        return DTensor.from_local(
            torch.full(local, value, dtype=dtype, device=device), mesh, pl,
            run_check=False, shape=whole.shape, stride=whole.stride())
    device = tree_leaves(params)[0].device
    extras = {k: (extras or {}).get(k, torch.zeros(s, dtype=d, device=device))
              for k, (s, d) in shapes.items()}
    with _installed(mesh, False), L.cache_hook(make):
        return model.decode_init(params, batch, seq_len,
                                 extras=batch_shard(extras, mesh), **kw)


def meshed_prefill_step(step, mesh):
    """``step`` (``launch/steps.py::build_prefill_step``'s) on the params'
    ``DTensor``s: every rank passes the whole batch and takes its rows
    (:func:`batch_shard`), the model splits its compute over the model
    axis as in training (``flash_attention``'s local-shard entry under
    ``use_pallas``), and the last position's logits [B, 1, V], vocab-
    parallel on the ranks, come back gathered, whole on every rank."""
    def run(params, batch):
        with _installed(mesh):
            logits = step(params, batch_shard(batch, mesh))
        return logits.full_tensor() if isinstance(logits, DTensor) \
            else logits
    return run


def meshed_serve_step(step, mesh):
    """``step`` (``launch/steps.py::build_serve_step``'s) on the params'
    ``DTensor``s and a cache from :func:`sharded_decode_cache`, the mesh
    installed in decode mode (``model_axis_ok=False``, as the
    reference's dry-run lowers decode): every rank passes the whole
    tokens [B, 1] and takes its rows; each layer reads and writes its
    shards of the cache in place (no cache leaf is gathered, and every
    leaf keeps its placements and storage); the argmax is
    vocab-parallel.  Returns (the next tokens [B, 1], whole on every
    rank, the cache), and with ``logits=True`` the step's logits [B, 1,
    V] third, as the ranks hold them (a ``DTensor``, its vocab over
    ``model``: ``full_tensor()`` gathers them).  The batch over the
    model axis (``dp2d``) is refused."""
    def run(params, cache, tokens, pos, logits=False):
        if "model" in batch_axes(mesh):
            raise NotImplementedError("decode on the mesh with the batch "
                                      "over the model axis (dp2d) is not "
                                      "ported")
        with _installed(mesh, False):
            out = step(params, cache,
                       batch_shard({"tokens": tokens}, mesh)["tokens"], pos,
                       logits=logits)
            tok = tp.from_local(out[0], tp.compute_placements(mesh),
                                mesh=mesh).full_tensor()
        return (tok,) + tuple(out[1:])
    return run


def _update_shards(step, state, local_grads, targets, region, mesh, gnorm):
    """AdamW on this rank's moments and the params' update regions
    (``targets``), clipped by the whole gradient's norm ``gnorm``; the
    regions of params that their moments shard finer are gathered back
    (:func:`_write_back`).  Returns (lr, metrics)."""
    opt = state["opt"]
    local_opt = {"step": opt["step"],
                 "mu": tree_map(lambda t: t.to_local(), opt["mu"]),
                 "nu": tree_map(lambda t: t.to_local(), opt["nu"])}
    lr, m = step.update_(local_grads, local_opt, targets, grad_norm=gnorm)
    opt["step"] = local_opt["step"]
    _write_back(state["params"], targets, region, mesh)
    return lr, m


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
    if mesh is not None:
        state = sharded_train_state(model, device, mesh)
    else:
        state = make_train_state(
            model, torch.Generator(device).manual_seed(0), tcfg)
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
