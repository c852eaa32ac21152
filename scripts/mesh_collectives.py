"""The collectives one tensor-parallel train step makes on the (2, 2)
``("data", "model")`` debug mesh: 4 gloo ranks on the CPU, the smoke
configs of phi3-mini-3.8b and mixtral-8x22b with two KV heads, and of
xlstm-1.3b, zamba2-1.2b, whisper-medium and llama-3.2-vision-11b (the
shapes and stub inputs of ``tests/torch_mesh_ranks.py``), B 4 x S 16,
full remat, under each sharding policy.  ``CommDebugMode`` records them (the tests'
recorder, ``tests/torch_mesh_ranks.py::Collectives``); for each kind and
mesh axis the script prints their count and bytes (each collective's
largest tensor), and the largest tensor a collective over the model axis
touches beside the smallest matrix of a model-sharded param (a whole
gather of one would reach it).  The second of two steps is recorded.

    PYTHONPATH=src python scripts/mesh_collectives.py
    PYTHONPATH=src python scripts/mesh_collectives.py --decode

``--decode`` records one meshed decode step instead
(``launch/train.py::meshed_serve_step`` on a cache from
``sharded_decode_cache``), for each case of
``tests/torch_mesh_ranks.py::DECODE`` (each layout of the reference's
cache specs: KV heads, cache rows, head dim, the MoE gather on expert
and FFN-width shards and through the capacity region, xLSTM's heads and
key dim, the Mamba2 state, whisper, the VLM) at its B 4 and cache
length, the third of three steps from two slots before the cache's end;
beside the largest tensor over the model axis it prints the smallest
model-sharded KV-cache shard.

``torch.distributed`` calls (the loss and norm all-reduces, the
vocab-parallel logsumexp's max and sum, the load-balance loss's token
means, the ``dp2d`` rows' token gather) do not name their group in the
record and are listed under ``c10d``.  Bytes are those of the smoke
shapes; no time is taken.
"""
from __future__ import annotations

import collections
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]



def _table(rec, axis):
    """(count and bytes by (kind, axis), the largest tensor over the model
    axis) of a ``Collectives`` record."""
    rows = collections.defaultdict(lambda: [0, 0])
    biggest = 0
    for op, group, n, nbytes in rec.seen:
        where = axis.get(group, group)
        rows[(op, where)][0] += 1
        rows[(op, where)][1] += nbytes
        if where in ("model", "c10d"):
            biggest = max(biggest, n)
    return ", ".join(f"{op} over {where} {c} ({b} bytes)"
                     for (op, where), (c, b) in sorted(rows.items())), biggest


def _decode(rank, mesh, axis):
    from torch_mesh_ranks import (DECODE, DECODE_SHAPE, DEFAULTS, POLICIES,
                                  Collectives, _batches)
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train as T
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.sharding.rules import map_with_path, set_sharding_policy
    B = DECODE_SHAPE[0]
    mi = mesh.mesh_dim_names.index("model")
    for label, arch, over, clen, _, pols in DECODE:
        cfg = reduced(get_config(arch), **over)
        for name in pols:
            set_sharding_policy(**DEFAULTS)
            set_sharding_policy(**POLICIES[name])
            model, serve = build_serve_step(cfg)
            params = T.sharded_train_state(model, torch.device("cpu"),
                                           mesh)["params"]
            extras = {k: v for k, v in _batches(cfg, 1, B=B)[0].items()
                      if k not in ("tokens", "labels")}
            cache = T.sharded_decode_cache(model, params, B, clen, mesh,
                                           extras=extras)
            run = T.meshed_serve_step(serve, mesh)
            tok = torch.zeros((B, 1), dtype=torch.int32)
            for i in range(3):
                with Collectives() as rec:
                    tok, cache = run(params, cache, tok, clen - 2 + i)
            kv = []
            map_with_path(lambda p, t: kv.append(t.to_local().numel())
                          if p.split("/")[-1] in ("k", "v")
                          and t.placements[mi].is_shard() else None, cache)
            table, biggest = _table(rec, axis)
            if rank == 0:
                print(f"decode {label} ({arch}-smoke) {name}: "
                      f"{len(rec.seen)} collectives, "
                      f"{sum(b for *_, b in rec.seen)} bytes: {table}; the "
                      f"largest tensor over the model axis {biggest} "
                      f"elements, the smallest model-sharded KV-cache "
                      f"shard {min(kv) if kv else None}", flush=True)
    set_sharding_policy(**DEFAULTS)


def _rank(rank, path, decode):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=4)
    if decode:
        from repro_torch.launch.mesh import make_debug_mesh
        mesh = make_debug_mesh()
        _decode(rank, mesh, {mesh.get_group(a).group_name: a
                             for a in mesh.mesh_dim_names})
        dist.destroy_process_group()
        return
    from torch_mesh_ranks import (DEFAULTS, FAMILIES, OVER, POLICIES,
                                  XLSTM_ARCH, Collectives, _batches)
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_train_step, make_train_state
    from repro_torch.sharding.rules import set_sharding_policy
    from repro_torch.tree import tree_leaves
    mesh = make_debug_mesh()
    axis = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                       loss_chunk=8, remat="full")
    archs = ((("phi3-mini-3.8b", OVER), ("mixtral-8x22b", OVER),
              (XLSTM_ARCH, {})) + tuple(f[:2] for f in FAMILIES))
    for arch, over in archs:
        cfg = reduced(get_config(arch), **over)
        batch = _batches(cfg, 1)[0]
        for name, pol in POLICIES.items():
            set_sharding_policy(**DEFAULTS)
            set_sharding_policy(**pol)
            model, step = build_train_step(cfg, tcfg)
            state = T.place_state(make_train_state(
                model, torch.Generator().manual_seed(0), tcfg), mesh)
            run = T.meshed_step(step, mesh)
            state, _ = run(state, batch)
            with Collectives() as rec:
                state, _ = run(state, batch)
            mi = mesh.mesh_dim_names.index("model")
            layer = min(t.shape[-2] * t.shape[-1]
                        for t in tree_leaves(state["params"])
                        if isinstance(t, DTensor)
                        and t.placements[mi].is_shard())
            table, biggest = _table(rec, axis)
            if rank == 0:
                print(f"{arch}-smoke {name}: {len(rec.seen)} collectives, "
                      f"{sum(b for *_, b in rec.seen)} bytes: {table}; the "
                      f"largest tensor over the model axis {biggest} "
                      f"elements, the smallest model-sharded matrix {layer}",
                      flush=True)
    set_sharding_policy(**DEFAULTS)
    dist.destroy_process_group()


def main():
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(f"{tmp}/pg",
                                        "--decode" in sys.argv[1:]),
                           nprocs=4, start_method="spawn")


if __name__ == "__main__":
    main()
