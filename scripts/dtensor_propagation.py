"""What ``DTensor``'s own sharding propagation does on the operations of
the dense and MoE decoders' train step, on the (2, 2) ``("data",
"model")`` debug mesh: 4 gloo ranks on the CPU, the params placed as
``sharding/rules.py`` places them (FSDP over ``data``, the model dim
over ``model``) and the activations batch-sharded over ``data``.  For
each operation the script prints the collectives propagation inserts
(each with its input and output shapes) and the placements it gives the
result.  It shows where propagation alone would miss the layout the
reference names, which is why ``sharding/tp.py`` writes the model's
regions with their placements stated.

    PYTHONPATH=src python scripts/dtensor_propagation.py

Shapes: B 4, S 16, d 64, MLP width 128, vocab 256, 4 experts.  No time
is taken.
"""
from __future__ import annotations

import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_flatten


class _Shapes(CommDebugMode):
    """``CommDebugMode`` that keeps each collective's op and the shapes
    of its input and output tensors."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if getattr(func, "_overloadpacket", None) in self.comm_registry:
            def shapes(x):
                return [tuple(t.shape) for t in tree_flatten(x)[0]
                        if isinstance(t, torch.Tensor)]
            self.seen.append(f"{func.__name__.split('.')[0]} "
                             f"{shapes((args, kwargs))} -> {shapes(out)}")
        return out


def _rank(rank, path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(0)
    B, S, d, f, V, E = 4, 16, 64, 128, 256, 4

    def put(shape, placements, ints=False):
        t = (torch.randint(0, V, shape, generator=g) if ints else
             torch.randn(shape, generator=g))
        return distribute_tensor(t, mesh, placements)
    rows = (Shard(0), Replicate())
    x = put((B, S, d), rows)
    w_up = put((d, f), (Shard(0), Shard(1)))          # ("embed", "mlp")
    w_down = put((f, d), (Shard(1), Shard(0)))        # ("mlp", "embed")
    w_vocab = put((d, V), (Shard(0), Shard(1)))       # ("embed", "vocab")
    emb = put((V, d), (Shard(1), Shard(0)))           # ("vocab", "embed")
    experts = put((E, d, f), (Shard(1), Shard(0)))    # ("exp", "embed", ..)
    tokens = put((B, S), rows, ints=True)
    labels = put((B, S, 1), rows, ints=True)
    chosen = distribute_tensor(torch.tensor([1, 3]), mesh,
                               (Replicate(), Replicate()))
    h = x @ w_up
    logits = (x @ w_vocab).float()
    cases = (("column-parallel product x @ w_up", lambda: x @ w_up),
             ("row-parallel product h @ w_down", lambda: h @ w_down),
             ("vocab-parallel logits x @ w_unembed", lambda: x @ w_vocab),
             ("logsumexp over the vocab shards",
              lambda: torch.logsumexp(logits, dim=-1)),
             ("target logit gather", lambda: torch.gather(logits, -1,
                                                          labels)),
             ("embedding lookup, vocab over model",
              lambda: F.embedding(tokens, emb)),
             ("the chosen experts' weights", lambda: experts[chosen]))
    for what, fn in cases:
        with _Shapes() as rec:
            out = fn()
        if rank == 0:
            print(f"{what}: {'; '.join(rec.seen) or 'no collective'}; "
                  f"result {tuple(out.placements)}", flush=True)
    dist.destroy_process_group()


def main():
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(f"{tmp}/pg",), nprocs=4,
                           start_method="spawn")


if __name__ == "__main__":
    main()
