"""Training launcher — port of ``repro.launch.train`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --smoke --steps 20 --batch 8 --seq 64 --device cpu

Runs on the card (``--device cuda``, the default) unless told otherwise.
``--use-pallas`` launches the hand-written ``flash_attention`` kernel in
every block (forward, the remat recompute and backward).  The state is
updated in place (the reference donates it).  Checkpoints are the
reference's files (``repro_torch.checkpoint``'s ``save_pytree``), so a
run resumes from either package's ``--ckpt-dir``.  ``--mesh`` is refused:
the production mesh waits for the sharding slice (ROADMAP Queue 1 item
4); the MoE family trains on one device, its experts unsharded.
The cross-attention families train on zero stub-frontend inputs, as in
the reference.
The reference's ``--fl-clients``/``--fl-agg-every`` are parsed there but
drive nothing; the port leaves them out.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, load_pytree, save_pytree
from repro_torch.configs import (INPUT_SHAPES, TrainConfig, get_config,
                                 get_smoke_config)
from repro_torch.data.synthetic import lm_batches, synthetic_lm_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (adapt_for_shape, build_train_step,
                                      make_train_state)
from repro_torch.models.api import extra_inputs
from repro_torch.tree import tree_leaves


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
    if args.mesh:
        raise ValueError(f"--mesh {args.mesh}: the production mesh waits for "
                         "the sharding slice (sharding/rules.py, "
                         "launch/mesh.py, ROADMAP Queue 1 item 4); the port "
                         "trains on one device")
    device = resolve_device(args.device)

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
    model, train_step = build_train_step(cfg, tcfg)

    state = make_train_state(model, torch.Generator(device).manual_seed(0),
                             tcfg)
    start = 0
    if args.ckpt_dir:
        ck = latest_step(args.ckpt_dir)
        if ck:
            _restore(state, ck)
            start = state["opt"]["step"]
            print(f"resumed from {ck} (step {start})")

    toks = synthetic_lm_dataset(max(S * B * 4, 100_000), cfg.vocab_size,
                                seed=0)
    it = lm_batches(toks, B, S, seed=0)
    extras = {k: torch.zeros(shp, dtype=dt, device=device) for k, (shp, dt)
              in extra_inputs(cfg, B, S).items()}

    history = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(it).items()}
        batch.update(extras)
        state, metrics = train_step(state, batch)
        history.append(metrics)
        if step % 10 == 0 or step == args.steps - 1:
            per_step = (time.time() - t0) / max(step - start + 1, 1)
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"({per_step:.2f}s/step)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_pytree(args.ckpt_dir, _on_disk(state), step=step + 1)
    if args.ckpt_dir:
        p = save_pytree(args.ckpt_dir, _on_disk(state), step=args.steps)
        print("saved", p)
    return {"state": state, "losses": [float(m["loss"]) for m in history]}


if __name__ == "__main__":
    main()
