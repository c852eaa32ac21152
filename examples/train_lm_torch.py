"""Energy-aware federated LM training over the early-exit transformer
family on the PyTorch port (``repro_torch``): the twin of
``examples/train_lm.py``, with its flags and ``--device``.

The paper's dual-selection workflow on a language task: a fleet of
battery-powered devices trains the early-exit decoder on the synthetic
next-token corpus; each round the selector picks WHO participates and
WHICH depth prefix (Model_1..Model_4) each client trains, and the server
layer-align aggregates the zero-filled deltas.  On the card the blocks'
norms and attention run the hand-written ``rmsnorm`` and causal
``flash_attention`` kernels, forward and backward.

    PYTHONPATH=src python examples/train_lm_torch.py              # the card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu \\
        --selector greedy --rounds 12 --devices 16 --ckpt /tmp/lm.msgpack

``--ckpt`` saves the final global params in the reference's format
(``repro_torch.checkpoint.save_pytree``), which either package's
``serve_lm`` loads (``examples/serve_lm_torch.py``, ``examples/
serve_lm.py``).

``--local`` skips the fleet and runs plain local DR-FL client updates on
one simulated device per depth: ``family.client_update`` +
``aggregate_drfl`` (the list path) + ``evaluate`` without the engine.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.device import resolve_device, to_host
from repro_torch.fl import FLConfig, run_simulation
from repro_torch.fl import server as fl_server
from repro_torch.models.family import get_family
from repro_torch.tree import tree_map


def run_local(args, params=None):
    """Engine-free mini round-loop: one client per depth prefix.  Starts
    from ``params`` (a tree of tensors) or the family's init at
    ``args.seed``; returns ``(params, rounds)``, ``rounds`` one
    ``{"losses": [M], "accs": [M]}`` per round (numpy)."""
    dev = resolve_device(args.device)
    fam = get_family("transformer")
    x, y = fam.make_dataset(args.n_train, 10, hw=args.seq, noise=1.0,
                            seed=args.seed)
    n_val = max(64, args.n_train // 10)
    x_val = torch.as_tensor(x[:n_val], device=dev).long()
    y_val = torch.as_tensor(y[:n_val], device=dev).long()
    x_tr, y_tr = x[n_val:], y[n_val:]
    if params is None:
        params = fam.init(torch.Generator().manual_seed(args.seed), 10,
                          width_mult=args.width, hw=args.seq)
    gp = tree_map(lambda t: torch.as_tensor(t).to(dev), params)
    M = fam.num_submodels()
    shards = np.array_split(np.arange(len(x_tr)), M)
    rounds = []
    for rnd in range(args.rounds):
        deltas, idxs, weights, losses = [], [], [], []
        for m in range(M):
            sh = shards[m]
            d, loss = fam.client_update(
                "drfl", gp, m, x_tr[sh], y_tr[sh], epochs=args.epochs,
                batch=args.batch, lr=args.lr, seed=args.seed + rnd * M + m)
            deltas.append(d)
            idxs.append(m)
            weights.append(float(len(sh)))
            losses.append(loss)
        gp, _ = fl_server.aggregate_drfl(gp, deltas, idxs, weights,
                                         server_lr=0.7, family=fam)
        accs = fl_server.evaluate(gp, x_val, y_val, family=fam)
        losses, accs = to_host(torch.stack(losses), accs)
        rounds.append({"losses": losses, "accs": accs})
        print(f"round {rnd:3d} losses={np.round(losses, 3)} "
              f"exit accs={np.round(accs, 3)}")
    return gp, rounds


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--selector", default="marl",
                    choices=["marl", "greedy", "random", "static"])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--participation", type=float, default=0.5)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seq", type=int, default=8,
                    help="context window length (cfg.hw)")
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--n-train", type=int, default=1200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--async", dest="engine_async", action="store_true",
                    help="event-driven async rounds instead of sync barriers")
    ap.add_argument("--local", action="store_true",
                    help="engine-free client_update/aggregate demo")
    ap.add_argument("--ckpt", default=None,
                    help="save final global params (msgpack) for serve_lm")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None, params=None):
    """Run the example; returns the final global params (and, with
    ``--local``, the per-round record of :func:`run_local`, which starts
    from ``params`` where given)."""
    args = parse_args(argv)
    rounds = None
    if args.local:
        gp, rounds = run_local(args, params)
    else:
        cfg = FLConfig(
            n_devices=args.devices, n_rounds=args.rounds,
            participation=args.participation, local_epochs=args.epochs,
            batch_size=args.batch, lr=args.lr, n_train=args.n_train,
            hw=args.seq, width_mult=args.width, seed=args.seed,
            model_family="transformer", method="drfl",
            selector=args.selector, energy_scale=0.05,
            engine_mode="async" if args.engine_async else "sync")
        t0 = time.time()
        h = run_simulation(cfg, verbose=True, device=args.device)
        print(f"\n{cfg.engine_mode} run: {len(h['acc_mean'])} evals in "
              f"{time.time() - t0:.1f}s wall; final mean exit acc "
              f"{h['acc_mean'][-1]:.3f}, fleet energy left "
              f"{h['energy'][-1]:,.0f} J, dropouts {h['dropouts']}")
        gp = h["params"]

    if args.ckpt:
        save_pytree(args.ckpt, gp)
        print("saved", args.ckpt)
    return gp, rounds


if __name__ == "__main__":
    main()
