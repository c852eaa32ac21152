"""End-to-end run on the PyTorch port: DR-FL vs HeteroFL vs ScaleFL.

The paper's core experiment on one NVIDIA card: the three methods on a
non-IID synthetic dataset under a binding energy budget.

    PYTHONPATH=src python examples/drfl_e2e_torch.py              # the card
    PYTHONPATH=src python examples/drfl_e2e_torch.py --full       # paper-scale
    PYTHONPATH=src python examples/drfl_e2e_torch.py --device cpu --rounds 3

Writes per-arm histories (drfl_e2e_results.json) and a checkpoint of the
final DR-FL global model (``repro_torch.checkpoint.io.save_pytree``, the
JAX package's on-disk format) into the ``--out`` directory (default
``tmp/``, created on demand).
"""
import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.checkpoint.io import save_pytree
from repro_torch.fl import FLConfig, run_simulation


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale: 40 devices, 200 rounds")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--out", default="tmp",
                    help="output directory for results + model checkpoint")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.full:
        base = dict(n_devices=40, n_rounds=200, n_train=8000, local_epochs=5,
                    participation=0.1)
    else:
        base = dict(n_devices=10, n_rounds=20, n_train=1500, local_epochs=2,
                    participation=0.3)
    if args.rounds:
        base["n_rounds"] = args.rounds
    if args.devices:
        base["n_devices"] = args.devices

    results = {}
    for method, sel in (("drfl", "marl"), ("heterofl", "greedy"),
                        ("scalefl", "greedy")):
        print(f"\n=== {method} ({sel}) ===")
        cfg = FLConfig(method=method, selector=sel, alpha=args.alpha,
                       seed=args.seed, energy_scale=0.05, **base)
        h = run_simulation(cfg, verbose=True, device=args.device)
        results[method] = {
            "acc_mean": h["acc_mean"],
            "best_acc": np.asarray(h["best_acc"]).tolist(),
            "energy": h["energy"],
            "alive": h["alive"],
            "round_time": h["round_time"],
            "dropouts": h["dropouts"],
        }
        if method == "drfl":
            ckpt = os.path.join(args.out, "drfl_global_model.ckpt")
            save_pytree(ckpt, h["params"])
            print(f"saved DR-FL global model -> {ckpt}")

    out_json = os.path.join(args.out, "drfl_e2e_results.json")
    with open(out_json, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nwrote {out_json}")
    print("\nfinal best-exit accuracies:")
    for m, r in results.items():
        print(f"  {m:10s} best_acc={np.round(r['best_acc'], 3)} "
              f"alive={r['alive'][-1]} dropouts={r['dropouts']}")


if __name__ == "__main__":
    main()
