"""Quickstart on the PyTorch port: a short DR-FL run on one NVIDIA card.

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Runs a small fleet of battery-powered heterogeneous devices training the
4-exit layer-wise ResNet with MARL dual-selection through
``repro_torch.fl.run_simulation``, and prints the round-by-round accuracy
/ energy / fleet-survival trace and the run's wall time.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.fl import FLConfig, run_simulation


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    cfg = FLConfig(
        n_devices=8,          # heterogeneous fleet (small/medium/large tiers)
        n_rounds=8,
        participation=0.4,    # Top-K = 3 clients per round
        local_epochs=2,
        method="drfl",
        selector="marl",      # the paper's QMIX dual-selection
        alpha=0.5,            # Dirichlet non-IID
        n_train=1200,
        energy_scale=0.05,    # make the battery budget binding
        seed=0,
    )
    print(f"DR-FL quickstart on {args.device}: {cfg.n_devices} devices, "
          f"{cfg.n_rounds} rounds, alpha={cfg.alpha}, "
          f"selector={cfg.selector}")
    t0 = time.perf_counter()
    hist = run_simulation(cfg, verbose=True, device=args.device)
    wall = time.perf_counter() - t0
    print("\nbest accuracy per layer-wise model (Models 1-4):",
          np.round(hist["best_acc"], 3))
    print("devices alive at end:", hist["alive"][-1], "/", cfg.n_devices)
    print("total energy remaining: %.0f J" % hist["energy"][-1])
    print(f"run wall time: {wall:.2f} s")


if __name__ == "__main__":
    main()
