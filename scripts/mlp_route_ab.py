#!/usr/bin/env python3
"""The ``mlp`` family's two bucket-program routes on the card: the
participant axis written out (``apply_all_exits_stacked``, differentiated
by plain autograd: the family's route, ``stacked_forward = True``)
against ``torch.func.vmap`` over participants of ``grad`` of the
one-participant forward (the CNN's route).

    python3 scripts/mlp_route_ab.py

Both run ``chip_smoke.py``'s ``[mlp]`` configuration (64 devices at 50%,
d 256, 32x32, sync DR-FL + MARL, bucketed) through ``run_simulation``;
the ``vmap`` route is this script's own family, registered as
``mlp_vmap`` with the same parameters and cost model.  The routes take
turns (written out, vmap, vmap, written out); each turn prints its warm
rounds' wall and ``clients`` host seconds (rounds 1 and 2; the step is
host-bound, so the wall is the metric) and the final weights' largest
difference from the first turn's.  Prints the card's name and power limit
first.  Needs one NVIDIA card; imports neither jax nor the JAX package.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _vmap_family():
    from repro_torch.models import mlp
    from repro_torch.models.family import register_family

    class VmapMlp(mlp.MlpFamily):
        name = "mlp_vmap"
        stacked_forward = False
    register_family(VmapMlp())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mlp_route_ab: no CUDA card", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (sets the float32 precision flags)
    from repro_torch.fl import FLConfig, run_simulation
    from repro_torch.tree import tree_leaves
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _vmap_family()
    routes = {"written out": "mlp", "vmap(grad)": "mlp_vmap"}
    first = None
    for label in ("written out", "vmap(grad)", "vmap(grad)", "written out"):
        cfg = FLConfig(n_devices=64, n_rounds=3, participation=0.5,
                       n_train=6400, seed=0, width_mult=1.0, hw=32,
                       model_family=routes[label])
        hist = run_simulation(cfg)
        torch.cuda.synchronize()
        params = [t.cpu() for t in tree_leaves(hist["params"])]
        first = first or params
        diff = max(float((a - b).abs().max()) for a, b in zip(params, first))
        print(f"[mlp route] {label}: warm round wall "
              f"{[round(w, 3) for w in hist['wall_clock'][1:]]} s, clients "
              f"host s {[round(p['clients'], 3) for p in hist['phase_s'][1:]]}"
              f", models {[sorted(set(m)) for m in hist['model_choices']]}, "
              f"max weight diff from the first turn {diff:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
