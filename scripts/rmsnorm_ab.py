#!/usr/bin/env python3
"""Before and after of the rmsnorm kernels on one card, two checkouts of
this repository taking turns.

    python3 scripts/rmsnorm_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout (its ``src/``).  Each runs in a
fresh process, in the order given, so two versions alternate on the same
card, and each is measured by this repository's own ``chip_smoke.py``
phases: the kernel build, the card's launch floor, ``rmsnorm`` forward
and backward at ``chip_smoke.py``'s two timed shapes (the bucketed path's
G 16 and the per-client G 1, R 1024, d 128, f32) and at the exit norms
(G 16, R 32) and the bucketed shape in bfloat16, each checked against
the plain version, then timed beside it and ``F.rms_norm``; and one warm
round of the transformer on the per-client executor (the paper's 40
devices, 50%) under ``torch.profiler``.  Every output line carries the checkout's label
(its position and root).  Needs one NVIDIA card and ``nvcc``; imports
neither jax nor the JAX package.
"""
from __future__ import annotations

import importlib
import importlib.util
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
#: (G, R, d, dtype, label) timed beside chip_smoke.RMSNORM_TIMED's
EXTRA = [(16, 32, 128, "float32", "the exit norms"),
         (16, 1024, 128, "bfloat16", "the bucketed shape in bf16")]


def one(root: Path) -> None:
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    import repro_torch  # noqa: F401  (sets the float32 precision flags)
    from repro_torch.fl import FLConfig, run_simulation
    cs.phase_build()
    cs.phase_floor()
    mod = importlib.import_module("repro_torch.kernels.rmsnorm.rmsnorm")
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(G, R, d, "float32", where)
              for G, R, d, where in cs.RMSNORM_TIMED.values()] + EXTRA
    for G, R, d, dt, where in shapes:
        x, s, dy = cs._rmsnorm_inputs(G, R, d, getattr(torch, dt), g)
        abs_errs, errs = cs._fwd_bwd_errors(mod.rmsnorm, mod.rmsnorm_plain,
                                            [x, s], dy)
        if max(errs) > cs.KERNEL_TOL[dt]:
            raise AssertionError(f"rmsnorm disagrees with its plain version"
                                 f" at {where}")
        cs.rmsnorm_timed(mod, where, x, s, dy,
                         [(abs_errs[0], errs[0]),
                          (max(abs_errs[1:]), max(errs[1:]))])
    cfg = FLConfig(**dict(cs.PAPER_CFG, n_rounds=1, participation=0.5,
                          model_family="transformer"))
    run_simulation(cfg)                        # warm
    cs.phase_profile(cfg, "perclient round")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from attention_ab import take_turns
    sys.exit(take_turns(sys.argv, one, __file__, __doc__))
