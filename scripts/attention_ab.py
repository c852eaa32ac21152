#!/usr/bin/env python3
"""Before and after of the attention kernels on one card, two checkouts
of this repository taking turns.

    python3 scripts/attention_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout (its ``src/``).  Each runs in a
fresh process, in the order given, so two versions alternate on the same
card, and each is measured by this repository's own ``chip_smoke.py``
phases: the kernel build, the model-layout ``flash_attention`` call at
the transformer path's shape (checked, then timed beside SDPA), the set
mixer's shapes of ``[fig6 n1024]`` (BH 208, Sq 4, Sk 1024) and of
``[marl train]``'s n = 1M row (BH 12, Sq 4, Sk 4096), each checked and
timed forward and backward beside SDPA, and one warm round of the
transformer path under ``torch.profiler`` (our kernels' and ATen's
elementwise launches).  Every output line carries the
checkout's label (its position and root).  Needs one NVIDIA card and
``nvcc``; imports neither jax nor the JAX package.
"""
from __future__ import annotations

import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"


def one(root: Path) -> None:
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import repro_torch  # noqa: F401  (sets the float32 precision flags)
    from repro_torch.fl import FLConfig, run_simulation
    import torch
    cs.phase_build()
    mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    cs._model_layout_times(mod)
    g = torch.Generator(device="cuda").manual_seed(1)
    for shape, where in (
            (("set mixer path", 208, 208, 4, 1024, 32, False, 0, "float32"),
             "the set mixer's path shape"),
            (("set mixer bench", 12, 12, 4, 4096, 32, False, 0, "float32"),
             "the set mixer's n = 1M shape")):
        cs._attention_case(mod, g, shape, where)
    cfg = FLConfig(**dict(cs.TRANSFORMER_CFG, n_rounds=1))
    run_simulation(cfg)                        # warm
    cs.phase_profile(cfg, "round")


def take_turns(argv, one, script, doc) -> int:
    """``script OLD NEW NEW OLD``: run ``script --one ROOT`` for each root
    in turn, each in a fresh process, its lines labelled with the root's
    position; ``script --one ROOT`` runs ``one(ROOT)``."""
    if len(argv) == 3 and argv[1] == "--one":
        one(Path(argv[2]).resolve())
        return 0
    if len(argv) < 2:
        print(doc, file=sys.stderr)
        return 2
    rc = 0
    for i, root in enumerate(argv[1:]):
        proc = subprocess.Popen([sys.executable, script, "--one", root],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            print(f"[{i}:{root}] {line}", end="", flush=True)
        rc = rc or proc.wait()
    return rc


if __name__ == "__main__":
    sys.exit(take_turns(sys.argv, one, __file__, __doc__))
