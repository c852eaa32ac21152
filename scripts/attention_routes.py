#!/usr/bin/env python3
"""Where the short-query route of ``flash_attention`` starts to win: both
routes timed on one card over a sweep of key-set lengths.

    python3 scripts/attention_routes.py

For Sq in (1, 4, 8) query rows a head, D 32, non-causal, float32, BH 208
and 12 (the set mixer's two batch shapes), and Sk from 1 to 4096, each
direction runs on the short route (``fwd_split.cu``, ``bwd_short.cu``)
and on the tiled route (``fwd.cu``; ``bwd_fused.cu`` up to its limits,
``bwd_three_pass.cu`` past them), forced by replacing the module's
``attention_route``; device ms come from ``chip_smoke.py``'s ``_times``
(``torch.profiler``, 20 calls after 3).  Prints one line per shape, then
for each (BH, Sq) the least Sk from which the short route wins at every
longer Sk measured: its forward is faster, and so is its forward and
backward together (a training step runs both; the set mixer's QMIX update
runs two forwards and one backward).  ``SHORT_MIN_SK`` in
``flash_attention.py`` is the largest of them.  Needs one NVIDIA card
and ``nvcc``; imports neither jax nor the JAX package.
"""
from __future__ import annotations

import importlib
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SK = (1, 2, 4, 8, 16, 32, 64, 96, 128, 256, 512, 1024, 4096)


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("attention_routes: no CUDA card", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (sets the float32 precision flags)
    mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    cs.phase_build()
    chosen = mod.attention_route

    def forced(route):
        def pick(Sq, Sk, D, group):
            return ("short", mod.short_split(D)) if route == "short" else \
                ("tiled", 0)
        return pick

    def fn(a, b, c):
        return mod.flash_attention_bhsd(a, b, c, causal=False)
    g = torch.Generator(device="cuda").manual_seed(0)
    starts = {}
    for BH in (208, 12):
        for Sq in (1, 4, 8):
            wins = []
            for Sk in SK:
                q = torch.randn((BH, Sq, 32), generator=g, device="cuda")
                k, v = (torch.randn((BH, Sk, 32), generator=g, device="cuda")
                        for _ in range(2))
                do = torch.randn((BH, Sq, 32), generator=g, device="cuda")
                t = {}
                for route in ("short", "tiled"):
                    mod.attention_route = forced(route)
                    try:
                        fwd = cs._times(lambda: fn(q, k, v))[0]
                        bwd = cs._grad_times(fn, [q, k, v], do)[0]
                    finally:
                        mod.attention_route = chosen
                    t[route] = (fwd, bwd)
                tiled_bwd = ("fused" if mod.fused_backward(Sq, Sk, 32)
                             else "three_pass")
                win = t["short"][0] < t["tiled"][0] and \
                    sum(t["short"]) < sum(t["tiled"])
                wins.append(win)
                print(f"[routes] BH={BH} Sq={Sq} Sk={Sk} D=32: device ms "
                      f"forward short {t['short'][0]:.4f} tiled "
                      f"{t['tiled'][0]:.4f}; backward short "
                      f"{t['short'][1]:.4f} tiled ({tiled_bwd}) "
                      f"{t['tiled'][1]:.4f}; short wins: {win}",
                      flush=True)
            start = next((SK[i] for i in range(len(SK))
                          if all(wins[i:])), None)
            starts[(BH, Sq)] = start
    for (BH, Sq), start in starts.items():
        print(f"[routes] BH={BH} Sq={Sq}: the short route wins from Sk = "
              f"{start} on")
    known = [s for s in starts.values() if s is not None]
    print(f"[routes] the least Sk from which it wins everywhere measured: "
          f"{max(known) if len(known) == len(starts) else None}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
