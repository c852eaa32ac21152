#!/usr/bin/env python3
"""What the CNN's GroupNorm costs on the card: one client's local SGD
(``LayerwiseFamily.train_steps``, the per-client executor's step) at the
full-width ResNet-18, batch 32, 32x32 images, under ATen's fused
``F.group_norm`` and under the port's GroupNorm, written out as the
reference writes it (``repro_torch.models.cnn._groupnorm``).

    python3 scripts/groupnorm_ab.py

The two forms take turns (fused, written out, written out, fused) at
submodels 0 and 3; each turn times 25 steps after 3 warm-up steps, the
host's clock around work that ends in a synchronise (the step is
host-bound, so its wall is the metric).  Prints the card's name and power
limit first.  Needs one NVIDIA card; imports neither jax nor the JAX
package.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

STEPS = 25


def fused(p, x, groups: int = 8):
    """ATen's one-kernel GroupNorm, the groups chosen as the model's."""
    import torch.nn.functional as F
    C = x.shape[1]
    g = min(groups, C)
    while C % g:
        g -= 1
    return F.group_norm(x, g, p["scale"], p["bias"], eps=1e-5)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("groupnorm_ab: no CUDA card", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (sets the float32 precision flags)
    from repro_torch.models import cnn
    from repro_torch.models.family import get_family
    from repro_torch.tree import tree_map
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    family = get_family("cnn")
    params = tree_map(lambda t: t.cuda(), family.init(
        torch.Generator().manual_seed(0), 10, width_mult=1.0, hw=32))
    g = torch.Generator().manual_seed(1)
    xs = torch.randn((STEPS, 32, 32, 32, 3), generator=g).cuda()
    ys = torch.randint(0, 10, (STEPS, 32), generator=g).cuda()
    forms = {"fused": fused, "written out": cnn._groupnorm}
    for label in ("fused", "written out", "written out", "fused"):
        cnn._groupnorm = forms[label]
        for m in (0, 3):
            family.train_steps("drfl", params, m, xs[:3], ys[:3], lr=0.05)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            family.train_steps("drfl", params, m, xs, ys, lr=0.05)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / STEPS * 1e3
            print(f"[groupnorm ab] {label:11s} submodel {m}: {ms:.2f} ms a "
                  f"step ({STEPS} steps, full width, batch 32, 32x32)",
                  flush=True)
    cnn._groupnorm = forms["written out"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
