#!/usr/bin/env python3
"""Write the async JAX engine checkpoint that the port resumes on the
card, and the record of the uninterrupted JAX run that the resumed run
must equal.

    PYTHONPATH=src JAX_PLATFORMS=cpu \
        python scripts/make_jax_async_checkpoint.py [OUT]

Runs the JAX package on the CPU (the port's one script that needs jax):
DR-FL, greedy, the async engine and the bucketed executor (so the
in-flight tasks hold ``delta1`` row slices in the JAX layout and the
resume aggregates through ``layer_agg``), killed right after its first
virtual round's save.  The checkpoint goes to ``OUT`` (default
``tests/data/jax_async_ckpt/``, which is committed), written with zlib
(the card machine has no ``zstandard``), beside ``record.json``: the
config, and the uninterrupted JAX run's task log, picks, model choices,
accuracies and totals, and a digest of its final weights (each leaf's
dot product with a fixed gaussian probe, :func:`weights_probe`).

The size is the live tests' (``tests/torch_live.py::BASE``: n 8, 8x8)
with the ``mlp`` family at its narrowest (width 0.0625, d 16) and a
participation of 0.25, so that the files stay under 200 KB (175 KB: the
weights, and one more copy for each of the two delta rows in flight).
The width-0.125 CNN of the live tests takes 1.6 MB, and a CNN narrow
enough for 200 KB (width 1/64) is ill-conditioned at 8x8 (its last
stages normalise one channel over one pixel).  The CNN's HWIO -> OIHW
delta rows are held to live JAX runs in the CPU tests
(``tests/test_torch_checkpoint_async_batched.py``).
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: the config (every other field the FLConfig default)
CONFIG = dict(n_devices=8, n_rounds=3, participation=0.25, local_epochs=1,
              batch_size=16, n_train=400, hw=8, model_family="mlp",
              width_mult=0.0625, seed=1, engine_mode="async",
              selector="greedy", client_executor="batched")
#: what the resumed run must equal
RECORD_KEYS = ("participants", "model_choices", "task_log", "staleness",
               "n_tasks", "n_aggregations", "acc", "acc_mean", "terminated")


def weights_probe(leaves) -> list:
    """Each leaf's dot product, in float64, with a standard normal probe
    of its shape drawn from ``default_rng(0)`` (leaves in sorted-key
    order, as both packages flatten a params dict): a few numbers that
    move with any change to any weight."""
    rng = np.random.default_rng(0)
    return [float(np.sum(np.asarray(leaf, np.float64)
                         * rng.standard_normal(np.shape(leaf))))
            for leaf in leaves]


def main(out: Path) -> None:
    import jax
    import repro.checkpoint.io as jio
    from repro.checkpoint import CheckpointHalt
    from repro.fl import simulation as jsim
    from repro.fl.engine import RoundEngine

    jio.zstd = None                      # zlib, which the card can read

    def run(cfg, halt=None):
        return RoundEngine(cfg, jsim._make_selector(cfg, 4), None,
                           halt_counter=halt).run()

    hist = run(jsim.FLConfig(**CONFIG))
    if out.exists():
        shutil.rmtree(out)
    try:
        run(jsim.FLConfig(**CONFIG, checkpoint_dir=str(out),
                          checkpoint_every=1), halt={"remaining": 1})
    except CheckpointHalt:
        pass
    else:
        raise SystemExit("the run ended before its first save")
    record = {"config": CONFIG}
    record.update({k: hist[k] for k in RECORD_KEYS})
    record["weights_probe"] = weights_probe(
        jax.tree_util.tree_leaves(hist["params"]))
    text = json.dumps(record, indent=1,
                      default=lambda a: np.asarray(a).tolist()) + "\n"
    (out / "record.json").write_text(text)
    total = sum(f.stat().st_size for f in out.iterdir())
    print(f"wrote {sorted(f.name for f in out.iterdir())} to {out} "
          f"({total} bytes): {hist['n_tasks']} tasks")


if __name__ == "__main__":
    main(Path(sys.argv[1]) if len(sys.argv) > 1
         else ROOT / "tests" / "data" / "jax_async_ckpt")
