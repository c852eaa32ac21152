#!/usr/bin/env python3
"""Quickest proof that the PyTorch/H100 port (``src/repro_torch``) runs on
the card, and the source of every on-card number in PERF.md.

    python3 chip_smoke.py

Needs one NVIDIA card, ``nvcc`` and this repository's ``src/`` beside the
script; imports neither jax nor the JAX package.  Phases, each printing
its own lines; any failure raises and exits non-zero:

1. build the main path's kernel (``layer_agg``) from
   ``src/repro_torch/kernels/layer_agg/csrc`` with ``nvcc``;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes and edge shapes, and time kernel, plain version,
   one-call PyTorch yardstick (``library_ms``) and the roofline bound;
3. drive the main path through ``repro_torch.fl.run_simulation``: 64
   devices, the full-width multi-exit ResNet-18 on 32x32 images, sync
   DR-FL + QMIX, bucketed executor; launch counts are reset just before
   and read just after.  At the paper's 10% participation the fresh QMIX
   net's Q values rank submodel 0 first, so Top-K picks it for every
   participant; a second run of
   the same entry point at 50% participation drives several buckets per
   round, the deepest submodel included, into one ``layer_agg`` launch;
4. profile one warm round of that every-submodel configuration: kernel
   time by kernel and the card's busy share;
5. check a small run on the card against the same run on the CPU (plain
   versions): identical picks, accuracy within one validation sample,
   weights allclose at rtol 1e-4, atol 1e-5;
6. print the card's name and power limit, the kernels' JSON line and,
   last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, float32 outside tensor cores
REL_TOL = 1e-5
MAIN_CFG = dict(n_devices=64, width_mult=1.0, hw=32, n_train=6400, seed=0)


def _cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _agg_inputs(N, R, D, seed):
    """U ~ N(0, 1); masks held per row with every 7th row untrained (a
    zero denominator); data-size weights."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    U = torch.randn((N, R, D), generator=g, device="cuda")
    M = (torch.rand((N, R), generator=g, device="cuda") > 0.25).float()
    M[:, ::7] = 0.0
    w = torch.rand((N,), generator=g, device="cuda") * 300 + 8
    return U, M, w


def phase_build():
    from repro_torch.kernels.layer_agg import load_library
    _, seconds, log = load_library()
    regs = [l.strip() for l in log.splitlines() if "registers" in l]
    print(f"[build] layer_agg: nvcc {seconds:.2f} s; {' | '.join(regs)}")


def phase_kernels():
    """layer_agg against its plain version; returns the timing record."""
    import torch
    from repro_torch.core.aggregation import stacked_masked_mean
    from repro_torch.kernels.layer_agg import layer_agg, layer_agg_plain
    shapes = [("main path", 9, 11084, 1024), ("one client", 1, 11084, 1024),
              ("300 clients", 300, 1024, 1024), ("ragged D", 5, 1000, 1000),
              ("D over one chunk", 3, 257, 3000)]
    record = None
    for label, N, R, D in shapes:
        U, M, w = _agg_inputs(N, R, D, seed=N + R)
        got = layer_agg(U, M, w)
        torch.cuda.synchronize()
        ref = layer_agg_plain(U, M, w)
        err = (got - ref).abs().max().item()
        scale = max(ref.abs().max().item(), 1.0)
        zero_rows_ok = bool(torch.all(got[::7] == 0))
        print(f"[kernel] layer_agg {label} N={N} R={R} D={D}: "
              f"max_abs_err={err:.3e} (limit {REL_TOL * scale:.3e}), "
              f"zero-denominator rows zero: {zero_rows_ok}")
        if err > REL_TOL * scale or not zero_rows_ok:
            raise AssertionError(f"layer_agg disagrees with its plain "
                                 f"version at {label}")
        if label == "main path":
            ms = _cuda_ms(lambda: layer_agg(U, M, w))
            plain_ms = _cuda_ms(lambda: layer_agg_plain(U, M, w))

            def library():
                wm = w[:, None] * M
                return (torch.einsum("nl,nld->ld", wm, U)
                        / wm.sum(dim=0).clamp_min(1e-12)[:, None])
            library_ms = _cuda_ms(library)
            n_bytes = 4 * (N * R * D + N * R + N + R * D)
            n_ops = 2 * N * R * D + R * D
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / FP32_FLOPS_PER_S * 1e3
            record = {"name": "layer_agg", "route": "cuda",
                      "source": "src/repro_torch/kernels/layer_agg/csrc/"
                                "layer_agg.cu",
                      "replaces": "src/repro/kernels/layer_agg/"
                                  "layer_agg.py:37",
                      "launches": None, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations",
                      "library_ms": library_ms}
            print(f"[kernel] layer_agg main path: {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, einsum+divide {library_ms:.4f} ms, "
                  f"bound {record['bound_ms']:.4f} ms ({n_bytes / 1e6:.1f} "
                  f"MB at 3.35 TB/s), {n_bytes / ms / 1e6:.1f} GB/s")
        del U, M, w, got, ref
    # staleness alphas: kernel path on the card vs the plain path on the CPU
    U, M, w = _agg_inputs(9, 2048, 1024, seed=5)
    a = torch.rand((9,), device="cuda") * 0.8 + 0.2
    got = stacked_masked_mean(U, M, w, a)
    ref = stacked_masked_mean(U.cpu(), M.cpu(), w.cpu(), a.cpu())
    err = (got.cpu() - ref).abs().max().item()
    print(f"[kernel] layer_agg alpha path: max_abs_err={err:.3e}")
    if err > REL_TOL * max(ref.abs().max().item(), 1.0):
        raise AssertionError("alpha path disagrees with the CPU plain path")
    return record


def _drive(tag, cfg):
    """One ``run_simulation`` on the card with the launch counts reset
    just before and read just after; prints per-round lines and checks
    what every run of the main path must show.  Returns (hist, launches)."""
    import numpy as np
    import torch
    from repro_torch.fl import run_simulation
    from repro_torch.fl import batch as fl_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    fl_batch.reset_counters()
    t0 = time.perf_counter()
    hist = run_simulation(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    for t in range(len(hist["acc"])):
        print(f"[{tag}] round {t}: acc={np.round(hist['acc'][t], 4).tolist()}"
              f" energy={hist['energy'][t]:.1f} J reward="
              f"{hist['reward'][t]:+.4f} picks={hist['participants'][t]} "
              f"models={hist['model_choices'][t]} "
              f"wall={hist['wall_clock'][t]:.3f} s")
        print(f"[{tag}] round {t} host seconds by phase: " + ", ".join(
            f"{k}={v:.4f}" for k, v in hist["phase_s"][t].items()))
    print(f"[{tag}] executor={hist['executor']} aggregations="
          f"{hist['n_aggregations']} bucket programs="
          f"{fl_batch.COUNTERS['executions']} qmix updates="
          f"{hist['qmix']['updates']} launches={launches} run wall="
          f"{wall:.2f} s peak device memory="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if hist["executor"] != "batched":
        raise AssertionError("the main path did not take the bucketed "
                             "executor")
    if hist["n_aggregations"] < 1 or \
            launches["layer_agg"] != hist["n_aggregations"]:
        raise AssertionError("layer_agg launches != rounds with a cohort")
    vals = np.concatenate([np.ravel(hist["acc"]), hist["energy"],
                           hist["reward"]])
    if not np.all(np.isfinite(vals)):
        raise AssertionError("non-finite accuracy, energy or reward")
    return hist, launches


def phase_main_path():
    from repro_torch.fl import FLConfig
    hist, launches = _drive("main", FLConfig(n_rounds=3, participation=0.1,
                                             **MAIN_CFG))
    if hist["qmix"]["updates"] < 1:
        raise AssertionError("no QMIX update ran")
    return launches


def phase_all_submodels():
    """The same entry point at 50% participation (32 picks of 64): every
    round aggregates several buckets in one launch, and the deepest
    submodel trains.  Returns its config for the profile."""
    from repro_torch.fl import FLConfig
    cfg = FLConfig(n_rounds=2, participation=0.5, **MAIN_CFG)
    hist, _ = _drive("submodels", cfg)
    per_round = [sorted(set(m)) for m in hist["model_choices"]]
    print(f"[submodels] submodels trained per round: {per_round}")
    if max(len(m) for m in per_round) < 2:
        raise AssertionError("no round aggregated more than one bucket")
    deepest = len(hist["acc"][0]) - 1
    if not any(deepest in m for m in per_round):
        raise AssertionError("the deepest submodel never trained")
    return cfg


def phase_profile(cfg):
    """Device busy share of one warm round of ``cfg`` (``torch.profiler``,
    device activity only: recording every host op of the vmapped programs
    makes the trace too large to read back in time).  Busy time is the
    union of the kernels' intervals inside the round, so overlapping or
    doubly reported kernels are not counted twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fl import run_simulation
    cfg = dataclasses.replace(cfg, n_rounds=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        hist = run_simulation(cfg)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    spans = sorted({(e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if getattr(e, "device_type", None) == DeviceType.CUDA})
    if not spans:
        print("[profile] device busy time: not measured (no device events "
              "in the trace)")
        return
    # the round ends in its tail pull, right after its last kernel: the
    # window is the round's host wall time ending there
    round_us = hist["wall_clock"][0] * 1e6
    hi = max(e_ for _, e_, _ in spans)
    lo = hi - round_us
    busy_us, cur_s, cur_e = 0.0, None, None
    for s_, e_, _ in spans:
        s_, e_ = max(s_, lo), min(e_, hi)
        if e_ <= s_:
            continue
        if cur_e is None or s_ > cur_e:
            busy_us += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy_us += 0.0 if cur_e is None else cur_e - cur_s
    in_round = [(s_, e_, n) for s_, e_, n in spans if s_ >= lo]
    print(f"[profile] one warm round, participation {cfg.participation}, "
          f"submodels {sorted(set(hist['model_choices'][0]))}: wall "
          f"{round_us / 1e6:.3f} s, "
          f"{len(in_round)} kernels summing "
          f"{sum(e_ - s_ for s_, e_, _ in in_round) / 1e6:.3f} s, card busy "
          f"{busy_us / 1e6:.3f} s, busy share {busy_us / round_us:.3f} "
          f"(trace read in {time.perf_counter() - t0:.1f} s)")
    by_name = {}
    for s_, e_, name in in_round:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + e_ - s_)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"[profile] kernel {name[:60]}: {n} launches, {t / 1e3:.2f} ms")
    for name, (n, t) in by_name.items():
        if "layer_agg" in name:
            print(f"[profile] kernel layer_agg in the round: {n} launches, "
                  f"{t / 1e3:.4f} ms")


def phase_reference():
    """A small run on the card against the same run on the CPU, both
    greedy (ε = 0: the two devices' generators draw different numbers).
    Weights are held at rtol=1e-4, atol=1e-5, the tolerance of the parity
    tests after SGD steps and QMIX updates (float32 sums in another
    order on each device)."""
    import numpy as np
    import torch
    from repro_torch.fl import FLConfig
    from repro_torch.fl.engine import RoundEngine
    from repro_torch.fl.simulation import _make_buffer, _make_selector
    from repro_torch.tree import tree_leaves
    cfg = FLConfig(n_devices=64, n_rounds=3, participation=0.1,
                   width_mult=0.125, hw=8, n_train=1280, local_epochs=1,
                   seed=1)
    hists = {}
    for dev in ("cuda", "cpu"):
        sel = _make_selector(cfg, 4, device=dev)
        sel.learner.cfg = dataclasses.replace(sel.learner.cfg,
                                              eps_start=0.0, eps_end=0.0)
        sel.reset_episode()
        hists[dev] = RoundEngine(cfg, sel, _make_buffer(cfg),
                                 device=dev).run()
    g, c = hists["cuda"], hists["cpu"]
    n_val = max(64, int(cfg.n_val_fraction * cfg.n_train))
    acc_diff = float(np.max(np.abs(np.stack(g["acc"]) - np.stack(c["acc"]))))
    pairs = [(a.cpu(), b) for a, b in zip(tree_leaves(g["params"]),
                                          tree_leaves(c["params"]))]
    p_diff = max(float((a - b).abs().max()) for a, b in pairs)
    p_close = all(torch.allclose(a, b, rtol=1e-4, atol=1e-5)
                  for a, b in pairs)
    print(f"[reference] card vs CPU, n=64 width 0.125 8x8, 3 rounds: picks "
          f"equal={g['participants'] == c['participants']}, max per-exit "
          f"accuracy diff={acc_diff:.4f} (limit {1 / n_val:.4f}), max weight "
          f"diff={p_diff:.3e} (allclose at rtol 1e-4, atol 1e-5: {p_close})")
    if g["participants"] != c["participants"] or \
            g["model_choices"] != c["model_choices"]:
        raise AssertionError("card and CPU runs picked differently")
    if acc_diff > 1.0 / n_val + 1e-6 or not p_close:
        raise AssertionError("card and CPU runs disagree")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (sets the float32 precision flags)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card {torch.cuda.get_device_name(0)}")
    phase_build()
    record = phase_kernels()
    record["launches"] = phase_main_path()["layer_agg"]
    phase_profile(phase_all_submodels())
    phase_reference()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
