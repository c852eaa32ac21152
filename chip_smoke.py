#!/usr/bin/env python3
"""Quickest proof that the PyTorch/H100 port (``src/repro_torch``) runs on
the card, and the source of every on-card number in PERF.md.

    python3 chip_smoke.py

Needs one NVIDIA card, ``nvcc`` and this repository's ``src/`` beside the
script; imports neither jax nor the JAX package.  Phases, each printing
its own lines; any failure raises and exits non-zero:

1. build every kernel (``layer_agg``, ``rmsnorm``, ``flash_attention``)
   from ``src/repro_torch/kernels/<name>/csrc`` with ``nvcc``, one
   process per source, all started together;
2. time the card's launch floor (``floor_ms``: a fill of one element),
   then hold each kernel, forward and backward, against its plain PyTorch
   version on the card (the backward against autograd through the plain
   version) at its path's shapes and edge shapes; at the path's shape,
   time the kernel, the plain version and the one-call PyTorch yardstick
   (``library_ms``) by device time (``torch.profiler``) and by call time
   (CUDA events, the host's cost included), beside the roofline bound;
   attention's route (short: the split-Sk forward and the short-query
   backward; wgmma: bf16 causal on the tensor cores, TMA loads; tiled:
   the pipelined forward and the fused or three-pass backward) is
   printed for every shape, the short route's kernels are run twice
   (bitwise equal) and held against their CPU emulation
   (``attention_split_blocked``, the kernels' order of sums) at 1e-6, the
   wgmma route's twice (bitwise equal) and against their emulation of
   its rounding (``attention_wgmma_blocked``) at 1e-2, and
   the model-layout call, the one the transformer path makes, is checked
   and timed at the path's shape beside SDPA on the same layout;
   attention is also timed at the set mixer's shapes of step 10
   (non-causal, 4 seed queries over 1024 agents at BH 208, and over 4096
   at ``[marl train]``'s BH 12) beside non-causal SDPA;
   ``rmsnorm``'s route (vec or general) and its backward's splits are
   printed for every shape, and its backward is run twice (bitwise
   equal) and held against its CPU emulation (``rmsnorm_bwd_blocked``,
   the kernel's order of sums) at 1e-6;
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
5. drive the transformer path the same way: the early-exit transformer
   family at full width (d 128, 4 heads, 4 blocks, sequences of 32),
   64 devices at 50% participation, whose blocks run the ``rmsnorm`` and
   ``flash_attention`` kernels forward and backward; then profile one
   warm round of it;
6. the paper's own fleet (``benchmarks/common.py``'s harness: 40
   devices, 10%, 5 local epochs, full-width ResNet-18 on 32x32), which
   ``"auto"`` runs on the per-client executor: DR-FL + MARL for 3 rounds
   (``[paper fleet]``), ``FLConfig()`` as it stands but for 2 of its 30
   rounds (``[defaults]``), then every other arm of Table 1 / Fig. 5 for
   1 round (``[table1]``); HeteroFL and ScaleFL on the bucketed executor at
   64 devices (``[baselines bucketed]``); the transformer on the
   per-client executor, its kernel launches counted exactly from the
   clients' schedules (``[transformer perclient]``); one per-client
   round's deltas aggregated by the list path and by its stacked route
   through ``layer_agg`` (``[from list]``); the two executors on the same
   run (``[executors]``);
7. the async engine (``engine_mode="async"``): Fig. 6's 64-device DR-FL
   + MARL row at full width on the bucketed executor (``[async]``: one
   ``layer_agg`` launch per completion, N = 1, some of them stale; the
   cost of one completion's aggregation; then a profile of two warm
   virtual rounds), its HeteroFL arm (``[async heterofl]``), the
   transformer path (``[async transformer]``: every kernel's launch count
   exact from the dispatch ticks' buckets) and seeded faults with
   deadline reaping and quarantine (``[async faults]``, 5 rounds' sim
   time);
8. check small runs on the card against the same runs on the CPU (plain
   versions): each family on the bucketed executor, and the CNN's DR-FL
   greedy, HeteroFL and ScaleFL arms on the per-client executor;
   identical picks, accuracy within one validation sample, weights
   allclose at rtol 1e-4, atol 1e-5; and async runs (``[async
   reference]``: bucketed with hot-plug, and per-client), with identical
   task logs;
9. the energy scenarios (``repro_torch.energy``): the main path with
   18.9 J batteries under a static battery, solar harvesting, a diurnal
   wave, carbon-priced windows and a global joule budget (``[energy]``:
   ``layer_agg`` once per aggregation; each scenario must bite: more
   energy under solar, every pick open under a gate while some device was
   not, the budget ending the run within its limit), Fig. 6's async row
   under a diurnal wave and a budget (``[energy async]``), every scenario
   on both engines and both executors at the tests' size on the card
   against the CPU (``[energy reference]``), and
   ``benchmarks/energy_bench.py``'s n = 256 grid, 4 scenarios x 3
   fixed selectors and MARL under solar and the budget (``[energy
   grid]``, no JSON written);
10. MARL at fleet scale (the factored QMIX state, the set/attention
   mixer on the non-causal ``flash_attention``, sampled-agent replay):
   Fig. 6's 1024-device row at full width on the async engine
   (``[fig6 n1024]``: ``flash_attention`` twice per QMIX update, its
   backward once, all on the short-query route, ``layer_agg`` once per
   completion; the wall of one set-mode update),
   ``benchmarks/marl_train_bench.py``'s rows to
   n = 1M (``[marl train]``: the set mixer's step time flat in n), a
   300-device run on the card against the CPU, sync and async, with
   identical picks, task logs, sampled agents and factored states
   (``[fleet scale reference]``);
11. engine checkpoints (``repro_torch.checkpoint``): the main path killed
   after its first round's checkpoint and resumed (``[checkpoint]``:
   bit for bit as the uninterrupted run under cuDNN's deterministic mode,
   ``layer_agg`` exactly twice after the resume; the checkpoint's bytes,
   save and load seconds at full width), Fig. 6's 64-device async row the
   same way (``[checkpoint async]``: task log, history and weights;
   ``layer_agg`` once per completion after the save, the QMIX update from
   the restored replay), and checkpoints crossing devices (``[checkpoint
   reference]``: greedy and random on both engines killed on the card and
   resumed on the CPU and the reverse, against the uninterrupted CPU run;
   the 300-device set-mixer async run killed and resumed on the card,
   its ``flash_attention`` launches after the resume counted);
12. the public API (``repro_torch.fl``'s typed ``SimulationSpec``, the
   family registry, ``FLEnv``; the phases after ``[spec]`` run right
   after step 3's main path): ``[spec]``, run first, before the script
   touches the card (each config the reference's spec rejects raises its
   message from ``run_simulation`` and CUDA stays uninitialised; the main
   path's config round-trips through the spec exactly); ``[mlp]``, the
   ``mlp`` family at full width (d 256, 32x32), 64 devices at 50%, sync
   DR-FL + MARL, bucketed, ``layer_agg`` once a round, then ``layer_agg``
   held against its plain version and timed at that path's shape and
   ``[mlp profile]``; ``[mlp async]``, README.md's Public API example at
   full width (one ``layer_agg`` launch per completion); ``[mlp
   reference]``, a small bucketed run on the card against the CPU; and
   ``[env]``, ``FLEnv`` at 1024 devices on the card against the CPU, both
   reward clocks;
13. DR-FL's last engine gaps: ``[lm examples]``, the LM examples'
   twins (``examples/train_lm_torch.py --local`` for 2 rounds at full
   width, d 128, sequences of 32, on the card and on the CPU: per-round
   losses and weights at ``[reference]``'s tolerances; then
   ``examples/serve_lm_torch.py`` decoding 16 tokens from exits 0 and M-1
   of the card's ``--ckpt``, the CPU's tokens; ``rmsnorm`` and
   ``flash_attention`` launches counted, ms per token);
   ``[checkpoint from jax async]``, the committed async JAX checkpoint
   (``tests/data/jax_async_ckpt/``: the ``mlp`` family, bucketed, greedy,
   killed after its first virtual round's save with two ``delta1`` rows
   in flight) resumed through ``resume_state_from_jax`` on the card and
   on the CPU: picks, model choices and task log equal to the record of
   the uninterrupted JAX run beside it, card and CPU weights at ``[async
   reference]``'s tolerances, ``layer_agg`` once per completion after the
   resume; ``[fleet mesh]``, in a one-rank NCCL group the selection step
   on a fleet placed on the ``("fleet",)`` mesh against the plain step,
   and ``fleet_mesh=-1``/``2`` leaving the fleet unsharded;
14. the LM substrate's dense decoder (``repro_torch.launch``) at full
   width, bf16, random weights from seed 0: ``[lm serve]``, the
   reference serve main's run through ``SlotServer`` on phi3-mini-3.8b
   (32 layers, d 3072, 32 heads of 96, vocab 32064; 4 slots, 8 requests,
   decode attention plain torch as in the reference), ms a decode step;
   ``[lm prefill]``, ``build_prefill_step`` with ``use_pallas`` on
   phi3-mini and minitron-8b (GQA 32:8, D 128) at B 4 x S 2048 and on
   phi3-mini with a 1024-key window at B 2 x S 4096, one wgmma
   ``flash_attention`` forward a layer, the logits held against the plain
   route; ``[lm train]``, ``build_train_step`` on phi3-mini at B 2 x S
   1024 (full remat, the in-place AdamW), 2 steps, every launch on the
   wgmma route, and the peak memory; ``[lm reference]``, phi3-mini's
   widths at 2 layers in float32 (the tiled route), card against CPU
   (served tokens, prefill logits, losses); then the attention kernel at
   those four bf16 shapes against its plain version, its backward twice
   (bitwise equal), timed beside SDPA, its route and its bound on the
   bf16 tensor-core peak printed beside its times; then DR-FL over pods
   (``launch/steps.py``'s FL steps, the paper's Step 2 in the LM train
   loop) and the production mesh (``launch/{mesh,specs,train}.py``):
   ``[lm fl train]``, ``build_fl_train_step`` on phi3-mini at full width
   and depth, B 4 x S 1024, four clients of one sequence on the four
   exits, 2 steps (128 wgmma forwards, 64 backwards), walls and peak;
   ``[lm fl bucketed]``, ``build_fl_bucketed_train_step`` on the same
   clients bucket-major (320 and 160; the attention kernel is held to
   its plain version and timed at both steps' shapes, B 4 and B 1 x S
   1024, with the shapes above), its wall's share of the masked
   step's, its first loss against the masked step's, and both steps in
   float32 on the plain route at 4 layers, exits (1, 2, 3, 4), held to
   each other at the reference's tolerances; ``[lm mesh]``, in a
   one-rank NCCL group the production and debug meshes refused, then on
   a ``(1, 1)`` mesh the tensor-parallel path (the state built leaf by
   leaf, the model split over the model axis, attention through the
   kernel's local-shard entry) under seven sharding policies, 2 train
   steps and 2 FL steps each, phi3-mini at 4 layers, bitwise equal to
   the one-device steps, the entry's launches counted, then ``[lm mesh
   <family>]``, every other family at full width and cut depth (xLSTM's
   2 blocks, zamba2's 6 Mamba2 blocks and a shared-attention site,
   whisper's 2 and 2 layers over 1500 frames, the VLM's group of 4 self
   layers and a cross layer over 1601 image tokens) under three
   policies, 2 train steps each, bitwise equal to the one-device steps,
   the entry's launches exact, and ``[lm mesh bytes]`` (host only: each
   LM config's per-rank state on the (16, 16) production mesh); the
   attention kernel is also timed at one rank's local heads under a
   4-way model axis (phi3-mini train, 8 of 32 heads; zamba2's shared
   block, 8 of 32 at D 64; the VLM's self layers, 8:2 of 32:8 at D 128);
15. the sub-quadratic families (xlstm-1.3b, zamba2-1.2b) and the
   cross-attention families (whisper-medium: 24 encoder and 24 decoder
   layers over 1500 stub audio frames; llama-3.2-vision-11b: 8 groups of
   4 self layers and a gated cross layer over 1601 stub image tokens),
   each served (``[lm <family> serve]``), prefilled (``[lm <family>
   prefill]``: one wgmma forward at each causal self-attention layer,
   exactly, and nothing else) and trained for 2 steps (``[lm <family>
   train]``: two wgmma forwards and one backward a causal layer a step;
   xLSTM at 8 of its 48 blocks, the VLM at 10 of its 40 layers, the cut
   printed), then ``[lm sub-quadratic reference]`` and ``[lm
   cross-attention reference]`` (2-layer float32 configs, card against
   CPU; the VLM's gates drawn nonzero); the attention kernel is also
   timed at zamba2's two shapes, whisper's decoder (B 4, S 448, 16 heads
   of 64) and the VLM's train step (B 2, S 1024, 32:8, D 128); each new
   phase's seconds and the laps are printed;
16. print the card's name and power limit, the kernels' JSON line and,
   last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, f32 off tensor cores
#: H100 SXM data sheet, bf16 dense on the tensor cores: the least time of
#: bf16 work, whatever units a kernel runs it on
BF16_FLOPS_PER_S = 989e12
PEAKS = {FP32_FLOPS_PER_S: "float32 off the tensor cores, 67 TFLOP/s",
         BF16_FLOPS_PER_S: "bf16 dense tensor cores, 989 TFLOP/s"}
REL_TOL = 1e-5
#: rmsnorm and flash_attention, relative to the largest magnitude: the JAX
#: sweep's tolerances (tests/test_kernels.py)
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MAIN_CFG = dict(n_devices=64, width_mult=1.0, hw=32, n_train=6400, seed=0)
TRANSFORMER_CFG = dict(MAIN_CFG, n_rounds=3, participation=0.5,
                       model_family="transformer")
#: the per-client reference runs (card against CPU): the CNN test size
PERCLIENT_REFERENCE = dict(n_devices=8, n_rounds=3, participation=0.5,
                           local_epochs=1, batch_size=16, n_train=400, hw=8,
                           width_mult=0.125, seed=1)
#: HeteroFL at seed 3 and full batteries (the full width): with mixed
#: widths its trajectory is ill-conditioned at this size (the JAX
#: package's own two executors end 1e-2 apart), at seed 3 they agree to
#: 2e-6; ScaleFL's agree to 1.2e-7 with mixed widths
PERCLIENT_REFERENCE_ARMS = (
    dict(method="drfl", selector="greedy"),
    dict(method="heterofl", selector="greedy", seed=3),
    dict(method="scalefl", selector="greedy", energy_scale=0.01))
#: the paper's harness (benchmarks/common.py:29-30, the non-FAST branch):
#: 40 devices, below 64, so "auto" takes the per-client executor
PAPER_CFG = dict(n_devices=40, participation=0.1, local_epochs=5,
                 n_train=6000, energy_scale=0.6, width_mult=1.0, hw=32,
                 seed=0)
#: Fig. 6's 64-device row (benchmarks/fig6_scalability.py:62-80) on the
#: paper's harness: n_train 6000 * 64 / 40, 10%, the async engine with a
#: reward evaluation every round(0.1 * 64) aggregations; 3 virtual rounds
#: (a budget of 18 tasks), not the harness's 30
ASYNC_CFG = dict(PAPER_CFG, n_devices=64, n_train=9600, engine_mode="async",
                 async_eval_every=6, n_rounds=3)
KERNELS = ("layer_agg", "rmsnorm", "flash_attention")
#: the call times that stood in for a device time the profiler did not
#: read (:func:`_times`)
EVENT_TIMED = []
#: our kernels' names in a profiler trace
OWN_KERNELS = ("layer_agg", "rmsnorm", "fa_")


def _device_spans(prof):
    """(start, end, name) of every device activity of a torch.profiler
    trace, in µs from the trace's start, each once (an activity reported
    twice counts once).  Read from the profiler's raw results, as
    ``prof.events()`` reads them but without building its event tree over
    every host op, which took up to 40 s a trace on the H100 machine."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    return sorted({((e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3,
                    e.name()) for e in res.events()
                   if e.device_type() == DeviceType.CUDA
                   and not e.is_hidden_event()})


def _times(fn, iters: int = 20, warmup: int = 3):
    """(device ms, call ms) of one call of fn, over iters calls made back
    to back.  Device ms: the summed durations of the kernels, copies and
    sets that fn runs on the card (torch.profiler, device activity only),
    the card's own time whatever the host does between launches.  Call
    ms: CUDA events around the calls, the same work with the host's cost
    of each call (Python, ctypes, allocation, autograd) where that cost
    is the larger."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(stop) / iters
    # the profiler now and then reads back no device activity at all (one
    # read in ~20 on the H100 machine); such a read is taken again, and
    # after 3 empty reads in a row (seen once in a whole run) the CUDA
    # events' time stands in for the device time, counted and printed
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = _device_spans(prof)
        if spans:
            return sum(e - s for s, e, _ in spans) / iters / 1e3, call_ms
    EVENT_TIMED.append(call_ms)
    print(f"[profiler] no device activity in 3 reads: device ms from CUDA "
          f"events, {call_ms:.4f} ms ({len(EVENT_TIMED)} such timings so "
          "far)")
    return call_ms, call_ms


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
    """One nvcc per kernel source, all started together (each build is a
    subprocess, so the threads only wait)."""
    import importlib
    from concurrent.futures import ThreadPoolExecutor
    mods = [importlib.import_module(f"repro_torch.kernels.{k}")
            for k in KERNELS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        built = list(pool.map(lambda m: m.load_library(), mods))
    for name, (_, seconds, log) in zip(KERNELS, built):
        regs = [l.split(":", 1)[-1].strip() for l in log.splitlines()
                if "registers" in l or "spill stores" in l]
        print(f"[build] {name}: nvcc {seconds:.2f} s; ptxas: "
              f"{' | '.join(regs)}")
    print(f"[build] all kernels built in {time.perf_counter() - t0:.2f} s")


def _errors(got, ref):
    """(max |got - ref|, that over the largest magnitude of ref, at least
    1): the absolute error and the relative one the tolerance holds."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max()
    return err.item(), (err / ref.abs().max().clamp_min(1.0)).item()


def _fwd_bwd_errors(fn, plain, inputs, dout):
    """(absolute, relative) errors of fn's output and gradients (for the
    cotangent dout) against plain's, on the same inputs, each a list:
    [fwd, grad of each input]."""
    import torch
    out = fn(*inputs)
    got = torch.autograd.grad(out, inputs, dout)
    ref_in = [t.detach().clone().requires_grad_() for t in inputs]
    ref_out = plain(*ref_in)
    ref = torch.autograd.grad(ref_out, ref_in, dout)
    torch.cuda.synchronize()
    if not all(torch.isfinite(t.float()).all() for t in (out, *got)):
        raise AssertionError("non-finite kernel output or gradient")
    errs = [_errors(out, ref_out)] + [_errors(a, b) for a, b in zip(got, ref)]
    return [e[0] for e in errs], [e[1] for e in errs]


def _grad_times(fn, inputs, dout, iters=20):
    """:func:`_times` of the backward alone, taken the same way for the
    kernel, the plain version and the library call: gradients of one
    retained graph of fn, through autograd again and again."""
    import torch
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*ins)
    return _times(lambda: torch.autograd.grad(out, ins, dout,
                                              retain_graph=True), iters)


def _fwd_bwd_times(fn, inputs, dout, iters=20):
    """:func:`_times` of one forward and its backward."""
    import torch
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    return _times(lambda: torch.autograd.grad(fn(*ins), ins, dout), iters)


def _record(name, source, replaces, abs_err, rel_err, times, n_bytes,
            n_ops, flops_per_s=FP32_FLOPS_PER_S):
    """A kernel's entry of the kernels line; times: (device ms, call ms)
    of the kernel, the plain version and the library call; the bound's
    operations over ``flops_per_s``, the peak of their type (named under
    ``peak`` where it is not float32's)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flops_per_s * 1e3
    (ms, call), (plain, plain_call), (lib, lib_call) = times
    record = {"name": name, "route": "cuda", "source": source,
              "replaces": replaces, "launches": None,
              "max_abs_err": abs_err, "max_rel_err": rel_err, "ms": ms,
              "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "library_ms": lib, "call_ms": call,
              "plain_call_ms": plain_call, "library_call_ms": lib_call}
    if flops_per_s != FP32_FLOPS_PER_S:
        record["peak"] = PEAKS[flops_per_s]
    return record


def _print_record(r, library, where="the path's shape"):
    print(f"[kernel] {r['name']} at {where}, device ms (call ms):"
          f" kernel {r['ms']:.4f} ({r['call_ms']:.4f}), plain "
          f"{r['plain_ms']:.4f} ({r['plain_call_ms']:.4f}), {library} "
          f"{r['library_ms']:.4f} ({r['library_call_ms']:.4f}), bound "
          f"{r['bound_ms']:.4f} ({r['bound_by']})")


def _timed_records(names, source, replaces, errs, fns, dout, costs,
                   library, where="the path's shape",
                   flops_per_s=FP32_FLOPS_PER_S, iters=20):
    """The records of a kernel's forward and backward at a path's shape
    (``where``).  fns: (function, inputs) of the kernel's wrapper, the
    plain version and the library call; errs: (absolute, relative) errors
    of the forward and of the backward; costs: (bytes, flops) of each,
    the flops at ``flops_per_s``; each time over ``iters`` calls."""
    fwd = [_times(lambda f=f, i=i: f(*[t.detach() for t in i]), iters)
           for f, i in fns]
    bwd = [_grad_times(f, i, dout, iters) for f, i in fns]
    records = [_record(n, source, replaces, *e, t, *c, flops_per_s)
               for n, e, t, c in zip(names, errs, (fwd, bwd), costs)]
    for r in records:
        _print_record(r, library, where)
    both = [_fwd_bwd_times(f, i, dout, iters) for f, i in fns]
    print(f"[kernel] {names[0]} forward+backward at {where}, "
          "device ms (call ms): " + ", ".join(
              f"{who} {dev:.4f} ({call:.4f})" for who, (dev, call)
              in zip(("kernel", "plain", library), both)))
    return records


def _attach_per_client(records, per_client):
    """The per-client shape's records go into the path's records, under
    ``per_client``, each with its shape."""
    for r, pc in zip(records, per_client):
        r["per_client"] = {k: pc[k] for k in (
            "shape", "max_abs_err", "max_rel_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "call_ms",
            "plain_call_ms", "library_call_ms", "rmsnorm_route", "splits")
            if k in pc}
    return records


#: rmsnorm's timed shapes: (G, R, d, where)
RMSNORM_TIMED = {"block norms": (16, 1024, 128, "the bucketed path's shape"),
                 "per-client block norms": (1, 1024, 128,
                                            "the per-client shape")}


def _rmsnorm_inputs(G, R, d, dtype, g, offset=0):
    """x (times 3), scale and dy on the card; x starts ``offset``
    elements into its storage (off the 16-byte grid for 1)."""
    import torch
    flat = torch.randn((G * R * d + offset,), generator=g, device="cuda") * 3
    x = flat[offset:].view(G, R, d).to(dtype).requires_grad_()
    s = torch.randn((G, d), generator=g, device="cuda").to(dtype)
    dy = torch.randn((G, R, d), generator=g, device="cuda").to(dtype)
    return x, s.requires_grad_(), dy


def rmsnorm_timed(mod, where, x, s, dy, errs):
    """The records of rmsnorm's forward and backward on x [G, R, d] (at
    ``where``), beside the plain version and ``F.rms_norm``
    with one [d] scale row for every group (the same bytes and flops, no
    per-group scale).  Uses only ``mod.rmsnorm``, ``rmsnorm_plain`` and
    ``EPS``, so ``scripts/rmsnorm_ab.py`` times earlier designs with it."""
    import torch.nn.functional as F
    G, R, d = x.shape
    s1 = s.detach()[0].contiguous()
    n = G * R * d
    records = _timed_records(
        ("rmsnorm", "rmsnorm_bwd"),
        "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm/rmsnorm.py:20", errs,
        [(mod.rmsnorm, [x, s]), (mod.rmsnorm_plain, [x, s]),
         (lambda a, b: F.rms_norm(a, (d,), b, mod.EPS), [x, s1])], dy,
        # forward: x in, y out, scale in, rstd out; ~4 flops an element.
        # Backward: x, dy in, dx out, scale in, dscale out, rstd in; ~9
        # flops an element
        [(4 * (2 * n + G * d + G * R), 4 * n),
         (4 * (3 * n + 2 * G * d + G * R), 9 * n)],
        "F.rms_norm with one [d] scale", where)
    for r in records:
        r["shape"] = f"G={G} R={R} d={d} {x.dtype}".replace("torch.", "")
    return records


def _rmsnorm_blocked_check(mod, label, x, s, dy):
    """The backward kernel called twice on the same inputs (with rstd from
    torch): bitwise equal; and against its CPU emulation of the kernel's
    order of sums, at 1e-6 of the largest magnitude.  Returns the
    backward's (route, splits)."""
    import torch
    G, R, d = x.shape
    x, s = x.detach(), s.detach()
    rstd = torch.rsqrt(torch.mean(x.float() ** 2, dim=-1) + mod.EPS)
    runs = [mod._backward(x, s, dy, rstd) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    route, splits = mod.rmsnorm_route(
        G, R, d, x.dtype, [x.data_ptr(), s.data_ptr(), dy.data_ptr(),
                           runs[0][0].data_ptr()], mod._sm_count(x.device))
    emu = mod.rmsnorm_bwd_blocked(x.cpu(), s.cpu(), dy.cpu(), rstd.cpu(),
                                  route, splits)
    err = max(_errors(a.cpu(), b)[1] for a, b in zip(runs[0], emu))
    print(f"[kernel] rmsnorm {label}: backward route {route}, {splits} "
          f"splits a group; two calls bitwise equal: {same}; against the "
          f"blocked emulation rel err {err:.2e} (limit 1e-06)")
    if not same or err > 1e-6:
        raise AssertionError(f"rmsnorm's backward at {label} is not "
                             "deterministic or disagrees with its emulation")
    return route, splits


def phase_rmsnorm():
    """rmsnorm forward and backward against the plain version, and the
    backward against itself (bitwise) and its blocked emulation, at the
    paths' and edge shapes (the general route: d not a multiple of 4, d
    over the vec route's 1024, x off the 16-byte grid, and the model
    layout on such a view); returns the records of both kernels, timed
    at the transformer path's block norms (16 participants x 32
    sequences x 32 positions, d 128) and, under ``per_client``, at the
    per-client executor's (one client: G 1)."""
    import importlib
    import torch
    mod = importlib.import_module("repro_torch.kernels.rmsnorm.rmsnorm")
    # (label, G, R, d, dtype, x's offset in elements)
    shapes = [("block norms", 16, 1024, 128, "float32", 0),
              ("per-client block norms", 1, 1024, 128, "float32", 0),
              ("exit norms", 16, 32, 128, "float32", 0),
              ("odd R", 3, 11, 128, "float32", 0),
              ("odd R, one group", 1, 7, 64, "float32", 0),
              ("one row", 4, 1, 128, "float32", 0),
              ("d not a power of two", 4, 33, 100, "float32", 0),
              ("d not a multiple of 4", 2, 9, 99, "float32", 0),
              ("d 8192", 2, 5, 8192, "float32", 0),
              ("x off the 16-byte grid", 1, 1024, 128, "float32", 1),
              ("block norms bf16", 16, 1024, 128, "bfloat16", 0),
              ("d 100 bf16", 4, 33, 100, "bfloat16", 0)]
    g = torch.Generator(device="cuda").manual_seed(0)
    records = {}
    for label, G, R, d, dt, offset in shapes:
        x, s, dy = _rmsnorm_inputs(G, R, d, getattr(torch, dt), g, offset)
        fwd_route, _ = mod.rmsnorm_route(
            G, R, d, x.dtype, [x.data_ptr(), s.data_ptr()], 1)
        abs_errs, errs = _fwd_bwd_errors(mod.rmsnorm, mod.rmsnorm_plain,
                                         [x, s], dy)
        print(f"[kernel] rmsnorm {label} G={G} R={R} d={d} {dt} (forward "
              f"route {fwd_route}): rel err y {errs[0]:.2e}, dx "
              f"{errs[1]:.2e}, dscale {errs[2]:.2e} (limit "
              f"{KERNEL_TOL[dt]:.0e}); abs err y {abs_errs[0]:.2e}, grads "
              f"{max(abs_errs[1:]):.2e}")
        if max(errs) > KERNEL_TOL[dt]:
            raise AssertionError(f"rmsnorm disagrees with its plain "
                                 f"version at {label}")
        route, splits = _rmsnorm_blocked_check(mod, label, x, s, dy)
        if label not in RMSNORM_TIMED:
            continue
        rec = records[label] = rmsnorm_timed(
            mod, RMSNORM_TIMED[label][3], x, s, dy,
            [(abs_errs[0], errs[0]), (max(abs_errs[1:]), max(errs[1:]))])
        rec[0]["rmsnorm_route"] = fwd_route
        rec[1]["rmsnorm_route"], rec[1]["splits"] = route, splits
        for r in rec:
            print(f"[kernel] {r['name']} at {RMSNORM_TIMED[label][3]}: route "
                  f"{r['rmsnorm_route']}, splits {r.get('splits', '-')}")
    _rmsnorm_op_offset_view(mod)
    return _attach_per_client(records["block norms"],
                              records["per-client block norms"])


def _rmsnorm_op_offset_view(mod):
    """The model layout ([32, 32, 128], one client's block norms) on a
    contiguous view that starts one element into its storage: the general
    route forward and backward, against the plain version."""
    import torch
    from repro_torch.kernels import LAUNCHES
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((32 * 32 * 128 + 1,), generator=g, device="cuda")[1:]
    x = x.view(32, 32, 128).requires_grad_()
    s = torch.randn((128,), generator=g, device="cuda").requires_grad_()
    w = torch.randn((32, 32, 128), generator=g, device="cuda")
    before = dict(LAUNCHES)
    abs_errs, errs = _fwd_bwd_errors(mod.rmsnorm_op, mod.rmsnorm_plain,
                                     [x, s], w)
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
             if LAUNCHES[k] != before[k]}
    print(f"[kernel] rmsnorm_op on a view one element in, [32, 32, 128] "
          f"f32: launches {moved}; rel err y {errs[0]:.2e}, dx "
          f"{errs[1]:.2e}, dscale {errs[2]:.2e} (limit "
          f"{KERNEL_TOL['float32']:.0e})")
    if max(errs) > KERNEL_TOL["float32"] or \
            moved.get("rmsnorm_general") != 1 or \
            moved.get("rmsnorm_bwd_general") != 1:
        raise AssertionError("rmsnorm_op on an unaligned view")


def phase_floor():
    """The card's launch floor: the device ms of the smallest ATen
    kernel, a fill of a one-element tensor, through :func:`_times`."""
    import torch
    t = torch.empty((1,), device="cuda")
    ms, call = _times(lambda: t.fill_(0.0))
    print(f"[floor] a fill of one element: device ms {ms:.4f} (call ms "
          f"{call:.4f})")
    return ms


def _attention_pairs(BH, Sq, Sk, causal, window) -> int:
    """(query, key) pairs the masks keep: the work this input needs."""
    total = 0
    for q in range(Sq):
        lo = max(0, q - window + 1) if window else 0
        hi = min(q, Sk - 1) if causal else Sk - 1
        total += max(0, hi - lo + 1)
    return BH * total


def attention_routes(mod, Sq, Sk, D, group, dtype="float32", causal=True,
                     window=0):
    """(forward route, backward route, split) of a shape with contiguous
    tensors: ``split`` and ``short`` on the short-query route, ``wgmma``
    and ``wgmma`` on the bf16 tensor-core route, else ``tiled`` and
    ``fused`` or ``three_pass`` (a checkout without the short route:
    always tiled; one whose ``attention_route`` takes no dtype: no wgmma
    route)."""
    import inspect
    import torch
    route, split = "tiled", 0
    if hasattr(mod, "attention_route"):
        if "dtype" in inspect.signature(mod.attention_route).parameters:
            route, split = mod.attention_route(
                Sq, Sk, D, group, getattr(torch, dtype), causal=causal,
                window=window)
        else:
            route, split = mod.attention_route(Sq, Sk, D, group)
    if route == "short":
        return "split", "short", split
    if route == "wgmma":
        return "wgmma", "wgmma", 0
    return ("tiled", "fused" if mod.fused_backward(Sq, Sk, D)
            else "three_pass", 0)


#: each attention kernel's source, by direction and route (the launch
#: counter's suffix)
ATTENTION_SOURCES = {
    r: f"src/repro_torch/kernels/flash_attention/csrc/{f}" for r, f in (
        ("fwd_split", "fwd_split.cu"), ("fwd_tiled", "fwd.cu"),
        ("fwd_wgmma", "fwd_wgmma.cu"), ("bwd_short", "bwd_short.cu"),
        ("bwd_fused", "bwd_fused.cu"), ("bwd_three_pass",
                                        "bwd_three_pass.cu"),
        ("bwd_wgmma", "bwd_wgmma.cu"))}
#: the forward and the backward routes, as the launch counters name them
FWD_ROUTES = ("split", "tiled", "wgmma")
BWD_ROUTES = ("short", "fused", "three_pass", "wgmma")


def _route_launch(mod, q, k, v, do, causal, window):
    """The shape's route's forward and backward launched directly on [BH,
    S, D] tensors, through their model-layout views as
    ``flash_attention_bhsd`` hands them over: (o, lse, dq, dk, dv)."""
    import torch
    BH, BHkv = q.shape[0], k.shape[0]

    def model(t, heads):
        return t.unflatten(0, (BHkv, heads)).transpose(1, 2)
    qm, km, vm, dom = (model(q, BH // BHkv), model(k, 1), model(v, 1),
                       model(do, BH // BHkv))
    om, dqm, dkm, dvm = (torch.empty_like(t) for t in (qm, qm, km, vm))
    lse = mod._forward(qm, km, vm, om, causal, window)
    mod._backward(qm, km, vm, om, dom, lse, dqm, dkm, dvm, causal, window)

    def bhsd(t):
        return t.transpose(1, 2).flatten(0, 1)
    return [bhsd(om), lse] + [bhsd(t) for t in (dqm, dkm, dvm)]


def _attention_short_check(mod, label, q, k, v, do, causal, window, split):
    """The short route's kernels called twice on the same inputs (also
    where the shape's Sk is below ``SHORT_MIN_SK``, the route's edge cases
    with rows that see no key): bitwise equal in o, lse, dq, dk and dv;
    against the plain version at the kernels' tolerance; and against
    their CPU emulation of the kernels' order of sums at 1e-6 of the
    largest magnitude in float32 (1e-2 in bfloat16, a rounding of the
    output apart), lse -1e30 on both for rows that see no key."""
    import torch
    q, k, v = (t.detach() for t in (q, k, v))
    least = mod.SHORT_MIN_SK
    mod.SHORT_MIN_SK = 1
    try:
        runs = [_route_launch(mod, q, k, v, do, causal, window)
                for _ in range(2)]
    finally:
        mod.SHORT_MIN_SK = least
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = mod.attention_plain(*ins, causal=causal, window=window)
    refs = [ref, *torch.autograd.grad(ref, ins, do)]
    plain = max(_errors(a, b)[1] for a, b in zip(runs[0][:1] + runs[0][2:],
                                                 refs))
    got = [t.cpu() for t in runs[0]]
    cpu = [t.cpu() for t in (q, k, v)]
    o, lse = mod.attention_split_blocked(*cpu, causal=causal,
                                         window=window, split=split)
    emu = [o, lse, *mod.attention_split_blocked_bwd(
        *cpu, got[0], do.cpu(), got[1], causal=causal, window=window,
        split=split)]
    seen = lse > -1e29
    keyless_equal = torch.equal(got[1][~seen], lse[~seen])
    errs = [_errors(got[1][seen], lse[seen])[1]] + [
        _errors(a, b)[1] for a, b in zip(got[:1] + got[2:],
                                         emu[:1] + emu[2:])]
    lim = 1e-6 if q.dtype == torch.float32 else 1e-2
    tol = KERNEL_TOL[str(q.dtype).replace("torch.", "")]
    print(f"[kernel] flash_attention {label}: short route, split {split}; "
          f"two launches bitwise equal: {same}; against the plain version "
          f"rel err {plain:.2e} (limit {tol:.0e}); against the blocked "
          f"emulation rel err lse {errs[0]:.2e}, o {errs[1]:.2e}, dq "
          f"{errs[2]:.2e}, dk {errs[3]:.2e}, dv {errs[4]:.2e} (limit "
          f"{lim:.0e}); keyless rows' lse equal: {keyless_equal}")
    if not same or not keyless_equal or max(errs) > lim or plain > tol:
        raise AssertionError(f"flash_attention's short route at {label} is "
                             "not deterministic or disagrees with its "
                             "emulation")


def _attention_wgmma_check(mod, label, q, k, v, do, window):
    """The wgmma route's kernels called twice on the same bf16 inputs
    [BH, S, D]: bitwise equal in o, lse, dq, dk and dv; and, at the edge
    shapes (BH Sq Sk at most 2^24), against their CPU emulation of the
    route's rounding (``attention_wgmma_blocked``) at 1e-2 of the largest
    magnitude (lse at 1e-5): the tensor cores sum in their own order."""
    import torch
    q, k, v = (t.detach() for t in (q, k, v))
    runs = [_route_launch(mod, q, k, v, do, True, window) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    emu_err = None
    if q.shape[0] * q.shape[1] * k.shape[1] <= 2 ** 24:
        got = [t.cpu() for t in runs[0]]
        cpu = [t.cpu() for t in (q, k, v)]
        o, lse = mod.attention_wgmma_blocked(*cpu, causal=True, window=window)
        emu = [o, *mod.attention_wgmma_blocked_bwd(
            *cpu, got[0], do.cpu(), got[1], causal=True, window=window)]
        emu_err = max(_errors(a, b)[1] for a, b in zip(got[:1] + got[2:],
                                                       emu))
        lse_err = _errors(got[1], lse)[1]
    print(f"[kernel] flash_attention {label}: wgmma route; two launches "
          f"bitwise equal: {same}" + (
              "" if emu_err is None else
              f"; against the emulation rel err o/grads {emu_err:.2e} "
              f"(limit 1e-02), lse {lse_err:.2e} (limit 1e-05)"))
    if not same or (emu_err is not None and (emu_err > 1e-2 or
                                             lse_err > 1e-5)):
        raise AssertionError(f"flash_attention's wgmma route at {label} is "
                             "not deterministic or disagrees with its "
                             "emulation")


def _attention_case(mod, g, shape, where=None):
    """One of :func:`phase_attention`'s shapes, ``(label, BH, BHkv, Sq,
    Sk, D, causal, window, dtype)``: the kernel's forward and backward held
    against the plain version (on the short route also against their
    emulation, and bitwise against themselves); with ``where`` (the
    shape's name in the printed lines) also timed beside SDPA, returning
    the forward's and the backward's records."""
    import torch
    import torch.nn.functional as F
    label, BH, BHkv, Sq, Sk, D, causal, window, dt = shape
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn(dims, generator=g, device="cuda").to(dtype)
               for dims in ((BH, Sq, D), (BHkv, Sk, D), (BHkv, Sk, D)))
    if label.startswith("set mixer"):
        q[..., -1] = D ** 0.5
        k[..., -1] = torch.randn((BHkv, Sk), generator=g,
                                 device="cuda") * 0.1
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    do = torch.randn((BH, Sq, D), generator=g, device="cuda").to(dtype)

    def fn(a, b, c):
        return mod.flash_attention_bhsd(a, b, c, causal=causal,
                                        window=window)

    def plain(a, b, c):
        return mod.attention_plain(a, b, c, causal=causal,
                                   window=window)
    abs_errs, errs = _fwd_bwd_errors(fn, plain, [q, k, v], do)
    fwd_route, route, split = attention_routes(mod, Sq, Sk, D, BH // BHkv,
                                               dt, causal, window)
    print(f"[kernel] flash_attention {label} BH={BH} BHkv={BHkv} "
          f"Sq={Sq} Sk={Sk} D={D} causal={causal} window={window} {dt}"
          f" (forward {fwd_route}, backward {route}):"
          f" rel err o {errs[0]:.2e}, dq {errs[1]:.2e}, dk "
          f"{errs[2]:.2e}, dv {errs[3]:.2e} (limit "
          f"{KERNEL_TOL[dt]:.0e}); abs err o {abs_errs[0]:.2e}, grads "
          f"{max(abs_errs[1:]):.2e}")
    if max(errs) > KERNEL_TOL[dt]:
        raise AssertionError(f"flash_attention disagrees with its plain"
                             f" version at {label}")
    if route == "short" or label.startswith("short"):
        _attention_short_check(mod, label, q, k, v, do, causal, window,
                               split or mod.short_split(D))
    if route == "wgmma":
        _attention_wgmma_check(mod, label, q, k, v, do, window)
    if where is None:
        return None

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c,
                                              is_causal=causal)
    pairs = _attention_pairs(BH, Sq, Sk, causal, window)
    nq, nk = BH * Sq * D, BHkv * Sk * D
    rec = _timed_records(
        ("flash_attention", "flash_attention_bwd"),
        ATTENTION_SOURCES["fwd_" + fwd_route],
        "src/repro/kernels/flash_attention/flash_attention.py:67",
        [(abs_errs[0], errs[0]), (max(abs_errs[1:]), max(errs[1:]))],
        [(f, [q, k, v]) for f in (fn, plain, sdpa)], do,
        # forward: q, k, v in, o and lse out; q.k and p.v per kept
        # pair.  Backward: q, k, v, o, dO, lse in; dq, dk, dv out;
        # five products per kept pair (s, dp, dv, dq, dk)
        [(4 * (2 * nq + 2 * nk + BH * Sq), 4 * D * pairs),
         (4 * (4 * nq + 4 * nk + BH * Sq), 10 * D * pairs)],
        "SDPA is_causal" if causal else "SDPA", where)
    rec[0]["fwd_route"], rec[1]["bwd_route"] = fwd_route, route
    rec[1]["source"] = ATTENTION_SOURCES["bwd_" + route]
    for r in rec:
        r["shape"] = (f"BH={BH} S={Sq} D={D} causal {dt}" if causal else
                      f"BH={BH} Sq={Sq} Sk={Sk} D={D} non-causal {dt}")
    return rec


def phase_attention():
    """flash_attention forward and backward against the plain version;
    returns the records of both, timed at the transformer path's shape
    (BH = 16 participants x 32 sequences x 4 heads, S 32, D 32, causal)
    and, under ``per_client``, at the per-client executor's (one client:
    BH = 32 sequences x 4 heads); then the records at the set mixer's
    shapes, timed beside non-causal SDPA: its path shape ([fig6 n1024]:
    BH = 208 replay steps, 4 seed queries over 1024 agents, D 32,
    non-causal; the seeds carry sqrt(32) and the keys a log-weight in
    slot -1) and [marl train]'s n = 1M shape (BH 12, 4096 stored
    agents)."""
    import importlib
    import torch
    mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    # (label, BH, BHkv, Sq, Sk, D, causal, window, dtype)
    shapes = [("path", 2048, 2048, 32, 32, 32, True, 0, "float32"),
              ("per-client path", 128, 128, 32, 32, 32, True, 0, "float32"),
              ("GQA 4:2 D64", 8, 4, 128, 128, 64, True, 0, "float32"),
              ("GQA 8:1", 8, 1, 256, 256, 32, True, 0, "float32"),
              ("window 32 D128", 4, 4, 128, 128, 128, True, 32, "float32"),
              ("non-causal", 4, 4, 64, 64, 64, False, 0, "float32"),
              ("GQA 6:2", 6, 2, 128, 128, 64, True, 0, "float32"),
              ("set mixer", 2, 2, 4, 4096, 32, False, 0, "float32"),
              ("set mixer path", 208, 208, 4, 1024, 32, False, 0,
               "float32"),
              ("set mixer ragged", 208, 208, 4, 300, 32, False, 0,
               "float32"),
              ("set mixer bench", 12, 12, 4, 4096, 32, False, 0,
               "float32"),
              ("rows with no key", 2, 1, 40, 24, 16, True, 5, "float32"),
              ("odd sizes", 3, 3, 33, 17, 20, False, 3, "float32"),
              ("path bf16", 2048, 2048, 32, 32, 32, True, 0, "bfloat16"),
              # the fused backward's length limit and one past it (three
              # passes) at D 32, 64 and 128; a GQA group with a window in
              # the fused range
              ("fused limit D32", 64, 64, 64, 64, 32, True, 0, "float32"),
              ("past it D32", 64, 64, 65, 65, 32, True, 0, "float32"),
              ("fused limit D64", 64, 64, 64, 64, 64, True, 0, "float32"),
              ("past it D64", 64, 64, 65, 65, 64, True, 0, "float32"),
              ("fused limit D128", 64, 64, 32, 32, 128, True, 0, "float32"),
              ("past it D128", 64, 64, 33, 33, 128, True, 0, "float32"),
              ("fused GQA 4:1 window", 64, 16, 48, 48, 64, True, 16,
               "float32"),
              ("fused limit D64 bf16", 64, 64, 64, 64, 64, True, 0,
               "bfloat16"),
              # the short-query route's edges: Sq 1 and 8; a split of 128
              # keys (D 32) one key short, whole, one key over; GQA; D 64
              # and 128 (splits of 64 and 32 keys); causal rows whose
              # later splits are all masked; a window with rows that see
              # no key; bf16.  The wrapper takes Sk below SHORT_MIN_SK
              # (5, 33) to the tiled route; the short check forces them
              # through the short kernels
              ("short Sq 1", 16, 16, 1, 1000, 32, False, 0, "float32"),
              ("short Sq 8", 16, 16, 8, 300, 32, False, 0, "float32"),
              ("short split - 1", 16, 16, 4, 127, 32, False, 0, "float32"),
              ("short split", 16, 16, 4, 128, 32, False, 0, "float32"),
              ("short split + 1", 16, 16, 4, 129, 32, False, 0, "float32"),
              ("short GQA 4:1", 16, 4, 4, 300, 32, False, 0, "float32"),
              ("short GQA 8:1 causal D64", 16, 2, 3, 257, 64, True, 0,
               "float32"),
              ("short causal D128", 8, 8, 8, 200, 128, True, 0, "float32"),
              ("short window", 8, 8, 8, 300, 32, True, 4, "float32"),
              ("short rows with no key", 6, 3, 8, 5, 16, True, 2,
               "float32"),
              ("short set mixer bf16", 208, 208, 4, 1024, 32, False, 0,
               "bfloat16"),
              ("short GQA 4:1 bf16 D128", 8, 2, 8, 33, 128, False, 0,
               "bfloat16"),
              # the wgmma route's edges (bf16, causal): Sq and Sk off the
              # 64-row tiles, Sq != Sk, GQA 4:1 at D 128, a window that
              # crosses the 128-key tiles at D 96, D 16 (one TMA box of 64
              # columns, 48 of them zeros)
              ("wgmma GQA 4:1 D128", 8, 2, 130, 130, 128, True, 0,
               "bfloat16"),
              ("wgmma window D96", 8, 8, 300, 300, 96, True, 100,
               "bfloat16"),
              ("wgmma Sq != Sk D64", 4, 2, 200, 136, 64, True, 0,
               "bfloat16"),
              ("wgmma D16", 4, 4, 96, 96, 16, True, 0, "bfloat16")]
    timed = {"path": "the bucketed path's shape",
             "per-client path": "the per-client shape",
             "set mixer path": "the set mixer's path shape",
             "set mixer bench": "the set mixer's n = 1M shape"}
    g = torch.Generator(device="cuda").manual_seed(1)
    records = {}
    for shape in shapes:
        rec = _attention_case(mod, g, shape, timed.get(shape[0]))
        if rec is not None:
            records[shape[0]] = rec
    _model_layout_times(mod)
    for r in records["set mixer path"]:
        r["path"] = "fig6 n1024 set mixer"
    for r in records["set mixer bench"]:
        r["path"] = "marl train n=1048576 set mixer"
    return (_attach_per_client(records["path"], records["per-client path"]),
            records["set mixer path"] + records["set mixer bench"])


def _model_layout_times(mod):
    """The model-layout call at the transformer path's shape (q, k, v
    [512, 32, 4, 32] contiguous, as the model hands them over, causal,
    f32): its output and gradients held against the plain version, then
    forward and forward plus backward timed beside SDPA on the same
    layout (through transposed views)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn((512, 32, 4, 32), generator=g, device="cuda")
                   .requires_grad_() for _ in range(4))
    do = do.detach()

    def plain(a, b, c):                 # heads-first and back
        o = mod.attention_plain(*(t.transpose(1, 2).reshape(-1, 32, 32)
                                  for t in (a, b, c)))
        return o.reshape(512, 4, 32, 32).transpose(1, 2)
    abs_errs, errs = _fwd_bwd_errors(mod.flash_attention, plain, [q, k, v],
                                     do)
    print(f"[kernel] model layout [512, 32, 4, 32] causal f32: rel err o "
          f"{errs[0]:.2e}, dq {errs[1]:.2e}, dk {errs[2]:.2e}, dv "
          f"{errs[3]:.2e} (limit {KERNEL_TOL['float32']:.0e}); abs err o "
          f"{abs_errs[0]:.2e}, grads {max(abs_errs[1:]):.2e}")
    if max(errs) > KERNEL_TOL["float32"]:
        raise AssertionError("the model-layout flash_attention disagrees "
                             "with its plain version")

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            is_causal=True).transpose(1, 2)
    fns = (("flash_attention", mod.flash_attention), ("SDPA", sdpa))
    fwd = [_times(lambda f=f: f(q.detach(), k.detach(), v.detach()))
           for _, f in fns]
    both = [_fwd_bwd_times(f, [q, k, v], do) for _, f in fns]
    for (who, _), (dev, call), (dev2, call2) in zip(fns, fwd, both):
        print(f"[kernel] model layout [512, 32, 4, 32] causal f32, {who}: "
              f"forward device ms {dev:.4f} (call ms {call:.4f}); forward+"
              f"backward device ms {dev2:.4f} (call ms {call2:.4f})")


def _layer_agg_record(U, M, w, err, scale):
    """layer_agg's record at U's shape: the kernel, the plain version and
    the einsum + divide library call, beside the bound (each input read
    once, the output written once)."""
    import torch
    N, R, D = U.shape

    def library():
        wm = w[:, None] * M
        return (torch.einsum("nl,nld->ld", wm, U)
                / wm.sum(dim=0).clamp_min(1e-12)[:, None])
    from repro_torch.kernels.layer_agg import layer_agg, layer_agg_plain
    times = [_times(f) for f in (lambda: layer_agg(U, M, w),
                                 lambda: layer_agg_plain(U, M, w), library)]
    n_bytes = 4 * (N * R * D + N * R + N + R * D)
    record = _record("layer_agg",
                     "src/repro_torch/kernels/layer_agg/csrc/layer_agg.cu",
                     "src/repro/kernels/layer_agg/layer_agg.py:37", err,
                     err / scale, times, n_bytes, 2 * N * R * D + R * D)
    record["shape"] = f"N={N} R={R} D={D} float32"
    _print_record(record, "einsum+divide", record["shape"])
    print(f"[kernel] layer_agg {record['shape']}: {n_bytes / 1e6:.1f} MB at "
          f"3.35 TB/s; {n_bytes / record['ms'] / 1e6:.1f} GB/s of device "
          "time")
    return record


def phase_kernels():
    """layer_agg against its plain version; returns the record timed at
    the sync main path's shape (N 9), with the async engine's (one client
    a launch, N 1) under ``async``."""
    import torch
    from repro_torch.core.aggregation import stacked_masked_mean
    from repro_torch.kernels.layer_agg import layer_agg, layer_agg_plain
    shapes = [("main path", 9, 11084, 1024), ("one client", 1, 11084, 1024),
              ("300 clients", 300, 1024, 1024), ("ragged D", 5, 1000, 1000),
              ("D over one chunk", 3, 257, 3000)]
    records = {}
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
        if label in ("main path", "one client"):
            records[label] = _layer_agg_record(U, M, w, err, scale)
        del U, M, w, got, ref
    # staleness alphas: kernel path on the card vs the plain path on the
    # CPU, at 9 clients and at the async engine's one (R 11084)
    for N, R in ((9, 2048), (1, 11084)):
        U, M, w = _agg_inputs(N, R, 1024, seed=5)
        a = torch.rand((N,), device="cuda") * 0.8 + 0.2
        got = stacked_masked_mean(U, M, w, a)
        ref = stacked_masked_mean(U.cpu(), M.cpu(), w.cpu(), a.cpu())
        err = (got.cpu() - ref).abs().max().item()
        print(f"[kernel] layer_agg alpha path N={N} R={R}: "
              f"max_abs_err={err:.3e}")
        if err > REL_TOL * max(ref.abs().max().item(), 1.0):
            raise AssertionError("alpha path disagrees with the CPU plain "
                                 "path")
        del U, M, w, got, ref
    record = records["main path"]
    record["async"] = records["one client"]
    return record


def _drive(tag, cfg, executor, expect):
    """One ``run_simulation`` of ``cfg`` (a flat config or a typed
    ``SimulationSpec``) on the card with the launch counts reset
    just before and read just after; prints per-round lines and checks
    what every run must show: the ``executor`` it should take, finite
    accuracy, energy and reward, and the exact launch counts that
    ``expect(hist)`` gives (a dict of ``LAUNCHES`` keys).  Returns
    (hist, launches)."""
    import numpy as np
    import torch
    from repro_torch.fl import ensure_flat_config, run_simulation
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
    cfg = ensure_flat_config(cfg)     # a typed spec's flat config
    for t in range(len(hist["acc"])):
        print(f"[{tag}] round {t}: acc={np.round(hist['acc'][t], 4).tolist()}"
              f" energy={hist['energy'][t]:.1f} J reward="
              f"{hist['reward'][t]:+.4f} picks={hist['participants'][t]} "
              f"models={hist['model_choices'][t]} "
              f"wall={hist['wall_clock'][t]:.3f} s")
        print(f"[{tag}] round {t} host seconds by phase: " + ", ".join(
            f"{k}={v:.4f}" for k, v in hist["phase_s"][t].items()))
    print(f"[{tag}] {cfg.method}/{cfg.selector} executor={hist['executor']}"
          f" aggregations={hist['n_aggregations']} bucket programs="
          f"{fl_batch.COUNTERS['executions']} qmix updates="
          f"{hist.get('qmix', {}).get('updates', 0)} launches={launches} "
          f"run wall={wall:.2f} s peak device memory="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if hist["executor"] != executor:
        raise AssertionError(f"[{tag}] took the {hist['executor']} "
                             f"executor, not the {executor} one")
    if hist["n_aggregations"] < 1:
        raise AssertionError(f"[{tag}] no round aggregated")
    want = expect(hist)
    wrong = {k: (launches[k], v) for k, v in want.items()
             if launches[k] != v}
    if wrong:
        raise AssertionError(f"[{tag}] launches (counted, expected): "
                             f"{wrong}")
    vals = np.concatenate([np.ravel(hist["acc"]), hist["energy"],
                           hist["reward"]])
    if not np.all(np.isfinite(vals)):
        raise AssertionError(f"[{tag}] non-finite accuracy, energy or "
                             "reward")
    return hist, launches


def _one_per_round(hist):
    """``layer_agg`` once per aggregation (the stacked DR-FL aggregation
    of the bucketed executor): a sync round with a cohort, or an async
    completion."""
    return {"layer_agg": hist["n_aggregations"]}


def _no_layer_agg(hist):
    """The per-client executor aggregates with ``layerwise_aggregate`` and
    the baselines with the sliced scatter, as the reference: no
    ``layer_agg`` launch."""
    return {"layer_agg": 0}


def phase_main_path():
    from repro_torch.fl import FLConfig
    hist, launches = _drive("main", FLConfig(n_rounds=3, participation=0.1,
                                             **MAIN_CFG), "batched",
                            _one_per_round)
    if hist["qmix"]["updates"] < 1:
        raise AssertionError("no QMIX update ran")
    return launches


def phase_all_submodels():
    """The same entry point at 50% participation (32 picks of 64): every
    round aggregates several buckets in one launch, and the deepest
    submodel trains.  Returns its config for the profile."""
    from repro_torch.fl import FLConfig
    cfg = FLConfig(n_rounds=2, participation=0.5, **MAIN_CFG)
    hist, _ = _drive("submodels", cfg, "batched", _one_per_round)
    per_round = [sorted(set(m)) for m in hist["model_choices"]]
    print(f"[submodels] submodels trained per round: {per_round}")
    if max(len(m) for m in per_round) < 2:
        raise AssertionError("no round aggregated more than one bucket")
    deepest = len(hist["acc"][0]) - 1
    if not any(deepest in m for m in per_round):
        raise AssertionError("the deepest submodel never trained")
    return cfg


def phase_profile(cfg, tag="profile", rounds=1):
    """Device busy share of ``rounds`` warm rounds of ``cfg`` (virtual
    rounds on the async engine; ``torch.profiler``, device activity only:
    recording every host op of the vmapped programs makes the trace too
    large to read back in time).  Busy time is the union of the kernels'
    intervals inside the rounds, so overlapping or doubly reported kernels
    are not counted twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fl import run_simulation
    cfg = dataclasses.replace(cfg, n_rounds=rounds)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        hist = run_simulation(cfg)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    spans = _device_spans(prof)
    round_s = sum(hist["wall_clock"])
    if not spans:
        print(f"[{tag}] device busy time: not measured (no device events "
              "in the trace)")
        return round_s, None
    # the rounds end in the last one's tail pull, right after its last
    # kernel: the window is their host wall time ending there.  The async
    # engine trains QMIX after its last row: that span's host seconds (it
    # ends in a pull, so they cover its device work) come off the end
    round_us = round_s * 1e6
    tail_us = (hist["phase_s"][-1].get("marl_train", 0.0) * 1e6
               if hist["engine"] == "async" else 0.0)
    hi = max(e_ for _, e_, _ in spans) - tail_us
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
    in_round = [(s_, e_, n) for s_, e_, n in spans if lo <= s_ < hi]
    print(f"[{tag}] {rounds} warm round(s) of {cfg.model_family} "
          f"{cfg.method} ({hist['engine']}), participation "
          f"{cfg.participation}, submodels "
          f"{sorted(set(m for r in hist['model_choices'] for m in r))}: wall "
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
        print(f"[{tag}] kernel {name[:60]}: {n} launches, {t / 1e3:.2f} ms")
    for what, keys in (("ATen elementwise kernels", ("elementwise",)),
                       ("copies (cat, copy kernels, memcpy)",
                        ("Cat", "copy", "Memcpy"))):
        hit = [(n, t) for name, (n, t) in by_name.items()
               if any(k in name for k in keys)]
        print(f"[{tag}] {what} in the rounds: {sum(n for n, _ in hit)} "
              f"launches, {sum(t for _, t in hit) / 1e3:.2f} ms")
    for name, (n, t) in sorted(by_name.items()):
        if any(k in name for k in OWN_KERNELS):
            print(f"[{tag}] own kernel {name[:60]} in the rounds: {n} "
                  f"launches, {t / 1e3:.4f} ms")
    return round_us / 1e6, busy_us / round_us


def phase_transformer():
    """The transformer path through the user's entry point: 64 devices,
    the full-width early-exit transformer, 50% participation, so several
    buckets train per round, the deepest submodel included.  Every
    kernel of the path must have launched.  Returns (cfg, launches)."""
    from collections import Counter
    from repro_torch.fl import FLConfig
    cfg = FLConfig(**TRANSFORMER_CFG)
    hist, launches = _drive("transformer", cfg, "batched", _one_per_round)
    per_round = [sorted(set(m)) for m in hist["model_choices"]]
    for t, models in enumerate(hist["model_choices"]):
        print(f"[transformer] round {t}: submodels trained {per_round[t]}, "
              f"buckets (submodel: participants) "
              f"{dict(sorted(Counter(models).items()))}")
    missing = [k for k in ("layer_agg", "rmsnorm", "rmsnorm_bwd",
                           "flash_attention", "flash_attention_bwd")
               if launches[k] < 1]
    if missing:
        raise AssertionError(f"the transformer path never launched {missing}")
    if launches["rmsnorm_vec"] != launches["rmsnorm"] or \
            launches["rmsnorm_bwd_vec"] != launches["rmsnorm_bwd"]:
        raise AssertionError("the transformer path's rmsnorm did not always "
                             f"take the vec route: {launches}")
    if launches["flash_attention_bwd_fused"] != \
            launches["flash_attention_bwd"]:
        raise AssertionError("the transformer path's attention backward "
                             f"did not always take the fused kernel: "
                             f"{launches}")
    if launches["flash_attention_fwd_tiled"] != launches["flash_attention"]:
        raise AssertionError("the transformer path's attention forward did "
                             f"not always take the tiled route: {launches}")
    if max(len(m) for m in per_round) < 2:
        raise AssertionError("no round trained more than one bucket")
    deepest = len(hist["acc"][0]) - 1
    if not any(deepest in m for m in per_round):
        raise AssertionError("the deepest submodel never trained")
    return cfg, launches


def phase_paper_fleet():
    """The slice's path: the paper's harness (40 devices, so "auto" takes
    the per-client executor), DR-FL + MARL for 3 rounds; its aggregation
    is ``layerwise_aggregate``, so ``layer_agg`` never launches."""
    from repro_torch.fl import FLConfig
    hist, _ = _drive("paper fleet", FLConfig(n_rounds=3, **PAPER_CFG),
                     "perclient", _no_layer_agg)
    if hist["qmix"]["updates"] < 1:
        raise AssertionError("no QMIX update ran on the paper fleet")


def phase_defaults():
    """``FLConfig()`` as it stands (40 devices, the CNN at width 0.25 on
    16x16, DR-FL + MARL) but for its depth, 3 of its 30 rounds (the
    script's time): the per-client executor, no ``layer_agg``."""
    from repro_torch.fl import FLConfig
    hist, _ = _drive("defaults", FLConfig(n_rounds=3), "perclient",
                     _no_layer_agg)
    print(f"[defaults] {len(hist['acc'])} rounds, final accuracy per exit "
          f"{[round(float(a), 4) for a in hist['final_acc']]}, warm round "
          f"wall {hist['wall_clock'][-1]:.3f} s")


def phase_table1():
    """Every other arm of Table 1 / Fig. 5 on the paper's fleet, 1 round
    each (the script's time): best accuracy per exit and the round's
    wall.  HeteroFL and
    ScaleFL run at energy_scale 0.01: at the harness's 0.6 every fresh
    battery affords the full model (a round costs under 2% of one), so
    greedy would give every client the full width whatever the seed; at
    0.01 some afford only the 0.75 slice, and a round trains two widths."""
    from repro_torch.fl import FLConfig
    for method, selector in (("drfl", "greedy"), ("heterofl", "greedy"),
                             ("scalefl", "greedy"), ("drfl", "random"),
                             ("drfl", "static")):
        kw = dict(PAPER_CFG, n_rounds=1, method=method, selector=selector)
        if method != "drfl":
            kw["energy_scale"] = 0.01
        tag = f"table1 {method}/{selector}"
        hist, _ = _drive(tag, FLConfig(**kw), "perclient", _no_layer_agg)
        widths = [sorted(set(m)) for m in hist["model_choices"]]
        print(f"[{tag}] best accuracy per exit "
              f"{[round(float(a), 4) for a in hist['best_acc']]}, round "
              f"wall {hist['wall_clock'][-1]:.3f} s, submodels per round "
              f"{widths}")
        if method != "drfl" and max(len(w) for w in widths) < 2:
            raise AssertionError(f"[{tag}] no round trained two widths")


def phase_baselines_bucketed():
    """HeteroFL and ScaleFL at 64 devices take the bucketed executor; the
    baselines aggregate with the sliced scatter, not ``layer_agg``."""
    from repro_torch.fl import FLConfig
    for method in ("heterofl", "scalefl"):
        _drive(f"baselines bucketed {method}",
               FLConfig(n_rounds=1, participation=0.5, method=method,
                        selector="greedy", **MAIN_CFG), "batched",
               _no_layer_agg)


def _client_steps(cfg, hist):
    """SGD steps the run's clients took: the lengths of their
    ``client_schedule``s (every participant survived and holds data), and
    the validation batches the run evaluated (before the first round and
    after each)."""
    from repro_torch.data.loader import client_schedule
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.fl.client import client_update_seed
    from repro_torch.models.family import get_family
    _, y = get_family(cfg.model_family).make_dataset(
        cfg.n_train, cfg.num_classes, hw=cfg.hw, noise=cfg.noise,
        seed=cfg.seed)
    n_val = max(64, int(cfg.n_val_fraction * cfg.n_train))
    parts = dirichlet_partition(y[n_val:], cfg.n_devices, cfg.alpha,
                                cfg.seed)
    steps = sum(len(client_schedule(parts[i],
                                    client_update_seed(cfg.seed, t, i),
                                    cfg.local_epochs, cfg.batch_size))
                for t, picks in enumerate(hist["participants"])
                for i in picks if len(parts[i]))
    evals = (len(hist["acc"]) + 1) * -(-n_val // 256)
    return steps, evals


def phase_transformer_perclient():
    """The transformer on the per-client executor: 40 devices, 50%, 2
    rounds, full width.  Every step runs the full depth forward and
    backward (the masked DR-FL loss), so each launch count is exact:
    12 ``rmsnorm`` and 4 ``flash_attention`` forwards and backwards a
    step, every backward fused, and the evaluation's forwards on top.
    Returns the launches."""
    from repro_torch.fl import FLConfig
    cfg = FLConfig(**dict(PAPER_CFG, n_rounds=2, participation=0.5,
                          model_family="transformer"))
    counted = {}

    def expect(hist):
        if hist["dropouts"]:
            raise AssertionError("a participant dropped out: the steps "
                                 "cannot be counted from the picks")
        steps, evals = counted["steps"], counted["evals"] = \
            _client_steps(cfg, hist)
        return {"layer_agg": 0, "rmsnorm": 12 * (steps + evals),
                "rmsnorm_vec": 12 * (steps + evals), "rmsnorm_general": 0,
                "rmsnorm_bwd": 12 * steps, "rmsnorm_bwd_vec": 12 * steps,
                "rmsnorm_bwd_general": 0,
                "flash_attention": 4 * (steps + evals),
                "flash_attention_bwd": 4 * steps,
                "flash_attention_bwd_fused": 4 * steps,
                "flash_attention_bwd_three_pass": 0}
    hist, launches = _drive("transformer perclient", cfg, "perclient",
                            expect)
    print(f"[transformer perclient] {counted['steps']} client SGD steps "
          f"and {counted['evals']} validation batches: launches exact, "
          f"submodels per round "
          f"{[sorted(set(m)) for m in hist['model_choices']]}")
    return launches


def phase_from_list():
    """One per-client DR-FL round's deltas at full width (four clients of
    the paper fleet, one per submodel, each its full local schedule),
    aggregated by ``aggregate_drfl`` (the list path, as the per-client
    engine) and by ``aggregate_drfl_from_list`` (P = 1 buckets into one
    ``layer_agg`` launch): the same new weights within 1e-5 of the largest
    magnitude; both device times."""
    import torch
    from repro_torch.data.loader import client_schedule
    from repro_torch.fl import FLConfig
    from repro_torch.fl import server as fl_server
    from repro_torch.fl.client import client_update_seed
    from repro_torch.fl.engine import _data_to_device, build_world
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.tree import tree_leaves
    cfg = FLConfig(n_rounds=1, **PAPER_CFG)
    w = build_world(cfg, device="cuda")
    x_dev = _data_to_device(w.x_tr, w.device)
    y_dev = torch.as_tensor(w.y_tr, dtype=torch.int64, device=w.device)
    clients = [i for i in range(cfg.n_devices) if len(w.parts[i])][:4]
    models = [0, 1, 2, 3]
    deltas, weights = [], []
    for i, m in zip(clients, models):
        steps = torch.as_tensor(client_schedule(
            w.parts[i], client_update_seed(cfg.seed, 0, i), cfg.local_epochs,
            cfg.batch_size), dtype=torch.int64, device=w.device)
        d, _ = w.family.train_steps("drfl", w.global_params, m,
                                    x_dev[steps], y_dev[steps], lr=cfg.lr)
        deltas.append(d)
        weights.append(float(len(w.parts[i])))
    args = (w.global_params, deltas, models, weights)
    kw = dict(server_lr=cfg.server_lr, family=w.family)
    ref, _ = fl_server.aggregate_drfl(*args, **kw)
    reset_launches()
    got, valid = fl_server.aggregate_drfl_from_list(*args, **kw)
    torch.cuda.synchronize()
    if LAUNCHES["layer_agg"] != 1:
        raise AssertionError(f"aggregate_drfl_from_list launched layer_agg "
                             f"{LAUNCHES['layer_agg']} times, not once")
    err = max((a - b).abs().max().item()
              for a, b in zip(tree_leaves(got), tree_leaves(ref)))
    scale = max(max(b.abs().max().item() for b in tree_leaves(ref)), 1.0)
    lst = _times(lambda: fl_server.aggregate_drfl(*args, **kw), iters=5)
    stk = _times(lambda: fl_server.aggregate_drfl_from_list(*args, **kw),
                 iters=5)
    print(f"[from list] clients {clients} submodels {models}: max_abs_err "
          f"{err:.3e}, max_rel_err {err / scale:.3e} (limit {REL_TOL:.0e});"
          f" valid {valid.tolist()}; device ms (call ms): aggregate_drfl "
          f"{lst[0]:.4f} ({lst[1]:.4f}), aggregate_drfl_from_list "
          f"{stk[0]:.4f} ({stk[1]:.4f})")
    if err / scale > REL_TOL or not bool(valid.all()):
        raise AssertionError("aggregate_drfl_from_list disagrees with "
                             "aggregate_drfl")


def _weights_diff(a, b):
    """(max |a - b| over the weights, allclose at rtol 1e-4, atol 1e-5)."""
    import torch
    from repro_torch.tree import tree_leaves
    pairs = list(zip(tree_leaves(a), tree_leaves(b)))
    return (max((x - y).abs().max().item() for x, y in pairs),
            all(torch.allclose(x, y, rtol=1e-4, atol=1e-5) for x, y in pairs))


def phase_executors():
    """The slice's path with the greedy selector, 2 rounds, on each
    executor: identical picks and models, and the reference's own
    tolerances for its two executors: mean accuracy atol 0.06
    (``tests/test_batch.py:246``) and, after multi-epoch runs, weights
    atol 6e-3 (``tests/test_batch.py:111``: the bucket program's
    convolutions sum in another order, and SGD amplifies that).  rtol
    1e-4, atol 1e-5 cannot hold on the card: cuDNN's float32 convolutions
    are not deterministic, and the per-client executor run twice ends
    further apart than that; its run-to-run distance is printed beside the
    executors' distance, with the largest per-exit accuracy difference.
    Then each executor's warm round wall and busy share (one profiled warm
    round)."""
    import numpy as np
    from repro_torch.fl import FLConfig, run_simulation
    expect = {"perclient": _no_layer_agg, "batched": _one_per_round}
    hists, cfgs = {}, {}
    for ex in expect:
        cfgs[ex] = FLConfig(n_rounds=2, selector="greedy",
                            client_executor=ex, **PAPER_CFG)
        hists[ex], _ = _drive(f"executors {ex}", cfgs[ex], ex, expect[ex])
    p, b = hists["perclient"], hists["batched"]
    again = run_simulation(cfgs["perclient"])
    diff, close = _weights_diff(p["params"], b["params"])
    rerun, _ = _weights_diff(p["params"], again["params"])
    n_val = max(64, int(cfgs["batched"].n_val_fraction
                        * cfgs["batched"].n_train))
    acc = float(np.max(np.abs(np.stack(p["acc"]) - np.stack(b["acc"]))))
    mean = float(np.max(np.abs(np.subtract(p["acc_mean"], b["acc_mean"]))))
    print(f"[executors] picks equal={p['participants'] == b['participants']}"
          f", models equal={p['model_choices'] == b['model_choices']}, max "
          f"mean accuracy diff {mean:.4f} (limit 0.06), max per-exit "
          f"accuracy diff {acc:.4f} ({acc * n_val:.0f} of {n_val} samples),"
          f" max weight diff {diff:.3e} (limit 6e-3; allclose at rtol 1e-4,"
          f" atol 1e-5: {close}); the per-client executor run again: max "
          f"weight diff {rerun:.3e}")
    if p["participants"] != b["participants"] or \
            p["model_choices"] != b["model_choices"] or mean > 0.06 or \
            diff > 6e-3:
        raise AssertionError("the two executors disagree on the card")
    for ex in expect:
        wall, busy = phase_profile(cfgs[ex], f"executors {ex} profile")
        print(f"[executors] {ex}: warm round wall "
              f"{hists[ex]['wall_clock'][-1]:.3f} s (profiled round "
              f"{wall:.3f} s, busy share "
              f"{'not measured' if busy is None else f'{busy:.3f}'})")


def _card_and_cpu(cfg, keep=None):
    """The same run on the card and on the CPU (plain versions); a MARL
    run acts greedily (ε = 0: the two devices' generators draw different
    numbers).  Returns (card hist, CPU hist); ``keep``, a dict, gets each
    device's (selector, buffer)."""
    from repro_torch.fl.engine import RoundEngine, uses_marl
    from repro_torch.fl.simulation import _make_buffer, _make_selector
    hists = {}
    for dev in ("cuda", "cpu"):
        sel, buf = _make_selector(cfg, 4, device=dev), None
        if uses_marl(cfg):
            sel.learner.cfg = dataclasses.replace(
                sel.learner.cfg, eps_start=0.0, eps_end=0.0)
            sel.reset_episode()
            buf = _make_buffer(cfg)
        hists[dev] = RoundEngine(cfg, sel, buf, device=dev).run()
        if keep is not None:
            keep[dev] = (sel, buf)
    return hists["cuda"], hists["cpu"]


def phase_reference(tag, cfg):
    """A small run on the card against the same run on the CPU.  Weights
    are held at rtol=1e-4, atol=1e-5, the tolerance of the parity tests
    after SGD steps and QMIX updates (float32 sums in another order on
    each device)."""
    import numpy as np
    import torch
    from repro_torch.tree import tree_leaves
    g, c = _card_and_cpu(cfg)
    n_val = max(64, int(cfg.n_val_fraction * cfg.n_train))
    acc_diff = float(np.max(np.abs(np.stack(g["acc"]) - np.stack(c["acc"]))))
    pairs = [(a.cpu(), b) for a, b in zip(tree_leaves(g["params"]),
                                          tree_leaves(c["params"]))]
    p_diff = max(float((a - b).abs().max()) for a, b in pairs)
    p_close = all(torch.allclose(a, b, rtol=1e-4, atol=1e-5)
                  for a, b in pairs)
    print(f"[{tag}] card vs CPU, {cfg.model_family} {cfg.method}/"
          f"{cfg.selector} {g['executor']} n={cfg.n_devices} width "
          f"{cfg.width_mult} hw {cfg.hw}, participation {cfg.participation},"
          f" {cfg.n_rounds} rounds: submodels per round "
          f"{[sorted(set(m)) for m in g['model_choices']]}, picks "
          f"equal={g['participants'] == c['participants']}, max per-exit "
          f"accuracy diff={acc_diff:.4f} (limit {1 / n_val:.4f}), max weight "
          f"diff={p_diff:.3e} (allclose at rtol 1e-4, atol 1e-5: {p_close})")
    if g["participants"] != c["participants"] or \
            g["model_choices"] != c["model_choices"]:
        raise AssertionError("card and CPU runs picked differently")
    if acc_diff > 1.0 / n_val + 1e-6 or not p_close:
        raise AssertionError("card and CPU runs disagree")


def _print_async(tag, hist):
    """Per virtual round: picks, the staleness of its completions and its
    sim time (``_drive`` printed its wall and host seconds by phase); then
    the episode's event totals."""
    i = 0
    for t, picks in enumerate(hist["participants"]):
        print(f"[{tag}] virtual round {t}: picks {picks} staleness "
              f"{hist['staleness'][i:i + len(picks)]} lost {hist['lost'][t]}"
              f" sim time {hist['sim_time'][t]:.1f} s wall "
              f"{hist['wall_clock'][t]:.3f} s")
        i += len(picks)
    print(f"[{tag}] tasks {hist['n_tasks']}, aggregations "
          f"{hist['n_aggregations']}, terminated {hist['terminated']}, "
          f"k_final {hist['k_final']}, sim time {hist['sim_time_total']:.1f}"
          f" s, idle {hist['idle_time']:.1f} s, wait for work "
          f"{hist['wait_for_work']:.1f} s, hot-plug {hist['hotplug']}")


def _async_agg_cost(cfg):
    """One async completion's DR-FL aggregation at full width: the whole
    model's rows of one client (the deepest submodel, stale by 2) stacked,
    one ``layer_agg`` launch, unstacked; device ms and call ms."""
    import torch
    from repro_torch.fl import server as fl_server
    from repro_torch.fl.engine import build_world
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.tree import tree_map
    w = build_world(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(4)
    delta = tree_map(
        lambda a: torch.randn(a.shape, generator=g, device="cuda")[None]
        * 1e-3, w.family.submodel_tree(w.global_params, 3))
    bucket = [(3, delta, [150.0], [2])]

    def agg():
        return fl_server.aggregate_drfl_stacked(
            w.global_params, bucket, server_lr=cfg.server_lr,
            staleness_decay=cfg.staleness_decay, family=w.family)
    reset_launches()
    agg()
    torch.cuda.synchronize()
    if LAUNCHES["layer_agg"] != 1:
        raise AssertionError("one async aggregation launched layer_agg "
                             f"{LAUNCHES['layer_agg']} times")
    dev, call = _times(agg, iters=10)
    print(f"[async] one completion's aggregation (aggregate_drfl_stacked, "
          f"N = 1, the full ResNet-18, staleness 2): device ms {dev:.4f}, "
          f"call ms {call:.4f}, one layer_agg launch")
    return dev, call


def phase_async():
    """The slice's path: Fig. 6's 64-device DR-FL + MARL row on the async
    engine, full width, bucketed executor: one ``layer_agg`` launch per
    completion (N = 1), through the alpha route when stale.  Returns
    (cfg, launches)."""
    from repro_torch.fl import FLConfig
    cfg = FLConfig(**ASYNC_CFG)
    hist, launches = _drive("async", cfg, "batched", _one_per_round)
    _print_async("async", hist)
    budget = 18
    if hist["n_tasks"] != budget and hist["terminated"]["reason"] not in (
            "fleet_dead", "starved"):
        raise AssertionError(f"[async] {hist['n_tasks']} tasks of {budget},"
                             f" terminated {hist['terminated']}")
    if max(hist["staleness"]) < 1:
        raise AssertionError("[async] no aggregation was stale")
    if hist.get("qmix", {}).get("updates", 0) < 1:
        raise AssertionError("[async] no QMIX update at the episode's end")
    _async_agg_cost(cfg)
    return cfg, launches


def phase_async_heterofl():
    """Fig. 6's other arm on the same config, greedy, 2 virtual rounds:
    the sliced aggregation, pre-scaled by the staleness, no ``layer_agg``."""
    from repro_torch.fl import FLConfig
    hist, _ = _drive("async heterofl", FLConfig(**dict(
        ASYNC_CFG, n_rounds=2, method="heterofl", selector="greedy")),
        "batched", _no_layer_agg)
    _print_async("async heterofl", hist)


def _async_block_steps(cfg, hist):
    """(bucket steps x blocks, validation batches) of an async bucketed
    transformer run: each dispatch tick trained its tasks with data as one
    program per submodel of next_pow2(longest schedule) steps, each
    running submodel m's m + 1 blocks (three ``rmsnorm``, one
    ``flash_attention``) forward and backward; the evaluations (the first,
    one per row and, for MARL, one per ``async_eval_every`` aggregations)
    each run ceil(n_val / 256) batches through the 4 blocks."""
    from repro_torch.data.loader import client_schedule
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.fl.batch import _next_pow2
    from repro_torch.fl.client import client_update_seed
    from repro_torch.fl.engine import uses_marl
    from repro_torch.models.family import get_family
    _, y = get_family(cfg.model_family).make_dataset(
        cfg.n_train, cfg.num_classes, hw=cfg.hw, noise=cfg.noise,
        seed=cfg.seed)
    n_val = max(64, int(cfg.n_val_fraction * cfg.n_train))
    parts = dirichlet_partition(y[n_val:], cfg.n_devices + cfg.hotplug_n,
                                cfg.alpha, cfg.seed)
    buckets = {}
    for t in hist["task_log"]:
        if len(parts[t["device"]]):
            buckets.setdefault((t["dispatch"], t["m"]), []).append(
                t["device"])
    block_steps = sum(
        _next_pow2(max(len(client_schedule(
            parts[i], client_update_seed(cfg.seed, cid, i),
            cfg.local_epochs, cfg.batch_size)) for i in devs)) * (m + 1)
        for (cid, m), devs in buckets.items())
    evals = 1 + len(hist["acc"]) + (
        hist["n_aggregations"] // cfg.async_eval_every if uses_marl(cfg)
        else 0)
    p1 = sum(len(d) == 1 for d in buckets.values())
    return block_steps, evals * -(-n_val // 256), p1, len(buckets)


def phase_async_transformer():
    """The transformer path on the async engine (``TRANSFORMER_CFG``, 2
    virtual rounds): after the first dispatch tick, each completion
    dispatches one task, a P = 1 bucket; every ``rmsnorm`` and
    ``flash_attention`` launch count is exact, forward, backward and
    route.  Returns the launches."""
    from repro_torch.fl import FLConfig
    cfg = FLConfig(**dict(TRANSFORMER_CFG, engine_mode="async", n_rounds=2))
    counted = {}

    def expect(hist):
        steps, evals, p1, n_buckets = _async_block_steps(cfg, hist)
        counted.update(steps=steps, evals=evals, p1=p1, buckets=n_buckets)
        return {"layer_agg": hist["n_aggregations"],
                "rmsnorm": 3 * steps + 12 * evals,
                "rmsnorm_vec": 3 * steps + 12 * evals, "rmsnorm_general": 0,
                "rmsnorm_bwd": 3 * steps, "rmsnorm_bwd_vec": 3 * steps,
                "rmsnorm_bwd_general": 0,
                "flash_attention": steps + 4 * evals,
                "flash_attention_bwd": steps,
                "flash_attention_bwd_fused": steps,
                "flash_attention_bwd_three_pass": 0}
    hist, launches = _drive("async transformer", cfg, "batched", expect)
    _print_async("async transformer", hist)
    print(f"[async transformer] {counted['buckets']} bucket programs "
          f"({counted['p1']} of one task), {counted['steps']} bucket steps "
          f"x blocks and {counted['evals']} validation batches: launches "
          "exact")
    return launches


def phase_async_faults():
    """Seeded faults on the async engine: DR-FL greedy, bucketed, 64
    devices at FLConfig's default width (0.25, 16x16), two of each fault
    kind; the time horizon is the same config's sync run on the card (as
    ``benchmarks/async_bench.py``).  Every poisoned delta is quarantined,
    every lost task reaped, the weights finite."""
    import torch
    from repro_torch.fl import FLConfig, run_simulation
    from repro_torch.tree import tree_leaves
    # 5 rounds: the script's time
    base = dict(n_devices=64, n_rounds=5, selector="greedy",
                client_executor="batched", seed=0)
    horizon = run_simulation(FLConfig(**base))["sim_time_total"]
    cfg = FLConfig(**base, engine_mode="async", async_time_horizon=horizon,
                   fault_crashes=2, fault_timeouts=2, fault_disconnects=2,
                   fault_corrupts=2)
    hist, _ = _drive("async faults", cfg, "batched", _one_per_round)
    _print_async("async faults", hist)
    faults = hist["faults"]
    for e in faults["events"]:
        print(f"[async faults] event {e}")
    poisoned = sorted((e["device"], e["poisoned_version"])
                      for e in faults["events"]
                      if e["outcome"] == "poisoned")
    quarantined = sorted((q["device"], q["version"])
                         for q in faults["quarantined"])
    lost = sum(1 for t in hist["task_log"] if t.get("lost"))
    print(f"[async faults] sync horizon {horizon:.1f} s; poisoned "
          f"{poisoned}, quarantined {quarantined}, reaped "
          f"{faults['n_reaped']} of {lost} lost tasks")
    if not set(poisoned) <= set(quarantined) or faults["n_reaped"] != lost:
        raise AssertionError("[async faults] a poisoned delta was not "
                             "quarantined or a lost task not reaped")
    if not all(torch.isfinite(t).all() for t in tree_leaves(hist["params"])):
        raise AssertionError("[async faults] non-finite weights")


def phase_async_reference():
    """Small async runs on the card against the CPU: bucketed DR-FL greedy
    at 64 devices with 8 joining after the first virtual round, and
    per-client DR-FL greedy at 16 devices.  The task log identical
    (device, dispatch, version, staleness, submodel); times and energy at
    rtol 1e-4; accuracy and weights at ``[executors]``'s tolerances (mean
    accuracy atol 0.06, weights atol 6e-3: cuDNN's float32 convolutions
    are not deterministic on the H100)."""
    import numpy as np
    from repro_torch.fl import FLConfig
    from repro_torch.tree import tree_leaves
    keys = ("device", "dispatch", "version", "staleness", "m")
    for tag, cfg in (
            ("async reference", FLConfig(
                n_devices=64, n_rounds=3, hw=8, n_train=1280,
                local_epochs=1, participation=0.1, width_mult=0.125,
                seed=1, selector="greedy", engine_mode="async",
                client_executor="batched", hotplug_n=8, hotplug_round=1)),
            ("async reference perclient", FLConfig(**dict(
                PERCLIENT_REFERENCE, n_devices=16, selector="greedy",
                engine_mode="async", client_executor="perclient")))):
        g, c = _card_and_cpu(cfg)
        same_log = [[t[k] for k in keys] for t in g["task_log"]] == \
            [[t[k] for k in keys] for t in c["task_log"]]
        w_diff = max(float((a.cpu() - b).abs().max()) for a, b in
                     zip(tree_leaves(g["params"]), tree_leaves(c["params"])))
        acc = float(np.max(np.abs(np.subtract(g["acc_mean"],
                                              c["acc_mean"]))))
        times_ok = all(np.allclose(g[k], c[k], rtol=1e-4, atol=1e-5)
                       for k in ("sim_time", "energy", "idle"))
        hp = [h["hotplug"] and {k: h["hotplug"][k] for k in (
            "vround", "version", "k_before", "k_after")} for h in (g, c)]
        print(f"[{tag}] card vs CPU, {g['executor']} n={cfg.n_devices} "
              f"hot-plug {hp[0]}: {len(g['task_log'])} tasks, task log "
              f"equal={same_log}, times and energy close={times_ok}, max "
              f"mean accuracy diff {acc:.4f} (limit 0.06), max weight diff "
              f"{w_diff:.3e} (limit 6e-3)")
        if not same_log or not times_ok or acc > 0.06 or w_diff > 6e-3:
            raise AssertionError(f"[{tag}] card and CPU runs disagree")
        if hp[0] != hp[1] or (cfg.hotplug_n and not (
                hp[0] and hp[0]["k_after"] > hp[0]["k_before"])):
            raise AssertionError(f"[{tag}] the hot-plug differs or did not "
                                 f"raise k: {hp}")


#: the energy scenarios on the main path: its config with batteries of
#: 18.9 J (``benchmarks/energy_bench.py``'s ``energy_scale``), so every
#: device affords submodel 0 (4.8 J at the median) and a battery binds
#: after three or four picks.  A day lasts as long as the trivial run's
#: three rounds of sim time (2.97 s in the port's CPU run at this fleet
#: and cost model), so the waves turn within the run
ENERGY_CFG = dict(MAIN_CFG, n_rounds=3, participation=0.1,
                  energy_scale=0.0025, charge_period=3.0)
#: a round of six submodel-0 picks costs about 29 J: 30 J funds one
#: round and part of the next
ENERGY_SCENARIOS = {
    "constant": {},
    "solar": dict(charge_profile="solar", charge_rate=2.0),
    "diurnal": dict(availability_profile="diurnal", availability_duty=0.5),
    "carbon_window": dict(charge_profile="carbon_window", charge_rate=2.0),
    "global_budget": dict(charge_profile="solar", charge_rate=2.0,
                          global_budget_j=30.0)}
#: benchmarks/energy_bench.py's grid (run_cell, SCENARIOS, DAY, K_TARGET,
#: BUDGET_PER_PICK) at n = 256: FLConfig's width and images.  Its n =
#: 4096 cells (factored state, set mixer) take phase_energy_grid(4096),
#: about 190 s on the card, which main() leaves out to keep the script
#: within half its time limit
GRID_N, GRID_ROUNDS, GRID_DAY = 256, 8, 3600.0
GRID_SCENARIOS = {
    "constant": {},
    "solar": dict(charge_profile="solar", charge_rate=2.0,
                  charge_period=GRID_DAY),
    "diurnal": dict(availability_profile="diurnal", availability_duty=0.5,
                    charge_period=GRID_DAY),
    "global_budget": dict(charge_profile="solar", charge_rate=2.0,
                          charge_period=GRID_DAY,
                          global_budget_j=18.0 * 8 * GRID_ROUNDS)}
GRID_SELECTORS = ("marl", "greedy", "random", "static")
#: the scenarios whose MARL cell the grid runs (the script's time): the
#: two its claims read
GRID_MARL_SCENARIOS = ("solar", "global_budget")


def _gate_check(tag, cfg, hist):
    """Under an availability gate: every round's participants were open at
    its start (the host twin over the fleet's phases, drawn as
    ``build_world`` draws them) and some device was offline.  Returns the
    offline count per round."""
    import numpy as np
    from repro_torch.core.fleet import make_fleet_state
    from repro_torch.energy import scenario_from_config
    sc = scenario_from_config(cfg)
    n = cfg.n_devices + cfg.hotplug_n
    tz = sc.init_fleet(make_fleet_state(n, cfg.seed, device="cpu"),
                       cfg.seed).tz_phase.numpy().astype(np.float64)
    starts = np.asarray(hist["sim_time"]) - np.asarray(hist["round_time"])
    gated = []
    for t, picks in zip(starts, hist["participants"]):
        ok = sc.available_host(tz, float(t))
        gated.append(int((~ok).sum()))
        if not all(ok[i] for i in picks):
            raise AssertionError(f"[{tag}] a device offline at sim time "
                                 f"{t:.3f} s was picked: {picks}")
    if hist["dropouts"] or not any(gated):
        raise AssertionError(f"[{tag}] the gate never kept an alive device "
                             f"out (offline per round {gated}, dropouts "
                             f"{hist['dropouts']})")
    return gated


def phase_energy():
    """The main path under each energy scenario, full width, bucketed,
    DR-FL + MARL: ``layer_agg`` once per aggregation.  Each scenario
    bites: solar ends with more fleet energy than constant; every pick of
    the diurnal and carbon-window runs was open at its round's start while
    some alive device was not; the budget ends the run within its limit.
    Returns {scenario: layer_agg launches}."""
    import numpy as np
    import torch
    from repro_torch.device import to_host
    from repro_torch.fl import FLConfig
    hists, launches = {}, {}
    for name, kw in ENERGY_SCENARIOS.items():
        tag = f"energy {name}"
        cfg = FLConfig(**ENERGY_CFG, **kw)
        t0 = time.perf_counter()
        hist, counts = _drive(tag, cfg, "batched", _one_per_round)
        hists[name], launches[name] = hist, counts["layer_agg"]
        walls = [w for w, p in zip(hist["wall_clock"], hist["participants"])
                 if p]
        print(f"[{tag}] rounds {len(hist['acc'])}, participants per round "
              f"{[len(p) for p in hist['participants']]}, energy "
              f"{np.round(hist['energy'], 2).tolist()} J, sim time "
              f"{np.round(hist['sim_time'], 3).tolist()} s, budget "
              f"{hist.get('budget')}, terminated {hist['terminated']}, "
              f"layer_agg {counts['layer_agg']} launches for "
              f"{hist['n_aggregations']} aggregations, warm round wall "
              f"{walls[-1]:.3f} s, charge phase s "
              f"{[round(p.get('charge', 0.0), 4) for p in hist['phase_s']]}"
              f", phase {time.perf_counter() - t0:.2f} s")
        if name in ("diurnal", "carbon_window"):
            print(f"[{tag}] offline devices at each round's start "
                  f"{_gate_check(tag, cfg, hist)}; every pick was open")
    if not hists["solar"]["energy"][-1] > hists["constant"]["energy"][-1]:
        raise AssertionError("[energy] solar harvesting left no more energy"
                             " than the static battery")
    gb = hists["global_budget"]
    b = gb["budget"]
    if gb["terminated"]["reason"] != "budget_exhausted" or \
            gb["terminated"].get("budget") != "energy" or \
            b["spent"] > b["limit"] + 1e-6:
        raise AssertionError(f"[energy] the budget did not end the run "
                             f"within its limit: {gb['terminated']}, {b}")
    # the budget's one extra pull a round: the picks' 64 costs
    need = torch.rand(64, device="cuda")
    to_host(need)
    t0 = time.perf_counter()
    for _ in range(100):
        to_host(need)
    print(f"[energy] the budget's extra pull (64 float32 costs to the host,"
          f" one sync): {(time.perf_counter() - t0) * 1e4:.2f} us a round")
    return launches


def phase_energy_async():
    """Fig. 6's 64-device row on the async engine (``ASYNC_CFG``) with
    18.9 J batteries, under a diurnal wave and then a global budget over a
    solar fleet: ``layer_agg`` once per completion."""
    from repro_torch.fl import FLConfig
    out = {}
    for name, kw in (("diurnal", ENERGY_SCENARIOS["diurnal"]),
                     ("global_budget", dict(ENERGY_SCENARIOS["solar"],
                                            global_budget_j=60.0))):
        tag = f"energy async {name}"
        cfg = FLConfig(**dict(ASYNC_CFG, energy_scale=0.0025,
                              charge_period=4.4, **kw))
        hist, counts = _drive(tag, cfg, "batched", _one_per_round)
        _print_async(tag, hist)
        print(f"[{tag}] tasks {hist['n_tasks']}, wake events "
              f"{len(hist.get('wakes', []))} at {hist.get('wakes')}, budget "
              f"{hist.get('budget')}, terminated {hist['terminated']}, "
              f"layer_agg {counts['layer_agg']} launches for "
              f"{hist['n_aggregations']} completions")
        if name == "global_budget" and (
                hist["terminated"]["reason"] != "budget_exhausted"
                or hist["budget"]["spent"] > 60.0 + 1e-6):
            raise AssertionError(f"[{tag}] {hist['terminated']}, "
                                 f"{hist['budget']}")
        out[name] = counts["layer_agg"]
    return out


#: the tests' size for [energy reference] (tests/test_torch_energy_live.py)
ENERGY_REFERENCE = dict(n_devices=8, n_rounds=3, participation=0.5,
                        local_epochs=1, batch_size=16, n_train=400, hw=8,
                        width_mult=0.125, seed=1, selector="greedy",
                        energy_scale=0.005, charge_period=30.0)
ENERGY_REFERENCE_SCENARIOS = {
    "solar": dict(charge_profile="solar", charge_rate=1.0),
    "diurnal": dict(availability_profile="diurnal", availability_duty=0.15,
                    seed=6),
    "carbon_window": dict(charge_profile="carbon_window", charge_rate=1.0,
                          seed=2),
    "global_budget": dict(charge_profile="solar", charge_rate=1.0,
                          global_budget_j=60.0)}


def phase_energy_reference():
    """Each scenario on both engines and both executors at the tests' size,
    on the card against the CPU: picks, model choices, task logs,
    termination and the budget's trims identical; energy, sim times and
    the budget's joules at rtol 1e-4; weights at ``[async reference]``'s
    atol 6e-3 (cuDNN's float32 convolutions are not deterministic)."""
    import numpy as np
    from repro_torch.fl import FLConfig
    from repro_torch.tree import tree_leaves
    keys = ("device", "dispatch", "version", "staleness", "m")
    for name, kw in ENERGY_REFERENCE_SCENARIOS.items():
        for mode in ("sync", "async"):
            for ex in ("perclient", "batched"):
                tag = f"energy reference {name} {mode} {ex}"
                cfg = FLConfig(**dict(ENERGY_REFERENCE, **kw,
                                      engine_mode=mode, client_executor=ex))
                g, c = _card_and_cpu(cfg)
                same = all(g[k] == c[k] for k in (
                    "participants", "model_choices", "dropouts", "alive"))
                same_log = [[t[k] for k in keys]
                            for t in g.get("task_log", [])] == \
                    [[t[k] for k in keys] for t in c.get("task_log", [])]
                term = g["terminated"]["reason"] == c["terminated"][
                    "reason"] and g["terminated"].get("budget") == \
                    c["terminated"].get("budget")
                close = all(np.allclose(g[k], c[k], rtol=1e-4, atol=1e-5)
                            for k in ("energy", "sim_time"))
                bud = ("budget" in g) == ("budget" in c) and (
                    "budget" not in c or (
                        g["budget"]["trimmed"] == c["budget"]["trimmed"]
                        and np.isclose(g["budget"]["spent"],
                                       c["budget"]["spent"], rtol=1e-4)))
                w_diff = max(float((a.cpu() - b).abs().max()) for a, b in
                             zip(tree_leaves(g["params"]),
                                 tree_leaves(c["params"])))
                print(f"[{tag}] card vs CPU: picks {g['participants']}, "
                      f"models equal={same}, task log equal={same_log} "
                      f"({len(g.get('task_log', []))} tasks), terminated "
                      f"{g['terminated']['reason']}/"
                      f"{g['terminated'].get('budget')} equal={term}, budget"
                      f" {g.get('budget')} equal={bud}, energy and sim time"
                      f" close={close}, wakes {len(g.get('wakes', []))}, max"
                      f" weight diff {w_diff:.3e} (limit 6e-3)")
                if not (same and same_log and term and close and bud) or \
                        w_diff > 6e-3:
                    raise AssertionError(f"[{tag}] card and CPU disagree")


def _bench_energy_rows(n):
    """``BENCH_energy.json``'s rows at n (the JAX package's run on a
    CPU), keyed by (scenario, selector); {} where the file has none."""
    path = SRC.parent / "BENCH_energy.json"
    rows = json.loads(path.read_text())["rows"] if path.exists() else []
    return {(r["scenario"], r["selector"]): r for r in rows if r["n"] == n}


def phase_energy_grid(n=GRID_N):
    """``benchmarks/energy_bench.py``'s cells at n on the card: 4
    scenarios x the 3 fixed selectors, and MARL under the scenarios of
    ``GRID_MARL_SCENARIOS``; 8 rounds, MARL pre-trained for 3 episodes
    (above 256 devices on the factored state and the set mixer); each
    row's fields as the bench prints them (no JSON is written).  The
    non-MARL cells are held to ``BENCH_energy.json``: survivors and
    termination equal, joules within 0.1 J (float32 fleet sums in another
    order: a few spacings of 2^-7 J at n 4096).  Returns the rows."""
    import numpy as np
    from repro_torch.fl import FLConfig, run_simulation
    rows = []
    bench = _bench_energy_rows(n)
    t_grid = time.perf_counter()
    for scenario, kw in GRID_SCENARIOS.items():
        for selector in GRID_SELECTORS:
            if selector == "marl" and scenario not in GRID_MARL_SCENARIOS:
                continue
            cfg = FLConfig(n_devices=n, n_rounds=GRID_ROUNDS,
                           participation=8 / n, n_train=3 * n,
                           local_epochs=1, method="drfl", selector=selector,
                           energy_scale=0.0025, seed=0,
                           marl_episodes=3 if selector == "marl" else 1,
                           **kw)
            t0 = time.perf_counter()
            h = run_simulation(cfg)
            wall = time.perf_counter() - t0
            joules = max(n * 7560.0 * 0.0025 - float(h["energy"][-1]), 0.0)
            acc = float(h["acc_mean"][-1])
            row = dict(scenario=scenario, selector=selector,
                       rounds_run=len(h["acc_mean"]), final_acc=acc,
                       surviving=int(h["alive"][-1]),
                       dropouts=int(h["dropouts"]), joules=joules,
                       joules_per_acc_point=joules / max(100.0 * acc, 1e-9),
                       terminated=h["terminated"]["reason"], wall_s=wall)
            if "budget" in h:
                row["budget_spent"] = h["budget"]["spent"]
            rows.append(row)
            ref = bench.get((scenario, selector))
            print(f"[energy grid] {scenario:14s} {selector:7s} n={n} "
                  f"acc={acc:.4f} alive={row['surviving']} dropouts="
                  f"{row['dropouts']} J={joules:.2f} J/acc-pt="
                  f"{row['joules_per_acc_point']:.3f} "
                  f"[{row['terminated']}] budget spent "
                  f"{row.get('budget_spent')} executor {h['executor']} "
                  f"wall {wall:.2f} s"
                  + ("" if ref is None else
                     f"; BENCH_energy.json J={ref['joules']:.2f} alive="
                     f"{ref['surviving']} [{ref['terminated']}]"))
            if not np.all(np.isfinite(h["energy"])):
                raise AssertionError("[energy grid] non-finite energy")
            if ref is not None and selector != "marl" and (
                    row["surviving"] != ref["surviving"]
                    or row["terminated"] != ref["terminated"]
                    or abs(joules - ref["joules"]) > 0.1):
                raise AssertionError(f"[energy grid] n={n} {scenario}/"
                                     f"{selector} differs from "
                                     "BENCH_energy.json")
    for scenario in ("solar", "global_budget"):
        m, r = (next(x["joules_per_acc_point"] for x in rows
                     if (x["scenario"], x["selector"]) == (scenario, s))
                for s in ("marl", "random"))
        print(f"[energy grid] claim marl_beats_random_jpap/{scenario}/"
              f"n{n}: {m < r} (marl {m:.3f}, random {r:.3f})")
    print(f"[energy grid] n={n}: {len(rows)} cells in "
          f"{time.perf_counter() - t_grid:.1f} s")
    return rows


#: Fig. 6's first row past the flat QMIX state (benchmarks/
#: fig6_scalability.py:56-104 on the paper-scale profile of
#: benchmarks/common.py:29-30): 1024 devices, k = 20, the async engine
#: with a budget of 2k tasks, at the full-width ResNet-18.  "auto" takes
#: the factored state and the set mixer; the episode has 2 x 40 + 120 + 8
#: = 208 steps over all 1024 agents (the budget is 4096)
FIG6_CFG = dict(n_devices=1024, n_train=60000, local_epochs=5,
                participation=0.02, energy_scale=0.6, n_rounds=120,
                engine_mode="async", async_eval_every=20,
                async_task_budget=40, client_executor="batched",
                marl_episodes=1, method="drfl", selector="marl",
                width_mult=1.0, hw=32, seed=0)


def _set_mixer_attention(updates, agents):
    """The set mixer's attention launches in ``updates`` QMIX updates: the
    mixer runs twice an update (online with its backward, target
    without), 4 seed queries over the stored agents, D 32, every launch on
    ``attention_route``'s route for that shape."""
    import importlib
    mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    fwd, bwd, _ = attention_routes(mod, 4, agents, 32, 1)
    want = {"flash_attention": 2 * updates, "flash_attention_bwd": updates}
    for r in ("split", "tiled"):
        want[f"flash_attention_fwd_{r}"] = 2 * updates if r == fwd else 0
    for r in ("short", "fused", "three_pass"):
        want[f"flash_attention_bwd_{r}"] = updates if r == bwd else 0
    return want


def _set_mixer_launches(hist):
    """A set-mixer run's launches: :func:`_set_mixer_attention` over its
    QMIX updates and stored agents; each async completion aggregates
    through ``layer_agg``."""
    return dict(_set_mixer_attention(hist["qmix"]["updates"],
                                     hist["qmix"]["replay_agents"]),
                layer_agg=hist["n_aggregations"], rmsnorm=0)


def _update_wall(n_agents, T, stored):
    """(device ms, wall ms) of one set-mode QMIX update on a fresh learner
    from a replay batch of the given shape (B 1: one episode)."""
    import numpy as np
    from repro_torch.core.marl.qmix import QmixConfig, QmixLearner
    rng = np.random.default_rng(0)
    batch = {"obs": rng.random((1, T + 1, stored, 5), np.float32),
             "state": rng.random((1, T + 1, 25), np.float32),
             "actions": rng.integers(0, 5, (1, T, stored)),
             "rewards": rng.normal(size=(1, T)).astype(np.float32),
             "mask": np.ones((1, T), np.float32),
             "agent_logw": np.zeros((1, stored), np.float32)}
    learner = QmixLearner(QmixConfig(
        n_agents=n_agents, obs_dim=5, num_actions=5, state_dim=25,
        mixer_mode="set"), 0)
    return _times(lambda: learner.update(batch), iters=5, warmup=2)


def phase_fig6():
    """``[fig6 n1024]``: the slice's path, through ``run_simulation`` on
    the card.  ``flash_attention`` launches exactly twice per QMIX update
    and its backward once, all on the short-query route (the one
    ``attention_route`` gives 1024 agents), ``layer_agg`` once per
    completion;
    the QMIX update count is the reference's formula at the episode's end
    (``engine.py:1540-1541``).  Returns the launches."""
    from repro_torch.fl import FLConfig
    cfg = FLConfig(**FIG6_CFG)
    hist, launches = _drive("fig6 n1024", cfg, "batched",
                            _set_mixer_launches)
    if launches["flash_attention_fwd_split"] != launches["flash_attention"]:
        raise AssertionError("[fig6 n1024] the set mixer's attention left "
                             f"the short route: {launches}")
    _print_async("fig6 n1024", hist)
    q = hist["qmix"]
    vrounds = hist["terminated"]["vrounds"]
    want = cfg.marl_updates_per_round * max(1, vrounds
                                            // cfg.marl_train_every)
    print(f"[fig6 n1024] qmix: mixer {q['mixer_mode']}, replay agents "
          f"{q['replay_agents']} of {cfg.n_devices}, episode length "
          f"{q['replay_episode_len']}, capacity {q['replay_capacity']}, "
          f"updates {q['updates']} (the reference's formula at {vrounds} "
          f"virtual rounds: {want}), td_loss {q['td_loss']}")
    if (q["mixer_mode"], q["replay_agents"], q["replay_episode_len"]) != \
            ("set", 1024, 208) or q["updates"] != want or want < 1:
        raise AssertionError(f"[fig6 n1024] qmix record {q}")
    if hist["n_tasks"] != 40:
        raise AssertionError(f"[fig6 n1024] {hist['n_tasks']} tasks of 40")
    dev, wall = _update_wall(cfg.n_devices, q["replay_episode_len"],
                             q["replay_agents"])
    print(f"[fig6 n1024] one set-mode QMIX update (B 1, T 208, 1024 "
          f"agents, a fresh learner): wall ms {wall:.2f}, device ms "
          f"{dev:.2f}")
    return launches


#: benchmarks/marl_train_bench.py's _bench_one: factored state, replay
#: of capacity 8 filled by 3 episodes of 4 selects (so B = 3), batch 16
MARL_TRAIN_ROWS = ((256, "flat"), (256, "set"), (4096, "flat"),
                   (4096, "set"), (65536, "set"), (1_048_576, "set"))


#: ``[marl train]``'s updates a row: warm-up ones, then timed ones
MARL_TRAIN_WARM, MARL_TRAIN_ITERS = 13, 10


def _marl_train_rig(n, mixer_mode, seed=0, agent_budget=4096):
    """One row of the bench on the card, set up: the replay filled by real
    ``select`` episodes over a sampled fleet.  Returns the row's state for
    :func:`_marl_train_update`."""
    from repro_torch.core.fleet import sample_fleet_state
    from repro_torch.core.marl.buffer import ReplayBuffer
    from repro_torch.core.selection import OBS_DIM, MarlSelector
    from repro_torch.kernels import LAUNCHES
    sizes = (2.8e6, 8.4e6, 22.5e6, 44.8e6)
    fracs = (0.11, 0.3, 0.72, 1.0)
    k, T = max(1, n // 100), 4
    sel = MarlSelector(n, len(sizes), T, seed=seed, state_mode="factored",
                       mixer_mode=mixer_mode, agent_budget=agent_budget)
    buf = ReplayBuffer(8, T, n, OBS_DIM, sel.learner.cfg.state_dim, seed,
                       agent_budget=agent_budget if mixer_mode == "set"
                       else None)
    t0 = time.perf_counter()
    for ep in range(3):
        fleet = sample_fleet_state(n, seed=seed + ep)
        sel.reset_episode()
        for t in range(T):
            sel.select(fleet, t, k, sizes, fracs)
            sel.observe_reward(0.1 * (ep + t))
        buf.add_episode(*sel.episode_arrays(fleet, T))
    return dict(n=n, mode=mixer_mode, sel=sel, buf=buf,
                fill_s=time.perf_counter() - t0, losses=[], times=[],
                counted=dict.fromkeys(LAUNCHES, 0))


def _marl_train_update(rig):
    """One QMIX update of a row, on the wall clock (it ends in its pull);
    its loss and its kernel launches go to the row's record.  Returns its
    seconds."""
    from repro_torch.kernels import LAUNCHES
    sel, buf = rig["sel"], rig["buf"]
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    loss = sel.learner.update(buf.sample(sel.learner.cfg.batch_size))[
        "td_loss"]
    secs = time.perf_counter() - t0
    rig["losses"].append(loss)
    for key, v in LAUNCHES.items():
        rig["counted"][key] += v - before[key]
    return secs


def _marl_train_row(rig):
    """A row's record from its updates, its launches checked against the
    set mixer's attention (none for the flat mixer)."""
    import statistics
    n, mixer_mode, buf, losses = (rig["n"], rig["mode"], rig["buf"],
                                  rig["losses"])
    want = (_set_mixer_attention(len(losses), buf.N) if mixer_mode == "set"
            else {"flash_attention": 0, "flash_attention_bwd": 0})
    wrong = {key: (rig["counted"][key], v) for key, v in want.items()
             if rig["counted"][key] != v}
    launches = {key: rig["counted"][key] for key in want}
    if wrong:
        raise AssertionError(f"[marl train] n={n} {mixer_mode} launches "
                             f"(counted, expected): {wrong}")
    times = rig["times"]
    row = dict(n=n, mode=mixer_mode, agents_stored=buf.N,
               batch=min(rig["sel"].learner.cfg.batch_size, len(buf)),
               train_step_s=statistics.median(times),
               train_step_min_s=min(times), replay_fill_s=rig["fill_s"],
               replay_mb=buf.nbytes / 1e6, loss_first=losses[0],
               loss_last=losses[-1], loss_decreased=losses[-1] < losses[0],
               state_dim=rig["sel"].learner.cfg.state_dim, launches=launches)
    print(f"[marl train] {mixer_mode:4s} n={n:7d} stored agents "
          f"{row['agents_stored']} B {row['batch']}: train step median "
          f"{row['train_step_s'] * 1e3:.2f} ms (min "
          f"{row['train_step_min_s'] * 1e3:.2f}), replay fill "
          f"{rig['fill_s']:.2f} s, replay {row['replay_mb']:.2f} MB, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (decreased "
          f"{row['loss_decreased']})")
    return row


def phase_marl_train():
    """``[marl train]``: the port's twin of ``benchmarks/
    marl_train_bench.py`` on the card (the flat mixer up to 4096, the set
    mixer to 1M devices, storing 4096 agents: attention at BH 12, Sk
    4096).  Each row fills its replay and takes ``MARL_TRAIN_WARM``
    warm-up updates; then the rows take their ``MARL_TRAIN_ITERS`` timed
    updates in turn, one update of each row a round, so that a spell of
    load on the shared host falls on every row alike (a step is ~25 ms of
    host work, and rows timed one after another moved by 40-60% against
    each other).  The bench's own acceptance: the set rows' step time is
    flat in n, here each row's fastest timed step from 4096 up within 1.5x
    of the 4096 row's.  Loss behaviour is compared with
    ``BENCH_marl_train.json`` (a JAX run on a CPU) in PERF.md, not the
    times.  Returns the rows."""
    import gc
    rigs = []
    for n, mode in MARL_TRAIN_ROWS:
        rigs.append(_marl_train_rig(n, mode))
        for _ in range(MARL_TRAIN_WARM):
            _marl_train_update(rigs[-1])
    gc.collect()
    for _ in range(MARL_TRAIN_ITERS):
        for rig in rigs:
            rig["times"].append(_marl_train_update(rig))
    rows = [_marl_train_row(rig) for rig in rigs]
    base = next(r["train_step_min_s"] for r in rows
                if (r["n"], r["mode"]) == (4096, "set"))
    ratios = {r["n"]: r["train_step_min_s"] / base for r in rows
              if r["mode"] == "set" and r["n"] >= 4096}
    print("[marl train] set rows' fastest step over the n = 4096 row's: "
          + ", ".join(f"n={n}: {x:.3f}" for n, x in ratios.items()))
    if max(ratios.values()) > 1.5:
        raise AssertionError("[marl train] the set mixer's step time grows "
                             f"with n: {ratios}")
    return rows


def phase_fleet_scale_reference():
    """``[fleet scale reference]``: MARL at fleet scale on the card
    against the CPU, greedy (ε = 0), at the live tests' size (300
    devices, width 0.125, 8x8 images, the trace sampled to 64 agents),
    sync and async on the bucketed executor: picks, model choices, task
    logs, the sampled agents and every stored factored state and
    observation identical; weights at ``[executors]``'s atol 6e-3.  Seed
    3: the fresh greedy policy trains submodels 0 and 1 on both engines
    (at seed 1 its async run picks nobody)."""
    import numpy as np
    from repro_torch.fl import FLConfig
    from repro_torch.tree import tree_leaves
    keys = ("device", "dispatch", "version", "staleness", "m")
    base = dict(n_devices=300, n_rounds=3, participation=0.02,
                local_epochs=1, batch_size=16, n_train=1500, hw=8,
                width_mult=0.125, seed=3, marl_agent_budget=64,
                client_executor="batched")
    for mode in ("sync", "async"):
        cfg = FLConfig(**dict(base, engine_mode=mode,
                              async_task_budget=12))
        keep = {}
        g, c = _card_and_cpu(cfg, keep)
        (gs, gb), (cs, cb) = keep["cuda"], keep["cpu"]
        same = (g["participants"] == c["participants"]
                and g["model_choices"] == c["model_choices"]
                and [[t[k] for k in keys] for t in g.get("task_log", [])]
                == [[t[k] for k in keys] for t in c.get("task_log", [])])
        same_idx = np.array_equal(gs._ep_idx, cs._ep_idx)
        same_state = np.array_equal(gb.state, cb.state)
        same_obs = np.array_equal(gb.obs, cb.obs)
        w_diff = max(float((a.cpu() - b).abs().max()) for a, b in
                     zip(tree_leaves(g["params"]), tree_leaves(c["params"])))
        print(f"[fleet scale reference] {mode}: {gs.state_mode} state, "
              f"{gs.mixer_mode} mixer, {gb.N} of {cfg.n_devices} agents "
              f"stored, {g['n_aggregations']} aggregations, qmix updates "
              f"{g['qmix']['updates']}: picks, models and task log equal="
              f"{same}, sampled agents equal={same_idx}, factored states "
              f"equal={same_state}, observations equal={same_obs}, max "
              f"weight diff {w_diff:.3e} (limit 6e-3)")
        if not (same and same_idx and same_state and same_obs) or \
                w_diff > 6e-3 or gs._ep_idx is None or \
                g["n_aggregations"] < 1:
            raise AssertionError(f"[fleet scale reference] {mode}: card "
                                 "and CPU disagree")


#: host clocks: the records a resumed run may change
RESUME_EXEMPT = ("wall_clock", "phase_s", "params")


def _canon(x):
    """A history record as comparable bytes (tensors and arrays by dtype
    and bytes)."""
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    if isinstance(x, np.ndarray):
        return ("arr", str(x.dtype), x.tobytes())
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    return x


def _hist_diff(a, b):
    """(history keys that differ, host clocks apart; max |a - b| over the
    final weights)."""
    from repro_torch.tree import tree_leaves
    keys = [k for k in a if k not in RESUME_EXEMPT
            and _canon(a.get(k)) != _canon(b.get(k))]
    keys += [k for k in b if k not in a]
    w = max(float((x.cpu() - y.cpu()).abs().max()) for x, y in
            zip(tree_leaves(a["params"]), tree_leaves(b["params"])))
    return keys, w


def _same_picks(a, b):
    keys = ("device", "dispatch", "version", "staleness", "m")
    return (a["participants"] == b["participants"]
            and a["model_choices"] == b["model_choices"]
            and [[t[k] for k in keys] for t in a.get("task_log", [])]
            == [[t[k] for k in keys] for t in b.get("task_log", [])])


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN's deterministic algorithms for this block, then the settings
    as they were (its default float32 convolutions are not deterministic
    on the H100; the package never sets these)."""
    import torch
    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = was


@contextlib.contextmanager
def _timed_saves(seconds):
    """Each ``EngineCheckpointer.save`` of this block timed into
    ``seconds`` (host clock: the save pulls every tensor, so it ends on
    the host)."""
    from repro_torch.checkpoint import EngineCheckpointer
    save = EngineCheckpointer.save

    def timed(self, state, meta):
        t0 = time.perf_counter()
        out = save(self, state, meta)
        seconds.append(time.perf_counter() - t0)
        return out
    EngineCheckpointer.save = timed
    try:
        yield
    finally:
        EngineCheckpointer.save = save


def _kill_and_resume(tag, cfg, ckpt_dir, resumed_expect,
                     executor="batched", device="cuda",
                     resume_device="cuda"):
    """The checkpoint phases' pattern on ``cfg``: a run on ``device`` with
    ``checkpoint_every=1`` killed after its first save (it must raise
    ``CheckpointHalt``), the checkpoint loaded and timed, then the resumed
    run on ``resume_device``, through :func:`_drive` on the card, where
    ``resumed_expect(hist, saved_state)`` gives its exact launch counts.
    Returns (resumed hist, saved state, {save s, load s, bytes, step})."""
    import os
    from repro_torch.checkpoint import CheckpointHalt, EngineCheckpointer
    from repro_torch.fl import run_simulation
    ck = dataclasses.replace(cfg, checkpoint_dir=ckpt_dir,
                             checkpoint_every=1)
    saves = []
    try:
        with _timed_saves(saves):
            run_simulation(ck, device=device, halt_after_saves=1)
    except CheckpointHalt:
        pass
    else:
        raise AssertionError(f"[{tag}] the checkpointed run was not halted")
    t0 = time.perf_counter()
    saved, meta = EngineCheckpointer(ckpt_dir).load()
    load_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(ckpt_dir, n))
               for n in os.listdir(ckpt_dir))
    resumed = dataclasses.replace(ck, resume=True)
    if resume_device == "cuda":
        res, _ = _drive(f"{tag} resumed", resumed, executor,
                        lambda h: resumed_expect(h, saved))
    else:
        res = run_simulation(resumed, device="cpu")
    return res, saved, {"save_s": saves[0], "load_s": load_s,
                        "bytes": size, "step": meta["step"]}


def _hold_resumed(tag, cfg, ref, res):
    """The resumed run against the uninterrupted one: bit for bit, host
    clocks apart; where they differ, a second uninterrupted run measures
    the card's run-to-run difference, which the resumed run must keep
    within, with identical picks and task log."""
    from repro_torch.fl import run_simulation
    keys, w = _hist_diff(ref, res)
    if not keys and w == 0.0:
        print(f"[{tag}] resumed == uninterrupted bit for bit (history, "
              "task log, QMIX record and final weights)")
        return
    again = run_simulation(cfg)
    keys2, w2 = _hist_diff(ref, again)
    print(f"[{tag}] resumed differs from uninterrupted in {keys}, max "
          f"weight diff {w:.3e}; two uninterrupted runs differ in {keys2},"
          f" max weight diff {w2:.3e}; picks and task log equal="
          f"{_same_picks(ref, res)}")
    if not _same_picks(ref, res) or w > w2:
        raise AssertionError(f"[{tag}] the resumed run is off the "
                             "uninterrupted one past their run-to-run "
                             "difference")


def phase_checkpoint():
    """``[checkpoint]``: the main path killed after its first round's
    checkpoint and resumed: bit for bit as the uninterrupted run (or
    within the measured run-to-run difference), ``layer_agg`` exactly
    once per resumed round; the checkpoint's bytes, save and load
    seconds at full width."""
    import tempfile
    from repro_torch.fl import FLConfig
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    cfg = FLConfig(n_rounds=3, participation=0.1, **MAIN_CFG)
    with _cudnn_deterministic(), tempfile.TemporaryDirectory() as d:
        ref, _ = _drive("checkpoint uninterrupted", cfg, "batched",
                        _one_per_round)
        res, saved, cost = _kill_and_resume(
            "checkpoint", cfg, d,
            lambda h, st: {"layer_agg": h["n_aggregations"] - st["n_agg"]})
        _hold_resumed("checkpoint", cfg, ref, res)
    resumed = res["n_aggregations"] - saved["n_agg"]
    n_weights = sum(t.numel() for t in tree_leaves(res["params"]))
    print(f"[checkpoint] main path, full width ({n_weights} float32 "
          f"weights): checkpoint after round {cost['step']} of "
          f"{cfg.n_rounds}, {cost['bytes']} bytes on disk (zlib), save "
          f"{cost['save_s']:.3f} s, load {cost['load_s']:.3f} s; the "
          f"resumed run launched layer_agg {resumed} times "
          f"({cfg.n_rounds - cost['step']} rounds); phase "
          f"{time.perf_counter() - t0:.1f} s")
    if resumed != 2:
        raise AssertionError(f"[checkpoint] {resumed} aggregations after "
                             "the resume, not 2")
    return cost


def phase_checkpoint_async():
    """``[checkpoint async]``: Fig. 6's 64-device row (``[async]``) killed
    after its first virtual round's checkpoint and resumed: task log,
    history and weights as the uninterrupted run's; ``layer_agg`` once per
    completion after the save; the QMIX update at the episode's end from
    the restored replay and learner."""
    import tempfile
    from repro_torch.fl import FLConfig
    t0 = time.perf_counter()
    cfg = FLConfig(**ASYNC_CFG)
    with _cudnn_deterministic(), tempfile.TemporaryDirectory() as d:
        ref, _ = _drive("checkpoint async uninterrupted", cfg, "batched",
                        _one_per_round)
        res, saved, cost = _kill_and_resume(
            "checkpoint async", cfg, d,
            lambda h, st: {"layer_agg": h["n_aggregations"]
                           - st["state"]["version"]})
        _hold_resumed("checkpoint async", cfg, ref, res)
    st = saved["state"]
    print(f"[checkpoint async] checkpoint at virtual round {cost['step']}:"
          f" {st['version']} aggregations, {st['inflight']} tasks in "
          f"flight, {len(saved['heap'])} heap events, replay episodes "
          f"{saved['buffer']['size']}; {cost['bytes']} bytes, save "
          f"{cost['save_s']:.3f} s, load {cost['load_s']:.3f} s; resumed: "
          f"{res['n_aggregations'] - st['version']} completions aggregated,"
          f" qmix updates {res['qmix']['updates']} (uninterrupted "
          f"{ref['qmix']['updates']}), td_loss {res['qmix']['td_loss']}; "
          f"phase {time.perf_counter() - t0:.1f} s")
    if st["inflight"] < 1 or res["qmix"]["updates"] < 1 or \
            saved["buffer"]["size"] != 0:
        raise AssertionError("[checkpoint async] the save must fall inside "
                             "the episode, before its QMIX update")


def phase_checkpoint_reference():
    """``[checkpoint reference]``: checkpoints cross devices.  Greedy and
    random DR-FL on both engines at the per-client reference size: killed
    on the card and resumed on the CPU, and killed on the CPU and resumed
    on the card, each held to the uninterrupted CPU run with picks, models
    and task log identical, at the card-against-CPU tolerances of its
    engine: sync, ``[reference]``'s (accuracy within one validation
    sample, weights allclose at rtol 1e-4, atol 1e-5); async, ``[async
    reference]``'s (mean accuracy atol 0.06, weights atol 6e-3: its tasks
    aggregate one client at a time, and cuDNN's float32 convolutions,
    not deterministic on the card, drift further over them; sim times
    and energy at rtol 1e-4).  Then the set-mixer async arm of ``[fleet scale
    reference]`` on the card, killed inside its episode and resumed:
    its QMIX update after the resume launches ``flash_attention`` twice
    (online, target) and its backward once per update, on the route
    ``attention_route`` gives its 64 stored agents."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.fl import FLConfig, run_simulation
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    for mode in ("sync", "async"):
        for selector in ("greedy", "random"):
            cfg = FLConfig(**dict(PERCLIENT_REFERENCE, engine_mode=mode,
                                  selector=selector))
            cpu = run_simulation(cfg, device="cpu")
            n_val = max(64, int(cfg.n_val_fraction * cfg.n_train))
            for kill, resume in (("cuda", "cpu"), ("cpu", "cuda")):
                with tempfile.TemporaryDirectory() as d:
                    res, _, cost = _kill_and_resume(
                        f"checkpoint reference {mode} {selector} {kill}",
                        cfg, d, lambda h, st: {"layer_agg": 0},
                        executor="perclient", device=kill,
                        resume_device=resume)
                pairs = [(a.cpu(), b) for a, b in zip(
                    tree_leaves(res["params"]), tree_leaves(cpu["params"]))]
                w = max(float((a - b).abs().max()) for a, b in pairs)
                if mode == "sync":
                    acc = float(np.max(np.abs(np.stack(res["acc"])
                                              - np.stack(cpu["acc"]))))
                    acc_lim = 1.0 / n_val + 1e-6
                    close = all(torch.allclose(a, b, rtol=1e-4, atol=1e-5)
                                for a, b in pairs)
                else:
                    acc = float(np.max(np.abs(np.subtract(
                        res["acc_mean"], cpu["acc_mean"]))))
                    acc_lim = 0.06
                    close = w <= 6e-3 and all(
                        np.allclose(res[k], cpu[k], rtol=1e-4, atol=1e-5)
                        for k in ("sim_time", "energy", "idle"))
                same = _same_picks(res, cpu)
                print(f"[checkpoint reference] {mode} {selector}: killed on"
                      f" {kill} after round {cost['step']}, resumed on "
                      f"{resume}, against the uninterrupted CPU run: picks,"
                      f" models and task log equal={same}, max accuracy "
                      f"diff {acc:.4f} (limit {acc_lim:.4f}), max weight "
                      f"diff {w:.3e} (within {mode}'s card-against-CPU "
                      f"tolerance: {close})")
                if not same or acc > acc_lim or not close:
                    raise AssertionError("[checkpoint reference] a "
                                         "checkpoint did not cross devices")
    cfg = FLConfig(n_devices=300, n_rounds=3, participation=0.02,
                   local_epochs=1, batch_size=16, n_train=1500, hw=8,
                   width_mult=0.125, seed=3, marl_agent_budget=64,
                   client_executor="batched", engine_mode="async",
                   async_task_budget=12)

    def after_resume(h, st):
        return dict(_set_mixer_launches(h),
                    layer_agg=h["n_aggregations"] - st["state"]["version"])
    with _cudnn_deterministic(), tempfile.TemporaryDirectory() as d:
        ref, _ = _drive("checkpoint reference set mixer uninterrupted", cfg,
                        "batched",
                        _set_mixer_launches)
        res, saved, cost = _kill_and_resume(
            "checkpoint reference set mixer", cfg, d, after_resume)
        _hold_resumed("checkpoint reference set mixer", cfg, ref, res)
    u = res["qmix"]["updates"]
    want = after_resume(res, saved)
    route = next((r for r in ("short", "fused", "three_pass")
                  if want[f"flash_attention_bwd_{r}"]), "no")
    print(f"[checkpoint reference] set mixer async n=300: killed at "
          f"virtual round {cost['step']} ({saved['state']['version']} "
          f"aggregations, replay episodes {saved['buffer']['size']}), "
          f"resumed on the card: {u} QMIX updates, flash_attention "
          f"{want['flash_attention']} forward and "
          f"{want['flash_attention_bwd']} {route} backward launches, "
          f"counted; phase {time.perf_counter() - t0:.1f} s")
    if u < 1 or res["qmix"]["mixer_mode"] != "set":
        raise AssertionError("[checkpoint reference] no set-mixer QMIX "
                             "update after the resume")


#: the reference's messages for the configs its SimulationSpec rejects
#: (src/repro/fl/spec.py:203-223, :184-189, :99-100) and the port used to
#: run or refuse with another message
SPEC_REJECTS = (
    (dict(participation=0.0), "participation must be in (0, 1]"),
    (dict(task_deadline_factor=1.0),
     "resilience.task_deadline_factor must be > 1 (a deadline at or before "
     "the task's own completion would reap live work)"),
    (dict(alpha=0.0), "alpha must be > 0"),
    (dict(fault_crashes=1, fault_horizon=100.0),
     "fault injection rides the async event timeline: fault_* counts need "
     "engine.mode='async'"),
    (dict(model_family="resnet9000"),
     "model.family='resnet9000' is not one of cnn, mlp, transformer"))
#: the small runs held on the card against the CPU (``[... reference]``)
REFERENCE_CFG = dict(n_devices=64, n_rounds=3, hw=8, n_train=1280,
                     local_epochs=1)
#: the mlp family at the width its cost model is calibrated at (d 256,
#: 32x32 inputs): 64 devices at 50%, the sync engine, "auto" (bucketed)
MLP_CFG = dict(n_devices=64, n_rounds=3, participation=0.5, n_train=6400,
               seed=0)


def phase_spec():
    """Run before the script touches the card: each config the reference's
    ``SimulationSpec`` rejects raises its ``ValueError``, message for
    message, from ``run_simulation`` on the default device, and CUDA is
    still not initialised after all of them; the main path's and
    ``[mlp]``'s configs round-trip through the typed spec exactly."""
    import torch
    from repro_torch.fl import FLConfig, SimulationSpec, run_simulation
    base = dict(n_rounds=3, participation=0.1, **MAIN_CFG)
    for change, want in SPEC_REJECTS:
        try:
            run_simulation(FLConfig(**dict(base, **change)))
        except ValueError as e:
            got = str(e)
        else:
            raise AssertionError(f"[spec] {change} ran")
        print(f"[spec] {change}: ValueError {got!r}")
        if got != want:
            raise AssertionError(f"[spec] {change}: not the reference's "
                                 f"message {want!r}")
    print(f"[spec] CUDA initialised after the rejected configs: "
          f"{torch.cuda.is_initialized()}")
    if torch.cuda.is_initialized():
        raise AssertionError("[spec] a rejected config reached the card")
    main = FLConfig(**base)
    spec = _mlp_spec()
    trips = (SimulationSpec.from_flat(main).to_flat() == main,
             SimulationSpec.from_flat(spec.to_flat()) == spec)
    print(f"[spec] from_flat(main path).to_flat() == main path: {trips[0]}; "
          f"[mlp]'s spec round-trips: {trips[1]}")
    if not all(trips):
        raise AssertionError("[spec] the round trip is not exact")


def _mlp_spec():
    from repro_torch.fl import ModelSpec, SimulationSpec
    return SimulationSpec(**MLP_CFG, model=ModelSpec(family="mlp",
                                                     width_mult=1.0, hw=32))


def phase_mlp():
    """The ``mlp`` family at full width through ``run_simulation`` of a
    typed ``SimulationSpec``: DR-FL + MARL, sync, bucketed, its stacked
    rows through ``layer_agg`` once a round.  Returns (flat config,
    launches, the last round's layer_agg N and R)."""
    from repro_torch.fl.batch import _next_pow2
    from repro_torch.models.family import get_family
    spec = _mlp_spec()
    hist, launches = _drive("mlp", spec, "batched", _one_per_round)
    cfg = spec.to_flat()
    per_round = [sorted(set(m)) for m in hist["model_choices"]]
    counts = [sum(_next_pow2(r.count(m)) for m in set(r))
              for r in hist["model_choices"]]
    fam = get_family("mlp")
    R = fam.stack_template(fam.param_shapes(10, 1.0, 32)).n_rows
    print(f"[mlp] warm round wall {hist['wall_clock'][-1]:.3f} s; buckets "
          f"(submodels) per round {per_round}; layer_agg N per round "
          f"{counts}, R {R}; layer_agg launches {launches['layer_agg']} in "
          f"{len(hist['acc'])} rounds")
    if hist["qmix"]["updates"] < 1:
        raise AssertionError("[mlp] no QMIX update ran")
    return cfg, launches, counts[-1], R


def phase_mlp_kernel(N, R, launches):
    """``layer_agg`` at the ``mlp`` bucketed path's shape (N rows of the
    last round's buckets, R from ``stack_template``) against its plain
    version; its record, with the ``[mlp]`` run's launches."""
    import torch
    from repro_torch.kernels.layer_agg import layer_agg, layer_agg_plain
    U, M, w = _agg_inputs(N, R, 1024, seed=N + R)
    got = layer_agg(U, M, w)
    torch.cuda.synchronize()
    ref = layer_agg_plain(U, M, w)
    err = (got - ref).abs().max().item()
    scale = max(ref.abs().max().item(), 1.0)
    print(f"[kernel] layer_agg mlp path N={N} R={R} D=1024: max_abs_err="
          f"{err:.3e} (limit {REL_TOL * scale:.3e})")
    if err > REL_TOL * scale:
        raise AssertionError("layer_agg disagrees with its plain version at "
                             "the mlp path's shape")
    record = _layer_agg_record(U, M, w, err, scale)
    record["path"] = "mlp"
    record["launches"] = launches
    return record


def phase_mlp_async():
    """README.md's Public API example at full width: the ``mlp`` family,
    greedy, the async engine, 64 devices at 20%, 3 virtual rounds; one
    ``layer_agg`` launch per completion."""
    from repro_torch.fl import EngineSpec, MarlSpec, ModelSpec, SimulationSpec
    spec = SimulationSpec(
        n_devices=64, n_rounds=3, participation=0.2, method="drfl",
        model=ModelSpec(family="mlp", width_mult=1.0, hw=32),
        marl=MarlSpec(selector="greedy"),
        engine=EngineSpec(mode="async"))
    hist, launches = _drive("mlp async", spec, "batched", _one_per_round)
    _print_async("mlp async", hist)
    if hist["n_tasks"] != 3 * 13:
        raise AssertionError(f"[mlp async] {hist['n_tasks']} tasks of 39")
    return launches


def phase_env():
    """``FLEnv`` on the card against the CPU: both reward clocks, 1024
    devices, 50 steps of seeded numpy actions; dropouts, alive counts and
    ``done`` equal, rewards and energies at rtol 1e-9; steps per second
    on each device."""
    import numpy as np
    import torch
    from repro_torch.fl import FLEnv, FLEnvConfig
    for mode in ("sync", "async"):
        cfg = FLEnvConfig.for_family("cnn", n_devices=1024, n_rounds=50,
                                     seed=0, mode=mode)
        runs = {}
        for dev in ("cuda", "cpu"):
            env = FLEnv(cfg, device=dev)
            rng = np.random.default_rng(0)
            out = []
            t0 = time.perf_counter()
            for _ in range(cfg.n_rounds):
                _, r, done, info = env.step(
                    rng.integers(0, cfg.n_models + 1, cfg.n_devices))
                out.append((r, done, info))
                if done:
                    break
            runs[dev] = (out, len(out) / (time.perf_counter() - t0))
        (g, g_rate), (c, c_rate) = runs["cuda"], runs["cpu"]
        same = [(a[1], a[2]["alive"], a[2]["dropouts"]) for a in g] == \
            [(b[1], b[2]["alive"], b[2]["dropouts"]) for b in c]
        rel = max(max(abs(a[0] - b[0]) / max(abs(b[0]), 1e-300),
                      abs(a[2]["energy"] - b[2]["energy"]) / b[2]["energy"])
                  for a, b in zip(g, c))
        print(f"[env] {mode}, 1024 devices, {len(g)} steps: dropouts "
              f"{sum(a[2]['dropouts'] for a in g)}, alive at the end "
              f"{g[-1][2]['alive']}, done {g[-1][1]}; dropouts, alive and "
              f"done equal: {same}; max relative reward/energy diff "
              f"{rel:.3e} (limit 1e-9); steps per second: card "
              f"{g_rate:.1f}, CPU {c_rate:.1f}")
        if not same or rel > 1e-9:
            raise AssertionError(f"[env] {mode}: card and CPU disagree")
    torch.cuda.synchronize()


def phase_public_api():
    """``[mlp]`` with ``layer_agg``'s record at its shape, ``[mlp
    profile]``, ``[mlp async]``, ``[mlp reference]`` and ``[env]``;
    returns the record."""
    from repro_torch.fl import FLConfig
    t0 = time.perf_counter()
    cfg, launches, N, R = phase_mlp()
    record = phase_mlp_kernel(N, R, launches["layer_agg"])
    phase_profile(cfg, "mlp profile")
    record["async_launches"] = phase_mlp_async()["layer_agg"]
    # seed 10: the greedy fresh policy trains the deepest submodel every
    # round and two buckets in round 1 (seed 1 picks nobody in round 0)
    phase_reference("mlp reference", FLConfig(
        participation=0.5, width_mult=0.125, model_family="mlp", seed=10,
        **REFERENCE_CFG))
    phase_env()
    print(f"[mlp] the public API phases took {time.perf_counter() - t0:.1f}"
          " s")
    return record


def _example(name):
    """One of ``examples/`` as a module (the examples are scripts, not a
    package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, SRC.parent / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the LM examples at full width: d 128, 4 heads, 4 blocks, windows of 32
LM_ARGS = ["--local", "--rounds", "2", "--width", "1.0", "--seq", "32"]
LM_KERNELS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
              "flash_attention_bwd")


def phase_lm_examples():
    """``[lm examples]``: ``train_lm_torch --local`` on the card and on
    the CPU from one init (per-round losses at rtol 1e-4, exit accuracies
    within one validation sample, weights at ``[reference]``'s rtol 1e-4,
    atol 1e-5), then ``serve_lm_torch`` decoding the card's ``--ckpt`` on
    the card and on the CPU (the same tokens).  The kernels' launches are
    reset before each card run and read after it; each must have run."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.tree import tree_leaves
    train, serve = _example("train_lm_torch"), _example("serve_lm_torch")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ck = f"{tmp}/lm.msgpack"
        reset_launches()
        t1 = time.perf_counter()
        gp, rounds = train.main(LM_ARGS + ["--device", "cuda", "--ckpt", ck])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        train_launches = {k: LAUNCHES[k] for k in LM_KERNELS}
        cpu_gp, cpu_rounds = train.main(LM_ARGS + ["--device", "cpu"])
        n_val = max(64, 1200 // 10)
        loss_ok = all(np.allclose(g["losses"], c["losses"], rtol=1e-4)
                      for g, c in zip(rounds, cpu_rounds))
        acc = max(float(np.max(np.abs(g["accs"] - c["accs"])))
                  for g, c in zip(rounds, cpu_rounds))
        pairs = [(a.cpu(), b) for a, b in zip(tree_leaves(gp),
                                              tree_leaves(cpu_gp))]
        w_diff = max(float((a - b).abs().max()) for a, b in pairs)
        w_ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-5)
                   for a, b in pairs)
        serve_args = ["--ckpt", ck, "--seq", "32", "--width", "1.0",
                      "--gen", "16", "--exit", "0"]
        reset_launches()
        card = serve.main(serve_args + ["--device", "cuda"])
        decode_launches = {k: LAUNCHES[k] for k in LM_KERNELS}
        cpu = serve.main(serve_args + ["--device", "cpu"])
    print(f"[lm examples] train_lm_torch --local, 2 rounds at d 128, seq "
          f"32: card {train_s:.2f} s; losses per round "
          f"{[np.round(r['losses'], 4).tolist() for r in rounds]}, equal to"
          f" the CPU's at rtol 1e-4: {loss_ok}; max exit accuracy diff "
          f"{acc:.4f} (limit {1 / n_val:.4f}); max weight diff {w_diff:.3e}"
          f" (allclose at rtol 1e-4, atol 1e-5: {w_ok}); launches "
          f"{train_launches}")
    for m in sorted(card):
        print(f"[lm examples] serve_lm_torch exit {m}: card tokens "
              f"{card[m][0]}, {card[m][1]:.2f} ms/token (CPU "
              f"{cpu[m][1]:.2f}); equal to the CPU's: "
              f"{card[m][0] == cpu[m][0]}")
    print(f"[lm examples] decode launches {decode_launches}; the phase "
          f"took {time.perf_counter() - t0:.1f} s")
    if not loss_ok or acc > 1.0 / n_val + 1e-6 or not w_ok:
        raise AssertionError("[lm examples] card and CPU training disagree")
    if any(card[m][0] != cpu[m][0] for m in card) or sorted(card) != [0, 3]:
        raise AssertionError("[lm examples] card and CPU decode differently")
    idle = [k for k in LM_KERNELS if not train_launches[k]] + [
        k for k in ("rmsnorm", "flash_attention") if not decode_launches[k]]
    if idle:
        raise AssertionError(f"[lm examples] kernels never launched: {idle}")


#: the committed async JAX checkpoint (DR-FL greedy, bucketed, the mlp
#: family at n 8) and the record of its uninterrupted JAX run beside it
#: (scripts/make_jax_async_checkpoint.py)
JAX_ASYNC_CKPT = SRC.parent / "tests" / "data" / "jax_async_ckpt"


def phase_checkpoint_from_jax_async():
    """``[checkpoint from jax async]``: the committed async JAX checkpoint
    (killed after its first virtual round's save, two bucketed ``delta1``
    rows in flight in the JAX layout) resumed by ``run_simulation(resume=
    True)`` through ``resume_state_from_jax``, on the card and on the CPU.
    Both resumed runs must equal the record of the uninterrupted JAX run
    (picks, model choices, staleness and task log, times at rtol 1e-4;
    accuracies within one validation sample); the card and the CPU runs
    agree at ``[async reference]``'s tolerances (mean accuracy 0.06,
    weights atol 6e-3); ``layer_agg`` launches once per aggregation after
    the resume."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.checkpoint import EngineCheckpointer
    from repro_torch.fl import FLConfig, run_simulation
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.tree import tree_leaves
    record = json.loads((JAX_ASYNC_CKPT / "record.json").read_text())
    t0 = time.perf_counter()
    hists = {}
    with tempfile.TemporaryDirectory() as tmp:
        saved, _ = EngineCheckpointer(str(JAX_ASYNC_CKPT)).load()
        for dev in ("cuda", "cpu"):
            shutil.copytree(JAX_ASYNC_CKPT, f"{tmp}/{dev}")
            cfg = FLConfig(**record["config"], checkpoint_dir=f"{tmp}/{dev}",
                           resume=True)
            reset_launches()
            hists[dev] = run_simulation(cfg, device=dev)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = LAUNCHES["layer_agg"]
    g, c = hists["cuda"], hists["cpu"]
    after = len(g["staleness"]) - len(saved["hist"]["staleness"])
    in_flight = sum(1 for t in saved["tasks"].values()
                    if t.get("delta1") is not None)
    n_val = max(64, int(0.04 * record["config"]["n_train"]))

    def matches(h):
        if any(h[k] != record[k] for k in (
                "participants", "model_choices", "staleness", "n_tasks")):
            return False
        if np.max(np.abs(np.subtract(h["acc_mean"], record["acc_mean"]))
                  ) > 1.0 / n_val + 1e-6:
            return False
        for got, ref in zip(h["task_log"] + [h["terminated"]],
                            record["task_log"] + [record["terminated"]]):
            for k, v in ref.items():
                if (not np.isclose(got[k], v, rtol=1e-4, atol=0)
                        if isinstance(v, float) else got[k] != v):
                    return False
        return len(h["task_log"]) == len(record["task_log"])
    w_diff = max(float((a.cpu() - b).abs().max()) for a, b in
                 zip(tree_leaves(g["params"]), tree_leaves(c["params"])))
    acc = float(np.max(np.abs(np.subtract(g["acc_mean"], c["acc_mean"]))))
    cf = record["config"]
    print(f"[checkpoint from jax async] the JAX package's checkpoint "
          f"({cf['model_family']}, {cf['client_executor']}, greedy, n="
          f"{cf['n_devices']}; virtual round {saved['state']['vround']}, "
          f"{in_flight} delta rows in flight) resumed on the card: "
          f"{len(g['task_log'])} tasks, equal to the JAX record: card "
          f"{matches(g)}, CPU {matches(c)}; layer_agg {launches} launches "
          f"for {after} aggregations after the resume; card vs CPU max mean"
          f" accuracy diff {acc:.4f} (limit 0.06), max weight diff "
          f"{w_diff:.3e} (limit 6e-3); {time.perf_counter() - t0:.1f} s")
    if not (matches(g) and matches(c)):
        raise AssertionError("[checkpoint from jax async] the resumed runs "
                             "differ from the JAX record")
    if launches != after or after < 1 or not in_flight:
        raise AssertionError(f"[checkpoint from jax async] layer_agg "
                             f"{launches} launches for {after} aggregations")
    if acc > 0.06 or w_diff > 6e-3:
        raise AssertionError("[checkpoint from jax async] card and CPU "
                             "resumes disagree")


def phase_fleet_mesh():
    """``[fleet mesh]``: one card is one rank.  Inside a one-rank NCCL
    group, ``dual_selection_energy_step`` at n 1024 on a fleet and hidden
    state placed on the ``("fleet",)`` mesh (``DTensor``s, ``Shard(0)``:
    the summary's ``all_reduce`` and the top-k's ``all_gather`` go through
    NCCL) against the plain step on the card: picks and actions equal,
    the rest at the reference's step tolerances (rtol 1e-5, atol 1e-6);
    ``maybe_shard_fleet`` with ``fleet_mesh=-1`` and ``2`` returns the
    fleet itself, and the engine takes either (it never shards: its
    ``fleet_mesh`` is a no-op on one rank and refused above one)."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.core.fleet import make_fleet_state
    from repro_torch.core.selection import (MarlSelector,
                                            dual_selection_energy_step)
    from repro_torch.device import to_host
    from repro_torch.fl import FLConfig
    from repro_torch.fl.engine import check_supported
    from repro_torch.sharding.fleet import (fleet_mesh, maybe_shard_fleet,
                                            shard_agent_array, shard_fleet)
    t0 = time.perf_counter()
    n, k = 1024, 64
    sizes, fracs = (2.8e6, 8.4e6, 22.5e6, 44.8e6), (0.11, 0.3, 0.72, 1.0)
    sel = MarlSelector(n, len(sizes), n_rounds=5, seed=0,
                       state_mode="factored", mixer_mode="set",
                       device="cuda")
    fleet = make_fleet_state(n, seed=2, device="cuda")
    rng = np.random.default_rng(0)
    hidden = torch.tensor(rng.normal(size=tuple(sel.hidden.shape)),
                          dtype=torch.float32, device="cuda")
    kw = dict(round_idx=2, n_rounds=5, budget_left=2000.0)
    plain = dual_selection_energy_step(sel.learner.params["agent"], hidden,
                                       fleet, sizes, fracs, k, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            for n_shards in (-1, 2):
                check_supported(FLConfig(fleet_mesh=n_shards))
                if maybe_shard_fleet(fleet, n_shards) is not fleet:
                    raise AssertionError(f"[fleet mesh] fleet_mesh="
                                         f"{n_shards} sharded on one rank")
            mesh = fleet_mesh()
            with implicit_replication():
                meshed = dual_selection_energy_step(
                    sel.learner.params["agent"],
                    shard_agent_array(hidden, mesh), shard_fleet(fleet, mesh),
                    sizes, fracs, k, **kw)
                f1, h1, p1, a1, s1 = to_host(
                    plain[0].remaining, *plain[1:])
                f2, h2, p2, a2, s2 = to_host(
                    meshed[0].remaining, *meshed[1:])
        finally:
            dist.destroy_process_group()
    diffs = {name: float(np.max(np.abs(x.astype(np.float64) - y)))
             for name, x, y in (("remaining", f2, f1), ("hidden", h2, h1),
                                ("summary", s2, s1))}
    same = (np.array_equal(p2, p1) and np.array_equal(a2, a1)
            and np.allclose(f2, f1, rtol=1e-6, atol=0)
            and all(np.allclose(x, y, rtol=1e-5, atol=1e-6)
                    for x, y in ((h2, h1), (s2, s1))))
    print(f"[fleet mesh] one-rank NCCL group, dual_selection_energy_step n="
          f"{n} k={k} on the one-rank mesh vs plain on the card: "
          f"{int(p1.sum())} picks, picks and actions equal "
          f"{np.array_equal(p2, p1) and np.array_equal(a2, a1)}, max diffs "
          + ", ".join(f"{k_} {v:.3e}" for k_, v in diffs.items())
          + f"; fleet_mesh=-1/2 leave the fleet unsharded; "
          f"{time.perf_counter() - t0:.1f} s")
    if not same:
        raise AssertionError("[fleet mesh] the meshed step differs")
    print("[fleet mesh] the sharded step over several cards (torchrun "
          "--nproc-per-node k, NCCL) is not run on this one-card machine; "
          "tests/test_torch_shard.py runs it on 4 gloo ranks on the CPU")


#: ``[lm substrate]``: the dense decoder at full width in bf16.
#: phi3-mini-3.8b: 32 layers, d 3072, 32 heads of 96, d_ff 8192, vocab
#: 32064; minitron-8b: d 4096, 32 query heads over 8 KV heads of 128,
#: d_ff 16384, vocab 256000
LM_ARCH = "phi3-mini-3.8b"
#: the reference serve main's defaults: slots, requests, prompt, max-new
LM_SERVE = (4, 8, 12, 8)
#: ``[lm prefill]``: (label, arch, B, S, window); the window row stands
#: in for adapt_for_shape's long-context SWA (window 8192 at 512k tokens)
LM_PREFILL = (("phi3-mini", "phi3-mini-3.8b", 4, 2048, 0),
              ("minitron-8b", "minitron-8b", 4, 2048, 0),
              ("phi3-mini SWA 1024", "phi3-mini-3.8b", 2, 4096, 1024))
#: ``[lm train]``: B, S, steps
LM_TRAIN = (2, 1024, 2)
#: ``[lm fl train]`` and ``[lm fl bucketed]``: B (one sequence a client,
#: one client an exit), S, steps
LM_FL = (4, 1024, 2)
#: ``[lm mesh]``: layers (exits 1 to layers), the train steps' B, the FL
#: steps' B (one client an exit), S, steps of each
LM_MESH = (4, 2, 4, 1024, 2)
#: ``[lm mesh]``'s sharding policies for phi3-mini's train and FL steps:
#: ``default`` (the families take no FL step), and those that
#: ``LM_MESH_FAMILY_POLICIES`` do not run (zero1 without FSDP, as the
#: reference pairs them).  repeat_kv with attn_heads, a no-op at
#: phi3-mini's 32:32 heads on one rank, runs in the families' train steps
LM_MESH_POLICIES = (("default", {}),
                    ("attn_seq", {"attn_seq": True}),
                    ("act_seq", {"act_seq": True}),
                    ("block_gather", {"block_gather": True}),
                    ("fsdp=False", {"fsdp": False}),
                    ("zero1", {"fsdp": False, "zero1": True}))
#: ``[lm mesh]``'s other families at full width, their depth cut: (label,
#: arch, the cut, B, S).  xLSTM: one mLSTM and one sLSTM block; zamba2:
#: 6 Mamba2 blocks and one shared-attention site; whisper: 2 encoder and
#: 2 decoder layers over 1500 frames; the VLM: one group of 4 self layers
#: and a cross layer over 1601 image tokens
LM_MESH_FAMILIES = (("xlstm", "xlstm-1.3b", {"num_layers": 2}, 2, 128),
                    ("zamba2", "zamba2-1.2b", {"num_layers": 6}, 2, 1024),
                    ("whisper", "whisper-medium",
                     {"encoder_layers": 2, "num_layers": 2}, 4, 448),
                    ("vlm", "llama-3.2-vision-11b", {"num_layers": 5}, 2,
                     1024))
#: the policies the families run under (the one-device steps are taken
#: again under repeat_kv where it changes them: the VLM's GQA)
LM_MESH_FAMILY_POLICIES = (("default", {}), ("dp2d", {"dp2d": True}),
                           ("repeat_kv+attn_heads",
                            {"repeat_kv": True, "attn_heads": True}))
#: ``[lm mesh serve]``: the models at full width, their depth cut as
#: ``[lm mesh]``'s (mixtral at 2 layers, so that the MoE decode region
#: runs), and the prefill's S: (label, arch, the cut, S)
LM_MESH_SERVE = (("phi3-mini", "phi3-mini-3.8b", {"num_layers": 4}, 1024),
                 ("xlstm", "xlstm-1.3b", {"num_layers": 2}, 128),
                 ("zamba2", "zamba2-1.2b", {"num_layers": 6}, 1024),
                 ("whisper", "whisper-medium",
                  {"encoder_layers": 2, "num_layers": 2}, 448),
                 ("vlm", "llama-3.2-vision-11b", {"num_layers": 5}, 1024),
                 ("mixtral", "mixtral-8x22b", {"num_layers": 2}, 1024))
#: every wrapper's own count of its launches (``LAUNCHES``' other keys
#: split these by route or by entry)
KERNEL_TOTALS = ("layer_agg", "rmsnorm", "rmsnorm_bwd", "flash_attention",
                 "flash_attention_bwd")
#: ``[lm mesh serve]``: the prefill's B, the decode steps, the slots and
#: the cache length
LM_MESH_SERVE_SHAPE = (2, 8, 4, 56)
#: ``[lm mesh bytes]``: every LM config but the dense family's smallest
LM_MESH_ARCHS = ("phi3-mini-3.8b", "minitron-8b", "yi-34b", "command-r-35b",
                 "mixtral-8x22b", "qwen3-moe-235b-a22b", "xlstm-1.3b",
                 "zamba2-1.2b", "whisper-medium", "llama-3.2-vision-11b")
#: the attention kernel at the LM paths' shapes: (label, B, S, Hq, Hkv,
#: D, window); all bf16 and causal
LM_ATTENTION = (("phi3-mini prefill", 4, 2048, 32, 32, 96, 0),
                ("minitron-8b prefill", 4, 2048, 32, 8, 128, 0),
                ("phi3-mini train", 2, 1024, 32, 32, 96, 0),
                # one rank's local heads under a 4-way model axis: the
                # train step's, and the meshed prefill's
                ("phi3-mini train local heads", 2, 1024, 8, 8, 96, 0),
                ("phi3-mini prefill local heads", 4, 2048, 8, 8, 96, 0),
                ("phi3-mini fl train", 4, 1024, 32, 32, 96, 0),
                ("phi3-mini fl bucketed", 1, 1024, 32, 32, 96, 0),
                ("phi3-mini SWA 1024", 2, 4096, 32, 32, 96, 1024),
                ("zamba2 prefill", 4, 2048, 32, 32, 64, 0),
                ("zamba2 train", 2, 1024, 32, 32, 64, 0),
                # the shared block's and the VLM's self layers' local
                # heads under a 4-way model axis
                ("zamba2 train local heads", 2, 1024, 8, 8, 64, 0),
                ("vlm train local heads", 2, 1024, 8, 2, 128, 0),
                ("whisper decoder", 4, 448, 16, 16, 64, 0),
                ("vlm train", 2, 1024, 32, 8, 128, 0),
                ("mixtral prefill", 4, 2048, 48, 8, 128, 4096),
                ("qwen3-moe prefill", 4, 2048, 64, 4, 128, 0),
                ("mixtral train", 2, 1024, 48, 8, 128, 4096),
                ("qwen3-moe train", 2, 1024, 64, 4, 128, 0))
LM_ROUTES = tuple(f"flash_attention_fwd_{r}" for r in FWD_ROUTES) + tuple(
    f"flash_attention_bwd_{r}" for r in BWD_ROUTES)
#: the sub-quadratic families at full width and depth in bf16:
#: xlstm-1.3b (48 blocks, 24 mLSTM and 24 sLSTM, d 2048, 4 heads, the
#: mLSTM's P 1024) and zamba2-1.2b (38 Mamba2 blocks, d 2048, P 64, H 64,
#: N 64; one shared attention block of 32 heads of 64 at 6 sites)
LM_SUBQ = {"xlstm": "xlstm-1.3b", "zamba2": "zamba2-1.2b"}
#: ``[lm <family> prefill]``: B, S (xLSTM's shorter: its sLSTM time loop
#: is eager launches at every position), blocks (None: full depth).
#: xLSTM runs 16 of its 48 blocks (8 mLSTM + 8 sLSTM), to pay for the MoE
#: phases (its full-depth forwards: PERF.md, §5)
LM_SUBQ_PREFILL = {"xlstm": (4, 1024, 16), "zamba2": (4, 2048, None)}
#: ``[lm <family> train]``: B, S, steps, blocks (None: full depth).
#: xLSTM trains 8 of its 48 blocks (4 mLSTM + 4 sLSTM), to pay for the
#: cross-attention phases (its full-depth steps: PERF.md, §5)
LM_SUBQ_TRAIN = {"xlstm": (2, 256, 2, 8), "zamba2": (2, 1024, 2, None)}
#: the cross-attention families at full width in bf16: whisper-medium (24
#: encoder and 24 decoder layers, d 1024, 16 heads of 64, 1500 stub audio
#: frames, biases) and llama-3.2-vision-11b (40 layers = 8 groups of 4
#: self layers and a gated cross layer, d 4096, 32:8 heads of 128, 1601
#: stub image tokens)
LM_CROSS = {"whisper": "whisper-medium", "vlm": "llama-3.2-vision-11b"}
#: ``[lm <family> prefill]``: B, S (whisper: its n_text_ctx, 448)
LM_CROSS_PREFILL = {"whisper": (4, 448), "vlm": (4, 2048)}
#: ``[lm <family> train]``: B, S, steps, layers (None: full depth).  The
#: VLM trains 10 of its 40 layers (2 groups): at full depth its bf16
#: params and grads and float32 moments, about 117 GB, pass the card
LM_CROSS_TRAIN = {"whisper": (4, 448, 2, None), "vlm": (2, 1024, 2, 10)}
#: the MoE family at full width in bf16: mixtral-8x22b (56 layers, d
#: 6144, 48:8 heads of 128, window 4096, 8 experts top-2 of d_ff 16384)
#: and qwen3-moe-235b-a22b (94 layers, d 4096, 64:4 heads of 128 with
#: ``qk_norm``, 128 experts top-8 of d_ff 1536, vocab 151936); about 2.5
#: B params a layer each
LM_MOE = {"mixtral": "mixtral-8x22b", "qwen3-moe": "qwen3-moe-235b-a22b"}
#: ``[lm <family> serve]`` and ``[lm <family> prefill]``: the depth.  The
#: prefill holds the bf16 params beside their float32 copy: 4 layers of
#: mixtral are 10.4 B params (62.5 GB in both), 3 of qwen3-moe 8.7 B
LM_MOE_DEPTH = {"mixtral": 4, "qwen3-moe": 3}
#: ``[lm <family> prefill]``: B, S
LM_MOE_PREFILL = (4, 2048)
#: ``[lm <family> train]``: B, S, steps, layers (bf16 params and grads and
#: float32 AdamW moments, 12 bytes a param: mixtral's 2 layers, 5.4 B
#: params, about 65 GB; qwen3-moe's 1, 3.7 B with its vocabulary, 45 GB)
LM_MOE_TRAIN = {"mixtral": (2, 1024, 2, 2), "qwen3-moe": (2, 1024, 2, 1)}


def _synced_wall(fn):
    """(fn's result, its seconds of wall) with the card idle on both
    sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _stub_extras(cfg, B, S, seed):
    """The family's stub-frontend inputs (``image_embeds``,
    ``audio_frames``) on the card, N(0, 1) in ``cfg.dtype`` from ``seed``;
    empty for the other families."""
    import torch
    from repro_torch.models.api import extra_inputs
    g = torch.Generator("cuda").manual_seed(seed)
    return {k: torch.randn(shape, generator=g, device="cuda").to(dt)
            for k, (shape, dt) in extra_inputs(cfg, B, S).items()}


def _shape_note(cfg):
    """A config's depth, widths and stub inputs, as a phase line names
    them."""
    if cfg.family == "ssm":
        return f"{cfg.num_layers} blocks, d {cfg.d_model}, {cfg.num_heads} heads"
    if cfg.family == "mamba-hybrid":
        return (f"{cfg.num_layers} Mamba2 blocks, d {cfg.d_model}, a shared "
                f"block of {cfg.num_heads} heads of {cfg.hd}")
    heads = (f"d {cfg.d_model}, {cfg.num_heads}:{cfg.num_kv_heads} heads of "
             f"{cfg.hd}" + (" with qk_norm" if cfg.qk_norm else ""))
    if cfg.family == "audio":
        return (f"{cfg.encoder_layers} encoder and {cfg.num_layers} decoder "
                f"layers, {heads}, {cfg.num_audio_frames} stub frames")
    if cfg.family == "vlm":
        k = cfg.cross_attn_every
        return (f"{cfg.num_layers} layers in {cfg.num_layers // k} groups of "
                f"{k - 1} self and 1 cross, {heads}, {cfg.num_image_tokens} "
                "stub image tokens")
    if cfg.family == "moe":
        return (f"{cfg.num_layers} layers, {heads}, {cfg.num_experts} "
                f"experts top-{cfg.experts_per_token} of d_ff {cfg.d_ff}")
    return f"{cfg.num_layers} layers, {heads}"


def phase_lm_serve(arch=LM_ARCH, tag="lm serve", layers=None):
    """``[lm serve]``: the reference serve main's run (4 slots, 8 requests
    of 12 prompt tokens, 8 new each, a cache of 56) through ``SlotServer``
    on phi3-mini at full width and depth, bf16, random weights from seed
    0; then 8 more decode steps of the warm server timed alone.  Decode
    attention is plain torch, as in the reference: no kernel launches.
    ``[lm xlstm serve]`` and ``[lm zamba2 serve]`` run the same on the
    sub-quadratic families (xLSTM has no attention; zamba2's decode
    attention at its 6 sites is plain torch): a refilled slot carries on
    from its previous occupant's state, as in the reference.  ``[lm
    whisper serve]`` and ``[lm vlm serve]`` on the cross-attention
    families: the server draws its stub frames or image tokens, and
    ``decode_init`` (whisper's 1500-frame encoder, the cross K/V) is timed
    again warm.  ``[lm mixtral serve]`` and ``[lm qwen3-moe serve]`` at
    ``layers`` of their depth (:func:`_cut_depth`): the MoE FFN decodes
    through the reference's gather path, each token's experts' weights
    gathered (mixtral: [4, 2, 6144, 16384] a weight)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import SlotServer, serve
    slots, requests, prompt, new = LM_SERVE
    cfg, depth = _cut_depth(get_config(arch), layers)
    torch.cuda.reset_peak_memory_stats()
    srv, init_s = _synced_wall(lambda: SlotServer(
        cfg, slots, (prompt + new + 8) * 2, device="cuda"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt)
               for _ in range(requests)]
    enc = ""
    if srv.extras:
        _, enc_s = _synced_wall(lambda: srv.model.decode_init(
            srv.params, slots, srv.max_len, extras=srv.extras))
        enc = f" (decode_init warm {enc_s:.3f} s)"
    reset_launches()
    outs, steps, secs = serve(srv, prompts, new, verbose=False)
    launched = sum(LAUNCHES.values())
    _, warm = _synced_wall(lambda: [srv.step() for _ in range(8)])
    served = [t for o in outs for t in o]
    print(f"[{tag}] SlotServer {arch} at full width and {depth} "
          f"({_shape_note(cfg)}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}), init {init_s:.2f} s{enc}: "
          f"{len(outs)}/{requests} requests, {len(served)} tokens served in"
          f" {steps} decode steps, {secs:.2f} s ({secs / steps * 1e3:.2f} "
          f"ms a step, the first included); warm {warm / 8 * 1e3:.2f} ms a "
          f"step, {warm:.3f} s for the 8; kernel launches {launched} "
          f"(decode attention is plain torch); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; first "
          f"outputs {outs[:2]}")
    if len(outs) != requests or len(served) != requests * new or \
            not all(0 <= t < cfg.vocab_size for t in served):
        raise AssertionError(f"[{tag}] the server did not serve every "
                             "request")
    if launched:
        raise AssertionError(f"[{tag}] the decode launched a kernel")
    del srv
    _free_card()


def phase_lm_prefill():
    """``[lm prefill]``: ``build_prefill_step`` with ``use_pallas=True`` at
    full width and depth, bf16: phi3-mini and minitron-8b at B 4 x S
    2048, and phi3-mini with a 1024-key window at B 2 x S 4096.  Each
    launches the wgmma forward once a layer and no other route
    (:func:`_lm_prefill_row`).  Returns the launches by label."""
    import dataclasses
    from repro_torch.configs import get_config
    return {label: _lm_prefill_row(
        "lm prefill", label,
        dataclasses.replace(get_config(arch), window=window), B, S,
        get_config(arch).num_layers)
        for label, arch, B, S, window in LM_PREFILL}


def phase_lm_subq_prefill(family):
    """``[lm xlstm prefill]`` (B 4 x S 1024) and ``[lm zamba2 prefill]``
    (B 4 x S 2048): the same run and checks as ``[lm prefill]`` at full
    width and depth.  zamba2 launches the wgmma forward once at each of
    its 6 attention sites and nothing else; xLSTM launches no kernel, and
    its sLSTM time loops' share of the warm run is printed.  Returns the
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.hybrid import num_attn_sites
    B, S, layers = LM_SUBQ_PREFILL[family]
    cfg, depth = _cut_depth(get_config(LM_SUBQ[family]), layers)
    return _lm_prefill_row(f"lm {family} prefill", family, cfg, B, S,
                           num_attn_sites(cfg) if family == "zamba2" else 0,
                           depth)


class _SlstmClock:
    """Within ``with``: the wall of every sLSTM block (the time loop and
    its projections), the card synchronised on both sides of each."""

    def __init__(self):
        from repro_torch.models import xlstm
        self.mod, self.seconds, self.calls = xlstm, 0.0, 0

    def __enter__(self):
        import torch
        inner = self.orig = self.mod.slstm_apply

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        self.mod.slstm_apply = timed
        return self

    def __exit__(self, *exc):
        self.mod.slstm_apply = self.orig


def _lm_prefill_row(tag, label, cfg, B, S, n_wgmma, depth="depth"):
    """One prefill run: ``build_prefill_step`` with ``use_pallas=True`` on
    random bf16 weights from seed 0, first and warm; its last-position
    logits held against the same step with ``use_pallas=False`` (the
    plain ``gqa_attend``) on the same params upcast to float32, where the
    two routes must agree at the float32 kernel tolerance; in bf16 both
    routes are held against that float32 forward, and the kernel route
    must be as close to it as the plain route, within a quarter: 32 bf16
    layers of random weights put either bf16 route about 2e-2 from the
    float32 forward (PERF.md, §6), so the two bf16 routes' distance from
    each other is printed, not held.  ``n_wgmma`` wgmma forwards, and no
    other route's launch.  A cross-attention family's stub inputs ride
    the batch (:func:`_stub_extras`, bf16, upcast by the float32 model).
    A MoE model's errors are taken on runs routed as the float32 plain
    forward (``moe.routes``): the timed runs route for themselves, their
    logits are held finite and of the right shape, their error from the
    float32 forward and how many choices the first one routes otherwise
    are printed, and the pinned kernel run must launch as the timed one.
    The peak memory is the timed bf16 runs'; the check's (with the
    float32 copy of the params) is printed beside it.  ``depth`` names
    the depth on the phase line.  Returns the launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import moe
    from repro_torch.tree import tree_map
    steps = {(dt, pallas): build_prefill_step(
        dataclasses.replace(cfg, dtype=dt),
        TrainConfig(use_pallas=pallas))[1]
        for dt in ("bfloat16", "float32") for pallas in (True, False)}
    model = build_prefill_step(cfg)[0]
    torch.cuda.reset_peak_memory_stats()
    params, init_s = _synced_wall(lambda: model.init(
        torch.Generator("cuda").manual_seed(0)))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    batch = {"tokens": torch.from_numpy(toks).cuda(),
             **_stub_extras(cfg, B, S, seed=2)}
    reset_launches()
    with moe.routes() as bf16_routes:
        got, first_s = _synced_wall(
            lambda: steps["bfloat16", True](params, batch))
    launches = {k: LAUNCHES[k] for k in LM_ROUTES}
    with _SlstmClock() as slstm:
        _, kernel_s = _synced_wall(
            lambda: steps["bfloat16", True](params, batch))
    peak = torch.cuda.max_memory_allocated()
    ref, plain_s = _synced_wall(
        lambda: steps["bfloat16", False](params, batch))
    p32 = tree_map(lambda t: t.float(), params)
    f32 = {}
    with moe.routes() as routes:
        f32[False] = steps["float32", False](p32, batch)
    with moe.routes(routes):
        f32[True] = steps["float32", True](p32, batch)
    del p32
    timed, pinned, pinned_launches = got, "", launches
    if routes:
        # a rounding apart, a near tie routes a token to another expert
        # (and moves the capacity's cut): the errors below are taken with
        # every route's routing pinned to the float32 plain forward's
        flips = sum(int((a != b).sum()) for a, b in zip(bf16_routes, routes))
        reset_launches()
        with moe.routes(routes):
            got = steps["bfloat16", True](params, batch)
        pinned_launches = {k: LAUNCHES[k] for k in LM_ROUTES}
        with moe.routes(routes):
            ref = steps["bfloat16", False](params, batch)
        pinned = (f"; the first bf16 kernel run routes {flips} of "
                  f"{sum(r.numel() for r in routes)} top-"
                  f"{cfg.experts_per_token} choices unlike the float32 "
                  f"forward, its logits rel err from that forward "
                  f"{_errors(timed, f32[False])[1]:.3e}; each run below "
                  f"routes as that forward ({len(routes)} layers) and the "
                  f"pinned kernel run launches {pinned_launches}")
    err = {name: _errors(a, b)[1] for name, a, b in (
        ("bf16 kernel vs plain", got, ref),
        ("bf16 kernel vs f32", got, f32[False]),
        ("bf16 plain vs f32", ref, f32[False]),
        ("f32 kernel vs plain", f32[True], f32[False]))}
    shape = (B, 1, cfg.vocab_size)
    finite = all(bool(torch.isfinite(t).all()) and tuple(t.shape) == shape
                 for t in (timed, got))
    share = (f"; the sLSTM blocks {slstm.seconds:.3f} s of the warm run "
             f"({100 * slstm.seconds / kernel_s:.1f}%, {slstm.calls} "
             f"blocks)" if slstm.calls else "")
    print(f"[{tag}] {label} ({cfg.name} at full width and {depth}, "
          f"{_shape_note(cfg)}, window {cfg.window}) B {B} x S {S} bf16: init "
          f"{init_s:.2f} s; kernel route {first_s:.3f} s first, "
          f"{kernel_s:.3f} s warm; plain route {plain_s:.3f} s; launches"
          f" {launches}; logits {tuple(timed.shape)} finite "
          f"{finite}; peak memory {peak / 2 ** 30:.2f} GiB (the check's, "
          f"with a float32 copy of the params, "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB)"
          f"{pinned}; rel errs "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
          + f" (limits: f32 kernel vs plain "
          f"{KERNEL_TOL['float32']:.0e}; bf16 kernel vs f32 at most "
          f"1.25x bf16 plain vs f32){share}")
    if not finite or \
            err["f32 kernel vs plain"] > KERNEL_TOL["float32"] or \
            err["bf16 kernel vs f32"] > 1.25 * err["bf16 plain vs f32"]:
        raise AssertionError(f"[{tag}] {label}: the kernel route "
                             "disagrees with the plain route")
    if launches["flash_attention_fwd_wgmma"] != n_wgmma or \
            sum(launches.values()) != n_wgmma or pinned_launches != launches:
        raise AssertionError(f"[{tag}] {label}: launches {launches} "
                             f"(pinned {pinned_launches}), "
                             f"expected {n_wgmma} wgmma forwards and no "
                             "other")
    del timed
    del params, got, ref, f32
    _free_card()
    return launches


def phase_lm_train():
    """``[lm train]``: ``build_train_step`` on phi3-mini at full width and
    depth, bf16, B 2 x S 1024, ``remat="full"``, ``use_pallas=True``, 2
    steps of the in-place AdamW on ``lm_batches`` (the trainer's data).
    Each step launches the forward twice a layer (the forward and the
    remat recompute) and the backward once, all on the wgmma route
    (:func:`_lm_train`).  Returns the launches."""
    import importlib
    from repro_torch.configs import get_config
    B, S, steps = LM_TRAIN
    cfg = get_config(LM_ARCH)
    L = cfg.num_layers
    fwd_route, route, _ = attention_routes(
        importlib.import_module(
            "repro_torch.kernels.flash_attention.flash_attention"),
        S, S, cfg.hd, cfg.num_heads // cfg.num_kv_heads, "bfloat16")
    if (fwd_route, route) != ("wgmma", "wgmma"):
        raise AssertionError(f"[lm train] the routes at S {S}, D {cfg.hd}: "
                             f"forward {fwd_route}, backward {route}")
    return _lm_train("lm train", cfg, B, S, steps, 2 * L * steps,
                     L * steps, f"; the routes at S {S}, D {cfg.hd}: "
                     f"forward {fwd_route}, backward {route}")


def phase_lm_subq_train(family):
    """``[lm xlstm train]`` (B 2 x S 256, 8 of its 48 blocks) and ``[lm
    zamba2 train]`` (B 2 x S 1024, full depth): 2 steps at full width as
    ``[lm train]``.  zamba2 recomputes only its Mamba blocks, so each step
    launches one wgmma forward and one wgmma backward at each of its 6
    attention sites; xLSTM launches none, and its sLSTM blocks' share of
    the steps (their forward and remat recompute) is printed.  Returns
    the launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.hybrid import num_attn_sites
    B, S, steps, layers = LM_SUBQ_TRAIN[family]
    cfg, depth = _cut_depth(get_config(LM_SUBQ[family]), layers)
    n = num_attn_sites(cfg) * steps if family == "zamba2" else 0
    return _lm_train(f"lm {family} train", cfg, B, S, steps, n, n,
                     depth=depth)


def _cut_depth(cfg, layers):
    """(cfg at ``layers`` layers, the depth as the phase line names it);
    ``None`` keeps the full depth."""
    if layers is None:
        return cfg, "depth"
    return (dataclasses.replace(cfg, num_layers=layers),
            f"depth cut to {layers} of {cfg.num_layers} layers")


def phase_lm_cross_prefill(family):
    """``[lm whisper prefill]`` (B 4 x S 448 decoder tokens over 1500
    frames) and ``[lm vlm prefill]`` (B 4 x S 2048 over 1601 image
    tokens): the same run and checks as ``[lm prefill]`` at full width and
    depth.  Only causal self-attention takes the kernel: one wgmma forward
    a decoder layer (whisper, 24) or a self layer (the VLM, 32); the
    encoder and the cross-attention stay plain.  Returns the launches."""
    from repro_torch.configs import get_config
    B, S = LM_CROSS_PREFILL[family]
    cfg = get_config(LM_CROSS[family])
    return _lm_prefill_row(f"lm {family} prefill", family, cfg, B, S,
                           _causal_layers(cfg))


def _causal_layers(cfg):
    """The layers whose causal self-attention launches ``flash_attention``
    under ``use_pallas``: every decoder layer, or the VLM's self layers."""
    from repro_torch.models.vlm import group_shape
    if cfg.family == "vlm":
        n_groups, n_self = group_shape(cfg)
        return n_groups * n_self
    return cfg.num_layers


def phase_lm_cross_train(family):
    """``[lm whisper train]`` (B 4 x S 448, full depth, about 0.8 B
    params) and ``[lm vlm train]`` (B 2 x S 1024, 10 of its 40 layers: 2
    groups): 2 steps at full width as ``[lm train]``, on random stub
    inputs.  Any remat but ``none`` recomputes each encoder and decoder
    layer (whisper) or each whole group (the VLM), so each step launches
    two wgmma forwards (the forward and the recompute) and one wgmma
    backward at each causal self-attention layer.  Returns the
    launches."""
    from repro_torch.configs import get_config
    B, S, steps, layers = LM_CROSS_TRAIN[family]
    cfg, depth = _cut_depth(get_config(LM_CROSS[family]), layers)
    n = _causal_layers(cfg) * steps
    return _lm_train(f"lm {family} train", cfg, B, S, steps, 2 * n, n,
                     depth=depth)


def _lm_train(tag, cfg, B, S, steps, n_fwd, n_bwd, note="", depth="depth"):
    """``steps`` train steps of ``cfg`` on the card, ``remat="full"``,
    ``use_pallas=True``, the in-place AdamW on ``lm_batches`` (and a
    cross-attention family's stub inputs, :func:`_stub_extras`, drawn
    once): each step's loss, grad norm and seconds, the peak of
    ``torch.cuda.max_memory_allocated``, and ``n_fwd`` wgmma forwards and
    ``n_bwd`` wgmma backwards in all, no other route's.  Returns the
    launches."""
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.data.synthetic import lm_batches, synthetic_lm_dataset
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import build_train_step, make_train_state
    from repro_torch.tree import tree_leaves
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=10,
                       total_steps=steps, remat="full", loss_chunk=min(512, S),
                       use_pallas=True)
    model, train_step = build_train_step(cfg, tcfg)
    state = make_train_state(model, torch.Generator("cuda").manual_seed(0),
                             tcfg)
    it = lm_batches(synthetic_lm_dataset(max(S * B * 4, 100_000),
                                         cfg.vocab_size, seed=0), B, S, seed=0)
    extras = _stub_extras(cfg, B, S, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows = []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
        batch.update(extras)
        with _SlstmClock() as slstm:
            (_, m), secs = _synced_wall(lambda: train_step(state, batch))
        rows.append((float(m["loss"]), float(m["grad_norm"]), secs,
                     slstm.seconds))
    peak = torch.cuda.max_memory_allocated()
    launches = {k: LAUNCHES[k] for k in LM_ROUTES}
    share = "; ".join(f"step {i}: the sLSTM blocks {t:.3f} s "
                      f"({100 * t / s:.1f}%)"
                      for i, (_, _, s, t) in enumerate(rows) if t)
    print(f"[{tag}] {cfg.name} at full width and {depth} ({_shape_note(cfg)}, "
          f"{sum(t.numel() for t in tree_leaves(state['params'])) / 1e9:.3f} B "
          f"params, {cfg.dtype}), B {B} x S {S}, remat full, use_pallas: "
          + "; ".join(f"step {i}: loss {l:.4f}, grad norm {g:.4f}, "
                      f"{s:.3f} s" for i, (l, g, s, _) in enumerate(rows))
          + f"; peak memory {peak / 2 ** 30:.2f} GiB "
          f"({torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}"
          f" GiB on the card); launches {launches}{note}"
          + (f"; {share} (forward and remat recompute)" if share else ""))
    if not all(math.isfinite(l) and math.isfinite(g) for l, g, _, _ in rows):
        raise AssertionError(f"[{tag}] a non-finite loss or grad norm")
    if launches["flash_attention_fwd_wgmma"] != n_fwd or \
            launches["flash_attention_bwd_wgmma"] != n_bwd or \
            sum(launches.values()) != n_fwd + n_bwd:
        raise AssertionError(f"[{tag}] launches {launches}: expected "
                             f"{n_fwd} wgmma forward and {n_bwd} wgmma "
                             "backward")
    del state, extras
    _free_card()
    return launches


def phase_lm_reference():
    """``[lm reference]``: phi3-mini's widths at 2 layers in float32, the
    card against the CPU (:func:`_lm_reference`); on the card the prefill
    launches the tiled forward once a layer, and each train step twice a
    layer (the remat recompute) and the backward once."""
    import dataclasses
    from repro_torch.configs import get_config
    _lm_reference("lm reference", dataclasses.replace(
        get_config(LM_ARCH), num_layers=2, dtype="float32"), 2 + 2 * 2 * 2,
        2 * 2)


def phase_lm_subq_reference():
    """``[lm sub-quadratic reference]``: xlstm-1.3b's and zamba2-1.2b's
    widths at 2 layers in float32, card against CPU, as ``[lm
    reference]``.  zamba2 keeps one attention site (``shared_attn_every``
    2): the prefill launches the tiled forward once, each train step once
    more and the backward once (the shared block is not recomputed);
    xLSTM launches nothing."""
    import dataclasses
    from repro_torch.configs import get_config
    for family, arch in LM_SUBQ.items():
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                                  shared_attn_every=2 * bool(
                                      cfg.shared_attn_every))
        n = family == "zamba2"
        _lm_reference(f"lm sub-quadratic reference {family}", cfg,
                      n + 2 * n, 2 * n)


def phase_lm_cross_reference():
    """``[lm cross-attention reference]``: whisper-medium's and
    llama-3.2-vision-11b's smoke configs (2 layers, d 256, 4 heads of 64,
    float32; 32 frames, 16 image tokens) card against CPU, as ``[lm
    reference]``, the VLM's gates drawn nonzero (at the init's zeros its
    cross layer adds nothing).  Tiled forwards: whisper 2 a prefill (its
    decoder layers) and 4 a train step, the VLM 1 and 2 (its one self
    layer); one backward a causal layer a step."""
    from repro_torch.configs import get_smoke_config
    for family, arch in LM_CROSS.items():
        cfg = get_smoke_config(arch)
        n = _causal_layers(cfg)
        _lm_reference(f"lm cross-attention reference {family}", cfg,
                      n + 2 * 2 * n, 2 * n)


def phase_lm_moe_prefill(family):
    """``[lm mixtral prefill]`` and ``[lm qwen3-moe prefill]``: B 4 x S
    2048 at full width and ``LM_MOE_DEPTH`` layers, the run and checks of
    ``[lm prefill]`` (:func:`_lm_prefill_row`): one wgmma forward a layer
    (mixtral's 4096-key window passes S, so every key is seen; qwen3-moe
    puts 16 query heads on a KV head, after ``qk_norm``) and no other
    route.  The MoE FFN takes the capacity dispatch, its expert products
    cuBLAS's, as the reference's are XLA's.  Returns the launches."""
    from repro_torch.configs import get_config
    B, S = LM_MOE_PREFILL
    cfg, depth = _cut_depth(get_config(LM_MOE[family]), LM_MOE_DEPTH[family])
    return _lm_prefill_row(f"lm {family} prefill", family, cfg, B, S,
                           cfg.num_layers, depth)


def phase_lm_moe_train(family):
    """``[lm mixtral train]`` and ``[lm qwen3-moe train]``: B 2 x S 1024 at
    full width and ``LM_MOE_TRAIN``'s depth, 2 steps as ``[lm train]``, the
    loss carrying the router's aux term: each step launches two wgmma
    forwards (the forward and the remat recompute) and one wgmma backward
    a layer.  Returns the launches."""
    from repro_torch.configs import get_config
    B, S, steps, layers = LM_MOE_TRAIN[family]
    cfg, depth = _cut_depth(get_config(LM_MOE[family]), layers)
    n = cfg.num_layers * steps
    return _lm_train(f"lm {family} train", cfg, B, S, steps, 2 * n, n,
                     depth=depth)


def phase_lm_moe_reference():
    """``[lm moe reference]``: mixtral-8x22b's and qwen3-moe-235b-a22b's
    smoke configs (2 layers, d 256, 4 heads of 64, 4 experts top-2,
    float32; mixtral's window 64, qwen3's ``qk_norm``) card against CPU, as
    ``[lm reference]`` (tiled forwards: 2 a prefill, 4 a train step; 2
    backwards a step), then the routing (:func:`_moe_routing_check`)."""
    from repro_torch.configs import get_smoke_config
    for family, arch in LM_MOE.items():
        cfg = get_smoke_config(arch)
        n = cfg.num_layers
        _lm_reference(f"lm moe reference {family}", cfg, n + 2 * 2 * n,
                      2 * n)
        _moe_routing_check(f"lm moe reference {family}", cfg)


def _moe_routing_check(tag, cfg):
    """The prefill step (``use_pallas``, B 2 x S 64) on one init (seed 0)
    twice on the card and once on the CPU: each layer's top-k indices
    equal on both, and the two card runs' logits and indices bitwise
    equal (the dispatch's scatter adds, so the dropped choices' zero rows
    leave the kept token in slot C - 1 as it is, in any order)."""
    import numpy as np
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import moe
    from repro_torch.tree import tree_map
    model, prefill = build_prefill_step(cfg, TrainConfig(use_pallas=True))
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 64)))
    runs = []
    for dev in ("cuda", "cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), params)
        with moe.routes() as routes:
            logits = prefill(p, {"tokens": toks.to(dev)}).cpu()
        runs.append((logits, [i.cpu() for i in routes]))
        del p
    (l1, i1), (l2, i2), (lc, ic) = runs
    bitwise = torch.equal(l1, l2) and all(
        torch.equal(a, b) for a, b in zip(i1, i2))
    same = len(i1) == len(ic) == cfg.num_layers and all(
        torch.equal(a, b) for a, b in zip(i1, ic))
    E, K = cfg.num_experts, cfg.experts_per_token
    C = moe.capacity(64, K, E, cfg.moe_capacity_factor)
    dropped = [int((moe.slots(topi.reshape(2, -1), E) >= C).sum())
               for topi in ic]
    print(f"[{tag}] routing, prefill B 2 x S 64 (capacity {C} a row and "
          f"expert): top-{K} indices of {len(ic)} layers card vs CPU equal "
          f"{same}; two card prefills bitwise equal (logits and indices) "
          f"{bitwise}; choices dropped by capacity per layer {dropped} of "
          f"{2 * 64 * K}; logits card vs CPU max diff "
          f"{float((l1 - lc).abs().max()):.3e}")
    if not (same and bitwise):
        raise AssertionError(f"[{tag}] the routing differs")
    _free_card()


def _fl_gates(cfg, B, device):
    """One client a row, client i on submodel i % M: the FL step's gates
    ``[L, B]``, per-layer counts ``[L]`` and client count."""
    import torch
    from repro_torch.core.layerwise import layer_mask, num_submodels
    gates = torch.stack([layer_mask(cfg, i % num_submodels(cfg),
                                    device=device) for i in range(B)], dim=1)
    return {"layer_gates": gates, "layer_counts": gates.sum(dim=1),
            "n_clients": float(B)}


def _fl_batches(cfg, B, S, steps, seed=0):
    """``steps`` of the trainer's batches (``lm_batches``) on the card,
    each row one client's, with the FL gates (:func:`_fl_gates`)."""
    import torch
    from repro_torch.data.synthetic import lm_batches, synthetic_lm_dataset
    it = lm_batches(synthetic_lm_dataset(max(S * B * 4, 100_000),
                                         cfg.vocab_size, seed=0), B, S,
                    seed=seed)
    out = []
    for _ in range(steps):
        b = {k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
        b.update(_fl_gates(cfg, B, "cuda"))
        out.append(b)
    return out


def _bucket_major(batch, nb):
    """A masked FL batch whose row i is client i (submodel i % nb) as the
    bucketed step takes it, ``[nb, B/nb, S]``: bucket b holds submodel b's
    clients."""
    import torch
    return {k: torch.stack([batch[k][b::nb] for b in range(nb)])
            for k in ("tokens", "labels")}


def _fl_run(tag, build, cfg, tcfg, batches):
    """``build(cfg, tcfg)``'s step over ``batches`` from a state made from
    seed 0 on the card: the rows (loss, grad norm, seconds), the peak of
    ``max_memory_allocated`` and the launches by route."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import make_train_state
    model, step = build(cfg, tcfg)[:2]
    state = make_train_state(model, torch.Generator("cuda").manual_seed(0),
                             tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows = []
    for b in batches:
        (_, m), secs = _synced_wall(lambda: step(state, b))
        rows.append((float(m["loss"]), float(m["grad_norm"]), secs))
    peak = torch.cuda.max_memory_allocated()
    launches = {k: LAUNCHES[k] for k in LM_ROUTES}
    print(f"[{tag}] {cfg.name} at full width and depth ({_shape_note(cfg)},"
          f" exits {tuple(cfg.exit_points)}, {cfg.dtype}), "
          f"{len(batches[0]['labels'].flatten(0, -2))} clients of one "
          f"sequence of {batches[0]['labels'].shape[-1]}, remat full, "
          "use_pallas: " + "; ".join(
              f"step {i}: loss {l:.4f}, grad norm {g:.4f}, {s:.3f} s"
              for i, (l, g, s) in enumerate(rows))
          + f"; peak memory {peak / 2 ** 30:.2f} GiB; launches {launches}")
    if not all(math.isfinite(l) and math.isfinite(g) for l, g, _ in rows):
        raise AssertionError(f"[{tag}] a non-finite loss or grad norm")
    del state
    _free_card()
    return rows, launches


def _check_launches(tag, launches, n_fwd, n_bwd):
    if launches["flash_attention_fwd_wgmma"] != n_fwd or \
            launches["flash_attention_bwd_wgmma"] != n_bwd or \
            sum(launches.values()) != n_fwd + n_bwd:
        raise AssertionError(f"[{tag}] launches {launches}: expected "
                             f"{n_fwd} wgmma forwards and {n_bwd} wgmma "
                             "backwards, no other route")


def _fl_float32_check():
    """Masked against bucketed in float32 on the plain route at 4 of
    phi3-mini's 32 layers, full width, exits cut to (1, 2, 3, 4), B 4 x S
    256 (one client an exit), the reference's ``TrainConfig`` (its
    ``test_fl_bucketed_step_bitwise_equals_masked``): losses within 1e-5
    relative, every updated param at atol 1e-6, rtol 1e-5.  Returns the
    line's numbers."""
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.steps import (build_fl_bucketed_train_step,
                                          build_fl_train_step,
                                          make_train_state)
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=4,
                              exit_points=(1, 2, 3, 4), dtype="float32")
    tcfg = TrainConfig(loss_chunk=256, remat="none")
    (batch,) = _fl_batches(cfg, 4, 256, 1, seed=3)
    states, losses = [], []
    for build, b in ((build_fl_train_step, batch),
                     (build_fl_bucketed_train_step, _bucket_major(batch, 4))):
        model, step = build(cfg, tcfg)[:2]
        state = make_train_state(
            model, torch.Generator("cuda").manual_seed(0), tcfg)
        _, m = step(state, b)
        states.append(state["params"])
        losses.append(float(m["loss"]))
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    worst, ok = 0.0, rel <= 1e-5
    for a, b in zip(*(tree_leaves(s) for s in states)):
        worst = max(worst, float((a - b).detach().abs().max()))
        ok = ok and torch.allclose(a, b, atol=1e-6, rtol=1e-5)
    del states
    _free_card()
    return losses, rel, worst, ok


def phase_lm_fl():
    """``[lm fl train]`` and ``[lm fl bucketed]``: the FL-over-pods steps
    (``launch/steps.py``, the paper's Step 2 in the LM train loop) on
    phi3-mini at full width and depth, bf16, ``remat="full"``,
    ``use_pallas``, 2 steps each on ``lm_batches`` at B 4 x S 1024: four
    clients of one sequence, client i on exit i (8, 16, 24, 32 layers).
    The masked step (``build_fl_train_step``, the gates ``[L, B]``)
    computes every layer for every client: 2 x 32 wgmma forwards (the
    forward and the remat recompute) and 32 backwards a step.  The
    bucketed step (``build_fl_bucketed_train_step``, bucket-major ``[4,
    1, 1024]``, from a state re-made from the same seed: a copy would not
    fit beside the first) runs each bucket's prefix only: 2 x 80 and 80 a
    step.  Checks: exactly those launches, no other route; the two steps'
    first losses within 2e-2 relative; and :func:`_fl_float32_check`.
    Returns the launches of both runs."""
    import importlib
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.steps import (build_fl_bucketed_train_step,
                                          build_fl_train_step)
    B, S, steps = LM_FL
    cfg = get_config(LM_ARCH)
    exits = tuple(cfg.exit_points)
    if len(exits) != B:
        raise AssertionError(f"[lm fl train] {B} clients for {exits}")
    fwd_route, route, _ = attention_routes(
        importlib.import_module(
            "repro_torch.kernels.flash_attention.flash_attention"),
        S, S, cfg.hd, cfg.num_heads // cfg.num_kv_heads, "bfloat16")
    if (fwd_route, route) != ("wgmma", "wgmma"):
        raise AssertionError(f"[lm fl train] the routes at S {S}, D "
                             f"{cfg.hd}: forward {fwd_route}, backward "
                             f"{route}")
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=10,
                       total_steps=steps, remat="full", loss_chunk=min(512, S),
                       use_pallas=True)
    batches = _fl_batches(cfg, B, S, steps)
    masked, m_launch = _fl_run("lm fl train", build_fl_train_step, cfg, tcfg,
                               batches)
    L = cfg.num_layers
    _check_launches("lm fl train", m_launch, 2 * L * steps, L * steps)
    bucketed, b_launch = _fl_run(
        "lm fl bucketed", build_fl_bucketed_train_step, cfg, tcfg,
        [_bucket_major(b, len(exits)) for b in batches])
    n = sum(exits) * steps
    _check_launches("lm fl bucketed", b_launch, 2 * n, n)
    first = abs(bucketed[0][0] - masked[0][0]) / abs(masked[0][0])
    losses, rel, worst, ok = _fl_float32_check()
    print(f"[lm fl bucketed] the bucketed step's wall over the masked "
          f"step's: " + ", ".join(f"step {i} {b[2] / m[2]:.3f}" for i, (m, b)
                                  in enumerate(zip(masked, bucketed)))
          + f" (the layers it computes: {sum(exits)}/{L * len(exits)} = "
          f"{sum(exits) / (L * len(exits)):.3f}); first-step losses "
          f"{masked[0][0]:.6f} masked, {bucketed[0][0]:.6f} bucketed, "
          f"relative {first:.2e} (limit 2e-2); the routes at S {S}, D "
          f"{cfg.hd}: forward {fwd_route}, backward {route}")
    print(f"[lm fl bucketed] float32, plain route, 4 of {L} layers, exits "
          f"(1, 2, 3, 4), B 4 x S 256: losses {losses[0]:.7f} masked, "
          f"{losses[1]:.7f} bucketed, relative {rel:.2e} (limit 1e-5); "
          f"updated params max diff {worst:.3e} (atol 1e-6, rtol 1e-5: "
          f"{ok})")
    if first > 2e-2 or not ok:
        raise AssertionError("[lm fl bucketed] the bucketed and masked "
                             "steps disagree")
    return m_launch, b_launch


def _lm_mesh_bytes():
    """``[lm mesh bytes]``, host only: each LM config's (but the dense
    family's smallest) per-rank bytes of params, grads and AdamW moments
    on the (16, 16)
    production mesh beside the whole state's, from the spec functions on
    the meta device (``launch/specs.py::state_bytes``)."""
    import types
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import state_bytes
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 16, "model": 16})
    parts = []
    for arch in LM_MESH_ARCHS:
        b = state_bytes(get_config(arch), mesh)
        parts.append(
            f"{arch} params {b['params'] / 1e9:.3f} / "
            f"{b['whole_params'] / 1e9:.3f} GB, grads {b['grads'] / 1e9:.3f}"
            f" / {b['whole_grads'] / 1e9:.3f} GB, float32 moments "
            f"{b['moments'] / 1e9:.3f} / {b['whole_moments'] / 1e9:.3f} GB")
    print("[lm mesh bytes] each rank's state on the (16, 16) ('data', "
          "'model') production mesh / the whole state's, from the specs on "
          "the meta device (no card): " + "; ".join(parts))


def phase_lm_mesh():
    """``[lm mesh]``: one card is one rank.  In a one-rank NCCL group the
    production and debug meshes raise ``ValueError`` (256 and 4 ranks),
    so a ``(1, 1)`` ``("data", "model")`` mesh is built directly;
    phi3-mini at full width, 4 of its 32 layers (exits 1-4), bf16,
    ``use_pallas``.  The one-device steps run once from seed 0: 2 train
    steps (B 2 x S 1024) then 2 FL steps (B 4 x S 1024, client i on exit
    i).  Then, under each of ``LM_MESH_POLICIES``, the tensor-parallel
    path (``launch/train.py``: the state built leaf by leaf by
    ``sharded_train_state``, ``meshed_step`` on the params' ``DTensor``s,
    the model's regions in ``sharding/tp.py``) runs the same 4 steps,
    held bit for bit to the one-device steps: losses, grad norms and
    every param and moment (the policies steer only the mesh, and
    phi3-mini's 32 heads, one a KV head, make ``repeat_kv`` a no-op on
    one device).  Every attention launch of the meshed steps goes
    through ``flash_attention``'s local-shard entry
    (``flash_attention_sharded``, ``_bwd_sharded``), counted and checked.
    Then, in the same group, ``LM_MESH_FAMILIES`` (xLSTM, the Mamba2
    hybrid, whisper and the VLM at full width, their depth cut) under
    ``LM_MESH_FAMILY_POLICIES`` (:func:`_lm_mesh_family`), then ``[lm
    mesh serve]`` (each of ``LM_MESH_SERVE``'s models' meshed prefill
    and decode, :func:`_lm_mesh_serve`), and ``[lm mesh bytes]``.
    Returns the launches of the train steps and of the FL steps (the
    one-device run and every policy's), by ``"train"`` and ``"fl"``, of
    each family's steps by its label, and of each serve model's prefills
    by ``"serve <label>"``."""
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.synthetic import lm_batches, synthetic_lm_dataset
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.launch.steps import (build_fl_train_step,
                                          build_train_step, make_train_state)
    from repro_torch.launch.train import meshed_step, sharded_train_state
    from repro_torch.sharding.rules import (get_sharding_policy,
                                            set_sharding_policy)
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    layers, B, B_fl, S, steps = LM_MESH
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=layers,
                              exit_points=tuple(range(1, layers + 1)))
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=10,
                       total_steps=2 * steps, remat="full", loss_chunk=512,
                       use_pallas=True)
    model, train_step = build_train_step(cfg, tcfg)
    _, fl_step = build_fl_train_step(cfg, tcfg)
    it = lm_batches(synthetic_lm_dataset(max(S * B * 4, 100_000),
                                         cfg.vocab_size, seed=0), B, S, seed=0)
    runs = [(train_step, {k: torch.from_numpy(v).cuda()
                          for k, v in next(it).items()})
            for _ in range(steps)]
    runs += [(fl_step, b) for b in _fl_batches(cfg, B_fl, S, steps, seed=1)]
    keys = LM_ROUTES + ("flash_attention_sharded",
                        "flash_attention_bwd_sharded")
    parts = [dict.fromkeys(keys, 0), dict.fromkeys(keys, 0)]

    def count(i):
        """Add the launches since the last count to the train (i <
        steps) or the FL part."""
        for k in keys:
            parts[i >= steps][k] += LAUNCHES[k]
        reset_launches()
    torch.cuda.set_device(0)
    refused, lines, same_all = [], [], True
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            for build in (make_production_mesh, make_debug_mesh):
                try:
                    build()
                except ValueError as e:
                    refused.append(str(e))
                else:
                    raise AssertionError(f"[lm mesh] {build.__name__} "
                                         "built on one rank")
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            reset_launches()
            one = make_train_state(
                model, torch.Generator("cuda").manual_seed(0), tcfg)
            ref = []
            for i, (step, b) in enumerate(runs):
                (one, m), secs = _synced_wall(lambda: step(one, b))
                ref.append((float(m["loss"]), float(m["grad_norm"]), secs))
                count(i)
            before = get_sharding_policy()
            for name, pol in LM_MESH_POLICIES:
                set_sharding_policy(**pol)
                try:
                    (meshed, secs_init) = _synced_wall(
                        lambda: sharded_train_state(model, "cuda", mesh))
                    rows = []
                    for i, (step, b) in enumerate(runs):
                        (meshed, m), secs = _synced_wall(
                            lambda: meshed_step(step, mesh)(meshed, b))
                        rows.append((float(m["loss"]), float(m["grad_norm"]),
                                     secs))
                        count(i)
                finally:
                    set_sharding_policy(**before)
                same = all(a[:2] == b[:2] for a, b in zip(ref, rows)) and \
                    all((x == y) if isinstance(x, int) else
                        torch.equal(x.to_local(), y)
                        for x, y in zip(tree_leaves(meshed), tree_leaves(one)))
                same_all = same_all and same
                placed = sorted({str(tuple(t.placements))
                                 for t in tree_leaves(meshed["params"])})
                lines.append(
                    f"{name}: state built leaf by leaf in {secs_init:.3f} s "
                    f"({', '.join(placed)}); " + ", ".join(
                        f"{'train' if i < steps else 'fl'} {i % steps} loss "
                        f"{r[0]:.4f} {r[2]:.3f} s" for i, r in
                        enumerate(rows)) + f"; bitwise equal: {same}")
                del meshed
                _free_card()
            del one
            _free_card()
            families = {label: _lm_mesh_family(label, arch, cut, B, S,
                                               steps, mesh)
                        for label, arch, cut, B, S in LM_MESH_FAMILIES}
            t_serve = time.perf_counter()
            for label, arch, cut, S_pre in LM_MESH_SERVE:
                families[f"serve {label}"] = _lm_mesh_serve(
                    label, arch, cut, S_pre, mesh)
            print(f"[lm mesh serve] the six models took "
                  f"{time.perf_counter() - t_serve:.1f} s")
        finally:
            dist.destroy_process_group()
    n = len(LM_MESH_POLICIES)
    print(f"[lm mesh] one-rank NCCL group: " + "; ".join(refused)
          + f"; a (1, 1) ('data', 'model') mesh built directly; "
          f"{cfg.name} at full width, {layers} of 32 layers, {cfg.dtype}, "
          f"use_pallas; one device: " + ", ".join(
              f"{'train' if i < steps else 'fl'} {i % steps} loss {r[0]:.4f}"
              f" grad norm {r[1]:.4f} {r[2]:.3f} s"
              for i, r in enumerate(ref)))
    for line in lines:
        print(f"[lm mesh] tensor-parallel, {line}")
    if not same_all:
        raise AssertionError("[lm mesh] a meshed step differs from the "
                             "one-device step")
    # each step (one device, then every policy's): the forward and the
    # remat recompute, and the backward, at each layer; the meshed ones
    # through the local-shard entry
    n_fwd, n_bwd = 2 * layers * steps, layers * steps
    for what, part in zip(("train", "fl"), parts):
        _check_launches(f"lm mesh {what}",
                        {k: part[k] for k in LM_ROUTES},
                        (n + 1) * n_fwd, (n + 1) * n_bwd)
        if (part["flash_attention_sharded"],
                part["flash_attention_bwd_sharded"]) != (n * n_fwd,
                                                         n * n_bwd):
            raise AssertionError(f"[lm mesh {what}] local-shard entry "
                                 f"launches {part}: expected {n * n_fwd} "
                                 f"and {n * n_bwd}")
    print(f"[lm mesh] launches: train {parts[0]}; fl {parts[1]}; the "
          f"local-shard entry's "
          f"{sum(p['flash_attention_sharded'] for p in parts)} forwards and "
          f"{sum(p['flash_attention_bwd_sharded'] for p in parts)} "
          f"backwards (at 32 heads; counted in the lm phi3-mini train and "
          f"fl train rows); {time.perf_counter() - t0:.1f} s")
    print("[lm mesh] several ranks over NCCL (torchrun --nproc-per-node "
          "k) are not run on this one-card machine; tests/test_torch_mesh."
          "py runs the tensor-parallel steps on 4 gloo ranks on the CPU")
    _lm_mesh_bytes()
    return {"train": {k: parts[0][k] for k in LM_ROUTES},
            "fl": {k: parts[1][k] for k in LM_ROUTES}, **families}


def _lm_mesh_family(label, arch, cut, B, S, steps, mesh):
    """``[lm mesh <label>]``: ``arch`` at full width with ``cut`` (one of
    ``LM_MESH_FAMILIES``), bf16, ``use_pallas``, ``steps`` train steps of
    B x S (the stub inputs drawn once): the one-device steps, then under
    each of ``LM_MESH_FAMILY_POLICIES`` the tensor-parallel path on
    ``mesh`` (the state built leaf by leaf, ``meshed_step``) from the
    same seed, held bit for bit to them (losses, grad norms, every param
    and moment; the one-device steps taken again where a policy changes
    them: ``repeat_kv`` on the VLM's grouped cross-attention).  The
    attention launches are exact: a causal self-attention layer's
    forward, its remat recompute and its backward (zamba2's shared block
    is not recomputed), the meshed steps' through the local-shard entry.
    Returns the launches of all the steps by route."""
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.synthetic import lm_batches, synthetic_lm_dataset
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import build_train_step, make_train_state
    from repro_torch.launch.train import meshed_step, sharded_train_state
    from repro_torch.models.hybrid import num_attn_sites
    from repro_torch.sharding.rules import (get_sharding_policy,
                                            set_sharding_policy)
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), **cut)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=10,
                       total_steps=steps, remat="full",
                       loss_chunk=min(512, S), use_pallas=True)
    model, step = build_train_step(cfg, tcfg)
    it = lm_batches(synthetic_lm_dataset(max(S * B * 4, 100_000),
                                         cfg.vocab_size, seed=0), B, S, seed=0)
    extras = _stub_extras(cfg, B, S, seed=1)
    batches = [dict({k: torch.from_numpy(v).cuda()
                     for k, v in next(it).items()}, **extras)
               for _ in range(steps)]
    if cfg.family == "mamba-hybrid":
        n_fwd = n_bwd = num_attn_sites(cfg)
    elif cfg.family == "ssm":
        n_fwd = n_bwd = 0
    else:
        n_bwd = _causal_layers(cfg)
        n_fwd = 2 * n_bwd
    keys = LM_ROUTES + ("flash_attention_sharded",
                        "flash_attention_bwd_sharded")
    total = dict.fromkeys(keys, 0)
    grouped = cfg.num_heads != cfg.num_kv_heads
    before = get_sharding_policy()
    one, ref, ref_key, lines, same_all = None, None, None, [], True
    try:
        for name, pol in LM_MESH_FAMILY_POLICIES:
            key = grouped and pol.get("repeat_kv", False)
            set_sharding_policy(**before)
            set_sharding_policy(**pol)
            if key != ref_key:
                one = None
                _free_card()
                one = make_train_state(
                    model, torch.Generator("cuda").manual_seed(0), tcfg)
                reset_launches()
                ref = []
                for b in batches:
                    (one, m), secs = _synced_wall(lambda: step(one, b))
                    ref.append((float(m["loss"]), float(m["grad_norm"]),
                                secs))
                for k in keys:
                    total[k] += LAUNCHES[k]
                ref_key = key
            meshed, secs_init = _synced_wall(
                lambda: sharded_train_state(model, "cuda", mesh))
            reset_launches()
            rows = []
            for b in batches:
                (meshed, m), secs = _synced_wall(
                    lambda: meshed_step(step, mesh)(meshed, b))
                rows.append((float(m["loss"]), float(m["grad_norm"]), secs))
            got = {k: LAUNCHES[k] for k in keys}
            for k in keys:
                total[k] += got[k]
            same = all(a[:2] == b[:2] for a, b in zip(ref, rows)) and \
                all((x == y) if isinstance(x, int) else
                    torch.equal(x.to_local(), y)
                    for x, y in zip(tree_leaves(meshed), tree_leaves(one)))
            same_all = same_all and same
            lines.append(
                f"{name}: state in {secs_init:.3f} s; " + ", ".join(
                    f"step {i} loss {r[0]:.4f} grad norm {r[1]:.4f} "
                    f"{r[2]:.3f} s (one device {q[2]:.3f} s)"
                    for i, (r, q) in enumerate(zip(rows, ref)))
                + f"; local-shard entry {got['flash_attention_sharded']} "
                f"forwards, {got['flash_attention_bwd_sharded']} "
                f"backwards; bitwise equal: {same}")
            if (got["flash_attention_sharded"],
                    got["flash_attention_bwd_sharded"],
                    got["flash_attention_fwd_wgmma"],
                    got["flash_attention_bwd_wgmma"],
                    sum(got[k] for k in LM_ROUTES)) != (
                    steps * n_fwd, steps * n_bwd, steps * n_fwd,
                    steps * n_bwd, steps * (n_fwd + n_bwd)):
                raise AssertionError(
                    f"[lm mesh {label}] {name}: launches {got}: expected "
                    f"{steps * n_fwd} forwards and {steps * n_bwd} "
                    "backwards, all wgmma and through the local-shard "
                    "entry")
            del meshed
            _free_card()
    finally:
        set_sharding_policy(**before)
    print(f"[lm mesh {label}] {cfg.name} at full width, depth cut "
          f"({_shape_note(cfg)}), {cfg.dtype}, B {B} x S {S}, use_pallas, "
          f"one-rank NCCL (1, 1) mesh: " + "; ".join(lines)
          + f"; {time.perf_counter() - t0:.1f} s")
    if not same_all:
        raise AssertionError(f"[lm mesh {label}] a meshed step differs "
                             "from the one-device step")
    del one, extras, batches
    _free_card()
    return {k: total[k] for k in LM_ROUTES}


def _lm_mesh_serve(label, arch, cut, S, mesh):
    """``[lm mesh serve] <label>``: ``arch`` at full width with ``cut``
    (one of ``LM_MESH_SERVE``), bf16, ``use_pallas``, seed 0, on the
    one-rank ``mesh``: a prefill of B x S (``LM_MESH_SERVE_SHAPE``; the
    stub inputs drawn once) and 8 greedy decode steps on 4 slots over a
    cache of 56, one device (``build_prefill_step``,
    ``build_serve_step``) then on the mesh (``launch/train.py``:
    ``meshed_prefill_step``, ``sharded_decode_cache``,
    ``meshed_serve_step`` on the params as ``DTensor``s in their
    placements, views of the one-device tensors), held bit for bit: the
    prefill's logits, the cache as built, every step's tokens and
    logits; every cache leaf keeps its placements and its storage.  The
    meshed prefill launches ``flash_attention`` once a causal layer or
    shared site, through the local-shard entry, on the wgmma route;
    decode launches no kernel.  Returns the two prefills' launches by
    route."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.specs import params_shardings
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.launch.train import (meshed_prefill_step,
                                          meshed_serve_step,
                                          sharded_decode_cache)
    from repro_torch.models.hybrid import num_attn_sites
    from repro_torch.tree import tree_leaves, tree_map
    t0 = time.perf_counter()
    B, steps, slots, clen = LM_MESH_SERVE_SHAPE
    cfg = dataclasses.replace(get_config(arch), **cut)
    model, prefill = build_prefill_step(cfg, TrainConfig(use_pallas=True))
    _, serve = build_serve_step(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    meshed = tree_map(lambda t, pl: DTensor.from_local(t, mesh, pl,
                                                       run_check=False),
                      params, params_shardings(params, mesh))
    g = torch.Generator("cuda").manual_seed(1)
    batch = dict(_stub_extras(cfg, B, S, seed=1), tokens=torch.randint(
        0, cfg.vocab_size, (B, S), generator=g, device="cuda"))
    extras = _stub_extras(cfg, slots, S, seed=2)
    first = torch.randint(0, cfg.vocab_size, (slots, 1), generator=g,
                          device="cuda", dtype=torch.int32)
    n_pre = (0 if cfg.family == "ssm" else num_attn_sites(cfg)
             if cfg.family == "mamba-hybrid" else _causal_layers(cfg))
    reset_launches()
    one, secs_one = _synced_wall(lambda: prefill(params, batch))
    one_launches = dict(LAUNCHES)
    reset_launches()
    got, secs_mesh = _synced_wall(
        lambda: meshed_prefill_step(prefill, mesh)(meshed, batch))
    pre = dict(LAUNCHES)
    same = torch.equal(got, one)
    cache1 = model.decode_init(params, slots, clen, extras=extras)
    cache = sharded_decode_cache(model, meshed, slots, clen, mesh,
                                 extras=extras)
    same_init = all(torch.equal(a.to_local(), b) for a, b in
                    zip(tree_leaves(cache), tree_leaves(cache1)))
    kept = [(t.placements, t.to_local().data_ptr())
            for t in tree_leaves(cache)]
    run = meshed_serve_step(serve, mesh)
    tok1 = tok = first
    rows, same_steps = [], True
    reset_launches()
    for i in range(steps):
        (t1, cache1, l1), s1 = _synced_wall(
            lambda: serve(params, cache1, tok1, i, logits=True))
        (t2, cache, l2), s2 = _synced_wall(
            lambda: run(meshed, cache, tok, i, logits=True))
        same_steps = same_steps and torch.equal(t1, t2) and torch.equal(
            l1, l2.full_tensor())
        rows.append((s2, s1))
        tok1, tok = t1, t2
    decode_launches = sum(LAUNCHES[k] for k in KERNEL_TOTALS)
    same_cache = all(torch.equal(a.to_local(), b) for a, b in
                     zip(tree_leaves(cache), tree_leaves(cache1)))
    placed = kept == [(t.placements, t.to_local().data_ptr())
                      for t in tree_leaves(cache)]
    finite = bool(torch.isfinite(one).all()) and bool(
        torch.isfinite(l1).all())
    want = (n_pre, n_pre, n_pre, n_pre)
    have = (pre["flash_attention_sharded"], pre["flash_attention_fwd_wgmma"],
            sum(pre[k] for k in LM_ROUTES),
            sum(pre[k] for k in KERNEL_TOTALS))
    print(f"[lm mesh serve] {label}: {cfg.name} at full width, depth cut "
          f"({_shape_note(cfg)}), {cfg.dtype}, use_pallas, one-rank NCCL "
          f"(1, 1) mesh: prefill B {B} x S {S} {secs_mesh:.3f} s meshed, "
          f"{secs_one:.3f} s one device, logits bitwise equal: {same}, "
          f"local-shard entry {have[0]} of {n_pre} forwards; cache "
          f"{slots} slots x {clen} built sharded, bitwise equal: "
          f"{same_init}; {steps} decode steps (s a step, meshed / one "
          f"device): " + ", ".join(f"{a:.4f}/{b:.4f}" for a, b in rows)
          + f"; tokens and logits bitwise equal: {same_steps}, cache "
          f"after the steps bitwise equal: {same_cache}, placements and "
          f"storage kept: {placed}; decode launches {decode_launches} "
          f"kernels; {time.perf_counter() - t0:.1f} s")
    if not (same and same_init and same_steps and same_cache and placed
            and finite):
        raise AssertionError(f"[lm mesh serve] {label}: the meshed prefill "
                             "or decode differs from one device")
    if have != want or decode_launches:
        raise AssertionError(
            f"[lm mesh serve] {label}: prefill launches {have} (local-shard "
            f"entry, wgmma, all attention routes, all kernels): expected "
            f"{want}; decode launched {decode_launches}")
    del params, meshed, cache, cache1, one, got, batch, extras
    _free_card()
    return {k: pre[k] + one_launches[k] for k in LM_ROUTES}


def _lm_reference(tag, cfg, n_fwd, n_bwd):
    """``cfg`` (2 layers, float32) on the card against the CPU on the same
    params (the CPU server's, from seed 0, copied to the card; a VLM's
    gates drawn nonzero) and stub inputs (the CPU server's, and numpy
    draws in the batches): the slot server's greedy tokens (2 slots, 3
    requests of 4 tokens, 4 new) equal; the prefill step's logits (B 2 x
    S 64, ``use_pallas``: the kernel on the card, its plain version on the
    CPU) and 2 train steps' losses and grad norms (the same,
    ``remat="full"``, two batches) at rtol 1e-4 (the logits atol 1e-5);
    ``n_fwd`` tiled forwards and ``n_bwd`` backwards on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import SlotServer, serve
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_train_step)
    from repro_torch.models.api import extra_inputs
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    _, prefill = build_prefill_step(cfg, TrainConfig(use_pallas=True))
    _, train_step = build_train_step(cfg, TrainConfig(
        learning_rate=1e-4, warmup_steps=1, total_steps=2, remat="full",
        loss_chunk=32, use_pallas=True))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=4) for _ in range(3)]
    toks = [rng.integers(0, cfg.vocab_size, (2, 65)) for _ in range(2)]
    stubs = [{k: rng.normal(size=shape).astype(np.float32)
              for k, (shape, _) in extra_inputs(cfg, 2, 64).items()}
             for _ in toks]
    servers = {"cpu": SlotServer(cfg, 2, 32, device="cpu")}
    params, extras = servers["cpu"].params, servers["cpu"].extras
    if "cross_blocks" in params:
        g = torch.Generator().manual_seed(4)
        for k in ("gate_attn", "gate_mlp"):
            params["cross_blocks"][k] = torch.randn(
                params["cross_blocks"][k].shape, generator=g)
    servers["cuda"] = SlotServer(cfg, 2, 32, device="cuda")
    got = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        srv = servers.pop(dev)
        srv.params = tree_map(lambda t: t.to(dev, copy=True), params)
        srv.cache = srv.model.decode_init(
            srv.params, srv.slots, srv.max_len,
            extras={k: v.to(dev) for k, v in extras.items()})
        outs, _, _ = serve(srv, prompts, 4, verbose=False)
        del srv
        batches = [{"tokens": torch.from_numpy(t[:, :-1]).to(dev),
                    "labels": torch.from_numpy(t[:, 1:]).to(dev),
                    **{k: torch.from_numpy(v).to(dev)
                       for k, v in stub.items()}}
                   for t, stub in zip(toks, stubs)]
        reset_launches()
        logits = prefill(p, batches[0]).cpu()
        state = {"params": p, "opt": adamw_init(p)}
        metrics = [train_step(state, b)[1] for b in batches]
        got[dev] = (outs, logits,
                    [(float(m["loss"]), float(m["grad_norm"]))
                     for m in metrics], dict(LAUNCHES))
        del p, state
    (g_out, g_log, g_loss, g_launch), (c_out, c_log, c_loss, _) = \
        got["cuda"], got["cpu"]
    log_ok = torch.allclose(g_log, c_log, rtol=1e-4, atol=1e-5)
    loss_ok = np.allclose(g_loss, c_loss, rtol=1e-4, atol=0)
    print(f"[{tag}] {cfg.name}'s widths at 2 layers, float32, card vs "
          f"CPU: served tokens equal {g_out == c_out} ({g_out}); prefill "
          f"logits max diff {float((g_log - c_log).abs().max()):.3e} "
          f"(allclose at rtol 1e-4, atol 1e-5: {log_ok}); (loss, grad "
          f"norm) card {g_loss} CPU {c_loss} (rtol 1e-4: {loss_ok}); card "
          f"launches { {k: g_launch[k] for k in LM_ROUTES if g_launch[k]} };"
          f" {time.perf_counter() - t0:.1f} s")
    if g_out != c_out or not log_ok or not loss_ok:
        raise AssertionError(f"[{tag}] the card and the CPU disagree")
    if g_launch["flash_attention_fwd_tiled"] != n_fwd or \
            g_launch["flash_attention_bwd"] != n_bwd or \
            sum(g_launch[k] for k in LM_ROUTES) != n_fwd + n_bwd:
        raise AssertionError(f"[{tag}] the card's prefill and train steps "
                             f"launched {g_launch}: expected {n_fwd} tiled "
                             f"forwards and {n_bwd} backwards")
    _free_card()


def phase_lm_kernels():
    """The attention kernel at the LM paths' bf16 shapes (``LM_ATTENTION``,
    model layout [B, S, H, D], causal): forward and backward held against
    the plain version at 2e-2, then timed beside it and beside SDPA
    (``is_causal``, ``enable_gqa`` where query heads share a KV head; a
    window shorter than S through an explicit window mask, SDPA having no
    window; mixtral's 4096 keys at S 2048 are causal), 5 calls each; the
    bound on the bf16 dense tensor-core peak; each shape's route printed
    beside its times; on the wgmma route two
    backward launches held bitwise equal.  Uses only the module's
    wrappers, routes and plain version, so ``scripts/attention_ab.py``
    times earlier designs with it.  Returns the records; their launches
    come from the path runs (:func:`_lm_kernel_launches`).  Run early:
    late in the script the profiler has read these shapes short and then
    not at all."""
    import importlib
    import torch
    import torch.nn.functional as F
    mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    tol = KERNEL_TOL["bfloat16"]
    g = torch.Generator(device="cuda").manual_seed(3)
    records = []
    for label, B, S, Hq, Hkv, D, window in LM_ATTENTION:
        q, k, v = (torch.randn((B, S, h, D), generator=g, device="cuda")
                   .bfloat16().requires_grad_() for h in (Hq, Hkv, Hkv))
        do = torch.randn((B, S, Hq, D), generator=g, device="cuda").bfloat16()
        mask = None
        if window and window < S:   # a window of S keys or more is causal
            mask = mod._visible(S, S, True, window, "cuda")

        def fn(a, b, c):
            return mod.flash_attention(a, b, c, causal=True, window=window)

        def plain(a, b, c):
            return mod.attention_plain_model(a, b, c, causal=True,
                                             window=window)

        def sdpa(a, b, c):
            return F.scaled_dot_product_attention(
                a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
                attn_mask=mask, is_causal=mask is None,
                enable_gqa=Hq != Hkv).transpose(1, 2)
        abs_errs, errs = _fwd_bwd_errors(fn, plain, [q, k, v], do)
        fwd_route, route, _ = attention_routes(mod, S, S, D, Hq // Hkv,
                                               "bfloat16", True, window)
        print(f"[kernel] flash_attention {label} B={B} S={S} Hq={Hq} "
              f"Hkv={Hkv} D={D} window={window} bfloat16 (forward "
              f"{fwd_route}, backward {route}): rel err o {errs[0]:.2e}, dq"
              f" {errs[1]:.2e}, dk {errs[2]:.2e}, dv {errs[3]:.2e} (limit "
              f"{tol:.0e}); abs err o {abs_errs[0]:.2e}, grads "
              f"{max(abs_errs[1:]):.2e}")
        if max(errs) > tol:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at {label}")
        if route == "wgmma":
            _attention_wgmma_check(mod, label, *(
                t.detach().transpose(1, 2).flatten(0, 1)
                for t in (q, k, v, do)), window)
        pairs = _attention_pairs(B * Hq, S, S, True, window)
        nq, nk = B * Hq * S * D, B * Hkv * S * D
        rec = _timed_records(
            ("flash_attention", "flash_attention_bwd"),
            ATTENTION_SOURCES["fwd_" + fwd_route],
            "src/repro/kernels/flash_attention/flash_attention.py:67",
            [(abs_errs[0], errs[0]), (max(abs_errs[1:]), max(errs[1:]))],
            [(f, [q, k, v]) for f in (fn, plain, sdpa)], do,
            # bf16 q, k, v, o (dO, dq, dk, dv) and float32 lse; the same
            # products per kept pair as the float32 rows
            [(2 * (2 * nq + 2 * nk) + 4 * B * Hq * S, 4 * D * pairs),
             (2 * (4 * nq + 4 * nk) + 4 * B * Hq * S, 10 * D * pairs)],
            "SDPA" + (" window mask" if mask is not None else " is_causal"),
            label,
            flops_per_s=BF16_FLOPS_PER_S, iters=5)
        rec[0]["fwd_route"], rec[1]["bwd_route"] = fwd_route, route
        rec[1]["source"] = ATTENTION_SOURCES["bwd_" + route]
        for r, how in zip(rec, (fwd_route, route)):
            r["shape"] = (f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal "
                          f"window={window} bfloat16")
            r["path"] = f"lm {label}"
            print(f"[kernel] {r['name']} {label}: route {how}, device ms "
                  f"{r['ms']:.4f}, {100 * r['bound_ms'] / r['ms']:.1f}% of "
                  f"the bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
                  f"plain {r['plain_ms']:.4f} ms, SDPA "
                  f"{r['library_ms']:.4f} ms")
        records += rec
        del q, k, v, do, mask
        _free_card()
    return records


def _lm_kernel_launches(records, prefill_launches, train_launches):
    """The LM kernel records' launches: each shape's path runs', forward
    and backward, and by route.  ``prefill_launches`` and
    ``train_launches`` by label (a family's under its name:
    ``"zamba2"``, ``"whisper"``, ``"vlm"``, ``"mixtral"``,
    ``"qwen3-moe"``; the FL steps' under ``"fl"`` and ``"fl bucketed"``,
    the mesh's train and FL steps under ``"mesh"`` and ``"mesh fl"``)."""
    runs = {"lm phi3-mini prefill": prefill_launches["phi3-mini"],
            # the VLM's prefill shape is minitron-8b's: its launches too
            "lm minitron-8b prefill": _summed(prefill_launches["minitron-8b"],
                                              prefill_launches["vlm"]),
            # phi3-mini's S 1024 steps by batch: B 2 ([lm train], [lm
            # mesh]'s train steps), B 4 ([lm fl train], [lm mesh]'s FL
            # steps) and B 1 ([lm fl bucketed]'s buckets)
            "lm phi3-mini train": _summed(train_launches["phi3-mini"],
                                          train_launches["mesh"],
                                          train_launches["serve phi3-mini"]),
            "lm phi3-mini fl train": _summed(train_launches["fl"],
                                             train_launches["mesh fl"]),
            # a timing shape only: on one card's (1, 1) mesh all 32
            # heads are the one rank's, so the main path never gives the
            # kernel 8 heads ([lm mesh] prints the local-shard entry's
            # launches, which the two rows above count)
            "lm phi3-mini train local heads": {},
            "lm phi3-mini prefill local heads": {},
            "lm phi3-mini fl bucketed": train_launches["fl bucketed"],
            "lm phi3-mini SWA 1024": prefill_launches["phi3-mini SWA 1024"],
            "lm zamba2 prefill": prefill_launches["zamba2"],
            # [lm zamba2 train] and [lm mesh]'s zamba2 steps, B 2 x S 1024
            "lm zamba2 train": _summed(train_launches["zamba2"],
                                       train_launches["mesh zamba2"],
                                       train_launches["serve zamba2"]),
            # timing shapes, as phi3-mini's local heads
            "lm zamba2 train local heads": {},
            "lm vlm train local heads": {},
            # whisper's prefill and train steps ([lm mesh]'s too) share
            # the decoder's shape
            "lm whisper decoder": _summed(prefill_launches["whisper"],
                                          train_launches["whisper"],
                                          train_launches["mesh whisper"]),
            "lm vlm train": _summed(train_launches["vlm"],
                                    train_launches["mesh vlm"],
                                    train_launches["serve vlm"]),
            "lm mixtral prefill": prefill_launches["mixtral"],
            "lm qwen3-moe prefill": prefill_launches["qwen3-moe"],
            "lm mixtral train": _summed(train_launches["mixtral"],
                                        train_launches["serve mixtral"]),
            "lm qwen3-moe train": train_launches["qwen3-moe"]}
    for r in records:
        counts = runs[r["path"]]
        _attention_route_launches(r, counts)
        r["launches"] = sum(r["route_launches"].values())


def _summed(*counts):
    """Launch counts added key by key."""
    return {k: sum(c.get(k, 0) for c in counts)
            for k in set().union(*counts)}


def _attention_route_launches(record, launches, into=None):
    """An attention record's launches by route (into ``into``, else the
    record): every forward route, or every backward route."""
    into = record if into is None else into
    if "fwd_route" in record:
        into["route_launches"] = {
            k: launches.get(f"flash_attention_fwd_{k}", 0)
            for k in FWD_ROUTES}
    if "bwd_route" in record:
        into["route_launches"] = {
            k: launches.get(f"flash_attention_bwd_{k}", 0)
            for k in BWD_ROUTES}


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
    phase_spec()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card {torch.cuda.get_device_name(0)}")
    from repro_torch.fl import FLConfig
    phase_build()
    floor = phase_floor()
    t_start = time.perf_counter()

    def lap(tag):
        print(f"[time] {tag}: {time.perf_counter() - t_start:.1f} s since "
              "the build")
    attention, set_mixer = phase_attention()
    # early, as the mlp record below: late in the run the profiler read
    # these shapes short, then not at all
    lm_records = phase_lm_kernels()
    records = [phase_kernels()] + phase_rmsnorm() + attention
    for r in records + set_mixer + lm_records:
        r["floor_ms"] = floor
        if "per_client" in r:
            r["per_client"]["floor_ms"] = floor
    records[0]["launches"] = phase_main_path()["layer_agg"]
    # early: timed late in the run, the profiler read layer_agg at the mlp
    # path's shape below its bytes bound on the H100 (0.0701 and 0.0956
    # device ms against 0.1428), so that record is taken here
    lap("the kernels and the main path")
    mlp_record = phase_public_api()
    mlp_record["floor_ms"] = floor
    lap("the public API")
    phase_profile(phase_all_submodels())
    cfg, launches = phase_transformer()
    for r in records[1:]:
        r["launches"] = launches[r["name"]]
        _attention_route_launches(r, launches)
        if "rmsnorm_route" in r:
            r["route_launches"] = {
                k: launches[f"{r['name']}_{k}"] for k in ("vec", "general")}
    phase_profile(cfg, "transformer profile")
    lap("every submodel and the transformer path, profiled")
    phase_paper_fleet()
    phase_defaults()
    phase_table1()
    phase_baselines_bucketed()
    launches = phase_transformer_perclient()
    for r in records[1:]:
        r["per_client"]["launches"] = launches[r["name"]]
        _attention_route_launches(r, launches, r["per_client"])
        if "rmsnorm_route" in r:
            r["per_client"]["route_launches"] = {
                k: launches[f"{r['name']}_{k}"] for k in ("vec", "general")}
    phase_from_list()
    phase_executors()
    lap("the paper's fleet")
    cfg, launches = phase_async()
    records[0]["async_launches"] = launches["layer_agg"]
    records[0]["async"]["launches"] = launches["layer_agg"]
    phase_profile(cfg, "async profile", rounds=2)
    phase_async_heterofl()
    launches = phase_async_transformer()
    for r in records[1:]:
        r["async_launches"] = launches[r["name"]]
    phase_async_faults()
    lap("the async engine")
    phase_reference("reference", FLConfig(participation=0.1,
                                          width_mult=0.125, seed=1,
                                          **REFERENCE_CFG))
    # seed 10: the greedy fresh policy trains the deepest submodel every
    # round and two buckets in rounds 1 and 2 (seed 1 trains submodel 0
    # only, after an empty first round)
    phase_reference("transformer reference", FLConfig(
        participation=0.5, width_mult=0.25, model_family="transformer",
        seed=10, **REFERENCE_CFG))
    for arm in PERCLIENT_REFERENCE_ARMS:
        phase_reference(f"reference perclient {arm['method']}", FLConfig(
            **dict(PERCLIENT_REFERENCE, **arm)))
    phase_async_reference()
    lap("card against CPU")
    records[0]["energy_launches"] = phase_energy()
    records[0]["energy_async_launches"] = phase_energy_async()
    phase_energy_reference()
    phase_energy_grid()
    lap("the energy scenarios")
    launches = phase_fig6()
    rows = phase_marl_train()
    # the n = 1M shape's launches: [marl train]'s n = 1M row
    million = next(r["launches"] for r in rows if r["n"] == 1_048_576)
    for r in set_mixer:
        counts = launches if r["path"].startswith("fig6") else million
        r["launches"] = counts[r["name"]]
        _attention_route_launches(r, counts)
    records += set_mixer
    phase_fleet_scale_reference()
    lap("MARL at fleet scale")
    t0 = time.perf_counter()
    phase_checkpoint()
    phase_checkpoint_async()
    phase_checkpoint_reference()
    print(f"[checkpoint] the three checkpoint phases took "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_lm_examples()
    phase_checkpoint_from_jax_async()
    phase_fleet_mesh()
    print(f"[engine gaps] the three phases took "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_lm_serve()
    prefill_launches = phase_lm_prefill()
    train_launches = {"phi3-mini": phase_lm_train()}
    phase_lm_reference()
    print(f"[lm substrate] the four phases took "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (train_launches["fl"], train_launches["fl bucketed"]), secs = \
        _synced_wall(phase_lm_fl)
    mesh_launches, s_mesh = _synced_wall(phase_lm_mesh)
    train_launches["mesh"] = mesh_launches["train"]
    train_launches["mesh fl"] = mesh_launches["fl"]
    for label, *_ in LM_MESH_FAMILIES:
        train_launches[f"mesh {label}"] = mesh_launches[label]
    for label, *_ in LM_MESH_SERVE:
        # [lm mesh serve]'s prefills, B 2 x S 1024: the train rows' shapes
        train_launches[f"serve {label}"] = mesh_launches[f"serve {label}"]
    print(f"[lm fl] the FL steps took {secs:.1f} s, the mesh {s_mesh:.1f} "
          f"s: {time.perf_counter() - t0:.1f} s")
    for family, arch in LM_SUBQ.items():
        t0 = time.perf_counter()
        phase_lm_serve(arch, f"lm {family} serve")
        prefill_launches[family] = phase_lm_subq_prefill(family)
        train_launches[family] = phase_lm_subq_train(family)
        print(f"[lm {family}] serve, prefill and train took "
              f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_lm_subq_reference()
    print(f"[lm sub-quadratic reference] took "
          f"{time.perf_counter() - t0:.1f} s")
    lap("the sub-quadratic families")
    for family, arch in LM_CROSS.items():
        t0 = time.perf_counter()
        _, secs = _synced_wall(lambda: phase_lm_serve(arch,
                                                     f"lm {family} serve"))
        prefill_launches[family], s_pre = _synced_wall(
            lambda: phase_lm_cross_prefill(family))
        train_launches[family], s_train = _synced_wall(
            lambda: phase_lm_cross_train(family))
        print(f"[lm {family}] serve {secs:.1f} s, prefill {s_pre:.1f} s, "
              f"train {s_train:.1f} s: {time.perf_counter() - t0:.1f} s")
    _, secs = _synced_wall(phase_lm_cross_reference)
    print(f"[lm cross-attention reference] took {secs:.1f} s")
    lap("the cross-attention families")
    for family, arch in LM_MOE.items():
        t0 = time.perf_counter()
        _, secs = _synced_wall(lambda: phase_lm_serve(
            arch, f"lm {family} serve", LM_MOE_DEPTH[family]))
        prefill_launches[family], s_pre = _synced_wall(
            lambda: phase_lm_moe_prefill(family))
        train_launches[family], s_train = _synced_wall(
            lambda: phase_lm_moe_train(family))
        print(f"[lm {family}] serve {secs:.1f} s, prefill {s_pre:.1f} s, "
              f"train {s_train:.1f} s: {time.perf_counter() - t0:.1f} s")
    _, secs = _synced_wall(phase_lm_moe_reference)
    print(f"[lm moe reference] took {secs:.1f} s")
    lap("the MoE family")
    _lm_kernel_launches(lm_records, prefill_launches, train_launches)
    lap("all phases")
    print(f"[profiler] {len(EVENT_TIMED)} kernel timings took the CUDA "
          "events' time for want of a profiler read")
    records.append(mlp_record)
    records += lm_records
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
