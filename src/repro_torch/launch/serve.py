"""Serving launcher: batched greedy decoding with a persistent KV cache and
simple slot-based continuous batching — port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        --smoke --device cpu

Runs on the card (``--device cuda``, the default) unless told otherwise.
Requests (random prompts here) are packed into fixed batch slots;
finished slots are refilled.  The decode step writes its cache in place
(the reference donates it), and the host reads one ``[slots, 1]`` token
tensor a step, as the reference does.

The reference's demo simplifications are kept, so both packages serve
the same tokens: all slots share one monotone position cursor (a
refilled slot can still attend to the previous occupant's KV entries,
and on a recurrent family, xLSTM or the Mamba2 hybrid, carries on from
its state), and a slot past its prompt is fed token 0, not its last
output (the reference never writes its ``tok`` buffer back).  A
cross-attention family (the VLM, whisper) attends to stub frontend
embeddings drawn once, N(0, 1) in ``cfg.dtype``, from the server's own
generator after its params (``extras``; the reference's
``jax.random.normal`` draws cannot be reproduced), given to
``decode_init``.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_serve_step
from repro_torch.models.api import extra_inputs


class SlotServer:
    """Fixed-slot continuous batching over one decode step."""

    def __init__(self, cfg, slots: int, max_len: int, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.model, self._step = build_serve_step(cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.model.init(gen)
        self.extras = {k: torch.randn(shp, generator=gen,
                                      device=self.device).to(dt)
                       for k, (shp, dt)
                       in extra_inputs(cfg, slots, max_len).items()}
        self.cache = self.model.decode_init(self.params, slots, max_len,
                                            extras=self.extras)
        self.tok = np.zeros((slots, 1), np.int32)
        self.pos = 0
        self.active: List[Optional[dict]] = [None] * slots

    def submit(self, prompt: np.ndarray, max_new: int) -> Optional[int]:
        """Assign a request to a free slot; returns slot id or None."""
        for s, a in enumerate(self.active):
            if a is None:
                self.active[s] = {"prompt": list(prompt), "fed": 0,
                                  "out": [], "max_new": max_new}
                return s
        return None

    def step(self):
        """One global decode step: teacher-forces pending prompt tokens,
        collects generated tokens for slots past their prompt."""
        tok = self.tok.copy()
        for s, a in enumerate(self.active):
            if a and a["fed"] < len(a["prompt"]):
                tok[s, 0] = a["prompt"][a["fed"]]
                a["fed"] += 1
        next_tok, self.cache = self._step(
            self.params, self.cache, torch.from_numpy(tok).to(self.device),
            self.pos)
        self.pos += 1
        nt = next_tok.cpu().numpy()
        done = []
        for s, a in enumerate(self.active):
            if not a:
                continue
            if a["fed"] >= len(a["prompt"]):
                a["out"].append(int(nt[s, 0]))
                if len(a["out"]) >= a["max_new"]:
                    done.append((s, a))
                    self.active[s] = None
        return done


def serve(srv: SlotServer, prompts, max_new: int, verbose: bool = True):
    """Serve ``prompts`` through ``srv`` (the reference ``main``'s loop);
    returns (outputs in completion order, decode steps, seconds)."""
    pending = list(prompts)
    outputs, t0, steps = [], time.time(), 0
    while len(outputs) < len(prompts):
        while pending and srv.submit(pending[0], max_new) is not None:
            pending.pop(0)
        for s, a in srv.step():
            outputs.append(a["out"])
            if verbose:
                print(f"request done (slot {s}): {a['out']}")
        steps += 1
        if srv.pos >= srv.max_len - 1:
            print("cache exhausted; stopping")
            break
    return outputs, steps, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    max_len = args.prompt_len + args.max_new + 8
    srv = SlotServer(cfg, args.slots, max_len * 2, device=args.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
               for _ in range(args.requests)]
    outputs, steps, dt = serve(srv, prompts, args.max_new)
    print(f"served {len(outputs)}/{args.requests} requests in {steps} steps, "
          f"{dt:.1f}s ({dt / max(steps, 1) * 1000:.0f} ms/step, "
          f"slots={args.slots})")
    return {"outputs": outputs, "steps": steps, "seconds": dt}


if __name__ == "__main__":
    main()
