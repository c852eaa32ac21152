"""Early-exit greedy decoding from the transformer family's global model
on the PyTorch port (``repro_torch``): the twin of
``examples/serve_lm.py``, with its flags and ``--device``.

The serving-side payoff of depth-prefix training: the SAME parameter tree
answers at any of its exits, so a battery-poor device decodes from exit 0
while a charged one uses the full depth.

    PYTHONPATH=src python examples/serve_lm_torch.py --gen 24   # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu \\
        --exit 0 --gen 24 --ckpt /tmp/lm.msgpack

``--ckpt`` takes params saved by either package's ``train_lm``
(``examples/train_lm_torch.py`` or ``examples/train_lm.py``: one format).
Decoding recomputes the full context window each step (the family's
training forward over the ``seq``-token sliding window, no KV cache), as
the reference does, and pulls one token a step from the device.  Without
``--ckpt`` the script first runs a few local DR-FL warm-up rounds so the
decode has a trained tree to exercise.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.family import get_family
from repro_torch.tree import tree_leaves, tree_map


@torch.no_grad()
def greedy_decode(fam, params, prompt, gen, exit_idx, seq):
    """Greedy next-token loop over a sliding ``seq``-token window."""
    dev = tree_leaves(params)[0].device
    toks = list(map(int, prompt))
    for _ in range(gen):
        window = torch.tensor(toks[-seq:], dtype=torch.int64,
                              device=dev)[None, :]
        logits = fam.apply_all_exits(params, window)[exit_idx]
        toks.append(int(torch.argmax(logits[0])))
    return toks[len(prompt):]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None,
                    help="msgpack params from examples/train_lm*.py")
    ap.add_argument("--exit", dest="exit_idx", type=int, default=-1,
                    help="exit head to decode from (-1 = deepest)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--train-rounds", type=int, default=6,
                    help="warmup DR-FL rounds when no --ckpt is given")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None, params=None):
    """Decode from exits 0, ``--exit`` and M-1; returns ``{exit: (tokens,
    ms per token)}``.  ``params`` (a tree of tensors) stands in for the
    family's init at ``--seed``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    fam = get_family("transformer")
    M = fam.num_submodels()
    exit_idx = args.exit_idx % M
    if params is None:
        params = fam.init(torch.Generator().manual_seed(args.seed), 10,
                          width_mult=args.width, hw=args.seq)
    if args.ckpt:
        from repro_torch.checkpoint import load_pytree
        params = load_pytree(args.ckpt, params)
        print("loaded", args.ckpt)
    params = tree_map(lambda t: torch.as_tensor(t).to(dev), params)
    if not args.ckpt:
        print(f"no --ckpt: {args.train_rounds} local DR-FL warmup rounds")
        x, y = fam.make_dataset(1200, 10, hw=args.seq, noise=1.0,
                                seed=args.seed)
        g = params
        for rnd in range(args.train_rounds):
            d, loss = fam.client_update("drfl", g, M - 1, x, y, epochs=1,
                                        batch=32, lr=0.05,
                                        seed=args.seed + rnd)
            g = tree_map(lambda a, b: a + b, g, d)
            print(f"  round {rnd} loss={float(loss):.3f}")
        params = g

    # prompt: a fresh window from the same Markov stream (held-out offset)
    x_eval, _ = fam.make_dataset(64, 10, hw=args.seq, noise=0.0,
                                 seed=args.seed + 1)
    prompt = np.asarray(x_eval[0])
    print(f"prompt tokens: {prompt.tolist()}")

    out = {}
    for m in sorted({0, exit_idx, M - 1}):
        t0 = time.time()
        toks = greedy_decode(fam, params, prompt, args.gen, m, args.seq)
        dt = (time.time() - t0) / args.gen * 1000
        out[m] = (toks, dt)
        marker = " <-- --exit" if m == exit_idx else ""
        print(f"exit {m} ({m + 1}/{M} blocks): {toks}  "
              f"[{dt:.1f} ms/token]{marker}")
    return out


if __name__ == "__main__":
    main()
