"""Synthetic datasets (offline container — no CIFAR/SVHN/FMNIST downloads).

``synthetic_image_dataset`` builds a *learnable* class-conditional Gaussian
mixture with CIFAR-like shapes: class prototypes are smooth random fields,
samples are prototype + noise.  Difficulty is controlled by ``noise`` —
at the default a small CNN separates classes well above chance but far from
perfectly, which is what the FL accuracy dynamics need (DESIGN.md §1:
directional validation of the paper's claims).

``synthetic_lm_dataset`` emits an order-2 Markov token stream, and
``synthetic_token_dataset`` frames it as next-token classification for the
transformer family.

Copied from ``repro.data.synthetic``: the port makes the same arrays from
the same seed without importing the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _smooth_field(rng, hw: int, ch: int, octaves: int = 3) -> np.ndarray:
    """Low-frequency random image so prototypes have spatial structure."""
    img = np.zeros((hw, hw, ch), np.float32)
    for o in range(octaves):
        k = 2 ** (o + 2)
        coarse = rng.normal(size=(k, k, ch)).astype(np.float32)
        reps = int(np.ceil(hw / k))
        up = np.kron(coarse, np.ones((reps, reps, 1), np.float32))[:hw, :hw]
        img += up / (o + 1)
    return img / octaves


def synthetic_image_dataset(n: int, num_classes: int = 10, hw: int = 32,
                            ch: int = 3, noise: float = 1.0, seed: int = 0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x [n,hw,hw,ch] float32, y [n] int32), balanced classes."""
    rng = np.random.default_rng(seed)
    protos = np.stack([_smooth_field(rng, hw, ch) for _ in range(num_classes)])
    protos *= 2.0 / max(np.abs(protos).max(), 1e-6)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = protos[y] + noise * rng.normal(size=(n, hw, hw, ch)).astype(np.float32)
    return x.astype(np.float32), y


def synthetic_lm_dataset(n_tokens: int, vocab: int, seed: int = 0,
                         branching: int = 4) -> np.ndarray:
    """Order-2 Markov chain over ``vocab`` tokens; each (a,b) context has
    ``branching`` likely successors.  Returns [n_tokens] int32."""
    rng = np.random.default_rng(seed)
    # hash-based sparse transition: successors of (a,b) are derived
    # deterministically; probabilities are a fixed random simplex.
    probs = rng.dirichlet(np.ones(branching) * 0.5)
    out = np.empty(n_tokens, np.uint64)
    out[0], out[1] = rng.integers(0, vocab, 2)
    mult1 = np.uint64(6364136223846793005)
    mult2 = np.uint64(1442695040888963407)
    inc = np.uint64(1013904223)
    ctx_choice = rng.choice(branching, size=n_tokens, p=probs).astype(np.uint64)
    with np.errstate(over="ignore"):
        for t in range(2, n_tokens):
            h = (out[t - 2] * mult1 + out[t - 1] * mult2
                 + inc * ctx_choice[t]) >> np.uint64(33)
            out[t] = h % np.uint64(vocab)
    return out.astype(np.int32)


def synthetic_token_dataset(n: int, vocab: int = 10, seq_len: int = 16,
                            noise: float = 1.0, seed: int = 0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Next-token prediction framed as classification over ``vocab``:
    returns (x [n, seq_len] int32 context windows, y [n] int32 next-token
    labels), stride-1 windows over the order-2 Markov stream.  ``noise``
    resamples a fraction (``0.05 * noise``, capped at 0.5) of context
    tokens uniformly."""
    toks = synthetic_lm_dataset(n + seq_len + 1, vocab, seed=seed)
    idx = np.arange(n)[:, None] + np.arange(seq_len)[None, :]
    x = toks[idx].astype(np.int32)
    y = toks[np.arange(n) + seq_len].astype(np.int32)
    if noise > 0:
        rng = np.random.default_rng(seed + 1)
        flip = rng.random(x.shape) < min(0.5, 0.05 * float(noise))
        x = np.where(flip, rng.integers(0, vocab, x.shape), x)
    return x.astype(np.int32), y


def lm_batches(tokens: np.ndarray, batch: int, seq_len: int, seed: int = 0):
    """Infinite iterator of {'tokens','labels'} windows."""
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq_len - 1
    while True:
        idx = rng.integers(0, n, size=batch)
        tok = np.stack([tokens[i:i + seq_len] for i in idx])
        lab = np.stack([tokens[i + 1:i + seq_len + 1] for i in idx])
        yield {"tokens": tok, "labels": lab}
