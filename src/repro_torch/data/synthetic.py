"""Synthetic datasets (offline container — no CIFAR/SVHN/FMNIST downloads).

``synthetic_image_dataset`` builds a *learnable* class-conditional Gaussian
mixture with CIFAR-like shapes: class prototypes are smooth random fields,
samples are prototype + noise.  Difficulty is controlled by ``noise`` —
at the default a small CNN separates classes well above chance but far from
perfectly, which is what the FL accuracy dynamics need (DESIGN.md §1:
directional validation of the paper's claims).

Copied from ``repro.data.synthetic`` (image set only): the port makes the
same arrays from the same seed without importing the JAX package.
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
