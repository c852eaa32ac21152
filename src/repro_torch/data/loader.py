"""Mini-batch schedules — port of ``repro.data.loader`` (numpy only).

:func:`epoch_batches` and :func:`batch_iterator` are copies of the JAX
package's host loaders.  :func:`client_schedule` is the same sequence as
gather indices, so a client's batches can be gathered on the device from
a resident training set instead of being copied from the host per step.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def epoch_batches(x: np.ndarray, y: np.ndarray, batch: int,
                  rng: np.random.Generator
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One shuffled epoch; last partial batch dropped (shape-stable)."""
    idx = rng.permutation(len(x))
    for i in range(0, len(idx) - batch + 1, batch):
        j = idx[i:i + batch]
        yield x[j], y[j]
    if len(idx) < batch:   # tiny client: one padded batch (wrap-around)
        j = np.resize(idx, batch)
        yield x[j], y[j]


def batch_iterator(x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        yield from epoch_batches(x, y, batch, rng)


def client_schedule(part: np.ndarray, seed: int, epochs: int,
                    batch: int) -> np.ndarray:
    """Global-dataset gather indices ``[T_i, B]`` for one client: shuffled
    epochs of full batches, one wrap-around batch for clients with fewer
    than ``batch`` samples — :func:`epoch_batches` over ``epochs`` epochs
    with ``default_rng(seed)``, as indices into the global set."""
    rng = np.random.default_rng(seed)
    part = np.asarray(part)
    n = len(part)
    steps = []
    for _ in range(epochs):
        idx = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            steps.append(part[idx[i:i + batch]])
        if n < batch:
            steps.append(part[np.resize(idx, batch)])
    return np.asarray(steps, np.int32).reshape(len(steps), batch)
