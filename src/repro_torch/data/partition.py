"""Non-IID client partitions (paper §5.1.2): Dirichlet(alpha) heterogeneous
splits following HeteroFL's methodology — smaller alpha = more non-IID.

Copied from ``repro.data.partition`` (numpy only).
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_per_client: int = 8) -> List[np.ndarray]:
    """Returns per-client index arrays."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(100):
        parts = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx = np.flatnonzero(labels == c)
            rng.shuffle(idx)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
            for i, chunk in enumerate(np.split(idx, cuts)):
                parts[i].extend(chunk.tolist())
        sizes = [len(p) for p in parts]
        if min(sizes) >= min_per_client:
            break
    return [np.asarray(sorted(p), dtype=np.int64) for p in parts]
