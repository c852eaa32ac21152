"""FL client helpers — port of ``repro.fl.client`` (seed derivation only;
the per-client executor is ROADMAP Queue 1, 'per-client executor')."""
from __future__ import annotations

import numpy as np


def client_update_seed(base_seed: int, round_idx: int, device_idx: int) -> int:
    """Collision-free per-(round, device) seed for local training: the
    ``SeedSequence`` hash of (base, round, device), as ``client.py:37-46``."""
    return int(np.random.SeedSequence(
        entropy=(int(base_seed), int(round_idx), int(device_idx))
    ).generate_state(1)[0])
