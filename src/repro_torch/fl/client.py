"""FL client-side local training (paper Step 5) — port of
``repro.fl.client``.

The per-method training lives on the family
(``family.client_update(method, ...)``, ``family.loss_fn(method)``); this
module keeps the flat API over the default family and the per-(round,
device) seed derivation.  Three client kinds, one per method compared:

* ``drfl_client_update``: the depth-prefix submodel, trained in place on
  the full tree (the delta is zero outside it);
* ``heterofl_client_update``: the width-sliced submodel (HeteroFL);
* ``scalefl_client_update``: depth + width with self-distillation.

Each returns ``(delta, mean local loss)``, the loss a 0-d tensor on the
params' device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.family import resolve_family


def client_update_seed(base_seed: int, round_idx: int, device_idx: int) -> int:
    """Collision-free per-(round, device) seed for local training: the
    ``SeedSequence`` hash of (base, round, device), as ``client.py:37-46``."""
    return int(np.random.SeedSequence(
        entropy=(int(base_seed), int(round_idx), int(device_idx))
    ).generate_state(1)[0])


def drfl_submodel_loss(sub, x, y):
    return resolve_family().loss_fn("drfl")(sub, x, y)


def slice_submodel_loss(sub, x, y):
    return resolve_family().loss_fn("heterofl")(sub, x, y)


def scalefl_submodel_loss(sub, x, y):
    return resolve_family().loss_fn("scalefl")(sub, x, y)


def client_update(method: str, global_params, model_idx: int, x, y, *,
                  epochs=5, batch=32, lr=0.05, seed=0, family=None):
    """Family-routed local training: ``(delta tree, mean local loss)``."""
    return resolve_family(family).client_update(
        method, global_params, model_idx, x, y, epochs=epochs, batch=batch,
        lr=lr, seed=seed)


def drfl_client_update(global_params, model_idx: int, x, y, *, epochs=5,
                       batch=32, lr=0.05, seed=0, family=None):
    """``(full-structure delta, mean loss)``."""
    return client_update("drfl", global_params, model_idx, x, y,
                         epochs=epochs, batch=batch, lr=lr, seed=seed,
                         family=family)


def heterofl_client_update(global_params, model_idx: int, x, y, *, epochs=5,
                           batch=32, lr=0.05, seed=0, family=None):
    """``(sliced delta, mean loss)``; width ``WIDTH_LEVELS[model_idx]``."""
    return client_update("heterofl", global_params, model_idx, x, y,
                         epochs=epochs, batch=batch, lr=lr, seed=seed,
                         family=family)


def scalefl_client_update(global_params, model_idx: int, x, y, *, epochs=5,
                          batch=32, lr=0.05, seed=0, family=None):
    return client_update("scalefl", global_params, model_idx, x, y,
                         epochs=epochs, batch=batch, lr=lr, seed=seed,
                         family=family)
