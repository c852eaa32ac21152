"""Carry a JAX package engine checkpoint into the port: a TPU run
continued on the card.

:func:`resume_state_from_jax` turns the state of a ``"drfl-engine"``
manifest, as the port's loader decodes it (every JAX leaf a numpy array),
into the ``resume_state`` of the port's sync :class:`repro_torch.fl.
engine.RoundEngine`:

* the CNN weights through :func:`repro_torch.convert.cnn_params_from_jax`
  (HWIO -> OIHW convolutions), the transformer's leaf for leaf;
* the QMIX learner's params, target and AdamW moments as tensors, the
  AdamW ``step`` as an int;
* the fleet arrays as :class:`repro_torch.core.fleet.FleetState` tensors;
* the history (with an empty ``phase_s`` record for each JAX row: the JAX
  engine times no phases), the partitions, the replay and the numpy RNG
  states as they are.

The JAX selector's ``jax.random`` act key has no torch counterpart: the
port's ε generator keeps the state it was built with, seeded from the
learner's seed, so the ε-greedy draws after the resume are the port's own
(with ε = 0, or the JAX draws replayed, the runs agree).

``run_simulation(resume=True)`` takes this path by itself when the latest
manifest is the JAX package's.  An async JAX checkpoint raises
``NotImplementedError``: its event heap holds the JAX layout's delta rows
(ROADMAP Queue 1, "checkpoints from JAX: async").  The other direction,
a port checkpoint resumed by the JAX package, is refused there by the
manifest's format.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.convert import cnn_params_from_jax, params_from_jax
from repro_torch.fl.engine import resolve_client_executor


def _learner(state: Dict[str, Any]) -> Dict[str, Any]:
    opt = state["opt"]
    return {"params": params_from_jax(state["params"]),
            "target": params_from_jax(state["target"]),
            "opt": {"step": int(opt["step"]), "mu": params_from_jax(opt["mu"]),
                    "nu": params_from_jax(opt["nu"])},
            "updates": int(state["updates"])}


def _selector(state: Dict[str, Any]) -> Dict[str, Any]:
    if state.get("kind") != "marl":
        return state                    # "stateless", or a numpy RNG state
    out = {k: v for k, v in state.items() if k != "key"}
    out["learner"] = _learner(state["learner"])
    out["hidden"] = torch.from_numpy(np.asarray(state["hidden"],
                                                np.float32))
    out["act_gen"] = None
    return out


def resume_state_from_jax(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A decoded JAX sync engine checkpoint as the port's resume state
    for ``cfg`` (whose ``model_family`` says how to convert the weights;
    ``run_simulation`` has already checked the config fingerprint)."""
    if state.get("mode") != "sync":
        raise NotImplementedError(
            f"resuming a JAX engine checkpoint of engine_mode="
            f"{state.get('mode')!r} is not ported to repro_torch yet "
            "(ROADMAP Queue 1, 'checkpoints from JAX: async')")
    conv = (cnn_params_from_jax if cfg.model_family == "cnn"
            else params_from_jax)
    hist = dict(state["hist"], phase_s=[{} for _ in state["hist"]["acc"]],
                executor=resolve_client_executor(cfg))
    fleet = {k: torch.from_numpy(np.array(v))
             for k, v in state["fleet"].items()}
    return dict(state, fleet=fleet,
                global_params=conv(state["global_params"]), hist=hist,
                selector=_selector(state["selector"]))
