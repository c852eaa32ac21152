"""Carry a JAX package engine checkpoint into the port: a TPU run
continued on the card.

:func:`resume_state_from_jax` turns the state of a ``"drfl-engine"``
manifest, as the port's loader decodes it (every JAX leaf a numpy array),
into the ``resume_state`` of the port's :class:`repro_torch.fl.engine.
RoundEngine`, sync or async:

* the CNN weights through :func:`repro_torch.convert.cnn_params_from_jax`
  (HWIO -> OIHW convolutions), the transformer's leaf for leaf;
* the QMIX learner's params, target and AdamW moments as tensors, the
  AdamW ``step`` as an int;
* the fleet arrays as :class:`repro_torch.core.fleet.FleetState` tensors;
* the history (with an empty ``phase_s`` record for each JAX row: the JAX
  engine times no phases), the partitions, the replay and the numpy RNG
  states as they are;
* (async) each in-flight task's ``delta1``, the ``[1, ...]`` row slice of
  its bucket's stacked delta in the JAX layout (``engine.py:413-431``),
  through the same converter behind its leading axis, so the port's
  ``_decode_task`` restores row 0 as the slice the uninterrupted run
  aggregates; the per-client executor's dispatch-time weights
  (``params_table``, keyed by model version) as the global weights are;
  the heap, cohorts, ``last_done``, ``busy64``, ``alive_host``,
  ``disconnected``, ``corrupt_pending`` and the windows as the host
  values they are.

The JAX selector's ``jax.random`` act key has no torch counterpart: the
port's ε generator keeps the state it was built with, seeded from the
learner's seed, so the ε-greedy draws after the resume are the port's own
(with ε = 0, or the JAX draws replayed, the runs agree).

``run_simulation(resume=True)`` takes this path by itself when the latest
manifest is the JAX package's, of either engine mode; a manifest of any
other mode raises ``ValueError``.  The other direction, a port checkpoint
resumed by the JAX package, is refused there by the manifest's format.
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


def _task(enc: Dict[str, Any], cfg) -> Dict[str, Any]:
    """An encoded async task in the port's form: its cohort under
    ``"cid"`` (the JAX task's ``"dispatch"`` repeats it, and its ``"tid"``
    is the key it is saved under), its ``delta1`` row slice in the port's
    layout (a dropped task's is ``None``)."""
    out = {k: v for k, v in enc.items()
           if k not in ("tid", "cohort", "dispatch")}
    out["cid"] = enc["cohort"]
    if enc.get("delta1") is not None:
        out["delta1"] = (
            cnn_params_from_jax(enc["delta1"], stacked=True)
            if cfg.model_family == "cnn" else params_from_jax(enc["delta1"]))
    return out


def resume_state_from_jax(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A decoded JAX engine checkpoint, sync or async, as the port's
    resume state for ``cfg`` (whose ``model_family`` says how to convert
    the weights; ``run_simulation`` has already checked the config
    fingerprint)."""
    mode = state.get("mode")
    if mode not in ("sync", "async"):
        raise ValueError(f"unknown engine_mode {mode!r} in a JAX engine "
                         "checkpoint (expected 'sync' or 'async')")
    conv = (cnn_params_from_jax if cfg.model_family == "cnn"
            else params_from_jax)
    hist = dict(state["hist"], phase_s=[{} for _ in state["hist"]["acc"]],
                executor=resolve_client_executor(cfg))
    fleet = {k: torch.from_numpy(np.array(v))
             for k, v in state["fleet"].items()}
    out = dict(state, fleet=fleet,
               global_params=conv(state["global_params"]), hist=hist,
               selector=_selector(state["selector"]))
    if mode == "async":
        out["state"] = {k: v for k, v in state["state"].items()
                        if k != "tid"}        # the port numbers tasks at save
        out["tasks"] = {tid: _task(enc, cfg)
                        for tid, enc in state["tasks"].items()}
        out["params_table"] = {v: conv(p)
                               for v, p in state["params_table"].items()}
    return out
