"""Seeded fault injection for the async engine — a copy of
``repro.fl.faults`` (numpy only; the port imports nothing of the JAX
package).  The plan's RNG stream is the reference's,
``default_rng((seed, 0xFA17))``, so a seed gives the same event list in
both packages.

A :class:`FaultPlan` is a frozen, seed-deterministic list of
:class:`FaultEvent`\\ s that the async engine pushes onto its event heap
at startup; each pops like any completion event, so a faulted run is
exactly as reproducible as a clean one.

Event taxonomy (``kind``):

* ``"crash"``       — device dies mid-whatever: battery spent
  (``fleet_kill``), any in-flight task is lost, and its cohort is charged
  a wasted-energy penalty so the MARL selector *learns* flakiness.
* ``"timeout"``     — straggler: the in-flight task never completes; the
  device stays unresponsive (busy) until the task's deadline reaps it.
* ``"disconnect"``  — transient: alive -> False for ``duration`` sim
  seconds (in-flight task lost), then a ``"rejoin"`` event restores the
  device with its battery intact.
* ``"corrupt"``     — the device's next completed delta is replaced by a
  poisoned payload (``nan`` / ``inf`` / ``huge``); aggregation-side
  quarantine must keep it out of the global params.

``"rejoin"`` events are engine-internal (scheduled by a disconnect);
plans never contain them directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

FAULT_KINDS = ("crash", "timeout", "disconnect", "corrupt")
CORRUPT_PAYLOADS = ("nan", "inf", "huge")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    time: float                  # sim-seconds
    kind: str                    # one of FAULT_KINDS (or "rejoin", internal)
    device: int
    duration: float = 0.0        # disconnect only: seconds until rejoin
    payload: str = ""            # corrupt only: nan | inf | huge

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    events: Tuple[FaultEvent, ...]

    def __post_init__(self):
        for ev in self.events:
            if ev.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {ev.kind!r} "
                                 f"(expected one of {FAULT_KINDS})")
            if ev.kind == "corrupt" and ev.payload not in CORRUPT_PAYLOADS:
                raise ValueError(f"corrupt payload {ev.payload!r} "
                                 f"(expected one of {CORRUPT_PAYLOADS})")

    def __len__(self):
        return len(self.events)

    @staticmethod
    def sample(n_devices: int, horizon: float, *, crashes: int = 0,
               timeouts: int = 0, disconnects: int = 0, corrupts: int = 0,
               seed: int = 0) -> "FaultPlan":
        """Seed-deterministic plan: event times uniform over the middle
        90% of ``horizon`` sim-seconds, devices uniform over the fleet."""
        if horizon <= 0:
            raise ValueError("FaultPlan.sample needs horizon > 0 "
                             "(sim-seconds over which to spread events)")
        rng = np.random.default_rng((int(seed), 0xFA17))
        events = []
        for kind, count in (("crash", crashes), ("timeout", timeouts),
                            ("disconnect", disconnects),
                            ("corrupt", corrupts)):
            for _ in range(int(count)):
                t = float(rng.uniform(0.05, 0.95) * horizon)
                dev = int(rng.integers(0, n_devices))
                dur = float(rng.uniform(0.05, 0.25) * horizon)
                payload = str(rng.choice(CORRUPT_PAYLOADS))
                events.append(FaultEvent(
                    time=t, kind=kind, device=dev,
                    duration=dur if kind == "disconnect" else 0.0,
                    payload=payload if kind == "corrupt" else ""))
        events.sort(key=lambda e: (e.time, e.device, e.kind))
        return FaultPlan(events=tuple(events))

    @staticmethod
    def from_config(cfg) -> Optional["FaultPlan"]:
        """Build the plan the flat config describes (None = faults off)."""
        counts = dict(crashes=getattr(cfg, "fault_crashes", 0),
                      timeouts=getattr(cfg, "fault_timeouts", 0),
                      disconnects=getattr(cfg, "fault_disconnects", 0),
                      corrupts=getattr(cfg, "fault_corrupts", 0))
        if not any(counts.values()):
            return None
        horizon = (getattr(cfg, "fault_horizon", 0.0)
                   or getattr(cfg, "async_time_horizon", 0.0))
        if horizon <= 0:
            raise ValueError(
                "fault injection needs a time window: set fault_horizon "
                "(or async_time_horizon) > 0 so events can be scheduled")
        fault_seed = getattr(cfg, "fault_seed", -1)
        seed = fault_seed if fault_seed >= 0 else cfg.seed
        return FaultPlan.sample(cfg.n_devices, float(horizon), seed=seed,
                                **counts)


def poison_payload(payload: str):
    """The value a corrupted delta's leaves are filled with."""
    return {"nan": float("nan"), "inf": float("inf"),
            "huge": 1e30}[payload]
