"""Charge and availability profiles and the per-run :class:`EnergyScenario`
— port of ``repro.energy.profiles``.

Three orthogonal pieces move energy through time:

* **charge profiles**: how energy comes back, a pure ``[n]`` tensor
  ``rate(fleet, sim_time)`` in J/s from the fleet's ``charge_rate``
  (amplitude) and ``tz_phase`` (time of day) and the sim clock;
* **availability profiles**: when devices are on, an ``[n]`` bool mask of
  ``(fleet, sim_time)``; an unavailable device abstains like a dead one;
* **the global budget**: a fleet-wide joule ceiling that the engine and
  every selector enforce (``EnergyScenario.global_budget_j``).

The device-side functions take the port's :class:`~repro_torch.core.
fleet.FleetState` (float32 tensors; the arithmetic is float32, as the
reference's on a jnp fleet); the host twins (``ok_host``,
``available_host``, ``next_ok_host``, ``next_available_host``) take a
numpy float64 copy of ``tz_phase`` and cost no device sync.  The shared
curves take the array module (``torch`` or ``numpy``) as ``xp``.  Profiles
are frozen dataclasses resolved through registries, so a scenario is
added by registering a class, not by editing the engine.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Type

import numpy as np
import torch

#: the private RNG stream of the per-device profile arrays (spawned off
#: ``(seed, _PROFILE_RNG_TAG)``): enabling a profile never moves the fleet
#: or data draws of the same seed
_PROFILE_RNG_TAG = 0xE67

#: ``carbon_window``: a device abstains while its local grid intensity is
#: above this fraction of the daily peak (the dirtiest third of the day)
CARBON_INTENSITY_CUTOFF = 0.75


def _angle(period: float, tz_phase, sim_time):
    """2 pi (t / period + tz_phase): ``t / period`` in float64 on the host,
    then the sum and the product in ``tz_phase``'s dtype."""
    return 2.0 * math.pi * (sim_time / period + tz_phase)


# ---------------------------------------------------------------------------
# charge profiles
# ---------------------------------------------------------------------------


class ChargeProfile:
    """How energy returns to the fleet.  ``rate`` is the whole contract;
    ``participation_ok`` optionally gates participation by the same clock
    (``None``: never gates); ``ok_host`` / ``next_ok_host`` are its numpy
    twins for the async engine's host-side dispatch mask."""

    name: str = "abstract"

    def rate(self, fleet, sim_time) -> torch.Tensor:
        """[n] instantaneous charge rate (J/s) at ``sim_time``."""
        raise NotImplementedError

    def participation_ok(self, fleet, sim_time) -> Optional[torch.Tensor]:
        """[n] bool participation gate, or None (no gate)."""
        return None

    def ok_host(self, tz_phase: np.ndarray,
                now: float) -> Optional[np.ndarray]:
        return None

    def next_ok_host(self, tz_phase: np.ndarray, now: float) -> np.ndarray:
        """[n] earliest sim time >= now at which each device's gate is
        open (``now`` where it already is)."""
        return np.full(np.shape(tz_phase), float(now))


@dataclasses.dataclass(frozen=True)
class ConstantCharge(ChargeProfile):
    """A flat trickle at each device's ``charge_rate`` J/s; with the
    default amplitude 0 it is the static battery (the engine then skips
    the charge entirely)."""

    name: str = "constant"
    period: float = 86400.0             # unused; a uniform constructor

    def rate(self, fleet, sim_time) -> torch.Tensor:
        return fleet.charge_rate


@dataclasses.dataclass(frozen=True)
class SolarCharge(ChargeProfile):
    """Solar harvesting, ``charge_rate * max(0, sin(2 pi (t / period +
    tz_phase)))``: per-device amplitude and phase (local solar time, the
    same ``tz_phase`` that drives diurnal availability)."""

    name: str = "solar"
    period: float = 86400.0

    def rate(self, fleet, sim_time) -> torch.Tensor:
        s = torch.sin(_angle(self.period, fleet.tz_phase, sim_time))
        return fleet.charge_rate * torch.clamp_min(s, 0.0)


@dataclasses.dataclass(frozen=True)
class CarbonWindowCharge(ChargeProfile):
    """Carbon-priced windows: local intensity ``I = 0.5 - 0.5 cos(2 pi (t
    / period + tz_phase))`` (0 at local midnight, 1 at the peak); devices
    charge at ``charge_rate * (1 - I)`` and abstain while ``I >
    CARBON_INTENSITY_CUTOFF``."""

    name: str = "carbon_window"
    period: float = 86400.0

    def _intensity(self, xp, tz_phase, sim_time):
        return 0.5 - 0.5 * xp.cos(_angle(self.period, tz_phase, sim_time))

    def rate(self, fleet, sim_time) -> torch.Tensor:
        return fleet.charge_rate * (
            1.0 - self._intensity(torch, fleet.tz_phase, sim_time))

    def participation_ok(self, fleet, sim_time) -> torch.Tensor:
        return (self._intensity(torch, fleet.tz_phase, sim_time)
                <= CARBON_INTENSITY_CUTOFF)

    def ok_host(self, tz_phase: np.ndarray, now: float) -> np.ndarray:
        return (self._intensity(np, np.asarray(tz_phase, np.float64), now)
                <= CARBON_INTENSITY_CUTOFF)

    def next_ok_host(self, tz_phase: np.ndarray, now: float) -> np.ndarray:
        # I <= cutoff  <=>  cos(2 pi x) >= 1 - 2 cutoff: open on the phase
        # band [1 - x_c, 1 + x_c] around each whole turn; a blocked device
        # reopens when its phase next reaches 1 - x_c
        tz = np.asarray(tz_phase, np.float64)
        x = (now / self.period + tz) % 1.0
        x_c = math.acos(1.0 - 2.0 * CARBON_INTENSITY_CUTOFF) / (2.0 * math.pi)
        blocked = (x > x_c) & (x < 1.0 - x_c)
        return np.where(blocked, now + ((1.0 - x_c) - x) * self.period, now)


# ---------------------------------------------------------------------------
# availability profiles
# ---------------------------------------------------------------------------


class AvailabilityProfile:
    """When devices are reachable at all.  ``available`` is the device
    mask; ``available_host`` / ``next_available_host`` its numpy twins."""

    name: str = "abstract"

    def available(self, fleet, sim_time) -> Optional[torch.Tensor]:
        """[n] bool mask, or None when every device is always available."""
        return None

    def available_host(self, tz_phase: np.ndarray,
                       now: float) -> Optional[np.ndarray]:
        return None

    def next_available_host(self, tz_phase: np.ndarray,
                            now: float) -> np.ndarray:
        return np.full(np.shape(tz_phase), float(now))


@dataclasses.dataclass(frozen=True)
class AlwaysAvailable(AvailabilityProfile):
    """Every alive device is always dispatchable: the trivial default."""

    name: str = "always"
    period: float = 86400.0
    duty: float = 1.0


@dataclasses.dataclass(frozen=True)
class DiurnalAvailability(AvailabilityProfile):
    """A diurnal wave: device n is available for the first ``duty``
    fraction of its local day, ``(t / period + tz_phase) mod 1 < duty``,
    and offline for the rest."""

    name: str = "diurnal"
    period: float = 86400.0
    duty: float = 0.5

    def _frac(self, tz_phase, sim_time):
        return (sim_time / self.period + tz_phase) % 1.0

    def available(self, fleet, sim_time) -> torch.Tensor:
        return self._frac(fleet.tz_phase, sim_time) < self.duty

    def available_host(self, tz_phase: np.ndarray, now: float) -> np.ndarray:
        return self._frac(np.asarray(tz_phase, np.float64), now) < self.duty

    def next_available_host(self, tz_phase: np.ndarray,
                            now: float) -> np.ndarray:
        frac = self._frac(np.asarray(tz_phase, np.float64), now)
        return np.where(frac < self.duty, now,
                        now + (1.0 - frac) * self.period)


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

_CHARGE_REGISTRY: Dict[str, Type[ChargeProfile]] = {}
_AVAIL_REGISTRY: Dict[str, Type[AvailabilityProfile]] = {}


def register_charge_profile(cls: Type[ChargeProfile],
                            name: Optional[str] = None) -> Type[ChargeProfile]:
    """Register a charge-profile class under ``cls.name`` (or ``name``)."""
    _CHARGE_REGISTRY[name or cls.name] = cls
    return cls


def register_availability_profile(
        cls: Type[AvailabilityProfile],
        name: Optional[str] = None) -> Type[AvailabilityProfile]:
    _AVAIL_REGISTRY[name or cls.name] = cls
    return cls


def known_charge_profiles() -> Tuple[str, ...]:
    return tuple(sorted(_CHARGE_REGISTRY))


def known_availability_profiles() -> Tuple[str, ...]:
    return tuple(sorted(_AVAIL_REGISTRY))


def get_charge_profile(name: str, period: float = 86400.0) -> ChargeProfile:
    try:
        cls = _CHARGE_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown charge profile {name!r} (registered: "
            f"{', '.join(known_charge_profiles())})") from None
    return cls(period=float(period))


def get_availability_profile(name: str, period: float = 86400.0,
                             duty: float = 1.0) -> AvailabilityProfile:
    try:
        cls = _AVAIL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown availability profile {name!r} (registered: "
            f"{', '.join(known_availability_profiles())})") from None
    return cls(period=float(period), duty=float(duty))


register_charge_profile(ConstantCharge)
register_charge_profile(SolarCharge)
register_charge_profile(CarbonWindowCharge)
register_availability_profile(AlwaysAvailable)
register_availability_profile(DiurnalAvailability)


# ---------------------------------------------------------------------------
# the per-run scenario
# ---------------------------------------------------------------------------


def _and(masks):
    masks = [m for m in masks if m is not None]
    if not masks:
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


@dataclasses.dataclass(frozen=True)
class EnergyScenario:
    """One run's resolved energy scenario.  The three ``trivial_*``
    predicates gate every engine hook at the Python level: a trivial piece
    launches nothing and pulls nothing, so the default configuration
    (``constant`` at rate 0, ``always``, no budget) runs exactly the
    scenario-free engine."""

    charge: ChargeProfile
    availability: AvailabilityProfile
    charge_rate: float = 0.0            # fleet-mean amplitude, J/s
    global_budget_j: float = 0.0        # 0 = unlimited
    energy_scale: float = 1.0           # recharge cap: battery * scale

    @property
    def trivial_charge(self) -> bool:
        """No joule can ever flow back into the fleet."""
        return self.charge_rate == 0.0

    @property
    def trivial_availability(self) -> bool:
        """No device is ever gated out by time of day: no availability
        wave, and a charge profile that does not override
        ``participation_ok`` (a type test: ``carbon_window`` alone gates)."""
        return (isinstance(self.availability, AlwaysAvailable)
                and type(self.charge).participation_ok
                is ChargeProfile.participation_ok)

    @property
    def budget_active(self) -> bool:
        return self.global_budget_j > 0.0

    @property
    def is_trivial(self) -> bool:
        return (self.trivial_charge and self.trivial_availability
                and not self.budget_active)

    def init_fleet(self, fleet, seed: int):
        """Draw the per-device profile arrays for every device of the
        fleet (hot-plug joiners included): ``tz_phase`` ~ U[0, 1), then
        ``charge_rate`` ~ amplitude x U[0.7, 1.3], from the private stream
        ``(seed, _PROFILE_RNG_TAG)`` in numpy float64, rounded to the
        fleet's dtype on its device: the reference's draws, bit for bit."""
        rng = np.random.default_rng((int(seed), _PROFILE_RNG_TAG))
        n = len(fleet)
        tz = rng.uniform(0.0, 1.0, size=n)
        amp = self.charge_rate * rng.uniform(0.7, 1.3, size=n)
        like = dict(dtype=fleet.remaining.dtype,
                    device=fleet.remaining.device)
        return fleet.replace(charge_rate=torch.as_tensor(amp, **like),
                             tz_phase=torch.as_tensor(tz, **like))

    def apply_charge(self, fleet, t0: float, t1: float):
        """Integrate the charge rate over ``[t0, t1]`` by the midpoint rule
        and top up every ALIVE device, capped at ``max(battery *
        energy_scale, remaining)``; a dead device keeps its (zero) charge:
        harvesting never brings one back."""
        if t1 <= t0:
            return fleet
        rate = self.charge.rate(fleet, 0.5 * (t0 + t1))
        cap = fleet.battery * self.energy_scale
        topped = torch.minimum(fleet.remaining + rate * (t1 - t0),
                               torch.maximum(cap, fleet.remaining))
        return fleet.replace(remaining=torch.where(fleet.alive, topped,
                                                   fleet.remaining))

    def available(self, fleet, sim_time) -> Optional[torch.Tensor]:
        """[n] bool device-side participation mask (the availability wave
        AND the charge profile's gate), or None when trivial."""
        return _and([self.availability.available(fleet, sim_time),
                     self.charge.participation_ok(fleet, sim_time)])

    def available_host(self, tz_phase: np.ndarray,
                       now: float) -> Optional[np.ndarray]:
        """Numpy twin of :meth:`available` over a host ``tz_phase`` copy."""
        return _and([self.availability.available_host(tz_phase, now),
                     self.charge.ok_host(tz_phase, now)])

    def next_available_host(self, tz_phase: np.ndarray, now: float) -> float:
        """Earliest sim time after ``now`` at which at least one of the
        given devices passes every gate (each device's latest next
        opening: conservative under stacked gates; a wake that finds the
        gate shut again reschedules); ``now + 1e-6`` if that is not
        later."""
        tz = np.asarray(tz_phase, np.float64)
        if tz.size == 0:
            return float(now)
        nxt = np.maximum(self.availability.next_available_host(tz, now),
                         self.charge.next_ok_host(tz, now))
        t = float(nxt.min())
        return t if t > now else float(now) + 1e-6


def scenario_from_config(cfg) -> EnergyScenario:
    """The :class:`EnergyScenario` a flat config asks for (any object with
    ``FLConfig``'s energy fields)."""
    period = float(getattr(cfg, "charge_period", 86400.0))
    return EnergyScenario(
        charge=get_charge_profile(
            getattr(cfg, "charge_profile", "constant"), period=period),
        availability=get_availability_profile(
            getattr(cfg, "availability_profile", "always"), period=period,
            duty=float(getattr(cfg, "availability_duty", 1.0))),
        charge_rate=float(getattr(cfg, "charge_rate", 0.0)),
        global_budget_j=float(getattr(cfg, "global_budget_j", 0.0)),
        energy_scale=float(getattr(cfg, "energy_scale", 1.0)))
