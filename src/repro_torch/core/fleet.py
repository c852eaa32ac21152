"""Struct-of-arrays device fleet on the card — port of ``repro.core.fleet``.

Every array field of :class:`FleetState` is an ``[n]`` tensor on one
device: float32 for the energy and profile fields (among them the energy
scenarios' ``charge_rate`` and ``tz_phase``, zeros unless
:meth:`repro_torch.energy.EnergyScenario.init_fleet` draws them) (the JAX package runs its
fleet with 64-bit mode off, so float32 is the reference precision), int32
data sizes and a bool ``alive``; the tier and power-mode labels are static
tuples of strings.  The profiles are drawn by the numpy scalar
reference (:func:`repro_torch.core.energy.make_fleet`), so a seed gives
the same fleet as the JAX package.

Eq. 3-7 as batched tensor ops: :func:`fleet_cost_matrix` (time and energy
for every device x submodel), :func:`fleet_affordability` (strict ``<``,
as ``fleet.py:304``; a fleet-wide ``budget_left`` masks inclusively, as
``fleet.py:305-306``) and :func:`fleet_charge` (strict ``>``, as
``fleet.py:323``; a device that cannot pay dies).  The churn updates of
the async engine and hot-plug (``fleet.py:336-406``): :func:`fleet_connect`,
:func:`fleet_disconnect`, :func:`fleet_kill`, :func:`fleet_set_alive`,
:func:`fleet_set_busy` and the host mask :func:`fleet_idle`.  All functions
return new states, their masks built on the fleet's device; the input is
never changed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.energy import make_fleet
from repro_torch.device import resolve_device, to_host


@dataclasses.dataclass
class FleetState:
    compute: torch.Tensor       # samples/s at full model, normal mode
    p_train: torch.Tensor       # W
    p_com: torch.Tensor         # W
    bandwidth: torch.Tensor     # bytes/s uplink
    battery: torch.Tensor       # J capacity
    remaining: torch.Tensor     # J
    data_size: torch.Tensor     # L_n local samples (int32)
    mode_compute: torch.Tensor  # POWER_MODES compute multiplier
    mode_power: torch.Tensor    # POWER_MODES power multiplier
    alive: torch.Tensor         # bool
    #: per-device virtual clock (sim seconds) of the async engine: the
    #: device is mid-task until then.  float32, an observability mirror
    #: only: the engine keeps its authoritative clocks on the host in
    #: float64, as the reference does
    busy_until: torch.Tensor
    #: the energy scenarios' per-device profile arrays
    #: (:mod:`repro_torch.energy`): the harvesting amplitude in J/s (0: the
    #: device never recharges) and the time-of-day offset in [0, 1) of a
    #: day, shared by solar charging and diurnal availability.  ``None``
    #: means zeros of ``remaining``'s dtype on its device, as the reference
    charge_rate: Optional[torch.Tensor] = None
    tz_phase: Optional[torch.Tensor] = None
    #: human-readable labels, static (not tensors): each device's tier and
    #: power mode, as the JAX ``FleetState`` keeps them
    tiers: Tuple[str, ...] = ()
    modes: Tuple[str, ...] = ()

    def __post_init__(self):
        for f in ("charge_rate", "tz_phase"):
            if getattr(self, f) is None:
                setattr(self, f, torch.zeros_like(self.remaining))

    def __len__(self) -> int:
        return int(self.compute.shape[0])

    def replace(self, **kw) -> "FleetState":
        return dataclasses.replace(self, **kw)


def make_fleet_state(n: int, seed: int = 0, tier_probs=(0.4, 0.3, 0.3),
                     data_sizes: Optional[List[int]] = None, *,
                     device="cuda") -> FleetState:
    """Same draws as the JAX ``make_fleet_state`` (numpy float64 profiles),
    rounded to float32 tensors on ``device``."""
    from repro_torch.core.energy import POWER_MODES
    device = resolve_device(device)
    devs = make_fleet(n, seed, tier_probs, data_sizes)

    def f32(vals):
        return torch.tensor(np.asarray(vals, np.float64), dtype=torch.float32,
                            device=device)

    mults = [POWER_MODES[d.mode] for d in devs]
    return FleetState(
        compute=f32([d.profile.compute for d in devs]),
        p_train=f32([d.profile.p_train for d in devs]),
        p_com=f32([d.profile.p_com for d in devs]),
        bandwidth=f32([d.profile.bandwidth for d in devs]),
        battery=f32([d.profile.battery for d in devs]),
        remaining=f32([d.remaining for d in devs]),
        data_size=torch.tensor([d.data_size for d in devs],
                               dtype=torch.int32, device=device),
        mode_compute=f32([m[0] for m in mults]),
        mode_power=f32([m[1] for m in mults]),
        alive=torch.tensor([d.alive for d in devs], dtype=torch.bool,
                           device=device),
        busy_until=torch.zeros((n,), dtype=torch.float32, device=device),
        tiers=tuple(d.profile.tier for d in devs),
        modes=tuple(d.mode for d in devs))


def _f32(fleet: FleetState, vals) -> torch.Tensor:
    return torch.as_tensor(vals, dtype=torch.float32,
                           device=fleet.remaining.device)


def fleet_cost_matrix(fleet: FleetState, model_sizes, model_fractions,
                      local_epochs: int = 5, batch_size: int = 32
                      ) -> Tuple[torch.Tensor, ...]:
    """(t_tra, t_com, e_tra, e_com), each [n, M], in the JAX expression
    order.  ``batch_size`` does not enter Eq. 5 (kept for signature
    parity with the reference)."""
    sizes = _f32(fleet, model_sizes)
    fracs = torch.clamp_min(_f32(fleet, model_fractions), 1e-6)
    eff = (fleet.compute * fleet.mode_compute)[:, None] / fracs[None, :]
    t_tra = (fleet.data_size * local_epochs)[:, None] / eff
    t_com = 2.0 * sizes[None, :] / fleet.bandwidth[:, None]
    e_tra = (fleet.p_train * fleet.mode_power)[:, None] * t_tra
    e_com = fleet.p_com[:, None] * t_com
    return t_tra, t_com, e_tra, e_com


def fleet_affordability(fleet: FleetState, model_sizes, model_fractions,
                        local_epochs: int = 5, batch_size: int = 32,
                        budget_left: Optional[float] = None
                        ) -> torch.Tensor:
    """[n, M+1] bool action mask: column m < M is "can pay for submodel m"
    (strict ``<``), column M (abstain) is always legal; dead devices can
    only abstain.  ``budget_left`` (J), the remaining fleet-wide budget,
    also masks every submodel whose cost alone exceeds it (inclusive
    ``<=``, compared in float32); ``None`` adds nothing."""
    _, _, e_tra, e_com = fleet_cost_matrix(
        fleet, model_sizes, model_fractions, local_epochs, batch_size)
    e_need = e_tra + e_com
    afford = (e_need < fleet.remaining[:, None]) & fleet.alive[:, None]
    if budget_left is not None:
        afford = afford & (e_need <= _f32(fleet, budget_left))
    abstain = torch.ones((len(fleet), 1), dtype=torch.bool,
                         device=afford.device)
    return torch.cat([afford, abstain], dim=1)


def fleet_charge(fleet: FleetState, e_need: torch.Tensor,
                 active: torch.Tensor) -> Tuple[FleetState, torch.Tensor]:
    """Deduct ``e_need`` where ``active``; survival is strict ``>``.  An
    active device that cannot pay wastes its energy and dies (remaining 0,
    alive False).  Returns ``(new_fleet, ok[n])``."""
    attempt = active.to(torch.bool) & fleet.alive
    ok = attempt & (fleet.remaining > e_need)
    died = attempt & ~ok
    zeros = torch.zeros_like(fleet.remaining)
    remaining = torch.where(ok, fleet.remaining - e_need,
                            torch.where(died, zeros, fleet.remaining))
    return fleet.replace(remaining=remaining, alive=fleet.alive & ~died), ok


def fleet_total_remaining(fleet: FleetState) -> float:
    """Eq. 6 fleet energy ledger as a host float (one sync)."""
    return float(fleet.remaining.sum())


def _index_mask(fleet: FleetState, indices) -> torch.Tensor:
    """[n] bool mask on the fleet's device, True at ``indices``."""
    dev = fleet.remaining.device
    mask = torch.zeros((len(fleet),), dtype=torch.bool, device=dev)
    mask[torch.as_tensor(np.asarray(indices, np.int64), device=dev)] = True
    return mask


def _from(fleet: FleetState, start: int) -> torch.Tensor:
    """[n] bool mask of the devices ``[start:]``."""
    return torch.arange(len(fleet), device=fleet.remaining.device) >= start


def fleet_connect(fleet: FleetState, start: int, energy_scale: float = 1.0,
                  now: float = 0.0) -> FleetState:
    """Hot-plug (paper §4.2 Step 1): devices ``[start:]`` come online with
    fresh (scaled) batteries, idle as of sim time ``now``."""
    joins = _from(fleet, start)
    return fleet.replace(
        remaining=torch.where(joins, fleet.battery * energy_scale,
                              fleet.remaining),
        alive=fleet.alive | joins,
        busy_until=torch.where(joins, _f32(fleet, now), fleet.busy_until))


def fleet_disconnect(fleet: FleetState, start: int) -> FleetState:
    """Mark devices ``[start:]`` as not yet connected (dead, no energy)."""
    out = _from(fleet, start)
    return fleet.replace(
        remaining=torch.where(out, torch.zeros_like(fleet.remaining),
                              fleet.remaining),
        alive=fleet.alive & ~out)


def fleet_idle(fleet: FleetState, now: float) -> np.ndarray:
    """[n] bool host mask (one pull): alive and not mid-task at ``now``."""
    alive, busy = to_host(fleet.alive, fleet.busy_until)
    return alive & (busy <= now + 1e-9)


def fleet_set_busy(fleet: FleetState, indices, until) -> FleetState:
    """Mark ``indices`` busy until the given sim times (a scalar or one per
    index), rounded to the float32 mirror; no host pull."""
    busy = fleet.busy_until.clone()
    idx = torch.as_tensor(np.asarray(indices, np.int64),
                          device=busy.device)
    busy[idx] = _f32(fleet, np.asarray(until, np.float64))
    return fleet.replace(busy_until=busy)


def fleet_kill(fleet: FleetState, indices) -> FleetState:
    """Hard crash of ``indices``: battery spent, alive False (the fault
    plan's "crash"); energy already charged for a task stays spent."""
    mask = _index_mask(fleet, indices)
    return fleet.replace(
        remaining=torch.where(mask, torch.zeros_like(fleet.remaining),
                              fleet.remaining),
        alive=fleet.alive & ~mask)


def fleet_set_alive(fleet: FleetState, indices, value: bool) -> FleetState:
    """Set liveness at ``indices`` without touching energy: a transient
    disconnect (False) and its rejoin (True) keep the battery."""
    mask = _index_mask(fleet, indices)
    return fleet.replace(alive=(fleet.alive | mask) if value
                         else (fleet.alive & ~mask))
