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

Fleet scale (``fleet.py:213-255``, ``:419-538``): :func:`sample_fleet_state`
(batched numpy draws for 65k-1M devices), :func:`fleet_topk_mask` (ties
to the lower index through a stable sort) and :func:`fleet_summary`, the
factored QMIX state of ``summary_width(M)`` features.  Its histogram bins
are exact: the float32 quotients are true divisions on every device (a
CUDA division by a host scalar multiplies by the reciprocal, which can
move a value across a bin edge), and every fleet sum is taken exactly in
float64 and rounded once, so the card and the CPU give the same bits and
the JAX package's float32 sums agree to their own rounding.

A fleet sharded over a ``torch.distributed`` mesh
(:mod:`repro_torch.sharding.fleet`: every field a ``DTensor``, rows
split over the ranks) runs through the same functions, inside the
caller's ``torch.distributed.tensor.experimental.implicit_replication()``
(a plain tensor met on the way, which every rank holds whole, is taken as
replicated): the elementwise ops on each rank's rows, and the two
reductions of the selection step with their collectives written out,
each rank's rows never gathered: :func:`fleet_summary` adds every rank's
float64 sums with ONE ``all_reduce`` of ``summary_width`` values before
its one rounding, so its bits are the unsharded summary's;
:func:`fleet_topk_mask` takes each rank's top k, gathers the k (value,
index) candidates of every rank with one ``all_gather`` and merges them
with the same tie rule.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.core.energy import BATTERY_JOULES, DEVICE_TIERS, make_fleet
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
                     device="cuda", dtype=torch.float32) -> FleetState:
    """Same draws as the JAX ``make_fleet_state`` (numpy float64 profiles),
    as ``dtype`` tensors on ``device``: float32, the engines' precision,
    or float64, the reference's numpy backend (``backend="numpy"``, what
    :class:`repro_torch.fl.environment.FLEnv` runs on)."""
    from repro_torch.core.energy import POWER_MODES
    device = resolve_device(device)
    devs = make_fleet(n, seed, tier_probs, data_sizes)

    def f32(vals):
        return torch.tensor(np.asarray(vals, np.float64), dtype=dtype,
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
        busy_until=torch.zeros((n,), dtype=dtype, device=device),
        tiers=tuple(d.profile.tier for d in devs),
        modes=tuple(d.mode for d in devs))


def sample_fleet_state(n: int, seed: int = 0, tier_probs=(0.4, 0.3, 0.3),
                       data_sizes: Optional[List[int]] = None, *,
                       device="cuda") -> FleetState:
    """The large-fleet constructor (``fleet.py:213-255``): the reference's
    batched numpy draws (tier mix, per-tier jitter, data sizes), rounded to
    float32 tensors on ``device``; no labels.  Not the draws of
    :func:`make_fleet_state` for a seed, as in the reference."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    tier_names = list(DEVICE_TIERS)
    tiers = rng.choice(len(tier_names), size=n, p=list(tier_probs))
    base = np.asarray([DEVICE_TIERS[t] for t in tier_names], np.float64)
    jitter = rng.uniform(0.85, 1.15, size=(n, 3))
    c, pt, pc = (base[tiers] * jitter).T
    if data_sizes is not None:
        ds = np.asarray(data_sizes, np.int64)
    else:
        ds = rng.integers(200, 1200, size=n)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=torch.float32,
                            device=device)
    battery = f32(np.full(n, BATTERY_JOULES))
    return FleetState(
        compute=f32(c), p_train=f32(pt), p_com=f32(pc),
        bandwidth=f32(np.full(n, 2.5e6)), battery=battery,
        remaining=battery.clone(),
        data_size=torch.tensor(ds, dtype=torch.int32, device=device),
        mode_compute=f32(np.ones(n)), mode_power=f32(np.ones(n)),
        alive=torch.ones((n,), dtype=torch.bool, device=device),
        busy_until=torch.zeros((n,), dtype=torch.float32, device=device))


def _rows(t: DTensor):
    """(this rank's rows, the global index of its first row, the group to
    reduce over or None) of a fleet ``DTensor``: a replicated one holds
    every row and needs no collective."""
    local = t.to_local()
    if not isinstance(t.placements[0], Shard):
        return local, 0, None
    mesh = t.device_mesh
    return local, mesh.get_local_rank() * local.shape[0], mesh.get_group()


def _like_rows(ref: DTensor, local: torch.Tensor) -> DTensor:
    """``local``, this rank's rows, as a ``DTensor`` placed as ``ref``."""
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False)


def _like(fleet: FleetState, vals) -> torch.Tensor:
    """``vals`` in the fleet's float dtype (float32 but for the float64
    fleets of :func:`make_fleet_state`), on its device."""
    return torch.as_tensor(vals, dtype=fleet.remaining.dtype,
                           device=fleet.remaining.device)


def fleet_cost_matrix(fleet: FleetState, model_sizes, model_fractions,
                      local_epochs: int = 5, batch_size: int = 32
                      ) -> Tuple[torch.Tensor, ...]:
    """(t_tra, t_com, e_tra, e_com), each [n, M], in the JAX expression
    order.  ``batch_size`` does not enter Eq. 5 (kept for signature
    parity with the reference)."""
    sizes = _like(fleet, model_sizes)
    fracs = torch.clamp_min(_like(fleet, model_fractions), 1e-6)
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
        afford = afford & (e_need <= _like(fleet, budget_left))
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
    """Eq. 6 fleet energy ledger as a host float (one sync; a sharded
    fleet's ranks' sums added by :func:`~repro_torch.device.to_host`'s
    gather: ``float`` of a sharded sum would read this rank's alone)."""
    return float(to_host(fleet.remaining.sum())[0])


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
        busy_until=torch.where(joins, _like(fleet, now), fleet.busy_until))


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
    busy[idx] = _like(fleet, np.asarray(until, np.float64))
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


# ---------------------------------------------------------------------------
# Top-K participant cut and the factored fleet summary (fleet.py:419-538)
# ---------------------------------------------------------------------------


def fleet_topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """[n] bool mask of the k highest ``scores``; ties go to the lower
    index (a stable descending sort: ``torch.topk`` keeps no tie order,
    ``jax.lax.top_k`` and the host selectors' stable argsort do).  ``-inf``
    scores are never selected.  Sharded scores (a ``DTensor``): each
    rank's top k, one ``all_gather`` of every rank's k (value, global
    index) candidates, the same stable sort over them in rank order (so
    ties still go to the lower index), each rank marking its own rows."""
    if isinstance(scores, DTensor):
        return _topk_mask_sharded(scores, k)
    n = int(scores.shape[0])
    k = max(0, min(int(k), n))
    mask = torch.zeros((n,), dtype=torch.bool, device=scores.device)
    if k:
        idx = torch.sort(scores, descending=True, stable=True).indices[:k]
        mask[idx] = True
    return mask & torch.isfinite(scores)


def _topk_mask_sharded(scores: DTensor, k: int) -> DTensor:
    local, off, group = _rows(scores)
    if group is None:                      # replicated: every row is here
        return _like_rows(scores, fleet_topk_mask(local, k))
    k = max(0, min(int(k), int(scores.shape[0])))
    kl = min(k, local.shape[0])
    top = torch.sort(local, descending=True, stable=True)
    # float64 holds a float32 score and an index below 2^53 exactly
    cand = torch.stack([top.values[:kl].double(),
                        (top.indices[:kl] + off).double()], dim=1)
    gathered = [torch.empty_like(cand)
                for _ in range(dist.get_world_size(group))]
    dist.all_gather(gathered, cand, group=group)
    cand = torch.cat(gathered)             # rank order: index order
    order = torch.sort(cand[:, 0], descending=True, stable=True).indices
    picked = cand[order[:k], 1].long() - off
    picked = picked[(picked >= 0) & (picked < local.shape[0])]
    mask = torch.zeros(local.shape, dtype=torch.bool, device=local.device)
    mask[picked] = True
    return _like_rows(scores, mask & torch.isfinite(local))


#: histogram resolution of the factored summary (per-feature bin count)
SUMMARY_BINS = 8
#: width of the non-histogram tail of the summary vector
_SUMMARY_TOTALS = 5


def summary_width(n_models: int, n_bins: int = SUMMARY_BINS) -> int:
    """Width of :func:`fleet_summary`: battery and capability histograms
    (``n_bins`` each), per-submodel affordability fractions and 5 fleet
    totals, independent of the fleet's size."""
    return 2 * n_bins + int(n_models) + _SUMMARY_TOTALS


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true float32 division on every device (a CUDA
    division by a host scalar is a product with its reciprocal)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _np_float(t: torch.Tensor):
    """The numpy scalar type of ``t``'s float dtype: the reference's
    scalars are rounded to it (float32 on the engines' fleets, float64 on
    the numpy backend's)."""
    return np.float64 if t.dtype == torch.float64 else np.float32


def _histogram(values: torch.Tensor, weights: torch.Tensor, lo: float,
               hi: float, n_bins: int) -> torch.Tensor:
    """The weights of ``values`` over ``n_bins`` equal bins of [lo, hi),
    summed in float64 and not yet rounded: bin ``trunc((v - lo) / (hi -
    lo) * n_bins)`` in the values' dtype, clipped (``fleet.py:460-472``;
    ``hi - lo`` is rounded to that dtype first, as the reference's
    weak-typed scalar)."""
    scaled = true_div(values - lo, float(_np_float(values)(hi - lo))) * n_bins
    idx = torch.clamp(scaled.to(torch.int32), 0, n_bins - 1)
    onehot = idx[:, None] == torch.arange(n_bins, device=idx.device)
    return (onehot * weights[:, None]).double().sum(dim=0)


def fleet_summary(fleet: FleetState, model_sizes, model_fractions,
                  round_idx=0, n_rounds: int = 1, local_epochs: int = 5,
                  batch_size: int = 32, n_bins: int = SUMMARY_BINS,
                  afford: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The factored QMIX state (``fleet.py:475-535``): a float32 vector of
    :func:`summary_width` features on the fleet's device, whatever the
    fleet's size or order:

    * the alive mass per battery-fraction bin and per effective-compute
      bin (``/ 500``, as the agents' observation), over n;
    * per submodel, the fraction of the fleet that can pay for it;
    * remaining over battery energy, the alive fraction, the mean battery
      fraction and data size (/ 1000) of the alive devices, ``t /
      n_rounds``.

    Computed in the fleet's dtype and rounded to float32 at the end, as
    the reference on either backend (a float64 fleet is the numpy one's).
    ``afford``, an [n, M+1] action mask the caller already holds (the
    selector's, under a budget the budget-masked one), saves pricing the
    fleet twice.  Every fleet sum is taken in float64 (exact for a float32
    fleet's energies, counts and fractions, whatever the order of the
    adds) and rounded once.  On a sharded fleet each rank sums its own
    rows and one ``all_reduce`` adds the float64 sums before that
    rounding: the same bits, and every rank gets the whole vector."""
    n = len(fleet)
    if afford is None:
        afford = fleet_affordability(fleet, model_sizes, model_fractions,
                                     local_epochs, batch_size)
    group = None
    if isinstance(fleet.remaining, DTensor):
        group = _rows(fleet.remaining)[2]
        fleet = fleet.replace(**{f: getattr(fleet, f).to_local() for f in (
            "compute", "battery", "remaining", "data_size", "mode_compute",
            "alive")})
        afford = afford.to_local()
    dt = fleet.remaining.dtype
    np_dt = _np_float(fleet.remaining)
    inv_n = float(np_dt(1.0 / float(n)))
    alive = fleet.alive.to(dt)
    batt_frac = fleet.remaining / fleet.battery
    eff = true_div(fleet.compute * fleet.mode_compute, 500.0)
    sums = torch.cat([
        _histogram(batt_frac, alive, 0.0, 1.0 + 1e-9, n_bins),
        _histogram(eff, alive, 0.0, 2.0, n_bins),
        afford[:, :-1].double().sum(dim=0),
        torch.stack([x.double().sum() for x in (
            fleet.remaining, fleet.battery, alive, batt_frac * alive,
            fleet.data_size * alive)])])
    if group is not None:
        dist.all_reduce(sums, group=group)
    sums = sums.to(dt)                       # the one rounding
    hist_b, hist_c, afford_sum, rest = torch.split(
        sums, [n_bins, n_bins, afford.shape[1] - 1, 5])
    rem, batt, n_live, frac_live, data_live = rest
    n_alive = torch.clamp_min(n_live, 1.0)
    t = np_dt(round_idx) / np_dt(max(int(n_rounds), 1))
    totals = torch.stack([
        rem / batt, n_live * inv_n, frac_live / n_alive,
        true_div(data_live / n_alive, 1000.0),
        torch.full((), float(t), dtype=dt, device=sums.device)])
    return torch.cat([hist_b * inv_n, hist_c * inv_n, afford_sum * inv_n,
                      totals]).float()


# Array fields :func:`fleet_summary` does not read directly, as the
# reference lists them: the powers and bandwidth enter through the cost
# model only, ``busy_until`` is the async engine's mirror, and the energy
# scenario's profile arrays show through the battery histogram
SUMMARY_EXCLUDED_FIELDS = ("p_train", "p_com", "bandwidth", "mode_power",
                           "busy_until", "charge_rate", "tz_phase")
