"""The fleet mesh — port of ``repro.sharding.fleet`` on
``torch.distributed``.

The JAX package places :class:`FleetState`'s ``[n]`` arrays on a 1-D
``Mesh`` over a ``"fleet"`` axis of one process's devices, with a
``NamedSharding`` per field, so its jitted kernels run SPMD.  Here the
mesh is a 1-D :class:`~torch.distributed.device_mesh.DeviceMesh` named
``("fleet",)`` over the ranks of the default process group, and each
field becomes a ``DTensor``: ``Shard(0)`` where its length divides the
mesh, ``Replicate()`` otherwise (the reference's divisibility fallback,
``fleet.py:75-96``).  Every rank runs the same program, the selection
step (:func:`repro_torch.core.selection.dual_selection_energy_step`, the
step ``benchmarks/fleet_shard_bench.py`` times) or a selector's
``select``, inside ``torch.distributed.tensor.experimental.
implicit_replication()``, so that the plain tensors it meets (cost
vectors, masks, which every rank holds whole) count as replicated: the
fleet's elementwise Eq. 3-7 ops run on each rank's rows, and the two
reductions write their collectives out (:mod:`repro_torch.core.fleet`):
one ``all_reduce`` of ``summary_width`` float64 sums per
:func:`~repro_torch.core.fleet.fleet_summary`, one ``all_gather`` of 2k
top-k candidates (value, index) per
:func:`~repro_torch.core.fleet.fleet_topk_mask`; host code reads a
sharded field whole only through :func:`repro_torch.device.to_host`.

"Local devices" are the ranks of an initialised default group: on a host
with k cards, ``torchrun --nproc-per-node k`` with each rank on
``cuda:LOCAL_RANK`` and NCCL; on the CPU, gloo.  With no group, or one of
one rank, :func:`maybe_shard_fleet` is a no-op, as the reference below two
devices; ``n_shards`` from 2 to the world size - 1 raises ``ValueError``
(every rank runs the program, so a mesh spans them all).  The engine
does not shard: ``FLConfig.fleet_mesh`` is a no-op on one rank and
refused above one (:func:`repro_torch.fl.engine.check_supported`), since
every rank would run the whole engine, client training included, for
one result.

Public surface, with the reference's names:

* :data:`FLEET_AXIS` — the mesh dimension's name (``"fleet"``);
  :data:`FLEET_RULES` — field-name pattern to logical axes.
* :func:`fleet_mesh` — the 1-D mesh over the default group's ranks.
* :func:`fleet_spec_for` — one field's placements (rule lookup +
  divisibility fallback).
* :func:`fleet_shardings` — ``{field: placements}`` for a fleet.
* :func:`shard_fleet` — every field as a ``DTensor`` on the mesh.
* :func:`shard_agent_array` — one companion ``[n, ...]`` array (GRU
  hidden states, observations) with the same policy.
* :func:`unshard_fleet` — the fleet gathered back to plain tensors.
* :func:`is_sharded` — the fleet's fields live on a mesh of 2 or more.
* :func:`maybe_shard_fleet` — the config's entry (``FLConfig.fleet_mesh``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.fleet import FleetState

#: mesh dimension carrying the fleet's device axis
FLEET_AXIS = "fleet"

#: field-name regex -> logical axes of the array (every FleetState field
#: is 1-D over the fleet today; the table keeps the mapping declarative)
FLEET_RULES: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = (
    (r".*", (FLEET_AXIS,)),
)

LOGICAL_TO_MESH = {FLEET_AXIS: (FLEET_AXIS,)}


def _mesh_size(mesh: DeviceMesh, axes) -> int:
    """Ranks along the named mesh dimensions (the reference's
    ``rules._mesh_size``)."""
    size = 1
    for ax in axes:
        size *= mesh.size(mesh.mesh_dim_names.index(ax))
    return size


def _world() -> int:
    """Ranks of the default group; 1 with no group."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def fleet_mesh(n_shards: Optional[int] = None) -> DeviceMesh:
    """The 1-D ``("fleet",)`` mesh over every rank of the initialised
    default group, on the device type of its backend (``cuda`` for NCCL,
    else ``cpu``).  ``None``, ``0``, ``-1`` and the world size mean all
    ranks; any other count raises ``ValueError`` (every rank runs the
    program, so the mesh spans them all)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("fleet_mesh needs an initialised default "
                           "process group (torch.distributed."
                           "init_process_group)")
    world = dist.get_world_size()
    if n_shards not in (None, 0, -1, world):
        raise ValueError(
            f"fleet_mesh={n_shards} does not span the world size {world}: "
            "every rank runs the program, so the fleet shards over all of "
            "them (fleet_mesh=-1 or the world size; 0 or 1 for none)")
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev_type, list(range(world)),
                      mesh_dim_names=(FLEET_AXIS,))


def fleet_spec_for(name: str, shape, mesh: DeviceMesh) -> tuple:
    """One field's placements: the first matching rule of
    :data:`FLEET_RULES`, ``Shard`` along its fleet dimension where that
    dimension divides the mesh, else ``Replicate()`` (a scalar, too)."""
    if len(shape) == 0:
        return (Replicate(),)
    for pat, logical in FLEET_RULES:
        if re.search(pat, name):
            for dim, (size, ax) in enumerate(zip(shape, logical)):
                axes = LOGICAL_TO_MESH.get(ax, ())
                if (axes and size % _mesh_size(mesh, axes) == 0
                        and size >= _mesh_size(mesh, axes)):
                    return (Shard(dim),)
            return (Replicate(),)
    return (Replicate(),)


def _place(x: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """``x``, which every rank holds whole, as a ``DTensor``: each rank
    keeps its own rows (no collective)."""
    (p,) = placements
    local = (x.chunk(mesh.size(), dim=p.dim)[mesh.get_local_rank()]
             if isinstance(p, Shard) else x)
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False)


def shard_agent_array(x, mesh: DeviceMesh, axis: int = 0) -> DTensor:
    """One per-agent array (``[n, ...]``: the QMIX GRU hidden states, an
    observation matrix) on the mesh, sharded along ``axis`` where that
    dimension divides the mesh, else replicated."""
    x = torch.as_tensor(x)
    size = _mesh_size(mesh, (FLEET_AXIS,))
    if x.dim() > axis and x.shape[axis] % size == 0 and x.shape[axis] >= size:
        return _place(x, mesh, (Shard(axis),))
    return _place(x, mesh, (Replicate(),))


def _array_fields() -> Tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(FleetState)
                 if f.name not in ("tiers", "modes"))


def fleet_shardings(fleet: FleetState, mesh: DeviceMesh) -> dict:
    """``{field: placements}`` for every array field of ``fleet``."""
    return {f: fleet_spec_for(f, tuple(getattr(fleet, f).shape), mesh)
            for f in _array_fields()}


def shard_fleet(fleet: FleetState, mesh: DeviceMesh) -> FleetState:
    """Every array field as a ``DTensor`` on ``mesh`` (sharded over
    :data:`FLEET_AXIS`, replicated where indivisible); each rank must hold
    the same fleet (built from the same seed)."""
    return fleet.replace(**{
        f: _place(getattr(fleet, f), mesh, p)
        for f, p in fleet_shardings(fleet, mesh).items()})


def unshard_fleet(fleet: FleetState) -> FleetState:
    """The fleet gathered back to plain tensors on each rank's device (one
    collective per sharded field; every rank must call it)."""
    return fleet.replace(**{
        f: (getattr(fleet, f).full_tensor()
            if isinstance(getattr(fleet, f), DTensor) else getattr(fleet, f))
        for f in _array_fields()})


def is_sharded(fleet: FleetState) -> bool:
    """True when the fleet's fields live on a mesh of 2 or more ranks."""
    r = fleet.remaining
    return isinstance(r, DTensor) and r.device_mesh.size() > 1


def maybe_shard_fleet(fleet: FleetState, n_shards: int = 0) -> FleetState:
    """The reference's entry for a fleet-mesh count (its
    ``FLConfig.fleet_mesh``; the port's engine does not call it): ``0``
    and ``1`` keep the fleet as it is; otherwise the fleet is sharded over
    every rank of the default group when it has 2 or more (``-1``, or a
    count of at least the world size, as the reference's ``min(n_shards,
    devices)``), and returned unchanged with no group or a group of one.
    A count from 2 to the world size - 1 raises ``ValueError``."""
    if int(n_shards) in (0, 1):
        return fleet
    world = _world()
    want = world if n_shards == -1 else min(int(n_shards), world)
    if want < 2:
        return fleet
    if want < world:
        raise ValueError(
            f"fleet_mesh={n_shards} shards over fewer ranks than the world "
            f"size {world}: every rank runs the program, so the fleet shards "
            "over all of them (fleet_mesh=-1 or >= the world size)")
    return shard_fleet(fleet, fleet_mesh())
