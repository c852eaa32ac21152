"""Tensor-parallel regions on a ``DeviceMesh``: the port's counterpart of
the reference's GSPMD partitioning of every LM family.

The reference writes its models once and lets GSPMD split them by the
params' specs (``sharding/rules.py``) and the activation hooks.  The
port keeps each param a ``DTensor`` in the placements those specs name,
and splits the compute by hand in *regions*: a region takes
``DTensor``s in placements it states, computes on their local tensors
with the same operations as the one-device code, and returns
``DTensor``s in placements it states.  Between regions, ``DTensor``'s
own ``redistribute`` (the activation hooks among them) moves the data,
and its backward moves the gradient.

A region states, for each input, the placements of the gradient its
local backward computes: ``Shard`` (each rank's gradient of its own
shard), ``Replicate`` (every rank the whole gradient, as replicated
compute gives it) or ``Partial`` (the ranks' gradients sum to the whole,
as a product that contracts over a sharded dim gives it).
:func:`to_local` reduces that gradient to the input's own placements, so
every tensor's gradient keeps its tensor's placements and the step's
gradients come back with the params' (``launch/train.py::meshed_step``).

The layouts (``rows`` below are the leading, batch dim):

* **the compute layout** (:func:`compute_placements`): rows over the
  batch axes other than ``model``, every feature whole on the model
  axis.  The norms and the router run there, replicated over ``model``,
  and the column-parallel products start there.  Under ``dp2d`` the
  model axis carries batch rows too; the port gathers the model group's
  rows into this layout and keeps the weights in their shards, where the
  reference's GSPMD gathers each layer's weights instead (ZeRO-3
  streaming): the values are the same.
* **the own-rows layout** (:func:`own_placements`): rows over every
  batch axis, each rank its own shard of the batch; the loss and the
  load-balance loss are taken there, so that the meshed step's mean
  over the batch ranks is the batch's mean.
* **weights** (:func:`weight`): gathered over every axis but ``model``
  (FSDP's gather, once a use: inside the remat wrapper, again in the
  recompute), kept in their model shard (heads, MLP width, vocab,
  experts).  No region gathers a param over the model axis.
* **decode caches and recurrent states**: ``DTensor``s in the
  reference's cache placements (``rules.cache_specs``), each layer a
  view of this rank's shard (:func:`layer`), its block on a sharded dim
  read by :func:`model_range` and written in place (:func:`put`).  No
  region gathers a cache or state leaf over the model axis.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding.rules import activation_mesh, batch_axes


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


class _ToLocal(torch.autograd.Function):
    """A ``DTensor``'s local tensor (a view of it: the tensor the
    ``DTensor`` holds must not take this node as its grad_fn, or a param
    and its graph would hold each other alive); its local gradient, read
    under the stated placements, is redistributed to the ``DTensor``'s
    own."""

    @staticmethod
    def forward(ctx, x, grad_placements):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        ctx.shape, ctx.stride = x.shape, x.stride()
        ctx.grad_placements = tuple(grad_placements)
        local = x.to_local()
        return local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        move = ctx.grad_placements != ctx.placements
        d = DTensor.from_local(g.contiguous() if move else g, ctx.mesh,
                               ctx.grad_placements, run_check=False,
                               shape=ctx.shape, stride=ctx.stride)
        if move:
            d = d.redistribute(ctx.mesh, ctx.placements)
        return d, None


class _FromLocal(torch.autograd.Function):
    """A local tensor as a ``DTensor`` in the stated placements; its
    gradient arrives redistributed to them (a ``Partial`` output's as
    ``Replicate``: each rank's summand takes the whole gradient)."""

    @staticmethod
    def forward(ctx, t, mesh, placements, shape, stride):
        ctx.mesh = mesh
        ctx.target = tuple(Replicate() if p.is_partial() else p
                           for p in placements)
        return DTensor.from_local(t, mesh, placements, run_check=False,
                                  shape=shape, stride=stride)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor):
            if tuple(g.placements) != ctx.target:
                g = g.redistribute(ctx.mesh, ctx.target)
            g = g.to_local()
        return g, None, None, None, None


def to_local(x: DTensor, grad_placements: Sequence) -> torch.Tensor:
    """``x``'s local tensor, differentiable: its gradient is read under
    ``grad_placements`` and reduced to ``x``'s placements."""
    return _ToLocal.apply(x, tuple(grad_placements))


def from_local(t: torch.Tensor, placements: Sequence, shape=None,
               mesh=None) -> DTensor:
    """``t`` as this rank's local tensor of a ``DTensor`` in
    ``placements`` on ``mesh`` (the activation mesh by default), of the
    global ``shape`` (by default: even shards)."""
    mesh = mesh or activation_mesh()
    placements = tuple(placements)
    if shape is None:
        shape = list(t.shape)
        for i, p in enumerate(placements):
            if isinstance(p, Shard):
                shape[p.dim] *= mesh.size(i)
    shape = torch.Size(shape)
    return _FromLocal.apply(t, mesh, placements, shape,
                            _contiguous_stride(shape))


# ---------------------------------------------------------------------------
# the mesh and its layouts
# ---------------------------------------------------------------------------


def mesh():
    """The activation mesh (``rules.set_activation_mesh``)."""
    m = activation_mesh()
    if m is None:
        raise RuntimeError("a tensor-parallel region needs the activation "
                           "mesh (rules.set_activation_mesh)")
    return m


def names(m=None) -> tuple:
    return tuple((m or mesh()).mesh_dim_names)


def model_dim(m=None) -> int:
    """The index of the ``model`` mesh dim."""
    return names(m).index("model")


def model_size(m=None) -> int:
    m = m or mesh()
    return m.size(model_dim(m))


def model_rank(m=None) -> int:
    """This rank's coordinate on the model axis."""
    m = m or mesh()
    return m.get_coordinate()[model_dim(m)]


def model_group(m=None):
    """The model axis's process group, or None where it has one rank."""
    m = m or mesh()
    return m.get_group("model") if model_size(m) > 1 else None


def row_axes(m=None) -> tuple:
    """The mesh axes over which the compute layout's rows differ: the
    batch axes but ``model``."""
    return tuple(a for a in batch_axes(m or mesh()) if a != "model")


def compute_placements(m=None, model=Replicate()) -> tuple:
    """The compute layout (rows over :func:`row_axes`), ``model`` on the
    model axis."""
    m = m or mesh()
    rows = row_axes(m)
    return tuple(model if a == "model" else
                 Shard(0) if a in rows else Replicate() for a in names(m))


def own_placements(m=None) -> tuple:
    """The own-rows layout: rows over every batch axis."""
    m = m or mesh()
    b = batch_axes(m)
    return tuple(Shard(0) if a in b else Replicate() for a in names(m))


def local(x: DTensor, model=Replicate(), grad=None) -> torch.Tensor:
    """``x`` in the compute layout (``model`` on the model axis), as its
    local tensor, whose gradient is read with ``grad`` on the model axis
    (by default the placement itself)."""
    m = mesh()
    target = compute_placements(m, model)
    if tuple(x.placements) != target:
        x = x.redistribute(m, target)
    return to_local(x, compute_placements(m, model if grad is None
                                          else grad))


def wrap(t: torch.Tensor, model=Replicate(), shape=None) -> DTensor:
    """A region's output ``t`` (compute-layout rows) as a ``DTensor``,
    ``model`` on the model axis."""
    return from_local(t, compute_placements(mesh(), model), shape)


def weight(w: DTensor, model_grad=Replicate()) -> torch.Tensor:
    """A param's local compute tensor: gathered over every mesh axis but
    ``model`` (FSDP), kept in its model shard.  Its gradient is read as
    ``Partial`` over the rows' axes, in its shard where it has one on
    ``model``, and as ``model_grad`` where it is whole there (Replicate
    where the region computes with it alike on every model rank, Partial
    where each rank uses a part of it)."""
    m = mesh()
    rows, mi = row_axes(m), model_dim(m)
    pl = tuple(w.placements)
    compute = tuple(p if i == mi else Replicate() for i, p in enumerate(pl))
    grad = []
    for i, (a, p) in enumerate(zip(names(m), compute)):
        if isinstance(p, Shard):
            grad.append(p)
        elif i == mi:
            grad.append(model_grad)
        else:
            grad.append(Partial() if a in rows else Replicate())
    if compute != pl:
        w = w.redistribute(m, compute)
    return to_local(w, grad)


def model_shard_dim(w: DTensor):
    """The tensor dim ``w`` shards over ``model``, or None."""
    p = w.placements[model_dim(w.device_mesh)]
    return p.dim if isinstance(p, Shard) else None


def model_range(w: DTensor, dim: int):
    """This rank's (start, stop) on ``w``'s tensor dim ``dim`` (the whole
    dim where ``model`` does not shard it; even shards, as the rules
    give)."""
    n = w.shape[dim]
    if model_shard_dim(w) != dim:
        return 0, n
    size = n // model_size(w.device_mesh)
    r = model_rank(w.device_mesh)
    return r * size, (r + 1) * size


def unstack(p: DTensor, n: int):
    """A stacked param [L, ...] as its L layers' ``DTensor``s, each a
    view of this rank's shard (the stack dim is never sharded)."""
    pl = tuple(Shard(s.dim - 1) if isinstance(s, Shard) else s
               for s in p.placements)
    mesh_ = p.device_mesh
    parts = torch.unbind(to_local(p, p.placements))
    assert len(parts) == n, (len(parts), n)
    return [from_local(t, pl, p.shape[1:], mesh=mesh_) for t in parts]


def first_layers(p: DTensor, k: int) -> DTensor:
    """A stacked param's first ``k`` layers, a view of this rank's
    shard."""
    return from_local(to_local(p, p.placements)[:k], p.placements,
                      (k,) + tuple(p.shape[1:]), mesh=p.device_mesh)


def group_rows(t: torch.Tensor) -> torch.Tensor:
    """A plain per-rank batch tensor (tokens, labels: the own-rows layout)
    with the compute layout's rows: under ``dp2d`` the model group's rows
    gathered in rank order, else ``t`` itself."""
    m = mesh()
    if "model" not in batch_axes(m) or model_size(m) == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(model_size(m))]
    dist.all_gather(parts, t.contiguous(), group=model_group(m))
    return torch.cat(parts)


def own_rows(x: DTensor) -> torch.Tensor:
    """A compute-layout ``DTensor`` (whole on ``model``) as this rank's
    own rows, local: under ``dp2d`` its slice of the model group's rows."""
    m = mesh()
    target = own_placements(m)
    if tuple(x.placements) != target:
        x = x.redistribute(m, target)
    return to_local(x, target)


def batch_input(t: torch.Tensor) -> DTensor:
    """A per-rank batch input (this rank's own rows of a stub-frontend
    input, ``launch/train.py::batch_shard``) as a ``DTensor`` in the
    own-rows layout."""
    return from_local(t, own_placements())


def pointwise_param(g: DTensor, like: DTensor) -> torch.Tensor:
    """A param that every rank holds whole (a VLM cross layer's gate), as
    the local tensor of a pointwise use with ``like``'s local tensor: its
    gradient is read as ``Partial`` on the mesh dims that shard ``like``
    (each rank's sum over its own elements) and ``Replicate`` on the
    others."""
    whole = (Replicate(),) * g.device_mesh.ndim
    if tuple(g.placements) != whole:
        g = g.redistribute(g.device_mesh, whole)
    return to_local(g, tuple(Partial() if p.is_shard() else Replicate()
                             for p in like.placements))


def own_slice(t: torch.Tensor) -> torch.Tensor:
    """A plain compute-layout tensor's own rows (no gradient)."""
    m = mesh()
    if "model" not in batch_axes(m) or model_size(m) == 1:
        return t
    return t.chunk(model_size(m))[model_rank(m)]


class _SumOverModel(torch.autograd.Function):
    """The sum of the model ranks' partial values, whose result every
    rank then uses alike: its gradient is each summand's (the reference
    GSPMD's all-reduce of a partial sum)."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_model(t: torch.Tensor) -> torch.Tensor:
    group = model_group()
    return t if group is None else _SumOverModel.apply(t, group)


def whole(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A local activation sharded in even blocks on ``dim`` over
    ``model`` (the compute layout's rows), gathered whole: every rank's
    blocks in rank order."""
    return local(wrap(t, Shard(dim)))


def reduced(t: torch.Tensor, dim=None) -> torch.Tensor:
    """A local partial sum over ``model`` (the compute layout's rows),
    reduced: whole, or this rank's even block of ``dim``."""
    t = wrap(t, Partial())
    return local(t) if dim is None else local(t, Shard(dim))


# ---------------------------------------------------------------------------
# decode caches and recurrent states
# ---------------------------------------------------------------------------


def layer(t, i: int):
    """Layer ``i`` of a stacked decode-cache leaf: ``t[i]``, and for a
    ``DTensor`` the layer's ``DTensor`` over a view of this rank's shard
    (the rules never shard a stack dim), so that a write into its local
    tensor lands in the leaf's own storage."""
    if not isinstance(t, DTensor):
        return t[i]
    pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
               for p in t.placements)
    assert all(not isinstance(p, Shard) or p.dim >= 0 for p in pl), pl
    shape = t.shape[1:]
    return DTensor.from_local(t.to_local()[i], t.device_mesh, pl,
                              run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def local_of(t):
    """A cache leaf's local tensor (``t`` itself where it is plain)."""
    return t.to_local() if isinstance(t, DTensor) else t


def put(dst, src) -> None:
    """Write ``src`` into the cache leaf ``dst`` in place.  ``dst`` a
    ``DTensor``: ``src`` (a ``DTensor`` of its shape) redistributed to
    its placements and copied into its local tensor, or, a local tensor,
    copied where it is that tensor's shape (``dst``'s own shard); the
    storage ``dst`` holds stays its own."""
    if src is dst:
        return
    if isinstance(dst, DTensor):
        if isinstance(src, DTensor):
            if tuple(src.placements) != tuple(dst.placements):
                src = src.redistribute(dst.device_mesh, dst.placements)
            src = src.to_local()
        dst = dst.to_local()
    dst.copy_(src)


# ---------------------------------------------------------------------------
# attention on local shards
# ---------------------------------------------------------------------------


def attention_layout(q: DTensor, k: DTensor, v: DTensor, *, seq_ok: bool):
    """The layout of attention's q [B, Sq, Hq, D], k and v [B, Sk, Hkv, D]
    on their mesh, checked: on each mesh dim all three ``Replicate``, all
    ``Shard(0)`` (batch rows), all ``Shard(2)`` (heads: Hq and Hkv both
    divisible by the dim's ranks, or Hq == Hkv, which shard alike), or,
    with ``seq_ok``, q ``Shard(1)`` (query rows, Sq divisible) with k and
    v ``Replicate``.  Returns (k's and v's gradient placements: partial
    over a query-row dim, each rank's rows seeing all keys; the first
    query row's position on this rank).  Any other placements raise
    ``ValueError``: nothing is gathered here."""
    for name, t in (("k", k), ("v", v)):
        if not isinstance(t, DTensor) or t.device_mesh != q.device_mesh:
            raise ValueError(f"attention on local shards: {name} must be a "
                             "DTensor on q's mesh")
    m = q.device_mesh
    Hq, Hkv, Sq = q.shape[2], k.shape[2], q.shape[1]
    grad, offset = list(k.placements), 0
    coord = m.get_coordinate()
    for i, (a, b, c) in enumerate(zip(q.placements, k.placements,
                                      v.placements)):
        n = m.size(i)
        if a == b == c and (a.is_replicate() or a == Shard(0)):
            continue
        if a == b == c == Shard(2) and (
                Hq == Hkv or (Hq % n == 0 and Hkv % n == 0)):
            continue
        if seq_ok and a == Shard(1) and b == c == Replicate() and \
                Sq % n == 0 and offset == 0:
            grad[i] = Partial()
            offset = coord[i] * (Sq // n)
            continue
        raise ValueError(
            f"attention on local shards takes q, k, v all replicated, all "
            f"sharded on the batch (dim 0) or on the heads (dim 2, Hq {Hq} "
            f"and Hkv {Hkv} divisible by the {n} ranks)"
            + (", or q on its rows (dim 1) with k and v replicated"
               if seq_ok else "")
            + f"; got q {tuple(q.placements)}, k {tuple(k.placements)}, v "
            f"{tuple(v.placements)} on mesh dim {m.mesh_dim_names[i]!r}")
    return tuple(grad), offset


def attend_local(fn, q: DTensor, k: DTensor, v: DTensor, *, seq_ok: bool,
                 **kw) -> DTensor:
    """``fn(q, k, v, **kw)`` on each rank's local shards of attention's
    inputs (:func:`attention_layout`), the output in q's placements; with
    ``seq_ok``, ``fn``'s ``q_offset`` (the position of q's first row, 0
    unless given) is that of this rank's first query row."""
    grad, offset = attention_layout(q, k, v, seq_ok=seq_ok)
    if seq_ok:
        kw["q_offset"] = kw.get("q_offset", 0) + offset
    o = fn(to_local(q, q.placements), to_local(k, grad), to_local(v, grad),
           **kw)
    return from_local(o, q.placements, q.shape, mesh=q.device_mesh)
