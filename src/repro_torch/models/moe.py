"""Mixture-of-Experts FFN (token-choice top-k router, capacity dispatch) —
port of ``repro.models.moe``.

Two execution paths, as in the reference:

* **capacity dispatch** (training / prefill, ``S > 1``): the tokens of
  each sequence row are scattered into expert buffers ``[B, E, C, d]``
  (capacity ``C = max(K, ceil(S*K/E * capacity_factor))``), the experts
  run as batched matrix products over the stacked ``[E, d, f]`` tensors,
  and the results gather back.  A token's slot in its expert's buffer is
  its rank among the row's ``S*K`` choices in token-major, choice-minor
  order; choices past ``C`` are dropped (their rows zero, written to slot
  ``C - 1`` by an ADDING scatter, so a kept token there keeps its value).
* **gather path** (decode, ``S == 1``): each token's experts' weights are
  gathered (``[B, K, d, f]`` a weight) and applied directly; under
  ``moe_decode_impl="dispatch"`` the batch goes through the capacity
  dispatch as one sequence.

The router runs in float32 and returns a Switch-style load-balance aux
loss beside the output.  Its token means are the whole batch's: under
an activation mesh (``sharding/rules.py::set_activation_mesh``), where
each batch rank holds an equal shard, they are averaged over the batch
axes, as the reference's SPMD mean is global (:func:`batch_mean`).  Within :func:`routes` it records each call's
top-k indices, or takes given ones in their place, so that two forwards
that round differently can be held against each other on one routing.
The expert products are plain ``einsum`` (cuBLAS batched products), as
the reference's are plain XLA products outside any Pallas kernel.  Initialisation draws each expert's matrix on
its own (:func:`repro_torch.models.layers.normal_by_matrix`), so a
stack of bf16 experts never exists in float32 whole.

On the production mesh (``launch/train.py::meshed_step``: ``x`` and the
params ``DTensor``s) the capacity dispatch splits over the model axis as
the rules place the experts (:func:`_moe_sharded`): each rank's experts
(``E`` over ``model`` where it divides, else every expert at its shard
of the FFN width) run on the dispatch buffer's slice for them, and the
combine is a partial sum over ``model``; no expert weight is gathered.
The router stays replicated, and the load-balance loss is taken on each
rank's own rows with the batch's token means (:func:`batch_mean`).  At
S == 1 (decode) the gather path runs in the same region: each rank's
choices of the experts its shard holds (or, where ``E`` does not divide
the model axis, every choice at its shard of the FFN width), the
combine a partial sum over ``model``; ``moe_decode_impl="dispatch"``
puts the whole batch through the capacity region as one sequence.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.models import layers as L
from repro_torch.sharding import tp
from repro_torch.sharding.rules import activation_mesh, batch_axes, mesh_size


def moe_init(gen: torch.Generator, cfg, dtype, *, lead=()):
    """``moe.py:28-37``: the float32 router ``[d, E]``, and ``w_gate``,
    ``w_up`` ``[E, d, f]`` and ``w_down`` ``[E, f, d]`` in ``dtype``
    (``lead``: the layer stack in front of each)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = 1.0 / math.sqrt(d)
    return {
        "router": L._normal(gen, (d, E), s, torch.float32, lead),
        "w_gate": L.normal_by_matrix(gen, (E, d, f), s, dtype, lead),
        "w_up": L.normal_by_matrix(gen, (E, d, f), s, dtype, lead),
        "w_down": L.normal_by_matrix(gen, (E, f, d), 1.0 / math.sqrt(f),
                                     dtype, lead),
    }


#: set within :func:`routes`: (the list each router call appends its
#: top-k indices to, an iterator of indices that replace the top-k or None)
_ROUTES = None


@contextlib.contextmanager
def routes(replay=None):
    """Within ``with``: each router call's top-k indices, layer by layer,
    appended to the list it yields (empty for a model without experts).
    Given ``replay`` (such a list), the router takes those indices in
    place of its own top-k, its weights the gates there, renormalised as
    ever, so two forwards that round differently route alike."""
    global _ROUTES
    seen = []
    _ROUTES = (seen, None if replay is None else iter(replay))
    try:
        yield seen
    finally:
        _ROUTES = None


def batch_mean(t):
    """``t``, a mean over this rank's tokens, as the mean over the batch
    axes of the activation mesh (the ranks hold equal shards); ``t``
    itself without a mesh.  Its gradient stays this rank's own: the
    meshed step (``launch/train.py::meshed_step``) averages the ranks'
    gradients, which makes it the whole batch's."""
    mesh = activation_mesh()
    if mesh is None:
        return t
    axes = batch_axes(mesh)
    n = mesh_size(mesh, axes)
    if n == 1:
        return t
    whole = t.detach().clone()
    for a in axes:
        dist.all_reduce(whole, group=mesh.get_group(a))
    whole = whole / n
    return t + (whole - t).detach() if t.requires_grad else whole


def _gates(p, cfg, x):
    """x: [..., d] -> (the router's softmax [..., E], top-k weights [...,
    K] renormalised, top-k indices [..., K]).

    ``torch.topk`` with ``sorted=True`` gives ``jax.lax.top_k``'s
    descending order, which sets each choice's slot in the dispatch."""
    logits = x.float() @ p["router"]                           # [..., E]
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, cfg.experts_per_token, dim=-1,
                            sorted=True)
    if _ROUTES is not None:
        seen, replay = _ROUTES
        if replay is not None:
            topi = next(replay).to(x.device)
            topw = gates.gather(-1, topi)
        seen.append(topi)
    return gates, topw / (topw.sum(-1, keepdim=True) + 1e-9), topi


def _aux(cfg, gates, topi):
    """The Switch load-balance aux loss of ``gates`` [..., E] and the
    choices ``topi`` [..., K], its token means the batch's
    (:func:`batch_mean`)."""
    K, E = cfg.experts_per_token, cfg.num_experts
    me = batch_mean(gates.reshape(-1, E).mean(0))
    onehot = F.one_hot(topi, E).float()
    ce = batch_mean(onehot.sum(-2).reshape(-1, E).mean(0) / K)
    return E * torch.sum(me * ce)


def _route(p, cfg, x):
    """x: [..., d] -> (weights [..., K], idx [..., K], aux_loss)."""
    gates, topw, topi = _gates(p, cfg, x)
    return topw, topi, _aux(cfg, gates, topi)


def capacity(S, K, E, capacity_factor):
    """Each expert's slots a sequence row: ``max(K, ceil(S*K/E * cf))``."""
    return max(K, int(math.ceil(S * K / E * capacity_factor)))


def slots(flat_e, E):
    """flat_e: [B, T] expert ids, token-major and choice-minor -> [B, T]:
    each choice's rank among its row's choices of that expert, its slot in
    the expert's buffer (dropped where it reaches the capacity)."""
    onehot = F.one_hot(flat_e, E)                              # [B, T, E]
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot
    return torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0]


def _experts(p, xb):
    """xb: [..., E, C, d] -> [..., E, C, d]: each expert's SwiGLU on its
    buffer."""
    h = F.silu(torch.einsum("...ecd,edf->...ecf", xb, p["w_gate"]))
    h = h * torch.einsum("...ecd,edf->...ecf", xb, p["w_up"])
    return torch.einsum("...ecf,efd->...ecd", h, p["w_down"])


def moe_apply(p, cfg, x, *, capacity_factor: float = 0.0):
    """x: [B, S, d] -> (y [B, S, d], aux_loss)."""
    if isinstance(p["router"], DTensor):
        return _moe_sharded(p, cfg, x, capacity_factor)
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    if S == 1:
        if cfg.moe_decode_impl == "dispatch":
            # decode through the capacity dispatch, batch as sequence
            y, aux = moe_apply(p, cfg, x.transpose(0, 1),
                               capacity_factor=capacity_factor or 2.0)
            return y.transpose(0, 1), aux
        return _moe_gather(p, cfg, x)
    capacity_factor = capacity_factor or cfg.moe_capacity_factor
    topw, topi, aux = _route(p, cfg, x)                        # [B,S,K]
    return _dispatch(p, cfg, x, topw, topi, capacity_factor, 0, E), aux


def _dispatch(p, cfg, x, topw, topi, capacity_factor, lo, hi):
    """The capacity dispatch, the experts ``lo``..``hi - 1`` (``p``'s
    expert leaves hold those) and the combine: x [B, S, d], the top-k
    ``topw`` and ``topi`` [B, S, K] -> y [B, S, d], the sum over the
    choices of those experts (all of them: the whole output)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity(S, K, E, capacity_factor)

    flat_e = topi.reshape(B, S * K)                            # [B, T]
    pos = slots(flat_e, E)                                     # [B, T]
    keep = (pos < C).to(x.dtype)
    pos = pos.clamp_max(C - 1)
    # the choices of this expert range, their experts counted from lo
    mine = (flat_e >= lo) & (flat_e < hi)
    keep = keep * mine.to(x.dtype)
    ex = (flat_e - lo).clamp(0, hi - lo - 1)

    xr = x.repeat_interleave(K, dim=1)                         # [B, T, d]
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    buf = x.new_zeros((B, hi - lo, C, d)).index_put(
        (bidx, ex, pos), xr * keep[..., None], accumulate=True)
    yb = _experts(p, buf)                                      # [B,E,C,d]
    y = yb[bidx, ex, pos] * keep[..., None]                    # [B, T, d]
    y = y.reshape(B, S, K, d) * topw[..., None].to(x.dtype)
    return y.sum(dim=2)


def _moe_sharded(p, cfg, x, capacity_factor):
    """:func:`moe_apply`'s capacity dispatch on the mesh, x in the compute
    layout, in two regions.  The router, replicated on ``model`` (its
    ``("embed", None)`` spec): softmax and top-k on every model rank
    alike; the aux loss on this rank's own rows.  The experts: each rank
    runs the experts its shard holds (``E`` over ``model``, the
    ``("expert", "embed", "mlp")`` spec) on the dispatch buffer's slice
    for them, or, where ``E`` does not divide the model axis, every
    expert at its shard of the FFN width (``"mlp"``); either way the
    combine is a partial sum over ``model``."""
    B, S, d = x.shape
    if S == 1 and cfg.moe_decode_impl == "dispatch":
        return _moe_dispatch_decode(p, cfg, x, capacity_factor or 2.0)
    capacity_factor = capacity_factor or cfg.moe_capacity_factor
    gates, topw, topi = _gates({"router": tp.weight(p["router"])}, cfg,
                               tp.local(x))
    gates, topw = tp.wrap(gates), tp.wrap(topw)
    aux = _aux(cfg, tp.own_rows(gates), tp.own_slice(topi))
    E = cfg.num_experts
    names = ("w_gate", "w_up", "w_down")
    sharded = tp.model_shard_dim(p["w_gate"]) is not None
    lo, hi = tp.model_range(p["w_gate"], p["w_gate"].ndim - 3)
    grad = Partial() if sharded else Replicate()
    local = {n: tp.weight(p[n]) for n in names}
    xl, wl = tp.local(x, grad=grad), tp.local(topw, grad=grad)
    if S == 1:
        y = _gather_experts(local, cfg, xl, wl, topi, lo, hi)
    else:
        y = _dispatch(local, cfg, xl, wl, topi, capacity_factor, lo, hi)
    assert hi - lo == E or tp.model_shard_dim(p["w_gate"]) == 0, (lo, hi)
    return tp.wrap(y, grad), aux


def _moe_dispatch_decode(p, cfg, x, capacity_factor):
    """``moe_decode_impl="dispatch"`` on the mesh: the batch as one
    sequence through the capacity region's experts, whose slots couple
    the rows, so every rank takes the whole batch (its rows gathered over
    the batch axes) and keeps its own rows of the output."""
    m = tp.mesh()
    whole = (Replicate(),) * m.ndim
    xs = tp.to_local(x.redistribute(m, whole), whole).transpose(0, 1)
    gates, topw, topi = _gates({"router": tp.weight(p["router"])}, cfg, xs)
    lo, hi = tp.model_range(p["w_gate"], p["w_gate"].ndim - 3)
    y = _dispatch({n: tp.weight(p[n]) for n in ("w_gate", "w_up", "w_down")},
                  cfg, xs, topw, topi, capacity_factor, lo, hi)
    part = Partial() if tp.model_shard_dim(p["w_gate"]) is not None \
        else Replicate()
    y = tp.from_local(y.transpose(0, 1).contiguous(),
                      tuple(part if i == tp.model_dim(m) else Replicate()
                            for i in range(m.ndim)), mesh=m)
    return (y.redistribute(m, tp.compute_placements(m, part)),
            _aux(cfg, gates, topi))


def _moe_gather(p, cfg, x):
    """Decode path: gather each token's experts' weights.  x: [B, 1, d]."""
    topw, topi, aux = _route(p, cfg, x)                        # [B,1,K]
    return _gather_experts(p, cfg, x, topw, topi, 0, cfg.num_experts), aux


def _gather_experts(p, cfg, x, topw, topi, lo, hi):
    """The gather path's experts and combine: x [B, 1, d], the top-k
    ``topw`` and ``topi`` [B, 1, K] -> y [B, 1, d], each token's sum over
    its choices of the experts ``lo``..``hi - 1`` (``p``'s expert leaves
    hold those, at the FFN width they hold): every choice's weights
    gathered from ``p`` (a choice of another expert reads the nearest
    held one, and its product is zeroed)."""
    ti = topi[:, 0]                                            # [B, K]
    xt = x[:, 0]                                               # [B, d]
    mine = (ti >= lo) & (ti < hi)
    ti = (ti - lo).clamp(0, hi - lo - 1)
    h = F.silu(torch.einsum("bd,bkdf->bkf", xt, p["w_gate"][ti]))
    h = h * torch.einsum("bd,bkdf->bkf", xt, p["w_up"][ti])
    y = torch.einsum("bkf,bkfd->bkd", h, p["w_down"][ti])
    if hi - lo < cfg.num_experts:
        y = y * mine[..., None].to(y.dtype)
    y = (y * topw[:, 0, :, None].to(x.dtype)).sum(dim=1)
    return y[:, None, :]
