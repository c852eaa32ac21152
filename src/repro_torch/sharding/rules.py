"""Name-based sharding rules with divisibility fallback — port of
``repro.sharding.rules``.

Logical axes are inferred from parameter *path suffixes* (the same names
the model modules use); each logical axis maps to a mesh axis through
:data:`LOGICAL_TO_MESH`.  Rules silently fall back to replication when a
dimension is not divisible by the mesh-axis size — this is what lets one
rule table cover every architecture (e.g. mixtral's 8 experts cannot shard
over a 16-way model axis, so its experts replicate and the expert FFN
width shards instead).

The batch ("data-parallel") axes are ``("pod", "data")`` on the multi-pod
mesh and ``("data",)`` on the single-pod mesh; weights are FSDP-sharded
over ``data`` only (each pod holds the full FSDP shard group — the FL
mapping: pods are DR-FL clients and exchange weights by layer-aligned
aggregation over the ``pod`` axis).

A spec is a plain tuple with one entry per tensor dim: ``None``, a mesh
axis name, or a tuple of names (the reference's ``PartitionSpec``).
:func:`placements` turns one into a ``DTensor``'s placements on a
:class:`~torch.distributed.device_mesh.DeviceMesh`.  The spec functions
read only the mesh's axis names and sizes, so they take a ``DeviceMesh``
or any stand-in with ``axis_names`` and a ``shape`` mapping (the
reference's meshes are such), and need no process group.

The activation hooks of the reference (``constrain``,
``constrain_spec``, ``gather_block_input``, ``attn_head_shard``,
``attn_seq_shard``) are not here: they place activations for GSPMD and
change no value, and they take effect once the model axis splits the
compute (ROADMAP Queue 1).  Until then the policy knobs that only steer
them (:data:`HOOK_KNOBS`) keep their keys but refuse another value, and
:func:`activation_spec` has no sequence-parallel branch.  The mesh that
:func:`set_activation_mesh` installs is read by model code that takes a
mean over the batch (``models/moe.py``'s load-balance loss).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

# --- logical-axis rule table -------------------------------------------------
# suffix regex -> logical axes of the *base* (unstacked) param shape,
# rightmost dims.  Leading stacked layer/group dims are padded with None.
RULES: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = (
    (r"embed/emb$",                    ("vocab", "embed")),
    (r"unembed/w$",                    ("embed", "vocab")),
    (r"attn/w[qkv]/w$",                ("embed", "heads")),
    (r"cross/w[qkv]/w$",               ("embed", "heads")),
    (r"attn/wo/w$",                    ("heads", "embed")),
    (r"cross/wo/w$",                   ("heads", "embed")),
    (r"moe/router$",                   ("embed", None)),
    (r"moe/w_gate$",                   ("expert", "embed", "mlp")),
    (r"moe/w_up$",                     ("expert", "embed", "mlp")),
    (r"moe/w_down$",                   ("expert", "mlp", "embed")),
    (r"(mlp|ffn)/w_gate/w$",           ("embed", "mlp")),
    (r"(mlp|ffn)/w_up/w$",             ("embed", "mlp")),
    (r"(mlp|ffn)/w_down/w$",           ("mlp", "embed")),
    (r"(mlp|ffn)/w_in/w$",             ("embed", "mlp")),
    (r"(mlp|ffn)/w_out/w$",            ("mlp", "embed")),
    (r"w_up$",                         ("embed", "mlp")),      # xlstm mLSTM up
    (r"w_down$",                       ("mlp", "embed")),
    (r"w_in$",                         ("embed", "mlp")),      # mamba / slstm in
    (r"w_out$",                        ("mlp", "embed")),
    (r"wq$",                           ("mlp", "heads")),      # xlstm q/k/v (inner,inner)
    (r"wk$",                           ("mlp", "heads")),
    (r"wv$",                           ("mlp", "heads")),
    # sLSTM recurrent weights: replicated.  They are small but live inside
    # the time loop; the reference measured sharding them as an all-reduce
    # of their gradient at every step of the backward scan.
    (r"/r$",                           (None, None, None)),
)

LOGICAL_TO_MESH = {
    "vocab": ("model",),
    "heads": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "embed": ("data",),     # ZeRO/FSDP axis
}

# --- sharding policy (the reference's perf-iteration knobs) -------------------
# fsdp=False        -> weights replicated over 'data' (pure TP+DP).
# act_model=False   -> residual stream replicated over 'model'.
_POLICY = {"fsdp": True, "act_model": True, "repeat_kv": False,
           "zero1": False, "attn_seq": False, "attn_heads": False,
           "act_seq": False, "block_gather": False, "dp2d": False}

#: the knobs that steer only the activation hooks, which wait for the
#: tensor-parallel slice: their defaults are the only values taken
HOOK_KNOBS = ("act_model", "attn_seq", "attn_heads", "act_seq",
              "block_gather")


def set_sharding_policy(*, fsdp: Optional[bool] = None,
                        act_model: Optional[bool] = None,
                        repeat_kv: Optional[bool] = None,
                        zero1: Optional[bool] = None,
                        attn_seq: Optional[bool] = None,
                        attn_heads: Optional[bool] = None,
                        act_seq: Optional[bool] = None,
                        block_gather: Optional[bool] = None,
                        dp2d: Optional[bool] = None):
    """repeat_kv: materialise repeated KV heads inside attention
    (``models/layers.py::gqa_attend``) so the query-head axis is a pure
    batch dim of the score products.  zero1: with fsdp=False, keep
    optimizer moments sharded over 'data' (ZeRO-1) — replicated weights,
    sharded optimizer state.  A knob of :data:`HOOK_KNOBS` set away from
    its default raises ``NotImplementedError``."""
    new = dict(fsdp=fsdp, act_model=act_model, repeat_kv=repeat_kv,
               zero1=zero1, attn_seq=attn_seq, attn_heads=attn_heads,
               act_seq=act_seq, block_gather=block_gather, dp2d=dp2d)
    for k in HOOK_KNOBS:
        if new[k] is not None and new[k] != _POLICY[k]:
            raise NotImplementedError(
                f"sharding policy {k}={new[k]} steers the activation "
                f"hooks, which the port has not yet (the tensor-parallel "
                f"mesh slice)")
    for k, v in new.items():
        if v is not None:
            _POLICY[k] = v


def get_sharding_policy():
    return dict(_POLICY)


# --- meshes ------------------------------------------------------------------


def _axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in mesh order."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def batch_axes(mesh):
    """Mesh axes carrying the global batch.

    Under the ``dp2d`` policy the model axis joins the batch axes (every
    device holds whole sequences); the pod axis stays a pure
    replication/aggregation axis (in the FL mapping each pod-client sees
    its own global batch and aggregates over 'pod')."""
    names = tuple(_axes(mesh))
    if _POLICY.get("dp2d"):
        return tuple(a for a in ("data", "model") if a in names)
    return tuple(a for a in ("pod", "data") if a in names)


def mesh_size(mesh, axes) -> int:
    """Ranks along the named mesh axes."""
    sizes = _axes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def spec_for(path: str, shape, mesh, force_fsdp: bool = False) -> tuple:
    """The spec of one param leaf. 1-D/0-D params replicate."""
    ndim = len(shape)
    if ndim <= 1:
        return (None,) * ndim
    for pat, logical in RULES:
        if re.search(pat, path):
            base = list(logical)
            pad = ndim - len(base)
            if pad < 0:           # shape smaller than rule (shouldn't happen)
                return (None,) * ndim
            axes = [None] * pad + base
            out, used = [], set()
            for dim, name in zip(shape, axes):
                if name is None:
                    out.append(None)
                    continue
                if name == "embed" and not (_POLICY["fsdp"] or force_fsdp):
                    out.append(None)
                    continue
                mesh_axes = LOGICAL_TO_MESH.get(name, ())
                if (mesh_axes and not (set(mesh_axes) & used)
                        and dim % mesh_size(mesh, mesh_axes) == 0):
                    used.update(mesh_axes)
                    out.append(mesh_axes[0] if len(mesh_axes) == 1
                               else tuple(mesh_axes))
                else:
                    out.append(None)
            return tuple(out)
    return (None,) * ndim


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (an
    xLSTM cache's state is a tuple), ``path`` the keys and indices joined
    by ``/`` as the reference's ``_path_str`` joins them.  In the result a
    tuple of the tree is a list: a spec is itself a tuple, and a tree of
    specs keeps its containers apart from its leaves."""
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, join(i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(params_shape, mesh, force_fsdp: bool = False):
    """The params' tree with each leaf's spec (leaves: anything with a
    ``shape``, such as meta tensors)."""
    return map_with_path(
        lambda path, leaf: spec_for(path, leaf.shape, mesh, force_fsdp),
        params_shape)


def cache_specs(cache_shape, mesh):
    """Decode-cache specs.

    KV caches are [..., batch, seq, kv_heads, head_dim]; recurrent states are
    [..., batch, heads, ...].  Strategy: shard batch over the data axes when
    divisible; then kv_heads over 'model' when divisible, else the seq dim.
    """
    b_axes = batch_axes(mesh)
    b_size = mesh_size(mesh, b_axes)
    m_size = _axes(mesh)["model"]
    b_entry = b_axes if len(b_axes) > 1 else b_axes[0]

    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        if ndim <= 1 or path.endswith("pos"):
            return (None,) * ndim
        out = [None] * ndim
        if path in ("k", "v") or path.endswith("/k") or path.endswith("/v"):
            bdim, sdim, hdim, ddim = ndim - 4, ndim - 3, ndim - 2, ndim - 1
            if shape[bdim] % b_size == 0 and shape[bdim] >= b_size:
                out[bdim] = b_entry
            if shape[hdim] % m_size == 0:
                out[hdim] = "model"
            elif shape[sdim] % m_size == 0:
                # the reference measured seq-dim sharding cheaper than
                # head_dim sharding's score all-reduces
                out[sdim] = "model"
            elif shape[ddim] % m_size == 0:
                out[ddim] = "model"
        else:
            # recurrent / conv states: (stack?, B, H or C, ...)
            bdim = 1 if ndim >= 3 else 0
            if shape[bdim] % b_size == 0 and shape[bdim] >= b_size:
                out[bdim] = b_entry
            for d in range(bdim + 1, ndim):
                if shape[d] % m_size == 0:
                    out[d] = "model"
                    break
        return tuple(out)

    return map_with_path(leaf_spec, cache_shape)


def placements(spec: tuple, mesh) -> tuple:
    """A spec as ``DTensor`` placements on ``mesh``, one per mesh dim: a
    mesh dim named in entry ``d`` is ``Shard(d)``, the others
    ``Replicate()``.  Two mesh dims on one tensor dim shard it in mesh
    order, as the reference's tuple entries do."""
    out = []
    for name in _axes(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


# --- the activation mesh (set by the train main) -----------------------------

#: a module global, not the reference's thread-local: autograd runs the
#: backward, and the remat recompute in it, on a thread of its own on the
#: card, and the recompute must read the same mesh as the forward
_ACTIVATION_MESH = None


def set_activation_mesh(mesh, model_axis_ok: bool = True):
    """Install the mesh that model code reads (None: no mesh).
    ``model_axis_ok=False`` (never shard the feature dim) steers only the
    activation hooks and raises ``NotImplementedError``."""
    global _ACTIVATION_MESH
    if not model_axis_ok:
        raise NotImplementedError(
            "model_axis_ok=False steers the activation hooks, which the "
            "port has not yet (the tensor-parallel mesh slice)")
    _ACTIVATION_MESH = mesh


def activation_mesh():
    """The mesh :func:`set_activation_mesh` installed, or None."""
    return _ACTIVATION_MESH


def activation_spec(mesh, ndim: int, model_ok: bool = True) -> tuple:
    """The batch over the batch axes, the feature dim over ``model``
    (the reference's, without ``act_seq``'s branch: see
    :data:`HOOK_KNOBS`)."""
    b = batch_axes(mesh)
    spec = [None] * ndim
    spec[0] = b if len(b) > 1 else b[0]
    if model_ok and ndim >= 3 and not _POLICY.get("dp2d"):
        spec[-1] = "model"
    return tuple(spec)
