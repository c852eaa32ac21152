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

The activation hooks of the reference (:func:`constrain`,
:func:`constrain_spec`, :func:`gather_block_input`,
:func:`attn_head_shard`, :func:`attn_seq_shard`) take the same specs
and fallbacks.  Where the reference constrains a traced array for
GSPMD, the port redistributes a ``DTensor`` to the spec's placements; a
plain tensor (a rank that holds it whole, or no mesh) passes unchanged,
so model code calls them unconditionally.  Each hook's spec comes from a
function of the mesh and the shape alone (:func:`residual_spec`,
:func:`block_input_spec`, :func:`attn_head_specs`,
:func:`attn_seq_specs`), which the tests hold against the reference's
hooks.  The mesh that :func:`set_activation_mesh` installs is read by
the hooks, by the tensor-parallel regions (``sharding/tp.py``) and by
model code that takes a mean over the batch (``models/moe.py``'s
load-balance loss).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

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

#: the knobs that steer only the activation hooks (and so only where the
#: compute is split over the mesh, not the params' specs)
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
    sharded optimizer state.  attn_seq / attn_heads / act_seq /
    block_gather / act_model steer the activation hooks (their
    docstrings); dp2d puts the model axis among the batch axes."""
    new = dict(fsdp=fsdp, act_model=act_model, repeat_kv=repeat_kv,
               zero1=zero1, attn_seq=attn_seq, attn_heads=attn_heads,
               act_seq=act_seq, block_gather=block_gather, dp2d=dp2d)
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


# --- the activation mesh and hooks (rules.py:255-353 of the reference) ------

#: a module global, not the reference's thread-local: autograd runs the
#: backward, and the remat recompute in it, on a thread of its own on the
#: card, and the recompute must read the same mesh as the forward
_ACTIVATION_MESH = None
_MODEL_OK = True


def set_activation_mesh(mesh, model_axis_ok: bool = True):
    """Install the mesh that model code reads (None: no mesh).
    ``model_axis_ok=False`` disables sharding the feature dim in
    :func:`constrain` (e.g. decode steps where the residual stream is
    tiny)."""
    global _ACTIVATION_MESH, _MODEL_OK
    _ACTIVATION_MESH = mesh
    _MODEL_OK = bool(model_axis_ok)


def activation_mesh():
    """The mesh :func:`set_activation_mesh` installed, or None."""
    return _ACTIVATION_MESH


def model_axis_ok() -> bool:
    """``set_activation_mesh``'s ``model_axis_ok``."""
    return _MODEL_OK


def _batch_entry(mesh):
    b = batch_axes(mesh)
    return b if len(b) > 1 else b[0]


def activation_spec(mesh, ndim: int, model_ok: bool = True) -> tuple:
    """The batch over the batch axes; with ``model_ok`` and 3 dims or
    more, the feature dim over ``model`` (the sequence dim under
    ``act_seq``, Megatron-style sequence parallelism; nothing under
    ``dp2d``, whose batch already takes the model axis)."""
    spec = [None] * ndim
    spec[0] = _batch_entry(mesh)
    if model_ok and ndim >= 3 and not _POLICY.get("dp2d"):
        spec[1 if _POLICY.get("act_seq") else -1] = "model"
    return tuple(spec)


def residual_spec(mesh, shape) -> tuple:
    """:func:`constrain`'s spec for a tensor of ``shape``: the
    activation spec, without the model axis where the dim it shards
    (the feature dim, or the sequence under ``act_seq``) is not divisible
    by it, and without the batch axes where the batch is not divisible
    by them (``rules.py:344-352``)."""
    ndim = len(shape)
    model_ok = _MODEL_OK and _POLICY["act_model"]
    spec = list(activation_spec(mesh, ndim, model_ok))
    dim = 1 if _POLICY.get("act_seq") else -1
    if model_ok and ndim >= 3 and shape[dim] % _axes(mesh)["model"] != 0:
        spec = list(activation_spec(mesh, ndim, False))
    if shape[0] % mesh_size(mesh, batch_axes(mesh)) != 0:
        spec[0] = None
    return tuple(spec)


def block_input_spec(mesh, ndim: int):
    """:func:`gather_block_input`'s spec under ``block_gather`` (the
    batch over the batch axes, every other dim whole), else None."""
    if not _POLICY.get("block_gather") or ndim != 3:
        return None
    return (_batch_entry(mesh), None, None)


def attn_head_specs(mesh, q_shape, k_shape):
    """:func:`attn_head_shard`'s specs under ``attn_heads``: (q's, k's and
    v's or None where only q is constrained), or None."""
    if not _POLICY.get("attn_heads") or q_shape[1] <= 1:
        return None
    heads = (_batch_entry(mesh), None, "model", None)
    if _POLICY.get("repeat_kv") and q_shape[2] != k_shape[2]:
        return heads, None   # the repeat happens inside gqa_attend
    return heads, heads


def attn_seq_specs(mesh, q_shape):
    """:func:`attn_seq_shard`'s specs under ``attn_seq`` where the
    sequence divides the model axis: (q's, k's and v's), or None."""
    if not _POLICY.get("attn_seq"):
        return None
    m = _axes(mesh)["model"]
    if q_shape[1] % m or q_shape[1] < m:
        return None
    b = _batch_entry(mesh)
    return (b, "model", None, None), (b, None, None, None)


def constrain_spec(x, spec):
    """``x`` under an explicit spec if a mesh is installed: a ``DTensor``
    is redistributed to ``placements(spec)`` (the reference's
    ``with_sharding_constraint``); a plain tensor, which this rank holds
    whole, is returned as it is."""
    mesh = _ACTIVATION_MESH
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    target = placements(spec, mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def gather_block_input(x):
    """Manual sequence-parallel boundary: gather the residual to full
    feature width ONCE at block entry (``block_gather``), so the norm and
    both branches start from one gather.  A no-op otherwise."""
    mesh = _ACTIVATION_MESH
    if mesh is None:
        return x
    spec = block_input_spec(mesh, x.ndim)
    return x if spec is None else constrain_spec(x, spec)


def attn_head_shard(q, k, v):
    """Head-axis attention sharding (``attn_heads``): Q and the (repeated)
    KV over ``model`` on the head axis, [B, S, H, D].  Head counts that do
    not divide the model axis shard unevenly (the reference's GSPMD pads
    them).  Used together with ``repeat_kv``, inside ``gqa_attend``."""
    mesh = _ACTIVATION_MESH
    if mesh is None:
        return q, k, v
    specs = attn_head_specs(mesh, tuple(q.shape), tuple(k.shape))
    if specs is None:
        return q, k, v
    q = constrain_spec(q, specs[0])
    if specs[1] is None:
        return q, k, v
    return q, constrain_spec(k, specs[1]), constrain_spec(v, specs[1])


def attn_seq_shard(q, k, v):
    """Context-parallel attention sharding (``attn_seq``): Q over
    (``model``, sequence), KV replicated on the model axis; only where the
    sequence divides the model axis.  The reference's rationale: an
    indivisible head axis (yi-34b: 56 heads on 16) makes GSPMD all-reduce
    whole score tensors, and one KV gather a layer is far cheaper."""
    mesh = _ACTIVATION_MESH
    if mesh is None:
        return q, k, v
    specs = attn_seq_specs(mesh, tuple(q.shape))
    if specs is None:
        return q, k, v
    return (constrain_spec(q, specs[0]), constrain_spec(k, specs[1]),
            constrain_spec(v, specs[1]))


def constrain(x):
    """Residual-stream sharding constraint: [B, S, d] -> (batch, None,
    model) by :func:`residual_spec`.  No-op unless a mesh was installed
    via :func:`set_activation_mesh` and ``x`` is a ``DTensor``: models
    call this unconditionally."""
    mesh = _ACTIVATION_MESH
    if mesh is None or x.ndim < 2:
        return x
    return constrain_spec(x, residual_spec(mesh, tuple(x.shape)))
