"""Aggregation operators — port of ``repro.core.aggregation``: FedAvg
(Eq. 2), DR-FL layer-aligned averaging (paper Step 2) over a list of
client updates, the quarantine gate, and the stacked form.

:func:`layerwise_aggregate` is the list form the per-client executor
aggregates with, as the reference's does: one masked weighted mean per
leaf.  The stacked form (``aggregation.py:157-300``) lays each aggregation
group (stem, each stage, each exit), flattened in ``tree_leaves`` order
and padded to a multiple of ``seg``, out as consecutive rows of one
``[N, R, seg]`` tensor; the per-client hold masks become an ``[N, R]``
matrix, so the whole masked mean is one ``layer_agg`` kernel launch.  The
row layout (``group_sizes``, ``group_rows``) equals the JAX template's:
sizes are element counts, which the OIHW conv layout does not change.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

#: per-element magnitude ceiling for client deltas: only corrupted or
#: diverged payloads trip it
DELTA_MAG_CAP = 1e8


def tree_path_items(tree, _path=()):
    """``(path, leaf)`` for every leaf of a dict/list/tuple tree; paths are
    tuples of dict keys and sequence indices (positional identity, so a
    tensor reachable at two paths keeps two entries)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_path_items(v, _path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_path_items(v, _path + (i,))
    else:
        yield _path, tree


def tree_path_align(ref, other, _path=()):
    """``(path, other_leaf_or_None)`` for every leaf position of ``ref``:
    ``None`` where ``other`` (a depth-truncated tree, e.g. a ScaleFL
    client delta) has no entry."""
    if isinstance(ref, dict):
        for k, v in ref.items():
            o = other[k] if (other is not None and k in other) else None
            yield from tree_path_align(v, o, _path + (k,))
    elif isinstance(ref, (list, tuple)):
        for i, v in enumerate(ref):
            o = (other[i] if (other is not None and i < len(other))
                 else None)
            yield from tree_path_align(v, o, _path + (i,))
    else:
        yield _path, other


def delta_valid(delta) -> torch.Tensor:
    """0-d bool on the delta's device, never pulled: every element finite
    and within ``DELTA_MAG_CAP`` — the per-client quarantine gate (the
    leaves checked as one flat vector: four launches a delta)."""
    flat = torch.cat([l.reshape(-1) for l in tree_leaves(delta)])
    fin = torch.isfinite(flat)
    safe = torch.where(fin, flat, torch.zeros_like(flat))
    return fin.all() & (safe.abs().max() <= DELTA_MAG_CAP)


def sanitize_delta(delta):
    """Zero every non-finite element (quarantine zeroes a bad client's
    mask, but 0 * nan = nan); an exact copy of finite elements."""
    return tree_map(
        lambda u: torch.where(torch.isfinite(u), u, torch.zeros_like(u)),
        delta)


def fedavg(updates: Sequence, weights: Optional[Sequence[float]] = None):
    """Plain FedAvg over trees (Eq. 2); ``weights`` ~ client data sizes."""
    n = len(updates)
    if weights is None:
        w = [1.0 / n] * n
    else:
        tot = float(sum(weights))
        w = [float(x) / tot for x in weights]
    return tree_map(
        lambda *xs: sum(wi * x.float() for wi, x in zip(w, xs)
                        ).to(xs[0].dtype), *updates)


def layerwise_aggregate(global_params, client_updates: List,
                        client_masks: List,
                        weights: Optional[Sequence[float]] = None,
                        server_lr: float = 1.0):
    """DR-FL layer-aligned aggregation over a list of client updates.

    client_updates: full-structure trees (zero outside a client's
                    submodel); client_masks: trees of 0-d float32 masks
                    (``family.update_mask``); weights: data sizes L_n.
    Returns ``W + server_lr * masked weighted mean`` leaf by leaf, with the
    reference's float32 expression order."""
    n = len(client_updates)
    w = [float(x) for x in (weights if weights is not None else [1.0] * n)]

    def agg(gp, *leaves):
        ups, msks = leaves[:n], leaves[n:]
        num = sum(wi * m.float() * u.float()
                  for wi, u, m in zip(w, ups, msks))
        den = sum(wi * m.float() for wi, m in zip(w, msks))
        avg = torch.where(den > 0, num / torch.clamp_min(den, 1e-12),
                          torch.zeros_like(num))
        return (gp.float() + server_lr * avg).to(gp.dtype)

    return tree_map(agg, global_params, *client_updates, *client_masks)


class StackTemplate(NamedTuple):
    """Row layout of one model's parameters, grouped by aggregation unit."""
    seg: int                                   # segment (row) width
    n_rows: int                                # R: total rows
    group_sizes: Tuple[int, ...]               # flat element count per group
    group_rows: Tuple[Tuple[int, int], ...]    # (row_start, row_stop)


def build_stack_template(group_trees: Sequence, seg: int = 1024
                         ) -> StackTemplate:
    sizes, rows, r = [], [], 0
    for tree in group_trees:
        n = int(sum(l.numel() for l in tree_leaves(tree)))
        nr = max(1, -(-n // seg))
        sizes.append(n)
        rows.append((r, r + nr))
        r += nr
    return StackTemplate(seg=int(seg), n_rows=r, group_sizes=tuple(sizes),
                         group_rows=tuple(rows))


def stack_group_rows(group_trees: Sequence, template: StackTemplate,
                     held: Sequence[bool]) -> torch.Tensor:
    """Flatten the HELD groups of participant-stacked trees (leaves
    ``[P, ...]``, one entry per held group in global order) into
    ``[P, R, seg]`` float32 rows, zeros outside the held groups."""
    it = iter(group_trees)
    out = None
    for g, is_held in enumerate(held):
        if not is_held:
            continue
        leaves = tree_leaves(next(it))
        flat = torch.cat([l.reshape(l.shape[0], -1).float()
                          for l in leaves], dim=1)
        if out is None:
            out = torch.zeros((flat.shape[0], template.n_rows * template.seg),
                              dtype=torch.float32, device=flat.device)
        r0 = template.group_rows[g][0]
        out[:, r0 * template.seg:r0 * template.seg + flat.shape[1]] = flat
    return out.reshape(-1, template.n_rows, template.seg)


def group_row_mask(held: Sequence[bool], template: StackTemplate, *,
                   device=None) -> torch.Tensor:
    """Expand a per-group 0/1 vector to the per-row mask [R]."""
    m = torch.zeros((template.n_rows,), dtype=torch.float32, device=device)
    for g, is_held in enumerate(held):
        if is_held:
            r0, r1 = template.group_rows[g]
            m[r0:r1] = 1.0
    return m


def stacked_rows_valid(U: torch.Tensor) -> torch.Tensor:
    """[N] bool from rows [N, R, seg]: finite everywhere and within
    ``DELTA_MAG_CAP`` — the quarantine gate of the stacked path."""
    fin = torch.isfinite(U)
    safe = torch.where(fin, U, torch.zeros_like(U))
    return fin.flatten(1).all(dim=1) & (
        safe.abs().flatten(1).amax(dim=1) <= DELTA_MAG_CAP)


def stacked_masked_mean(U, mask01, weights,
                        alphas: Optional[torch.Tensor] = None):
    """Masked weighted mean over clients: U [N, R, seg], mask01 [N, R],
    weights [N] -> [R, seg] float32, through the ``layer_agg`` kernel
    (its plain version for CPU tensors).

    ``alphas`` (optional [N] staleness scales) weight the NUMERATOR only:
    the kernel's single-mask result is rescaled per row by
    (sum w*alpha*m) / (sum w*m), so the denominator keeps the 0/1 hold
    mask (``aggregation.py:239-272``).  ``None`` skips the rescale."""
    from repro_torch.kernels.layer_agg import layer_agg
    w = weights.float()
    if alphas is None:
        return layer_agg(U, mask01, w)
    m_alpha = (mask01 * alphas.float()[:, None]).contiguous()
    out = layer_agg(U, m_alpha, w)
    den01 = (w[:, None] * mask01).sum(dim=0)
    den_a = (w[:, None] * m_alpha).sum(dim=0)
    ratio = torch.where(den01 > 0, den_a / torch.clamp_min(den01, 1e-12),
                        torch.zeros_like(den01))
    return out * ratio[:, None]


def unstack_apply(global_group_trees: Sequence, rows: torch.Tensor,
                  template: StackTemplate, server_lr: float = 1.0):
    """Apply averaged rows [R, seg] to the global group trees:
    ``gp + server_lr * avg`` per leaf, as ``layerwise_aggregate``."""
    out = []
    for g, tree in enumerate(global_group_trees):
        r0, r1 = template.group_rows[g]
        flat = rows[r0:r1].reshape(-1)[:template.group_sizes[g]]
        new, off = [], 0
        for l in tree_leaves(tree):
            d = flat[off:off + l.numel()].reshape(l.shape)
            new.append((l.float() + server_lr * d).to(l.dtype))
            off += l.numel()
        out.append(tree_unflatten_like(tree, new))
    return out
