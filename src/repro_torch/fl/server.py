"""FL server: evaluation and aggregation — port of ``repro.fl.server``.

Three aggregations, each quarantining poisoned deltas (non-finite, or an
element beyond ``DELTA_MAG_CAP``) and returning ``(new_params, valid)``
with the [N] validity left on the device for the caller's batched pull:

* :func:`aggregate_drfl`: DR-FL layer-aligned averaging over a list of
  full-structure deltas (the per-client executor's, ``tree_map`` per
  leaf), staleness applied per exit-layer;
* :func:`aggregate_drfl_stacked`: the same over bucket-stacked deltas,
  flattened into ``[N, R, seg]`` rows and averaged by one ``layer_agg``
  kernel launch (the bucketed executor's); :func:`aggregate_drfl_from_list`
  routes a list of deltas there as P = 1 buckets;
* :func:`aggregate_sliced`: the HeteroFL/ScaleFL scatter average, keyed
  by tree path.

Keywords of the reference that no caller sets are left out: quarantine is
always on at ``DELTA_MAG_CAP`` and the validity is always returned.  The
staleness decay is the caller's (``FLConfig.staleness_decay``, which the
async engine passes in; 0.5 by default, as the reference).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core import aggregation
from repro_torch.core.aggregation import (delta_valid, layerwise_aggregate,
                                          sanitize_delta, tree_path_align,
                                          tree_path_items)
from repro_torch.models.family import resolve_family
from repro_torch.tree import tree_leaves, tree_map

def evaluate(params, x_val: torch.Tensor, y_val: torch.Tensor,
             batch: int = 256, family=None) -> torch.Tensor:
    """Per-exit accuracy on the validation set, left on the device (the
    round tail pulls it with the fleet telemetry).  Batches of 256 with
    the reference's float32 arithmetic (mean x len, summed, / n)."""
    fam = resolve_family(family)
    total, n = None, 0
    for i in range(0, len(x_val), batch):
        xb, yb = x_val[i:i + batch], y_val[i:i + batch]
        acc = fam.eval_fn(params, xb, yb) * len(xb)
        total = acc if total is None else total + acc
        n += len(xb)
    return total / max(n, 1)


def staleness_scale(staleness: float, decay: float = 0.5) -> float:
    """FedAsync polynomial discount (1 + s)^(-decay); s <= 0 maps to
    exactly 1.0, so fresh rows are untouched."""
    if staleness <= 0:
        return 1.0
    return float((1.0 + float(staleness)) ** (-float(decay)))


def aggregate_drfl(global_params, deltas: List, model_idxs: List[int],
                   weights: Sequence[float], server_lr: float = 1.0,
                   staleness: Optional[Sequence[float]] = None,
                   staleness_decay: float = 0.5, family=None):
    """DR-FL layer-aligned aggregation over full-structure deltas
    (``server.py:67-114``).  A poisoned delta's masks are zeroed (its
    weight leaves every denominator) and its non-finite elements zeroed;
    all-valid input is exactly the unvalidated mean.  A stale delta is
    multiplied by its alpha on exactly the stem, stages and exits it
    holds (``update_mask(scale=alpha)``), so a lone stale contributor
    moves a layer by alpha times its update.  Returns
    ``(new_params, valid [N] bool on the device)``."""
    fam = resolve_family(family)
    masks = [fam.update_mask(global_params, m) for m in model_idxs]
    valid = [delta_valid(d) for d in deltas]
    deltas = [sanitize_delta(d) for d in deltas]
    masks = [tree_map(lambda mm, v=v: mm * v.float(), mask)
             for mask, v in zip(masks, valid)]
    if staleness is not None and any(s > 0 for s in staleness):
        scaled = []
        for d, m, s in zip(deltas, model_idxs, staleness):
            a = staleness_scale(s, staleness_decay)
            if a == 1.0:
                scaled.append(d)
                continue
            smask = fam.update_mask(global_params, m, scale=a)
            scaled.append(tree_map(
                lambda u, sm: (u.float() * sm).to(u.dtype), d, smask))
        deltas = scaled
    out = layerwise_aggregate(global_params, deltas, masks, weights,
                              server_lr=server_lr)
    return out, torch.stack(valid)


def aggregate_drfl_from_list(global_params, deltas: List,
                             model_idxs: List[int], weights: Sequence[float],
                             server_lr: float = 1.0,
                             staleness: Optional[Sequence[float]] = None,
                             staleness_decay: float = 0.5, family=None):
    """:func:`aggregate_drfl`'s contract through the stacked path: each
    full-structure delta becomes a P = 1 bucket of its submodel (views, no
    copies), so the mean is one ``layer_agg`` launch on the card."""
    fam = resolve_family(family)
    buckets = []
    for j, (d, m) in enumerate(zip(deltas, model_idxs)):
        sub = fam.submodel_tree(d, m)
        stal = None if staleness is None else [staleness[j]]
        buckets.append((m, tree_map(lambda a: a.unsqueeze(0), sub),
                        [weights[j]], stal))
    return aggregate_drfl_stacked(global_params, buckets,
                                  server_lr=server_lr,
                                  staleness_decay=staleness_decay,
                                  family=fam)


def _scatter_avg(gp, contribs):
    """contribs: (delta leaf, weight) pairs; a delta may be a channel
    prefix of ``gp`` (the reference pads it at each axis's end)."""
    num = torch.zeros(gp.shape, dtype=torch.float32, device=gp.device)
    den = torch.zeros_like(num)
    for u, w in contribs:
        at = tuple(slice(0, s) for s in u.shape)
        num[at] += w * u.float()
        den[at] += w
    avg = torch.where(den > 0, num / torch.clamp_min(den, 1e-12),
                      torch.zeros_like(num))
    return (gp.float() + avg).to(gp.dtype)


def aggregate_sliced(global_params, deltas: List, weights: Sequence[float]):
    """HeteroFL/ScaleFL scatter aggregation (``server.py:283-328``): each
    client's (depth-truncated, width-sliced) delta is aligned with the
    global tree by path, and every entry is averaged over the clients
    that hold it.  A poisoned client's weight is multiplied by its 0/1
    validity, so it leaves numerator and denominator.  No ``server_lr``,
    as in the reference.  Returns ``(new_params, valid [N])``."""
    valid = [delta_valid(d) for d in deltas]
    deltas = [sanitize_delta(d) for d in deltas]
    table: Dict[tuple, list] = {
        path: [] for path, _ in tree_path_items(global_params)}
    for d, w, v in zip(deltas, weights, valid):
        wj = float(w) * v.float()
        for path, leaf in tree_path_align(global_params, d):
            if leaf is not None:
                table[path].append((leaf, wj))
    wtot = float(sum(weights)) or 1.0

    def rebuild(gp, path=()):
        if isinstance(gp, dict):
            return {k: rebuild(v, path + (k,)) for k, v in gp.items()}
        if isinstance(gp, (list, tuple)):
            t = [rebuild(v, path + (i,)) for i, v in enumerate(gp)]
            return t if isinstance(gp, list) else tuple(t)
        contribs = table[path]
        if not contribs:
            return gp
        return _scatter_avg(gp, [(u, w / wtot) for u, w in contribs])

    return rebuild(global_params), torch.stack(valid)


def _stacked_agg_program(global_params, deltas, weights, alphas, *, family,
                         model_idxs, server_lr: float):
    """DR-FL Step 2 over bucket-stacked deltas (``server.py:132-179``):
    flatten into [N, R, seg] rows, quarantine poisoned rows (mask column
    and elements zeroed: 0 * nan = nan, so masking alone cannot keep nan
    out of the numerator), masked mean, scatter back onto the global
    tree.  Returns ``(new_params, valid [N] bool)``."""
    template = family.stack_template(global_params)
    us, row_masks = [], []
    for model_idx, delta in zip(model_idxs, deltas):
        held = family.held_groups(global_params, model_idx)
        u = aggregation.stack_group_rows(family.stack_groups(delta),
                                         template, held)       # [P, R, seg]
        row_mask = aggregation.group_row_mask(held, template,
                                              device=u.device)
        us.append(u)
        row_masks.append(row_mask.expand(u.shape[0], template.n_rows))
    u_all = torch.cat(us, dim=0)
    m_all = torch.cat(row_masks, dim=0)
    w_all = torch.cat(weights)
    a_all = torch.cat(alphas) if alphas is not None else None
    valid = aggregation.stacked_rows_valid(u_all)
    u_all = torch.where(valid[:, None, None], u_all,
                        torch.zeros((), device=u_all.device))
    m_all = m_all * valid[:, None].float()
    rows = aggregation.stacked_masked_mean(u_all, m_all.contiguous(), w_all,
                                           a_all)
    new_groups = aggregation.unstack_apply(family.stack_groups(global_params),
                                           rows, template,
                                           server_lr=server_lr)
    return family.unstack_groups(global_params, new_groups), valid


def aggregate_drfl_stacked(global_params, buckets, server_lr: float = 1.0,
                           staleness_decay: float = 0.5, family=None):
    """Layer-aligned aggregation over ``(model_idx, stacked_delta, weights,
    staleness)`` buckets.  Pad rows carry weight 0.0 and drop out of the
    mean exactly; staleness alphas scale the numerator only, and all-fresh
    input skips the rescale.  Returns ``(new_params, valid)``: the row
    validity [N] is left on the device for the caller's batched pull
    (``None`` when there are no buckets)."""
    fam = resolve_family(family)
    model_idxs, deltas, ws, alphas = [], [], [], []
    any_stale = False
    for model_idx, delta, weights, stal in buckets:
        dev = tree_leaves(delta)[0].device
        model_idxs.append(int(model_idx))
        deltas.append(delta)
        ws.append(torch.tensor([float(x) for x in weights],
                               dtype=torch.float32, device=dev))
        scales = ([1.0] * len(weights) if stal is None else
                  [staleness_scale(s, staleness_decay) for s in stal])
        any_stale = any_stale or any(a != 1.0 for a in scales)
        alphas.append(torch.tensor(scales, dtype=torch.float32, device=dev))
    if not deltas:
        return global_params, None
    return _stacked_agg_program(
        global_params, deltas, ws, alphas if any_stale else None, family=fam,
        model_idxs=model_idxs, server_lr=float(server_lr))
