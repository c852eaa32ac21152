"""FL server: evaluation and stacked DR-FL aggregation — port of
``repro.fl.server`` (``evaluate``, ``staleness_scale``,
``aggregate_drfl_stacked``, ``_stacked_agg_program``).

The stacked path runs eagerly: bucket-stacked deltas are flattened into
``[N, R, seg]`` rows, poisoned rows are quarantined, and the masked mean
is one ``layer_agg`` kernel launch per aggregation.
"""
from __future__ import annotations

import torch

from repro_torch.core import aggregation
from repro_torch.models.family import resolve_family
from repro_torch.tree import tree_leaves

#: FedAsync polynomial staleness decay (``FLConfig.staleness_decay``'s
#: default; the sync engine sends no staleness, so nothing sets another)
STALENESS_DECAY = 0.5


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


def staleness_scale(staleness: float) -> float:
    """FedAsync polynomial discount (1 + s)^(-STALENESS_DECAY); s <= 0
    maps to 1.0."""
    if staleness <= 0:
        return 1.0
    return float((1.0 + float(staleness)) ** (-STALENESS_DECAY))


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
                           family=None):
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
                  [staleness_scale(s) for s in stal])
        any_stale = any_stale or any(a != 1.0 for a in scales)
        alphas.append(torch.tensor(scales, dtype=torch.float32, device=dev))
    if not deltas:
        return global_params, None
    return _stacked_agg_program(
        global_params, deltas, ws, alphas if any_stale else None, family=fam,
        model_idxs=model_idxs, server_lr=float(server_lr))
