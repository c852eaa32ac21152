"""Bucketed client-update executor — port of ``repro.fl.batch``.

1. bucket the cohort by submodel index (shapes are fixed per index);
2. build each bucket's padded schedule on the host, exactly as the JAX
   package does (``batch.py:76-142``): per-client epoch permutations from
   ``client_update_seed``, P and T padded to powers of two, pad steps
   replaying the client's first batch and pad rows replaying client 0,
   both masked out of the update and the loss;
3. run each bucket as one program, a Python loop over the T steps whose
   step gives every participant the gradient of its own loss (the
   method's: DR-FL, or the HeteroFL/ScaleFL loss on the family's sliced
   submodel):
   ``torch.func.vmap`` over participants of ``grad`` (the CNN), or, for a
   family with ``stacked_forward`` (the transformer, whose CUDA kernels
   ``torch.func`` cannot see inside), one forward over the participant
   axis written out and ``torch.autograd.grad`` of the summed losses,
   which is each participant's own gradient exactly.  Mini-batches are
   gathered on the device from the resident training set, and the losses
   come back to the host once per bucket.

The deltas stay stacked ``[P_pad, ...]`` per bucket, in the submodel's
tree, which is what :func:`repro_torch.fl.server.aggregate_drfl_stacked`
consumes; the baselines take them apart (:meth:`CohortResult.unstacked`)
for :func:`repro_torch.fl.server.aggregate_sliced`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.data.loader import client_schedule
from repro_torch.device import to_host
from repro_torch.models.family import resolve_family
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

# "compiles" counts new (method, model, shape) signatures, "executions"
# counts bucket program runs — the dispatch accounting of the reference
COUNTERS = {"compiles": 0, "executions": 0}
_SEEN_SIGNATURES: set = set()


def reset_counters() -> None:
    COUNTERS["compiles"] = 0
    COUNTERS["executions"] = 0
    _SEEN_SIGNATURES.clear()


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass
class Bucket:
    """One submodel bucket's padded schedule (host arrays)."""
    model_idx: int
    participants: List[int]          # device ids, cohort order
    weights: List[float]             # data sizes, aligned with participants
    gather: np.ndarray               # [P_pad, T_pad, B] int32
    valid: np.ndarray                # [P_pad, T_pad] float32

    @property
    def n_real(self) -> int:
        return len(self.participants)


def bucket_cohort(participants: Sequence[int], model_idxs: Sequence[int],
                  parts: Sequence[np.ndarray], seeds: Sequence[int],
                  weights: Sequence[float], *, epochs: int,
                  batch: int) -> List[Bucket]:
    """Group a cohort by submodel index and build padded schedules
    (zero-data participants must be filtered by the caller)."""
    by_m: Dict[int, List[int]] = {}
    for j, m in enumerate(model_idxs):
        by_m.setdefault(int(m), []).append(j)
    buckets = []
    for m in sorted(by_m):
        js = by_m[m]
        scheds = [client_schedule(parts[j], seeds[j], epochs, batch)
                  for j in js]
        t_pad = _next_pow2(max(len(s) for s in scheds))
        p_pad = _next_pow2(len(js))
        gather = np.zeros((p_pad, t_pad, batch), np.int32)
        valid = np.zeros((p_pad, t_pad), np.float32)
        for r, s in enumerate(scheds):
            gather[r, :len(s)] = s
            gather[r, len(s):] = s[0]    # pad steps replay batch 0, masked
            valid[r, :len(s)] = 1.0
        gather[len(js):] = gather[0]     # pad clients replay client 0
        buckets.append(Bucket(model_idx=m,
                              participants=[int(participants[j]) for j in js],
                              weights=[float(weights[j]) for j in js],
                              gather=gather, valid=valid))
    return buckets


def _stacked_step(family):
    """``vmap(grad_and_value(loss))``'s contract for a ``stacked_forward``
    family: (stacked params, [P, B, ...], [P, B]) -> (grads, losses [P]).
    Participant p's parameters reach only loss p, so the gradient of the
    sum is every participant's own gradient."""
    loss_fn = family.stacked_loss_fn

    def step(params, xb, yb):
        leaves = [l.detach().requires_grad_() for l in tree_leaves(params)]
        with torch.enable_grad():
            losses = loss_fn(tree_unflatten_like(params, leaves), xb, yb)
            grads = torch.autograd.grad(losses.sum(), leaves)
        return tree_unflatten_like(params, list(grads)), losses.detach()
    return step


def _bucket_program(sub_params, x_all, y_all, gather, valid, *, lr: float,
                    family, method: str):
    """One bucket: every participant's gradient of its ``method`` loss per
    step (see the module note for the two routes), in a loop over the T
    schedule steps.

    sub_params: the bucket's submodel tree (shared initial point)
    gather:     [P, T, B] int64 rows into x_all/y_all (on the device)
    valid:      [P, T] float32 step mask (0 = padding, a no-op step)

    Returns (stacked delta tree [P, ...], mean losses [P])."""
    P, T = valid.shape
    step = (_stacked_step(family) if family.stacked_forward
            else vmap(grad_and_value(family.loss_fn(method))))
    params = tree_map(lambda a: a.expand((P,) + a.shape).clone(), sub_params)
    loss_sum = torch.zeros(P, device=valid.device)
    for t in range(T):
        idx = gather[:, t]                               # [P, B]
        grads, loss = step(params, x_all[idx], y_all[idx])
        v = valid[:, t]
        # v == 1 multiplies are exact, so real steps are plain p - lr*g;
        # v == 0 makes the step an identity
        params = tree_map(
            lambda p, g: p - lr * (g * v.view((P,) + (1,) * (g.dim() - 1))),
            params, grads)
        loss_sum = loss_sum + loss * v
    delta = tree_map(lambda a, b: a - b, params, sub_params)
    return delta, loss_sum / torch.clamp_min(valid.sum(dim=1), 1.0)


@dataclasses.dataclass
class BucketResult:
    """Stacked outcome of one bucket.  ``stacked_delta`` keeps the pow2
    participant padding (pad rows carry weight 0.0); real rows are the
    first ``len(participants)``."""
    model_idx: int
    participants: List[int]
    weights: List[float]             # [P_pad], 0.0 beyond the real rows
    stacked_delta: object            # submodel tree, leaves [P_pad, ...]
    losses: np.ndarray               # [P_real]


def run_bucket(method: str, global_params, x_all, y_all, bucket: Bucket, *,
               lr: float, family=None) -> BucketResult:
    fam = resolve_family(family)
    sub = fam.submodel_params(method, global_params, bucket.model_idx)
    sig = (fam.name, method, bucket.model_idx, bucket.gather.shape,
           tuple(x_all.shape), float(lr))
    if sig not in _SEEN_SIGNATURES:
        _SEEN_SIGNATURES.add(sig)
        COUNTERS["compiles"] += 1
    COUNTERS["executions"] += 1
    dev = x_all.device
    stacked, losses = _bucket_program(
        sub, x_all, y_all,
        torch.as_tensor(bucket.gather, dtype=torch.int64, device=dev),
        torch.as_tensor(bucket.valid, device=dev), lr=float(lr), family=fam,
        method=method)
    p = bucket.n_real
    p_pad = bucket.gather.shape[0]
    (losses_h,) = to_host(losses[:p])     # one pull per bucket
    return BucketResult(model_idx=bucket.model_idx,
                        participants=list(bucket.participants),
                        weights=list(bucket.weights) + [0.0] * (p_pad - p),
                        stacked_delta=stacked, losses=losses_h)


@dataclasses.dataclass
class CohortResult:
    buckets: List[BucketResult]

    def unstacked(self):
        """Per participant ``(device_id, model_idx, delta, weight, loss)``
        in bucket order, each delta a view of its bucket's row: the input
        of the list aggregations (``aggregate_sliced``)."""
        return [(i, b.model_idx, tree_map(lambda a, r=r: a[r],
                                          b.stacked_delta),
                 b.weights[r], float(b.losses[r]))
                for b in self.buckets for r, i in enumerate(b.participants)]


def run_cohort(method: str, global_params, x_all: torch.Tensor,
               y_all: torch.Tensor, parts: Sequence[np.ndarray],
               participants: Sequence[int], model_idxs: Sequence[int],
               seeds: Sequence[int], *, epochs: int, batch: int, lr: float,
               family=None) -> CohortResult:
    """A whole cohort's local training, one program per bucket, each
    client weighted by its shard size.  ``x_all``/``y_all`` are the
    device-resident training set."""
    buckets = bucket_cohort(participants, model_idxs, parts, seeds,
                            [float(len(p)) for p in parts], epochs=epochs,
                            batch=batch)
    fam = resolve_family(family)
    return CohortResult(buckets=[
        run_bucket(method, global_params, x_all, y_all, b, lr=lr, family=fam)
        for b in buckets])
