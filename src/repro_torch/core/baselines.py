"""The heterogeneous-FL baselines of the paper's Table 1 — port of
``repro.core.baselines``.

* **HeteroFL**: clients train channel-prefix (width) slices of the one
  global model, fraction p in ``WIDTH_LEVELS``; aggregation averages each
  weight entry over the clients whose slice holds it.
* **ScaleFL**: depth prefix (exit m) x width slice ``WIDTH_LEVELS[m]``,
  the deepest held exit distilled into the shallower ones.

Layout: the port keeps convolution kernels OIHW, so the slice axes are the
reference's moved: its HWIO axis 3 (cout) is axis 0 here and its axis 2
(cin) is axis 1.  The stem keeps its 3 input channels (cout only); an exit
slices ``w`` on axis 0 and keeps ``b``.  Slices are views of the global
tensors: nothing writes into them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.tree import tree_map

WIDTH_LEVELS = (0.25, 0.5, 0.75, 1.0)
#: OIHW axes a width slice cuts: cout and cin, or cout alone (the stem)
_COUT_CIN = (0, 1)
_COUT = (0,)


def _slice(a: torch.Tensor, frac: float, axes: Sequence[int]):
    sl = [slice(None)] * a.dim()
    for ax in axes:
        sl[ax] = slice(0, max(1, math.ceil(a.shape[ax] * frac)))
    return a[tuple(sl)]


def _slice_gn(p, frac: float):
    return tree_map(lambda a: _slice(a, frac, (0,)), p)


def width_slice_cnn(params: Dict, frac: float) -> Dict:
    """HeteroFL submodel: the channel-prefix slice of every layer."""
    out = {"stem": {"conv": _slice(params["stem"]["conv"], frac, _COUT),
                    "gn": _slice_gn(params["stem"]["gn"], frac)},
           "stages": [], "exits": []}
    for stage in params["stages"]:
        blocks = []
        for bp in stage:
            nb = {"conv1": _slice(bp["conv1"], frac, _COUT_CIN),
                  "gn1": _slice_gn(bp["gn1"], frac),
                  "conv2": _slice(bp["conv2"], frac, _COUT_CIN),
                  "gn2": _slice_gn(bp["gn2"], frac)}
            if "proj" in bp:
                nb["proj"] = _slice(bp["proj"], frac, _COUT_CIN)
            blocks.append(nb)
        out["stages"].append(blocks)
    for ep in params["exits"]:
        out["exits"].append({
            "bottleneck": _slice(ep["bottleneck"], frac, _COUT_CIN),
            "gn": _slice_gn(ep["gn"], frac),
            "w": _slice(ep["w"], frac, (0,)),
            "b": ep["b"]})
    return out


def _prefix(shape) -> tuple:
    return tuple(slice(0, s) for s in shape)


def heterofl_aggregate(global_params: Dict, updates: List[Dict],
                       fracs: List[float],
                       weights: Optional[List[float]] = None):
    """Scatter-average width-sliced client updates into the global tree:
    entry (i, j, ...) of a global weight is averaged over the clients whose
    slice covers it (each update sits at the prefix of its leaf, as the
    reference's end padding puts it)."""
    if weights is None:
        weights = [1.0] * len(updates)

    def agg(gp, *ups):
        num = torch.zeros(gp.shape, dtype=torch.float32, device=gp.device)
        den = torch.zeros_like(num)
        for u, w in zip(ups, weights):
            at = _prefix(u.shape)
            num[at] += w * u.float()
            den[at] += w
        avg = torch.where(den > 0, num / torch.clamp_min(den, 1e-12),
                          torch.zeros_like(num))
        return (gp.float() + avg).to(gp.dtype)

    return tree_map(agg, global_params, *updates)


def scalefl_submodel(params: Dict, model_idx: int) -> Dict:
    """ScaleFL 2-D scaling: depth prefix (exit ``model_idx``) + width
    ``WIDTH_LEVELS[model_idx]``."""
    sliced = width_slice_cnn(params, WIDTH_LEVELS[model_idx])
    return {"stem": sliced["stem"],
            "stages": sliced["stages"][:model_idx + 1],
            "exits": sliced["exits"][:model_idx + 1]}


def kd_loss(student_logits, teacher_logits, temp: float = 2.0):
    """Self-distillation: the deepest held exit teaches shallower ones."""
    t = torch.softmax(teacher_logits / temp, dim=-1)
    ls = torch.log_softmax(student_logits / temp, dim=-1)
    return -torch.mean(torch.sum(t * ls, dim=-1)) * temp * temp
