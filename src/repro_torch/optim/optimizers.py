"""AdamW over parameter trees — port of ``repro.optim.adamw_update``.

Written out rather than ``torch.optim.AdamW``: the reference uses
beta2=0.95, eps 1e-8 added to sqrt(v_hat), a global-norm clip and float32
moments, none of which are that class's defaults.

:func:`adamw_update` builds new trees; :func:`adamw_update_` writes the
same numbers, bit for bit, into the params and moments in place, one
slice of a leaf at a time.  It is the port's form of the reference train
step's donated state (``launch/train.py``, ``donate_argnums=(0,)``): at
phi3-mini's full width the moments alone are 30.6 GB in float32, and a
second copy of them beside new params does not fit one 80 GB card.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    ).sum())


def adamw_init(params):
    return {"step": 0,
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)}


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, beta1=0.9, beta2=0.95,
                 eps=1e-8, weight_decay=0.0, grad_clip: float = 0.0):
    """Returns ``(new_params, new_state, {"grad_norm": tensor})``."""
    gnorm = global_norm(grads)
    if grad_clip:
        scale = torch.clamp_max(grad_clip / (gnorm + 1e-9), 1.0)
    else:
        scale = torch.ones((), device=gnorm.device)
    step = state["step"] + 1
    b1c = 1.0 - beta1 ** float(step)
    b2c = 1.0 - beta2 ** float(step)
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                          tree_leaves(state["nu"]), tree_leaves(params)):
        g = g.float() * scale
        m = beta1 * m + (1.0 - beta1) * g
        v = beta2 * v + (1.0 - beta2) * g * g
        step_ = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        pf = p.float()
        if weight_decay and p.ndim >= 2:   # decoupled decay, matrices only
            step_ = step_ + weight_decay * pf
        new_p.append((pf - lr * step_).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (tree_unflatten_like(params, new_p),
            {"step": step, "mu": tree_unflatten_like(params, new_m),
             "nu": tree_unflatten_like(params, new_v)},
            {"grad_norm": gnorm})


#: elements of a leaf that :func:`adamw_update_` updates at once: its
#: float32 temporaries stay near 1 GB each, whatever the leaf's size
INPLACE_CHUNK = 1 << 28


@torch.no_grad()
def adamw_update_(grads, state, params, *, lr, beta1=0.9, beta2=0.95,
                  eps=1e-8, weight_decay=0.0, grad_clip: float = 0.0,
                  grad_norm=None):
    """:func:`adamw_update` in place: ``params`` and ``state``'s ``mu``
    and ``nu`` are overwritten and ``state["step"]`` advances; returns
    ``{"grad_norm": tensor}``.  Every element goes through the same
    operations in the same order as in :func:`adamw_update`, so the
    results are equal bit for bit; only the slicing into chunks of
    ``INPLACE_CHUNK`` elements is new, and elementwise arithmetic does not
    depend on it.  ``grad_norm``, where given, is the norm the clip
    reads in place of ``grads``' own: a rank that updates its shards of a
    sharded state (``launch/train.py::meshed_step``) clips by the whole
    gradient's norm."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    if grad_clip:
        scale = torch.clamp_max(grad_clip / (gnorm + 1e-9), 1.0)
    else:
        scale = torch.ones((), device=gnorm.device)
    step = state["step"] + 1
    b1c = 1.0 - beta1 ** float(step)
    b2c = 1.0 - beta2 ** float(step)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                          tree_leaves(state["nu"]), tree_leaves(params)):
        decay = bool(weight_decay) and p.ndim >= 2
        # view(-1) raises on a leaf it cannot flatten in place
        for gc, mc, vc, pc in zip(*(t.split(INPLACE_CHUNK) for t in (
                g.reshape(-1), m.view(-1), v.view(-1), p.view(-1)))):
            gc = gc.float() * scale
            mc.mul_(beta1).add_((1.0 - beta1) * gc)
            vc.mul_(beta2).add_((1.0 - beta2) * gc * gc)
            step_ = (mc / b1c) / (torch.sqrt(vc / b2c) + eps)
            pf = pc.float()
            if decay:                      # decoupled decay, matrices only
                step_ = step_ + weight_decay * pf
            pc.copy_(pf - lr * step_)
    state["step"] = step
    return {"grad_norm": gnorm}
