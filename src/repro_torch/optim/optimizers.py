"""AdamW over parameter trees — port of ``repro.optim.adamw_update``.

Written out rather than ``torch.optim.AdamW``: the reference uses
beta2=0.95, eps 1e-8 added to sqrt(v_hat), a global-norm clip and float32
moments, none of which are that class's defaults.
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
