"""Nested dict/list parameter trees, flattened in ``jax.tree.leaves`` order.

JAX flattens dicts by SORTED key and lists in order; the port's stack
templates and optimizer states rely on the same order, so group sizes and
row layouts equal the JAX package's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of trees with the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *[r[i] for r in rest])
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_unflatten_like(tree, leaves: List[Any]):
    """Rebuild ``tree``'s structure from ``leaves`` in tree_leaves order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has positions")
    return out


def tree_shapes(tree) -> Tuple[Tuple[Tuple[int, ...], str], ...]:
    return tuple((tuple(l.shape), str(l.dtype)) for l in tree_leaves(tree))
