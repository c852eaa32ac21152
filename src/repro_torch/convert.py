"""JAX numpy parameter trees <-> the port's tensors.

The port keeps the JAX tree layout (same dict keys, same lists) and the
JAX shapes everywhere except convolution kernels, which PyTorch wants
OIHW where JAX stores HWIO.  Every 4-D leaf of a CNN tree is a conv
kernel; nothing else is transposed.  Images keep NHWC at every public
function (``repro_torch.models.cnn.apply_all_exits`` changes layout
inside), so data arrays need no conversion.  QMIX, transformer and mlp
trees (dense ``w`` [d_in, d_out] used as ``x @ w``) convert leaf for
leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map

#: conv kernel layouts: JAX ``HWIO`` -> PyTorch ``OIHW``, and back
HWIO_TO_OIHW = (3, 2, 0, 1)
OIHW_TO_HWIO = (2, 3, 1, 0)


def _lead(perm, lead: int):
    """``perm`` applied behind ``lead`` untouched leading axes."""
    return tuple(range(lead)) + tuple(lead + p for p in perm)


def cnn_params_from_jax(tree, device="cpu", *, stacked: bool = False):
    """JAX CNN params (numpy or jax arrays, HWIO convs) -> float32 tensors
    with OIHW convs.  ``stacked``: every leaf carries a leading
    participant axis [P, ...] (bucket-stacked deltas)."""
    lead = int(stacked)

    def leaf(a):
        a = np.asarray(a, np.float32)
        if a.ndim == 4 + lead:
            a = np.transpose(a, _lead(HWIO_TO_OIHW, lead))
        return torch.tensor(np.ascontiguousarray(a), device=device)
    return tree_map(leaf, _as_python_tree(tree))


def cnn_params_to_jax_layout(tree, *, stacked: bool = False):
    """The port's CNN params -> numpy with HWIO convs (for comparison with
    the JAX package's arrays)."""
    lead = int(stacked)

    def leaf(t):
        a = t.detach().cpu().numpy()
        if a.ndim == 4 + lead:
            a = np.transpose(a, _lead(OIHW_TO_HWIO, lead))
        return a
    return tree_map(leaf, tree)


def params_from_jax(tree, device="cpu"):
    """Any JAX tree with no conv kernels, leaf for leaf: QMIX
    ``params``/``target``, and the transformer and mlp families' params,
    flat or participant-stacked (their dense ``w`` are [d_in, d_out] in
    both packages)."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=device),
                    _as_python_tree(tree))


def lm_params_from_jax(tree, device="cpu"):
    """The JAX package's LM params, given as numpy arrays, leaf for leaf
    with their dtypes: ``repro.models.transformer``'s (the stacked ``[L,
    ...]`` blocks, the embedding, an untied ``unembed`` or none where it
    is tied; a MoE block's ``moe`` leaves ``router``, float32 in a bf16
    model, and ``w_gate``, ``w_up``, ``w_down`` ``[L, E, ...]``),
    ``repro.models.xlstm``'s (the ``mlstm`` and ``slstm``
    stacks ``[L/2, ...]``, their gate and recurrent leaves ``w_if``,
    ``b_if``, ``r`` and ``b`` float32 in a bf16 model) and
    ``repro.models.hybrid``'s (the ``mamba`` stack ``[L, ...]``, its
    ``A_log``, ``dt_bias`` and ``D`` float32, and the unstacked
    ``shared_attn`` block), ``repro.models.encdec``'s (the ``encoder`` and
    ``decoder`` stacks, their LayerNorm ``bias`` and attention biases) and
    ``repro.models.vlm``'s (``self_blocks`` ``[G, n_self, ...]``,
    ``cross_blocks`` ``[G, ...]`` with their float32 ``gate_attn`` and
    ``gate_mlp``): the walk is generic, so every family's tree arrives
    as it is.  Float32 stays float32, and a bfloat16 leaf
    (numpy's ``ml_dtypes`` type) goes through float32, which holds every
    bfloat16 value exactly, into a bfloat16 tensor."""
    def leaf(a):
        a = np.asarray(a)
        bf16 = a.dtype.name == "bfloat16"
        t = torch.tensor(a.astype(np.float32) if bf16 else a, device=device)
        return t.to(torch.bfloat16) if bf16 else t
    return tree_map(leaf, _as_python_tree(tree))


def _as_python_tree(tree):
    """Plain dicts/lists: JAX may hand back tuples or other mappings."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _as_python_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_python_tree(v) for v in tree]
    return tree
