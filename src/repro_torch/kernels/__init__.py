"""Kernels written by hand for Hopper, one package each, and their launch
counts.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel
and nowhere else (its plain version on CPU tensors does not count), so a
run can show that the main path went through the kernel.  A backward
kernel counts under its own ``<name>_bwd`` key, once per backward call;
``flash_attention``'s forward also counts under the route it took,
``flash_attention_fwd_split`` (the short-query route),
``flash_attention_fwd_wgmma`` (the bf16 tensor-core route) or
``flash_attention_fwd_tiled``, and its backward under
``flash_attention_bwd_short`` (the short-query route),
``flash_attention_bwd_wgmma`` (the bf16 tensor-core route, two launches
counted once), ``flash_attention_bwd_fused`` or
``flash_attention_bwd_three_pass`` (the tiled route's two), and
``rmsnorm``'s forward and backward under theirs, ``rmsnorm_vec`` or
``rmsnorm_general`` and ``rmsnorm_bwd_vec`` or ``rmsnorm_bwd_general``.
A ``flash_attention`` launch made through its local-shard entry (the
mesh's ``DTensor``s) also counts under ``flash_attention_sharded`` or
``flash_attention_bwd_sharded``.
"""
from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"layer_agg": 0, "rmsnorm": 0, "rmsnorm_bwd": 0,
                            "rmsnorm_vec": 0, "rmsnorm_general": 0,
                            "rmsnorm_bwd_vec": 0, "rmsnorm_bwd_general": 0,
                            "flash_attention": 0, "flash_attention_bwd": 0,
                            "flash_attention_fwd_split": 0,
                            "flash_attention_fwd_tiled": 0,
                            "flash_attention_fwd_wgmma": 0,
                            "flash_attention_bwd_short": 0,
                            "flash_attention_bwd_wgmma": 0,
                            "flash_attention_bwd_fused": 0,
                            "flash_attention_bwd_three_pass": 0,
                            "flash_attention_sharded": 0,
                            "flash_attention_bwd_sharded": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
