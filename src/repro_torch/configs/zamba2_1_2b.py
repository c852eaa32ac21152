"""Zamba2-1.2B — Mamba2 backbone + shared attention block [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="mamba-hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    head_dim=64,
    ssm_state=64, ssm_expand=2, ssm_chunk=64,
    shared_attn_every=6,
    exit_points=(10, 19, 29, 38),
    source="arXiv:2411.15242",
)
