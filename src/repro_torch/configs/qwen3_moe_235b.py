"""Qwen3-MoE-235B-A22B — 128 experts, top-8 routing [hf:Qwen/Qwen3-30B-A3B
family].  d_ff is the per-expert FFN width."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936,
    head_dim=128, rope_theta=1_000_000.0, qk_norm=True,
    num_experts=128, experts_per_token=8,
    exit_points=(24, 47, 71, 94),
    source="hf:Qwen/Qwen3-30B-A3B",
)
