"""Llama-3.2-11B-Vision backbone — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].  Vision encoder is a stub frontend
(precomputed patch embeddings), per the assignment carve-out."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    head_dim=128, rope_theta=500_000.0,
    cross_attn_every=5, num_image_tokens=1601,
    exit_points=(10, 20, 30, 40),
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
