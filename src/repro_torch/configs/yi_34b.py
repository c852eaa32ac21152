"""Yi-34B — llama-arch GQA dense decoder [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    head_dim=128, rope_theta=5_000_000.0,
    exit_points=(15, 30, 45, 60),
    source="arXiv:2403.04652",
)
