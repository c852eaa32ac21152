"""xLSTM-1.3B — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    head_dim=512,
    ssm_expand=2, ssm_chunk=64,
    exit_points=(12, 24, 36, 48),
    source="arXiv:2405.04517",
)
