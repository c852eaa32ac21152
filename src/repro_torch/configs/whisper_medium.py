"""Whisper-medium — enc-dec audio backbone; conv/mel frontend is a stub
(precomputed frame embeddings) [arXiv:2212.04356].  num_layers counts the
DECODER stack; the encoder has the same depth."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    head_dim=64,
    attn_bias=True, mlp_bias=True,
    encoder_layers=24, num_audio_frames=1500,
    exit_points=(6, 12, 18, 24),
    source="arXiv:2212.04356",
)
