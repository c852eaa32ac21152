"""Command-R-35B — GQA, no-bias dense decoder [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000,
    head_dim=128, rope_theta=8_000_000.0,
    attn_bias=False, mlp_bias=False, tie_embeddings=True,
    exit_points=(10, 20, 30, 40),
    source="hf:CohereForAI/c4ai-command-r-v01",
)
