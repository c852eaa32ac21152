"""Config dataclasses shared across the framework.

Every assigned architecture is expressed as a :class:`ModelConfig`.  Input
shapes (train_4k / prefill_32k / decode_32k / long_500k) are
:class:`ShapeConfig` entries in :data:`INPUT_SHAPES`.

Copied field for field from ``repro.configs.base`` (pure data, no jax):
the port builds the same configurations without importing the JAX
package.  ``TrainConfig.use_pallas`` keeps its name so that a reference
call site ports unchanged; in the port it means "launch the hand-written
``flash_attention`` kernel" (:mod:`repro_torch.kernels.flash_attention`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (family-polymorphic).

    ``family`` selects the block implementation:
      dense | moe | ssm (xlstm) | mamba-hybrid | vlm | audio (enc-dec)
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25
    moe_decode_impl: str = "gather"   # gather (weight-streaming) | dispatch
                                      # (token all-to-all via capacity buffers)

    # --- SSM / recurrent ---
    ssm_state: int = 0                # Mamba2 state size N
    ssm_expand: int = 2               # inner-dim expansion factor
    ssm_chunk: int = 64               # SSD chunk length
    # xLSTM: blocks alternate mLSTM (even) / sLSTM (odd)

    # --- hybrid (zamba2-style) ---
    shared_attn_every: int = 0        # apply the shared attn block every k SSM blocks

    # --- attention ---
    window: int = 0                   # sliding-window size; 0 = full causal
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_bias: bool = False
    mlp_bias: bool = False

    # --- VLM ---
    cross_attn_every: int = 0         # a cross-attn layer after every k self layers
    num_image_tokens: int = 0         # stub frontend: precomputed patch embeds

    # --- audio enc-dec ---
    encoder_layers: int = 0
    num_audio_frames: int = 0         # stub frontend: precomputed frame embeds

    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- DR-FL layer-wise exits (depth-prefix submodels, paper §4.2) ---
    exit_points: Tuple[int, ...] = ()

    # --- provenance ---
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_decoder_only(self) -> bool:
        return self.family != "audio"

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab_size, self.hd
        nh, nkv, L = self.num_heads, self.num_kv_heads, self.num_layers
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if self.family == "ssm":  # xlstm blocks: internal up/down projections
            inner = self.ssm_expand * d
            per_layer = d * inner * 3 + inner * d + 2 * d  # qkv-ish + out + norms
            return v * d * (1 if self.tie_embeddings else 2) + L * per_layer
        if self.family == "mamba-hybrid":
            inner = self.ssm_expand * d
            mamba = d * (2 * inner + 2 * self.num_heads * self.ssm_state) + inner * d
            shared = attn + 3 * d * f  # one shared block, counted once
            return v * d * 2 + L * (mamba + 2 * d) + shared
        if self.family == "moe":
            ff = 3 * d * f * self.num_experts + d * self.num_experts  # experts + router
        else:
            ff = 3 * d * f
        per_layer = attn + ff + 2 * d
        n = v * d * (1 if self.tie_embeddings else 2) + L * per_layer + d
        if self.family == "vlm":
            n_cross = self.num_layers // max(self.cross_attn_every, 1)
            n += n_cross * (attn + 3 * d * f + 2 * d)
        if self.family == "audio":
            n += self.encoder_layers * (attn + 3 * d * f + 2 * d)
            n += self.num_layers * attn  # decoder cross-attention
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_ff = 3 * d * f * self.num_experts
        active_ff = 3 * d * f * self.experts_per_token
        return self.param_count() - self.num_layers * (dense_ff - active_ff)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / training-loop hyperparameters."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | linear | constant
    microbatch: int = 0               # 0 = no microbatching
    remat: str = "full"               # full | dots | none
    loss_chunk: int = 512             # sequence-chunked CE (avoid [B,S,V] logits)
    use_pallas: bool = False          # opt-in kernels (XLA default for dry-run)
    attn_chunk: int = 0               # >0: online-softmax KV-block attention


def reduced(cfg: ModelConfig, **over) -> ModelConfig:
    """A smoke-test variant of the same family: 2 layers, d_model<=512, <=4 experts."""
    d = min(cfg.d_model, 256)
    nh = max(1, min(cfg.num_heads, 4))
    nkv = max(1, min(cfg.num_kv_heads, nh))
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d,
        num_heads=nh,
        num_kv_heads=nkv,
        head_dim=d // nh,
        d_ff=0 if cfg.d_ff == 0 else min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_chunk=16,
        window=min(cfg.window, 64) if cfg.window else 0,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        num_image_tokens=min(cfg.num_image_tokens, 16) if cfg.num_image_tokens else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        num_audio_frames=min(cfg.num_audio_frames, 32) if cfg.num_audio_frames else 0,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        exit_points=(1, 2) if cfg.exit_points else (),
        dtype="float32",
    )
    changes.update(over)
    return dataclasses.replace(cfg, **changes)
