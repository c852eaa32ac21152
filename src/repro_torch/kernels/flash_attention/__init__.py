from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: F401
    attention_plain, attention_plain_model, attention_route,
    attention_split_blocked, attention_split_blocked_bwd,
    attention_wgmma_blocked, attention_wgmma_blocked_bwd, flash_attention,
    flash_attention_bhsd, fused_backward, load_library, short_split,
    tma_aligned)
