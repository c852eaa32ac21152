from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: F401
    attention_plain, attention_plain_model, flash_attention,
    flash_attention_bhsd, fused_backward, load_library)
