from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: F401
    attention_plain, flash_attention, flash_attention_bhsd, load_library)
