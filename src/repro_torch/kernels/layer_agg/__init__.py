from repro_torch.kernels.layer_agg.layer_agg import (  # noqa: F401
    layer_agg, layer_agg_plain, load_library)
