from repro_torch.kernels.rmsnorm.rmsnorm import (  # noqa: F401
    load_library, rmsnorm, rmsnorm_bwd_blocked, rmsnorm_op, rmsnorm_plain,
    rmsnorm_route)
