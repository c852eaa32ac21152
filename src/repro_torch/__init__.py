"""PyTorch/CUDA port of the DR-FL reproduction (``repro``), for one H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module layout (``repro_torch.fl.engine`` <-> ``repro.fl.engine``, ...) and
imports neither ``jax`` nor anything of ``repro``.  Parameters are nested
dicts of tensors in the JAX tree layout, with convolution kernels stored
OIHW (see :mod:`repro_torch.convert`).

Entry points, in :mod:`repro_torch.fl` (which exports every public name
of ``repro.fl``): :func:`~repro_torch.fl.run_simulation`, on a flat
``FLConfig`` or a typed ``SimulationSpec``, and the gym-style
:class:`~repro_torch.fl.FLEnv`; both run on ``"cuda"`` unless the caller
passes ``device="cpu"``.
"""
import torch

# The reference computes in full float32.  cuDNN convolutions default to
# TF32 (about three decimal digits), so both TF32 switches are turned off
# here, once, for every module of the port.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
