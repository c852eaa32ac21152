"""Multi-exit ResNet-18 (paper §5.1.1) — port of ``repro.models.cnn``.

Model_m = stem + stages[0..m] + exit[m]; exit head = 1x1 bottleneck conv +
GroupNorm + global average pool + linear classifier.

Layouts: public functions take images NHWC, as the JAX package does, and
run NCHW inside; convolution kernels are stored OIHW (the JAX tree holds
HWIO, :mod:`repro_torch.convert` transposes).  Numerics follow the
reference exactly:

* SAME padding is TensorFlow's, asymmetric at stride 2 (``cnn.py:54-81``):
  a stride-2 3x3 conv on an even image pads top/left 0 and bottom/right 1,
  which ``padding=1`` would get wrong, so the pad is computed and applied
  with ``F.pad`` before an unpadded ``F.conv2d``;
* GroupNorm uses ``min(8, C)`` groups, lowered until it divides C
  (``cnn.py:88-99``), with the biased variance and eps 1e-5, written out
  as the reference writes it.  ATen's fused float32 ``group_norm`` (and
  ``var_mean``'s one-pass variance) train differently on some batches
  (a client with a few samples of one label: its gradients left the
  reference's, which stayed at float64's), far enough to move a live run
  past the tests' tolerance.  The written-out form costs a per-client
  step on the H100 more than the fused kernel
  (``scripts/groupnorm_ab.py``, ``PERF.md``).

Convolutions and GroupNorm had no Pallas kernel; they stay ATen/cuDNN ops.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.family import LayerwiseFamily, register_family

STAGE_CHANNELS = (64, 128, 256, 512)
BLOCKS_PER_STAGE = 2
#: image batch layout change at the public boundary
NHWC_TO_NCHW = (0, 3, 1, 2)


def _build(make, num_classes: int, in_channels: int, width_mult: float):
    """The parameter tree, with ``make(kind, shape)`` making each leaf."""
    chans = [max(8, int(c * width_mult)) for c in STAGE_CHANNELS]

    def conv(kh, kw, cin, cout):
        return make("conv", (cout, cin, kh, kw))            # OIHW

    def gn(c):
        return {"scale": make("ones", (c,)), "bias": make("zeros", (c,))}

    params = {"stem": {"conv": conv(3, 3, in_channels, chans[0]),
                       "gn": gn(chans[0])},
              "stages": [], "exits": []}
    cin = chans[0]
    for si, cout in enumerate(chans):
        blocks = []
        for bi in range(BLOCKS_PER_STAGE):
            stride = 2 if (bi == 0 and si > 0) else 1
            p = {"conv1": conv(3, 3, cin, cout), "gn1": gn(cout),
                 "conv2": conv(3, 3, cout, cout), "gn2": gn(cout)}
            if stride != 1 or cin != cout:
                p["proj"] = conv(1, 1, cin, cout)
            blocks.append(p)
            cin = cout
        params["stages"].append(blocks)
        bott = max(16, cout // 2)
        params["exits"].append({"bottleneck": conv(1, 1, cout, bott),
                                "gn": gn(bott),
                                "w": make("head", (bott, num_classes)),
                                "b": make("zeros", (num_classes,))})
    return params


def init(gen: torch.Generator, num_classes: int = 10, in_channels: int = 3,
         width_mult: float = 1.0):
    """He-normal convs, unit GroupNorm, N(0, 1/bott) heads — the reference's
    distributions, drawn from ``gen`` on the CPU."""
    def make(kind, shape):
        if kind == "conv":
            fan_in = shape[1] * shape[2] * shape[3]
            return torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)
        if kind == "head":
            return torch.randn(shape, generator=gen) / math.sqrt(shape[0])
        return torch.ones(shape) if kind == "ones" else torch.zeros(shape)
    return _build(make, num_classes, in_channels, width_mult)


def param_shapes(num_classes: int = 10, in_channels: int = 3,
                 width_mult: float = 1.0):
    """The same tree of meta tensors: shapes and dtypes, no storage."""
    return _build(lambda kind, shape: torch.empty(shape, device="meta"),
                  num_classes, in_channels, width_mult)


def _conv(x, w, stride: int = 1):
    """TF SAME conv on NCHW ``x`` with OIHW ``w`` (``cnn.py:54-81``)."""
    kh, kw = w.shape[2], w.shape[3]
    H, W = x.shape[-2], x.shape[-1]
    ph = max((-(-H // stride) - 1) * stride + kh - H, 0)
    pw = max((-(-W // stride) - 1) * stride + kw - W, 0)
    if ph or pw:
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return F.conv2d(x, w, stride=stride)


def _groupnorm(p, x, groups: int = 8):
    """The reference's expression (``cnn.py:88-99``), op for op: the
    group mean, the mean square of ``x - mean``, then the scale and the
    bias, so autograd differentiates what JAX differentiates."""
    B, C = x.shape[:2]
    g = min(groups, C)
    while C % g:
        g -= 1
    xg = x.reshape(B, g, -1)
    centered = xg - xg.mean(dim=-1, keepdim=True)
    var = (centered * centered).mean(dim=-1, keepdim=True)
    y = (centered * torch.rsqrt(var + 1e-5)).reshape(x.shape)
    shape = (1, C) + (1,) * (x.dim() - 2)
    return y * p["scale"].reshape(shape) + p["bias"].reshape(shape)


def _basic_block(p, x, stride: int):
    h = torch.relu(_groupnorm(p["gn1"], _conv(x, p["conv1"], stride)))
    h = _groupnorm(p["gn2"], _conv(h, p["conv2"]))
    sc = _conv(x, p["proj"], stride) if "proj" in p else x
    return torch.relu(h + sc)


def _exit_head(p, x):
    h = torch.relu(_groupnorm(p["gn"], _conv(x, p["bottleneck"])))
    return h.mean(dim=(2, 3)) @ p["w"] + p["b"]


def apply_all_exits(params, x):
    """x [B, H, W, C] (NHWC) -> logits of every exit ``params`` holds
    (truncated submodel trees included)."""
    h = x.permute(NHWC_TO_NCHW)
    h = torch.relu(_groupnorm(params["stem"]["gn"],
                              _conv(h, params["stem"]["conv"])))
    outs = []
    for si, stage in enumerate(params["stages"]):
        for bi, bp in enumerate(stage):
            h = _basic_block(bp, h, 2 if (bi == 0 and si > 0) else 1)
        outs.append(_exit_head(params["exits"][si], h))
    return outs


def flops_per_sample(model_idx: int, image_hw: int = 32,
                     width_mult: float = 1.0) -> float:
    """Rough analytic forward FLOPs for Model_{idx+1} (energy-model input),
    the reference's formula."""
    chans = [max(8, int(c * width_mult)) for c in STAGE_CHANNELS]
    total, hw, cin = 0.0, image_hw, 3
    total += 2 * 9 * cin * chans[0] * hw * hw
    cin = chans[0]
    for si in range(model_idx + 1):
        cout = chans[si]
        hw = hw // (2 if si > 0 else 1)
        for _ in range(BLOCKS_PER_STAGE):
            total += 2 * 9 * cin * cout * hw * hw
            total += 2 * 9 * cout * cout * hw * hw
            cin = cout
    total += 2 * cin * max(16, cin // 2) * hw * hw
    return total


class CnnFamily(LayerwiseFamily):
    """The paper's multi-exit ResNet-18; the one family with all three FL
    methods (HeteroFL/ScaleFL submodels are channel-prefix slices,
    :mod:`repro_torch.core.baselines`)."""

    name = "cnn"
    supported_methods = ("drfl", "heterofl", "scalefl")

    def init(self, gen: torch.Generator, num_classes: int = 10,
             width_mult: float = 1.0, hw: int = 32):
        # parameters do not depend on the image size
        return init(gen, num_classes, width_mult=width_mult)

    def param_shapes(self, num_classes: int = 10, width_mult: float = 1.0,
                     hw: int = 32):
        return param_shapes(num_classes, width_mult=width_mult)

    def num_submodels(self) -> int:
        return len(STAGE_CHANNELS)

    def apply_all_exits(self, params, x):
        return apply_all_exits(params, x)

    def flops_per_sample(self, model_idx: int, image_hw: int = 32,
                         width_mult: float = 1.0) -> float:
        return flops_per_sample(model_idx, image_hw, width_mult)

    def submodel_params(self, method: str, global_params, model_idx: int):
        from repro_torch.core.baselines import (WIDTH_LEVELS,
                                                scalefl_submodel,
                                                width_slice_cnn)
        if method == "heterofl":
            return width_slice_cnn(global_params, WIDTH_LEVELS[model_idx])
        if method == "scalefl":
            return scalefl_submodel(global_params, model_idx)
        return super().submodel_params(method, global_params, model_idx)


register_family(CnnFamily())
