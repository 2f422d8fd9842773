"""MobileNetV2 backbone (NHWC), alpha 1.0.

Port of tf2_yolo_tpu/models/mobilenet.py: a 3x3 stride-2 SAME stem
(Ci = 3, the conv kernel's small-Ci route), 17 inverted-residual blocks
(``block1``-``block17``: a 1x1 expansion but in the first, a depthwise
3x3, a 1x1 projection, the residual added at stride 1 with equal
channels), a 1x1 head to 1280 channels; ReLU6 after every BN but the
projection's; output stride 32. Every conv is unbiased and
glorot-uniform, every BN keras's (eps 1e-3, momentum 0.999), submodules
named as the flax ones (``stem_conv``, ``expand_conv``, ``dw_conv``,
``project_conv``, ``head_conv`` and their ``*_bn``). The dense convs run
on the conv kernel (its CUDA-core route where Ci is 16, 24 or 144, not
a multiple of 32); the depthwise convs are the library's grouped conv
(``layers.depthwise_conv``).
"""

import torch
from torch import nn

from .layers import (MOBILENET_BN, BNState, Conv, DepthwiseConv,
                     conv_then_bn, depthwise_then_bn, glorot_uniform_, relu6)

# (filters, stride, expand, repeats)
BLOCKS = [
    (16, 1, 1, 1),
    (24, 2, 6, 2),
    (32, 2, 6, 3),
    (64, 2, 6, 4),
    (96, 1, 6, 3),
    (160, 2, 6, 3),
    (320, 1, 6, 1),
]


def _conv(ci, co, k, stride=1, **kw):
    return Conv(ci, co, k, stride, False, init=glorot_uniform_,
                padding="same", **kw)


def _bn(features, device):
    return BNState(features, device, **MOBILENET_BN)


class InvertedResidual(nn.Module):
    def __init__(self, ci, filters, stride=1, expand=6,
                 dtype=torch.float32, generator=None, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        mid = ci * expand
        self.expand = expand != 1
        if self.expand:
            self.expand_conv = _conv(ci, mid, 1, **kw)
            self.expand_bn = _bn(mid, device)
        self.dw_conv = DepthwiseConv(mid, 3, stride, **kw)
        self.dw_bn = _bn(mid, device)
        self.project_conv = _conv(mid, filters, 1, **kw)
        self.project_bn = _bn(filters, device)
        self.residual = stride == 1 and ci == filters

    def forward(self, x):
        y = x
        if self.expand:
            y = relu6(conv_then_bn(self.expand_conv, self.expand_bn, y))
        y = relu6(depthwise_then_bn(self.dw_conv, self.dw_bn, y))
        y = conv_then_bn(self.project_conv, self.project_bn, y)
        return x + y if self.residual else y


class MobileNetV2(nn.Module):
    """MobileNetV2 feature extractor: (N, H, W, 3) -> (N, H/32, W/32,
    1280)."""

    def __init__(self, dtype=torch.float32, generator=None, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.stem_conv = _conv(3, 32, 3, 2, **kw)
        self.stem_bn = _bn(32, device)
        ci, i = 32, 0
        for filters, stride, expand, repeats in BLOCKS:
            for r in range(repeats):
                i += 1
                self.add_module(f"block{i}", InvertedResidual(
                    ci, filters, stride if r == 0 else 1, expand, **kw))
                ci = filters
        self.blocks = i
        self.head_conv = _conv(ci, 1280, 1, **kw)
        self.head_bn = _bn(1280, device)
        self.out_channels = 1280

    def forward(self, x):
        x = relu6(conv_then_bn(self.stem_conv, self.stem_bn, x))
        for i in range(self.blocks):
            x = getattr(self, f"block{i + 1}")(x)
        return relu6(conv_then_bn(self.head_conv, self.head_bn, x))
