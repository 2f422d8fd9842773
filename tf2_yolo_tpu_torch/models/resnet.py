"""ResNet-50/101/152, v1 and v2 (pre-activation), backbones (NHWC).

Port of tf2_yolo_tpu/models/resnet.py, the keras.applications
structure: a 7x7 stride-2 stem after a zero pad of 3 (VALID, not SAME),
a 3x3 stride-2 max pool after a zero pad of 1, then bottleneck stages of
(3, 4, 6, 3), (3, 4, 23, 3) or (3, 8, 36, 3) blocks, returning the stage
outputs (c3, c4, c5) at strides 8, 16 and 32 (512, 1024 and 2048
channels). Submodules carry the flax names (``stem_conv``, ``stem_bn``,
``stage{i}_block{j}`` with ``conv1``-``conv3``, ``bn1``-``bn3``,
``short_conv``, ``short_bn``, v2's ``pre_bn`` and ``post_bn``), each a
``Conv`` or a ``BNState`` (keras BN: eps 1.001e-5, momentum 0.99),
paired by :func:`~.layers.conv_then_bn`. Kernels are glorot-uniform, as
keras builds them. Every conv runs on the conv kernel: the stem on its
small-Ci route with the explicit pad, the 1x1 stride-2 projections and
v1's strided ``conv1`` on the ring route, v2's 3x3 stride-2 ``conv2``
with flax's SAME.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (RESNET_BN, BNState, Conv, conv_then_bn, glorot_uniform_,
                     max_pool)

DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _conv(ci, co, k, stride=1, use_bias=True, padding="same", **kw):
    return Conv(ci, co, k, stride, use_bias, init=glorot_uniform_,
                padding=padding, **kw)


def _bn(features, device):
    return BNState(features, device, **RESNET_BN)


class BottleneckV1(nn.Module):
    """Post-activation bottleneck (keras resnet v1): the stride on the
    first 1x1 conv and on the projection; every conv biased, each
    followed by BN."""

    def __init__(self, ci, filters, stride=1, project=False,
                 dtype=torch.float32, generator=None, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        f = filters
        self.project = project
        if project:
            self.short_conv = _conv(ci, 4 * f, 1, stride, **kw)
            self.short_bn = _bn(4 * f, device)
        self.conv1 = _conv(ci, f, 1, stride, **kw)
        self.bn1 = _bn(f, device)
        self.conv2 = _conv(f, f, 3, **kw)
        self.bn2 = _bn(f, device)
        self.conv3 = _conv(f, 4 * f, 1, **kw)
        self.bn3 = _bn(4 * f, device)

    def forward(self, x):
        shortcut = x
        if self.project:
            shortcut = conv_then_bn(self.short_conv, self.short_bn, x)
        y = F.relu(conv_then_bn(self.conv1, self.bn1, x))
        y = F.relu(conv_then_bn(self.conv2, self.bn2, y))
        y = conv_then_bn(self.conv3, self.bn3, y)
        return F.relu(shortcut + y)


class BottleneckV2(nn.Module):
    """Pre-activation bottleneck (keras resnet_v2): BN + ReLU of the input
    first (``pre_bn``, normalised without a conv before it), the stride on
    the 3x3 conv, the projection from the pre-activated input; ``conv1``
    and ``conv2`` unbiased, ``conv3`` and ``short_conv`` biased without
    BN."""

    def __init__(self, ci, filters, stride=1, project=False,
                 dtype=torch.float32, generator=None, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        f = filters
        self.project = project
        self.stride = stride
        self.pre_bn = _bn(ci, device)
        if project:
            self.short_conv = _conv(ci, 4 * f, 1, stride, **kw)
        self.conv1 = _conv(ci, f, 1, use_bias=False, **kw)
        self.bn1 = _bn(f, device)
        self.conv2 = _conv(f, f, 3, stride, use_bias=False, **kw)
        self.bn2 = _bn(f, device)
        self.conv3 = _conv(f, 4 * f, 1, **kw)

    def forward(self, x):
        pre = F.relu(self.pre_bn(x))
        if self.project:
            shortcut = self.short_conv(pre)[0]
        elif self.stride > 1:
            shortcut = max_pool(x, 1, self.stride, "SAME")
        else:
            shortcut = x
        y = F.relu(conv_then_bn(self.conv1, self.bn1, pre))
        y = F.relu(conv_then_bn(self.conv2, self.bn2, y))
        return shortcut + self.conv3(y)[0]


class ResNet(nn.Module):
    """ResNet backbone: ``forward(x)`` returns (c3, c4, c5).

    Args:
        depth: 50, 101 or 152.
        preact: False for v1, True for v2 (pre-activation blocks, no BN
            after the stem, a final ``post_bn`` + ReLU on c5).
    """

    def __init__(self, depth=50, preact=False, dtype=torch.float32,
                 generator=None, device="cuda"):
        super().__init__()
        if depth not in DEPTHS:
            raise ValueError(f"ResNet depth {depth}: 50, 101 or 152")
        kw = dict(dtype=dtype, generator=generator, device=device)
        block = BottleneckV2 if preact else BottleneckV1
        self.preact = preact
        self.stem_conv = _conv(3, 64, 7, 2, padding=3, **kw)
        if not preact:
            self.stem_bn = _bn(64, device)
        ci, self.stages = 64, []
        for stage, (filters, blocks) in enumerate(
                zip((64, 128, 256, 512), DEPTHS[depth])):
            names = []
            for b in range(blocks):
                name = f"stage{stage + 1}_block{b + 1}"
                self.add_module(name, block(
                    ci, filters, stride=2 if b == 0 and stage else 1,
                    project=b == 0, **kw))
                names.append(name)
                ci = 4 * filters
            self.stages.append(names)
        if preact:
            self.post_bn = _bn(ci, device)
        self.out_channels = (512, 1024, 2048)

    def stem(self, x):
        """The stem conv (BN and ReLU in v1) and the 3x3 stride-2 max
        pool after a zero pad of 1: stride 4."""
        if self.preact:
            x = self.stem_conv(x)[0]
        else:
            x = F.relu(conv_then_bn(self.stem_conv, self.stem_bn, x))
        # the keras pool pads with zeros, not -inf: v2's stem output is
        # not activated and may be negative there
        return max_pool(F.pad(x, (0, 0, 1, 1, 1, 1)), 3, 2)

    def forward(self, x):
        x = self.stem(x)
        taps = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            taps.append(x)
        c5 = F.relu(self.post_bn(taps[3])) if self.preact else taps[3]
        return taps[1], taps[2], c5
