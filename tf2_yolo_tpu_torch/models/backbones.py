"""CSPDarknet-53, the YOLOv4 backbone (NHWC).

Port of ``CSPResBlock``, ``CSPStage`` and ``CSPDarknet53`` (the plain
path, the fused-GEMM path of stages 3-5 and the all-fused path of stages
1-2) in tf2_yolo_tpu/models/backbones.py. Submodule names follow the flax names
(``stem``, ``stage3.block2.expand``, ...). Every conv uses the v4
DarknetConv2D init, RandomNormal(0, 0.02).
"""

import torch
from torch import nn

from .layers import ConvBN, darknet_normal_
from .packed_region import (activate, p3_stage, packed_conv3x3,
                            packed_stage, rows_to)


def _cbn(ci, co, k, stride=1, **kw):
    return ConvBN(ci, co, k, stride, act="mish", init=darknet_normal_, **kw)


class CSPResBlock(nn.Module):
    """x + expand(squeeze(x)): 1x1 to ``mid``, 3x3 back to ``out``."""

    def __init__(self, mid, out, **kw):
        super().__init__()
        self.squeeze = _cbn(out, mid, 1, **kw)
        self.expand = _cbn(mid, out, 3, **kw)

    def forward(self, x):
        return x + self.expand(self.squeeze(x))


class CSPStage(nn.Module):
    """Cross-stage-partial stage: stride-2 down, a cross path and a
    residual stack, concat [stack, cross], 1x1 fuse."""

    def __init__(self, ci, features, blocks, narrow=True, **kw):
        super().__init__()
        mid = features // 2 if narrow else features
        self.down = _cbn(ci, features, 3, 2, **kw)
        self.cross = _cbn(features, mid, 1, **kw)
        self.pre = _cbn(features, mid, 1, **kw)
        self.blocks = blocks
        for b in range(blocks):
            self.add_module(f"block{b + 1}",
                            CSPResBlock(features // 2, mid, **kw))
        self.post = _cbn(mid, mid, 1, **kw)
        self.out = _cbn(2 * mid, features, 1, **kw)

    def forward(self, x):
        x = self.down(x)
        cross = self.cross(x)
        x = self.pre(x)
        for b in range(self.blocks):
            x = getattr(self, f"block{b + 1}")(x)
        x = self.post(x)
        return self.out(torch.cat([x, cross], dim=-1))


class CSPDarknet53(nn.Module):
    """Stem + five CSP stages. Returns (c3, c4, c5): the stride-8 256-ch,
    stride-16 512-ch and stride-32 1024-ch stage outputs.

    ``packed`` takes the values of the JAX training benchmark's
    ``BENCH_PACKED``. ``True`` (or 1) runs stages 3-5 through the fused
    GEMMs of :mod:`.packed_region` in train mode, with the stem and
    stages 1-2 on the plain path. ``3`` also runs stages 1-2 all fused:
    the stem hands over its raw output and affine, the 3x3 and stride-2
    convs are ``fused_conv3x3``, the residual chains are term lists read
    by sum-GEMMs, and the result is activated once before stage 3; any
    batch size takes this route. ``2`` (stages 1-2 batch-packed into the
    TPU's lanes) is the same computation as 1 without lane packing and
    raises. ``False`` (or 0) and eval mode take the plain path
    throughout. Same parameters and the same math up to summation
    order."""

    SPECS = ((64, 1, False), (128, 2, True), (256, 8, True),
             (512, 8, True), (1024, 4, True))

    def __init__(self, packed=False, **kw):
        super().__init__()
        if packed not in (0, 1, 3):          # False == 0, True == 1
            raise ValueError(
                f"packed takes False/0, True/1 or 3, got {packed!r}")
        self.packed = int(packed)
        self.stem = _cbn(3, 32, 3, **kw)
        ci = 32
        for i, (f, blocks, narrow) in enumerate(self.SPECS):
            self.add_module(f"stage{i + 1}",
                            CSPStage(ci, f, blocks, narrow, **kw))
            ci = f

    def forward(self, x):
        packed = self.packed if self.training else 0
        first = 0
        if packed == 3:
            y4, aff = packed_conv3x3(self.stem, x)
            y2, aff, (b, h, w) = p3_stage(self.stage1, y4, aff)
            y2, aff, (b, h, w) = p3_stage(self.stage2,
                                          rows_to(y2, b, h, w), aff)
            x = rows_to(activate(y2, aff, "mish", self.stage2.out.dtype),
                        b, h, w)
            first = 2
        else:
            x = self.stem(x)
        taps = {}
        for i in range(first, len(self.SPECS)):
            stage = getattr(self, f"stage{i + 1}")
            if packed and i >= 2:
                y2, aff, (b, h, w) = packed_stage(stage, x)
                x = rows_to(activate(y2, aff, "mish", stage.out.dtype),
                            b, h, w)
            else:
                x = stage(x)
            taps[i] = x
        return taps[2], taps[3], taps[4]
