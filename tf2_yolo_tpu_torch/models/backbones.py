"""CSPDarknet-53, the YOLOv4 backbone (eval mode, NHWC).

Port of ``CSPResBlock``, ``CSPStage`` and the plain path of
``CSPDarknet53`` in tf2_yolo_tpu/models/backbones.py. Submodule names
follow the flax names (``stem``, ``stage3.block2.expand``, ...). Every
conv uses the v4 DarknetConv2D init, RandomNormal(0, 0.02).
"""

import torch
from torch import nn

from .layers import ConvBN, darknet_normal_


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
    stride-16 512-ch and stride-32 1024-ch stage outputs."""

    SPECS = ((64, 1, False), (128, 2, True), (256, 8, True),
             (512, 8, True), (1024, 4, True))

    def __init__(self, **kw):
        super().__init__()
        self.stem = _cbn(3, 32, 3, **kw)
        ci = 32
        for i, (f, blocks, narrow) in enumerate(self.SPECS):
            self.add_module(f"stage{i + 1}",
                            CSPStage(ci, f, blocks, narrow, **kw))
            ci = f

    def forward(self, x):
        x = self.stem(x)
        taps = []
        for i in range(len(self.SPECS)):
            x = getattr(self, f"stage{i + 1}")(x)
            taps.append(x)
        return taps[2], taps[3], taps[4]
