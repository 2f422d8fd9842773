"""The backbones of the four YOLO families (NHWC).

Port of tf2_yolo_tpu/models/backbones.py: ``DarknetV1`` (v1),
``Darknet19`` and ``UNetBody`` (v2), ``ResBlock``, ``Darknet53`` and
``TinyDarknet`` (v3), and ``CSPResBlock``, ``CSPStage`` and
``CSPDarknet53`` (v4: the plain path, the fused-GEMM path of stages 3-5
and the all-fused path of stages 1-2), and ``Classifier``, the GAP +
softmax top of the classifier functions (:mod:`.classifiers`). Submodule
names follow the flax names: the named ones (``stem``, ``stage3_block2.expand``,
``stage3.block2.expand``, ...) and, where the JAX module builds its convs
unnamed inside ``@nn.compact``, flax's automatic ``ConvBN_0``,
``ConvBN_1``, ... (``ConvActBN_0``, ... in the UNet) in call order. The
v4 convs use the DarknetConv2D init, RandomNormal(0, 0.02); the others
HE_NORMAL.
"""

import torch
from torch import nn

from .layers import (ConvActBN, ConvBN, Dense, darknet_normal_, he_normal_,
                     max_pool, upsample2x)
from .packed_region import (activate, p3_stage, packed_conv3x3,
                            packed_stage, rows_to)


class _Sequence(nn.Module):
    """Numbers its convs as flax numbers unnamed submodules: the i-th
    module of class ``cls`` is ``{cls.__name__}_{i}``. ``add(cls, co,
    *args)`` builds the next one on the running channel count and
    returns its name."""

    def __init__(self, ci, **kw):
        super().__init__()
        self._ci = ci
        self._kw = kw
        self._counts = {}

    def add(self, cls, co, *args, **extra):
        i = self._counts.get(cls.__name__, 0)
        self._counts[cls.__name__] = i + 1
        name = f"{cls.__name__}_{i}"
        self.add_module(name, cls(self._ci, co, *args, **self._kw, **extra))
        self._ci = co
        return name


def _v12_conv(**kw):
    """The v1/v2 Darknet conv: biased, BN, leaky, flax's SAME."""
    return dict(act="leaky", use_bias=True, darknet_pad=False, **kw)


class DarknetV1(_Sequence):
    """24-conv DarkNet-v1 body (23 ConvBNs): output stride 64 (448^2 ->
    7^2), 1024 channels. Every conv is SAME, biased, BN + leaky; the
    stem is 7x7 stride 2 and the 14^2 -> 7^2 conv 3x3 stride 2."""

    # (features, kernel, stride) in order; "pool" a 2x2 VALID max pool
    PLAN = ([(64, 7, 2), "pool", (192, 3, 1), "pool",
             (128, 1, 1), (256, 3, 1), (256, 1, 1), (512, 3, 1), "pool"]
            + [(256, 1, 1), (512, 3, 1)] * 4
            + [(1024, 3, 1), "pool", (512, 1, 1), (1024, 3, 1),
               (512, 1, 1), (1024, 3, 1), (1024, 3, 1), (1024, 3, 2),
               (1024, 3, 1), (1024, 3, 1)])

    def __init__(self, **kw):
        super().__init__(3, **_v12_conv(**kw))
        self.steps = [step if step == "pool" else self.add(ConvBN, *step)
                      for step in self.PLAN]

    def forward(self, x):
        for step in self.steps:
            x = max_pool(x) if step == "pool" else getattr(self, step)(x)
        return x


class Darknet19(_Sequence):
    """DarkNet-19 body. Returns (passthrough, out): the stride-16 512-ch
    feature (the last conv before the fifth pool) and the stride-32
    1024-ch output."""

    PLAN = ([(32, 3), "pool", (64, 3), "pool", (128, 3), (64, 1), (128, 3),
             "pool", (256, 3), (128, 1), (256, 3), "pool", (512, 3),
             (256, 1), (512, 3), (256, 1), (512, 3), "tap", "pool"]
            + [(1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)])

    def __init__(self, **kw):
        super().__init__(3, **_v12_conv(**kw))
        self.steps = [step if isinstance(step, str) else self.add(ConvBN,
                                                                  *step)
                      for step in self.PLAN]

    def forward(self, x):
        tap = None
        for step in self.steps:
            if step == "pool":
                x = max_pool(x)
            elif step == "tap":
                tap = x
            else:
                x = getattr(self, step)(x)
        return tap, x


class UNetBody(_Sequence):
    """Encoder-decoder UNet body, the v2 alternative backbone: five
    encoder stages of two 3x3 ConvActBNs (64 .. 1024) each followed by a
    2x2 max pool, then two decoder stages (upsample, a 2x2 ConvActBN,
    concat with the stride-16 / stride-8 skip, two 3x3 ConvActBNs).
    Output stride 32 (five pools, two up-merges... of a stride-128
    bottom), 256 channels."""

    def __init__(self, **kw):
        super().__init__(3, **kw)
        self.encoder = []
        for f in (64, 128, 256, 512, 1024):
            self.encoder.append((self.add(ConvActBN, f),
                                 self.add(ConvActBN, f)))
        self.decoder = []
        for f, skip in ((512, 1024), (256, 512)):
            up = self.add(ConvActBN, f, 2)
            self._ci = skip + f
            self.decoder.append((up, self.add(ConvActBN, f),
                                 self.add(ConvActBN, f)))

    def forward(self, x):
        skips = []
        for a, b in self.encoder:
            x = getattr(self, b)(getattr(self, a)(x))
            skips.append(x)
            x = max_pool(x)
        for (up, a, b), skip in zip(self.decoder, (skips[4], skips[3])):
            x = getattr(self, up)(upsample2x(x))
            x = torch.cat([skip, x], dim=-1)
            x = getattr(self, b)(getattr(self, a)(x))
        return x


class ResBlock(nn.Module):
    """Darknet-53 residual block: x + expand(squeeze(x)), a 1x1 to half
    the features and a 3x3 back, leaky."""

    def __init__(self, features, **kw):
        super().__init__()
        self.squeeze = ConvBN(features, features // 2, 1, act="leaky", **kw)
        self.expand = ConvBN(features // 2, features, 3, act="leaky", **kw)

    def forward(self, x):
        return x + self.expand(self.squeeze(x))


class Darknet53(nn.Module):
    """Darknet-53 body: ``stem`` and five stages of a 3x3 stride-2
    ``stage{i}_down`` (darknet pad) and ``stage{i}_block{b}`` ResBlocks
    (1, 2, 8, 8, 4). Returns (c3, c4, c5): the stride-8 256-ch, stride-16
    512-ch and stride-32 1024-ch stage outputs. 52 ConvBNs."""

    out_channels = (256, 512, 1024)

    SPECS = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))

    def __init__(self, **kw):
        super().__init__()
        self.stem = ConvBN(3, 32, 3, act="leaky", **kw)
        ci = 32
        for i, (f, blocks) in enumerate(self.SPECS):
            self.add_module(f"stage{i + 1}_down",
                            ConvBN(ci, f, 3, 2, act="leaky", **kw))
            for b in range(blocks):
                self.add_module(f"stage{i + 1}_block{b + 1}",
                                ResBlock(f, **kw))
            ci = f

    def forward(self, x):
        x = self.stem(x)
        taps = []
        for i, (_, blocks) in enumerate(self.SPECS):
            x = getattr(self, f"stage{i + 1}_down")(x)
            for b in range(blocks):
                x = getattr(self, f"stage{i + 1}_block{b + 1}")(x)
            taps.append(x)
        return taps[2], taps[3], taps[4]


class TinyDarknet(_Sequence):
    """Tiny YOLOv3 backbone: 3x3 convs (16 .. 512) with 2x2 SAME max
    pools, the last of stride 1, then 1024 3x3 and a 256 1x1 bottleneck.
    Returns (c4, c5pre): the stride-16 256-ch tap and the stride-32
    256-ch bottleneck. 8 ConvBNs (darknet defaults: unbiased, leaky)."""

    PLAN = ([(16, 3), "pool", (32, 3), "pool", (64, 3), "pool", (128, 3),
             "pool", (256, 3), "tap", "pool", (512, 3), "pool1",
             (1024, 3), (256, 1)])

    def __init__(self, **kw):
        super().__init__(3, act="leaky", **kw)
        self.steps = [step if isinstance(step, str) else self.add(ConvBN,
                                                                  *step)
                      for step in self.PLAN]

    def forward(self, x):
        tap = None
        for step in self.steps:
            if step == "pool":
                x = max_pool(x, 2, 2, "SAME")
            elif step == "pool1":
                x = max_pool(x, 2, 1, "SAME")     # the stride-1 pool
            elif step == "tap":
                tap = x
            else:
                x = getattr(self, step)(x)
        return tap, x


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
    order.

    ``section`` cuts the body for pipeline parallelism: "early" runs the
    stem and stages 1-3 and returns c3; "late" takes ``x`` AS c3, runs
    stages 4-5 and returns (c4, c5). Each section takes the route that
    ``packed`` gives its stages in the whole body."""

    out_channels = (256, 512, 1024)

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

    def forward(self, x, section=None):
        if section not in (None, "early", "late"):
            raise ValueError(f"Invalid section: {section!r}")
        packed = self.packed if self.training else 0
        first = 3 if section == "late" else 0
        last = 3 if section == "early" else len(self.SPECS)
        if section != "late" and packed == 3:
            y4, aff = packed_conv3x3(self.stem, x)
            y2, aff, (b, h, w) = p3_stage(self.stage1, y4, aff)
            y2, aff, (b, h, w) = p3_stage(self.stage2,
                                          rows_to(y2, b, h, w), aff)
            x = rows_to(activate(y2, aff, "mish", self.stage2.out.dtype),
                        b, h, w)
            first = 2
        elif section != "late":
            x = self.stem(x)
        taps = {}
        for i in range(first, last):
            stage = getattr(self, f"stage{i + 1}")
            if packed and i >= 2:
                y2, aff, (b, h, w) = packed_stage(stage, x)
                x = rows_to(activate(y2, aff, "mish", stage.out.dtype),
                            b, h, w)
            else:
                x = stage(x)
            taps[i] = x
        if section == "early":
            return taps[2]
        if section == "late":
            return taps[3], taps[4]
        return taps[2], taps[3], taps[4]


class Classifier(nn.Module):
    """GAP + softmax classifier top of the darknet, darknet19, darknet53
    and csp_darknet53 functions (``Classifier`` of the JAX package): the
    ``backbone`` module's last output (of ``features`` channels, 1024 for
    every darknet body) goes through the 1x1 conv head ``ConvBN_0``
    (biased, BN, leaky, HE_NORMAL; ``conv_head``, darknet19) and a
    global average pool, or a global average pool and the Dense layer
    ``Dense_0``, then a softmax over ``class_num`` classes, in the
    compute dtype."""

    def __init__(self, backbone, class_num=1000, conv_head=False,
                 features=1024, dtype=torch.float32, generator=None,
                 device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.backbone = backbone
        self.conv_head = conv_head
        if conv_head:
            self.ConvBN_0 = ConvBN(features, class_num, 1, act="leaky",
                                   use_bias=True, darknet_pad=False,
                                   init=he_normal_, **kw)
        else:
            self.Dense_0 = Dense(features, class_num, **kw)

    def forward(self, x):
        feats = self.backbone(x)
        if isinstance(feats, tuple):
            feats = feats[-1]
        if self.conv_head:
            return torch.softmax(self.ConvBN_0(feats).mean(dim=(1, 2)), -1)
        return torch.softmax(self.Dense_0(feats.mean(dim=(1, 2))), -1)
