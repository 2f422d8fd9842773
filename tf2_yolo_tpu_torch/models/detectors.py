"""The detector networks: backbone + neck + head(s) of each family.

Port of ``_split_anchors``, ``FPNStage``, ``YoloV1``, ``YoloV2``,
``YoloV3`` and the full-network path of ``YoloV4`` in
tf2_yolo_tpu/models/detectors.py (NHWC; ``train()`` / ``eval()`` select
batch or running BatchNorm statistics). The concat orders, the
coarse-to-fine output order and the flat channel layouts are the JAX
package's:

- v1: one (N, S, S, 5 B + C) output;
- v2: one (N, S, S, B (5 + C)) output;
- v3/v4: a list [coarse (stride 32), mid (16), fine (8)] of those.

YOLOv4: 107 ConvBN layers (72 mish in the backbone, 35 leaky in the
neck, 7 of them stride 2) and 3 biased head convs. YOLOv3 (Darknet-53):
72 ConvBNs and 3 head convs; tiny: 13 in all. YOLOv2: 22 ConvBNs and a
head (darknet), or 16 ConvActBNs and a head (UNet), or MobileNetV2 and a
head. YOLOv3 and v4 also take the ResNets by name (``"resnet50"`` ...
``"resnet152v2"``) and a user backbone factory in place of their body.

``forward(x, pipeline_stage=None)`` cuts every family for pipeline
parallelism (``parallel.pipeline``): ``"backbone"`` runs the body alone
and returns its taps, ``"neck"`` takes ``x`` AS those taps and runs the
rest; YOLOv4 with its stock CSPDarknet-53 also cuts the body after
stage 3 (``"backbone_early"`` -> c3, ``"backbone_late"`` -> (c3, c4,
c5)). Each cut runs exactly the submodules of its part.
"""

import numpy as np
import torch
from torch import nn

from .backbones import (CSPDarknet53, Darknet19, Darknet53, DarknetV1,
                        TinyDarknet, UNetBody)
from .heads import AnchorHead, HeadV1
from .layers import (ConvBN, darknet_normal_, he_normal_, space_to_depth,
                     spp, upsample2x)
from .mobilenet import MobileNetV2
from .resnet import ResNet


def _resnet_from_name(name, **kw):
    """'resnet50', 'resnet101v2', ... -> a ResNet module."""
    preact = name.endswith("v2")
    depth = int(name[len("resnet"):-2] if preact else name[len("resnet"):])
    return ResNet(depth=depth, preact=preact, **kw)


def _custom_backbone(factory, kw):
    """A user backbone: ``factory(dtype=, generator=, device=)`` returns
    an ``nn.Module`` that maps NHWC images to the (c3, c4, c5) taps at
    strides 8, 16 and 32 and states their channels in ``out_channels``
    (the torch form of the JAX package's ``factory(bn_axis_name=, dtype=,
    name=)``, whose flax module is built lazily)."""
    module = factory(**kw)
    channels = getattr(module, "out_channels", None)
    if not isinstance(module, nn.Module) or \
            not isinstance(channels, (tuple, list)) or len(channels) != 3:
        raise ValueError(
            "a backbone factory must return an nn.Module with "
            "out_channels = (c3, c4, c5) channels of its three taps")
    return module


def _body(backbone, default, kw):
    """The v3/v4 body: (module, (c3, c4, c5) channels)."""
    if callable(backbone):
        module = _custom_backbone(backbone, kw)
    elif backbone.startswith("resnet"):
        module = _resnet_from_name(backbone, **kw)
    else:
        module = default(**kw)
    return module, tuple(module.out_channels)


def _check_pipeline_stage(stage, extra=()):
    """Validate a ``pipeline_stage`` value (parallel/pipeline.py cuts)."""
    if stage not in (None, "backbone", "neck") + tuple(extra):
        raise ValueError(f"Invalid pipeline_stage: {stage!r}")


def _split_anchors(anchors, num_levels):
    """Split a flat anchor list evenly across levels, coarse first."""
    anchors = np.asarray(anchors, np.float32)
    if len(anchors) % num_levels:
        raise ValueError(
            "The total number of anchor boxes should be a multiple of "
            f"the number {num_levels} of output tensors")
    per = len(anchors) // num_levels
    return [anchors[i * per:(i + 1) * per] for i in range(num_levels)]


def _neck(ci, co, k, stride=1, **kw):
    return ConvBN(ci, co, k, stride, act="leaky", init=darknet_normal_,
                  **kw)


class FPNStage(nn.Module):
    """The 5-conv stack: alternating 1x1 to ``features`` and 3x3 to
    2 * ``features``, leaky. ``make_out`` (v3) adds the 3x3 ``out`` conv
    to 2 * ``features``, and ``forward`` returns (x, out); without it
    (the v4 PAN) it returns x. ``init`` draws the kernels (v4:
    RandomNormal(0, 0.02), v3: HE_NORMAL)."""

    def __init__(self, ci, features, make_out=False, init=darknet_normal_,
                 **kw):
        super().__init__()
        f = features
        for i, (c_in, c_out, k) in enumerate(
                [(ci, f, 1), (f, 2 * f, 3), (2 * f, f, 1), (f, 2 * f, 3),
                 (2 * f, f, 1)]):
            self.add_module(f"conv{i + 1}",
                            ConvBN(c_in, c_out, k, act="leaky", init=init,
                                   **kw))
        self.out = (ConvBN(f, 2 * f, 3, act="leaky", init=init, **kw)
                    if make_out else None)

    def forward(self, x):
        for i in range(5):
            x = getattr(self, f"conv{i + 1}")(x)
        if self.out is None:
            return x
        return x, self.out(x)


class YoloV1(nn.Module):
    """DarkNet-v1 + the v1 head. ``forward(images)`` returns (N, S, S,
    5 B + C) f32, S = H / 64."""

    def __init__(self, bbox_num=2, class_num=1, dtype=torch.float32,
                 generator=None, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.plain = False
        self.backbone = DarknetV1(**kw)
        self.head = HeadV1(1024, bbox_num, class_num, **kw)

    def forward(self, x, pipeline_stage=None):
        """``pipeline_stage``: None runs the whole net; "backbone"
        returns the DarkNet-v1 feature map; "neck" takes ``x`` AS that
        feature and runs the head."""
        _check_pipeline_stage(pipeline_stage)
        if pipeline_stage != "neck":
            x = self.backbone(x)
        if pipeline_stage == "backbone":
            return x
        return self.head(x)


class YoloV2(nn.Module):
    """DarkNet-19 (or the UNet) + the passthrough + the v2 head
    (softmax classes, constant anchors). With DarkNet-19 the stride-16
    512-ch tap is reduced to 64 channels (``passthrough``), moved to
    stride 32 by ``space_to_depth(2)`` and concatenated, [pt, conv], with
    the backbone output after ``neck1`` and ``neck2``; ``neck3`` fuses.
    ``forward(images)`` returns (N, S, S, B (5 + C)) f32, S = H / 32.
    ``backbone="unet"`` and ``"mobilenet"`` feed their output to the head
    directly."""

    def __init__(self, anchors, class_num=1, backbone="darknet",
                 dtype=torch.float32, generator=None, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.plain = False
        self.backbone_name = backbone
        conv = dict(act="leaky", use_bias=True, darknet_pad=False, **kw)
        if backbone == "darknet":
            self.backbone = Darknet19(**kw)
            self.neck1 = ConvBN(1024, 1024, 3, **conv)
            self.neck2 = ConvBN(1024, 1024, 3, **conv)
            self.passthrough = ConvBN(512, 64, 3, **conv)
            self.neck3 = ConvBN(4 * 64 + 1024, 1024, 3, **conv)
            ci = 1024
        elif backbone == "unet":
            self.backbone = UNetBody(**kw)
            ci = 256
        elif backbone == "mobilenet":
            self.backbone = MobileNetV2(**kw)
            ci = self.backbone.out_channels
        else:
            raise ValueError(f"Invalid backbone: {backbone}")
        self.head = AnchorHead(ci, anchors, class_num, prob_act="softmax",
                               anchors_as_params=False, init=he_normal_,
                               **kw)

    def forward(self, x, pipeline_stage=None):
        """``pipeline_stage``: None runs the whole net; "backbone"
        returns the backbone's taps ((passthrough, feat) for DarkNet-19,
        one feature map otherwise); "neck" takes ``x`` AS those taps and
        runs the rest."""
        _check_pipeline_stage(pipeline_stage)
        taps = x if pipeline_stage == "neck" else self.backbone(x)
        if pipeline_stage == "backbone":
            return taps
        if self.backbone_name == "darknet":
            passthrough, feat = taps
            conv = self.neck2(self.neck1(feat))
            pt = space_to_depth(self.passthrough(passthrough), 2)
            feat = self.neck3(torch.cat([pt, conv], dim=-1))
        else:
            feat = taps
        return self.head(feat)


class YoloV3(nn.Module):
    """Darknet-53 + the 3-level top-down FPN + per-level heads (sigmoid
    classes, constant anchors), or with ``backbone="tiny_darknet"`` the
    tiny body and its two heads; a ResNet name or a backbone factory
    (:func:`_custom_backbone`) replaces Darknet-53 under the same FPN.
    ``forward(images)`` returns the [coarse (stride 32), mid (16)(, fine
    (8))] head outputs, each (N, S, S, B (5 + C)) f32."""

    def __init__(self, anchors, class_num=1, backbone="full_darknet",
                 dtype=torch.float32, generator=None, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.plain = False
        self.tiny = backbone == "tiny_darknet"
        leaky = dict(act="leaky", **kw)
        if self.tiny:
            self.backbone = TinyDarknet(**kw)
            self.tiny_out1 = ConvBN(256, 512, 3, **leaky)
            self.tiny_up = ConvBN(256, 128, 1, **leaky)
            self.tiny_out2 = ConvBN(128 + 256, 256, 3, **leaky)
            feats = (512, 256)
        else:
            self.backbone, (c3, c4, c5) = _body(backbone, Darknet53, kw)
            self.fpn1 = FPNStage(c5, 512, make_out=True, init=he_normal_,
                                 **kw)
            self.up1 = ConvBN(512, 256, 1, **leaky)
            self.fpn2 = FPNStage(256 + c4, 256, make_out=True,
                                 init=he_normal_, **kw)
            self.up2 = ConvBN(256, 128, 1, **leaky)
            self.fpn3 = FPNStage(128 + c3, 128, make_out=True,
                                 init=he_normal_, **kw)
            feats = (1024, 512, 256)
        per_level = _split_anchors(anchors, len(feats))
        for i, (ci, anc) in enumerate(zip(feats, per_level)):
            self.add_module(f"head{i + 1}",
                            AnchorHead(ci, anc, class_num,
                                       anchors_as_params=False,
                                       init=he_normal_, **kw))
        self.levels = len(feats)

    def forward(self, x, pipeline_stage=None):
        """``pipeline_stage``: None runs the whole net; "backbone"
        returns the backbone's taps ((c3, c4, c5), or (tap, bottleneck)
        for the tiny body); "neck" takes ``x`` AS those taps and runs
        the FPN and the heads."""
        _check_pipeline_stage(pipeline_stage)
        taps = x if pipeline_stage == "neck" else self.backbone(x)
        if pipeline_stage == "backbone":
            return tuple(taps)
        if self.tiny:
            tap, bottleneck = taps
            out1 = self.tiny_out1(bottleneck)
            up = upsample2x(self.tiny_up(bottleneck))
            out2 = self.tiny_out2(torch.cat([up, tap], dim=-1))
            feats = [out1, out2]
        else:
            c3, c4, c5 = taps
            t, out1 = self.fpn1(c5)
            t = torch.cat([upsample2x(self.up1(t)), c4], dim=-1)
            t, out2 = self.fpn2(t)
            t = torch.cat([upsample2x(self.up2(t)), c3], dim=-1)
            _, out3 = self.fpn3(t)
            feats = [out1, out2, out3]
        return [getattr(self, f"head{i + 1}")(f)
                for i, f in enumerate(feats)]


class YoloV4(nn.Module):
    """The full YOLOv4 network. ``forward(images)`` takes NHWC images and
    returns the [coarse (stride 32), mid (16), fine (8)] head outputs,
    each (N, S, S, B*(5+C)) f32.

    ``dtype`` is the compute dtype of the convs; parameters are f32.
    ``generator`` draws the v4 init (RandomNormal(0, 0.02) everywhere in
    CSPDarknet-53 and the neck; a ResNet keeps its glorot-uniform).
    ``packed=True`` runs the backbone's stages 3-5 through the fused
    GEMMs in train mode, ``packed=3`` also stages 1-2 through the fused
    3x3 convs and sum-GEMMs (see ``CSPDarknet53``); only CSPDarknet-53
    has those stages, so with another ``backbone`` (a ResNet name or a
    factory, as YoloV3's) any ``packed`` but False raises ValueError.
    The model is built on the card unless ``device`` says otherwise.
    ``plain`` is set by ``layers.use_plain_route``.
    """

    def __init__(self, anchors, class_num=1, dtype=torch.float32,
                 generator=None, device="cuda", packed=False,
                 backbone="csp_darknet"):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.plain = False
        if (callable(backbone) or backbone != "csp_darknet") \
                and packed is not False:
            raise ValueError(f"packed={packed!r} fuses CSPDarknet-53 "
                             f"stages; backbone {backbone!r} has none")
        self.backbone, (c3, c4, c5) = _body(
            backbone, lambda **k: CSPDarknet53(packed=packed, **k), kw)

        self.td1_pre1 = _neck(c5, 512, 1, **kw)
        self.td1_pre2 = _neck(512, 1024, 3, **kw)
        self.td1_spp_pre = _neck(1024, 512, 1, **kw)
        self.td1_post1 = _neck(2048, 512, 1, **kw)
        self.td1_post2 = _neck(512, 1024, 3, **kw)
        self.td1_post3 = _neck(1024, 512, 1, **kw)

        self.td1_up = _neck(512, 256, 1, **kw)
        self.td2_pre = _neck(c4, 256, 1, **kw)
        self.td2 = FPNStage(512, 256, **kw)

        self.td2_up = _neck(256, 128, 1, **kw)
        self.td3_pre = _neck(c3, 128, 1, **kw)
        self.td3 = FPNStage(256, 128, **kw)

        self.out_l = _neck(128, 256, 3, **kw)

        self.bu1_dn = _neck(128, 256, 3, 2, **kw)
        self.bu1 = FPNStage(512, 256, **kw)
        self.out_m = _neck(256, 512, 3, **kw)

        self.bu2_dn = _neck(256, 512, 3, 2, **kw)
        self.bu2 = FPNStage(1024, 512, **kw)
        self.out_s = _neck(512, 1024, 3, **kw)

        per_level = _split_anchors(anchors, 3)
        for i, (ci, anc) in enumerate(zip((1024, 512, 256), per_level)):
            self.add_module(f"head{i + 1}",
                            AnchorHead(ci, anc, class_num, **kw))

    def forward(self, x, pipeline_stage=None):
        """``pipeline_stage``: None runs the whole network; "backbone"
        returns the (c3, c4, c5) taps; "neck" takes ``x`` AS those taps
        and runs the neck and the heads. "backbone_early" and
        "backbone_late" cut the stock CSPDarknet-53 itself, for 3-stage
        pipelines: stem + stages 1-3 -> c3, then stages 4-5 -> (c3, c4,
        c5); both take the packed routes in train mode as the whole body
        does (``CSPDarknet53(section=...)``)."""
        _check_pipeline_stage(pipeline_stage,
                              extra=("backbone_early", "backbone_late"))
        if pipeline_stage in ("backbone_early", "backbone_late"):
            if not isinstance(self.backbone, CSPDarknet53):
                raise ValueError(
                    "backbone_early/backbone_late cuts require the "
                    "stock csp_darknet backbone")
            if pipeline_stage == "backbone_early":
                return self.backbone(x, section="early")
            return (x, *self.backbone(x, section="late"))
        if pipeline_stage == "neck":
            c3, c4, c5 = x
        else:
            c3, c4, c5 = self.backbone(x)
        if pipeline_stage == "backbone":
            return (c3, c4, c5)

        # top-down path with SPP at the coarsest level
        t_s = self.td1_spp_pre(self.td1_pre2(self.td1_pre1(c5)))
        t_s = spp(t_s)
        t_s = self.td1_post3(self.td1_post2(self.td1_post1(t_s)))

        up = self.td1_up(t_s)
        t_m = torch.cat([self.td2_pre(c4), upsample2x(up)], dim=-1)
        t_m = self.td2(t_m)

        up = self.td2_up(t_m)
        t_l = torch.cat([self.td3_pre(c3), upsample2x(up)], dim=-1)
        t_l = self.td3(t_l)

        out_l = self.out_l(t_l)

        # bottom-up PAN re-downsamples
        t_m = self.bu1(torch.cat([self.bu1_dn(t_l), t_m], dim=-1))
        out_m = self.out_m(t_m)

        t_s = self.bu2(torch.cat([self.bu2_dn(t_m), t_s], dim=-1))
        out_s = self.out_s(t_s)

        feats = (out_s, out_m, out_l)                  # coarse -> fine
        return [getattr(self, f"head{i + 1}")(f)
                for i, f in enumerate(feats)]
