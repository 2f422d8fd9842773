"""YOLOv4: CSPDarknet-53 + SPP top-down FPN + bottom-up PAN + heads.

Port of ``_split_anchors``, ``FPNStage`` and the full-network path of
``YoloV4`` in tf2_yolo_tpu/models/detectors.py (NHWC; ``train()`` /
``eval()`` select batch or running BatchNorm statistics). The
concat orders and the coarse-to-fine output order are the JAX
package's. 107 ConvBN layers (72 mish in the backbone, 35 leaky in the
neck, 7 of them stride 2) and 3 biased head convs.
"""

import numpy as np
import torch
from torch import nn

from .backbones import CSPDarknet53
from .heads import AnchorHead
from .layers import ConvBN, darknet_normal_, spp, upsample2x


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
    """The v4 5-conv stack: alternating 1x1 to ``features`` and 3x3 to
    2 * ``features``, leaky. (The v3 3x3 ``out`` conv comes with YOLOv3.)"""

    def __init__(self, ci, features, **kw):
        super().__init__()
        f = features
        for i, (c_in, c_out, k) in enumerate(
                [(ci, f, 1), (f, 2 * f, 3), (2 * f, f, 1), (f, 2 * f, 3),
                 (2 * f, f, 1)]):
            self.add_module(f"conv{i + 1}", _neck(c_in, c_out, k, **kw))

    def forward(self, x):
        for i in range(5):
            x = getattr(self, f"conv{i + 1}")(x)
        return x


class YoloV4(nn.Module):
    """The full YOLOv4 network. ``forward(images)`` takes NHWC images and
    returns the [coarse (stride 32), mid (16), fine (8)] head outputs,
    each (N, S, S, B*(5+C)) f32.

    ``dtype`` is the compute dtype of the convs; parameters are f32.
    ``generator`` draws the v4 init (RandomNormal(0, 0.02) everywhere).
    ``packed=True`` runs the backbone's stages 3-5 through the fused
    GEMMs in train mode, ``packed=3`` also stages 1-2 through the fused
    3x3 convs and sum-GEMMs (see ``CSPDarknet53``). The model is built on
    the card unless ``device`` says otherwise. ``plain`` is set by
    ``layers.use_plain_route``.
    """

    def __init__(self, anchors, class_num=1, dtype=torch.float32,
                 generator=None, device="cuda", packed=False):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.plain = False
        self.backbone = CSPDarknet53(packed=packed, **kw)

        self.td1_pre1 = _neck(1024, 512, 1, **kw)
        self.td1_pre2 = _neck(512, 1024, 3, **kw)
        self.td1_spp_pre = _neck(1024, 512, 1, **kw)
        self.td1_post1 = _neck(2048, 512, 1, **kw)
        self.td1_post2 = _neck(512, 1024, 3, **kw)
        self.td1_post3 = _neck(1024, 512, 1, **kw)

        self.td1_up = _neck(512, 256, 1, **kw)
        self.td2_pre = _neck(512, 256, 1, **kw)
        self.td2 = FPNStage(512, 256, **kw)

        self.td2_up = _neck(256, 128, 1, **kw)
        self.td3_pre = _neck(256, 128, 1, **kw)
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

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)

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
