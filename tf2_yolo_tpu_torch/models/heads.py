"""Detection heads.

Port of ``HeadV1`` and ``AnchorHead`` in tf2_yolo_tpu/models/heads.py.
Each head is one biased 1x1 conv emitting every channel; the math after
it runs in f32 whatever the compute dtype, since the wh exponentials
overflow bf16. Output layouts are the flat ones of the JAX package:
[xy, wh, conf, prob] * B per anchor (v2-v4), and 5 B box channels then C
shared class channels (v1).
"""

import numpy as np
import torch
from torch import nn

from ..ops.geometry import clip
from .layers import Conv, darknet_normal_, he_normal_


class HeadV1(nn.Module):
    """YOLOv1 head: a biased 1x1 conv (HE_NORMAL) to 5 B + C channels,
    sigmoid on the 5 B box channels (xywhc) and softmax on the C class
    channels that the B boxes share."""

    def __init__(self, ci, bbox_num, class_num, dtype=torch.float32,
                 generator=None, device="cuda"):
        super().__init__()
        self.bbox_num = bbox_num
        self.class_num = class_num
        self.conv = Conv(ci, 5 * bbox_num + class_num, 1, use_bias=True,
                         dtype=dtype, init=he_normal_, generator=generator,
                         device=device)

    def forward(self, x):
        raw = self.conv(x)[0].float()
        split = 5 * self.bbox_num
        return torch.cat([torch.sigmoid(raw[..., :split]),
                          torch.softmax(raw[..., split:], dim=-1)], dim=-1)


class AnchorHead(nn.Module):
    """Biased 1x1 conv to B*(5+C) channels, then sigmoid xy,
    exp(clamped) * anchors wh, sigmoid conf, and softmax (``prob_act``
    "softmax", v2) or sigmoid (v3/v4) class probabilities.

    ``anchors_as_params=True`` (v4) keeps the (B, 2) anchors as the
    trainable parameter ``anchors``; otherwise (v2/v3) they are
    constants, a buffer left out of the ``state_dict`` as the flax tree
    has no such leaf. ``init`` draws the conv kernel: RandomNormal(0,
    0.02) (v4) or HE_NORMAL (v2/v3). The defaults are the v4 settings,
    which the port's YOLOv4 path has always taken (the JAX module's
    defaults are the v2/v3 ones)."""

    def __init__(self, ci, anchors, class_num, prob_act="sigmoid",
                 anchors_as_params=True, dtype=torch.float32,
                 init=darknet_normal_, generator=None, device="cuda"):
        super().__init__()
        if prob_act not in ("sigmoid", "softmax"):
            raise ValueError(f"unknown prob_act {prob_act!r}")
        anchors = np.asarray(anchors, np.float32)
        self.bbox_num = anchors.shape[0]
        self.class_num = class_num
        self.prob_act = prob_act
        self.conv = Conv(ci, self.bbox_num * (5 + class_num), 1,
                         use_bias=True, dtype=dtype, init=init,
                         generator=generator, device=device)
        anchors = torch.tensor(anchors, device=device)
        if anchors_as_params:
            self.anchors = nn.Parameter(anchors)
        else:
            self.register_buffer("anchors", anchors, persistent=False)

    def forward(self, x):
        raw, _, _ = self.conv(x)
        n, h, w, _ = raw.shape
        raw = raw.float().reshape(n, h, w, self.bbox_num,
                                  5 + self.class_num)
        xy = torch.sigmoid(raw[..., 0:2])
        # clamp the exponent: an untrained or diverged net can emit huge
        # raw values and exp() would overflow
        wh = torch.exp(clip(raw[..., 2:4], -15.0, 15.0)) * self.anchors
        conf = torch.sigmoid(raw[..., 4:5])
        if self.prob_act == "softmax":
            prob = torch.softmax(raw[..., 5:], dim=-1)
        else:
            prob = torch.sigmoid(raw[..., 5:])
        out = torch.cat([xy, wh, conf, prob], dim=-1)
        return out.reshape(n, h, w, self.bbox_num * (5 + self.class_num))
