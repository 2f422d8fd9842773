"""The YOLOv4 anchor head.

Port of ``AnchorHead`` in tf2_yolo_tpu/models/heads.py with the v4
settings: trainable ``anchors`` and sigmoid class probabilities. (The v2
softmax and constant-anchor variants come with the other families.)
One biased 1x1 conv emits all B*(5+C) channels; the math after it runs
in f32 whatever the compute dtype, since the wh exponentials overflow
bf16. Output layout is the flat [xy, wh, conf, prob] * B.
"""

import numpy as np
import torch
from torch import nn

from ..ops.geometry import clip
from .layers import Conv, darknet_normal_


class AnchorHead(nn.Module):
    """Biased 1x1 conv to B*(5+C) channels (init RandomNormal(0, 0.02)),
    then sigmoid xy, exp(clamped) * anchors wh, sigmoid conf and probs."""

    def __init__(self, ci, anchors, class_num, dtype=torch.float32,
                 generator=None, device="cuda"):
        super().__init__()
        anchors = np.asarray(anchors, np.float32)
        self.bbox_num = anchors.shape[0]
        self.class_num = class_num
        self.conv = Conv(ci, self.bbox_num * (5 + class_num), 1,
                         use_bias=True, dtype=dtype, init=darknet_normal_,
                         generator=generator, device=device)
        self.anchors = nn.Parameter(torch.tensor(anchors, device=device))

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
        prob = torch.sigmoid(raw[..., 5:])
        out = torch.cat([xy, wh, conf, prob], dim=-1)
        return out.reshape(n, h, w, self.bbox_num * (5 + self.class_num))
