"""YOLOv3 facade (reference yolov3/__init__.py parity).

Port of tf2_yolo_tpu/yolov3.py: Darknet-53 (``"full_darknet"``), the
tiny body (``"tiny_darknet"``), a ResNet or a backbone factory, constant
anchors split evenly across the
output levels, and the per-level v3 loss list. The model is built on the
card unless ``create_model`` is told otherwise.
"""

from collections.abc import Iterable

import numpy as np
import torch

from .engine import Model
from .facade_base import (MetricKind, YoloBase, graft_backbone_params,
                          make_version_aliases, resolve_pretrained)
from .models import YoloV3
from .ops.losses import wrap_yolo_loss_v3

__all__ = ["Yolo", "MetricKind"]

DEFAULT_ANCHORS = [[0.89663461, 0.78365384],
                   [0.37500000, 0.47596153],
                   [0.27884615, 0.21634615],
                   [0.14182692, 0.28605769],
                   [0.14903846, 0.10817307],
                   [0.07211538, 0.14663461],
                   [0.07932692, 0.05528846],
                   [0.03846153, 0.07211538],
                   [0.02403846, 0.03125000]]

_BACKBONES = ("full_darknet", "tiny_darknet", "resnet50", "resnet101",
              "resnet152", "resnet50v2", "resnet101v2", "resnet152v2")


class Yolo(YoloBase):
    """YOLOv3: Darknet-53 + 3-level FPN, anchors split across levels."""

    version = 3
    stride = 32
    num_levels = 3

    def __init__(self, input_shape=(416, 416, 3), class_names=[]):
        super().__init__(input_shape, class_names)
        self.abox_num = 3
        self.fpn_layers = 3
        self.anchors = None

    @property
    def _bbox_num(self):
        return self.abox_num

    def create_model(self, anchors=DEFAULT_ANCHORS,
                     backbone="full_darknet",
                     pretrained_weights=None,
                     pretrained_body="pascal_voc",
                     dtype=None,
                     input_rescale=1 / 255,
                     seed=0,
                     device="cuda"):
        """Build the v3 model (reference yolov3/__init__.py:100-181).

        The JAX facade's arguments, plus ``seed`` (the HE_NORMAL init is
        drawn from a ``torch.Generator``) and ``device`` (the card unless
        told "cpu"). ``backbone``: "full_darknet", "tiny_darknet" (the
        tiny body has two levels and takes 2 x B anchors),
        "resnet{50,101,152}{,v2}", or a factory ``f(dtype=, generator=,
        device=)`` returning an ``nn.Module`` of the (c3, c4, c5) taps at
        strides 8, 16 and 32 with their channels in ``out_channels``
        (the JAX package's ``f(bn_axis_name=, dtype=, name=)``).
        ``dtype`` is the compute dtype of the convs (default f32). Weight
        files (``pretrained_weights``, a string ``pretrained_body``) are
        the port's ``torch.save`` files; a Model or dict
        ``pretrained_body`` grafts its backbone parameters.
        """
        if not callable(backbone) and backbone not in _BACKBONES:
            raise ValueError(f"Invalid backbone: {backbone}")
        gen = torch.Generator(device=device).manual_seed(int(seed))
        module = YoloV3(anchors, self.class_num, backbone=backbone,
                        dtype=dtype or torch.float32, generator=gen,
                        device=device)
        self.model = Model(module, self.input_shape,
                           input_rescale=input_rescale, device=device)

        if pretrained_body is not None and \
                not isinstance(pretrained_body, str):
            graft_backbone_params(self.model, pretrained_body)
        elif isinstance(pretrained_body, str):
            body = resolve_pretrained(pretrained_body, "yolov3_body")
            if body is not None:
                self.model.load_weights(body)

        weights = resolve_pretrained(pretrained_weights, "yolov3")
        if weights is not None:
            self.model.load_weights(weights)

        self.anchors = anchors
        self.grid_shape = tuple(self.model.output_shapes[0][1:3])
        self.fpn_layers = self.num_levels = len(self.model.output_shapes)
        self.abox_num = len(anchors) // self.fpn_layers
        return self.model

    def loss(self, binary_weight=1,
             loss_weight=[1, 1, 5, 1],
             ignore_thresh=0.6,
             use_focal_loss=False,
             focal_loss_gamma=2,
             use_scale=True):
        """Per-level v3 loss list (reference yolov3/__init__.py:380-437):
        anchors split B per level, a ``binary_weight`` per level."""
        if (not isinstance(binary_weight, Iterable)
                or len(binary_weight) != self.fpn_layers):
            binary_weight = [binary_weight] * self.fpn_layers
        if isinstance(loss_weight, dict):
            loss_weight = [loss_weight["xy"], loss_weight["wh"],
                           loss_weight["conf"], loss_weight["prob"]]

        anchors = np.asarray(self.anchors, np.float32)
        losses = []
        for level in range(self.fpn_layers):
            amp = 2 ** level
            grid_shape = (self.grid_shape[0] * amp,
                          self.grid_shape[1] * amp)
            lo = self.abox_num * level
            losses.append(wrap_yolo_loss_v3(
                grid_shape=grid_shape,
                bbox_num=self.abox_num,
                class_num=self.class_num,
                anchors=anchors[lo:lo + self.abox_num],
                binary_weight=binary_weight[level],
                loss_weight=loss_weight,
                ignore_thresh=ignore_thresh,
                use_focal_loss=use_focal_loss,
                focal_loss_gamma=focal_loss_gamma,
                use_scale=use_scale))
        return losses


# module-level parity with the reference's per-version subpackages
# (yolovN.losses.wrap_yolo_loss, yolovN.metrics.wrap_*)
globals().update(make_version_aliases(3))
