"""YOLOv2 facade (reference yolov2/__init__.py parity).

Port of tf2_yolo_tpu/yolov2.py: DarkNet-19 with the passthrough
(``"darknet"``), the UNet body (``"unet"``) or MobileNetV2
(``"mobilenet"``), a softmax head with
constant anchors, and the v2 loss. The model is built on the card unless
``create_model`` is told otherwise.
"""

import torch

from .engine import Model
from .facade_base import (MetricKind, YoloBase, graft_backbone_file,
                          graft_backbone_params, make_version_aliases,
                          resolve_pretrained)
from .models import YoloV2
from .ops.losses import wrap_yolo_loss_v2

__all__ = ["Yolo", "MetricKind"]

DEFAULT_ANCHORS = [[0.75157846, 0.70525231],
                   [0.60637077, 0.27136769],
                   [0.25680231, 0.42110308],
                   [0.14418923, 0.15865615],
                   [0.04405615, 0.05210654]]


class Yolo(YoloBase):
    """YOLOv2: DarkNet-19 + passthrough, grid = input/32, 5 anchors."""

    version = 2
    stride = 32
    num_levels = 1

    def __init__(self, input_shape=(416, 416, 3), class_names=[]):
        super().__init__(input_shape, class_names)
        self.abox_num = 5
        self.anchors = None

    @property
    def _bbox_num(self):
        return self.abox_num

    def create_model(self, anchors=DEFAULT_ANCHORS,
                     backbone="darknet",
                     pretrained_weights=None,
                     pretrained_backbone=None,
                     dtype=None,
                     input_rescale=1 / 255,
                     seed=0,
                     device="cuda"):
        """Build the v2 model (reference yolov2/__init__.py:69-105).

        The JAX facade's arguments, plus ``seed`` (the HE_NORMAL init is
        drawn from a ``torch.Generator``) and ``device`` (the card unless
        told "cpu"). ``backbone``: "darknet", "unet" or "mobilenet".
        ``pretrained_backbone``: a Model or dict whose backbone
        parameters are grafted, or a name resolved in the local weight
        cache (``{backbone}_backbone_{name}.pt``), whose backbone
        parameters and statistics are grafted. ``dtype`` is the compute
        dtype of the convs (default f32).
        """
        if backbone not in ("darknet", "unet", "mobilenet"):
            raise ValueError(f"Invalid backbone: {backbone}")
        gen = torch.Generator(device=device).manual_seed(int(seed))
        module = YoloV2(anchors, self.class_num, backbone=backbone,
                        dtype=dtype or torch.float32, generator=gen,
                        device=device)
        self.model = Model(module, self.input_shape,
                           input_rescale=input_rescale, device=device)

        if isinstance(pretrained_backbone, str):
            resolved = resolve_pretrained(
                pretrained_backbone, f"{backbone}_backbone")
            if resolved is not None:
                graft_backbone_file(self.model, resolved)
        elif pretrained_backbone is not None:
            graft_backbone_params(self.model, pretrained_backbone)

        weights = resolve_pretrained(pretrained_weights, "yolov2")
        if weights is not None:
            self.model.load_weights(weights)

        self.anchors = anchors
        self.abox_num = len(anchors)
        self.grid_shape = tuple(self.model.output_shapes[1:3])
        return self.model

    def loss(self, binary_weight=1,
             loss_weight=[1, 1, 5, 1],
             ignore_thresh=0.6):
        """v2 loss closure (reference yolov2/__init__.py:286-318)."""
        if isinstance(loss_weight, dict):
            loss_weight = [loss_weight["xy"], loss_weight["wh"],
                           loss_weight["conf"], loss_weight["prob"]]
        return wrap_yolo_loss_v2(
            grid_shape=self.grid_shape,
            bbox_num=self.abox_num,
            class_num=self.class_num,
            anchors=self.anchors,
            binary_weight=binary_weight,
            loss_weight=loss_weight,
            ignore_thresh=ignore_thresh)


# module-level parity with the reference's per-version subpackages
# (yolovN.losses.wrap_yolo_loss, yolovN.metrics.wrap_*)
globals().update(make_version_aliases(2))
