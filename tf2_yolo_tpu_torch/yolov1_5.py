"""YOLOv1.5 facade (reference yolov1_5/__init__.py parity).

Port of tf2_yolo_tpu/yolov1_5.py: DarkNet-v1, grid = input / 64, B boxes
a cell sharing one class distribution, and the v1 loss. The model is
built on the card unless ``create_model`` is told otherwise:

    yolo = Yolo(input_shape, class_names)
    yolo.create_model(device="cpu")
    img, label = yolo.read_file_to_dataset(img_dir, xml_dir)
    yolo.model.compile("adam", loss=yolo.loss(binary_weight),
                       metrics=yolo.metrics("obj+iou"))
    yolo.model.fit(img, label, epochs=..., batch_size=...)
"""

import torch

from .engine import Model
from .facade_base import (MetricKind, YoloBase, graft_backbone_params,
                          make_version_aliases, resolve_pretrained)
from .models import YoloV1
from .ops.losses import wrap_yolo_loss_v1

__all__ = ["Yolo", "MetricKind"]


class Yolo(YoloBase):
    """YOLOv1.5: DarkNet-v1 backbone, grid = input/64, 2 boxes/cell."""

    version = 1
    stride = 64
    num_levels = 1

    def __init__(self, input_shape=(448, 448, 3), class_names=[]):
        super().__init__(input_shape, class_names)
        self.bbox_num = 2

    @property
    def _bbox_num(self):
        return self.bbox_num

    def create_model(self, bbox_num=2,
                     pretrained_weights=None,
                     pretrained_backbone=None,
                     dtype=None,
                     input_rescale=1 / 255,
                     seed=0,
                     device="cuda"):
        """Build the v1 model (reference yolov1_5/__init__.py:66-91).

        The JAX facade's arguments, plus ``seed`` (the HE_NORMAL init is
        drawn from a ``torch.Generator``) and ``device`` (the card unless
        told "cpu"). ``pretrained_backbone``: a Model or dict whose
        backbone parameters are grafted. ``dtype`` is the compute dtype
        of the convs (default f32); parameters and the loss stay f32.
        """
        gen = torch.Generator(device=device).manual_seed(int(seed))
        module = YoloV1(bbox_num=bbox_num, class_num=self.class_num,
                        dtype=dtype or torch.float32, generator=gen,
                        device=device)
        self.model = Model(module, self.input_shape,
                           input_rescale=input_rescale, device=device)

        if pretrained_backbone is not None:
            graft_backbone_params(self.model, pretrained_backbone)

        weights = resolve_pretrained(pretrained_weights, "yolov1")
        if weights is not None:
            self.model.load_weights(weights)

        self.bbox_num = bbox_num
        self.grid_shape = tuple(self.model.output_shapes[1:3])
        return self.model

    def loss(self, binary_weight, loss_weight=[5, 5, 1, 1]):
        """v1 loss closure (reference yolov1_5/__init__.py:270-297).

        loss_weight: dict {"xy","wh","conf","prob"} or 4-list.
        """
        if isinstance(loss_weight, dict):
            loss_weight = [loss_weight["xy"], loss_weight["wh"],
                           loss_weight["conf"], loss_weight["prob"]]
        return wrap_yolo_loss_v1(
            grid_shape=self.grid_shape,
            bbox_num=self.bbox_num,
            class_num=self.class_num,
            binary_weight=binary_weight,
            loss_weight=loss_weight)


# module-level parity with the reference's per-version subpackages
# (yolovN.losses.wrap_yolo_loss, yolovN.metrics.wrap_*)
globals().update(make_version_aliases(1))
