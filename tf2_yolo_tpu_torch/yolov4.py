"""YOLOv4 facade (reference yolov4/__init__.py parity).

Port of tf2_yolo_tpu/yolov4.py. Anchors live as model parameters (one
(B, 2) ``anchors`` parameter per head, ``head{i}.anchors``):
``Yolo.anchors`` reads/writes them, ``anchors_trainable`` toggles their
optimizer mask (taking effect at the next ``model.compile``), and
``reshape_anchors`` rescales them for a new input resolution. The model
is built on the card unless ``create_model`` is told otherwise.
"""

from collections.abc import Iterable

import numpy as np
import torch

from .engine import Model
from .facade_base import (MetricKind, YoloBase, make_version_aliases,
                          resolve_pretrained)
from .models import YoloV4
from .ops.losses import wrap_yolo_loss_v4

__all__ = ["Yolo", "MetricKind"]

_BACKBONES = ("csp_darknet", "resnet50", "resnet101", "resnet152",
              "resnet50v2", "resnet101v2", "resnet152v2")


class Yolo(YoloBase):
    """YOLOv4: CSPDarknet-53 + SPP/PAN, CIoU loss, anchor parameters."""

    version = 4
    stride = 32
    num_levels = 3

    def __init__(self, input_shape=(608, 608, 3), class_names=[]):
        super().__init__(input_shape, class_names)
        self.abox_num = 3
        self.pan_layers = 3
        self._model = None
        self._file_names = None
        self._anchors_trainable = False

    @property
    def _bbox_num(self):
        return self.abox_num

    # -- guarded accessors (reference yolov4/__init__.py:100-167) ------
    @property
    def model(self):
        if self._model is None:
            raise ValueError(
                "You haven't created a model by using create_model().")
        return self._model

    @model.setter
    def model(self, value):
        if value is not None:
            raise ValueError(
                "Can't set attribute directly, "
                "please create a model by using create_model().")
        self._model = None

    @model.deleter
    def model(self):
        self._model = None

    @property
    def file_names(self):
        if self._file_names is None:
            raise ValueError("You haven't read files.")
        return self._file_names

    @file_names.setter
    def file_names(self, value):
        self._file_names = value

    # -- anchors as model state ----------------------------------------
    def _heads(self):
        return [getattr(self.model.module, f"head{i + 1}")
                for i in range(self.pan_layers)]

    @property
    def anchors(self):
        """Flat (9, 2)-style anchor list read from head parameters."""
        if self._model is None:
            raise ValueError(
                "To get anchors, you have to create a model first.")
        return np.vstack([h.anchors.detach().cpu().numpy()
                          for h in self._heads()]).tolist()

    @anchors.setter
    def anchors(self, anchor_boxes):
        anchor_boxes = np.asarray(anchor_boxes, np.float32)
        with torch.no_grad():
            for i, head in enumerate(self._heads()):
                lo = i * self.abox_num
                head.anchors.copy_(torch.from_numpy(
                    anchor_boxes[lo:lo + self.abox_num]))

    @property
    def anchors_trainable(self):
        return self._anchors_trainable

    @anchors_trainable.setter
    def anchors_trainable(self, trainable):
        self._anchors_trainable = bool(trainable)
        if self._model is not None:
            self._model.default_frozen = self._frozen_predicate()

    def _frozen_predicate(self):
        if self._anchors_trainable:
            return None

        def frozen(name, param):
            return name.split(".")[-1] == "anchors"
        return frozen

    def reshape_anchors(self, ori_shape, shape=None):
        """Rescale anchors for a new input size
        (reference yolov4/__init__.py:169-188).

        Args:
            ori_shape: original (width, height).
            shape: target (width, height); defaults to the model input.
        """
        if shape is None:
            shape = self.input_shape[1::-1]
        amp = np.array([ori_shape[0] / shape[0],
                        ori_shape[1] / shape[1]], np.float32)
        self.anchors = np.asarray(self.anchors, np.float32) * amp

    # ------------------------------------------------------------------
    def vis_img(self, img, *label_datas, conf_threshold=0.5,
                show_conf=True, nms_mode=0, nms_threshold=0.45,
                nms_sigma=0.5, **kwargs):
        """Visualize grid label(s)/prediction(s) on an image, with the
        v4 facade's own default ``nms_threshold`` of 0.45
        (reference yolov4/__init__.py:414-420)."""
        return super().vis_img(
            img, *label_datas, conf_threshold=conf_threshold,
            show_conf=show_conf, nms_mode=nms_mode,
            nms_threshold=nms_threshold, nms_sigma=nms_sigma, **kwargs)

    # ------------------------------------------------------------------
    def create_model(self, anchors=None,
                     backbone="csp_darknet",
                     pretrained_weights=None,
                     pretrained_body="ms_coco",
                     dtype=None,
                     input_rescale=1 / 255,
                     seed=0,
                     device="cuda",
                     packed=False):
        """Build the v4 model (reference yolov4/__init__.py:190-276).

        The JAX facade's arguments, plus: ``seed`` draws the v4 init
        (RandomNormal(0, 0.02); a ResNet's glorot-uniform) from a
        ``torch.Generator``; ``device`` (the card unless told "cpu");
        ``packed`` the fused backbone route of ``YoloV4`` (False, True or
        3, CSPDarknet-53 only; the JAX package sets it process-wide with
        ``set_packed_early``). ``backbone``: "csp_darknet", a ResNet
        ("resnet50", "resnet101", "resnet152" and their "v2"), or a
        factory ``f(dtype=, generator=, device=)`` returning an
        ``nn.Module`` of the (c3, c4, c5) taps at strides 8, 16 and 32
        with their channels in ``out_channels``. ``dtype`` is the compute
        dtype of the convs (default f32). Weight files
        (``pretrained_weights``, a string ``pretrained_body``) are the
        port's ``torch.save`` files.
        """
        use_arg_anchors = True
        if pretrained_weights is None:
            if anchors is None:
                raise ValueError(
                    "Without pretrained weights, `anchors` can't be "
                    "empty.")
        else:
            pretrained_body = None
            if anchors is None:
                anchors = [[1.0, 1.0]
                           for _ in range(self.pan_layers * self.abox_num)]
                use_arg_anchors = False

        # a factory callable (``f(dtype=, generator=, device=)`` -> an
        # nn.Module yielding the (c3, c4, c5) taps, with their channels in
        # ``out_channels``) is the torch form of the JAX package's
        # wrap-any-backbone PAN constructor
        if not callable(backbone) and backbone not in _BACKBONES:
            raise ValueError(f"Invalid backbone: {backbone}")

        gen = torch.Generator(device=device).manual_seed(int(seed))
        module = YoloV4(anchors, self.class_num,
                        dtype=dtype or torch.float32, generator=gen,
                        device=device, packed=packed, backbone=backbone)
        self._model = Model(module, self.input_shape,
                            input_rescale=input_rescale, device=device)
        self._model.default_frozen = self._frozen_predicate()

        if pretrained_body is not None and \
                not isinstance(pretrained_body, str):
            src = (pretrained_body.variables
                   if isinstance(pretrained_body, Model)
                   else pretrained_body)
            body = {k: v for k, v in src.items()
                    if k.startswith("backbone.")}
            self._model.module.load_state_dict(body, strict=False)
        elif isinstance(pretrained_body, str):
            body = resolve_pretrained(pretrained_body, "yolov4_body")
            if body is not None:
                self._model.load_weights(body)

        weights = resolve_pretrained(pretrained_weights, "yolov4")
        if weights is not None:
            self._model.load_weights(weights)
            if use_arg_anchors:
                self.anchors = anchors
                print("The saved model is loaded and will use the "
                      "argument `anchors` instead of the original "
                      "anchors.")

        self.grid_shape = tuple(self._model.output_shapes[0][1:3])
        self.pan_layers = self.num_levels = len(self._model.output_shapes)
        return self._model

    # ------------------------------------------------------------------
    def loss(self, binary_weight=1,
             loss_weight=[1, 5, 1],
             wh_reg_weight=0.01,
             ignore_thresh=0.6,
             truth_thresh=1.0,
             label_smooth=0.0,
             focal_loss_gamma=2):
        """Per-level v4 loss list (reference yolov4/__init__.py:475-536)."""
        if (not isinstance(binary_weight, Iterable)
                or len(binary_weight) != self.pan_layers):
            binary_weight = [binary_weight] * self.pan_layers
        if isinstance(loss_weight, dict):
            loss_weight = [loss_weight["box"], loss_weight["conf"],
                           loss_weight["prob"]]

        anchors = np.asarray(self.anchors, np.float32)
        losses = []
        for level in range(self.pan_layers):
            amp = 2 ** level
            grid_shape = (self.grid_shape[0] * amp,
                          self.grid_shape[1] * amp)
            lo = self.abox_num * level
            losses.append(wrap_yolo_loss_v4(
                grid_shape=grid_shape,
                bbox_num=self.abox_num,
                class_num=self.class_num,
                anchors=anchors[lo:lo + self.abox_num],
                binary_weight=binary_weight[level],
                loss_weight=loss_weight,
                wh_reg_weight=wh_reg_weight,
                ignore_thresh=ignore_thresh,
                truth_thresh=truth_thresh,
                label_smooth=label_smooth,
                focal_loss_gamma=focal_loss_gamma))
        return losses


# module-level parity with the reference's per-version subpackages
# (yolovN.losses.wrap_yolo_loss, yolovN.metrics.wrap_*)
globals().update(make_version_aliases(4))
