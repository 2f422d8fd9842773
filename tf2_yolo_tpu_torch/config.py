"""Dataclass config tree, JSON-serializable for reproducibility.

Port of tf2_yolo_tpu/config.py: the facades' constructor and method
keyword arguments (model, loss, NMS, training) in one tree, written and
read as the JAX package's JSON text, from which ``build`` makes the
facade of its version and its model, and ``build_loss`` that facade's
loss.
"""

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


@dataclass
class LossConfig:
    """Per-version loss knobs (union of the v1-v4 signatures)."""
    binary_weight: Any = 1.0
    loss_weight: Optional[List[float]] = None   # per-version default
    ignore_thresh: float = 0.6
    truth_thresh: float = 1.0                   # v4
    label_smooth: float = 0.0                   # v4
    wh_reg_weight: float = 0.01                 # v4
    use_focal_loss: bool = False                # v3
    focal_loss_gamma: int = 2
    use_scale: bool = True                      # v3


@dataclass
class NmsConfig:
    """Decode + NMS knobs (tools.py vis_img/nms signatures)."""
    conf_threshold: float = 0.5
    nms_mode: int = 1            # 0 none, 1 NMS, 2 soft, 3 DIoU
    nms_threshold: float = 0.45
    nms_sigma: float = 0.5
    max_boxes: int = 100


@dataclass
class TrainConfig:
    optimizer: str = "adam"
    learning_rate: float = 1e-4
    batch_size: int = 20
    epochs: int = 1
    seed: Optional[int] = None
    metrics: str = "obj_acc"
    checkpoint_dir: Optional[str] = None
    profile_dir: Optional[str] = None


@dataclass
class YoloConfig:
    """Top-level experiment config."""
    version: int = 4
    input_shape: Tuple[int, int, int] = (416, 416, 3)
    class_names: List[str] = field(default_factory=list)
    anchors: Optional[List[List[float]]] = None
    backbone: Optional[str] = None              # per-version default
    bbox_num: int = 2                           # v1 only
    pretrained_weights: Optional[str] = None
    pretrained_body: Optional[str] = None
    loss: LossConfig = field(default_factory=LossConfig)
    nms: NmsConfig = field(default_factory=NmsConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    # ------------------------------------------------------------------
    def to_json(self, path=None, indent=2):
        text = json.dumps(dataclasses.asdict(self), indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_json(cls, source):
        """Load from a JSON string or file path."""
        if isinstance(source, str) and source.lstrip().startswith("{"):
            data = json.loads(source)
        else:
            with open(source) as f:
                data = json.load(f)
        data = dict(data)
        data["loss"] = LossConfig(**data.get("loss", {}))
        data["nms"] = NmsConfig(**data.get("nms", {}))
        data["train"] = TrainConfig(**data.get("train", {}))
        data["input_shape"] = tuple(data["input_shape"])
        return cls(**data)

    # ------------------------------------------------------------------
    def build(self, device="cuda"):
        """Build the per-version Yolo facade and its model, on the card
        unless ``device`` says otherwise (the init drawn from
        ``train.seed``, 0 when it is None)."""
        from . import yolov1_5, yolov2, yolov3, yolov4

        mod = {1: yolov1_5, 2: yolov2, 3: yolov3, 4: yolov4}[
            self.version]
        yolo = mod.Yolo(input_shape=self.input_shape,
                        class_names=self.class_names)

        kwargs = {}
        if self.version == 1:
            kwargs["bbox_num"] = self.bbox_num
            if self.pretrained_body is not None:
                kwargs["pretrained_backbone"] = self.pretrained_body
        else:
            if self.anchors is not None:
                kwargs["anchors"] = self.anchors
            if self.backbone is not None:
                kwargs["backbone"] = self.backbone
            if self.version == 2:
                kwargs["pretrained_backbone"] = self.pretrained_body
            else:
                kwargs["pretrained_body"] = self.pretrained_body
        yolo.create_model(pretrained_weights=self.pretrained_weights,
                          seed=self.train.seed or 0, device=device,
                          **kwargs)
        return yolo

    def build_loss(self, yolo):
        """Build the version-appropriate loss from this config."""
        lc = self.loss
        if self.version == 1:
            return yolo.loss(
                binary_weight=lc.binary_weight,
                loss_weight=lc.loss_weight or [5, 5, 1, 1])
        if self.version == 2:
            return yolo.loss(
                binary_weight=lc.binary_weight,
                loss_weight=lc.loss_weight or [1, 1, 5, 1],
                ignore_thresh=lc.ignore_thresh)
        if self.version == 3:
            return yolo.loss(
                binary_weight=lc.binary_weight,
                loss_weight=lc.loss_weight or [1, 1, 5, 1],
                ignore_thresh=lc.ignore_thresh,
                use_focal_loss=lc.use_focal_loss,
                focal_loss_gamma=lc.focal_loss_gamma,
                use_scale=lc.use_scale)
        return yolo.loss(
            binary_weight=lc.binary_weight,
            loss_weight=lc.loss_weight or [1, 5, 1],
            wh_reg_weight=lc.wh_reg_weight,
            ignore_thresh=lc.ignore_thresh,
            truth_thresh=lc.truth_thresh,
            label_smooth=lc.label_smooth,
            focal_loss_gamma=lc.focal_loss_gamma)
