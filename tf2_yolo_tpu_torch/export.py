"""The serving program: eval-mode forward, device decode, device NMS.

Port of ``make_serving_fn`` in tf2_yolo_tpu/export.py. (BN folding, int8
and the saved serving artifact come later.)
"""

import torch

from .ops.decode import decode_multi_level
from .ops.nms import apply_nms_device


def make_serving_fn(model, class_num, version=4, threshold=0.5, nms_mode=1,
                    nms_threshold=0.45, nms_sigma=0.5, max_boxes=128):
    """Return ``serve(images) -> (rows, keep)`` for NHWC f32 images:
    rows (N, max_boxes, 7) = [x, y, w, h, conf, class_idx, class_prob]
    and keep (N, max_boxes) bool, under ``torch.inference_mode()``.

    ``threshold`` is also the confidence under which Soft-NMS
    (``nms_mode=2``, decay ``nms_sigma``) drops a decayed box, as in the
    JAX version. The NMS takes the model's route: the kernel by default,
    the plain version after ``models.layers.use_plain_route(model)``.
    """
    if version not in (2, 3, 4):
        raise NotImplementedError(
            f"version {version}: the v1 shared-class decode layout is not "
            "ported yet (ROADMAP.md, modules to port, other families)")
    model.eval()

    @torch.inference_mode()
    def serve(images):
        outs = model(images)
        rows, valid = decode_multi_level(
            outs if isinstance(outs, (list, tuple)) else [outs],
            class_num=class_num, threshold=threshold, max_boxes=max_boxes)
        return apply_nms_device(rows, valid, nms_mode=nms_mode,
                                nms_threshold=nms_threshold,
                                conf_threshold=threshold,
                                nms_sigma=nms_sigma,
                                plain=getattr(model, "plain", False))

    return serve
