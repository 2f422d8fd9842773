"""Box geometry (IoU / DIoU) on tensors.

Port of ``pair_iou`` in tf2_yolo_tpu/ops/geometry.py, with the same
operation order, so that the NMS kernel (csrc/nms.cu), which repeats
this arithmetic, rounds as this function does.
"""

EPSILON = 1e-07


def _corners(xy, wh):
    half = wh / 2.0
    return xy - half, xy + half


def pair_iou(xywh_a, xywh_b, mode=1):
    """Broadcast IoU of two xywh tensors (x, y normalized by image size).

    Args:
        xywh_a: tensor (..., 4).
        xywh_b: tensor (..., 4), broadcast-compatible with ``xywh_a``.
        mode: 1 -> IoU, 2 -> DIoU (= IoU - rho^2 / c^2).

    Returns:
        IoU (or DIoU) with the broadcast shape minus the last axis.
    """
    xy_a, wh_a = xywh_a[..., 0:2], xywh_a[..., 2:4]
    xy_b, wh_b = xywh_b[..., 0:2], xywh_b[..., 2:4]

    mins_a, maxes_a = _corners(xy_a, wh_a)
    mins_b, maxes_b = _corners(xy_b, wh_b)

    inter_mins = mins_b.maximum(mins_a)
    inter_maxes = maxes_b.minimum(maxes_a)
    inter_wh = (inter_maxes - inter_mins).clamp(min=0.0)
    inter_area = inter_wh[..., 0] * inter_wh[..., 1]

    area_a = wh_a[..., 0] * wh_a[..., 1]
    area_b = wh_b[..., 0] * wh_b[..., 1]
    union = area_a + area_b - inter_area
    iou = inter_area / (union + EPSILON)

    if mode == 1:
        return iou

    enc_mins = mins_b.minimum(mins_a)
    enc_maxes = maxes_b.maximum(maxes_a)
    enc_wh = enc_maxes - enc_mins
    enc_c2 = enc_wh[..., 0] * enc_wh[..., 0] + enc_wh[..., 1] * enc_wh[..., 1]
    dx = xy_a[..., 0] - xy_b[..., 0]
    dy = xy_a[..., 1] - xy_b[..., 1]
    rho2 = dx * dx + dy * dy
    return iou - rho2 / enc_c2
