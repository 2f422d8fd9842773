"""Box geometry (IoU / DIoU / CIoU) on tensors.

Port of ``pair_iou`` and ``grid_iou`` in tf2_yolo_tpu/ops/geometry.py,
with the same operation order, so that the NMS kernel (csrc/nms.cu),
which repeats ``pair_iou``'s arithmetic, rounds as this function does.
``grid_iou`` is differentiable; its max/min are ``torch.maximum`` /
``torch.minimum`` on tensors, which split the gradient evenly at a tie
as ``jnp.maximum`` does (``clamp`` would pass all of it).
"""

import math

import torch

EPSILON = 1e-07


def clip(x, lo, hi):
    """min(max(x, lo), hi) with ``jnp.clip``'s gradient: 1 inside, 0
    outside and 0.5 at a bound (``torch.clamp`` gives 1 there)."""
    lo = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


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


def grid_iou(xywh_true, xywh_pred, grid_shape, return_ciou=False):
    """Loss-side IoU where only xy is normalized by the grid.

    The label stores xy as the offset inside the owning cell and wh
    normalized by image size; xy is divided by the grid (W, H order)
    before the IoU.

    Args:
        xywh_true: (..., 1, 4) grid-space truth.
        xywh_pred: (..., B, 4) grid-space prediction.
        grid_shape: (grid_h, grid_w) python ints.
        return_ciou: also return CIoU (= IoU - rho^2/c^2 - alpha*v).

    Returns:
        iou (..., B) or (iou, ciou).
    """
    wh_norm = torch.tensor([float(g) for g in grid_shape[::-1]],
                           dtype=xywh_true.dtype, device=xywh_true.device)

    xy_true = xywh_true[..., 0:2] / wh_norm
    wh_true = xywh_true[..., 2:4]
    xy_pred = xywh_pred[..., 0:2] / wh_norm
    wh_pred = xywh_pred[..., 2:4]

    mins_t, maxes_t = _corners(xy_true, wh_true)
    mins_p, maxes_p = _corners(xy_pred, wh_pred)

    inter_mins = torch.maximum(mins_p, mins_t)
    inter_maxes = torch.minimum(maxes_p, maxes_t)
    inter_wh = inter_maxes - inter_mins
    inter_wh = torch.maximum(inter_wh, torch.zeros_like(inter_wh))
    inter_area = inter_wh[..., 0] * inter_wh[..., 1]

    area_t = wh_true[..., 0] * wh_true[..., 1]
    area_p = wh_pred[..., 0] * wh_pred[..., 1]
    union = area_p + area_t - inter_area
    iou = inter_area / (union + EPSILON)

    if not return_ciou:
        return iou

    enc_mins = torch.minimum(mins_p, mins_t)
    enc_maxes = torch.maximum(maxes_p, maxes_t)
    enc_wh = enc_maxes - enc_mins
    enc_c2 = enc_wh[..., 0] ** 2 + enc_wh[..., 1] ** 2
    rho2 = ((xy_true[..., 0] - xy_pred[..., 0]) ** 2
            + (xy_true[..., 1] - xy_pred[..., 1]) ** 2)

    atan_t = torch.atan(wh_true[..., 0] / (wh_true[..., 1] + EPSILON))
    atan_p = torch.atan(wh_pred[..., 0] / (wh_pred[..., 1] + EPSILON))
    v = 4.0 / (math.pi ** 2) * (atan_t - atan_p) ** 2
    alpha = v / (1.0 - iou + v)

    ciou = iou - rho2 / enc_c2 - alpha * v
    return iou, ciou
