"""Train-time metrics as closures over tensors.

Port of tf2_yolo_tpu/ops/metrics.py: ``wrap_obj_acc``, ``wrap_mean_iou``,
``wrap_class_acc`` and ``wrap_recall`` return ``metric(y_true, y_pred) ->
0-d tensor`` on ``y_pred``'s device (reading it waits for the step). The
``version`` argument selects the tensor layout: 1 for YOLOv1 (5*B + a
shared C), anything >= 2 for the per-anchor layout B x (5+C). All math is
f32, as the losses'. The closures' ``__name__`` is the metric's name,
which the engine's logs use.
"""

import torch

from .geometry import EPSILON, grid_iou


def _f32(y_true, y_pred):
    y_pred = y_pred.float()
    return y_true.to(y_pred.device, torch.float32), y_pred


def _split_v1(y_true, y_pred, grid_shape, bbox_num, class_num):
    xywhc_true = y_true[..., :-class_num].reshape(-1, *grid_shape, 1, 5)
    xywhc_pred = y_pred[..., :-class_num].reshape(
        -1, *grid_shape, bbox_num, 5)
    return xywhc_true, xywhc_pred


def _split_v2(y_true, y_pred, grid_shape, bbox_num, class_num):
    y_true = y_true.reshape(-1, *grid_shape, 1, 5 + class_num)
    y_pred = y_pred.reshape(-1, *grid_shape, bbox_num, 5 + class_num)
    return y_true, y_pred


def _split(y_true, y_pred, grid_shape, bbox_num, class_num, version):
    split = _split_v1 if version == 1 else _split_v2
    return split(y_true, y_pred, grid_shape, bbox_num, class_num)


def _argmax_first(x):
    """Index of the largest value on the last axis, ties to the first
    (``jnp.argmax``'s rule, which ``torch.argmax`` does not promise on
    every device)."""
    best = x == x.max(dim=-1, keepdim=True).values
    return (best & (best.cumsum(dim=-1) == 1)).to(torch.uint8).argmax(dim=-1)


def wrap_obj_acc(grid_shape, bbox_num, class_num, version=2):
    """Binary accuracy of max-over-boxes confidence vs objectness."""
    grid_shape = tuple(int(g) for g in grid_shape)

    def obj_acc(y_true, y_pred):
        t, p = _split(*_f32(y_true, y_pred), grid_shape, bbox_num,
                      class_num, version)
        c_true = t[..., 4]                                      # N,S,S,1
        c_pred = p[..., 4].max(dim=-1, keepdim=True).values     # N,S,S,1
        # keras binary_accuracy thresholds the prediction at > 0.5
        thresholded = (c_pred > 0.5).float()
        return (c_true == thresholded).float().mean()

    return obj_acc


def wrap_mean_iou(grid_shape, bbox_num, class_num, version=2):
    """Mean best-box IoU over object cells."""
    grid_shape = tuple(int(g) for g in grid_shape)

    def mean_iou(y_true, y_pred):
        t, p = _split(*_f32(y_true, y_pred), grid_shape, bbox_num,
                      class_num, version)
        has_obj = t[..., 4]                                     # N,S,S,1
        iou = grid_iou(t[..., :4], p[..., :4], grid_shape)      # N,S,S,B
        iou = iou.max(dim=-1, keepdim=True).values * has_obj
        return iou.sum() / (has_obj.sum() + EPSILON)

    return mean_iou


def wrap_class_acc(grid_shape, bbox_num, class_num, version=2):
    """Argmax class match over object cells. For v1 the class
    distribution is shared per cell (denominator: the object count); for
    v2+ it is per anchor box (denominator scaled by ``bbox_num``)."""
    grid_shape = tuple(int(g) for g in grid_shape)

    def class_acc(y_true, y_pred):
        y_true, y_pred = _f32(y_true, y_pred)
        if version == 1:
            y_true_r = y_true.reshape(-1, *grid_shape, 5 + class_num)
            y_pred_r = y_pred.reshape(
                -1, *grid_shape, 5 * bbox_num + class_num)
            has_obj = y_true_r[..., 4]                          # N,S,S
            pi_true = _argmax_first(y_true_r[..., -class_num:])
            pi_pred = _argmax_first(y_pred_r[..., -class_num:])
            equal = (pi_true == pi_pred).float() * has_obj
            num_p = has_obj.sum()
        else:
            t, p = _split_v2(y_true, y_pred, grid_shape, bbox_num,
                             class_num)
            has_obj = t[..., 4]                                 # N,S,S,1
            pi_true = _argmax_first(t[..., -class_num:])        # N,S,S,1
            pi_pred = _argmax_first(p[..., -class_num:])        # N,S,S,B
            equal = (pi_true == pi_pred).float() * has_obj
            num_p = has_obj.sum() * bbox_num
        return equal.sum() / (num_p + EPSILON)

    return class_acc


def wrap_recall(grid_shape, bbox_num, class_num, iou_threshold=0.5,
                version=2):
    """Recall at an IoU threshold, gated on class match."""
    grid_shape = tuple(int(g) for g in grid_shape)

    def recall(y_true, y_pred):
        y_true, y_pred = _f32(y_true, y_pred)
        t, p = _split(y_true, y_pred, grid_shape, bbox_num, class_num,
                      version)
        has_obj = t[..., 4]                                     # N,S,S,1
        if version == 1:
            y_true_r = y_true.reshape(-1, *grid_shape, 5 + class_num)
            y_pred_r = y_pred.reshape(
                -1, *grid_shape, 5 * bbox_num + class_num)
            pi_true = _argmax_first(y_true_r[..., -class_num:])
            pi_pred = _argmax_first(y_pred_r[..., -class_num:])
            equal = (pi_true == pi_pred).float()[..., None] * has_obj
        else:
            pi_true = _argmax_first(t[..., -class_num:])
            pi_pred = _argmax_first(p[..., -class_num:])
            equal = (pi_true == pi_pred).float() * has_obj
        iou = grid_iou(t[..., :4], p[..., :4], grid_shape) * equal
        iou = iou.max(dim=-1, keepdim=True).values              # N,S,S,1
        num_tp = (iou >= iou_threshold).float().sum()
        return num_tp / (has_obj.sum() + EPSILON)

    return recall
