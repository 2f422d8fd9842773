"""The YOLOv4 loss as a closure over tensors.

Port of ``wrap_yolo_loss_v4``, ``_sum_batch_mean`` and ``_response_mask``
in tf2_yolo_tpu/ops/losses.py. ``loss(y_true, y_pred) -> scalar`` takes
the flat channel layout (N, S, S, B*(5+C)) the model emits or pre-shaped
(N, S, S, B, 5+C) tensors. The reduction is ``sum(mean(x, dim=0))``
(per-batch mean, then sum over grid/box/coord axes). All math is f32
whatever the dtype of ``y_pred``. (Losses v1-v3 come with the other
families.)
"""

import torch

from .geometry import EPSILON, clip, grid_iou


def _sum_batch_mean(x):
    """sum over all axes of the per-batch mean."""
    return x.mean(dim=0).sum()


def _response_mask(iou_scores):
    """One-hot of the best-IoU box per cell, ties to the first index.
    Written with a cumulative count because ``torch.argmax`` does not
    promise the first index among equals on every device."""
    best = iou_scores == iou_scores.max(dim=-1, keepdim=True).values
    first = best & (best.cumsum(dim=-1) == 1)
    return first.to(iou_scores.dtype)


def wrap_yolo_loss_v4(grid_shape,
                      bbox_num,
                      class_num,
                      anchors=None,
                      binary_weight=1,
                      loss_weight=(1, 1, 1),
                      wh_reg_weight=0.01,
                      ignore_thresh=0.6,
                      truth_thresh=1,
                      label_smooth=0,
                      focal_loss_gamma=2):
    """YOLOv4 loss: CIoU box term, focal conf with label smoothing,
    BCE class loss, log-space wh regularizer, 3-way loss weights. The
    ``anchors`` here are constants (the head's are parameters).
    ``binary_weight`` may be an array, as in the JAX package: the loss
    is then computed per weight and their mean returned (equal to the
    loss at the weights' mean)."""
    grid_shape = tuple(int(g) for g in grid_shape)
    if anchors is not None:
        anchors = torch.as_tensor(anchors, dtype=torch.float32).reshape(
            1, 1, 1, bbox_num, 2)
    binary_weight = torch.as_tensor(binary_weight, dtype=torch.float32)

    def yolo_loss(y_true, y_pred):
        y_pred = y_pred.float().reshape(
            -1, *grid_shape, bbox_num, 5 + class_num)
        y_true = y_true.to(y_pred.device, torch.float32).reshape(
            -1, *grid_shape, 1, 5 + class_num)

        iou_scores, ciou_scores = grid_iou(
            y_true[..., :4], y_pred[..., :4], grid_shape, return_ciou=True)
        # the masks are piecewise constant in y_pred: no gradient
        iou_scores = iou_scores.detach()
        has_obj = y_true[..., 4] * _response_mask(iou_scores)
        if truth_thresh < 1:
            truth_mask = (iou_scores > truth_thresh).float()
            has_obj = has_obj + truth_mask * (1.0 - has_obj)
        has_obj_exp = has_obj[..., None]
        no_obj = (1.0 - has_obj) * (iou_scores < ignore_thresh).float()

        box_loss = _sum_batch_mean(has_obj * (1.0 - ciou_scores))

        c_pred = clip(y_pred[..., 4], EPSILON, 1 - EPSILON)
        if label_smooth > 0:
            obj_error = torch.abs(1.0 - label_smooth - c_pred)
            no_obj_error = torch.abs(label_smooth - c_pred)
        else:
            obj_error = 1.0 - c_pred
            no_obj_error = c_pred

        has_obj_c = -_sum_batch_mean(
            has_obj * obj_error ** focal_loss_gamma
            * torch.log(1.0 - obj_error))
        no_obj_c = -_sum_batch_mean(
            no_obj * no_obj_error ** focal_loss_gamma
            * torch.log(1.0 - no_obj_error))
        # a 0-d weight joins a CUDA tensor from the CPU without a copy
        bw = binary_weight.to(y_pred.device) if binary_weight.dim() \
            else binary_weight
        c_loss = has_obj_c + bw * no_obj_c

        p_true = y_true[..., -class_num:]
        p_pred = clip(y_pred[..., -class_num:], EPSILON, 1 - EPSILON)
        p_loss = -_sum_batch_mean(
            has_obj_exp * (p_true * torch.log(p_pred)
                           + (1.0 - p_true) * torch.log(1.0 - p_pred)))

        wh_pred = y_pred[..., 2:4]
        if anchors is not None:
            wh_pred = wh_pred / anchors.to(y_pred.device)
        wh_reg = _sum_batch_mean(torch.square(torch.log(wh_pred)))

        return (loss_weight[0] * box_loss
                + loss_weight[1] * c_loss
                + loss_weight[2] * p_loss
                + wh_reg_weight * wh_reg).mean()

    return yolo_loss
