"""The four YOLO losses as closures over tensors.

Port of ``wrap_yolo_loss_v1`` .. ``wrap_yolo_loss_v4``,
``_sum_batch_mean`` and ``_response_mask`` in
tf2_yolo_tpu/ops/losses.py. ``loss(y_true, y_pred) -> scalar`` takes the
flat channel layout the model emits ((N, S, S, 5 B + C) for v1, (N, S, S,
B*(5+C)) otherwise) or pre-shaped tensors. The reduction is
``sum(mean(x, dim=0))`` (per-batch mean, then sum over grid/box/coord
axes). All math is f32 whatever the dtype of ``y_pred``, in the JAX
package's operation order, quirks included. ``binary_weight`` may be an
array: the loss is then computed per weight and their mean returned.
"""

import numpy as np
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


def _max_eps(x):
    """max(x, EPSILON) with ``jnp.maximum``'s gradient."""
    return torch.maximum(x, torch.full((), EPSILON, dtype=x.dtype,
                                       device=x.device))


def _binary_weight(binary_weight, device):
    # a 0-d weight joins a CUDA tensor from the CPU without a copy
    return binary_weight.to(device) if binary_weight.dim() \
        else binary_weight


def wrap_yolo_loss_v1(grid_shape,
                      bbox_num,
                      class_num,
                      binary_weight=1,
                      loss_weight=(1, 1, 1, 1)):
    """YOLOv1 loss: SSE xy, sqrt-wh, IoU-target conf (its gradient flows
    through the IoU, as in the JAX package) and softmax cross-entropy of
    the class distribution that the B boxes of a cell share."""
    grid_shape = tuple(int(g) for g in grid_shape)
    binary_weight = torch.as_tensor(binary_weight, dtype=torch.float32)

    def yolo_loss(y_true, y_pred):
        y_pred = y_pred.float().reshape(
            -1, *grid_shape, 5 * bbox_num + class_num)
        y_true = y_true.to(y_pred.device, torch.float32).reshape(
            -1, *grid_shape, 5 + class_num)
        xywhc_true = y_true[..., :-class_num].reshape(
            -1, *grid_shape, 1, 5)
        xywhc_pred = y_pred[..., :-class_num].reshape(
            -1, *grid_shape, bbox_num, 5)

        iou_scores = grid_iou(xywhc_true[..., :4], xywhc_pred[..., :4],
                              grid_shape)                      # N,S,S,B
        response = _response_mask(iou_scores.detach())
        response_exp = response[..., None]

        has_obj = xywhc_true[..., 4]                           # N,S,S,1
        has_obj_exp = has_obj[..., None]
        no_obj = 1.0 - has_obj * response                      # N,S,S,B

        xy_true = xywhc_true[..., 0:2]
        xy_pred = xywhc_pred[..., 0:2]
        wh_true = _max_eps(xywhc_true[..., 2:4])
        wh_pred = _max_eps(xywhc_pred[..., 2:4])
        c_pred = xywhc_pred[..., 4]

        xy_loss = _sum_batch_mean(
            has_obj_exp * response_exp * torch.square(xy_true - xy_pred))
        wh_loss = _sum_batch_mean(
            has_obj_exp * response_exp
            * torch.square(torch.sqrt(wh_true) - torch.sqrt(wh_pred)))
        has_obj_c = _sum_batch_mean(
            has_obj * response * torch.square(iou_scores - c_pred))
        no_obj_c = _sum_batch_mean(no_obj * torch.square(c_pred))
        c_loss = has_obj_c + _binary_weight(binary_weight,
                                            y_pred.device) * no_obj_c

        p_true = y_true[..., -class_num:]
        p_pred = clip(y_pred[..., -class_num:], EPSILON, 1 - EPSILON)
        p_loss = -_sum_batch_mean(has_obj * p_true * torch.log(p_pred))

        return (loss_weight[0] * xy_loss
                + loss_weight[1] * wh_loss
                + loss_weight[2] * c_loss
                + loss_weight[3] * p_loss).mean()

    return yolo_loss


def _anchor_loss(grid_shape, bbox_num, class_num, anchors, binary_weight,
                 loss_weight, ignore_thresh, use_focal_loss,
                 focal_loss_gamma, use_scale, bce):
    """The v2 (``bce=False``: softmax cross-entropy) and v3 (binary
    cross-entropy) loss: xy and log-space anchor-relative wh SSE scaled
    by 2 - w h, the best-IoU box responsible, no-obj below
    ``ignore_thresh``, SSE or focal conf, and a 0.01 wh^2 regularizer."""
    grid_shape = tuple(int(g) for g in grid_shape)
    if anchors is not None:
        anchors = torch.as_tensor(np.asarray(anchors, np.float32)).reshape(
            1, 1, 1, bbox_num, 2)
    binary_weight = torch.as_tensor(binary_weight, dtype=torch.float32)

    def yolo_loss(y_true, y_pred):
        y_pred = y_pred.float().reshape(
            -1, *grid_shape, bbox_num, 5 + class_num)
        y_true = y_true.to(y_pred.device, torch.float32).reshape(
            -1, *grid_shape, 1, 5 + class_num)

        # the IoU is read only through masks: no gradient
        iou_scores = grid_iou(y_true[..., :4], y_pred[..., :4],
                              grid_shape).detach()
        has_obj = y_true[..., 4] * _response_mask(iou_scores)
        has_obj_exp = has_obj[..., None]
        no_obj = (1.0 - has_obj) * (iou_scores < ignore_thresh).float()

        xy_true = y_true[..., 0:2]
        xy_pred = y_pred[..., 0:2]
        wh_true = y_true[..., 2:4]
        wh_pred = y_pred[..., 2:4]
        if anchors is not None:
            pa = anchors.to(y_pred.device)
            wh_true, wh_pred = wh_true / pa, wh_pred / pa
        wh_true = torch.log(_max_eps(wh_true))
        wh_pred = torch.log(wh_pred)
        c_pred = y_pred[..., 4]

        box_scale = (2.0 - y_true[..., 2:3] * y_true[..., 3:4]
                     if use_scale else 1.0)
        xy_loss = _sum_batch_mean(
            has_obj_exp * box_scale * torch.square(xy_true - xy_pred))
        wh_loss = _sum_batch_mean(
            has_obj_exp * box_scale * torch.square(wh_true - wh_pred))

        if use_focal_loss:
            c_clip = clip(c_pred, EPSILON, 1 - EPSILON)
            has_obj_c = -_sum_batch_mean(
                has_obj * (1.0 - c_clip) ** focal_loss_gamma
                * torch.log(c_clip))
            no_obj_c = -_sum_batch_mean(
                no_obj * c_clip ** focal_loss_gamma
                * torch.log(1.0 - c_clip))
        else:
            has_obj_c = _sum_batch_mean(has_obj * torch.square(1.0 - c_pred))
            no_obj_c = _sum_batch_mean(no_obj * torch.square(c_pred))
        c_loss = has_obj_c + _binary_weight(binary_weight,
                                            y_pred.device) * no_obj_c

        p_true = y_true[..., -class_num:]
        p_pred = clip(y_pred[..., -class_num:], EPSILON, 1 - EPSILON)
        if bce:
            p_loss = -_sum_batch_mean(
                has_obj_exp * (p_true * torch.log(p_pred)
                               + (1.0 - p_true) * torch.log(1.0 - p_pred)))
        else:
            p_loss = -_sum_batch_mean(has_obj_exp * p_true
                                      * torch.log(p_pred))

        regularizer = _sum_batch_mean(torch.square(wh_pred)) * 0.01

        return (loss_weight[0] * xy_loss
                + loss_weight[1] * wh_loss
                + loss_weight[2] * c_loss
                + loss_weight[3] * p_loss
                + regularizer).mean()

    return yolo_loss


def wrap_yolo_loss_v2(grid_shape,
                      bbox_num,
                      class_num,
                      anchors,
                      binary_weight=1,
                      loss_weight=(1, 1, 1, 1),
                      ignore_thresh=0.6):
    """YOLOv2 loss: log-space anchor-relative wh, ignore-thresh no-obj
    mask, box_loss_scale = 2 - w*h, wh^2*0.01 regularizer, softmax
    cross-entropy of the classes."""
    return _anchor_loss(grid_shape, bbox_num, class_num, anchors,
                        binary_weight, loss_weight, ignore_thresh,
                        use_focal_loss=False, focal_loss_gamma=2,
                        use_scale=True, bce=False)


def wrap_yolo_loss_v3(grid_shape,
                      bbox_num,
                      class_num,
                      anchors=None,
                      binary_weight=1,
                      loss_weight=(1, 1, 1, 1),
                      ignore_thresh=0.6,
                      use_focal_loss=False,
                      focal_loss_gamma=2,
                      use_scale=True):
    """YOLOv3 loss: v2's with an optional focal conf loss, an optional
    box scale, and binary cross-entropy of the classes; ``anchors=None``
    takes wh as it is."""
    return _anchor_loss(grid_shape, bbox_num, class_num, anchors,
                        binary_weight, loss_weight, ignore_thresh,
                        use_focal_loss, focal_loss_gamma, use_scale,
                        bce=True)


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
        c_loss = has_obj_c + _binary_weight(binary_weight,
                                            y_pred.device) * no_obj_c

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
