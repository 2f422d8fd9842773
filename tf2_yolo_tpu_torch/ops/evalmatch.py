"""Batched evaluation matching (IoU assignment, TP/TPP counting) for
``create_score_mat`` / ``PRfunc``.

Port of tf2_yolo_tpu/ops/evalmatch.py. The padded decoded detections of a
whole image chunk (``ops.decode_multi_level`` + ``ops.apply_nms_device``)
are matched at once: one (B, T, P) IoU lattice with class and validity
masking, the best GT of each prediction, and per-class sums as one-hot
products in f32 (exact for integer counts). These are plain tensor ops,
on whatever device the rows lie; the host then does vectorized NumPy over
the flat result.

Semantics are the host path's:
  - a prediction matches the GT with the HIGHEST IoU among the
    same-class GTs of its image, the first on ties, as ``np.argmax`` over
    the class subset (masking with -1 keeps the subset's order);
  - it counts as TPP if that best IoU >= iou_threshold;
  - TP collapses TPPs sharing a GT to one (unique matched GTs).
"""

import torch

from .geometry import pair_iou


def _one_hot(idx, num):
    """f32 one-hot of int ``idx`` over ``num``; an index outside
    [0, num) gives a zero row, as ``jax.nn.one_hot``."""
    return (idx[..., None] == torch.arange(num, device=idx.device)).float()


def match_counts(t_rows, t_valid, p_rows, p_valid, class_num,
                 iou_threshold):
    """Per-image, per-class detection-matching counts.

    Args:
        t_rows: (B, T, 7) padded GT rows [x, y, w, h, conf, cls, prob].
        t_valid: (B, T) bool validity of GT rows.
        p_rows: (B, P, 7) padded prediction rows (same layout).
        p_valid: (B, P) bool validity of prediction rows.
        class_num: number of classes.
        iou_threshold: match threshold.

    Returns:
        dict of (B, class_num) int32 tensors: ``n_true`` / ``n_pred``
        (class-wise GT / prediction counts), ``tpp`` (matched
        predictions), ``tp`` (unique matched GTs).
    """
    t_cls = t_rows[..., 5].to(torch.int32)
    p_cls = p_rows[..., 5].to(torch.int32)
    t_oh = _one_hot(t_cls, class_num) * t_valid[..., None]     # (B, T, C)
    p_oh = _one_hot(p_cls, class_num) * p_valid[..., None]     # (B, P, C)

    hit, best_gt = _match(t_rows, t_valid, p_rows, p_valid, t_cls, p_cls,
                          iou_threshold)

    # matched-GT occupancy: the hits onto their best GT slot (a one-hot
    # product), then > 0 marks each GT matched at least once
    gt_oh = _one_hot(best_gt, t_rows.shape[1])                 # (B, P, T)
    gt_hits = torch.einsum("bpt,bp->bt", gt_oh, hit.float())   # (B, T)
    matched_gt = (gt_hits > 0).float()

    return {
        "n_true": t_oh.sum(dim=1).to(torch.int32),
        "n_pred": p_oh.sum(dim=1).to(torch.int32),
        "tpp": torch.einsum("bpc,bp->bc", p_oh,
                            hit.float()).to(torch.int32),
        "tp": torch.einsum("btc,bt->bc", t_oh,
                           matched_gt).to(torch.int32),
    }


def match_pred_arrays(t_rows, t_valid, p_rows, p_valid, iou_threshold):
    """Per-prediction matching arrays for the PR sweep.

    Returns (B, P) tensors: ``joint_conf`` (conf x class prob), ``cls``
    int32, ``hit`` bool, ``best_gt`` int32 (row index into the image's
    padded GT rows: unique per (image, GT) once offset by image * T,
    which is all the PR sweep needs), and ``valid`` bool.
    """
    t_cls = t_rows[..., 5].to(torch.int32)
    p_cls = p_rows[..., 5].to(torch.int32)
    hit, best_gt = _match(t_rows, t_valid, p_rows, p_valid, t_cls, p_cls,
                          iou_threshold)
    return {
        "joint_conf": p_rows[..., 4] * p_rows[..., 6],
        "cls": p_cls,
        "hit": hit,
        "best_gt": best_gt,
        "valid": p_valid,
    }


def _match(t_rows, t_valid, p_rows, p_valid, t_cls, p_cls, iou_threshold):
    """(hit, best_gt): the best same-class GT of each prediction from one
    masked (B, T, P) IoU lattice."""
    ious = pair_iou(t_rows[:, :, None, :4], p_rows[:, None, :, :4])
    pair_ok = (t_valid[:, :, None] & p_valid[:, None, :]
               & (t_cls[:, :, None] == p_cls[:, None, :]))
    # real IoUs are >= 0, so -1 masking keeps the argmax over the valid
    # same-class subset
    masked = torch.where(pair_ok, ious, torch.full_like(ious, -1.0))
    best_iou = masked.max(dim=1).values                        # (B, P)
    # the first maximum: the least index that attains it, so that no
    # reduction order on any device decides a tie
    t = masked.shape[1]
    index = torch.arange(t, device=masked.device)[None, :, None]
    best_gt = torch.where(masked == best_iou[:, None], index,
                          torch.full_like(index, t)).amin(dim=1)
    hit = (best_iou >= iou_threshold) & p_valid
    return hit, best_gt.to(torch.int32)
