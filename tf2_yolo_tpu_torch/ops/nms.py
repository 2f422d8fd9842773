"""On-device NMS dispatch (greedy IoU and DIoU), static shapes.

Port of ``apply_nms_device`` and ``_sorted_by_conf`` from
tf2_yolo_tpu/ops/nms.py. Greedy and DIoU NMS run through
:func:`~tf2_yolo_tpu_torch.ops.kernels.nms.nms_keep`, the CUDA kernel on
a GPU tensor and its plain version on a CPU tensor.
"""

import torch

from .kernels.nms import nms_keep, nms_keep_plain


def _sorted_by_conf(rows, valid):
    """Sort each image's rows by joint confidence, descending; invalid
    rows last. Stable, as ``jnp.argsort`` is."""
    joint = rows[..., 4] * rows[..., 6]
    joint = torch.where(valid, joint, torch.full_like(joint, -torch.inf))
    order = torch.argsort(-joint, dim=-1, stable=True)
    rows = torch.gather(rows, 1, order[..., None].expand(-1, -1,
                                                          rows.shape[-1]))
    valid = torch.gather(valid, 1, order)
    return rows, valid


def apply_nms_device(rows, valid, nms_mode=1, nms_threshold=0.45,
                     plain=False):
    """Modes as the host ``apply_nms``: 0 none, 1 NMS, 3 DIoU-NMS.

    rows (N, K, 7), valid (N, K) bool. Returns (rows_sorted, keep) for
    modes 1 and 3 and (rows, valid) for mode 0. ``plain=True`` takes the
    plain NMS on any device (the reference route of a model set to
    plain, see ``models.layers.use_plain_route``).
    """
    if nms_mode == 0:
        return rows, valid
    if nms_mode == 2:
        raise NotImplementedError(
            "Soft-NMS (nms_mode=2) is not ported yet: ROADMAP.md, "
            "modules to port, 'Soft-NMS'")
    if nms_mode not in (1, 3):
        raise ValueError(f"Invalid nms_mode: {nms_mode}")
    rows_s, valid_s = _sorted_by_conf(rows, valid)
    boxes = torch.cat([rows_s, valid_s[..., None].to(rows_s.dtype)],
                      dim=-1).contiguous()
    keep_fn = nms_keep_plain if plain else nms_keep
    keep = keep_fn(boxes, nms_threshold, 1 if nms_mode == 1 else 2)
    return rows_s, keep > 0.5
