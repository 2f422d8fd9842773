"""On-device box decode with static shapes.

Port of tf2_yolo_tpu/ops/decode.py: the v2-v4 per-anchor layout and
the v1 layout, whose B boxes of a cell share one class distribution.
Output rows are [x, y, w, h, conf, class_idx, class_prob], x/y normalized to
the image, with a validity mask instead of a ragged result.

Top-k order: ``lax.top_k`` puts the lower index first among equal
values. ``torch.topk`` promises no order among ties, so selection here
is a stable descending sort, which keeps the lower index first.
"""

import torch


def _top_k(values, k):
    vals, idx = torch.sort(values, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _check_version(version):
    if version not in (1, 2, 3, 4):
        raise ValueError(f"Invalid version: {version}")


def decode_one_level(label_data, class_num=1, threshold=0.5,
                     max_boxes=100, version=2):
    """Decode one level's head output: (N, S, S, B*(5+C)) for
    ``version`` 2-4 (the per-anchor layout), (N, S, S, 5 B + C) for 1 (B
    boxes sharing the last C class channels).

    Returns rows (N, max_boxes, 7) f32 sorted by joint confidence
    descending, and valid (N, max_boxes) bool (joint conf >= threshold).
    """
    _check_version(version)
    n, gh, gw = label_data.shape[:3]
    label_data = label_data.float()
    if version == 1:
        bbox_num = (label_data.shape[-1] - class_num) // 5
        xywhc = label_data[..., :-class_num].reshape(n, gh, gw, bbox_num, 5)
        prob = label_data[..., None, -class_num:].expand(
            n, gh, gw, bbox_num, class_num)
    else:
        bbox_num = label_data.shape[-1] // (5 + class_num)
        shaped = label_data.reshape(n, gh, gw, bbox_num, 5 + class_num)
        xywhc = shaped[..., :5]
        prob = shaped[..., 5:]

    joint = xywhc[..., 4:5] * prob                  # N,gh,gw,B,C

    dev = label_data.device
    cols = torch.arange(gw, dtype=torch.float32, device=dev).view(1, 1, gw, 1)
    rows_i = torch.arange(gh, dtype=torch.float32, device=dev).view(1, gh, 1, 1)
    x = (cols + xywhc[..., 0]) / gw                 # N,gh,gw,B
    y = (rows_i + xywhc[..., 1]) / gh
    w, h, conf = xywhc[..., 2], xywhc[..., 3], xywhc[..., 4]

    flat = joint.reshape(n, -1)                     # N, gh*gw*B*C
    k = min(max_boxes, flat.shape[1])
    top_vals, top_idx = _top_k(flat, k)

    cls_idx = top_idx % class_num
    cell_box = top_idx // class_num                 # index into gh*gw*B

    def gather(field):
        return torch.gather(field.reshape(n, -1), 1, cell_box)

    out = torch.stack([
        gather(x), gather(y), gather(w), gather(h), gather(conf),
        cls_idx.float(),
        torch.gather(prob.reshape(n, -1), 1, top_idx),
    ], dim=-1)                                      # N,k,7

    valid = top_vals >= threshold
    if k < max_boxes:
        pad = max_boxes - k
        out = torch.nn.functional.pad(out, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return out, valid


def decode_multi_level(label_datas, class_num=1, threshold=0.5,
                       max_boxes=100, version=3):
    """Decode each level and merge to one top-``max_boxes`` set per
    image. Invalid rows all tie at -1 and keep level order."""
    rows_all, valid_all = [], []
    for ld in label_datas:
        rows, valid = decode_one_level(ld, class_num=class_num,
                                       threshold=threshold,
                                       max_boxes=max_boxes, version=version)
        rows_all.append(rows)
        valid_all.append(valid)
    rows = torch.cat(rows_all, dim=1)
    valid = torch.cat(valid_all, dim=1)
    joint = torch.where(valid, rows[..., 4] * rows[..., 6],
                        torch.full_like(rows[..., 4], -1.0))
    _, top_idx = _top_k(joint, max_boxes)
    rows = torch.gather(rows, 1, top_idx[..., None].expand(-1, -1, 7))
    valid = torch.gather(valid, 1, top_idx)
    return rows, valid
