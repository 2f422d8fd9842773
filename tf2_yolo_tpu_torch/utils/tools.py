"""Host-side (NumPy) utilities: image reading, the label pyramid,
decode, IoU and NMS, class weights, visualisation and annotation export.

A copy of the numpy functions of tf2_yolo_tpu/utils/tools.py (the port
imports nothing of the JAX package). They mirror the reference
``utils/tools.py`` behaviorally, vectorized with NumPy; the device-side
equivalents live in ``tf2_yolo_tpu_torch.ops``, and these host versions
are their oracle.
"""

import os
import xml.etree.ElementTree as ET

import numpy as np

EPSILON = 1e-07


# ---------------------------------------------------------------------------
# image reading
# ---------------------------------------------------------------------------

def read_img(path, size=(512, 512), rescale=None):
    """Read a folder of images into one (N, H, W, 3) ndarray.

    Parity with reference tools.py:29-52 (PIL resize -> RGB -> optional
    rescale; hidden files skipped; os.listdir order).
    """
    from PIL import Image

    names = [f for f in os.listdir(path) if not f.startswith(".")]
    data = np.empty((len(names), *size, 3))
    pil_size = (size[1], size[0])
    for i, name in enumerate(names):
        img = Image.open(os.path.join(path, name)).resize(pil_size)
        arr = np.array(img.convert("RGB"))
        data[i] = arr * rescale if rescale is not None else arr
    return data


# ---------------------------------------------------------------------------
# label pyramid
# ---------------------------------------------------------------------------

def down2xlabel(label_data):
    """2x-downsample a grid label, keeping the largest-area box per
    2x2 block (reference tools.py:342-367), vectorized.

    Within each 2x2 block the cells are ordered row-major
    ((0,0),(0,1),(1,0),(1,1)); the selected cell's xy offset is remapped
    into the coarser cell as (xy + (col, row)) / 2.
    """
    label_data = np.asarray(label_data)
    n, gh, gw, ch = label_data.shape
    blocks = (label_data
              .reshape(n, gh // 2, 2, gw // 2, 2, ch)
              .transpose(0, 1, 3, 2, 4, 5)
              .reshape(n, gh // 2, gw // 2, 4, ch))

    conf_hit = blocks[..., 4].max(axis=-1) == 1            # N,h,w
    area = blocks[..., 2] * blocks[..., 3]                 # N,h,w,4
    best = area.argmax(axis=-1)                            # N,h,w
    sel = np.take_along_axis(
        blocks, best[..., None, None], axis=3)[..., 0, :]  # N,h,w,ch

    col = (best % 2).astype(label_data.dtype)
    row = (best // 2).astype(label_data.dtype)
    new_xy = (sel[..., :2] + np.stack([col, row], axis=-1)) / 2

    out = np.concatenate([new_xy, sel[..., 2:]], axis=-1)
    return np.where(conf_hit[..., None], out,
                    np.zeros_like(out))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode(*label_datas, class_num=1, threshold=0.5, version=1):
    """Grid output(s) -> (N, 7) rows [x, y, w, h, conf, class_idx, prob].

    Parity with reference tools.py:370-438 including row order (the
    reference iterates ``np.where`` results, which is row-major over
    (y, x, box, class)) and the v1 shared-class layout vs v2-4
    per-anchor layout.
    """
    rows = []
    for label_data in label_datas:
        label_data = np.asarray(label_data)
        gh, gw = label_data.shape[:2]
        if version == 1:
            bbox_num = (label_data.shape[-1] - class_num) // 5
            xywhc = label_data[..., :-class_num].reshape(
                gh, gw, bbox_num, 5)
            prob = label_data[..., -class_num:][..., None, :]  # gh,gw,1,C
        elif version in (2, 3, 4):
            bbox_num = label_data.shape[-1] // (5 + class_num)
            shaped = label_data.reshape(gh, gw, bbox_num, 5 + class_num)
            xywhc = shaped[..., :5]
            prob = shaped[..., -class_num:]
        else:
            raise ValueError(f"Invalid version: {version}")

        joint = xywhc[..., 4:5] * prob                      # gh,gw,B,C
        ys, xs, bs, cs = np.nonzero(joint >= threshold)
        if len(ys) == 0:
            continue

        x = (xs + xywhc[ys, xs, bs, 0]) / gw
        y = (ys + xywhc[ys, xs, bs, 1]) / gh
        w = xywhc[ys, xs, bs, 2]
        h = xywhc[ys, xs, bs, 3]
        conf = xywhc[ys, xs, bs, 4]
        if version == 1:
            p = prob[ys, xs, np.zeros_like(bs), cs]
        else:
            p = prob[ys, xs, bs, cs]
        rows.append(np.stack(
            [x, y, w, h, conf, cs.astype(float), p], axis=1))

    if not rows:
        return np.array([], dtype="float")
    return np.concatenate(rows, axis=0).astype("float")


# ---------------------------------------------------------------------------
# IoU / NMS
# ---------------------------------------------------------------------------

def cal_iou(xywh_true, xywh_pred, mode=1):
    """Broadcast IoU (mode 1) or DIoU (mode 2) of xywh arrays.

    Parity with reference tools.py:630-684.
    """
    xywh_true = np.asarray(xywh_true, dtype=float)
    xywh_pred = np.asarray(xywh_pred, dtype=float)
    xy_t, wh_t = xywh_true[..., 0:2], xywh_true[..., 2:4]
    xy_p, wh_p = xywh_pred[..., 0:2], xywh_pred[..., 2:4]

    mins_t, maxes_t = xy_t - wh_t / 2, xy_t + wh_t / 2
    mins_p, maxes_p = xy_p - wh_p / 2, xy_p + wh_p / 2

    inter_wh = np.maximum(
        np.minimum(maxes_p, maxes_t) - np.maximum(mins_p, mins_t), 0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = (wh_t[..., 0] * wh_t[..., 1]
             + wh_p[..., 0] * wh_p[..., 1] - inter)
    iou = inter / (union + EPSILON)
    if mode == 1:
        return iou

    enc_wh = (np.maximum(maxes_p, maxes_t)
              - np.minimum(mins_p, mins_t))
    enc_c2 = enc_wh[..., 0] ** 2 + enc_wh[..., 1] ** 2
    rho2 = ((xy_t[..., 0] - xy_p[..., 0]) ** 2
            + (xy_t[..., 1] - xy_p[..., 1]) ** 2)
    return iou - rho2 / enc_c2


def _greedy_suppress(grp, ious, conf, nms_threshold):
    """Classic greedy NMS keep-mask, matching reference tools.py:719-729
    (a suppressed box never suppresses others; already-visited boxes are
    never suppressed; ties follow np.argsort order)."""
    order = np.argsort(conf)[::-1]
    n = len(grp)
    visited = np.zeros(n, dtype=bool)
    suppressed = np.zeros(n, dtype=bool)
    for idx in order:
        visited[idx] = True
        if suppressed[idx]:
            continue
        for j in np.where(ious[idx] >= nms_threshold)[0]:
            if not visited[j]:
                suppressed[j] = True
    return ~suppressed


def nms(xywhcp, class_num=1, nms_threshold=0.45, iou_mode=1):
    """Class-wise greedy NMS over decoded rows (reference tools.py:687-733).

    ``iou_mode=2`` uses DIoU for the pairwise overlap (DIoU-NMS).
    """
    xywhcp = np.asarray(xywhcp)
    classes = xywhcp[..., 5].astype("int")
    kept = []
    for ci in range(class_num):
        grp = xywhcp[classes == ci]
        if len(grp) == 0:
            kept.append(grp.reshape(0, xywhcp.shape[-1]))
            continue
        ious = cal_iou(grp[:, None, :5], grp[None, :, :5], mode=iou_mode)
        conf = grp[:, 4] * grp[:, 6]
        kept.append(grp[_greedy_suppress(grp, ious, conf, nms_threshold)])
    return np.vstack(kept)


def soft_nms(xywhcp, class_num=1, nms_threshold=0.45,
             conf_threshold=0.5, sigma=0.5):
    """Soft-NMS with Gaussian decay (reference tools.py:736-786).

    Every box (even an already-deleted one) decays its not-yet-visited
    overlaps by exp(-iou^2 / sigma); a box whose decayed confidence
    drops below ``conf_threshold`` is removed. Survivors keep their
    original rows.
    """
    xywhcp = np.asarray(xywhcp)
    classes = xywhcp[..., 5].astype("int")
    kept = []
    for ci in range(class_num):
        grp = xywhcp[classes == ci]
        if len(grp) == 0:
            kept.append(grp.reshape(0, xywhcp.shape[-1]))
            continue
        ious = cal_iou(grp[:, None, :5], grp[None, :, :5])
        conf = grp[:, 4] * grp[:, 6]
        order = np.argsort(conf)[::-1]
        conf = conf.copy()
        n = len(grp)
        visited = np.zeros(n, dtype=bool)
        deleted = np.zeros(n, dtype=bool)
        for idx in order:
            visited[idx] = True
            for j in np.where(ious[idx] >= nms_threshold)[0]:
                if not visited[j]:
                    conf[j] *= np.exp(-(ious[idx, j] ** 2) / sigma)
                    if conf[j] < conf_threshold:
                        deleted[j] = True
        kept.append(grp[~deleted])
    return np.vstack(kept)


def apply_nms(xywhcp, class_num, nms_mode, nms_threshold,
              conf_threshold=0.5, nms_sigma=0.5):
    """Dispatch helper for the 0-3 nms_mode convention used across the
    reference facade methods (e.g. tools.py:530-538)."""
    if nms_mode <= 0 or len(xywhcp) == 0:
        return xywhcp
    if nms_mode == 1:
        return nms(xywhcp, class_num, nms_threshold)
    if nms_mode == 2:
        return soft_nms(xywhcp, class_num, nms_threshold,
                        conf_threshold, nms_sigma)
    if nms_mode == 3:
        return nms(xywhcp, class_num, nms_threshold, 2)
    raise ValueError(f"Invalid nms_mode: {nms_mode}")


# ---------------------------------------------------------------------------
# class weighting
# ---------------------------------------------------------------------------

def get_class_weight(label_data, method="alpha"):
    """Per-channel class weights (reference tools.py:592-627).

    Methods: "alpha" (inverse frequency), "log", "effective"
    (class-balanced 1-beta^n), "binary" (pos/neg ratio, used as the
    conf-loss ``binary_weight``).
    """
    label_data = np.asarray(label_data)
    total = int(np.prod(label_data.shape[:-1]))
    counts = label_data.reshape(-1, label_data.shape[-1]).sum(axis=0)

    if method == "effective":
        beta = (total - 1) / total
        eff = 1 - np.power(beta, counts)
        weights = (1 - beta) / eff
    elif method == "binary":
        weights = counts / (total - counts)
    else:
        weights = 1 / counts

    weights = np.array(weights)
    if method == "log":
        weights = np.log(total * weights)
    if method != "binary":
        weights = weights / np.sum(weights) * len(weights)
    return weights


# ---------------------------------------------------------------------------
# visualization
# ---------------------------------------------------------------------------

def vis_img(img,
            *label_datas,
            class_names=[""],
            conf_threshold=0.5,
            show_conf=True,
            nms_mode=0,
            nms_threshold=0.45,
            nms_sigma=0.5,
            version=1,
            figsize=None,
            dpi=None,
            axis="off",
            savefig_path=None,
            fig_ax=None,
            return_fig_ax=False,
            point_radius=5,
            point_color="r",
            box_linewidth=2,
            box_color="auto",
            text_color="w",
            text_padcolor="auto",
            text_fontsize=12):
    """Draw decoded (optionally NMS-ed) boxes on an image with pyplot.

    Parity with reference tools.py:441-589 (same kwargs incl. fig_ax
    chaining and savefig).
    """
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle, Circle, BoxStyle

    class_num = len(class_names)
    if isinstance(point_color, str):
        point_color = [point_color] * class_num
    if box_color == "auto":
        box_color = point_color
    if text_padcolor == "auto":
        text_padcolor = point_color
    if isinstance(box_color, str):
        box_color = [box_color] * class_num
    if isinstance(text_color, str):
        text_color = [text_color] * class_num
    if isinstance(text_padcolor, str):
        text_padcolor = [text_padcolor] * class_num

    img = np.asarray(img)
    xywhcp = decode(*label_datas, class_num=class_num,
                    threshold=conf_threshold, version=version)
    xywhcp = apply_nms(xywhcp, class_num, nms_mode, nms_threshold,
                       conf_threshold, nms_sigma)

    if fig_ax is not None:
        fig, axes = fig_ax
    else:
        fig, axes = plt.subplots(1, figsize=figsize, dpi=dpi)
        axes.imshow(img)
        axes.axis(axis)

    img_h, img_w = img.shape[:2]
    for obj in xywhcp:
        box_x, box_y = obj[0] * img_w, obj[1] * img_h
        box_w, box_h = obj[2] * img_w, obj[3] * img_h
        class_i = int(obj[5])
        label = class_names[class_i]
        point_min = int(box_x - box_w / 2), int(box_y - box_h / 2)

        axes.add_patch(Circle((box_x, box_y), radius=point_radius,
                              color=point_color[class_i]))
        axes.add_patch(Rectangle(point_min, box_w, box_h,
                                 linewidth=box_linewidth,
                                 edgecolor=box_color[class_i],
                                 facecolor="none"))
        text = (f"{label}:{obj[4] * obj[6]:.2f}" if show_conf else label)
        if text_fontsize > 0:
            axes.text(*point_min, text,
                      color=text_color[class_i],
                      bbox={"boxstyle": BoxStyle.Square(pad=0.2),
                            "color": text_padcolor[class_i]},
                      fontsize=text_fontsize)

    if savefig_path is not None:
        fig.savefig(savefig_path, bbox_inches="tight", pad_inches=0)
    if return_fig_ax:
        return fig, axes
    plt.show()


# ---------------------------------------------------------------------------
# annotation export
# ---------------------------------------------------------------------------

def array_to_json(path, img_size, *label_datas,
                  class_names=[""],
                  conf_threshold=0.5,
                  nms_mode=0,
                  nms_threshold=0.45,
                  nms_sigma=0.5,
                  version=3):
    """Export decoded boxes as a labelme-style JSON file.

    Parity with reference tools.py:800-876, including the big5 encoding
    and str(dict)-with-quote-replacement serialization so output files
    are byte-identical.
    """
    class_num = len(class_names)
    xywhcp = decode(*label_datas, class_num=class_num,
                    threshold=conf_threshold, version=version)
    xywhcp = apply_nms(xywhcp, class_num, nms_mode, nms_threshold,
                       conf_threshold, nms_sigma)

    obj_list = []
    for obj in xywhcp:
        # plain Python floats: numpy>=2 scalar reprs would corrupt the
        # str(dict) serialization the reference format uses
        box_x, box_y = float(obj[0] * img_size[1]), float(obj[1] * img_size[0])
        box_w, box_h = float(obj[2] * img_size[1]), float(obj[3] * img_size[0])
        point_min = [box_x - box_w / 2, box_y - box_h / 2]
        point_max = [box_x + box_w / 2, box_y + box_h / 2]
        obj_list.append({"label": class_names[int(obj[5])],
                         "points": [point_min, point_max],
                         "shape_type": "rectangle",
                         "confidence": float(obj[4] * obj[6])})

    data = {"shapes": obj_list,
            "imageHeight": img_size[0],
            "imageWidth": img_size[1]}
    with open(path, "w", encoding="big5") as file:
        file.write(str(data).replace("'", "\""))


def array_to_xml(path, img_size, *label_datas,
                 class_names=[],
                 conf_threshold=0.5,
                 nms_mode=0,
                 nms_threshold=0.45,
                 nms_sigma=0.5,
                 version=3):
    """Export decoded boxes as a labelimg-style XML file.

    Parity with reference tools.py:879-965 (ElementTree structure:
    annotation > object > name/bndbox/confidence).
    """
    class_num = len(class_names)
    xywhcp = decode(*label_datas, class_num=class_num,
                    threshold=conf_threshold, version=version)
    xywhcp = apply_nms(xywhcp, class_num, nms_mode, nms_threshold,
                       conf_threshold, nms_sigma)

    root = ET.Element("annotation")
    for obj in xywhcp:
        box_x, box_y = obj[0] * img_size[1], obj[1] * img_size[0]
        box_w, box_h = obj[2] * img_size[1], obj[3] * img_size[0]

        et_object = ET.SubElement(root, "object")
        ET.SubElement(et_object, "name").text = class_names[int(obj[5])]
        bndbox = ET.SubElement(et_object, "bndbox")
        ET.SubElement(bndbox, "xmin").text = str(int(box_x - box_w / 2))
        ET.SubElement(bndbox, "ymin").text = str(int(box_y - box_h / 2))
        ET.SubElement(bndbox, "xmax").text = str(int(box_x + box_w / 2))
        ET.SubElement(bndbox, "ymax").text = str(int(box_y + box_h / 2))
        ET.SubElement(et_object, "confidence").text = str(obj[4] * obj[6])

    with open(path, "wb") as file:
        ET.ElementTree(root).write(file)


def create_score_mat(*args, **kwargs):
    """Moved: import it from ``tf2_yolo_tpu_torch.utils.measurement``
    (the reference keeps this shim in ``utils/tools.py``)."""
    raise ImportError(
        "The location of this function has been changed. Import it using "
        "`from tf2_yolo_tpu_torch.utils.measurement import "
        "create_score_mat`")


# The reference exposes the dataset reader from utils.tools
# (reference utils/tools.py:71 `class YoloDataSequence`); keep that
# import path working.
from ..data.dataset import YoloDataSequence  # noqa: E402,F401
