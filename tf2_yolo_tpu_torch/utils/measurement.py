"""Offline evaluation: precision/recall/F1 score matrix and PR-curve /
mAP.

Port of tf2_yolo_tpu/utils/measurement.py, with its pandas artifacts and
numeric conventions:
  - per-image decode (GT at threshold 0.5, predictions at
    ``conf_threshold``) and optional NMS;
  - class-wise IoU matching, TPP vs TP (unique matched GT) counting,
    three precision modes;
  - ``PRfunc`` gathers (joint_conf, matched_gt_id, hit) rows with a
    ``max_per_img`` cap, then sweeps a running precision/recall curve;
  - ``get_map`` modes voc2007 / voc2012 / area / smootharea.

``device=False`` runs the host path (NumPy, the port's ``utils.tools``).
Any other ``device`` runs decode, NMS and matching as batched tensor ops
in chunks of 64 images: ``True`` on the card (the NMS kernels of
``ops/kernels/nms.py``; it raises without a GPU), or a torch device or
its name, ``"cpu"`` taking the plain versions. Predictions may be NumPy
arrays, as ``Model.predict`` returns them, or tensors, which are not
copied when they already lie on that device. pandas and matplotlib are
imported where they are used.
"""

import warnings

import numpy as np
import torch

from .tools import apply_nms, cal_iou, decode

DEVICE_CHUNK = 64                  # images decoded and matched at once


def _eval_device(device):
    """None for the host path, else the torch device of the device path:
    ``True`` is the card, and raises where there is none."""
    if device is False or device is None:
        return None
    if device is True:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=True evaluates on the GPU, and CUDA is not "
                "available: pass device=False (host) or device='cpu'")
        return torch.device("cuda")
    return torch.device(device)


def _as_tensor(x, device):
    """``x`` (NumPy or tensor) on ``device``, f32; a tensor already there
    is not copied."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _decode_pair(y_true, y_pred_list, class_num, conf_threshold,
                 nms_mode, nms_threshold, nms_sigma, version):
    """Decode one image's GT + predictions, NMS on predictions."""
    xywhcp_true = decode(y_true, class_num=class_num, version=version)
    xywhcp_pred = decode(*y_pred_list, class_num=class_num,
                         threshold=conf_threshold, version=version)
    xywhcp_pred = apply_nms(xywhcp_pred, class_num, nms_mode,
                            nms_threshold, conf_threshold, nms_sigma)
    return xywhcp_true, xywhcp_pred


def _device_chunks(y_trues, y_preds, class_num, conf_threshold,
                   nms_mode, nms_threshold, nms_sigma, version,
                   max_boxes, chunk, device):
    """Yield padded decoded+NMSed tensors per image chunk on ``device``:
    ``(lo, t_rows, t_valid, p_rows, p_valid)``, the shared front end of
    the device evaluation paths. Emits the saturation warning after the
    last chunk."""
    from ..ops.decode import decode_multi_level
    from ..ops.nms import apply_nms_device

    n = len(y_trues)
    saturated = torch.zeros((), dtype=torch.int64, device=device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        t_rows, t_valid = decode_multi_level(
            [_as_tensor(y_trues[lo:hi], device)], class_num=class_num,
            threshold=0.5, max_boxes=max_boxes, version=version)
        p_rows, p_valid = decode_multi_level(
            [_as_tensor(p[lo:hi], device) for p in y_preds],
            class_num=class_num, threshold=conf_threshold,
            max_boxes=max_boxes, version=version)
        saturated += (p_valid.sum(dim=1) >= max_boxes).sum()
        if nms_mode > 0:
            p_rows, p_valid = apply_nms_device(
                p_rows, p_valid, nms_mode=nms_mode,
                nms_threshold=nms_threshold,
                conf_threshold=conf_threshold, nms_sigma=nms_sigma)
        yield lo, t_rows, t_valid, p_rows, p_valid

    saturated = int(saturated)              # one read of the device
    if saturated:
        warnings.warn(
            f"device eval: {saturated} image(s) hit the max_boxes="
            f"{max_boxes} pre-NMS cap; results keep only their top-k "
            "candidates by joint confidence (raise max_boxes or the "
            "conf_threshold for exact host-path parity)")


def decode_batch_device(y_trues, y_preds, class_num, conf_threshold,
                        nms_mode, nms_threshold, nms_sigma, version,
                        max_boxes=256, chunk=DEVICE_CHUNK, device=True):
    """Device path of evaluation: decode (+ NMS) in batched chunks on
    ``device`` (see the module docstring), then per-image NumPy rows.

    ``chunk`` bounds device memory (the lattices are per chunk, not for
    the whole dataset). ``max_boxes`` caps pre-NMS candidates per image;
    unlike the unbounded host path, an image that saturates the cap is
    cut to its top-k by joint confidence, and a warning says so.

    Returns:
        (true_rows_list, pred_rows_list): per-image (N_i, 7) arrays.
    """
    dev = _eval_device(device)
    if dev is None:
        raise ValueError("decode_batch_device needs a device, not False")
    t_all, p_all = [], []
    for _, t_rows, t_valid, p_rows, p_valid in _device_chunks(
            y_trues, y_preds, class_num, conf_threshold, nms_mode,
            nms_threshold, nms_sigma, version, max_boxes, chunk, dev):
        t_all.append((t_rows, t_valid))
        p_all.append((p_rows, p_valid))
    trues, preds = [], []
    for parts, out in ((t_all, trues), (p_all, preds)):
        for rows, valid in parts:
            rows, valid = rows.cpu().numpy(), valid.cpu().numpy()
            out.extend(rows[i][valid[i]] for i in range(len(rows)))
    return trues, preds


def _split_rows(xywhcp):
    """(rows, class_idx array) with empty-safe class extraction."""
    if len(xywhcp) > 0:
        return xywhcp, xywhcp[..., 5].astype("int")
    return xywhcp, np.array([], dtype=int)


def create_score_mat(y_trues, *y_preds,
                     class_names=[],
                     conf_threshold=0.5,
                     nms_mode=0,
                     nms_threshold=0.5,
                     nms_sigma=0.5,
                     iou_threshold=0.5,
                     precision_mode=2,
                     version=3,
                     device=False,
                     device_max_boxes=256):
    """Precision/recall/F1/gts/dets table per class.

    precision modes:
        0: TPP/PP   1: TP/(PP-(TPP-TP))   2: TP/PP

    ``device`` other than False runs decode, NMS and IoU matching for all
    images as batched tensor ops (``ops/evalmatch.py``) instead of
    per-image host loops; the host then only sums (image, class) count
    matrices.
    """
    import pandas as pd

    class_num = len(class_names)
    pp_p = np.zeros((class_num, 2))        # [pred positives, positives]
    tp = np.zeros((class_num, 2))          # [tpp, tp]
    det_counts = np.zeros((class_num,), dtype="int")

    dev = _eval_device(device)
    if dev is not None:
        from ..ops.evalmatch import match_counts

        keys = ("n_true", "n_pred", "tpp", "tp")
        sums = {k: torch.zeros(class_num, dtype=torch.int64, device=dev)
                for k in keys}
        for _, t_rows, t_valid, p_rows, p_valid in _device_chunks(
                y_trues, y_preds, class_num, conf_threshold, nms_mode,
                nms_threshold, nms_sigma, version, device_max_boxes,
                DEVICE_CHUNK, dev):
            got = match_counts(t_rows, t_valid, p_rows, p_valid,
                               class_num, iou_threshold)
            for k in keys:
                sums[k] += got[k].sum(dim=0)
        sums = {k: v.cpu().numpy() for k, v in sums.items()}
        pp_p[:, 0] = sums["n_pred"]
        pp_p[:, 1] = sums["n_true"]
        det_counts[:] = sums["n_pred"]
        # the per-image mode-1 correction and the TPP->TP collapse are
        # linear in the per-image counts, so the summed matrices give
        # the same table as the host's per-image accumulation
        if precision_mode == 1:
            pp_p[:, 0] -= sums["tpp"] - sums["tp"]
        tp[:, 0] = sums["tp"] if precision_mode > 0 else sums["tpp"]
        tp[:, 1] = sums["tp"]

    for i_img in (() if dev is not None else range(len(y_trues))):
        pred_list = [y_preds[j][i_img]
                     for j in range(len(y_preds))]
        true_rows, pred_rows = _decode_pair(
            y_trues[i_img], pred_list, class_num, conf_threshold,
            nms_mode, nms_threshold, nms_sigma, version)
        true_rows, true_cls = _split_rows(true_rows)
        pred_rows, pred_cls = _split_rows(pred_rows)

        for ci in range(class_num):
            t = true_rows[true_cls == ci][..., :5] \
                if len(true_rows) else np.zeros((0, 5))
            p = pred_rows[pred_cls == ci][..., :5] \
                if len(pred_rows) else np.zeros((0, 5))
            pp_p[ci] += (len(p), len(t))
            det_counts[ci] += len(p)
            if len(t) == 0 or len(p) == 0:
                continue
            ious = cal_iou(t.reshape(-1, 1, 5), p.reshape(1, -1, 5))
            best_iou = ious.max(axis=0)
            best_gt = ious.argmax(axis=0)
            hit = best_iou >= iou_threshold
            num_tpp = int(hit.sum())
            num_tp = len(set(best_gt[hit]))
            if precision_mode == 1:
                pp_p[ci, 0] -= (num_tpp - num_tp)
            if precision_mode > 0:
                num_tpp = num_tp
            tp[ci] += (num_tpp, num_tp)

    with np.errstate(divide="ignore", invalid="ignore"):
        table = np.true_divide(tp, pp_p)
    score_table = pd.DataFrame(table, columns=["precision", "recall"])
    prec, rec = score_table["precision"], score_table["recall"]
    score_table["F1-score"] = 2 * prec * rec / (prec + rec)
    score_table["gts"] = pp_p[:, 1].astype("int")
    score_table["dets"] = det_counts
    score_table.index = class_names
    return score_table


class PRfunc:
    """Callable precision-at-recall built from a detection sweep.

    Call with (recall, class_idx) -> precision. Also provides
    ``plot_pr_curve`` and ``get_map``. ``device`` as in
    :func:`create_score_mat`.
    """

    def __init__(self, y_trues, *y_preds,
                 class_names=[],
                 conf_threshold=0.05,
                 nms_mode=1,
                 nms_threshold=0.5,
                 nms_sigma=0.5,
                 iou_threshold=0.5,
                 precision_mode=2,
                 max_per_img=100,
                 version=3,
                 device=False,
                 device_max_boxes=256):
        class_num = len(class_names)
        self.class_num = class_num
        self.class_names = list(class_names)

        dev = _eval_device(device)
        if dev is not None:
            gts, detections = self._collect_device(
                y_trues, y_preds, class_num, conf_threshold, nms_mode,
                nms_threshold, nms_sigma, iou_threshold, max_per_img,
                version, device_max_boxes, dev)
        else:
            gts, detections = self._collect_host(
                y_trues, y_preds, class_num, conf_threshold, nms_mode,
                nms_threshold, nms_sigma, iou_threshold, max_per_img,
                version)

        # running precision/recall sweep, terminal point appended,
        # vectorized over the sorted detections (the cumulative counts
        # give the reference's per-detection loop exactly)
        self.precisions, self.recalls = [], []
        for ci in range(class_num):
            p, r = self._pr_sweep(detections[ci], gts[ci],
                                  precision_mode)
            self.precisions.append(p)
            self.recalls.append(r)

    @staticmethod
    def _collect_host(y_trues, y_preds, class_num, conf_threshold,
                      nms_mode, nms_threshold, nms_sigma,
                      iou_threshold, max_per_img, version):
        """Per-image host decode + match: (gts, per-class
        (conf, gt_id, hit) detection rows)."""
        gts = [0] * class_num
        detections = [np.empty((0, 3), dtype="float32")
                      for _ in range(class_num)]

        for i_img in range(len(y_trues)):
            pred_list = [y_preds[j][i_img]
                         for j in range(len(y_preds))]
            true_rows, pred_rows = _decode_pair(
                y_trues[i_img], pred_list, class_num,
                conf_threshold, nms_mode, nms_threshold,
                nms_sigma, version)
            true_rows, true_cls = _split_rows(true_rows)
            pred_rows, pred_cls = _split_rows(pred_rows)

            for ci in range(class_num):
                t = true_rows[true_cls == ci][..., :5] \
                    if len(true_rows) else np.zeros((0, 5))
                sel = pred_cls == ci
                p = pred_rows[sel][..., :5] \
                    if len(pred_rows) else np.zeros((0, 5))
                gt_base = gts[ci]
                gts[ci] = gt_base + len(t)
                if len(p) == 0:
                    continue

                joint_conf = p[:, 4] * pred_rows[sel][:, 6]
                if len(t) > 0:
                    ious = cal_iou(t.reshape(-1, 1, 5),
                                   p.reshape(1, -1, 5))
                    hit = (ious.max(axis=0)
                           >= iou_threshold).astype("float32")
                    gt_id = ious.argmax(axis=0) + gt_base
                else:
                    hit = np.zeros((len(p),), dtype="float32")
                    gt_id = hit
                rows = np.stack((joint_conf, gt_id, hit), axis=1)
                if max_per_img is not None and len(rows) > max_per_img:
                    order = np.argsort(rows[:, 0])[::-1]
                    rows = rows[order][:max_per_img]
                detections[ci] = np.vstack((detections[ci], rows))
        return gts, detections

    @staticmethod
    def _collect_device(y_trues, y_preds, class_num, conf_threshold,
                        nms_mode, nms_threshold, nms_sigma,
                        iou_threshold, max_per_img, version,
                        device_max_boxes, device):
        """Batched decode + NMS + matching on ``device``
        (ops/evalmatch.py), one read of the device at the end, then
        vectorized NumPy grouping with no per-image Python. GT ids are
        unique per (image, padded row), which is uniqueness-equivalent
        to the host path's per-class running ids, so the PR sweep is
        unchanged."""
        from ..ops.evalmatch import match_pred_arrays

        gts = torch.zeros(class_num, dtype=torch.int64, device=device)
        cols = []                      # (conf, cls, hit, gt_id, img)
        for lo, t_rows, t_valid, p_rows, p_valid in _device_chunks(
                y_trues, y_preds, class_num, conf_threshold, nms_mode,
                nms_threshold, nms_sigma, version, device_max_boxes,
                DEVICE_CHUNK, device):
            got = match_pred_arrays(t_rows, t_valid, p_rows, p_valid,
                                    iou_threshold)
            t_cls = t_rows[..., 5].long()[t_valid]
            gts += torch.bincount(t_cls, minlength=class_num)[:class_num]

            valid = got["valid"]
            n_img, n_box = valid.shape
            img = (lo + torch.arange(n_img, device=device))[:, None] \
                .expand(n_img, n_box)
            gt_id = img * t_rows.shape[1] + got["best_gt"]
            cols.append(torch.stack([
                got["joint_conf"].double()[valid],
                got["cls"].double()[valid],
                got["hit"].double()[valid],
                gt_id.double()[valid],
                img.double()[valid],
            ], dim=1))

        flat = (torch.cat(cols).cpu().numpy() if cols
                else np.zeros((0, 5), np.float64))
        gts = gts.cpu().numpy()
        if max_per_img is not None and len(flat):
            # per-(image, class) top-max_per_img by joint confidence:
            # group rows by (img, cls), rank within group, keep top-k.
            # Ties on exactly equal confidences go to the LATER original
            # row first (descending index key): the host path ranks with
            # argsort(conf)[::-1], whose reversal keeps the last of
            # equals; without this key a stable lexsort keeps the first
            # and the kept set at the cap can differ from the host's.
            order = np.lexsort((-np.arange(len(flat)),
                                -flat[:, 0], flat[:, 1], flat[:, 4]))
            flat = flat[order]
            n = len(flat)
            newg = np.ones(n, bool)
            newg[1:] = ((flat[1:, 4] != flat[:-1, 4])
                        | (flat[1:, 1] != flat[:-1, 1]))
            gstart = np.maximum.accumulate(
                np.where(newg, np.arange(n), 0))
            flat = flat[np.arange(n) - gstart < max_per_img]
        detections = [flat[flat[:, 1] == ci][:, [0, 3, 2]]
                      for ci in range(class_num)]
        return list(gts), detections

    @staticmethod
    def _pr_sweep(rows, num_gts, precision_mode):
        """Vectorized running precision/recall over conf-sorted
        detection rows (conf, gt_id, hit); appends the terminal
        (0, last-recall) point like the reference."""
        order = np.argsort(rows[:, 0])[::-1]
        rows = rows[order]
        k = len(rows)
        hit = rows[:, 2] > 0
        dets = np.arange(1, k + 1, dtype=np.int64)
        num_tpp = np.cumsum(hit.astype(np.int64))
        # first-in-sweep occurrence of each matched GT -> unique TP
        new = np.zeros(k, dtype=bool)
        h_idx = np.nonzero(hit)[0]
        if len(h_idx):
            _, first = np.unique(rows[h_idx, 1], return_index=True)
            new[h_idx[first]] = True
        num_tp = np.cumsum(new.astype(np.int64))
        fp = dets - num_tpp
        if precision_mode == 0:
            precisions = num_tpp / dets
        elif precision_mode == 1:
            # num_tp + fp >= 1 whenever k >= 1 (first hit is unique)
            precisions = num_tp / (num_tp + fp)
        else:
            precisions = num_tp / dets
        recalls = (num_tp / num_gts if num_gts
                   else np.zeros(k, dtype=np.float64))
        precisions = np.append(precisions, 0)
        recalls = np.append(recalls, recalls[-1] if k else 0.0)
        return precisions, recalls

    # ------------------------------------------------------------------
    def __call__(self, recall, class_idx=0):
        if class_idx >= self.class_num:
            raise IndexError("Class index out of range")
        precisions = self.precisions[class_idx]
        recalls = self.recalls[class_idx]
        n_above = int((recalls > recall).sum())
        if n_above == 0:
            return 0
        return precisions[-n_above:].max()

    @staticmethod
    def _interpolate(precision):
        """Monotone non-increasing envelope from the right."""
        out = precision.copy()
        running_max = 0
        for i in range(len(out) - 1, -1, -1):
            if out[i] > running_max:
                running_max = out[i]
            else:
                out[i] = running_max
        return out

    def plot_pr_curve(self, class_idx=-1, smooth=False,
                      figsize=None, return_fig=False):
        """Plot PR curve(s); ``smooth`` uses interpolated precision."""
        import matplotlib.pyplot as plt

        if class_idx >= self.class_num:
            raise IndexError("Class index out of range")
        sel = (slice(class_idx, class_idx + 1) if class_idx >= 0
               else slice(None))
        fig = plt.figure(figsize=figsize)
        for precision, recall in zip(self.precisions[sel],
                                     self.recalls[sel]):
            if smooth:
                precision = self._interpolate(precision)
            plt.plot(recall, precision)
        plt.legend(self.class_names[sel])
        plt.title("PR curve")
        plt.xlabel("recall")
        plt.ylabel("precision")
        plt.xlim(-0.05, 1.05)
        plt.ylim(-0.05, 1.05)
        if return_fig:
            return fig
        plt.show()

    def get_map(self, mode="voc2012"):
        """AP table: voc2007 (11-pt), voc2012 (7-pt), area, smootharea."""
        import pandas as pd

        aps = [0.0] * self.class_num
        if mode in ("area", "smootharea"):
            for ci in range(self.class_num):
                precisions = self.precisions[ci]
                if mode == "smootharea":
                    precisions = self._interpolate(precisions)
                recalls = self.recalls[ci]
                # trapezoid integral over the recorded sweep
                for k in range(len(precisions) - 1):
                    delta = recalls[k + 1] - recalls[k]
                    mid = (precisions[k + 1] + precisions[k]) / 2
                    aps[ci] += delta * mid
        else:
            if mode == "voc2012":
                recall_pts = [0, 0.14, 0.29, 0.43, 0.57, 0.71, 1]
            elif mode == "voc2007":
                recall_pts = [i / 10 for i in range(11)]
            else:
                raise ValueError(f"Invalid mode: {mode}")
            for ci in range(self.class_num):
                aps[ci] = sum(self(r, ci) for r in recall_pts) \
                    / len(recall_pts)

        aps.append(sum(aps) / len(aps))
        table = pd.DataFrame(aps, columns=["ap"])
        table.index = list(self.class_names) + ["mAP"]
        return table


class PR_func(PRfunc):
    """Deprecated alias of :class:`PRfunc`."""

    def __init__(self, *args, **kwargs):
        warnings.warn(
            "`PR_func` is deprecated and renamed to `PRfunc`.", Warning)
        super().__init__(*args, **kwargs)
