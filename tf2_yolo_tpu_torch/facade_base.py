"""Shared facade machinery of the ``Yolo`` classes.

Port of tf2_yolo_tpu/facade_base.py: dataset/sequence readers, vis_img,
metric-spec parsing ("obj+iou+recall0.6"), the multi-level label pyramid
of v3/v4, and pretrained-weight resolution from a local weight cache (no
downloads). Weight files are the port's own ``torch.save`` files
(``Model.save_weights``, ``convert.convert_to_cache``). The v1.5, v2, v3
and v4 facades are ported, their serving artifact (``export_model``)
and the reference h5 export (``export_reference_h5``) included.
"""

import functools
import os
import warnings

from .data import YoloDataSequence
from .ops import metrics as _metrics_mod
from .utils import tools


class MetricKind:
    """Names of metric kinds (reference yolov1_5/__init__.py:21-27)."""
    obj_acc = "obj_acc"
    mean_iou = "mean_iou"
    class_acc = "class_acc"
    recall = "recall"


def weights_cache_dir():
    return os.environ.get(
        "TF2_YOLO_TPU_TORCH_WEIGHTS",
        os.path.join(os.path.expanduser("~"), ".tf2_yolo_tpu_torch",
                     "weights"))


def resolve_pretrained(name, kind):
    """Map a named pretrained set ("ms_coco", "pascal_voc", "imagenet")
    to a local file of the port's format (``{kind}_{name}.pt`` under
    :func:`weights_cache_dir`), or None with a warning if unavailable;
    a path to an existing file is returned as it is."""
    if name is None:
        return None
    if os.path.isfile(name):
        return name
    candidate = os.path.join(weights_cache_dir(), f"{kind}_{name}.pt")
    if os.path.isfile(candidate):
        return candidate
    warnings.warn(
        f"Pretrained weights '{name}' for {kind} not found at "
        f"{candidate}; using random initialization. Place converted "
        "weights there to enable them.")
    return None


def graft_backbone_file(model, path):
    """Graft ONLY the backbone from a weight file of the port
    (``Model.save_weights``, ``convert.convert_to_cache``: a
    ``state_dict``) into ``model`` (an ``engine.Model``), parameters and
    BatchNorm statistics, shapes checked. The file may hold a whole
    network (its ``backbone.*`` entries are taken) or a bare backbone."""
    import torch

    from .bridge import to_flax
    from .convert import merge_into_variables

    restored = to_flax(torch.load(path, map_location="cpu",
                                  weights_only=True))
    params, stats = restored["params"], restored["batch_stats"]
    src = params.get("backbone", params)
    sstats = stats.get("backbone", stats)
    model.set_variables(merge_into_variables(
        model.variables, {"backbone": src},
        {"backbone": sstats} if sstats else {}))


def graft_backbone_params(model, src):
    """Copy a backbone's parameters into ``model`` (an ``engine.Model``),
    as the JAX v1.5-v3 facades graft ``pretrained_body`` /
    ``pretrained_backbone``: ``src`` is a Model or a ``{name: tensor}``
    dict, either of a whole network (its ``backbone.*`` entries are
    taken) or of a bare backbone. BatchNorm statistics are not copied
    (the JAX facades graft ``params`` only)."""
    from .engine import Model

    src = src.params if isinstance(src, Model) else src
    if any(k.startswith("backbone.") for k in src):
        body = {k: v for k, v in src.items() if k.startswith("backbone.")}
    else:
        body = {"backbone." + k: v for k, v in src.items()}
    model.params = {k: (v.detach().cpu() if hasattr(v, "detach") else v)
                    for k, v in body.items()}


def make_version_aliases(version):
    """Per-version module aliases mirroring the reference's
    yolovN.losses / yolovN.metrics import surface (versions 1-4)."""
    from .ops import losses

    loss = {1: losses.wrap_yolo_loss_v1, 2: losses.wrap_yolo_loss_v2,
            3: losses.wrap_yolo_loss_v3,
            4: losses.wrap_yolo_loss_v4}[version]
    return {
        "wrap_yolo_loss": loss,
        "wrap_obj_acc": functools.partial(
            _metrics_mod.wrap_obj_acc, version=version),
        "wrap_mean_iou": functools.partial(
            _metrics_mod.wrap_mean_iou, version=version),
        "wrap_class_acc": functools.partial(
            _metrics_mod.wrap_class_acc, version=version),
        "wrap_recall": functools.partial(
            _metrics_mod.wrap_recall, version=version),
    }


class _LabelPyramidSequence:
    """Wrap a YoloDataSequence to emit the FPN label pyramid lazily,
    coarsest level first (reference yolov3/__init__.py:41-53)."""

    def __init__(self, seq, num_levels):
        self.seq = seq
        self.num_levels = num_levels

    # the feed-contract attributes, so that engine.fit can cross-check
    # uint8 sequences against the model's input_rescale
    @property
    def uint8(self):
        return self.seq.uint8

    @property
    def rescale(self):
        return self.seq.rescale

    def __len__(self):
        return len(self.seq)

    def __getitem__(self, idx):
        img, label = self.seq[idx]
        labels = [label]
        for _ in range(self.num_levels - 1):
            label = tools.down2xlabel(label)
            labels.insert(0, label)
        return img, labels

    def as_iterator(self, prefetch=2):
        from .data.pipeline import threaded_prefetch

        yield from threaded_prefetch(
            lambda: (self[i] for i in range(len(self))), prefetch)


class YoloBase:
    """Common facade: construction params, readers, vis, metric spec."""

    version = None          # 1 (v1.5), 2, 3 or 4
    stride = 32             # output stride of the coarsest level
    num_levels = 1          # FPN/PAN levels

    def __init__(self, input_shape, class_names):
        self.input_shape = tuple(input_shape)
        self.grid_shape = (input_shape[0] // self.stride,
                           input_shape[1] // self.stride)
        self.class_names = list(class_names)
        self.class_num = len(self.class_names)
        self.model = None
        self.file_names = None

    @property
    def _bbox_num(self):
        raise NotImplementedError

    # ------------------------------------------------------------------
    def _finest_grid(self):
        amp = 2 ** (self.num_levels - 1)
        return (self.grid_shape[0] * amp, self.grid_shape[1] * amp)

    def read_file_to_dataset(
            self, img_path=None, label_path=None,
            label_format="labelimg", rescale=1 / 255,
            preprocessing=None, shuffle=True, seed=None,
            encoding="big5", thread_num=10, reader="PIL"):
        """Read a whole annotation folder into ndarrays.

        Returns (img, label) for single-level versions, or
        (img, [label_coarse, ..., label_fine]) for v3/v4
        (reference yolov3/__init__.py:183-249). ``reader``: "PIL"
        (default), "cv" or "native" (the C++ loader,
        ``tf2_yolo_tpu_torch.native``, built at first use).
        """
        seq = YoloDataSequence(
            img_path=img_path, label_path=label_path,
            label_format=label_format, size=self.input_shape[:2],
            rescale=rescale, preprocessing=preprocessing,
            grid_shape=self._finest_grid(),
            class_names=self.class_names, shuffle=shuffle, seed=seed,
            encoding=encoding, thread_num=thread_num, reader=reader,
            show_progress=True)
        self.file_names = seq.path_list
        seq.batch_size = max(len(seq.path_list), 1)
        img, label = seq[0]

        if self.num_levels == 1:
            return img, label
        labels = [label]
        for _ in range(self.num_levels - 1):
            label = tools.down2xlabel(label)
            labels.insert(0, label)
        return img, labels

    def read_file_to_sequence(
            self, img_path=None, label_path=None, batch_size=20,
            label_format="labelimg", rescale=1 / 255,
            preprocessing=None, augmenter=None, shuffle=True,
            seed=None, encoding="big5", thread_num=1, reader="PIL",
            uint8=False):
        """Lazy batched reader; v3/v4 emit the label pyramid per batch.
        ``uint8=True`` emits raw uint8 image batches that the engine
        normalizes on the device (a quarter of the f32 feed traffic —
        see ``engine.Model`` ``input_rescale``)."""
        seq = YoloDataSequence(
            img_path=img_path, label_path=label_path,
            batch_size=batch_size, label_format=label_format,
            size=self.input_shape[:2], rescale=rescale,
            preprocessing=preprocessing,
            grid_shape=self._finest_grid(),
            class_names=self.class_names, augmenter=augmenter,
            shuffle=shuffle, seed=seed, encoding=encoding,
            thread_num=thread_num, reader=reader, uint8=uint8)
        self.file_names = seq.path_list
        if self.num_levels == 1:
            return seq
        return _LabelPyramidSequence(seq, self.num_levels)

    # ------------------------------------------------------------------
    def vis_img(self, img, *label_datas, conf_threshold=0.5,
                show_conf=True, nms_mode=0, nms_threshold=0.5,
                nms_sigma=0.5, **kwargs):
        """Visualize grid label(s)/prediction(s) on an image."""
        return tools.vis_img(
            img, *label_datas, class_names=self.class_names,
            conf_threshold=conf_threshold, show_conf=show_conf,
            nms_mode=nms_mode, nms_threshold=nms_threshold,
            nms_sigma=nms_sigma, version=self.version, **kwargs)

    # ------------------------------------------------------------------
    def export_reference_h5(self, path):
        """Save the current weights as a keras h5 file the REFERENCE
        builders load — the inverse of ``pretrained_weights``
        conversion, so a model trained here deploys with the
        reference/TF tooling. v3/v4 write the reference's structural
        layer names (load with ``ref_model.load_weights(path,
        by_name=True)``); v1/v2 write positional conv2d_N names valid
        for the first reference model built in a fresh process (see
        ``convert.export_reference_weights``). Darknet-family backbones
        only. Needs ``h5py``.

        Returns the written {layer: {weight: array}} dict."""
        if self.model is None:
            raise ValueError("create_model() first")
        from .convert import export_reference_h5 as _export
        kw = ({"bbox_num": self._bbox_num} if self.version == 1
              else {"abox_num": self._bbox_num})
        return _export(self.model.variables, self.version,
                       self.class_num, path, **kw)

    def export_model(self, path, batch_size=1, threshold=0.5,
                     nms_mode=1, nms_threshold=0.45, nms_sigma=0.5,
                     max_boxes=128, fold_bn=True, platforms=None,
                     int8_calibration=None, int8_min_channels=256):
        """Export a fixed-shape serving artifact (forward + decode +
        NMS, weights inside, BatchNorm folded) with ``torch.export``, on
        the model's device.

        The artifact is reloaded with
        ``tf2_yolo_tpu_torch.export.load_serving(path)`` and called on
        (batch, H, W, 3) f32 images; no model-building code runs.
        ``batch_size`` may be a list of bucket sizes shipped in one file;
        the loaded model dispatches per call. ``.meta`` holds the class
        names, thresholds and shapes.

        ``int8_calibration``: sample image batches; when given, static
        per-layer int8 scales are calibrated on them
        (``export.calibrate_int8``) and the artifact serves every
        calibrated ConvBN with min(Ci, Co) >= ``int8_min_channels``
        through the int8 kernel; BN folding is skipped, since its
        epilogue already carries BN. ``platforms`` is the JAX package's
        lowering list: only ``None`` is taken."""
        from .export import calibrate_int8, save_serving

        if self.model is None:
            raise ValueError("Call create_model() before export_model()")
        module = self.model.module
        serving = dict(threshold=threshold, nms_mode=nms_mode,
                       nms_threshold=nms_threshold, nms_sigma=nms_sigma,
                       max_boxes=max_boxes)
        if int8_calibration is not None:
            serving.update(quant=calibrate_int8(module, int8_calibration),
                           int8_min_channels=int8_min_channels)
            fold_bn = False
        return save_serving(
            path, module, input_shape=self.input_shape,
            batch_size=batch_size, class_num=self.class_num,
            version=self.version, class_names=self.class_names,
            fold_bn=fold_bn, platforms=platforms, **serving)

    # ------------------------------------------------------------------
    @staticmethod
    def _parse_recall_threshold(kind):
        thr = kind[kind.find("recall") + 6:]
        end = thr.rfind("+")
        thr = thr[:end if end >= 0 else None]
        return float(thr) if thr else 0.5

    def metrics(self, kind="obj_acc"):
        """Build metric closures from a spec string like
        "obj+iou+recall0.6". Returns a flat list (v1/v2) or a
        list-of-lists per output level (v3/v4), matching the reference
        return conventions."""
        per_level = []
        for level in range(self.num_levels):
            amp = 2 ** level
            grid_shape = (self.grid_shape[0] * amp,
                          self.grid_shape[1] * amp)
            fns = []
            if "obj" in kind:
                fns.append(_metrics_mod.wrap_obj_acc(
                    grid_shape, self._bbox_num, self.class_num,
                    version=self.version))
            if "iou" in kind:
                fns.append(_metrics_mod.wrap_mean_iou(
                    grid_shape, self._bbox_num, self.class_num,
                    version=self.version))
            if "class" in kind:
                fns.append(_metrics_mod.wrap_class_acc(
                    grid_shape, self._bbox_num, self.class_num,
                    version=self.version))
            if "recall" in kind:
                fns.append(_metrics_mod.wrap_recall(
                    grid_shape, self._bbox_num, self.class_num,
                    iou_threshold=self._parse_recall_threshold(kind),
                    version=self.version))
            per_level.append(fns)
        if self.num_levels == 1:
            return per_level[0]
        return per_level
