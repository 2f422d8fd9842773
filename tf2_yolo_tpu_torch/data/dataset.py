"""Dataset reading + anchor-grid label encoding.

Port of tf2_yolo_tpu/data/dataset.py, numpy as there. ``reader="native"``
is the port's copy of the C++ loader (``tf2_yolo_tpu_torch.native``),
built at first use; where it cannot be built it raises with the build
error. ``shard``'s default index is the ``torch.distributed`` rank.

Behavioral parity with the reference ``YoloDataSequence``
(utils/tools.py:71-339): same constructor surface, file discovery,
seeded shuffle, threaded batch reads, per-image preprocessing hook,
augmenter hook, rescale, and the grid label codec quirks:
  - cell index = floor(center / cell_size); boxes whose index exceeds
    the grid are dropped (tools.py:199), negative indices wrap like
    NumPy indexing;
  - two boxes in one cell: xywh last-write-wins, class one-hot bits
    accumulate (tools.py:200-209).

Differences by design:
  - no keras ``Sequence`` base class — plain ``__len__/__getitem__``
    iterable feeding the train step;
  - the augmenter hook is the (image, boxes)->(image, boxes) contract
    from ``tf2_yolo_tpu_torch.data.augment`` instead of imgaug;
  - ``as_iterator`` provides an epoch iterator with background
    prefetch for overlap with the device step.
"""

import os
import threading
import warnings
from math import ceil

import numpy as np

from .parsers import parse_labelimg, parse_labelme


def encode_to_grid(boxes, labels, img_size, grid_shape, class_num,
                   out=None):
    """Encode pixel-space xyxy boxes into one grid label tensor.

    Args:
        boxes: (N, 4) xyxy floats in resized-image pixels.
        labels: length-N class indices.
        img_size: (height, width) of the resized image.
        grid_shape: (grid_h, grid_w).
        class_num: number of classes.
        out: optional (grid_h, grid_w, 5+C) array to fill in place.

    Returns:
        (grid_h, grid_w, 5 + class_num) float array.
    """
    gh, gw = grid_shape
    img_h, img_w = img_size
    cell_h, cell_w = img_h / gh, img_w / gw
    if out is None:
        out = np.zeros((gh, gw, 5 + class_num))

    for i in range(len(boxes)):
        x1, y1, x2, y2 = boxes[i]
        cx, cy = x1 + (x2 - x1) / 2, y1 + (y2 - y1) / 2
        bw, bh = x2 - x1, y2 - y1
        x_i = int(cx // cell_w)
        y_i = int(cy // cell_h)
        if x_i < gw and y_i < gh:
            out[y_i, x_i, 0] = (cx % cell_w) / cell_w
            out[y_i, x_i, 1] = (cy % cell_h) / cell_h
            out[y_i, x_i, 2] = bw / img_w
            out[y_i, x_i, 3] = bh / img_h
            out[y_i, x_i, 4] = 1
            out[y_i, x_i, 5 + labels[i]] = 1
    return out


class YoloDataSequence:
    """Threaded reader of labelimg/labelme folders into
    (images, grid_labels) batches.

    Args mirror the reference (utils/tools.py:76-127); ``augmenter``
    takes the (image, boxes)->(image, boxes) contract.
    """

    def __init__(self, img_path=None,
                 label_path=None,
                 reader="PIL",
                 batch_size=20,
                 label_format="labelimg",
                 size=(448, 448),
                 rescale=1 / 255,
                 preprocessing=None,
                 grid_shape=(7, 7),
                 class_names=[""],
                 augmenter=None,
                 shuffle=True,
                 seed=None,
                 encoding="big5",
                 thread_num=1,
                 show_progress=False,
                 uint8=False):
        self.img_path = img_path
        self.label_path = label_path
        self.reader = reader
        self.batch_size = batch_size
        self.label_format = label_format
        self.size = tuple(size)
        self.rescale = rescale
        self.preprocessing = preprocessing
        self.grid_shape = tuple(grid_shape)
        self.class_names = list(class_names)
        self.class_num = len(class_names)
        self.augmenter = augmenter
        self.encoding = encoding
        self.thread_num = thread_num
        self.show_progress = show_progress
        # uint8=True: emit RAW uint8 image batches (rescale NOT
        # applied host-side) — the engine normalizes on device
        # (Model input_rescale), shipping 1 byte/pixel instead of 8
        # (f64) to the accelerator feed. Bit-identical training: the
        # device computes the same u8 -> f32 * rescale product.
        self.uint8 = bool(uint8)
        if self.uint8 and rescale is not None \
                and not np.isclose(float(rescale), 1 / 255):
            # host rescale is NOT applied to uint8 batches; training is
            # only correct when the consuming Model's input_rescale
            # matches (create_model(input_rescale=...) plumbs it, and
            # engine.fit cross-checks sequence vs model at feed time).
            warnings.warn(
                f"uint8=True skips the host-side rescale ({rescale}); "
                "normalization happens on device with the Model's "
                "input_rescale. Pass the same value to "
                "create_model(input_rescale=...) or batches will be "
                "normalized with the default 1/255.", UserWarning)

        if reader not in ("cv", "PIL", "native"):
            raise ValueError(f"Invalid reader: {reader}")
        if reader == "native":
            from .. import native
            if not native.available():
                raise ValueError(
                    "native reader requested but libyolodata could not "
                    f"be built: {native.build_error()}")
        if label_format not in ("labelimg", "labelme"):
            raise ValueError(f"Invalid format: {label_format}")

        if label_format == "labelme" and (img_path is None
                                          or label_path is None):
            if label_path is None:
                self.label_path = img_path
                self.img_path = None
            names = [f for f in os.listdir(self.label_path)
                     if f.endswith(".json")]
        else:
            names = [f for f in os.listdir(img_path)
                     if not f.startswith(".")]
        names.sort()
        if shuffle:
            rng = np.random.RandomState(seed)
            names = np.asarray(names)
            rng.shuffle(names)
            names = names.tolist()
        self.path_list = names

    # ------------------------------------------------------------------
    def shard(self, num_shards, index=None):
        """Restrict this sequence to every ``num_shards``-th file
        (strided over the post-shuffle order) — the per-process data
        split of a multi-process run, each process feeding its own rows.
        All processes must construct the sequence
        with the SAME ``seed`` so the strided split is disjoint and
        exhaustive across them.

        Args:
            num_shards: total process count.
            index: this process's shard (default: the
                ``torch.distributed`` rank when a process group is
                initialised, else 0).

        Returns:
            self (mutated), for chaining.
        """
        if index is None:
            import torch.distributed as dist
            index = (dist.get_rank()
                     if dist.is_available() and dist.is_initialized()
                     else 0)
        if not 0 <= index < num_shards:
            raise ValueError(
                f"shard index {index} not in [0, {num_shards})")
        self.path_list = self.path_list[index::num_shards]
        return self

    # ------------------------------------------------------------------
    @property
    def augmenter(self):
        return self._augmenter

    @augmenter.setter
    def augmenter(self, aug):
        # reference users pass imgaug Sequential objects directly
        # (utils/tools.py:98, adapter at :218-228); duck-type-wrap
        # them into the (image, tagged) contract transparently
        from .augment import adapt_augmenter
        self._augmenter = adapt_augmenter(aug)

    def __len__(self):
        return ceil(len(self.path_list) / self.batch_size)

    def _load_image(self, name, image_data=None):
        """Read + resize one image; returns (array, zoom_ratio[w, h])."""
        if self.reader == "native" and image_data is None:
            from .. import native
            return native.load_image(
                os.path.join(self.img_path, name), self.size)
        if self.reader == "cv":
            import cv2 as cv
            if image_data is not None:
                raw = np.frombuffer(image_data.getvalue(), np.uint8)
                img = cv.imdecode(raw, cv.IMREAD_COLOR)
            else:
                img = cv.imread(os.path.join(self.img_path, name))
            zoom = (np.array(img.shape[1::-1])
                    / np.array(self.size[::-1]))
            img = cv.resize(img, self.size[::-1])
            return img, zoom
        from PIL import Image
        src = image_data if image_data is not None \
            else os.path.join(self.img_path, name)
        img = Image.open(src)
        zoom = np.array(img.size) / np.array(self.size[::-1])
        img = img.resize(self.size[::-1]).convert("RGB")
        return np.array(img), zoom

    def _load_sample(self, name):
        """Load one raw sample pre-augmentation: (image, tagged) with
        tagged an (N, 5) float array [x1, y1, x2, y2, class_idx] in
        pixel coordinates of the resized image."""
        if self.label_format == "labelimg":
            stem = name[:name.rfind(".")]
            boxes, labels = parse_labelimg(
                os.path.join(self.label_path, stem + ".xml"),
                self.class_names, self.encoding)
            img, zoom = self._load_image(name)
        else:
            if self.img_path is None:
                json_path = os.path.join(self.label_path, name)
            else:
                stem = name[:name.rfind(".")]
                json_path = os.path.join(self.label_path, stem + ".json")
            boxes, labels, image_data = parse_labelme(
                json_path, self.class_names, self.encoding)
            img, zoom = self._load_image(
                name if self.img_path is not None else None,
                image_data if self.img_path is None else None)

        labels = np.asarray(labels, dtype=float)
        if len(boxes):
            boxes = boxes / np.array([zoom[0], zoom[1],
                                      zoom[0], zoom[1]])[None, :]
        # labels ride as a 5th column so augmenters that drop boxes
        # keep the pairing intact
        tagged = np.concatenate(
            [boxes, labels[:, None]], axis=1) if len(boxes) \
            else np.zeros((0, 5))
        return img, tagged

    def sample_raw(self, rng=np.random):
        """A random raw (image, tagged-boxes) sample — the sampler hook
        for cross-image augmenters (``data.augment.Mosaic``)."""
        name = self.path_list[rng.randint(len(self.path_list))]
        return self._load_sample(name)

    def _read_one(self, name, img_batch, label_batch, pos):
        img, tagged = self._load_sample(name)
        if self.augmenter is not None:
            img, tagged = self.augmenter(img, tagged)
        boxes, labels = tagged[:, :4], tagged[:, 4]
        if self.preprocessing is not None:
            img = self.preprocessing(img)
        labels = labels.astype(int)

        if self.uint8 and np.issubdtype(np.asarray(img).dtype,
                                        np.floating):
            # a preprocessing/augmenter hook emitted floats; a silent
            # C-cast into the uint8 buffer truncates fractions — and
            # zeroes out normalized [0, 1] outputs entirely.
            if float(np.max(img, initial=0.0)) <= 2.0:
                raise ValueError(
                    "uint8=True but a preprocessing/augmenter hook "
                    "returned a normalized float image (max <= 2); "
                    "storing it in the uint8 batch would zero it out. "
                    "Return 0-255-valued images from hooks, or use "
                    "uint8=False.")
            img = np.clip(np.round(img), 0.0, 255.0)
        img_batch[pos] = img
        encode_to_grid(boxes, labels, img.shape[:2], self.grid_shape,
                       self.class_num, out=label_batch[pos])

    def _native_fast_path(self, names):
        """Whole-batch decode+parse+encode in C++ (native reader).
        Only for labelimg + no augmenter/preprocessing; otherwise the
        per-image Python path below runs (with native image decode)."""
        from .. import native

        img_paths = [os.path.join(self.img_path, n) for n in names]
        xml_paths = [os.path.join(self.label_path,
                                  n[:n.rfind(".")] + ".xml")
                     for n in names]
        imgs, labels = native.load_and_encode_batch(
            img_paths, xml_paths, self.size, self.grid_shape,
            self.class_names,
            threads=max(1, min(self.thread_num, os.cpu_count() or 1)))
        img_batch = imgs if self.uint8 else imgs.astype(np.float64)
        label_batch = labels.astype(np.float64)
        return img_batch, label_batch

    def __getitem__(self, idx):
        if idx >= len(self):
            raise IndexError("Sequence index out of range")
        total = len(self.path_list)
        start = idx * self.batch_size
        names = self.path_list[start:start + self.batch_size]
        bsz = len(names)

        if (self.reader == "native"
                and self.label_format == "labelimg"
                and self.augmenter is None
                and self.preprocessing is None):
            img_batch, label_batch = self._native_fast_path(names)
            if self.show_progress:
                print(f"\r{min(100, ceil((start + bsz) / total * 100)):3d}"
                      "% read", end="")
            if not self.uint8 and self.rescale is not None:
                img_batch = img_batch * self.rescale
            return img_batch, label_batch

        img_batch = np.empty((bsz, *self.size, 3),
                             np.uint8 if self.uint8 else np.float64)
        label_batch = np.zeros((bsz, *self.grid_shape,
                                5 + self.class_num))

        if self.thread_num <= 1 or bsz <= 1:
            for i, name in enumerate(names):
                self._read_one(name, img_batch, label_batch, i)
        else:
            per = ceil(bsz / self.thread_num)
            threads = []
            errors = []
            for w0 in range(0, bsz, per):
                def work(lo=w0):
                    try:
                        for i in range(lo, min(lo + per, bsz)):
                            self._read_one(names[i], img_batch,
                                           label_batch, i)
                    except BaseException as exc:   # propagate to caller
                        errors.append(exc)
                threads.append(threading.Thread(target=work))
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                # a swallowed worker error would hand the trainer
                # uninitialized np.empty image rows
                raise errors[0]

        if self.show_progress:
            print(f"\r{min(100, ceil((start + bsz) / total * 100)):3d}% "
                  "read", end="")

        if not self.uint8 and self.rescale is not None:
            img_batch = img_batch * self.rescale
        return img_batch, label_batch

    # ------------------------------------------------------------------
    def as_iterator(self, prefetch=2):
        """Epoch iterator with background-thread prefetch so host IO
        and augmentation overlap the device step."""
        from .pipeline import threaded_prefetch

        yield from threaded_prefetch(
            lambda: (self[i] for i in range(len(self))), prefetch)
