"""Lightweight box-aware image augmentation (imgaug replacement).

A copy of tf2_yolo_tpu/data/augment.py (numpy; the port imports nothing
of the JAX package).

The reference exposes an ``augmenter`` hook taking an imgaug
``Sequential`` (utils/tools.py:218-228); imgaug is not a dependency
here. An augmenter in this framework is any callable

    augmenter(image, boxes) -> (image, boxes)

with ``image`` an (H, W, 3) uint8/float ndarray and ``boxes`` a float
(N, 4) xyxy array in pixel coordinates of that image. The classes
below compose into a ``Sequential`` that satisfies that contract and
covers the augmentations the reference notebooks used (flips, affine
jitter, color jitter). NumPy-only: augmentation runs on host workers
overlapped with the device step.
"""

import numpy as np


class Sequential:
    """Apply augmenters in order; seedable."""

    def __init__(self, augmenters, seed=None):
        self.augmenters = list(augmenters)
        self.rng = np.random.RandomState(seed)

    def __call__(self, image, boxes):
        for aug in self.augmenters:
            image, boxes = aug(image, boxes, self.rng)
        return image, boxes


class RandomFlipLR:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, image, boxes, rng=np.random):
        if rng.rand() < self.prob:
            w = image.shape[1]
            image = image[:, ::-1]
            if len(boxes):
                boxes = boxes.copy()
                boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        return image, boxes


class RandomFlipUD:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, image, boxes, rng=np.random):
        if rng.rand() < self.prob:
            h = image.shape[0]
            image = image[::-1]
            if len(boxes):
                boxes = boxes.copy()
                boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
        return image, boxes


class RandomTranslate:
    """Shift by up to +-max_frac of the image size (zero fill); boxes
    fully shifted outside are dropped."""

    def __init__(self, max_frac=0.1):
        self.max_frac = max_frac

    def __call__(self, image, boxes, rng=np.random):
        h, w = image.shape[:2]
        dx = int(rng.uniform(-self.max_frac, self.max_frac) * w)
        dy = int(rng.uniform(-self.max_frac, self.max_frac) * h)
        out = np.zeros_like(image)
        src_x = slice(max(0, -dx), min(w, w - dx))
        src_y = slice(max(0, -dy), min(h, h - dy))
        dst_x = slice(max(0, dx), min(w, w + dx))
        dst_y = slice(max(0, dy), min(h, h + dy))
        out[dst_y, dst_x] = image[src_y, src_x]
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, [0, 2]] += dx
            boxes[:, [1, 3]] += dy
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
            keep = ((boxes[:, 2] - boxes[:, 0]) > 1) & \
                   ((boxes[:, 3] - boxes[:, 1]) > 1)
            boxes = boxes[keep]
        return out, boxes


class RandomScale:
    """Zoom in/out around the center by a factor in [lo, hi]."""

    def __init__(self, lo=0.9, hi=1.1):
        self.lo, self.hi = lo, hi

    def __call__(self, image, boxes, rng=np.random):
        from PIL import Image
        h, w = image.shape[:2]
        s = rng.uniform(self.lo, self.hi)
        nh, nw = max(1, int(h * s)), max(1, int(w * s))
        arr = np.asarray(Image.fromarray(
            image.astype(np.uint8)).resize((nw, nh)))
        out = np.zeros_like(image)
        if s >= 1:             # crop center
            y0, x0 = (nh - h) // 2, (nw - w) // 2
            out = arr[y0:y0 + h, x0:x0 + w]
            off = (-x0, -y0)
        else:                  # pad center
            y0, x0 = (h - nh) // 2, (w - nw) // 2
            out[y0:y0 + nh, x0:x0 + nw] = arr
            off = (x0, y0)
        if len(boxes):
            boxes = boxes * s
            boxes = boxes.copy()
            boxes[:, [0, 2]] += off[0]
            boxes[:, [1, 3]] += off[1]
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
            keep = ((boxes[:, 2] - boxes[:, 0]) > 1) & \
                   ((boxes[:, 3] - boxes[:, 1]) > 1)
            boxes = boxes[keep]
        return out.astype(image.dtype), boxes


class ColorJitter:
    """Brightness/contrast jitter (box-free)."""

    def __init__(self, brightness=0.2, contrast=0.2):
        self.brightness = brightness
        self.contrast = contrast

    def __call__(self, image, boxes, rng=np.random):
        img = image.astype(np.float32)
        scale = 255.0 if image.dtype == np.uint8 else 1.0
        b = rng.uniform(-self.brightness, self.brightness) * scale
        c = 1.0 + rng.uniform(-self.contrast, self.contrast)
        img = (img - scale / 2) * c + scale / 2 + b
        img = img.clip(0, scale)
        return img.astype(image.dtype), boxes


class HSVJitter:
    """Darknet-style HSV jitter: additive hue shift (wrapping),
    multiplicative saturation/value gains. The YOLOv4 training recipe's
    color augmentation (hue=.1 sat=1.5 val=1.5 in darknet terms maps to
    roughly hue=0.05, sat=val=0.5 here)."""

    def __init__(self, hue=0.015, sat=0.4, val=0.4):
        self.hue, self.sat, self.val = hue, sat, val

    def __call__(self, image, boxes, rng=np.random):
        from matplotlib.colors import rgb_to_hsv, hsv_to_rgb
        scale = 255.0 if image.dtype == np.uint8 else 1.0
        hsv = rgb_to_hsv(image.astype(np.float32) / scale)
        hsv[..., 0] = (hsv[..., 0]
                       + rng.uniform(-self.hue, self.hue)) % 1.0
        hsv[..., 1] = np.clip(
            hsv[..., 1] * (1 + rng.uniform(-self.sat, self.sat)), 0, 1)
        hsv[..., 2] = np.clip(
            hsv[..., 2] * (1 + rng.uniform(-self.val, self.val)), 0, 1)
        out = hsv_to_rgb(hsv) * scale
        return out.astype(image.dtype), boxes


def _resize_img(img, w, h):
    if img.dtype == np.uint8:
        from PIL import Image
        return np.asarray(Image.fromarray(img).resize((w, h)))
    ys = (np.arange(h) * img.shape[0] / h).astype(int)
    xs = (np.arange(w) * img.shape[1] / w).astype(int)
    return img[ys][:, xs]


class Mosaic:
    """YOLOv4-paper 4-image mosaic (arXiv:2004.10934 §3.4; the
    reference has no equivalent). Splits the canvas at a random center
    and stretches one sample into each quadrant, remapping and merging
    their boxes.

    ``sampler(rng) -> (image, (N, 5) tagged boxes)`` supplies the three
    extra samples — wire it to ``YoloDataSequence.sample_raw``:

        seq = yolo.read_file_to_sequence(...)
        seq.augmenter = Sequential(
            [Mosaic(seq.sample_raw), RandomFlipLR()], seed=0)
    """

    def __init__(self, sampler, prob=1.0, center=(0.3, 0.7)):
        self.sampler = sampler
        self.prob = prob
        self.center = center

    def __call__(self, image, boxes, rng=np.random):
        if rng.rand() >= self.prob:
            return image, boxes
        h, w = image.shape[:2]
        cx = int(rng.uniform(*self.center) * w)
        cy = int(rng.uniform(*self.center) * h)
        canvas = np.zeros_like(image)
        regions = [(0, 0, cx, cy), (cx, 0, w, cy),
                   (0, cy, cx, h), (cx, cy, w, h)]
        samples = [(image, boxes)] \
            + [self.sampler(rng) for _ in range(3)]
        cols = boxes.shape[1] if getattr(boxes, "ndim", 0) == 2 else 5
        merged = []
        for (x0, y0, x1, y1), (img_s, b_s) in zip(regions, samples):
            rw, rh = x1 - x0, y1 - y0
            if rw < 2 or rh < 2:
                continue
            canvas[y0:y1, x0:x1] = _resize_img(img_s, rw, rh)
            if len(b_s):
                b = np.asarray(b_s, float).copy()
                b[:, [0, 2]] = b[:, [0, 2]] * (rw / img_s.shape[1]) + x0
                b[:, [1, 3]] = b[:, [1, 3]] * (rh / img_s.shape[0]) + y0
                merged.append(b)
        if not merged:
            return canvas, np.zeros((0, cols))
        out = np.concatenate(merged, axis=0)
        keep = ((out[:, 2] - out[:, 0]) > 1) & \
               ((out[:, 3] - out[:, 1]) > 1)
        return canvas, out[keep]


class ImgaugAdapter:
    """Adapts an imgaug augmenter to this framework's augmenter hook.

    The reference's ``augmenter`` kwarg takes an
    ``imgaug.augmenters.Sequential`` and calls it as
    ``augmenter(image=img, bounding_boxes=BoundingBoxesOnImage)``
    (reference utils/tools.py:98, :218-228); this framework's hook is
    ``augmenter(image, tagged[N,5]) -> (image, tagged)``. The adapter
    converts the tagged xyxy+label rows to imgaug bounding boxes,
    invokes the imgaug object with the reference's calling convention,
    and re-pairs class labels by index (the same order-preserving
    assumption the reference makes at utils/tools.py:190-209).

    imgaug itself is imported lazily — only needed if a user actually
    passes an imgaug augmenter.
    """

    def __init__(self, aug):
        self.aug = aug

    def __call__(self, image, tagged):
        try:
            from imgaug.augmentables.bbs import (BoundingBox,
                                                 BoundingBoxesOnImage)
        except ImportError as e:
            raise ImportError(
                "an imgaug augmenter was passed but the imgaug package "
                "is not installed; either install imgaug or pass a "
                "plain (image, boxes) -> (image, boxes) callable "
                "(see tf2_yolo_tpu_torch.data.augment)") from e
        tagged = np.asarray(tagged, float)
        bbs = BoundingBoxesOnImage(
            [BoundingBox(x1=b[0], y1=b[1], x2=b[2], y2=b[3])
             for b in tagged],
            shape=image.shape)
        img_aug, bbs_aug = self.aug(image=image, bounding_boxes=bbs)
        boxes = getattr(bbs_aug, "bounding_boxes", bbs_aug)
        if not len(boxes):
            return img_aug, np.zeros((0, 5))
        out = np.array(
            [[bb.x1, bb.y1, bb.x2, bb.y2, lab]
             for bb, lab in zip(boxes, tagged[:, 4])], float)
        return img_aug, out


def adapt_augmenter(aug):
    """Wrap imgaug-style augmenters transparently; pass through
    anything already satisfying the (image, tagged) contract."""
    if aug is None or isinstance(aug, ImgaugAdapter):
        return aug
    if hasattr(aug, "augment_bounding_boxes") \
            or hasattr(aug, "to_deterministic"):
        return ImgaugAdapter(aug)
    return aug
