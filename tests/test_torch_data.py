"""The port's host data path and host tools against the JAX package's:
the annotation parsers, the grid encoder, ``YoloDataSequence`` (both
label formats, both image readers, shuffle, shard, threads, uint8 and the
augmenters under a seed), ``utils.tools`` and the k-means. Everything
here is numpy on both sides and is held EQUAL (``np.array_equal``), but
``kmeans_torch``, whose sums run in another order than ``kmeans_jax``'s."""

import os

import numpy as np
import pytest
import torch

import jax

from tests.helpers_data import make_dataset
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu import data as jdata
from tf2_yolo_tpu import utils as jutils
from tf2_yolo_tpu.data import augment as jaug
from tf2_yolo_tpu.utils.tools import apply_nms as japply
from tf2_yolo_tpu_torch import data as tdata
from tf2_yolo_tpu_torch import utils as tutils
from tf2_yolo_tpu_torch.data import augment as taug
from tf2_yolo_tpu_torch.utils import kmeans_torch
from tf2_yolo_tpu_torch.utils.kmeans import _lloyd
from tf2_yolo_tpu_torch.utils.tools import apply_nms as tapply

NAMES = ("square", "bar", "tall")


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Seeded sets: labelimg, labelme beside the images, labelme with the
    images embedded."""
    root = tmp_path_factory.mktemp("sets")
    return {
        "labelimg": make_dataset(str(root / "xml"), n_images=7,
                                 size=(64, 48), class_names=NAMES, seed=1),
        "labelme": make_dataset(str(root / "json"), n_images=7,
                                size=(64, 48), class_names=NAMES, seed=2,
                                label_format="labelme"),
        "embedded": make_dataset(str(root / "emb"), n_images=5,
                                 size=(48, 64), class_names=NAMES, seed=3,
                                 label_format="labelme",
                                 embed_image_data=True),
    }


def _both(sets, fmt, **kw):
    img_dir, lab_dir = sets[fmt]
    if fmt == "embedded":
        img_dir, lab_dir = None, lab_dir
    kw = dict(img_path=img_dir, label_path=lab_dir, size=(32, 32),
              grid_shape=(4, 4), class_names=list(NAMES),
              label_format="labelimg" if fmt == "labelimg" else "labelme",
              **kw)
    return jdata.YoloDataSequence(**kw), tdata.YoloDataSequence(**kw)


def _assert_batches_equal(jseq, tseq):
    assert jseq.path_list == tseq.path_list
    assert len(jseq) == len(tseq)
    for i in range(len(jseq)):
        (ji, jl), (ti, tl) = jseq[i], tseq[i]
        assert ji.dtype == ti.dtype and np.array_equal(ji, ti), i
        assert np.array_equal(jl, tl), i


def test_parsers_equal(sets):
    img_dir, lab_dir = sets["labelimg"]
    for f in sorted(os.listdir(lab_dir)):
        jb, jl = jdata.parse_labelimg(os.path.join(lab_dir, f), list(NAMES))
        tb, tl = tdata.parse_labelimg(os.path.join(lab_dir, f), list(NAMES))
        assert np.array_equal(jb, tb) and jl == tl
    _, lab_dir = sets["embedded"]
    for f in sorted(os.listdir(lab_dir)):
        jb, jl, jd = jdata.parse_labelme(os.path.join(lab_dir, f),
                                         list(NAMES[:2]))
        tb, tl, td = tdata.parse_labelme(os.path.join(lab_dir, f),
                                         list(NAMES[:2]))
        assert np.array_equal(jb, tb) and jl == tl
        assert jd.getvalue() == td.getvalue()


@pytest.mark.parametrize("boxes,labels", [
    # two boxes in one cell: xywh last-write-wins, class bits accumulate
    ([[8.0, 8.0, 24.0, 24.0], [18.0, 18.0, 30.0, 30.0]], [0, 1]),
    # a center past the grid is dropped; a negative one wraps
    ([[90.0, 90.0, 110.0, 110.0], [-20.0, 4.0, -4.0, 20.0]], [1, 0]),
    ([], []),
])
def test_encode_to_grid_equal(boxes, labels):
    boxes = np.asarray(boxes, float).reshape(-1, 4)
    want = jdata.encode_to_grid(boxes, labels, (96, 96), (6, 6), 2)
    got = tdata.encode_to_grid(boxes, labels, (96, 96), (6, 6), 2)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fmt,kw", [
    ("labelimg", dict(batch_size=3, shuffle=False)),
    ("labelimg", dict(batch_size=2, seed=5)),
    ("labelimg", dict(batch_size=4, seed=5, thread_num=3)),
    ("labelimg", dict(batch_size=3, seed=5, uint8=True)),
    ("labelimg", dict(batch_size=3, seed=5, reader="cv")),
    ("labelme", dict(batch_size=3, seed=7)),
    ("embedded", dict(batch_size=2, seed=7)),
    ("embedded", dict(batch_size=2, seed=7, reader="cv")),
], ids=["labelimg", "shuffled", "threaded", "uint8", "cv", "labelme",
        "embedded", "embedded-cv"])
def test_sequence_equal(sets, fmt, kw):
    _assert_batches_equal(*_both(sets, fmt, **kw))


def test_threaded_equals_single_and_shard(sets):
    _, single = _both(sets, "labelimg", batch_size=7, seed=2)
    _, threaded = _both(sets, "labelimg", batch_size=7, seed=2,
                        thread_num=4)
    assert all(np.array_equal(a, b) for a, b in zip(single[0], threaded[0]))
    parts = []
    for i in range(3):
        jseq, tseq = _both(sets, "labelimg", batch_size=2, seed=2)
        jseq.shard(3, i)
        tseq.shard(3, i)
        _assert_batches_equal(jseq, tseq)
        parts += tseq.path_list
    assert sorted(parts) == sorted(single.path_list)
    # no process group: the default index is 0 (JAX: process_index 0)
    jseq, tseq = _both(sets, "labelimg", batch_size=2, seed=2)
    assert tseq.shard(2).path_list == jseq.shard(2).path_list
    with pytest.raises(ValueError):
        tseq.shard(2, 5)


def _augmenter(aug, name, seq):
    if name == "flip":
        return aug.Sequential([aug.RandomFlipLR(0.5),
                               aug.RandomFlipUD(0.5)], seed=4)
    if name == "hsv":
        return aug.Sequential([aug.HSVJitter(0.05, 0.5, 0.5),
                               aug.ColorJitter()], seed=4)
    return aug.Sequential([aug.Mosaic(seq.sample_raw),
                           aug.RandomTranslate(0.2),
                           aug.RandomScale(0.8, 1.2)], seed=4)


@pytest.mark.parametrize("name", ["flip", "hsv", "mosaic"])
def test_augmenters_equal_under_a_seed(sets, name):
    jseq, tseq = _both(sets, "labelimg", batch_size=3, seed=9)
    jseq.augmenter = _augmenter(jaug, name, jseq)
    tseq.augmenter = _augmenter(taug, name, tseq)
    _assert_batches_equal(jseq, tseq)


def test_native_reader_raises(sets, monkeypatch):
    """A native reader that cannot be built raises with the build error
    (it never falls back to PIL quietly); an unknown reader raises.
    tests/test_torch_native.py holds the built reader to the JAX
    package's."""
    from tf2_yolo_tpu_torch import native

    img_dir, lab_dir = sets["labelimg"]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error",
                        RuntimeError("g++ failed on loader.cpp"))
    with pytest.raises(ValueError, match="could not be built: g.. failed"):
        tdata.YoloDataSequence(img_dir, lab_dir, reader="native")
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        native.load_image(os.path.join(img_dir, "x.png"), (8, 8))
    with pytest.raises(ValueError, match="Invalid reader"):
        tdata.YoloDataSequence(img_dir, lab_dir, reader="tf")


def _grid(rng, g, b=3, c=3):
    out = rng.rand(g, g, b * (5 + c))
    out[..., 4::5 + c] = rng.rand(g, g, b) ** 0.3      # many confident
    return out


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_tools_decode_and_nms_equal(mode):
    rng = np.random.RandomState(mode)
    grids = [_grid(rng, g) for g in (2, 4, 8)]
    kw = dict(class_num=3, threshold=0.4, version=4)
    rows_j = jutils.decode(*grids, **kw)
    rows_t = tutils.decode(*grids, **kw)
    assert len(rows_t) > 20 and np.array_equal(rows_t, rows_j)
    got = tapply(rows_t, 3, mode, 0.45, 0.4, 0.5)
    want = japply(rows_j, 3, mode, 0.45, 0.4, 0.5)
    assert np.array_equal(got, want)
    if mode == 1:
        assert len(got) < len(rows_t)        # something was suppressed
        assert np.array_equal(tutils.nms(rows_t, 3, 0.3),
                              jutils.nms(rows_j, 3, 0.3))
        assert np.array_equal(tutils.soft_nms(rows_t, 3, 0.3, 0.5, 0.3),
                              jutils.soft_nms(rows_j, 3, 0.3, 0.5, 0.3))


def test_tools_label_helpers_equal():
    rng = np.random.RandomState(3)
    label = np.zeros((2, 8, 8, 7))
    for b in range(2):
        for _ in range(9):
            gy, gx = rng.randint(0, 8, 2)
            label[b, gy, gx, :5] = [*rng.rand(4), 1]
            label[b, gy, gx, 5 + rng.randint(2)] = 1
    assert np.array_equal(tutils.down2xlabel(label),
                          jutils.down2xlabel(label))
    for method in ("alpha", "log", "effective", "binary"):
        assert np.array_equal(tutils.get_class_weight(label, method),
                              jutils.get_class_weight(label, method))
    a, b = rng.rand(5, 1, 4), rng.rand(1, 6, 4)
    for mode in (1, 2):
        assert np.array_equal(tutils.cal_iou(a, b, mode),
                              jutils.cal_iou(a, b, mode))


def test_numpy_kmeans_equal():
    rng = np.random.RandomState(0)
    boxes = rng.rand(200, 2) * 0.5 + 0.02
    out = []
    for mod in (jutils, tutils):
        np.random.seed(12)
        out.append(mod.kmeans(boxes, 5, mod.iou_dist, 1e-6, verbose=False))
    assert np.array_equal(out[0], out[1])


@pytest.mark.parametrize("dist", ["iou", "euclidean"])
def test_kmeans_torch_matches_kmeans_jax(dist):
    """The same start (``kmeans_jax``'s seeded draw, given to the loop):
    the same clusters, centres within 1e-6 (the sums of the members run
    in another order; measured 0 here)."""
    rng = np.random.RandomState(5)
    centres = np.array([[0.05, 0.07], [0.2, 0.1], [0.1, 0.3], [0.4, 0.45],
                        [0.7, 0.6]])
    boxes = np.concatenate([c + 0.01 * rng.randn(60, 2) for c in centres])
    boxes = np.abs(boxes).astype(np.float32)
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(3), len(boxes),
                                       (5,), replace=False))
    want = jutils.kmeans_jax(boxes, 5, dist=dist, seed=3)
    got = _lloyd(torch.from_numpy(boxes), torch.from_numpy(boxes[idx]),
                 dist, 1e-4, 1000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the default start draws distinct rows from its own seed
    again = kmeans_torch(boxes, 5, dist=dist, seed=3, device="cpu")
    assert again.shape == (5, 2) and np.isfinite(again).all()
