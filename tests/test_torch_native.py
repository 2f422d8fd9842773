"""The port's native (C++) loader, ``tf2_yolo_tpu_torch.native``, against
the JAX package's Python path, on the CPU: the library builds into
``build/native/`` and writes nothing into either package; the labelimg
parser equals ``tf2_yolo_tpu.data.parse_labelimg``; the whole-batch
decode + parse + encode and ``YoloDataSequence(reader="native")`` (its
batch fast path, uint8 too, and the per-image native decode under a
preprocessing hook) equal the JAX package's ``reader="PIL"`` sequence
exactly, on ``tests/helpers_data.make_dataset`` (PNG images at the
network size: lossless, no resampling). The C++ codec stores its grid
labels as f32 (the JAX package's loader does the same), so the batch
path's labels equal the Python codec's f64 labels rounded once to f32,
bit for bit.

The module skips only where the compiler cannot find ``jpeglib.h``;
with the header present a failed build fails the tests.
"""

import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

from tests.helpers_data import make_dataset
from tf2_yolo_tpu import data as jdata
from tf2_yolo_tpu_torch import data as tdata
from tf2_yolo_tpu_torch import native

REPO = Path(__file__).resolve().parents[1]
NAMES = ["square", "bar"]


def _jpeg_header_found():
    try:
        proc = subprocess.run(
            ["g++", "-E", "-x", "c++", "-"],
            input="#include <cstddef>\n#include <cstdio>\n"
                  "#include <jpeglib.h>\n",
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return proc.returncode == 0


@pytest.fixture(scope="module", autouse=True)
def _compiler_finds_the_headers():
    """Decided inside a fixture, not at import: every worker collects the
    same tests."""
    if not _jpeg_header_found():
        pytest.skip("the compiler finds no jpeglib.h")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    return make_dataset(str(root), n_images=6, size=(96, 96))


def _git_status():
    """Files git sees under the two packages, ignored ones included (a
    stray library would be ignored by ``*.so``), or None without git."""
    try:
        proc = subprocess.run(
            ["git", "status", "--porcelain", "--ignored",
             "--untracked-files=all", "--", "tf2_yolo_tpu",
             "tf2_yolo_tpu_torch"],
            cwd=REPO, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    if proc.returncode != 0:
        return None
    return {line for line in proc.stdout.splitlines()
            if "__pycache__" not in line}


def test_builds_into_build_native_and_nowhere_else():
    before = _git_status()
    out = native.library_path()
    native._build(out)              # a fresh build, replaced atomically
    assert native.available(), native.build_error()
    assert out.parent == REPO / "build" / "native" and out.is_file()
    after = _git_status()
    if before is not None:
        assert after - before == set()
    pkg = REPO / "tf2_yolo_tpu_torch"
    built = [p for p in pkg.rglob("*")
             if p.suffix in (".so", ".tmp", ".host") or ".so." in p.name]
    assert built == []
    assert sorted(p.name for p in (pkg / "native").iterdir()
                  if p.name != "__pycache__") == ["__init__.py",
                                                  "loader.cpp"]


def test_load_image_and_errors(dataset):
    img_dir, _ = dataset
    path = os.path.join(img_dir, sorted(os.listdir(img_dir))[0])
    img, zoom = native.load_image(path, (48, 48))
    assert img.shape == (48, 48, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(zoom, [2.0, 2.0])
    with pytest.raises(IOError):
        native.load_image("/nonexistent/zzz.png", (32, 32))
    with pytest.raises(IOError, match="1/2"):
        native.load_batch([path, "/nonexistent/zzz.png"], (32, 32))


def test_parse_labelimg_equals_python(dataset):
    _, lab_dir = dataset
    for f in sorted(os.listdir(lab_dir)):
        with open(os.path.join(lab_dir, f)) as fh:
            nb, nl = native.parse_labelimg(fh.read(), NAMES)
        pb, pl = jdata.parse_labelimg(os.path.join(lab_dir, f), NAMES,
                                      encoding="utf-8")
        assert np.array_equal(nb, pb) and nl == pl


def test_batch_pipeline_equals_python(dataset):
    img_dir, lab_dir = dataset
    names = sorted(os.listdir(img_dir))
    imgs, labels = native.load_and_encode_batch(
        [os.path.join(img_dir, n) for n in names],
        [os.path.join(lab_dir, n[:-4] + ".xml") for n in names],
        (96, 96), (6, 6), NAMES, threads=3)
    seq = jdata.YoloDataSequence(
        img_path=img_dir, label_path=lab_dir, batch_size=6, size=(96, 96),
        grid_shape=(6, 6), rescale=None, class_names=NAMES, shuffle=False,
        encoding="utf-8")
    py_img, py_lab = seq[0]
    assert labels.dtype == np.float32
    assert np.array_equal(labels, py_lab.astype(np.float32))
    assert np.array_equal(imgs, py_img)
    frames, _ = native.load_batch([os.path.join(img_dir, n) for n in names],
                                  (96, 96), threads=2)
    assert np.array_equal(frames, imgs)


@pytest.mark.parametrize("kind", ["fast path", "uint8", "per image"])
def test_sequence_native_reader_equals_pil(dataset, kind):
    img_dir, lab_dir = dataset
    kw = dict(img_path=img_dir, label_path=lab_dir, batch_size=4,
              size=(96, 96), grid_shape=(6, 6), class_names=NAMES,
              shuffle=True, seed=4, thread_num=2, encoding="utf-8",
              uint8=kind == "uint8")
    if kind == "per image":
        # a hook sends the native reader down the per-image path: the
        # image decoded natively, the labels by the Python parser
        kw["preprocessing"] = lambda img: img[:, ::-1]
    seq = tdata.YoloDataSequence(reader="native", **kw)
    ref = jdata.YoloDataSequence(reader="PIL", **kw)
    assert seq.path_list == ref.path_list and len(seq) == len(ref) == 2
    for i in range(len(ref)):
        (img, lab), (rimg, rlab) = seq[i], ref[i]
        assert img.dtype == rimg.dtype and np.array_equal(img, rimg), i
        if kind != "per image":        # the C++ codec's f32 labels
            rlab = rlab.astype(np.float32).astype(np.float64)
        assert lab.dtype == rlab.dtype and np.array_equal(lab, rlab), i
        assert (lab[..., 4] == 1).any()
