"""ctypes bindings for the native data loader (``loader.cpp``).

Port of tf2_yolo_tpu/native/__init__.py, the same functions and errors:

  - ``load_image(path, size)`` -> (HWC uint8 array, zoom[w, h])
  - ``load_batch(paths, size, threads)`` -> (N,H,W,3) + zooms
  - ``parse_labelimg(xml_text, class_names)`` -> (boxes, labels)
  - ``load_and_encode_batch(...)`` -> full images+grid-labels pipeline

The library is built at first use with ``g++ -O3 -shared -fPIC
-std=c++17 loader.cpp -ljpeg -lpng`` into
``build/native/libyolodata-<hash>.so`` at the root of the checkout (a
directory ``.gitignore`` lists), keyed by a hash of the source, the
flags and the machine's architecture, as ``ops/kernels/_build.py`` keys
the CUDA kernels; nothing is written into the package. No
``-march=native``: the library may outlive the host that built it.
Nothing runs at import time.

``available()`` reports whether the library could be built and loaded
and ``build_error()`` why not; every other function raises RuntimeError
with that error when it is unavailable. The reader that asks for it
(``YoloDataSequence(reader="native")``) raises too: it never falls back
to the Python path quietly.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("loader.cpp")
BUILD_DIR = SOURCE.parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng")

_lib = None
_lock = threading.Lock()
_build_error = None


def library_path():
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(
        SOURCE.read_bytes()
        + "\0".join((*FLAGS, *LIBS, platform.machine())).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libyolodata-{digest}.so"


def _build(out):
    """g++ into a temporary file beside ``out``, then an atomic rename:
    processes that build at once each finish with a whole library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError) as e:
            _build_error = e
            return None

        lib.yolo_load_image.restype = ctypes.c_int
        lib.yolo_load_image.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double)]
        lib.yolo_load_batch.restype = ctypes.c_int
        lib.yolo_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int]
        lib.yolo_parse_labelimg.restype = ctypes.c_int
        lib.yolo_parse_labelimg.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int)]
        lib.yolo_load_and_encode_batch.restype = ctypes.c_int
        lib.yolo_load_and_encode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        _lib = lib
        return _lib


def available():
    return _load() is not None


def build_error():
    """Why the library could not be built or loaded (None if it was)."""
    _load()
    return _build_error


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    return lib


def _as_c_paths(paths):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() if p is not None else None for p in paths]
    return arr


def load_image(path, size):
    """Decode+resize one image. Returns (H, W, 3) uint8 and
    zoom (orig_w/out_w, orig_h/out_h)."""
    lib = _library()
    h, w = size
    out = np.empty((h, w, 3), np.uint8)
    zoom = np.empty((2,), np.float64)
    rc = lib.yolo_load_image(
        path.encode(), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        zoom.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise IOError(f"failed to decode image ({rc}): {path}")
    return out, zoom


def load_batch(paths, size, threads=8):
    lib = _library()
    h, w = size
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    zooms = np.empty((n, 2), np.float64)
    fails = lib.yolo_load_batch(
        _as_c_paths(paths), n, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        zooms.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), threads)
    if fails:
        raise IOError(f"{fails}/{n} images failed to decode")
    return out, zooms


def parse_labelimg(xml_text, class_names, max_boxes=256):
    lib = _library()
    boxes = np.zeros((max_boxes, 4), np.float64)
    labels = np.zeros((max_boxes,), np.int32)
    n = lib.yolo_parse_labelimg(
        xml_text.encode(), "\n".join(class_names).encode(), max_boxes,
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return boxes[:n], labels[:n].tolist()


def load_and_encode_batch(img_paths, xml_paths, size, grid_shape,
                          class_names, threads=8, max_boxes=256):
    """Full native pipeline: images + labelimg XMLs -> (imgs uint8,
    grid labels f32). xml_paths entries may be None."""
    lib = _library()
    h, w = size
    gh, gw = grid_shape
    n = len(img_paths)
    c = len(class_names)
    imgs = np.empty((n, h, w, 3), np.uint8)
    labels = np.zeros((n, gh, gw, 5 + c), np.float32)
    fails = lib.yolo_load_and_encode_batch(
        _as_c_paths(img_paths), _as_c_paths(xml_paths), n, h, w,
        gh, gw, "\n".join(class_names).encode(), c, max_boxes,
        imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads)
    if fails:
        raise IOError(f"{fails}/{n} samples failed")
    return imgs, labels
