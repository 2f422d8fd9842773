"""The port imports torch and numpy, never JAX and nothing of the JAX
package: every module of ``tf2_yolo_tpu_torch`` and ``chip_smoke.py`` are
imported in a fresh interpreter, and ``sys.modules`` is
searched afterwards."""

import json
import os
import pkgutil
import re
import subprocess
import sys

import pytest

import tf2_yolo_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tf2_yolo_tpu")
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(tf2_yolo_tpu_torch.__path__,
                                          "tf2_yolo_tpu_torch."))


# one fresh interpreter imports, in turn, the facades, every module of
# the port, chip_smoke.py and the multi-process worker (with every module
# its source names), and reports after each step which forbidden modules
# (and, after the port's modules, h5py and the image libraries) are in
# sys.modules: what a later step finds includes every earlier one, so a
# step that found none loaded none
_STEPS = r"""
import importlib, json, re, sys
FORBIDDEN = %(forbidden)r
def found(tops):
    return sorted(m for m in sys.modules if m.split('.')[0] in tops)
out = {}
from tf2_yolo_tpu_torch import yolov1_5, yolov2, yolov3, yolov4
from tf2_yolo_tpu_torch.models import (YoloV1, YoloV2, YoloV3, ResNet,
    MobileNetV2, Classifier, darknet19)
from tf2_yolo_tpu_torch.config import YoloConfig
from tf2_yolo_tpu_torch.assets import load_class_names
out['facades'] = found(FORBIDDEN)
[importlib.import_module(m) for m in %(modules)r]
out['modules'] = found(FORBIDDEN)
out['h5py'] = found(('h5py',))
out['images'] = found(('PIL', 'cv2', 'matplotlib', 'imgaug'))
import chip_smoke
out['chip_smoke'] = found(FORBIDDEN)
sys.path.insert(0, 'tests')
[importlib.import_module(m) for m in %(worker_names)r]
import _torch_multiprocess_worker
out['worker'] = found(FORBIDDEN)
print(json.dumps(out))
"""


def _worker_names():
    """The modules that the multi-process worker's source names."""
    path = os.path.join(REPO, "tests", "_torch_multiprocess_worker.py")
    with open(path) as f:
        return re.findall(r"^\s*(?:from|import)\s+([\w.]+)", f.read(),
                          re.M)


@pytest.fixture(scope="module")
def imported():
    """What the fresh interpreter of ``_STEPS`` found after each step."""
    code = _STEPS % dict(forbidden=FORBIDDEN, modules=MODULES,
                         worker_names=sorted(set(_worker_names())))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_walk_finds_the_port():
    for name in ("tf2_yolo_tpu_torch.models.packed_region",
                 "tf2_yolo_tpu_torch.ops.kernels.fused_gemm",
                 "tf2_yolo_tpu_torch.ops.kernels.fused_conv3x3",
                 "tf2_yolo_tpu_torch.tools.bench_packed_probe",
                 "tf2_yolo_tpu_torch.ops.losses",
                 "tf2_yolo_tpu_torch.parallel.train",
                 "tf2_yolo_tpu_torch.tools.train_profile",
                 "tf2_yolo_tpu_torch.engine",
                 "tf2_yolo_tpu_torch.yolov4",
                 "tf2_yolo_tpu_torch.facade_base",
                 "tf2_yolo_tpu_torch.data.dataset",
                 "tf2_yolo_tpu_torch.data.pipeline",
                 "tf2_yolo_tpu_torch.ops.metrics",
                 "tf2_yolo_tpu_torch.parallel.checkpoint",
                 "tf2_yolo_tpu_torch.utils.kmeans",
                 "tf2_yolo_tpu_torch.utils.tools",
                 "tf2_yolo_tpu_torch.export",
                 "tf2_yolo_tpu_torch.ops.kernels.conv_int8",
                 "tf2_yolo_tpu_torch.ops.evalmatch",
                 "tf2_yolo_tpu_torch.utils.measurement",
                 "tf2_yolo_tpu_torch.yolov1_5",
                 "tf2_yolo_tpu_torch.yolov2",
                 "tf2_yolo_tpu_torch.yolov3",
                 "tf2_yolo_tpu_torch.models.backbones",
                 "tf2_yolo_tpu_torch.models.heads",
                 "tf2_yolo_tpu_torch.models.resnet",
                 "tf2_yolo_tpu_torch.models.mobilenet",
                 "tf2_yolo_tpu_torch.models.classifiers",
                 "tf2_yolo_tpu_torch.config",
                 "tf2_yolo_tpu_torch.assets",
                 "tf2_yolo_tpu_torch.convert",
                 "tf2_yolo_tpu_torch.native",
                 "tf2_yolo_tpu_torch.tools.bench_reader",
                 "tf2_yolo_tpu_torch.parallel.input",
                 "tf2_yolo_tpu_torch.parallel.mesh",
                 "tf2_yolo_tpu_torch.parallel.multihost",
                 "tf2_yolo_tpu_torch.parallel.pipeline"):
        assert name in MODULES


def test_the_facades_import_without_jax(imported):
    assert imported["facades"] == []


def test_every_module_of_the_port_imports_without_jax(imported):
    assert imported["modules"] == []


def test_chip_smoke_imports_without_jax(imported):
    assert imported["chip_smoke"] == []


def test_the_multiprocess_worker_imports_no_jax(imported):
    """The worker of the port's multi-process tests imports the port
    only: its source names no JAX module, and importing it with every
    module it names loads none."""
    names = _worker_names()
    assert "tf2_yolo_tpu_torch.parallel" in names
    assert not [m for m in names if m.split(".")[0] in FORBIDDEN], names
    assert imported["worker"] == []


def test_the_port_imports_without_h5py(imported):
    """The card's machine may have no h5py: the converter imports it in
    its two h5 functions only, and every converter takes a weight dict in
    place of a path."""
    assert imported["h5py"] == []


def test_the_port_imports_without_image_libraries(imported):
    """The card's machine may have no PIL, cv2 or matplotlib: the
    readers, augmenters and plots import them when they run, never when
    a module of the port is imported."""
    assert imported["images"] == []
