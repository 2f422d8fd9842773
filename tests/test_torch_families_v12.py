"""The port's YOLOv1 (128^2) and YOLOv2 (DarkNet-19 and UNet, 64^2)
against the JAX package's, in f32 on the CPU: the networks (leaves, eval
heads), one training step and the serving program
(``tests/helpers_families.py`` sets them up and holds the checks); the
v1 decode layout; and the serving artifact of a v1 model."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import helpers_families as fam
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu.ops import decode as jdecode
from tf2_yolo_tpu_torch.export import (load_serving, make_serving_fn,
                                       save_serving)
from tf2_yolo_tpu_torch.models import YoloV1
from tf2_yolo_tpu_torch.ops import decode

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["v1", "v2_darknet", "v2_unet"])
def family(request):
    yield fam.built(request.param)
    fam.built.cache_clear()


def test_leaves_and_structure_match_jax(family):
    fam.check_leaves_and_structure(family)


def test_eval_heads_match_jax(family):
    fam.check_eval_heads(family)


def test_train_step_matches_jax(family):
    fam.check_train_step(family)


def test_serving_kept_rows_match_jax(family):
    fam.check_serving_kept_rows(family)


def test_decode_v1_layout_matches_jax():
    # B boxes of a cell share the last C channels; on a 4 x 4 grid (x / 4
    # is exact, as the JAX package's jitted division by a reciprocal)
    rng = np.random.RandomState(4)
    out = rng.rand(2, 4, 4, 5 * 2 + fam.CLASSES).astype(np.float32)
    rows, valid = decode.decode_multi_level(
        [torch.from_numpy(out)], class_num=fam.CLASSES, threshold=0.3,
        max_boxes=40, version=1)
    jrows, jvalid = jdecode.decode_multi_level(
        [jnp.asarray(out)], class_num=fam.CLASSES, threshold=0.3,
        max_boxes=40, version=1)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < valid.sum() < valid.numel()


def test_v1_serving_artifact_round_trip(tmp_path):
    """``save_serving`` / ``load_serving`` of a YOLOv1 model keeps its
    version: the loaded program decodes the v1 layout, bit for bit the
    rows of ``make_serving_fn(version=1)``."""
    x = np.random.RandomState(6).rand(2, 128, 128, 3).astype(np.float32)
    model = YoloV1(2, fam.CLASSES, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    fam._calibrate_bn(model, torch.from_numpy(x))
    path = str(tmp_path / "v1.tysrv")
    save_serving(path, model, (128, 128, 3), batch_size=2,
                 class_num=fam.CLASSES, version=1, fold_bn=False,
                 threshold=0.2, max_boxes=32)
    served = load_serving(path)
    assert served.meta["yolo_version"] == 1
    rows, keep = served(x)
    want_rows, want_keep = make_serving_fn(
        model, fam.CLASSES, 1, threshold=0.2, max_boxes=32)(
        torch.from_numpy(x))
    assert torch.equal(rows, want_rows) and torch.equal(keep, want_keep)
    assert keep.any()
