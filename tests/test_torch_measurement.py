"""The port's offline evaluation (``utils/measurement.py``) and device-side
decode against the JAX package's, on the CPU.

The same seeded numpy grids go to both packages. ``create_score_mat``
tables and ``get_map`` tables compare with ``pd.testing.assert_frame_equal``
(NaN cells in the same places); PR curves and decoded rows compare
exactly. Each path is held to its counterpart: the port's host path
(``device=False``) to the JAX host path, and the port's device path on
the CPU (``device="cpu"``, the plain NMS versions) to the JAX device path
(``device=True``, XLA on the CPU). Last, a whole-slice check: a small
YOLOv4 from one JAX init predicts through the port's ``Model.predict``,
and both packages' ``PRfunc`` on those arrays give the same mAP.
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from tf2_yolo_tpu.models import YoloV4 as JaxYoloV4
from tf2_yolo_tpu.ops import decode_multi_level as jdecode_multi_level
from tf2_yolo_tpu.utils import measurement as jmeasurement
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch import engine
from tf2_yolo_tpu_torch.bridge import from_flax
from tf2_yolo_tpu_torch.data import encode_to_grid
from tf2_yolo_tpu_torch.models import YoloV4
from tf2_yolo_tpu_torch.models.layers import ConvBN
from tf2_yolo_tpu_torch.ops.decode import decode_multi_level
from tf2_yolo_tpu_torch.utils import PR_func, PRfunc, create_score_mat
from tf2_yolo_tpu_torch.utils import measurement
from tf2_yolo_tpu_torch.utils import tools as port_tools

torch.set_num_threads(1)

NAMES = ["a", "b", "c"]
MAP_MODES = ("voc2007", "voc2012", "area", "smootharea")


def _rand_level(rng, n, s, b, c):
    out = rng.rand(n, s, s, b * (5 + c)).astype(np.float32)
    shaped = out.reshape(n, s, s, b, 5 + c)
    shaped[..., 2:4] = shaped[..., 2:4] * 0.4 + 0.05
    return out


def _ragged_data(n=10, classes=3, seed=11):
    """Images with 0-5 GTs (some without any), random predictions: empty
    GT, empty predictions and classes out of balance (the fixture of the
    JAX package's device-evaluation tests)."""
    rng = np.random.RandomState(seed)
    preds = _rand_level(rng, n, 4, 2, classes)
    gts = np.zeros((n, 4, 4, 5 + classes), np.float32)
    for i in range(n):
        for _ in range(rng.randint(0, 6)):
            y, x = rng.randint(0, 4, 2)
            gts[i, y, x, :4] = rng.rand(4) * 0.5 + 0.2
            gts[i, y, x, 4] = 1
            gts[i, y, x, 5 + rng.randint(classes)] = 1
    return gts, preds


def _tied_data():
    """Four predictions of class a in image 0 whose joint confidences tie
    exactly, the 4th to 7th of that image and class, so that a cap of 4
    keeps one of them; the first two lie on GTs, the last two on none, so
    which one the cap keeps decides the curve."""
    gts, preds = _ragged_data(n=4, seed=5)
    shaped = preds.reshape(4, 4, 4, 2, 8)
    for y in range(4):
        shaped[0, y, y, 0, 4] = 0.8                    # conf
        shaped[0, y, y, 0, 5:] = [0.9, 0.0, 0.0]       # class a, prob 0.9
        if y < 2:
            gts[0, y, y, :4] = shaped[0, y, y, 0, :4]
            gts[0, y, y, 4:] = [1, 1, 0, 0]
    return gts, preds


def _score_mats(gts, preds, device, **kw):
    """Port and JAX ``create_score_mat`` on one path; ``preds`` a list of
    levels."""
    port = create_score_mat(gts, *preds, class_names=NAMES,
                            device=device and "cpu", **kw)
    jax_ = jmeasurement.create_score_mat(gts, *preds, class_names=NAMES,
                                         device=device, **kw)
    return port, jax_


def _prfuncs(gts, preds, device, **kw):
    port = PRfunc(gts, *preds, class_names=NAMES, device=device and "cpu",
                  **kw)
    jax_ = jmeasurement.PRfunc(gts, *preds, class_names=NAMES,
                               device=device, **kw)
    return port, jax_


def _assert_same_curves(port, jax_):
    for ci in range(len(jax_.precisions)):
        np.testing.assert_array_equal(port.precisions[ci],
                                      jax_.precisions[ci])
        np.testing.assert_array_equal(port.recalls[ci], jax_.recalls[ci])
    for mode in MAP_MODES:
        pd.testing.assert_frame_equal(port.get_map(mode), jax_.get_map(mode))


# --- decode ---------------------------------------------------------------

@pytest.mark.parametrize("version", [2, 3, 4])
def test_decode_multi_level_versions(version):
    rng = np.random.RandomState(version)
    levels = [_rand_level(rng, 3, s, 3, 3) for s in (2, 4)]
    rows, valid = decode_multi_level([torch.from_numpy(v) for v in levels],
                                     class_num=3, threshold=0.5,
                                     max_boxes=80, version=version)
    jrows, jvalid = jdecode_multi_level([jnp.asarray(v) for v in levels],
                                        class_num=3, threshold=0.5,
                                        max_boxes=80, version=version)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < valid.sum() < valid.numel()


@pytest.mark.parametrize("version,exc", [(0, ValueError), (5, ValueError)])
def test_decode_unported_versions_raise(version, exc):
    with pytest.raises(exc):
        decode_multi_level([torch.zeros(1, 2, 2, 8)], class_num=3,
                           version=version)


def test_decode_batch_device_matches_jax():
    gts, preds = _ragged_data()
    args = (3, 0.4, 1, 0.5, 0.5, 2)
    t, p = measurement.decode_batch_device(gts, [preds], *args,
                                           device="cpu")
    jt, jp = jmeasurement.decode_batch_device(gts, [preds], *args)
    assert len(t) == len(jt) == len(p) == len(jp) == len(gts)
    for got, want in zip(t + p, jt + jp):
        np.testing.assert_array_equal(got, want)


# --- create_score_mat -------------------------------------------------------

@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("nms_mode", [0, 1, 2, 3])
def test_score_mat_equal_jax(nms_mode, device):
    gts, preds = _ragged_data()
    for precision_mode in (0, 1, 2):
        port, jax_ = _score_mats(gts, [preds], device, conf_threshold=0.4,
                                 nms_mode=nms_mode, nms_threshold=0.5,
                                 iou_threshold=0.5,
                                 precision_mode=precision_mode, version=2)
        pd.testing.assert_frame_equal(port, jax_)
        assert (port["dets"] > 0).all()


def test_score_mat_device_equals_host_and_nan_cells():
    """A class that is never predicted: its precision is 0/0 (NaN) on
    both paths of both packages."""
    gts, preds = _ragged_data(seed=3)
    preds.reshape(10, 4, 4, 2, 8)[..., 7] = 0.0          # class c
    kw = dict(conf_threshold=0.4, nms_mode=1, version=2)
    host, jhost = _score_mats(gts, [preds], False, **kw)
    dev, jdev = _score_mats(gts, [preds], True, **kw)
    assert host["precision"].isna().tolist() == [False, False, True]
    for table in (jhost, dev, jdev):
        pd.testing.assert_frame_equal(host, table)


def test_score_mat_tensor_predictions():
    """Tensors on the evaluation's device are taken as they are."""
    gts, preds = _ragged_data()
    kw = dict(class_names=NAMES, conf_threshold=0.4, nms_mode=2,
              version=2, device="cpu")
    pd.testing.assert_frame_equal(
        create_score_mat(torch.from_numpy(gts), torch.from_numpy(preds),
                         **kw),
        create_score_mat(gts, preds, **kw))


def test_saturation_warning_and_parity():
    """A cap below the candidates warns on both packages' device paths,
    which still agree."""
    gts, preds = _ragged_data()
    kw = dict(conf_threshold=0.1, nms_mode=1, version=2,
              device_max_boxes=8)
    with pytest.warns(UserWarning, match="max_boxes=8"):
        port = create_score_mat(gts, preds, class_names=NAMES,
                                device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_ = jmeasurement.create_score_mat(gts, preds, class_names=NAMES,
                                             device=True, **kw)
    pd.testing.assert_frame_equal(port, jax_)


# --- PRfunc ----------------------------------------------------------------

@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("nms_mode", [0, 1, 2, 3])
def test_prfunc_equal_jax(nms_mode, device):
    """Every precision mode and ``get_map`` mode, with a cap that cuts."""
    gts, preds = _ragged_data(seed=13)
    for precision_mode in (0, 1, 2):
        port, jax_ = _prfuncs(gts, [preds], device, conf_threshold=0.2,
                              nms_mode=nms_mode,
                              precision_mode=precision_mode, max_per_img=3,
                              version=2)
        _assert_same_curves(port, jax_)


@pytest.mark.parametrize("max_per_img", [4, None, 100])
def test_prfunc_caps_and_ties_at_the_cap(max_per_img):
    """Equal joint confidences across the cap: each path keeps the rows
    its JAX counterpart keeps. (The host path ranks with NumPy's default
    argsort, which is not stable past 16 rows, so at a cap inside a tie
    the two paths may keep different rows, in both packages alike.)"""
    gts, preds = _tied_data()
    kw = dict(conf_threshold=0.3, nms_mode=0, max_per_img=max_per_img,
              version=2)
    for device in (False, True):
        _assert_same_curves(*_prfuncs(gts, [preds], device, **kw))


def test_pr_func_alias_bounds_and_modes():
    gts, preds = _ragged_data()
    with pytest.warns(Warning, match="deprecated"):
        pr = PR_func(gts, preds, class_names=NAMES, version=2)
    assert isinstance(pr, PRfunc)
    with pytest.raises(IndexError):
        pr(0.5, 3)
    with pytest.raises(ValueError):
        pr.get_map("nope")


def test_plot_pr_curve_agg():
    import matplotlib
    matplotlib.use("Agg")
    gts, preds = _ragged_data()
    pr = PRfunc(gts, preds, class_names=NAMES, version=2, device="cpu")
    fig = pr.plot_pr_curve(smooth=True, return_fig=True)
    assert len(fig.axes[0].lines) == len(NAMES)
    fig = pr.plot_pr_curve(class_idx=1, return_fig=True)
    assert len(fig.axes[0].lines) == 1
    with pytest.raises(IndexError):
        pr.plot_pr_curve(class_idx=3)


def test_device_true_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=True runs there")
    gts, preds = _ragged_data()
    with pytest.raises(RuntimeError, match="CUDA"):
        create_score_mat(gts, preds, class_names=NAMES, device=True)


def test_tools_shim_raises():
    with pytest.raises(ImportError, match="tf2_yolo_tpu_torch.utils"):
        port_tools.create_score_mat()


# --- the whole slice ---------------------------------------------------------

ANCHORS = np.stack([np.linspace(0.05, 0.75, 9),
                    np.linspace(0.07, 0.65, 9)], axis=1)


def _calibrate_bn(model, x):
    """BN statistics from the conv outputs on ``x``, as a trained
    network's BN holds them (the v4 init's otherwise shrink the heads)."""
    def hook(bn, out):
        bn.mean.copy_(out[0].mean(dim=(0, 1, 2)))
        bn.var.copy_(out[0].var(dim=(0, 1, 2), unbiased=False))

    handles = [m.conv.register_forward_hook(
        lambda conv, inputs, out, bn=m.bn: hook(bn, out))
        for m in model.modules() if isinstance(m, ConvBN) and m.bn is not None]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()


def test_whole_slice_map_equal_jax():
    """YOLOv4 at 96^2, batch 4, from one JAX init: the port's predictions,
    the same arrays to both packages, give equal mAP on every path. The
    GT boxes are the top predictions of each image, jittered, so that
    there are hits and misses."""
    rng = np.random.RandomState(0)
    x = rng.rand(4, 96, 96, 3).astype(np.float32)
    init = jax.tree_util.tree_map(np.asarray, JaxYoloV4(
        anchors=ANCHORS, class_num=3).init(jax.random.PRNGKey(0),
                                           jnp.asarray(x[:1]), train=False))
    module = YoloV4(ANCHORS, 3, device="cpu").eval()
    module.load_state_dict(from_flax(init), strict=True)
    _calibrate_bn(module, torch.from_numpy(x))
    preds = engine.Model(module, (96, 96, 3), device="cpu").predict(
        x, batch_size=4)
    assert [p.shape[1] for p in preds] == [3, 6, 12]

    # a threshold that leaves each image under the device path's 256
    joint = np.concatenate([
        (p.reshape(4, -1, 8)[..., 4:5] * p.reshape(4, -1, 8)[..., 5:])
        .reshape(4, -1) for p in preds], axis=1)
    threshold = float(np.nextafter(np.sort(joint, axis=1)[:, -200].max(),
                                   np.float32(1)))
    gts = np.zeros((4, 12, 12, 8))
    for i in range(4):
        rows = port_tools.decode(*[p[i] for p in preds], class_num=3,
                                 threshold=threshold, version=4)
        rows = rows[np.argsort(-rows[:, 4] * rows[:, 6])[:4]]
        xy = rows[:, :2] * 96 + rng.uniform(-2, 2, (len(rows), 2))
        half = rows[:, 2:4] * 96 / 2
        corners = np.clip(np.concatenate([xy - half, xy + half], 1), 0, 95)
        encode_to_grid(corners, rows[:, 5].astype(int), (96, 96), (12, 12),
                       3, out=gts[i])
    for nms_mode in (1, 2):
        kw = dict(conf_threshold=threshold, nms_mode=nms_mode,
                  nms_threshold=0.45, version=4)
        host, jhost = _prfuncs(gts, preds, False, **kw)
        dev, jdev = _prfuncs(gts, preds, True, **kw)
        for mode in MAP_MODES:
            want = jhost.get_map(mode)
            for pr in (host, dev, jdev):
                pd.testing.assert_frame_equal(pr.get_map(mode), want)
        assert 0 < jhost.get_map("area").loc["mAP", "ap"] < 1
