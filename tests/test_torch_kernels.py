"""The port's kernel wrappers on the CPU (their plain versions) against
the JAX package's Pallas kernels in interpret mode.

``conv_bn_stats`` is held to ``conv1x1_stats`` / ``conv3x3_stats`` and
``nms_keep`` to ``nms_pallas`` and ``nms_scan``. The CUDA kernels
themselves run only on the card, through ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tf2_yolo_tpu.ops.nms import nms_scan
from tf2_yolo_tpu.ops.pallas import nms_pallas
from tf2_yolo_tpu.ops.pallas.conv_bn_kernel import (conv1x1_stats,
                                                    conv3x3_stats)
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch.ops.kernels import (conv_bn_stats, nms_keep,
                                            nms_keep_plain)

torch.set_num_threads(1)

# the bound the JAX package holds its own kernels to against XLA
# (tests/test_pallas_convbn.py): f32 sums of up to 9*Ci products taken
# in another order
RTOL, ATOL = 2e-5, 1e-5


def _conv_case(seed, shape_x, shape_w):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape_x).astype(np.float32)
    w = (rng.randn(*shape_w) * 0.1).astype(np.float32)
    b = (rng.randn(shape_w[-1]) * 0.1).astype(np.float32)
    return x, w, b


def _assert_conv_close(got, want, tag):
    for g, w_, name in zip(got, want, ("y", "s1", "s2")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{tag}/{name}")


@pytest.mark.parametrize("n,h,w,ci,co", [
    (2, 8, 8, 16, 32),
    (3, 7, 5, 8, 8),        # uneven M
    (2, 13, 13, 16, 8),     # unaligned W (the 52/26/13 stages)
])
def test_conv1x1_matches_pallas(n, h, w, ci, co):
    x, k, b = _conv_case(0, (n, h, w, ci), (1, 1, ci, co))
    before = conv_bn_stats.launches
    got = conv_bn_stats(torch.from_numpy(x), torch.from_numpy(k),
                        torch.from_numpy(b), 1, want_stats=True)
    want = conv1x1_stats(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    _assert_conv_close(got, want, f"1x1 {n}x{h}x{w}x{ci}->{co}")
    # a CPU tensor takes the plain version, which is not a launch
    assert conv_bn_stats.launches == before


@pytest.mark.parametrize("stride,n,h,w,ci,co", [
    (1, 2, 8, 8, 8, 16),
    (1, 1, 12, 8, 3, 8),    # stem: 3 input channels
    (1, 2, 13, 13, 8, 16),  # unaligned W
    (2, 2, 8, 8, 8, 16),    # darknet top/left pad
    (2, 1, 12, 6, 4, 8),
])
def test_conv3x3_matches_pallas(stride, n, h, w, ci, co):
    x, k, b = _conv_case(1, (n, h, w, ci), (3, 3, ci, co))
    got = conv_bn_stats(torch.from_numpy(x), torch.from_numpy(k),
                        torch.from_numpy(b), stride, want_stats=True)
    want = conv3x3_stats(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                         stride)
    _assert_conv_close(got, want, f"3x3s{stride}")


def test_conv_without_stats_returns_same_y():
    x, k, b = _conv_case(2, (2, 8, 8, 4), (3, 3, 4, 8))
    args = (torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), 2)
    y, s1, s2 = conv_bn_stats(*args, want_stats=False)
    assert s1 is None and s2 is None
    assert torch.equal(y, conv_bn_stats(*args, want_stats=True)[0])


@pytest.mark.parametrize("case", ["geometry", "odd_stride2", "dtype",
                                  "channels", "strided", "device"])
def test_conv_wrapper_rejects(case):
    x = torch.zeros(1, 6, 6, 4)
    w = torch.zeros(3, 3, 4, 8)
    b = torch.zeros(8)
    stride = 1
    err = ValueError
    if case == "geometry":
        w = torch.zeros(5, 5, 4, 8)
    elif case == "odd_stride2":
        x, stride = torch.zeros(1, 5, 6, 4), 2
    elif case == "dtype":
        x, err = x.double(), TypeError
    elif case == "channels":
        w = torch.zeros(3, 3, 2, 8)
    elif case == "strided":
        x = torch.zeros(1, 6, 6, 8)[..., ::2]
    elif case == "device":
        x, w, b = x.to("meta"), w.to("meta"), b.to("meta")
    with pytest.raises(err):
        conv_bn_stats(x, w, b, stride)


def _sorted_boxes(rng, n_img=2, n_box=20, k=128, classes=2):
    """Clustered rows -> (N, K, 8) [x,y,w,h,conf,cls,prob,valid] sorted by
    joint confidence, as tests/test_pallas_nms.py builds them."""
    out = np.zeros((n_img, k, 8), np.float32)
    for i in range(n_img):
        rows = rng.rand(n_box, 7)
        rows[:, 2:4] = rows[:, 2:4] * 0.3 + 0.2
        rows[:, :2] = 0.5 + rng.randn(n_box, 2) * 0.08
        rows[:, 5] = rng.randint(0, classes, n_box)
        order = np.argsort(-(rows[:, 4] * rows[:, 6]))
        out[i, :n_box, :7] = rows[order]
        out[i, :n_box, 7] = 1.0
    return out


@pytest.mark.parametrize("iou_mode", [1, 2])
@pytest.mark.parametrize("k,n_box,classes", [(128, 20, 2), (768, 200, 3)])
def test_nms_keep_matches_pallas_and_scan(iou_mode, k, n_box, classes):
    boxes = _sorted_boxes(np.random.RandomState(k + iou_mode), n_box=n_box,
                          k=k, classes=classes)
    got = nms_keep(torch.from_numpy(boxes), 0.45, iou_mode).numpy()
    want = np.asarray(nms_pallas(jnp.asarray(boxes), threshold=0.45,
                                 iou_mode=iou_mode, interpret=True))
    # keep masks are decisions: exactly equal
    np.testing.assert_array_equal(got, want)
    _, scan_keep = nms_scan(jnp.asarray(boxes[..., :7]),
                            jnp.asarray(boxes[..., 7] > 0), 0.45,
                            iou_mode=iou_mode)
    np.testing.assert_array_equal(got > 0.5, np.asarray(scan_keep))
    assert 0 < got.sum() < boxes[..., 7].sum()


def test_nms_keep_chain_semantics():
    base = np.zeros((1, 128, 8), np.float32)
    base[0, 0, :7] = [0.50, 0.50, 0.20, 0.20, 0.9, 0, 1.0]
    base[0, 1, :7] = [0.58, 0.50, 0.20, 0.20, 0.8, 0, 1.0]
    base[0, 2, :7] = [0.66, 0.50, 0.20, 0.20, 0.7, 0, 1.0]
    base[0, :3, 7] = 1.0
    keep = nms_keep(torch.from_numpy(base), 0.4).numpy()
    # A kills B; suppressed B must not kill C; padding rows stay dead
    np.testing.assert_array_equal(keep[0, :3], [1, 0, 1])
    assert keep[0, 3:].sum() == 0
    want = np.asarray(nms_pallas(jnp.asarray(base), threshold=0.4,
                                 interpret=True))
    np.testing.assert_array_equal(keep, want)


def test_nms_keep_takes_any_k():
    """No multiple-of-128 padding: K = 37 gives the padded answer."""
    boxes = _sorted_boxes(np.random.RandomState(7), n_box=30, k=128)
    short = nms_keep_plain(torch.from_numpy(boxes[:, :37].copy()))
    full = nms_keep_plain(torch.from_numpy(boxes))
    assert torch.equal(short, full[:, :37])


@pytest.mark.parametrize("case", ["shape", "dtype", "iou_mode", "device"])
def test_nms_wrapper_rejects(case):
    boxes = torch.zeros(1, 16, 8)
    mode, err = 1, ValueError
    if case == "shape":
        boxes = torch.zeros(1, 16, 7)
    elif case == "dtype":
        boxes, err = boxes.double(), TypeError
    elif case == "iou_mode":
        mode = 3
    elif case == "device":
        boxes = boxes.to("meta")
    with pytest.raises(err):
        nms_keep(boxes, 0.45, mode)
