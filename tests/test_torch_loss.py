"""The port's loss-side geometry and YOLOv4 loss against the JAX
package's, value and gradient, on the same numpy-seeded inputs (f32).

The bound is the one the JAX package holds its own loss to against its
reference (rtol 3e-5): the same f32 formulas, with log/atan/exp from two
libraries and sums taken in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf2_yolo_tpu.ops.geometry import grid_iou as jgrid_iou
from tf2_yolo_tpu.ops.losses import _response_mask as jresponse_mask
from tf2_yolo_tpu.ops.losses import wrap_yolo_loss_v4 as jwrap_yolo_loss_v4
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch.ops.geometry import EPSILON, clip, grid_iou
from tf2_yolo_tpu_torch.ops.losses import _response_mask, wrap_yolo_loss_v4

torch.set_num_threads(1)

RTOL = 3e-5
GRID, BOXES, CLASSES = (6, 5), 3, 3
ANCHORS = np.array([[0.1, 0.15], [0.3, 0.25], [0.6, 0.5]], np.float32)


def _batch(seed, n=4):
    """(y_true, y_pred) as the label encoder and the v4 head make them:
    a few object cells, xy in (0, 1), wh > 0, conf and probs in (0, 1)."""
    rng = np.random.RandomState(seed)
    gh, gw = GRID
    y_true = np.zeros((n, gh, gw, 5 + CLASSES), np.float32)
    for b in range(n):
        for _ in range(3):
            gy, gx = rng.randint(0, gh), rng.randint(0, gw)
            y_true[b, gy, gx, :5] = [*rng.rand(2), *(0.1 + 0.5 * rng.rand(2)),
                                     1.0]
            y_true[b, gy, gx, 5:] = 0.0
            y_true[b, gy, gx, 5 + rng.randint(CLASSES)] = 1.0
    y_pred = rng.rand(n, gh, gw, BOXES, 5 + CLASSES).astype(np.float32)
    y_pred[..., 2:4] = np.exp(rng.randn(n, gh, gw, BOXES, 2) * 0.5) \
        * ANCHORS
    y_pred[..., 4:] = 0.02 + 0.96 * y_pred[..., 4:]
    return y_true, y_pred.reshape(n, gh, gw, -1)


def _assert_close(got, want, tag):
    want = np.asarray(want)
    # atol: 3e-5 of the tensor's scale, for entries that cancel to ~0
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=RTOL * max(1e-3, np.abs(want).max()),
        err_msg=tag)


@pytest.mark.parametrize("ciou", [False, True])
def test_grid_iou_value_and_gradient_match_jax(ciou):
    y_true, y_pred = _batch(0)
    t = y_true.reshape(4, *GRID, 1, -1)[..., :4]
    p = y_pred.reshape(4, *GRID, BOXES, -1)[..., :4]

    def jf(pp):
        out = jgrid_iou(jnp.asarray(t), pp, GRID, return_ciou=ciou)
        return out[1] if ciou else out

    want, vjp = jax.vjp(jf, jnp.asarray(p))
    ct = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    (want_grad,) = vjp(jnp.asarray(ct))

    tp = torch.from_numpy(p).requires_grad_()
    out = grid_iou(torch.from_numpy(t), tp, GRID, return_ciou=ciou)
    got = out[1] if ciou else out
    got.backward(torch.from_numpy(ct))
    _assert_close(got.detach().numpy(), want, "value")
    _assert_close(tp.grad.numpy(), want_grad, "gradient")
    if ciou:
        _assert_close(out[0].detach().numpy(),
                      jgrid_iou(jnp.asarray(t), jnp.asarray(p), GRID), "iou")


@pytest.mark.parametrize("case,kwargs", [
    ("default", {}),
    ("label_smooth", dict(label_smooth=0.1)),
    ("truth_thresh", dict(truth_thresh=0.3, ignore_thresh=0.5)),
    ("weights", dict(binary_weight=0.5, loss_weight=(2.0, 1.0, 0.5),
                     wh_reg_weight=0.05, focal_loss_gamma=3)),
    ("no_anchors", dict(anchors=None)),
    ("clip_bound", {}),
])
def test_yolo_loss_v4_value_and_gradient_match_jax(case, kwargs):
    y_true, y_pred = _batch(2)
    bound_rows = None
    if case == "clip_bound":
        # predictions exactly at, and beyond, both clip bounds, in cells
        # without an object (where the no-object confidence term has a
        # large gradient): the gradient is half at a bound (jnp.clip's
        # convention) and 0 beyond
        flat = y_pred.reshape(-1, 5 + CLASSES)
        empty = np.repeat(y_true.reshape(-1, 5 + CLASSES)[:, 4] == 0, BOXES)
        bound_rows = np.flatnonzero(empty)[:4]
        flat[bound_rows, 4] = [EPSILON, 1 - EPSILON, 0.0, 1.0]
    kw = dict(anchors=ANCHORS, **kwargs) if "anchors" not in kwargs \
        else kwargs
    jloss = jwrap_yolo_loss_v4(GRID, BOXES, CLASSES, **kw)
    want, want_grad = jax.value_and_grad(
        lambda pp: jloss(jnp.asarray(y_true), pp))(jnp.asarray(y_pred))

    tp = torch.from_numpy(y_pred).requires_grad_()
    got = wrap_yolo_loss_v4(GRID, BOXES, CLASSES, **kw)(
        torch.from_numpy(y_true), tp)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    _assert_close(tp.grad.numpy(), want_grad, case)
    if bound_rows is not None:
        got_b = tp.grad.numpy().reshape(-1, 5 + CLASSES)[bound_rows, 4]
        want_b = np.asarray(want_grad).reshape(-1, 5 + CLASSES)[bound_rows, 4]
        np.testing.assert_allclose(got_b, want_b, rtol=RTOL)
        assert want_b[0] != 0 and want_b[1] > 1e4 and not want_b[2:].any()
    if case == "truth_thresh":
        # the case must switch on cells that the response mask leaves off
        iou = jgrid_iou(jnp.asarray(y_true.reshape(4, *GRID, 1, -1)[..., :4]),
                        jnp.asarray(y_pred.reshape(4, *GRID, BOXES, -1)
                                    [..., :4]), GRID)
        assert int((np.asarray(iou) > 0.3).sum()) > 0


@pytest.mark.parametrize("binary_weight", [[0.7], [0.25, 1.0, 2.5]])
def test_yolo_loss_v4_array_binary_weight_matches_jax(binary_weight):
    # an array weight (as utils/tools.get_class_weight gives one) makes
    # the JAX loss an array whose mean is returned; the port follows
    y_true, y_pred = _batch(4)
    bw = np.asarray(binary_weight, np.float32)
    jloss = jwrap_yolo_loss_v4(GRID, BOXES, CLASSES, ANCHORS,
                               binary_weight=bw)
    want, want_grad = jax.value_and_grad(
        lambda pp: jloss(jnp.asarray(y_true), pp))(jnp.asarray(y_pred))
    tp = torch.from_numpy(y_pred).requires_grad_()
    got = wrap_yolo_loss_v4(GRID, BOXES, CLASSES, ANCHORS,
                            binary_weight=bw)(torch.from_numpy(y_true), tp)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    _assert_close(tp.grad.numpy(), want_grad, f"binary_weight {bw}")


def test_yolo_loss_v4_takes_bf16_predictions_in_f32():
    y_true, y_pred = _batch(3)
    loss = wrap_yolo_loss_v4(GRID, BOXES, CLASSES, ANCHORS)
    p16 = torch.from_numpy(y_pred).bfloat16()
    got = loss(torch.from_numpy(y_true), p16)
    assert got.dtype == torch.float32
    # f32 math on the rounded values: equal to the f32 loss of them
    assert got.item() == loss(torch.from_numpy(y_true), p16.float()).item()


def test_response_mask_ties_go_to_the_first_index():
    iou = np.array([[0.2, 0.7, 0.7], [0.5, 0.5, 0.5], [0.0, 0.1, 0.3],
                    [0.9, 0.1, 0.9]], np.float32)
    want = np.asarray(jresponse_mask(jnp.asarray(iou), 3, jnp.float32))
    got = _response_mask(torch.from_numpy(iou)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.argmax(-1), [1, 0, 2, 0])


def test_clip_gradient_matches_jnp_clip():
    x = np.array([EPSILON, 1 - EPSILON, 0.5, 0.0, 1.0, -15.0, 15.0, 16.0],
                 np.float32)
    for lo, hi in ((EPSILON, 1 - EPSILON), (-15.0, 15.0)):
        want = jax.grad(lambda v: jnp.sum(jnp.clip(v, lo, hi)))(
            jnp.asarray(x))
        t = torch.from_numpy(x).requires_grad_()
        out = clip(t, lo, hi)
        out.sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            out.detach().numpy(), np.asarray(jnp.clip(jnp.asarray(x), lo, hi)))
    assert 0.5 in t.grad.tolist()
