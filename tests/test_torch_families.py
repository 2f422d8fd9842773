"""The port's YOLOv3 (Darknet-53 and tiny at 96^2) against the JAX
package's, in f32 on the CPU: the networks (leaves, eval heads), one
training step and the serving program (``tests/helpers_families.py``
sets them up and holds the checks), and the v1, v2 and v3 losses on the
same tensors at 1e-6 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import helpers_families as fam
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu.ops import losses as jlosses
from tf2_yolo_tpu_torch.ops import losses

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["v3_full", "v3_tiny"])
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


# ----------------------------------------------------------------------
def _predictions(rng, version, grids, bbox_num):
    """Head-like outputs: sigmoid xy and conf, positive wh, per-anchor
    softmax (v2) or sigmoid (v3) classes, the v1 layout's softmax class
    tail."""
    outs = []
    for g in grids:
        if version == 1:
            o = rng.rand(2, g, g, 5 * bbox_num + fam.CLASSES)
            tail = np.exp(rng.randn(2, g, g, fam.CLASSES))
            o[..., 5 * bbox_num:] = tail / tail.sum(-1, keepdims=True)
        else:
            o = rng.rand(2, g, g, bbox_num, 5 + fam.CLASSES)
            o[..., 2:4] = np.exp(rng.randn(2, g, g, bbox_num, 2)) * 0.2
            if version == 2:
                p = np.exp(rng.randn(2, g, g, bbox_num, fam.CLASSES))
                o[..., 5:] = p / p.sum(-1, keepdims=True)
            o = o.reshape(2, g, g, -1)
        outs.append(o.astype(np.float32))
    return outs


# (version, grids, anchors, keyword arguments)
LOSS_CASES = {
    "v1": (1, [2], None, {}),
    "v1 weights": (1, [3], None, dict(binary_weight=0.5,
                                      loss_weight=(5, 5, 1, 1))),
    "v2": (2, [4], fam.ANCHORS5, {}),
    "v2 ignore": (2, [3], fam.ANCHORS5, dict(ignore_thresh=0.3,
                                            binary_weight=[0.5, 2.0])),
    "v3": (3, [3, 6, 12], fam.ANCHORS9, {}),
    "v3 focal": (3, [3, 6, 12], fam.ANCHORS9, dict(use_focal_loss=True)),
    "v3 focal no scale": (3, [3, 6], fam.ANCHORS6, dict(
        use_focal_loss=True, focal_loss_gamma=1.5, use_scale=False)),
    "v3 no anchors": (3, [4], None, dict(binary_weight=[0.5, 2.0])),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_its_gradient_match_jax(case):
    """Each loss on the same tensors: the value at 1e-6 relative, d loss
    / d y_pred at 1e-5 of its largest entry."""
    version, grids, anchors, kw = LOSS_CASES[case]
    rng = np.random.RandomState(len(case))
    bbox_num = 2 if version == 1 else (
        5 if version == 2 else (len(anchors) // len(grids)
                                if anchors else 3))
    preds = _predictions(rng, version, grids, bbox_num)
    ys = fam.labels_for(rng, version, grids)
    for i, (y, o) in enumerate(zip(ys, preds)):
        shape = (grids[i],) * 2
        if version == 1:
            jf, tf = (pkg.wrap_yolo_loss_v1(shape, bbox_num, fam.CLASSES,
                                            **kw)
                      for pkg in (jlosses, losses))
        else:
            anc = None if anchors is None else \
                anchors[i * bbox_num:(i + 1) * bbox_num]
            wrap = "wrap_yolo_loss_v2" if version == 2 else \
                "wrap_yolo_loss_v3"
            args = (shape, bbox_num, fam.CLASSES) + (
                (anc,) if version == 2 or anc is not None else ())
            jf, tf = (getattr(pkg, wrap)(*args, **kw)
                      for pkg in (jlosses, losses))
        want, jgrad = jax.jit(jax.value_and_grad(
            lambda p: jf(jnp.asarray(y), p)))(jnp.asarray(o))
        pred = torch.tensor(o, requires_grad=True)
        got = tf(torch.from_numpy(y), pred)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                   err_msg=case)
        jgrad = np.asarray(jgrad)
        np.testing.assert_allclose(pred.grad.numpy(), jgrad, rtol=1e-5,
                                   atol=1e-5 * np.abs(jgrad).max(),
                                   err_msg=case)
