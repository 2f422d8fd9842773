"""The port's evaluation matching (``ops/evalmatch.py``) against the JAX
package's, on the CPU.

The same seeded numpy rows go to ``match_counts`` and ``match_pred_arrays``
of both packages. Counts, classes, hits and best-GT indices are integers
or decisions and compare exactly; ``joint_conf`` is the same f32 product
and compares bit for bit. The rows include exact ties (repeated GT
boxes), where the best GT must be the first maximum, as ``np.argmax``
picks it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tf2_yolo_tpu.ops import evalmatch as jevalmatch
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch.ops import match_counts, match_pred_arrays

torch.set_num_threads(1)

B, T, P, CLASSES = 4, 8, 16, 3


def _rows(rng, n, classes):
    rows = np.zeros((B, n, 7), np.float32)
    rows[..., :2] = rng.rand(B, n, 2) * 0.6 + 0.2
    rows[..., 2:4] = rng.rand(B, n, 2) * 0.3 + 0.1
    rows[..., 4] = rng.rand(B, n)
    rows[..., 5] = rng.randint(0, classes, (B, n))
    rows[..., 6] = rng.rand(B, n)
    return rows


def _case(seed):
    """GT and prediction rows with invalid rows, an image with no valid
    GT, repeated GT boxes (ties) and predictions on top of GTs."""
    rng = np.random.RandomState(seed)
    t_rows, p_rows = _rows(rng, T, CLASSES), _rows(rng, P, CLASSES)
    t_valid = rng.rand(B, T) < 0.8
    p_valid = rng.rand(B, P) < 0.85
    t_valid[3] = False                       # an image without GTs
    # ties: GT 5 repeats GT 2 (box and class), GT 6 repeats GT 5
    t_rows[:, 5] = t_rows[:, 2]
    t_rows[:, 6] = t_rows[:, 5]
    t_valid[:2, [2, 5, 6]] = True
    # predictions on GT boxes: exact (IoU 1) or jittered, some of
    # another class
    for p, t in ((0, 2), (1, 5), (2, 0), (3, 1), (4, 4)):
        p_rows[:, p, :4] = t_rows[:, t, :4]
        p_rows[:, p, 5] = t_rows[:, t, 5]
    p_rows[:, 3, :2] += 0.01
    p_rows[:, 4, 5] = (t_rows[:, 4, 5] + 1) % CLASSES
    return t_rows, t_valid, p_rows, p_valid


def _both(fn_port, fn_jax, case, *args):
    t_rows, t_valid, p_rows, p_valid = case
    got = fn_port(torch.from_numpy(t_rows), torch.from_numpy(t_valid),
                  torch.from_numpy(p_rows), torch.from_numpy(p_valid), *args)
    want = fn_jax(jnp.asarray(t_rows), jnp.asarray(t_valid),
                  jnp.asarray(p_rows), jnp.asarray(p_valid), *args)
    assert got.keys() == want.keys()
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("iou_threshold", [0.3, 0.5, 0.9])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_counts_equal_jax(seed, iou_threshold):
    got, want = _both(
        lambda *a: match_counts(*a, CLASSES, iou_threshold),
        lambda *a: jevalmatch.match_counts(*a, CLASSES, iou_threshold),
        _case(seed))
    for key in want:
        assert got[key].dtype == np.int32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["tpp"].sum() > 0 and (got["tp"] <= got["tpp"]).all()


@pytest.mark.parametrize("iou_threshold", [0.3, 0.5, 0.9])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_pred_arrays_equal_jax(seed, iou_threshold):
    got, want = _both(
        lambda *a: match_pred_arrays(*a, iou_threshold),
        lambda *a: jevalmatch.match_pred_arrays(*a, iou_threshold),
        _case(seed))
    for key in ("cls", "best_gt"):
        assert got[key].dtype == np.int32, key
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(got["joint_conf"].view(np.int32),
                                  want["joint_conf"].view(np.int32))


def test_best_gt_is_the_first_of_tied_maxima():
    """Three identical GTs (2, 5, 6): a prediction on them matches GT 2
    in both packages, as np.argmax over the class subset would."""
    case = _case(0)
    got, want = _both(lambda *a: match_pred_arrays(*a, 0.5),
                      lambda *a: jevalmatch.match_pred_arrays(*a, 0.5),
                      case)
    for img in (0, 1):
        assert got["best_gt"][img, 0] == 2 and got["best_gt"][img, 1] == 2
        assert got["hit"][img, 0] and got["hit"][img, 1]
    np.testing.assert_array_equal(got["best_gt"], want["best_gt"])


def test_no_valid_rows():
    t_rows, t_valid, p_rows, p_valid = _case(3)
    t_valid[:], p_valid[:] = False, False
    got = match_counts(torch.from_numpy(t_rows), torch.from_numpy(t_valid),
                       torch.from_numpy(p_rows), torch.from_numpy(p_valid),
                       CLASSES, 0.5)
    for key, value in got.items():
        assert value.shape == (B, CLASSES) and not value.any(), key
