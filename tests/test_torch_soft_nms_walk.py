"""The Soft-NMS kernel's algorithm on the CPU: its transposed lattice and a
walk over its set bits, against the JAX package's ``soft_nms`` and the
port's ``soft_nms_scan_plain``.

The CUDA kernels (``csrc/nms.cu``: ``nms_lattice_kernel<true>`` and
``soft_walk_kernel``) run only on the card, where ``chip_smoke.py`` holds
their lattice words to ``soft_overlap_words_plain`` and their keep mask
to ``soft_nms_keep_plain``. Here :func:`_walk` repeats the walk kernel's
arithmetic in PyTorch: for each box, the earlier boxes of its row's set
bits in ascending order, the pair's IoU, exp(-(iou^2) / sigma) and the
product, in the scan's order.

Tolerances: keep masks, deletions and lattice words are decisions and
compare exactly; the walk's decayed confidences are held to the scan's
bit for bit (a multiplication by 1.0, the scan's factor for a pair that
does not overlap, is exact in f32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tf2_yolo_tpu.ops.nms import soft_nms
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch.ops.geometry import pair_iou
from tf2_yolo_tpu_torch.ops.kernels.nms import (soft_nms_keep,
                                                soft_nms_scan_plain,
                                                soft_overlap_words_plain,
                                                suppression_words_plain)

torch.set_num_threads(1)


def _boxes(rng, k, n_box, classes, n_img=2, spread=0.08):
    """(N, K, 8) clustered rows sorted by joint confidence, the first
    n_box of each image valid."""
    out = np.zeros((n_img, k, 8), np.float32)
    for i in range(n_img):
        rows = rng.rand(n_box, 7).astype(np.float32)
        rows[:, 2:4] = rows[:, 2:4] * 0.3 + 0.2
        rows[:, :2] = 0.5 + rng.randn(n_box, 2) * spread
        rows[:, 5] = rng.randint(0, classes, n_box)
        order = np.argsort(-(rows[:, 4] * rows[:, 6]), kind="stable")
        out[i, :n_box, :7] = rows[order]
        out[i, :n_box, 7] = 1.0
    return out


def _unpack(words, k):
    """(N, K, words) int64 -> (N, K, K) bool, column 64 w + b."""
    u = words.numpy().view(np.uint64)
    bits = (u[..., None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    return torch.from_numpy(bits.astype(bool).reshape(*u.shape[:2], -1)
                            [..., :k].copy())


def _walk(boxes, words, conf_threshold, sigma):
    """The walk kernel's arithmetic: each valid box j multiplies its
    confidence by the decay of each set bit i of its row, in ascending
    i, and is deleted once it falls below ``conf_threshold``. Returns
    (deleted, conf). Rows with fewer bits than the longest are padded
    with steps that change nothing."""
    n, k, _ = boxes.shape
    bits = _unpack(words, k)                         # N, K(j), K(i)
    steps = max(int(bits.sum(-1).max()), 1)
    # set bits first, each row's in ascending i
    order = torch.argsort((~bits).to(torch.int8), dim=-1,
                          stable=True)[..., :steps]
    has = torch.gather(bits, 2, order)
    box_i = torch.gather(boxes[:, None].expand(n, k, k, 8), 2,
                         order[..., None].expand(n, k, steps, 8))
    iou = pair_iou(box_i[..., :4], boxes[:, :, None, :4])   # iou(i, j)
    decay = torch.exp(-(iou * iou) / torch.full_like(iou, sigma))
    conf = boxes[..., 4] * boxes[..., 6]
    deleted = torch.zeros(n, k, dtype=torch.bool)
    for t in range(steps):
        conf = torch.where(has[..., t], conf * decay[..., t], conf)
        deleted = deleted | (has[..., t] & (conf < conf_threshold))
    return deleted, conf


def _check_walk(boxes, conf_threshold, sigma, nms_threshold=0.45):
    """The walk over the plain lattice equals the scan (deletions and
    decayed confidences, bit for bit), the wrapper's keep mask and the
    JAX ``soft_nms``. Returns the keep mask."""
    tb = torch.from_numpy(boxes)
    words = soft_overlap_words_plain(tb, nms_threshold)
    assert words.dtype == torch.int64
    assert words.shape == (*boxes.shape[:2], -(-boxes.shape[1] // 64))
    deleted, conf = _walk(tb, words, conf_threshold, sigma)
    valid, deleted_p, conf_p = soft_nms_scan_plain(tb, nms_threshold,
                                                   conf_threshold, sigma)
    np.testing.assert_array_equal(deleted.numpy(), deleted_p.numpy())
    np.testing.assert_array_equal(conf.numpy().view(np.int32),
                                  conf_p.numpy().view(np.int32))
    keep = (valid & ~deleted).numpy()
    np.testing.assert_array_equal(
        keep, soft_nms_keep(tb, nms_threshold, conf_threshold,
                            sigma).numpy() > 0.5)
    _, jkeep = soft_nms(jnp.asarray(boxes[..., :7]),
                        jnp.asarray(boxes[..., 7] > 0), nms_threshold,
                        conf_threshold, sigma)
    # the JAX function sorts first (stable, invalid rows last): put its
    # mask back in the input's order
    joint = np.where(boxes[..., 7] > 0, boxes[..., 4] * boxes[..., 6],
                     -np.inf)
    order = np.argsort(-joint, axis=1, kind="stable")
    jkeep_in = np.zeros_like(keep)
    np.put_along_axis(jkeep_in, order, np.asarray(jkeep), axis=1)
    np.testing.assert_array_equal(keep, jkeep_in)
    return keep


@pytest.mark.parametrize("sigma", [0.3, 0.5, 0.005])
@pytest.mark.parametrize("k,n_box,classes", [(1, 1, 1), (37, 30, 2),
                                             (130, 100, 3)])
def test_walk_matches_scan_and_jax(k, n_box, classes, sigma):
    """K = 1, K below one word, K past two words (not a multiple of 64)."""
    boxes = _boxes(np.random.RandomState(k + classes), k, n_box, classes)
    keep = _check_walk(boxes, 0.2, sigma)
    if k > 1:
        assert 0 < keep.sum() < boxes[..., 7].sum()


def test_walk_coincident_boxes_underflow():
    """At sigma 0.005 a copy's decay by its original (IoU 1) underflows
    to 0: its confidence is exactly 0 and it is deleted."""
    rng = np.random.RandomState(5)
    base = _boxes(rng, 40, 40, 2, n_img=1)[0, :, :7]
    copies = base.copy()
    copies[:, 4] *= np.float32(0.9)
    rows = np.concatenate([base, copies])
    rows = rows[np.argsort(-(rows[:, 4] * rows[:, 6]), kind="stable")]
    boxes = np.zeros((1, 80, 8), np.float32)
    boxes[0, :, :7] = rows
    boxes[0, :, 7] = 1.0
    tb = torch.from_numpy(boxes)
    _, conf = _walk(tb, soft_overlap_words_plain(tb), 0.2, 0.005)
    assert int((conf == 0).sum()) >= 40
    keep = _check_walk(boxes, 0.2, 0.005)
    assert 0 < keep.sum() <= 40


def test_walk_deleted_box_still_decays():
    """A deletes B; the deleted B still decays C below the threshold,
    which A alone does not overlap enough (IoU 0.38 < 0.45)."""
    boxes = np.zeros((1, 8, 8), np.float32)
    boxes[0, 0, :7] = [0.500, 0.5, 0.2, 0.2, 0.95, 0, 1.0]
    boxes[0, 1, :7] = [0.545, 0.5, 0.2, 0.2, 0.90, 0, 1.0]
    boxes[0, 2, :7] = [0.590, 0.5, 0.2, 0.2, 0.85, 0, 1.0]
    boxes[0, :3, 7] = 1.0
    bits = _unpack(soft_overlap_words_plain(torch.from_numpy(boxes)), 8)
    assert bits[0, 1].tolist()[:3] == [True, False, False]
    assert bits[0, 2].tolist()[:3] == [False, True, False]    # B, not A
    keep = _check_walk(boxes, 0.5, 0.5)
    np.testing.assert_array_equal(keep[0], [1, 0, 0, 0, 0, 0, 0, 0])


def test_walk_invalid_rows_decay_nothing():
    """Invalid rows inside the valid ones: no bit in their row or their
    column, and the walk still equals the scan."""
    boxes = _boxes(np.random.RandomState(21), 100, 100, 2, n_img=2)
    invalid = [3, 10, 11, 64, 65, 99]
    boxes[:, invalid, 7] = 0.0
    words = soft_overlap_words_plain(torch.from_numpy(boxes))
    bits = _unpack(words, 100)
    assert not bits[:, invalid].any() and not bits[:, :, invalid].any()
    keep = _check_walk(boxes, 0.2, 0.5)
    assert not keep[:, invalid].any()


def test_soft_lattice_bit_layout():
    """Row j's words hold exactly its valid, same-class, overlapping
    predecessors; bits past K and at or after j are zero."""
    boxes = np.zeros((1, 70, 8), np.float32)
    boxes[0, :, :7] = [0.5, 0.5, 0.2, 0.2, 0.9, 0, 1.0]
    boxes[0, :, 7] = 1.0
    boxes[0, 65, 5] = 1.0                    # another class
    boxes[0, 68, 7] = 0.0                    # an invalid row
    bits = soft_overlap_words_plain(torch.from_numpy(boxes)).numpy() \
        .view(np.uint64)[0]
    full = np.uint64((1 << 64) - 1)
    assert bits[0].sum() == 0                            # nothing before
    assert bits[1, 0] == 1 and bits[1, 1] == 0           # i = 0
    assert bits[64, 0] == full and bits[64, 1] == 0      # i = 0 .. 63
    assert bits[65].sum() == 0                           # alone in class
    assert bits[68].sum() == 0                           # invalid j
    # i = 64, 66, 67: not 65 (another class) nor 68 (invalid)
    assert bits[69, 0] == full and bits[69, 1] == np.uint64(0b1101)


@pytest.mark.parametrize("k,classes", [(37, 1), (200, 3)])
def test_soft_lattice_is_the_greedy_transposed(k, classes):
    """At IoU the Soft-NMS lattice is the greedy one transposed, with the
    later box's validity added (greedy gates only the suppressor)."""
    boxes = _boxes(np.random.RandomState(40 + k), k, k * 3 // 4, classes)
    boxes[:, k // 2, 7] = 0.0
    tb = torch.from_numpy(boxes)
    greedy = _unpack(suppression_words_plain(tb, 0.45, 1), k)   # (i, j)
    soft = _unpack(soft_overlap_words_plain(tb, 0.45), k)       # (j, i)
    valid = tb[..., 7] != 0
    np.testing.assert_array_equal(
        soft.numpy(), (greedy.transpose(1, 2) & valid[:, :, None]).numpy())
    assert soft.any()
