"""The port's NMS layer on the CPU against the JAX package's.

``soft_nms_keep`` (its plain version here) is held to ``soft_nms`` and
``apply_nms_device(nms_mode=2)``; the greedy kernel's bit layout, through
its plain mirror ``suppression_words_plain`` and a scan over the words
written as the scan kernel walks them, to ``nms_keep_plain`` and
``nms_scan``; ``_plan`` over the edges of K. The CUDA kernels themselves
run only on the card, through ``chip_smoke.py``.

Tolerances: keep masks are decisions and compare exactly; rows are input
rows reordered and compare exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tf2_yolo_tpu.ops.nms import apply_nms_device as japply_nms
from tf2_yolo_tpu.ops.nms import nms_scan, soft_nms
from tf2_yolo_tpu.utils import soft_nms as host_soft_nms
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch.ops.kernels import nms as nms_mod
from tf2_yolo_tpu_torch.ops.kernels.nms import (MAX_K, SMEM_LIMIT, _plan,
                                                nms_keep, nms_keep_plain,
                                                soft_nms_keep,
                                                soft_nms_keep_plain,
                                                suppression_words_plain)
from tf2_yolo_tpu_torch.ops.nms import apply_nms_device

torch.set_num_threads(1)


def _sorted_boxes(rng, k, n_box, classes, n_img=2, spread=0.08):
    """Clustered rows -> (N, K, 8) [x,y,w,h,conf,cls,prob,valid] sorted by
    joint confidence, the first n_box of each image valid."""
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


def _jax_rows_valid(boxes):
    return jnp.asarray(boxes[..., :7]), jnp.asarray(boxes[..., 7] > 0)


# --- Soft-NMS -------------------------------------------------------------

@pytest.mark.parametrize("conf_threshold", [0.2, 0.5])
@pytest.mark.parametrize("sigma", [0.3, 0.5])
@pytest.mark.parametrize("classes", [1, 3])
@pytest.mark.parametrize("k,n_box", [(37, 30), (128, 60), (768, 300)])
def test_soft_nms_keep_plain_matches_jax(k, n_box, classes, sigma,
                                         conf_threshold):
    boxes = _sorted_boxes(np.random.RandomState(k + classes), k, n_box,
                          classes)
    got = soft_nms_keep(torch.from_numpy(boxes), 0.45, conf_threshold,
                        sigma).numpy()
    rows, keep = soft_nms(*_jax_rows_valid(boxes), 0.45, conf_threshold,
                          sigma)
    # the rows arrive sorted: the JAX sort leaves them in place
    np.testing.assert_array_equal(np.asarray(rows), boxes[..., :7])
    np.testing.assert_array_equal(got > 0.5, np.asarray(keep))
    np.testing.assert_array_equal(got, got.astype(bool))
    # boxes really are deleted, and not all of them
    assert 0 < got.sum() < boxes[..., 7].sum()


@pytest.mark.parametrize("classes", [1, 3])
def test_soft_nms_small_sigma_deletes_coincident_boxes(classes):
    """At sigma 0.005 a box's decay by its copy, exp(-(iou^2) / sigma)
    with IoU 1, underflows to 0 in f32: the copy's confidence becomes 0
    and it is deleted, as in the JAX scan."""
    rng = np.random.RandomState(50 + classes)
    base = rng.rand(30, 7).astype(np.float32)
    base[:, :2] = 0.5 + rng.randn(30, 2) * 0.08
    base[:, 2:4] = base[:, 2:4] * 0.3 + 0.2
    base[:, 5] = rng.randint(0, classes, 30)
    copies = base.copy()
    copies[:, 4] *= np.float32(0.9)
    rows = np.concatenate([base, copies])
    rows = rows[np.argsort(-(rows[:, 4] * rows[:, 6]), kind="stable")]
    boxes = np.zeros((1, 64, 8), np.float32)
    boxes[0, :60, :7] = rows
    boxes[0, :60, 7] = 1.0
    tb = torch.from_numpy(boxes)
    valid, deleted, conf = nms_mod.soft_nms_scan_plain(tb, 0.45, 0.2, 0.005)
    # every copy decays to exactly 0 (its original comes first)
    assert int((valid & (conf == 0)).sum()) >= 30
    got = soft_nms_keep(tb, 0.45, 0.2, 0.005).numpy()
    _, keep = soft_nms(*_jax_rows_valid(boxes), 0.45, 0.2, 0.005)
    np.testing.assert_array_equal(got > 0.5, np.asarray(keep))
    assert 0 < got.sum() <= 30


def _soft_chain_boxes():
    """A kills B; deleted B still decays C below the threshold; A alone
    does not overlap C enough to decay it (IoU 0.38 < 0.45)."""
    boxes = np.zeros((1, 8, 8), np.float32)
    boxes[0, 0, :7] = [0.500, 0.5, 0.2, 0.2, 0.95, 0, 1.0]
    boxes[0, 1, :7] = [0.545, 0.5, 0.2, 0.2, 0.90, 0, 1.0]
    boxes[0, 2, :7] = [0.590, 0.5, 0.2, 0.2, 0.85, 0, 1.0]
    boxes[0, :3, 7] = 1.0
    return boxes


def test_soft_nms_decay_by_deleted_boxes():
    boxes = _soft_chain_boxes()
    keep = soft_nms_keep(torch.from_numpy(boxes), 0.45, 0.5, 0.5).numpy()
    # C falls only because the deleted B decays it: greedy NMS keeps it
    np.testing.assert_array_equal(keep[0], [1, 0, 0, 0, 0, 0, 0, 0])
    greedy = nms_keep(torch.from_numpy(boxes), 0.45).numpy()
    np.testing.assert_array_equal(greedy[0, :3], [1, 0, 1])
    _, jkeep = soft_nms(*_jax_rows_valid(boxes), 0.45, 0.5, 0.5)
    np.testing.assert_array_equal(keep > 0.5, np.asarray(jkeep))
    host = host_soft_nms(boxes[0, :3, :7], class_num=1, nms_threshold=0.45,
                         conf_threshold=0.5, sigma=0.5)
    np.testing.assert_array_equal(np.asarray(host, np.float32),
                                  boxes[0, :1, :7])


def test_soft_nms_matches_host_fixture():
    """The fixture of the JAX package's device-against-host Soft-NMS test
    (tests/test_device_decode_nms.py), through the port's dispatch."""
    rng = np.random.RandomState(4)
    base = rng.rand(6, 7)
    base[:, 2:4] = base[:, 2:4] * 0.3 + 0.2
    base[:, :2] = 0.5 + rng.randn(6, 2) * 0.05
    base[:, 4] = rng.rand(6) * 0.5 + 0.5
    base[:, 5] = 0
    base[:, 6] = 1.0
    rows = np.zeros((1, 32, 7), np.float32)
    rows[0, :6] = base
    valid = np.zeros((1, 32), bool)
    valid[0, :6] = True
    trows, tkeep = apply_nms_device(torch.from_numpy(rows),
                                    torch.from_numpy(valid), nms_mode=2,
                                    nms_threshold=0.45, conf_threshold=0.5,
                                    nms_sigma=0.5)
    got = trows.numpy()[0][tkeep.numpy()[0]]
    host = np.asarray(host_soft_nms(base.astype(np.float32), class_num=1,
                                    nms_threshold=0.45, conf_threshold=0.5,
                                    sigma=0.5), np.float32)
    assert 0 < len(got) < 6
    key = lambda r: r[np.lexsort(r.T[::-1])]             # noqa: E731
    np.testing.assert_allclose(key(got), key(host), rtol=1e-6, atol=0)


@pytest.mark.parametrize("sigma", [0.3, 0.5])
def test_apply_nms_device_soft_matches_jax(sigma):
    rng = np.random.RandomState(21)
    rows = np.zeros((2, 128, 7), np.float32)
    rows[:, :60] = rng.rand(2, 60, 7)
    rows[:, :60, :2] = 0.5 + rng.randn(2, 60, 2) * 0.1
    rows[:, :60, 2:4] = rows[:, :60, 2:4] * 0.3 + 0.2
    rows[:, :60, 5] = rng.randint(0, 3, (2, 60))
    valid = np.zeros((2, 128), bool)
    valid[:, :55] = True
    jr, jk = japply_nms(jnp.asarray(rows), jnp.asarray(valid), nms_mode=2,
                        nms_threshold=0.45, conf_threshold=0.3,
                        nms_sigma=sigma)
    tr, tk = apply_nms_device(torch.from_numpy(rows),
                              torch.from_numpy(valid), nms_mode=2,
                              nms_threshold=0.45, conf_threshold=0.3,
                              nms_sigma=sigma)
    assert tk.dtype == torch.bool
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < tk.sum() < valid.sum()


# --- the greedy kernel's plan and bit layout -------------------------------

@pytest.mark.parametrize("k", [1, 31, 32, 33, 63, 64, 65, 127, 128, 129,
                               1024, 1025, 1344, 1345, MAX_K])
def test_plan_over_the_edges_of_k(k):
    n = 8
    plan = _plan(n, k)
    assert plan.words == -(-k // 64)
    assert (plan.words - 1) * 64 < k <= plan.words * 64
    assert plan.scan_grid == n
    # the scan's shared memory: the alive words and each row's own word
    assert plan.smem_bytes == plan.words * 8 + 8 * k <= SMEM_LIMIT
    words, tiles, images = plan.lattice_grid
    assert (words, images) == (plan.words, n)
    assert (tiles - 1) * 16 < k <= tiles * 16
    assert plan.scratch_bytes == n * k * plan.words * 8


@pytest.mark.parametrize("n,k", [(1, 0), (1, MAX_K + 1), (0, 128),
                                 (65536, 128)])
def test_plan_rejects(n, k):
    with pytest.raises(ValueError):
        _plan(n, k)


def _scan_words(words, valid, k):
    """The scan kernel's walk over packed words, one image: the alive
    words start as the valid boxes; word by word, its 64 boxes are walked
    in order, an alive one kept and clearing from the word the boxes its
    row's own word holds; then the kept boxes' rows clear the later
    words. Returns the keep mask."""
    n_words = words.shape[1]
    mask = (1 << 64) - 1
    rows = [[int(v) & mask for v in row] for row in words]
    alive = [0] * n_words
    for j in np.flatnonzero(valid):
        alive[int(j) // 64] |= 1 << (int(j) % 64)
    for wk in range(n_words):
        kept = alive[wk]
        for b in range(64):
            if kept >> b & 1:
                kept &= ~rows[min(wk * 64 + b, k - 1)][wk] & mask
        alive[wk] = kept
        for b in range(64):
            if kept >> b & 1:
                for w in range(wk + 1, n_words):
                    alive[w] &= ~rows[wk * 64 + b][w] & mask
    return np.array([(alive[j // 64] >> (j % 64)) & 1 for j in range(k)],
                    np.float32)


@pytest.mark.parametrize("iou_mode", [1, 2])
@pytest.mark.parametrize("k,n_box,classes", [(37, 30, 1), (128, 60, 2),
                                             (768, 300, 3)])
def test_suppression_words_scan_matches_plain_and_jax(k, n_box, classes,
                                                      iou_mode):
    boxes = _sorted_boxes(np.random.RandomState(2 * k + iou_mode), k, n_box,
                          classes)
    tb = torch.from_numpy(boxes)
    words = suppression_words_plain(tb, 0.45, iou_mode)
    assert words.dtype == torch.int64
    assert words.shape == (2, k, -(-k // 64))
    plain = nms_keep_plain(tb, 0.45, iou_mode).numpy()
    _, scan_keep = nms_scan(*_jax_rows_valid(boxes), 0.45,
                            iou_mode=iou_mode)
    bits = words.numpy().view(np.uint64)
    for img in range(2):
        # bit b of word w of row i is the pair (i, 64 w + b); none past K
        unpacked = ((bits[img][..., None] >> np.arange(64, dtype=np.uint64))
                    & np.uint64(1)).reshape(k, -1)
        assert not unpacked[:, k:].any()
        keep = _scan_words(words[img].numpy(), boxes[img, :, 7] > 0, k)
        np.testing.assert_array_equal(keep, plain[img])
        np.testing.assert_array_equal(keep > 0.5, np.asarray(scan_keep)[img])
    assert 0 < plain.sum() < boxes[..., 7].sum()


def test_suppression_words_bit_layout():
    """Row i's word holds exactly the boxes i suppresses: a kept box's
    class-mates that overlap it and come after it."""
    boxes = np.zeros((1, 70, 8), np.float32)
    boxes[0, :, :7] = [0.5, 0.5, 0.2, 0.2, 0.9, 0, 1.0]
    boxes[0, :, 7] = 1.0
    boxes[0, 65, 5] = 1.0                    # another class
    boxes[0, 68, 7] = 0.0                    # an invalid row
    words = suppression_words_plain(torch.from_numpy(boxes)).numpy()
    bits = words.view(np.uint64)[0]
    full = np.uint64((1 << 64) - 1)
    assert bits[0, 0] == full - np.uint64(1)             # j = 1 .. 63
    # j = 64 .. 69 but 65 (another class); the invalid j = 68 is set:
    # validity gates the suppressor, keep gates the rest
    assert bits[0, 1] == np.uint64(0b111101)
    assert bits[68].sum() == 0                           # invalid i
    assert bits[69].sum() == 0                           # nothing after
    assert bits[63, 0] == 0


# --- the wrappers' checks ---------------------------------------------------

@pytest.mark.parametrize("case", ["shape", "dtype", "device", "strided",
                                  "k_past_max"])
def test_soft_nms_wrapper_rejects(case):
    boxes, err = torch.zeros(1, 16, 8), ValueError
    if case == "shape":
        boxes = torch.zeros(1, 16, 7)
    elif case == "dtype":
        boxes, err = boxes.double(), TypeError
    elif case == "device":
        boxes = boxes.to("meta")
    elif case == "strided":
        boxes = torch.zeros(1, 16, 16)[..., ::2]
    elif case == "k_past_max":
        boxes = torch.zeros(1, MAX_K + 1, 8)
    with pytest.raises(err):
        soft_nms_keep(boxes, 0.45, 0.5, 0.5)


def test_nms_wrapper_rejects_k_past_max():
    with pytest.raises(ValueError, match=str(MAX_K)):
        nms_keep(torch.zeros(1, MAX_K + 1, 8), 0.45, 1)


def test_cpu_tensors_launch_nothing():
    boxes = torch.from_numpy(_sorted_boxes(np.random.RandomState(3), 64, 40,
                                           2))
    before = nms_keep.launches, soft_nms_keep.launches
    nms_keep(boxes, 0.45, 1)
    soft_nms_keep(boxes, 0.45, 0.5, 0.5)
    assert (nms_keep.launches, soft_nms_keep.launches) == before
