"""Class-wise NMS keep masks over confidence-sorted boxes: greedy and Soft.

Both take (N, K, 8) f32 rows ``[x, y, w, h, conf, cls, prob, valid]``,
each image sorted by joint confidence descending, and return an (N, K)
f32 {0, 1} keep mask.

- ``nms_keep(boxes, threshold, iou_mode)``: box j is dropped when an
  earlier, valid, still-kept box of the same class overlaps it by at
  least ``threshold`` (IoU, or DIoU for ``iou_mode=2``).
- ``soft_nms_keep(boxes, nms_threshold, conf_threshold, sigma)``: every
  valid box decays each later valid box of its class that it overlaps by
  IoU >= ``nms_threshold`` by ``exp(-(iou^2) / sigma)``, deleted or not;
  a decayed box whose confidence falls below ``conf_threshold`` is
  deleted.

Source note. On a CUDA tensor both launch ``csrc/nms.cu``. The greedy
kernel replaces the Pallas TPU kernel ``nms_pallas``
(tf2_yolo_tpu/ops/pallas/nms_kernel.py): it builds the suppression
lattice as 64-bit words across the card (:func:`suppression_words_plain`
is its plain mirror) into global scratch, then one block per image scans
it word by word: one thread walks the word's 64 boxes, kept or not, and
the block clears the later words by the kept boxes' rows. :func:`_plan`
sizes the two launches. Soft-NMS, which has no Pallas counterpart (the
JAX package scans, ``_soft_nms_single`` in tf2_yolo_tpu/ops/nms.py),
builds the same lattice transposed (:func:`soft_overlap_words_plain` is
its plain mirror): row j's words hold the earlier boxes i that overlap
it. Then a thread per box walks its own set bits in ascending i and
decays its confidence in the scan's order, so each box's chain is as
long as its overlaps. Both calls are two launches sized by
:func:`_plan`. K is limited to ``MAX_K``, not by the TPU kernel's K <=
1024 cap or its multiple-of-128 padding. On a CPU tensor they
compute :func:`nms_keep_plain` (the semantics of ``nms_scan``) and
:func:`soft_nms_keep_plain` (``soft_nms``'s scan, step by step).

Both wrappers call custom ops (``tf2_yolo_tpu_torch::nms_keep``,
``::soft_nms_keep``; their fake implementations give the shape), so a
program traced by ``torch.export`` calls the kernels, or on the CPU the
plain versions.
"""

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import pair_iou
from ._build import load_library

SOURCE = ("nms.cu", ("--fmad=false",))   # source and extra nvcc flags
# shared memory a block may opt into on an H100 (227 KB)
SMEM_LIMIT = 232448
# the largest K: that of the first greedy kernel (227 KB of shared memory
# at 36 bytes a box), kept so that no K it took is refused now; the
# card's check runs it
MAX_K = 6456
WORD_BITS = 64
_TILE_ROWS = 16          # rows of a lattice block (TILE_ROWS in nms.cu)
_MAX_GRID_YZ = 65535


class Plan(NamedTuple):
    """How one call launches: ``words`` 64-bit words per lattice row;
    ``lattice_grid`` (words, row tiles, N) of the lattice kernel;
    ``scan_grid`` blocks of the greedy scan kernel (one per image);
    ``smem_bytes`` of the scan kernel's dynamic shared memory (the alive
    words and each row's own word); ``scratch_bytes`` of the global
    lattice. Soft-NMS takes ``words``, ``lattice_grid`` and
    ``scratch_bytes``; its walk has a thread a box."""
    words: int
    lattice_grid: tuple
    scan_grid: int
    smem_bytes: int
    scratch_bytes: int


def _plan(n, k):
    """The launch plan of ``nms_keep`` and ``soft_nms_keep`` for N images
    of K boxes (pure Python: the CPU tests reach it)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k}: the NMS kernels take 1 <= K <= {MAX_K}")
    if not 1 <= n <= _MAX_GRID_YZ:
        raise ValueError(f"N={n}: the NMS kernels take 1 <= N <= "
                         f"{_MAX_GRID_YZ}")
    words = -(-k // WORD_BITS)
    smem = words * 8 + k * 8
    assert smem <= SMEM_LIMIT
    return Plan(words, (words, -(-k // _TILE_ROWS), n), n, smem,
                n * k * words * 8)


def _check(boxes, iou_mode=1):
    if boxes.dim() != 3 or boxes.shape[-1] != 8 or boxes.shape[1] == 0:
        raise ValueError(f"want boxes (N, K, 8), got {tuple(boxes.shape)}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"want float32 boxes, got {boxes.dtype}")
    if not boxes.is_contiguous():
        raise ValueError("boxes must be contiguous")
    if iou_mode not in (1, 2):
        raise ValueError(f"iou_mode must be 1 (IoU) or 2 (DIoU), "
                         f"got {iou_mode}")


def _check_wrapper(boxes, name):
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for {boxes.device}")
    if boxes.shape[1] > MAX_K:
        raise ValueError(f"K={boxes.shape[1]} boxes: the {name} kernel "
                         f"takes K <= {MAX_K}")


def _suppression(boxes, threshold, iou_mode):
    """(N, K(i), K(j)) bool: i suppresses j when i is still alive."""
    k = boxes.shape[1]
    overlap = pair_iou(boxes[:, :, None, :4], boxes[:, None, :, :4],
                       mode=iou_mode)                      # N, K(i), K(j)
    same_class = boxes[:, :, None, 5] == boxes[:, None, :, 5]
    later = torch.ones(k, k, dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    valid = boxes[..., 7] != 0
    return (overlap >= threshold) & same_class & later & valid[:, :, None]


def nms_keep_plain(boxes, threshold=0.45, iou_mode=1):
    """Plain PyTorch version: the (N, K, K) suppression lattice, then the
    greedy scan as a loop over K."""
    _check(boxes, iou_mode)
    n, k, _ = boxes.shape
    suppress = _suppression(boxes, threshold, iou_mode)
    alive = torch.ones(n, k, dtype=torch.bool, device=boxes.device)
    for i in range(k):
        alive = alive & ~(suppress[:, i] & alive[:, i:i + 1])
    return alive.to(torch.float32) * boxes[..., 7]


def _pack_words(bits):
    """(N, K, K) bool -> (N, K, words) int64: bit b of word w of row r is
    column 64 w + b; bits past K are zero."""
    n, k, _ = bits.shape
    words = -(-k // WORD_BITS)
    padded = torch.zeros(n, k, words * WORD_BITS, dtype=torch.int64,
                         device=bits.device)
    padded[..., :k] = bits.to(torch.int64)
    weights = torch.from_numpy(np.left_shift(
        np.uint64(1), np.arange(WORD_BITS, dtype=np.uint64)).view(np.int64))
    # distinct bits: the int64 sum is their OR, bit 63 as the sign
    return (padded.view(n, k, words, WORD_BITS)
            * weights.to(bits.device)).sum(-1)


def suppression_words_plain(boxes, threshold=0.45, iou_mode=1):
    """The greedy kernel's lattice as it lies in scratch: (N, K, words)
    int64, bit b of word w of row i set when box i (valid) suppresses box
    j = 64 w + b; bits past K are zero. A plain mirror of the bit layout
    for the tests and the card's check; no serving path calls it."""
    _check(boxes, iou_mode)
    return _pack_words(_suppression(boxes, threshold, iou_mode))


def _soft_overlap(boxes, nms_threshold):
    """(N, K(i), K(j)) bool: valid i decays valid j > i of its class."""
    k = boxes.shape[1]
    ious = pair_iou(boxes[:, :, None, :4], boxes[:, None, :, :4], mode=1)
    same_class = boxes[:, :, None, 5] == boxes[:, None, :, 5]
    later = torch.ones(k, k, dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    valid = boxes[..., 7] != 0
    return ((ious >= nms_threshold) & same_class & later
            & valid[:, :, None] & valid[:, None, :])


def soft_overlap_words_plain(boxes, nms_threshold=0.45):
    """The Soft-NMS kernel's lattice as it lies in scratch: (N, K, words)
    int64, bit b of word w of row j set when the earlier box
    i = 64 w + b decays box j (both valid, the same class, IoU(i, j) >=
    ``nms_threshold``); bits past K are zero. The transpose of the greedy
    layout; a plain mirror for the tests and the card's check."""
    _check(boxes)
    return _pack_words(_soft_overlap(boxes, nms_threshold).transpose(1, 2))


def soft_nms_scan_plain(boxes, nms_threshold=0.45, conf_threshold=0.5,
                        sigma=0.5):
    """``_soft_nms_single``'s K-step scan (tf2_yolo_tpu/ops/nms.py) taken
    literally, over (N, K) tensors. Returns (valid, deleted, conf): the
    (N, K) bool masks and the decayed confidences after the last step."""
    _check(boxes)
    n, k, _ = boxes.shape
    ious = pair_iou(boxes[:, :, None, :4], boxes[:, None, :, :4], mode=1)
    same_class = boxes[:, :, None, 5] == boxes[:, None, :, 5]
    ious = torch.where(same_class, ious, torch.full_like(ious, -torch.inf))
    later = torch.ones(k, k, dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    valid = boxes[..., 7] != 0
    conf = boxes[..., 4] * boxes[..., 6]
    deleted = torch.zeros(n, k, dtype=torch.bool, device=boxes.device)
    # a full tensor, so that no backend turns the division into a
    # multiplication by the reciprocal
    sigma_t = torch.full((n, k), sigma, dtype=torch.float32,
                         device=boxes.device)
    one = torch.ones((), dtype=torch.float32, device=boxes.device)
    for i in range(k):
        iou_i = ious[:, i]
        overlap = later[i] & (iou_i >= nms_threshold) & valid
        decay = torch.where(overlap, torch.exp(-(iou_i * iou_i) / sigma_t),
                            one)
        conf = conf * torch.where(valid[:, i:i + 1], decay, one)
        deleted = deleted | (valid[:, i:i + 1] & overlap
                             & (conf < conf_threshold))
    return valid, deleted, conf


def soft_nms_keep_plain(boxes, nms_threshold=0.45, conf_threshold=0.5,
                        sigma=0.5):
    """Plain PyTorch version: the keep mask of
    :func:`soft_nms_scan_plain`."""
    valid, deleted, _ = soft_nms_scan_plain(boxes, nms_threshold,
                                            conf_threshold, sigma)
    return (valid & ~deleted).to(torch.float32)


@functools.cache
def _library():
    lib = load_library(*SOURCE)
    lib.nms_setup.argtypes = []
    lib.nms_setup.restype = ctypes.c_int
    lib.nms_keep_launch.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p]
    lib.nms_keep_launch.restype = ctypes.c_int
    lib.soft_nms_keep_launch.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    lib.soft_nms_keep_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _ready(device_index):
    """The library, its scan kernel allowed its shared memory on the
    device: ``nms_setup`` runs once per device, never per launch."""
    lib = _library()
    with torch.cuda.device(device_index):
        err = lib.nms_setup()
    if err != 0:
        raise RuntimeError(f"nms_setup failed: cudaError {err}")
    return lib


def _launch(boxes, threshold, iou_mode, plan):
    """Launch the greedy kernels of ``plan`` on a checked CUDA tensor;
    return (keep, lattice scratch)."""
    n, k, _ = boxes.shape
    lib = _ready(boxes.device.index)
    keep = torch.empty((n, k), dtype=torch.float32, device=boxes.device)
    lattice = torch.empty((n, k, plan.words), dtype=torch.int64,
                          device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = lib.nms_keep_launch(
        boxes.data_ptr(), keep.data_ptr(), lattice.data_ptr(), n, k,
        plan.words, plan.smem_bytes, float(threshold), int(iou_mode),
        stream)
    if err != 0:
        raise RuntimeError(f"nms_keep kernel launch failed: cudaError {err}")
    nms_keep.launches += 1
    return keep, lattice


def _nms_keep_impl(boxes, threshold, iou_mode):
    _check(boxes, iou_mode)
    _check_wrapper(boxes, "nms_keep")
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, threshold, iou_mode)
    n, k, _ = boxes.shape
    return _launch(boxes, threshold, iou_mode, _plan(n, k))[0]


@torch.library.custom_op("tf2_yolo_tpu_torch::nms_keep", mutates_args=())
def _nms_keep_op(boxes: torch.Tensor, threshold: float,
                 iou_mode: int) -> torch.Tensor:
    return _nms_keep_impl(boxes, threshold, iou_mode)


@_nms_keep_op.register_fake
def _(boxes, threshold, iou_mode):
    return boxes.new_empty(boxes.shape[:2])


def nms_keep(boxes, threshold=0.45, iou_mode=1):
    """See the module docstring. CPU tensors take the plain version;
    CUDA tensors launch the kernels, or raise."""
    _check_wrapper(boxes, "nms_keep")     # a meta tensor would pass the op
    return _nms_keep_op(boxes, float(threshold), int(iou_mode))


nms_keep.launches = 0


def soft_nms_keep(boxes, nms_threshold=0.45, conf_threshold=0.5, sigma=0.5):
    """See the module docstring. CPU tensors take the plain version;
    CUDA tensors launch the kernel, or raise."""
    _check_wrapper(boxes, "soft_nms_keep")
    return _soft_nms_keep_op(boxes, float(nms_threshold),
                             float(conf_threshold), float(sigma))


def _soft_launch(boxes, nms_threshold, conf_threshold, sigma, plan):
    """Launch the Soft-NMS kernels of ``plan`` on a checked CUDA tensor;
    return (keep, lattice scratch)."""
    n, k, _ = boxes.shape
    lib = _ready(boxes.device.index)
    keep = torch.empty((n, k), dtype=torch.float32, device=boxes.device)
    lattice = torch.empty((n, k, plan.words), dtype=torch.int64,
                          device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = lib.soft_nms_keep_launch(
        boxes.data_ptr(), keep.data_ptr(), lattice.data_ptr(), n, k,
        plan.words, float(nms_threshold), float(conf_threshold),
        float(sigma), stream)
    if err != 0:
        raise RuntimeError(
            f"soft_nms_keep kernel launch failed: cudaError {err}")
    soft_nms_keep.launches += 1
    return keep, lattice


def _soft_nms_keep_impl(boxes, nms_threshold, conf_threshold, sigma):
    _check(boxes)
    _check_wrapper(boxes, "soft_nms_keep")
    if boxes.device.type == "cpu":
        return soft_nms_keep_plain(boxes, nms_threshold, conf_threshold,
                                   sigma)
    n, k, _ = boxes.shape
    return _soft_launch(boxes, nms_threshold, conf_threshold, sigma,
                        _plan(n, k))[0]


soft_nms_keep.launches = 0


@torch.library.custom_op("tf2_yolo_tpu_torch::soft_nms_keep",
                         mutates_args=())
def _soft_nms_keep_op(boxes: torch.Tensor, nms_threshold: float,
                      conf_threshold: float, sigma: float) -> torch.Tensor:
    return _soft_nms_keep_impl(boxes, nms_threshold, conf_threshold, sigma)


@_soft_nms_keep_op.register_fake
def _(boxes, nms_threshold, conf_threshold, sigma):
    return boxes.new_empty(boxes.shape[:2])
