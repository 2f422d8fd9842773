"""Greedy class-wise NMS keep mask over confidence-sorted boxes.

``nms_keep(boxes, threshold, iou_mode)`` takes (N, K, 8) f32 rows
``[x, y, w, h, conf, cls, prob, valid]``, each image sorted by joint
confidence descending, and returns the (N, K) f32 {0, 1} keep mask: box
j is dropped when an earlier, valid, still-kept box of the same class
overlaps it by at least ``threshold`` (IoU, or DIoU for ``iou_mode=2``).

Source note. On a CUDA tensor this launches ``csrc/nms.cu``, the Hopper
port of the Pallas TPU kernel ``nms_pallas``
(tf2_yolo_tpu/ops/pallas/nms_kernel.py): one block per image, alive
flags in shared memory, K dependent steps with one barrier each, so it
is latency bound. K is limited only by shared memory (36 bytes a box),
not by the TPU kernel's K <= 1024 cap or its multiple-of-128 padding.
On a CPU tensor it computes :func:`nms_keep_plain`, the same semantics
as ``nms_scan`` (tf2_yolo_tpu/ops/nms.py) on rows in this layout.
"""

import ctypes
import functools

import torch

from ..geometry import pair_iou
from ._build import load_library

SOURCE = ("nms.cu", ("--fmad=false",))   # source and extra nvcc flags
# shared memory a block may opt into on an H100 (227 KB)
SMEM_LIMIT = 232448
_BYTES_PER_BOX = 36                    # 8 f32 fields + an int alive flag
MAX_K = SMEM_LIMIT // _BYTES_PER_BOX


def _check(boxes, iou_mode):
    if boxes.dim() != 3 or boxes.shape[-1] != 8 or boxes.shape[1] == 0:
        raise ValueError(f"want boxes (N, K, 8), got {tuple(boxes.shape)}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"want float32 boxes, got {boxes.dtype}")
    if not boxes.is_contiguous():
        raise ValueError("boxes must be contiguous")
    if iou_mode not in (1, 2):
        raise ValueError(f"iou_mode must be 1 (IoU) or 2 (DIoU), "
                         f"got {iou_mode}")


def nms_keep_plain(boxes, threshold=0.45, iou_mode=1):
    """Plain PyTorch version: the (N, K, K) suppression lattice, then the
    greedy scan as a loop over K."""
    _check(boxes, iou_mode)
    n, k, _ = boxes.shape
    overlap = pair_iou(boxes[:, :, None, :4], boxes[:, None, :, :4],
                       mode=iou_mode)                      # N, K(i), K(j)
    same_class = boxes[:, :, None, 5] == boxes[:, None, :, 5]
    later = torch.ones(k, k, dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    valid = boxes[..., 7] != 0
    suppress = (overlap >= threshold) & same_class & later \
        & valid[:, :, None]
    alive = torch.ones(n, k, dtype=torch.bool, device=boxes.device)
    for i in range(k):
        alive = alive & ~(suppress[:, i] & alive[:, i:i + 1])
    return alive.to(torch.float32) * boxes[..., 7]


@functools.cache
def _launcher():
    lib = load_library(*SOURCE)
    fn = lib.nms_keep_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nms_keep(boxes, threshold=0.45, iou_mode=1):
    """See the module docstring. CPU tensors take the plain version;
    CUDA tensors launch the kernel, or raise."""
    _check(boxes, iou_mode)
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, threshold, iou_mode)
    if boxes.device.type != "cuda":
        raise ValueError(f"no nms_keep kernel for {boxes.device}")
    n, k, _ = boxes.shape
    if k > MAX_K:
        raise ValueError(f"K={k} boxes need {k * _BYTES_PER_BOX} bytes of "
                         f"shared memory; a block has {SMEM_LIMIT}")
    launch = _launcher()
    keep = torch.empty((n, k), dtype=torch.float32, device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = launch(boxes.data_ptr(), keep.data_ptr(), n, k, float(threshold),
                 int(iou_mode), stream)
    if err != 0:
        raise RuntimeError(f"nms_keep kernel launch failed: cudaError {err}")
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0
