"""Conv + bias with per-channel statistic sums (NHWC, forward).

``conv_bn_stats(x, w, b, stride, want_stats)`` returns ``(y, s1, s2)``:
y = conv(x, w) + b rounded to ``x.dtype``; s1 = sum(y) and s2 = sum(y^2)
per output channel over N*H*W of the rounded y, in f32 (``None`` when
``want_stats`` is false).

Source note. On a CUDA tensor this launches ``csrc/conv_bn.cu``, the
Hopper port of the Pallas TPU kernels ``conv1x1_stats`` and
``conv3x3_stats`` (tf2_yolo_tpu/ops/pallas/conv_bn_kernel.py,
``_conv1x1_stats_fwd_impl`` and ``_conv3x3_stats_fwd_impl``). It is an
implicit-GEMM conv on the CUDA cores, bounded by their FMA rate; the
statistics are per-block partial sums added with f32 atomics, so their
last bits depend on block order. On a CPU tensor it computes
:func:`conv_bn_stats_plain`, the counterpart of ``conv_stats_ref``.

Geometries: 1x1 stride 1; 3x3 stride 1 SAME; 3x3 stride 2 with the
darknet top/left pad then VALID (H and W even). Weights are HWIO, the
flax layout, which is the kernel's row-major (K, Co) matrix.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GEOMETRIES = {(1, 1), (3, 1), (3, 2)}
_INT32_MAX = 2 ** 31 - 1


def _check(x, w, b, stride):
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError(
            f"want x (N,H,W,Ci), w (k,k,Ci,Co), b (Co,); got "
            f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    n, h, wd, ci = x.shape
    kh, kw, wci, co = w.shape
    if kh != kw or (kh, stride) not in _GEOMETRIES:
        raise ValueError(f"unsupported conv {kh}x{kw} stride {stride}")
    if wci != ci or b.shape[0] != co:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if stride == 2 and (h % 2 or wd % 2):
        raise ValueError(f"stride 2 needs even H and W, got {h}x{wd}")
    if x.numel() == 0 or x.numel() > _INT32_MAX \
            or n * (h // stride) * (wd // stride) * co > _INT32_MAX:
        raise ValueError(f"unsupported size {tuple(x.shape)} -> {co}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype \
            or b.dtype != x.dtype:
        raise TypeError(f"want one dtype of {list(_DTYPE_CODES)}, got "
                        f"{x.dtype}, {w.dtype}, {b.dtype}")
    if not (x.device == w.device == b.device):
        raise ValueError(f"tensors on {x.device}, {w.device}, {b.device}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("x, w and b must be contiguous")
    return n, h, wd, ci, co, kh


def conv_bn_stats_plain(x, w, b, stride=1, want_stats=True):
    """Plain PyTorch version: f32 conv on NCHW views, bias, rounding to
    ``x.dtype``, then the statistics of the rounded y."""
    _check(x, w, b, stride)
    xf = x.float().permute(0, 3, 1, 2)
    wf = w.float().permute(3, 2, 0, 1)            # HWIO -> OIHW
    pad = w.shape[0] // 2
    if stride == 2:
        xf = F.pad(xf, (1, 0, 1, 0))              # darknet top/left pad
        pad = 0
    yf = F.conv2d(xf, wf, stride=stride, padding=pad)
    yf = yf + b.float().view(1, -1, 1, 1)
    y = yf.to(x.dtype).permute(0, 2, 3, 1).contiguous()
    if not want_stats:
        return y, None, None
    ys = y.float()
    return y, ys.sum(dim=(0, 1, 2)), (ys * ys).sum(dim=(0, 1, 2))


@functools.cache
def _launcher():
    fn = load_library("conv_bn.cu").conv_bn_stats_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv_bn_stats(x, w, b, stride=1, want_stats=True):
    """See the module docstring. CPU tensors take the plain version;
    CUDA tensors launch the kernel, or raise."""
    n, h, wd, ci, co, ks = _check(x, w, b, stride)
    if x.device.type == "cpu":
        return conv_bn_stats_plain(x, w, b, stride, want_stats)
    if x.device.type != "cuda":
        raise ValueError(f"no conv_bn_stats kernel for {x.device}")
    launch = _launcher()
    y = torch.empty((n, h // stride, wd // stride, co), dtype=x.dtype,
                    device=x.device)
    s1 = s2 = None
    if want_stats:
        s1 = torch.zeros(co, dtype=torch.float32, device=x.device)
        s2 = torch.zeros(co, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 s1.data_ptr() if want_stats else None,
                 s2.data_ptr() if want_stats else None,
                 n, h, wd, ci, co, ks, stride, _DTYPE_CODES[x.dtype],
                 int(want_stats), stream)
    if err != 0:
        raise RuntimeError(f"conv_bn_stats kernel launch failed: "
                           f"cudaError {err}")
    conv_bn_stats.launches += 1
    return y, s1, s2


conv_bn_stats.launches = 0
