"""Static-scale int8 conv with its quantize prologue and affine epilogue.

``conv_int8(x, wq, c, t, sx, ksize, stride, out_dtype)`` computes, on an
NHWC ``x`` (bf16 or f32):

- xq = clamp(round(x / sx), -127, 127), round half to even, with a true
  division (no reciprocal);
- acc = conv(xq, wq) summed in int32 (exact);
- y = (float(acc) * c) + t per output channel, two f32 operations
  (no fused multiply-add), rounded once to ``out_dtype``.

``wq`` is the (Co, kp) int8 matrix of :func:`weight_layout`; ``c`` and
``t`` are f32 (Co,). Geometries as the conv kernel: 1x1 stride 1; 3x3
stride 1 SAME; 3x3 stride 2 with the darknet top/left pad then VALID
(H and W even).

Source note. On a CUDA tensor this launches ``csrc/conv_int8.cu``, the
port of the JAX package's static-scale int8 ConvBN (``ConvBN._quant_call``,
tf2_yolo_tpu/models/layers.py:362-398: XLA's ``conv_general_dilated``
s8 x s8 -> s32, no Pallas kernel; PyTorch has no int8 convolution on
CUDA). An implicit GEMM on ``mma.sync.m16n8k32`` s8 tensor cores: the
prologue quantizes x into shared memory (16-byte chunks for Ci % 32 ==
0, the "ring" route; element by element otherwise, the "gather" route,
which takes the stem's Ci = 3, K = 27 zero-padded to 32), the weights
arrive by ``cp.async``, and the epilogue applies the affine from the
int32 accumulators. Bound by bytes at 3.35 TB/s on every YOLOv4 layer but
the 3x3 ones at 26^2 and below with Ci >= 256 (int8 peak 1979 TOP/s).
``conv_int8.launches`` counts every launch, ``conv_int8.tc_launches`` those
on the tensor cores (every route is). The ring route reads x in 16-byte
chunks and raises ValueError on tensors off a 16-byte boundary
(``conv_bn._check_aligned``). On a CPU tensor the wrapper computes
:func:`conv_int8_plain`, exact: the conv of the int8 values runs in f64,
where every sum of these products is an integer below 2**53.

The wrapper calls the custom op ``tf2_yolo_tpu_torch::conv_int8`` (its
fake implementation gives the shape), so a program traced by
``torch.export`` calls the kernel, or on the CPU the plain version.
"""

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._build import load_library
from .conv_bn import _check_aligned

SOURCE = ("conv_int8.cu", ())        # source and extra nvcc flags
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GEOMETRIES = {(1, 1), (3, 1), (3, 2)}
_INT32_MAX = 2 ** 31 - 1
_SMS = 132                           # H100 SMs
_BM, _BK = 128, 32                   # output rows a block, K a slice
_TILES = {0: 128, 1: 64, 2: 32}      # config id -> output channels a block
QMAX = 127


class Plan(NamedTuple):
    """How one int8 conv launches: ``route`` "ring" (Ci % 32 == 0) or
    "gather"; ``config`` the tile id (0/1/2: 128/64/32 channels);
    ``grid`` (x, y); ``kp`` the padded contraction depth."""
    route: str
    config: int
    grid: tuple
    kp: int


def padded_k(ksize, ci):
    """K = ksize * ksize * Ci rounded up to a multiple of 32."""
    return -(-ksize * ksize * ci // _BK) * _BK


def _plan(n, h, wd, ci, co, ksize, stride):
    """The launch plan (pure Python: the CPU tests reach it): the widest
    tile of 128, 64 or 32 channels that Co fills, halved while the grid
    would not cover the 132 SMs once. Raises ValueError on a shape the
    kernel does not take."""
    if (ksize, stride) not in _GEOMETRIES:
        raise ValueError(f"unsupported conv {ksize}x{ksize} stride {stride}")
    if stride == 2 and (h % 2 or wd % 2):
        raise ValueError(f"stride 2 needs even H and W, got {h}x{wd}")
    if min(n, h, wd, ci, co) < 1:
        raise ValueError(f"empty conv {(n, h, wd, ci)} -> {co}")
    m = n * (h // stride) * (wd // stride)
    rows = -(-m // _BM)
    config = next(c for c, bn in _TILES.items() if bn <= co or c == 2)
    cols = lambda c: -(-co // _TILES[c])
    while config < 2 and rows * cols(config) < _SMS:
        config += 1
    plan = Plan("ring" if ci % _BK == 0 else "gather", config,
                (rows, cols(config)), padded_k(ksize, ci))
    if rows > _INT32_MAX or plan.grid[1] > 65535:
        raise ValueError(f"unsupported size {(n, h, wd, ci)} -> {co}")
    return plan


def quantize_weights(kernel):
    """An HWIO f32 kernel -> (int8 HWIO kernel, f32 per-output-channel
    scale): sw = max(max |k| over (kh, kw, Ci), 1e-8) / 127 and
    wq = clamp(round(k / sw), -127, 127), the JAX package's rule."""
    k = kernel.detach().float()
    top = torch.clamp(k.abs().amax(dim=(0, 1, 2)), min=1e-8)
    sw = top / torch.full_like(top, QMAX)
    wq = torch.clamp(torch.round(k / sw), -QMAX, QMAX).to(torch.int8)
    return wq, sw


def weight_layout(wq):
    """(k, k, Ci, Co) int8 HWIO -> the kernel's (Co, kp) int8 matrix: row
    o is K = (ky, kx, c) in HWIO order, zero-padded to kp."""
    ks, _, ci, co = wq.shape
    kp = padded_k(ks, ci)
    out = torch.zeros((co, kp), dtype=torch.int8, device=wq.device)
    out[:, :ks * ks * ci] = wq.reshape(ks * ks * ci, co).t()
    return out.contiguous()


def quantize_plain(x, sx):
    """clamp(round(x / sx), -127, 127) as int8, round half to even. The
    divisor is a full tensor, so that no backend divides by multiplying
    with the reciprocal of a scalar."""
    xf = x.float()
    q = torch.round(xf / torch.full_like(xf, sx))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def _check(x, wq, c, t, sx, ksize, stride, out_dtype):
    if x.dim() != 4 or wq.dim() != 2 or c.dim() != 1 or t.dim() != 1:
        raise ValueError(
            f"want x (N,H,W,Ci), wq (Co,kp), c (Co,), t (Co,); got "
            f"{tuple(x.shape)}, {tuple(wq.shape)}, {tuple(c.shape)}, "
            f"{tuple(t.shape)}")
    n, h, wd, ci = x.shape
    co, kp = wq.shape
    if (ksize, stride) not in _GEOMETRIES:
        raise ValueError(f"unsupported conv {ksize}x{ksize} stride {stride}")
    if kp != padded_k(ksize, ci) or c.shape[0] != co or t.shape[0] != co:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)} for {ksize}x{ksize}, c "
                         f"{tuple(c.shape)}, t {tuple(t.shape)}")
    if stride == 2 and (h % 2 or wd % 2):
        raise ValueError(f"stride 2 needs even H and W, got {h}x{wd}")
    if x.numel() == 0 or x.numel() > _INT32_MAX \
            or n * (h // stride) * (wd // stride) * co > _INT32_MAX:
        raise ValueError(f"unsupported size {tuple(x.shape)} -> {co}")
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"x and the output take {list(_DTYPE_CODES)}, got "
                        f"{x.dtype} -> {out_dtype}")
    if wq.dtype != torch.int8 or c.dtype != torch.float32 \
            or t.dtype != torch.float32:
        raise TypeError(f"want wq int8, c and t float32; got {wq.dtype}, "
                        f"{c.dtype}, {t.dtype}")
    if not (x.device == wq.device == c.device == t.device):
        raise ValueError(f"tensors on {x.device}, {wq.device}, {c.device}, "
                         f"{t.device}")
    if not all(v.is_contiguous() for v in (x, wq, c, t)):
        raise ValueError("x, wq, c and t must be contiguous")
    if not float(sx) > 0.0:
        raise ValueError(f"the input scale must be positive, got {sx}")
    return n, h, wd, ci, co


def conv_int8_plain(x, wq, c, t, sx, ksize, stride, out_dtype):
    """Plain PyTorch version, exact: the same quantize; the conv as an
    f64 product of the unfolded int8 values (every partial sum is an
    integer below 9 * 2048 * 127**2 < 2**53), cast to int32; then
    float(acc) * c and + t as two separate operations."""
    n, h, wd, ci, co = _check(x, wq, c, t, sx, ksize, stride, out_dtype)
    xq = quantize_plain(x, sx).double().permute(0, 3, 1, 2)
    # (Co, ky, kx, c) -> (Co, c, ky, kx): unfold's order of the columns
    w = wq[:, :ksize * ksize * ci].double().reshape(co, ksize, ksize, ci)
    w = w.permute(0, 3, 1, 2).reshape(co, ci * ksize * ksize)
    pad = ksize // 2
    if stride == 2:
        xq = F.pad(xq, (1, 0, 1, 0))              # darknet top/left pad
        pad = 0
    ho, wo = h // stride, wd // stride
    cols = F.unfold(xq, ksize, padding=pad, stride=stride)  # N, K, L
    acc = torch.matmul(w, cols).to(torch.int32)            # N, Co, L
    y = acc.float() * c.view(1, -1, 1)
    y = y + t.view(1, -1, 1)
    return y.to(out_dtype).reshape(n, co, ho, wo).permute(0, 2, 3, 1) \
        .contiguous()


@functools.cache
def _launcher():
    fn = load_library(*SOURCE).conv_int8_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 \
        + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _forward_cuda(x, wq, c, t, sx, ksize, stride, out_dtype, dims):
    n, h, wd, ci, co = dims
    plan = _plan(n, h, wd, ci, co, ksize, stride)
    y = torch.empty((n, h // stride, wd // stride, co), dtype=out_dtype,
                    device=x.device)
    _check_aligned([x, wq, y] if plan.route == "ring" else [wq, y],
                   "conv_int8")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(x.data_ptr(), wq.data_ptr(), c.data_ptr(),
                      t.data_ptr(), y.data_ptr(), n, h, wd, ci, co, plan.kp,
                      ksize, stride, _DTYPE_CODES[x.dtype],
                      _DTYPE_CODES[out_dtype], float(sx),
                      int(plan.route == "ring"), plan.config, *plan.grid,
                      stream)
    if err != 0:
        raise RuntimeError(f"conv_int8 kernel launch failed: cudaError "
                           f"{err} ({plan})")
    conv_int8.launches += 1
    conv_int8.tc_launches += 1
    return y


def _impl(x, wq, c, t, sx, ksize, stride, out_dtype):
    dims = _check(x, wq, c, t, sx, ksize, stride, out_dtype)
    if x.device.type == "cpu":
        return conv_int8_plain(x, wq, c, t, sx, ksize, stride, out_dtype)
    if x.device.type == "cuda":
        return _forward_cuda(x, wq, c, t, sx, ksize, stride, out_dtype, dims)
    raise ValueError(f"no conv_int8 kernel for {x.device}")


@torch.library.custom_op("tf2_yolo_tpu_torch::conv_int8", mutates_args=())
def _conv_int8_op(x: torch.Tensor, wq: torch.Tensor, c: torch.Tensor,
                  t: torch.Tensor, sx: float, ksize: int, stride: int,
                  out_dtype: torch.dtype) -> torch.Tensor:
    return _impl(x, wq, c, t, sx, ksize, stride, out_dtype)


@_conv_int8_op.register_fake
def _(x, wq, c, t, sx, ksize, stride, out_dtype):
    n, h, wd, _ = x.shape
    return x.new_empty((n, h // stride, wd // stride, wq.shape[0]),
                       dtype=out_dtype)


def conv_int8(x, wq, c, t, sx, ksize, stride, out_dtype, plain=False):
    """See the module docstring. CPU tensors take the plain version; CUDA
    tensors launch the kernel, or raise. ``plain=True`` forces the plain
    version on any device (the reference route)."""
    if plain:
        return conv_int8_plain(x, wq, c, t, sx, ksize, stride, out_dtype)
    if x.device.type not in ("cpu", "cuda"):  # a meta tensor would pass
        raise ValueError(f"no conv_int8 kernel for {x.device}")
    return _conv_int8_op(x, wq, c, t, float(sx), ksize, stride, out_dtype)


conv_int8.launches = 0
conv_int8.tc_launches = 0
