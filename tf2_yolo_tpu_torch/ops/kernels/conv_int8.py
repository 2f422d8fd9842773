"""Static-scale int8 conv with its quantize pass and affine epilogue.

``conv_int8(x, wq, c, t, sx, ksize, stride, out_dtype, padding=)``
computes, on an NHWC ``x`` (bf16 or f32):

- xq = clamp(round(x / sx), -127, 127), round half to even, with a true
  division (no reciprocal);
- acc = conv(xq, wq) summed in int32 (exact);
- y = (float(acc) * c) + t per output channel, two f32 operations
  (no fused multiply-add), rounded once to ``out_dtype``.

``wq`` is the (Co, kp) int8 matrix of :func:`weight_layout`; ``c`` and
``t`` are f32 (Co,). Geometries as the conv kernel K1
(``conv_bn.conv_geometry``): ``padding="darknet"`` (the default: SAME at
stride 1, the darknet top/left pad then VALID for 3x3 stride 2),
``"same"`` (flax's ``"SAME"``, the smaller half of the pad on top and
left: YOLOv1.5's 7x7 stride-2 stem and 3x3 stride-2 conv) or an int pad
on every side; the kernels take the top and left pad and the output size
at run time and read zeros past the bottom and right edges. Symmetric
quantization maps the zero pad to zero, so every pad is exact.

Source note. On a CUDA tensor this launches ``csrc/conv_int8.cu``, the
port of the JAX package's static-scale int8 ConvBN (``ConvBN._quant_call``,
tf2_yolo_tpu/models/layers.py:362-398: XLA's ``conv_general_dilated``
s8 x s8 -> s32, no Pallas kernel; PyTorch has no int8 convolution on
CUDA), as two launches a call: a quantize pass that writes x once as
int8 into scratch (``conv_int8.quant_launches``), then an implicit GEMM
on ``wgmma.mma_async`` s8 tensor cores (``conv_int8.launches``, all of
them ``tc_launches``) fed by a ring of 128-byte K slices through 16-byte
``cp.async`` copies into 128-byte-swizzled shared memory, split over K
where the tiles alone would not cover the 132 SMs (the last split to
arrive applies the epilogue to the exact int32 sum). Chunks of 16 bytes
lie in one tap for Ci % 16 == 0 (the "ring" route); for other Ci (the
"gather" route: the stem's Ci = 3, K = 27 zero-padded to 32) the
quantize pass writes the implicit GEMM's (M, kp) int8 rows, which the
conv reads as a 1x1 conv (YOLOv1.5's 7x7 stem: K = 147 padded to 160).
:func:`_plan` picks the route, the tile, the split and the ring's
depth. Bound by bytes at 3.35 TB/s on every YOLOv4
layer but the 3x3 ones at 26^2 and below with Ci >= 256 (int8 peak 1979
TOP/s). Every operand is copied in 16-byte chunks: the wrapper raises
ValueError on a tensor off a 16-byte boundary
(``conv_bn._check_aligned``). On a CPU tensor the wrapper computes
:func:`conv_int8_plain`, exact: the conv of the int8 values runs in f64,
where every sum of these products is an integer below 2**53. Its two
halves, :func:`quantize_int8_plain` and :func:`conv_int8_xq_plain` (with
the int32 sums over any range of K, :func:`conv_int8_acc_plain`), are
for the tests.

The wrapper calls the custom op ``tf2_yolo_tpu_torch::conv_int8`` (its
fake implementation gives the shape), so a program traced by
``torch.export`` calls the kernel, or on the CPU the plain version.
"""

import collections
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._build import load_library
from .conv_bn import (_check_aligned, _pads, _padding_of, conv_geometry,
                      geometry_key)

SOURCE = ("conv_int8.cu", ())        # source and extra nvcc flags
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the geometries of the first kernel (``conv_int8_before_launch``)
_BEFORE_GEOMETRIES = {(1, 1), (3, 1), (3, 2)}
_INT32_MAX = 2 ** 31 - 1
_SMS = 132                           # H100 SMs
_BM = 128                            # output rows a block
_KP_ALIGN = 32                       # kp: K rounded up to one k32 step
_SLICE = 128                         # bytes of K a ring slot
_MIN_SLICES = 2                      # slices a split, at least
_TILES = {0: 256, 1: 128, 2: 64, 3: 32}   # config id -> channels a block
QMAX = 127


class Plan(NamedTuple):
    """How one int8 conv launches: ``route`` "ring" (Ci % 16 == 0) or
    "gather"; ``config`` the tile id (0/1/2/3: 256/128/64/32 channels);
    ``grid`` (row tiles, column tiles); ``kp`` the padded contraction
    depth; ``splits`` the split of K's ceil(kp / 128) slices (it divides
    them); ``stages`` the ring's slots."""
    route: str
    config: int
    grid: tuple
    kp: int
    splits: int
    stages: int

    @property
    def smem_bytes(self):
        """Dynamic shared memory: the slots a block uses (its slices, at
        most ``stages``) and 1 KB to align them to the swizzle's repeat."""
        slots = min(self.stages, -(-self.kp // _SLICE) // self.splits)
        return slots * (_BM + _TILES[self.config]) * _SLICE + 1024


def padded_k(ksize, ci):
    """K = ksize * ksize * Ci rounded up to a multiple of 32."""
    return -(-ksize * ksize * ci // _KP_ALIGN) * _KP_ALIGN


def _split_choices(slices):
    """The splits of ``slices`` K slices that a plan may take: the
    divisors that leave each split at least two slices (and 1)."""
    return [d for d in range(1, slices + 1)
            if slices % d == 0 and (d == 1 or slices // d >= _MIN_SLICES)]


def _geometry(n, h, wd, ci, co, ksize, stride, padding="darknet"):
    """(M, :class:`conv_bn.Geometry`) of the conv; raises ValueError on
    a geometry the kernels do not take."""
    if min(n, h, wd, ci, co) < 1:
        raise ValueError(f"empty conv {(n, h, wd, ci)} -> {co}")
    g = conv_geometry(h, wd, ksize, stride, padding)
    return n * g.ho * g.wo, g


def _plan(n, h, wd, ci, co, ksize, stride, padding="darknet"):
    """The launch plan (pure Python: the CPU tests reach it). The
    256-channel tile where it alone gives two waves of blocks (it reads
    a quarter fewer bytes from L2 an operation, but holds an SM alone with
    a 4-slot ring, and loses wherever it would leave SMs idle or split
    K; measured on the card). Otherwise the widest tile of 128, 64 or 32
    channels that Co fills and the fewest splits of K that together give
    at least one block to each of the 132 SMs (tried widest tile first);
    where none does, the narrowest tile and the largest split. A ring of
    6 slots keeps 4 slices in flight; 4 slots where a split has 2 slices
    or fewer, on the gather route, and with the 256-channel tile (whose 4
    slots fill the shared memory). Raises ValueError on a shape the
    kernel does not take."""
    m, _ = _geometry(n, h, wd, ci, co, ksize, stride, padding)
    rows = -(-m // _BM)
    kp = padded_k(ksize, ci)
    choices = _split_choices(-(-kp // _SLICE))
    last = len(_TILES) - 1
    first = next(c for c, bn in _TILES.items() if bn <= co or c == last)
    if first == 0 and rows * -(-co // _TILES[0]) >= 2 * _SMS:
        config, splits = 0, 1
    else:
        config, splits = last, choices[-1]
        for cfg in range(max(first, 1), last + 1):
            cols = -(-co // _TILES[cfg])
            fit = [d for d in choices if rows * cols * d >= _SMS]
            if fit:
                config, splits = cfg, fit[0]
                break
    route = "ring" if ci % 16 == 0 else "gather"
    slices = -(-kp // _SLICE) // splits
    stages = 4 if route == "gather" or slices <= 2 or config == 0 else 6
    plan = Plan(route, config, (rows, -(-co // _TILES[config])), kp, splits,
                stages)
    if rows > _INT32_MAX or plan.grid[1] > 65535:
        raise ValueError(f"unsupported size {(n, h, wd, ci)} -> {co}")
    return plan


def _before_plan(n, h, wd, ci, co, ksize, stride):
    """The plan of the first kernel (``conv_int8_before_launch``, kept
    for chip_smoke.py's before/after timing): (ring, config, grid), the
    widest tile that Co fills, halved while the grid would not cover the
    132 SMs; ring for Ci % 32 == 0."""
    if (ksize, stride) not in _BEFORE_GEOMETRIES:
        raise ValueError(f"the first kernel takes no {ksize}x{ksize} "
                         f"stride {stride} conv")
    rows = -(-_geometry(n, h, wd, ci, co, ksize, stride)[0] // _BM)
    tiles = {0: 128, 1: 64, 2: 32}       # its config ids
    config = next(c for c, bn in tiles.items() if bn <= co or c == 2)
    cols = lambda c: -(-co // tiles[c])
    while config < 2 and rows * cols(config) < _SMS:
        config += 1
    return ci % 32 == 0, config, (rows, cols(config))


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


def quantize_int8_plain(x, sx):
    """clamp(round(x / sx), -127, 127) as int8, round half to even. The
    divisor is a full tensor, so that no backend divides by multiplying
    with the reciprocal of a scalar."""
    xf = x.float()
    q = torch.round(xf / torch.full_like(xf, sx))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def _check(x, wq, c, t, sx, ksize, stride, out_dtype, padding="darknet"):
    if x.dim() != 4 or wq.dim() != 2 or c.dim() != 1 or t.dim() != 1:
        raise ValueError(
            f"want x (N,H,W,Ci), wq (Co,kp), c (Co,), t (Co,); got "
            f"{tuple(x.shape)}, {tuple(wq.shape)}, {tuple(c.shape)}, "
            f"{tuple(t.shape)}")
    n, h, wd, ci = x.shape
    co, kp = wq.shape
    g = conv_geometry(h, wd, ksize, stride, padding)
    if kp != padded_k(ksize, ci) or c.shape[0] != co or t.shape[0] != co:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)} for {ksize}x{ksize}, c "
                         f"{tuple(c.shape)}, t {tuple(t.shape)}")
    if x.numel() == 0 or x.numel() > _INT32_MAX \
            or n * g.ho * g.wo * co > _INT32_MAX:
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
    return n, h, wd, ci, co, g


def conv_int8_plain(x, wq, c, t, sx, ksize, stride, out_dtype,
                    padding="darknet"):
    """Plain PyTorch version, exact: the same quantize; the conv as an
    f64 product of the unfolded int8 values (every partial sum is an
    integer below 49 * 2048 * 127**2 < 2**53), cast to int32; then
    float(acc) * c and + t as two separate operations."""
    n, h, wd, ci, co, g = _check(x, wq, c, t, sx, ksize, stride, out_dtype,
                                 padding)
    xq = quantize_int8_plain(x, sx).double().permute(0, 3, 1, 2)
    # (Co, ky, kx, c) -> (Co, c, ky, kx): unfold's order of the columns
    w = wq[:, :ksize * ksize * ci].double().reshape(co, ksize, ksize, ci)
    w = w.permute(0, 3, 1, 2).reshape(co, ci * ksize * ksize)
    pad = _pads(h, wd, ksize, stride, padding)
    if type(pad) is not int:                  # (left, right, top, bottom)
        xq = F.pad(xq, pad)
        pad = 0
    ho, wo = g.ho, g.wo
    cols = F.unfold(xq, ksize, padding=pad, stride=stride)  # N, K, L
    acc = torch.matmul(w, cols).to(torch.int32)            # N, Co, L
    y = acc.float() * c.view(1, -1, 1)
    y = y + t.view(1, -1, 1)
    return y.to(out_dtype).reshape(n, co, ho, wo).permute(0, 2, 3, 1) \
        .contiguous()


def _columns_int8(xq, ksize, stride, kp, padding="darknet"):
    """(N, H, W, Ci) int8 -> the (M, kp) f64 rows of the implicit GEMM in
    the kernel's K order (ky, kx, c): input pixel (ho * stride - pad_top
    + ky, wo * stride - pad_left + kx), zero outside the image and past
    K."""
    n, h, wd, ci = xq.shape
    g = conv_geometry(h, wd, ksize, stride, padding)
    ho, wo = g.ho, g.wo
    bottom = max((ho - 1) * stride + ksize - h - g.pad_top, 0)
    right = max((wo - 1) * stride + ksize - wd - g.pad_left, 0)
    xp = F.pad(xq.double(), (0, 0, g.pad_left, right, g.pad_top, bottom))
    taps = [xp[:, ky:ky + stride * (ho - 1) + 1:stride,
               kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(ksize) for kx in range(ksize)]
    cols = torch.cat(taps, -1).reshape(n * ho * wo, ksize * ksize * ci)
    return F.pad(cols, (0, kp - cols.shape[1]))


def conv_int8_acc_plain(xq, wq, ksize, stride, k0=0, k1=None,
                        padding="darknet"):
    """The int32 sums of the conv of int8 ``xq`` (N, H, W, Ci) with the
    (Co, kp) matrix ``wq`` over the K columns k0 .. k1 only (all of them
    by default), (N, Ho, Wo, Co): what one split of the kernel's K slices
    adds. f64 products of the unfolded values, exact below 2**53."""
    n, h, wd, _ = xq.shape
    g = conv_geometry(h, wd, ksize, stride, padding)
    cols = _columns_int8(xq, ksize, stride, wq.shape[1], padding)[:, k0:k1]
    acc = torch.matmul(cols, wq[:, k0:k1].double().t())
    return acc.to(torch.int32).reshape(n, g.ho, g.wo, -1)


def conv_int8_xq_plain(xq, wq, c, t, ksize, stride, out_dtype,
                       padding="darknet"):
    """The conv half of :func:`conv_int8_plain` on an already quantized
    int8 ``xq``: float(acc) * c, then + t, rounded once to ``out_dtype``.
    ``conv_int8_xq_plain(quantize_int8_plain(x, sx), ...)`` equals
    ``conv_int8_plain(x, ..., sx, ...)`` bit for bit."""
    y = conv_int8_acc_plain(xq, wq, ksize, stride,
                            padding=padding).float() * c
    y = y + t
    return y.to(out_dtype)


@functools.cache
def _library():
    lib = load_library(*SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv_int8_quantize_launch.argtypes = [ptr] * 2 + [i32] * 13 \
        + [ctypes.c_float, ptr, i32, ptr]
    lib.conv_int8_launch.argtypes = [ptr] * 7 + [i32] * 18 + [ptr]
    lib.conv_int8_before_launch.argtypes = [ptr] * 5 + [i32] * 10 \
        + [ctypes.c_float] + [i32] * 4 + [ptr]
    for fn in (lib.conv_int8_quantize_launch, lib.conv_int8_launch,
               lib.conv_int8_before_launch):
        fn.restype = i32
    return lib


def _raise_on(err, what, plan=None):
    if err != 0:
        raise RuntimeError(f"conv_int8 {what} launch failed: cudaError "
                           f"{err}" + (f" ({plan})" if plan else ""))


def _quantize_launch(x, sx, xq, counters, ksize, stride, plan, stream,
                     padding="darknet"):
    """The quantize pass into ``xq`` (by ``plan.route``); clears
    ``counters``."""
    n, h, wd, ci = x.shape
    g = conv_geometry(h, wd, ksize, stride, padding)
    err = _library().conv_int8_quantize_launch(
        x.data_ptr(), xq.data_ptr(), n, h, wd, ci, ksize, stride, g.ho, g.wo,
        g.pad_top, g.pad_left, plan.kp,
        int(plan.route == "gather"), _DTYPE_CODES[x.dtype], float(sx),
        None if counters is None else counters.data_ptr(),
        0 if counters is None else counters.numel(), stream)
    _raise_on(err, "quantize", plan)
    conv_int8.quant_launches += 1


def _conv_launch(xq, wq, c, t, y, ws, counters, ksize, stride, plan,
                 stream, padding="darknet"):
    """The int8 conv of the quantize pass's ``xq`` into ``y`` by
    ``plan``; the gather route's rows are a 1x1 conv over kp channels."""
    if plan.route == "gather":
        (n, h), (wd, ci), ksize, stride = (1, 1), xq.shape, 1, 1
        g = conv_geometry(h, wd, 1, 1)
    else:
        n, h, wd, ci = xq.shape
        g = conv_geometry(h, wd, ksize, stride, padding)
    co, kp = wq.shape
    ptr = lambda v: None if v is None else v.data_ptr()
    err = _library().conv_int8_launch(
        xq.data_ptr(), wq.data_ptr(), c.data_ptr(), t.data_ptr(),
        y.data_ptr(), ptr(ws), ptr(counters), n, h, wd, ci, co, kp, ksize,
        stride, g.ho, g.wo, g.pad_top, g.pad_left, _DTYPE_CODES[y.dtype],
        plan.config, plan.stages, *plan.grid, plan.splits, stream)
    _raise_on(err, "conv", plan)
    conv_int8.launches += 1
    conv_int8.tc_launches += 1


def _buffers(x, plan, co, ksize, stride, padding="darknet"):
    """The scratch of one call: the int8 copy of x (ring route) or the
    (M, kp) int8 rows of the implicit GEMM (gather route); where K is
    split, the int32 partial tiles (splits, M * Co) and one counter a
    tile (None otherwise)."""
    n, h, wd, ci = x.shape
    m, _ = _geometry(n, h, wd, ci, co, ksize, stride, padding)
    shape = (m, plan.kp) if plan.route == "gather" else x.shape
    xq = torch.empty(shape, dtype=torch.int8, device=x.device)
    if plan.splits == 1:
        return xq, None, None
    ws = torch.empty((plan.splits, m * co), dtype=torch.int32,
                     device=x.device)
    counters = torch.empty(plan.grid[0] * plan.grid[1], dtype=torch.int32,
                           device=x.device)
    return xq, ws, counters


def _forward_cuda(x, wq, c, t, sx, ksize, stride, out_dtype, dims,
                  padding="darknet"):
    n, h, wd, ci, co, g = dims
    plan = _plan(n, h, wd, ci, co, ksize, stride, padding)
    y = torch.empty((n, g.ho, g.wo, co), dtype=out_dtype, device=x.device)
    xq, ws, counters = _buffers(x, plan, co, ksize, stride, padding)
    _check_aligned([v for v in (x, wq, xq, y, ws, counters)
                    if v is not None], "conv_int8")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _quantize_launch(x, sx, xq, counters, ksize, stride, plan, stream,
                     padding)
    _conv_launch(xq, wq, c, t, y, ws, counters, ksize, stride, plan, stream,
                 padding)
    conv_int8.by_geometry[geometry_key(ksize, stride, padding,
                                       plan.route)] += 1
    return y


def _before_forward(x, wq, c, t, sx, ksize, stride, out_dtype):
    """The first kernel on the same call (chip_smoke.py's "before"
    column; not counted, on no model path)."""
    n, h, wd, ci, co, _ = _check(x, wq, c, t, sx, ksize, stride, out_dtype)
    ring, config, grid = _before_plan(n, h, wd, ci, co, ksize, stride)
    y = torch.empty((n, h // stride, wd // stride, co), dtype=out_dtype,
                    device=x.device)
    _check_aligned([x, wq, y], "conv_int8")
    err = _library().conv_int8_before_launch(
        x.data_ptr(), wq.data_ptr(), c.data_ptr(), t.data_ptr(),
        y.data_ptr(), n, h, wd, ci, co, wq.shape[1], ksize, stride,
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], float(sx),
        int(ring), config, *grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "before")
    return y


def _impl(x, wq, c, t, sx, ksize, stride, out_dtype, padding="darknet"):
    dims = _check(x, wq, c, t, sx, ksize, stride, out_dtype, padding)
    if x.device.type == "cpu":
        return conv_int8_plain(x, wq, c, t, sx, ksize, stride, out_dtype,
                               padding)
    if x.device.type == "cuda":
        return _forward_cuda(x, wq, c, t, sx, ksize, stride, out_dtype, dims,
                             padding)
    raise ValueError(f"no conv_int8 kernel for {x.device}")


@torch.library.custom_op("tf2_yolo_tpu_torch::conv_int8", mutates_args=())
def _conv_int8_op(x: torch.Tensor, wq: torch.Tensor, c: torch.Tensor,
                  t: torch.Tensor, sx: float, ksize: int, stride: int,
                  out_dtype: torch.dtype,
                  padding: str = "darknet") -> torch.Tensor:
    return _impl(x, wq, c, t, sx, ksize, stride, out_dtype,
                 _padding_of(padding))


@_conv_int8_op.register_fake
def _(x, wq, c, t, sx, ksize, stride, out_dtype, padding="darknet"):
    n, h, wd, _ = x.shape
    g = conv_geometry(h, wd, ksize, stride, _padding_of(padding))
    return x.new_empty((n, g.ho, g.wo, wq.shape[0]), dtype=out_dtype)


def conv_int8(x, wq, c, t, sx, ksize, stride, out_dtype, plain=False,
              padding="darknet"):
    """See the module docstring. CPU tensors take the plain version; CUDA
    tensors launch the kernel, or raise. ``plain=True`` forces the plain
    version on any device (the reference route). ``padding``
    (``conv_bn.conv_geometry``): ``"darknet"``, ``"same"`` or an int."""
    if plain:
        return conv_int8_plain(x, wq, c, t, sx, ksize, stride, out_dtype,
                               padding)
    if x.device.type not in ("cpu", "cuda"):  # a meta tensor would pass
        raise ValueError(f"no conv_int8 kernel for {x.device}")
    return _conv_int8_op(x, wq, c, t, float(sx), ksize, stride, out_dtype,
                         str(padding))


conv_int8.launches = 0
conv_int8.tc_launches = 0
conv_int8.quant_launches = 0
# calls by conv_bn.geometry_key(ksize, stride, padding, route), e.g.
# "7x7s2 same gather", "3x3s2 darknet ring"
conv_int8.by_geometry = collections.Counter()
