"""Conv + bias with per-channel statistic sums (NHWC), differentiable.

``conv_bn_stats(x, w, b, stride, want_stats)`` returns ``(y, s1, s2)``:
y = conv(x, w) + b rounded to ``x.dtype``; s1 = sum(y) and s2 = sum(y^2)
per output channel over N*H*W of the rounded y, in f32 (``None`` when
``want_stats`` is false).

Backward (the JAX package's ``_dy_eff`` and ``_conv*_stats_bwd``): the
cotangents fold into g = dy + ds1 + 2 y ds2, computed in f32 and rounded
to ``dy.dtype``; dx and dw are the conv VJP of g in the compute dtype,
db = sum(g) in f32. The JAX package takes that VJP with XLA's conv
outside any Pallas kernel; here it is ``aten.convolution_backward`` on
NCHW views of the NHWC tensors (no copy), on either route.

Source note. On a CUDA tensor this launches ``csrc/conv_bn.cu``, the
Hopper port of the Pallas TPU kernels ``conv1x1_stats`` and
``conv3x3_stats`` (tf2_yolo_tpu/ops/pallas/conv_bn_kernel.py,
``_conv1x1_stats_fwd_impl`` and ``_conv3x3_stats_fwd_impl``). It is an
implicit-GEMM conv with three kernels, chosen by shape in
:func:`_tc_plan`: bf16 with Ci % 32 == 0 and Co % 8 == 0 (every conv of
YOLOv4 but the stem) runs on the tensor cores (``mma.sync`` bf16 -> f32
fed by a 4-stage ``cp.async`` ring; 128-pixel tiles of 128, 64 or 32
channels), bound by operations on the 3x3 layers at 52^2 and below with
Ci >= 128 and by bytes elsewhere; bf16 3x3 stride 1, 3x3 stride 2 SAME
or 7x7 stride 2 with Ci < 32 and Co % 8 == 0 (the stems, Ci = 3) runs on
the tensor cores as well, through an im2col in shared memory (an 8 x 16
pixel tile stages its input halo once, builds its [128 pixels x k^2 Ci]
A tile padded to a multiple of 32, and runs K / 16 ``mma.sync`` steps),
bound by the bytes of y; f32 (whose
tensor-core route would be TF32) and the other shapes run on the CUDA
cores, bound by their FMA rate. ``conv_bn_stats.launches`` counts every
launch, ``conv_bn_stats.tc_launches`` those of the tensor-core kernels.
The tensor-core routes copy 16-byte chunks and raise on a tensor that
does not start on a 16-byte boundary (:func:`_check_aligned`). The
statistics are per-block partial sums added with f64 atomics and
rounded to f32 here, so block order does not show in them even where a
training batch sums millions of rows. On a CPU tensor it computes
:func:`conv_bn_stats_plain`, the counterpart of ``conv_stats_ref``.

Geometries (:func:`conv_geometry`): 1x1 stride 1; 3x3 stride 1; 3x3
stride 2 with the darknet top/left pad then VALID (H and W even), or
with ``padding="same"`` flax's ``"SAME"``; and, SAME only, 1x1 stride
2 (the ResNet projections and strided 1x1 convs: no pad, the ring reads
the input rows (n, 2 ho, 2 wo) where they stand), 7x7 stride 2 (the
YOLOv1 stem) and 2x2 stride 1 (the UNet decoder). SAME pads
max((ceil(H/s) - 1) s + k - H, 0) rows in all, the smaller half on top
(left), and gives ceil(H/s) rows. An int ``padding`` p (0 <= p < k)
instead pads p on every side and is then VALID, (H + 2p - k) // s + 1
rows: the keras ResNet stem's ``jnp.pad`` 3 before its 7x7 stride-2
VALID conv, which is not SAME (SAME pads 2 on top at 416^2). The kernels
take the top and left pad and the output size from the wrapper and read
zeros past the bottom and right edges. Weights are HWIO, the flax
layout, which is the kernel's row-major (K, Co) matrix.

Under ``torch.export`` the forward without statistics (the served conv)
is the custom op ``tf2_yolo_tpu_torch::conv_bn_forward`` (its fake
implementation gives the shape), so an exported program calls the kernel,
or on the CPU the plain version.
"""

import collections
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._build import load_library

SOURCE = ("conv_bn.cu", ())          # source and extra nvcc flags
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GEOMETRIES = {(1, 1), (1, 2), (3, 1), (3, 2), (7, 2), (2, 1)}
# the small-Ci (im2col) kernel's geometries: the stems of v2-v4 (3x3
# s1), v1 and the ResNets (7x7 s2) and MobileNetV2 (3x3 s2 SAME)
_IC_GEOMETRIES = {(3, 1), (3, 2), (7, 2)}
_INT32_MAX = 2 ** 31 - 1
# H100: SMs, and the shared memory one block may use
_SMS = 132
SMEM_MAX = 232448
# tensor-core tiles by config id: (BN, warps along M): 128 output pixels
# and 8 warps each; a 4-stage ring of 32-deep slices
_TC_BM, _TC_BK, _TC_STAGES = 128, 32, 4
_TC_TILES = {0: (128, 2), 1: (64, 4), 2: (32, 4)}
_CC_TILE = 64                          # the CUDA-core kernel's BM = BN
# the small-Ci (im2col) kernel: config _IM2COL + tile id; an output tile
# of 8 x 16 pixels and its halo of (8 - 1) s + k x (16 - 1) s + k
_IM2COL = 3
_IC_TH, _IC_TW = 8, 16


class Geometry(NamedTuple):
    """Output size and top/left pad of one conv (:func:`conv_geometry`)."""
    ho: int
    wo: int
    pad_top: int
    pad_left: int


def _same_pad(size, ksize, stride):
    out = -(-size // stride)
    return out, max((out - 1) * stride + ksize - size, 0) // 2


def conv_geometry(h, wd, ksize, stride, padding="darknet"):
    """The output size and the top and left pad of a ``ksize`` x
    ``ksize`` conv of stride ``stride`` on an H x W input. ``padding``:
    ``"darknet"`` (the JAX ConvBN's default) at stride 2 one row and
    column on top and left, then VALID, and SAME at stride 1;
    ``"same"`` flax's ``"SAME"`` (see the module docstring); an int p,
    p on every side, then VALID. Raises ValueError on a geometry the
    kernels do not take."""
    if (ksize, stride) not in _GEOMETRIES:
        raise ValueError(f"unsupported conv {ksize}x{ksize} stride {stride}")
    if type(padding) is int:
        p = padding
        if not 0 <= p < ksize:
            raise ValueError(f"explicit pad {p} of a {ksize}x{ksize} "
                             f"conv: want 0 <= pad < {ksize}")
        ho = (h + 2 * p - ksize) // stride + 1
        wo = (wd + 2 * p - ksize) // stride + 1
        if ho < 1 or wo < 1:
            raise ValueError(f"explicit pad {p}: a {h}x{wd} input is "
                             f"smaller than the {ksize}x{ksize} window")
        return Geometry(ho, wo, p, p)
    if padding not in ("darknet", "same"):
        raise ValueError(f"padding {padding!r}: want 'darknet', 'same' or "
                         "an int")
    if stride == 2 and padding == "darknet":
        if ksize != 3:
            raise ValueError(f"the darknet pad is a 3x3 stride-2 pad, got "
                             f"{ksize}x{ksize}")
        if h % 2 or wd % 2:
            raise ValueError(f"stride 2 needs even H and W, got {h}x{wd}")
        return Geometry(h // 2, wd // 2, 1, 1)
    ho, top = _same_pad(h, ksize, stride)
    wo, left = _same_pad(wd, ksize, stride)
    return Geometry(ho, wo, top, left)


def _pads(h, wd, ksize, stride, padding):
    """An int p where a symmetric pad of p reads the same pixels as the
    geometry's (its bottom/right pad is then p or never read), so that
    the library conv pads without a copy; otherwise the (left, right,
    top, bottom) zero padding after which the conv is VALID."""
    g = conv_geometry(h, wd, ksize, stride, padding)
    if g.pad_top == g.pad_left and \
            (h + 2 * g.pad_top - ksize) // stride + 1 == g.ho and \
            (wd + 2 * g.pad_left - ksize) // stride + 1 == g.wo:
        return g.pad_top
    bottom = (g.ho - 1) * stride + ksize - h - g.pad_top
    right = (g.wo - 1) * stride + ksize - wd - g.pad_left
    return (g.pad_left, max(right, 0), g.pad_top, max(bottom, 0))


class Plan(NamedTuple):
    """How one conv launches: ``route`` "tc" (tensor cores) or
    "cuda_core"; ``config`` the tile id (-1 on the CUDA cores); ``grid``
    (x, y); ``smem_bytes`` of dynamic shared memory (0 on the CUDA
    cores)."""
    route: str
    config: int
    grid: tuple
    smem_bytes: int


def _tc_smem(config):
    """Bytes of dynamic shared memory of tensor-core config ``config``:
    the ring (A rows of 32 + 8 bf16, B rows of BN + 8) or the epilogue
    (the bf16 tile, rows of BN + 8, and two f32 partial sums per column
    and warp row), whichever is larger (``tc::Ring`` in conv_mma.cuh)."""
    bn, warps_m = _TC_TILES[config]
    ring = _TC_STAGES * (_TC_BM * (_TC_BK + 8) + _TC_BK * (bn + 8)) * 2
    epilogue = _TC_BM * (bn + 8) * 2 + 2 * warps_m * bn * 4
    return max(ring, epilogue)


def _ic_smem(config, ci, ksize=3, stride=1):
    """Bytes of dynamic shared memory of the small-Ci kernel with tile
    ``config`` (0, 1, 2) at ``ci`` input channels: the A tile (128 rows
    of K + 8 bf16, K = k^2 Ci rounded up to 32), the B tile (K rows of
    BN + 8), the input halo ((8 - 1) s + k x (16 - 1) s + k x Ci bf16, to
    16 bytes) and the tap table (K ints), or the epilogue's, whichever
    is larger (``IcSmem`` in conv_bn.cu)."""
    bn, warps_m = _TC_TILES[config]
    kp = -(-ksize * ksize * ci // _TC_BK) * _TC_BK
    halo_h = (_IC_TH - 1) * stride + ksize
    halo_w = (_IC_TW - 1) * stride + ksize
    halo = -(-halo_h * halo_w * ci * 2 // 16) * 16
    main = (_TC_BM * (kp + 8) + kp * (bn + 8)) * 2 + halo + kp * 4
    epilogue = _TC_BM * (bn + 8) * 2 + 2 * warps_m * bn * 4
    return max(main, epilogue)


def _tc_plan(n, h, wd, ci, co, ksize, stride, dtype, padding="darknet"):
    """The launch plan of one conv (pure Python: the CPU tests reach it).
    bf16 with Ci % 32 == 0 (a 32-deep slice lies in one tap) and Co % 8 == 0
    (16-byte rows) takes the tensor cores, with the widest tile of 128, 64
    or 32 channels that Co fills, halved while the grid would not cover the
    132 SMs once: grid (128-row blocks, column blocks). bf16 3x3 stride 1,
    3x3 stride 2 SAME or 7x7 stride 2 with Ci < 32 and Co % 8 == 0 (the
    stems) takes the small-Ci tensor-core kernel, config ``_IM2COL`` + tile,
    tiles chosen the same way: grid (8 x 16 output pixel tiles of all
    images, column blocks). Anything else of a supported dtype (f32) takes
    the CUDA-core kernel. Raises ValueError on a shape the kernels do not
    take."""
    g = conv_geometry(h, wd, ksize, stride, padding)
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {dtype}")
    if min(n, h, wd, ci, co) < 1:
        raise ValueError(f"empty conv {(n, h, wd, ci)} -> {co}")
    m = n * g.ho * g.wo
    ring = ci % _TC_BK == 0
    # the stems: 3x3 s1, 7x7 s2, and 3x3 s2 with SAME (not the darknet
    # pad, which no stem has)
    small_ci = ci < _TC_BK and (ksize, stride) in _IC_GEOMETRIES and not (
        stride == 2 and padding == "darknet")
    if dtype == torch.bfloat16 and co % 8 == 0 and (ring or small_ci):
        rows = -(-m // _TC_BM) if ring else \
            n * -(-g.ho // _IC_TH) * -(-g.wo // _IC_TW)
        config = next(c for c, (bn, _) in _TC_TILES.items()
                      if bn <= co or c == 2)
        grid = lambda c: (rows, -(-co // _TC_TILES[c][0]))
        while config < 2 and grid(config)[0] * grid(config)[1] < _SMS:
            config += 1
        if ring:
            plan = Plan("tc", config, grid(config), _tc_smem(config))
        else:
            plan = Plan("tc", _IM2COL + config, grid(config),
                        _ic_smem(config, ci, ksize, stride))
    else:
        plan = Plan("cuda_core", -1,
                    (-(-m // _CC_TILE), -(-co // _CC_TILE)), 0)
    if plan.grid[0] > _INT32_MAX or plan.grid[1] > 65535 \
            or plan.smem_bytes > SMEM_MAX:
        raise ValueError(f"unsupported size {(n, h, wd, ci)} -> {co}")
    return plan


def _check_aligned(tensors, what):
    """The tensor-core kernels copy 16-byte chunks: every tensor must
    start on a 16-byte boundary (a row slice of a larger tensor may not).
    Raises ValueError before anything is launched."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the tensor-core route needs 16-byte "
                         "aligned tensors")


def _check(x, w, b, stride, padding="darknet"):
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError(
            f"want x (N,H,W,Ci), w (k,k,Ci,Co), b (Co,); got "
            f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    n, h, wd, ci = x.shape
    kh, kw, wci, co = w.shape
    if kh != kw:
        raise ValueError(f"unsupported conv {kh}x{kw} stride {stride}")
    g = conv_geometry(h, wd, kh, stride, padding)
    if wci != ci or b.shape[0] != co:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if x.numel() == 0 or x.numel() > _INT32_MAX \
            or n * g.ho * g.wo * co > _INT32_MAX:
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


def conv_bn_stats_plain(x, w, b, stride=1, want_stats=True,
                        padding="darknet"):
    """Plain PyTorch version: f32 conv on NCHW views, bias, rounding to
    ``x.dtype``, then the statistics of the rounded y."""
    _check(x, w, b, stride, padding)
    xf = x.float().permute(0, 3, 1, 2)
    wf = w.float().permute(3, 2, 0, 1)            # HWIO -> OIHW
    p = _pads(x.shape[1], x.shape[2], w.shape[0], stride, padding)
    if not isinstance(p, int):
        xf = F.pad(xf, p)
        p = 0
    yf = F.conv2d(xf, wf, stride=stride, padding=p)
    yf = yf + b.float().view(1, -1, 1, 1)
    y = yf.to(x.dtype).permute(0, 2, 3, 1).contiguous()
    if not want_stats:
        return y, None, None
    ys = y.float()
    return y, ys.sum(dim=(0, 1, 2)), (ys * ys).sum(dim=(0, 1, 2))


@functools.cache
def _launcher():
    fn = load_library(*SOURCE).conv_bn_stats_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 17 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _forward_cuda(x, w, b, stride, want_stats, dims, padding="darknet"):
    n, h, wd, ci, co, ks = dims
    g = conv_geometry(h, wd, ks, stride, padding)
    plan = _tc_plan(n, h, wd, ci, co, ks, stride, x.dtype, padding)
    y = torch.empty((n, g.ho, g.wo, co), dtype=x.dtype, device=x.device)
    if plan.route == "tc":
        _check_aligned([x, w, y], "conv_bn_stats")
    launch = _launcher()
    s = None
    if want_stats:
        s = torch.zeros((2, co), dtype=torch.float64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                 s[0].data_ptr() if want_stats else None,
                 s[1].data_ptr() if want_stats else None,
                 n, h, wd, ci, co, *g, ks, stride, _DTYPE_CODES[x.dtype],
                 int(want_stats), plan.config, *plan.grid, plan.smem_bytes,
                 stream)
    if err != 0:
        raise RuntimeError(f"conv_bn_stats kernel launch failed: "
                           f"cudaError {err} ({plan})")
    conv_bn_stats.launches += 1
    conv_bn_stats.tc_launches += plan.route == "tc"
    route = "im2col" if plan.config >= _IM2COL else plan.route
    conv_bn_stats.by_geometry[
        geometry_key(ks, stride, padding, route)] += 1
    conv_bn_stats.by_shape[(n, h, wd, ci, co, ks, stride, padding)] += 1
    if not want_stats:
        return y, None, None
    s1, s2 = s.float()
    return y, s1, s2


def _conv_vjp(x, w, g, stride, want_dx, padding="darknet"):
    """(dx, dw) of the NHWC/HWIO conv for the output cotangent g, in the
    compute dtype (dx ``None`` unless ``want_dx``). Where a symmetric pad
    reads the same pixels as the geometry's (1x1, 3x3 stride 1, the
    darknet stride-2 pad on even H and W, whose bottom/right pad is never
    touched, 1x1 stride 2, an explicit pad) the library conv pads; where
    SAME pads more below than above (7x7 and 3x3 at stride 2 on even H,
    2x2) x is padded explicitly, the VJP taken at padding 0, and dx
    cropped."""
    h, wd = x.shape[1:3]
    pad = _pads(h, wd, w.shape[0], stride, padding)
    xc, crop = x.permute(0, 3, 1, 2), None
    if not isinstance(pad, int):
        left, _, top, _ = pad
        xc, crop = F.pad(xc, pad), (top, left)
        pad = 0
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), xc,
        w.permute(3, 2, 0, 1), None, [stride, stride], [pad, pad], [1, 1],
        False, [0, 0], 1, [want_dx, True, False])
    if want_dx and crop is not None:
        top, left = crop
        dx = dx[:, :, top:top + h, left:left + wd]
    return (dx.permute(0, 2, 3, 1) if want_dx else None,
            dw.permute(2, 3, 1, 0))


class _ConvBNStats(torch.autograd.Function):
    """apply(x, w, b, stride, want_stats, plain, padding) -> (y, s1,
    s2)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, want_stats, plain, padding):
        # a cotangent of s1 / s2 that no consumer produced (statistics
        # detached, as the frozen-statistics BatchNorm does) stays None
        ctx.set_materialize_grads(False)
        dims = _check(x, w, b, stride, padding)
        if plain or x.device.type == "cpu":
            y, s1, s2 = conv_bn_stats_plain(x, w, b, stride, want_stats,
                                            padding)
        elif x.device.type == "cuda":
            y, s1, s2 = _forward_cuda(x, w, b, stride, want_stats, dims,
                                      padding)
        else:
            raise ValueError(f"no conv_bn_stats kernel for {x.device}")
        ctx.stride = stride
        ctx.padding = padding
        if not want_stats:
            ctx.save_for_backward(x, w, None)
            return y
        ctx.save_for_backward(x, w, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1=None, ds2=None):
        x, w, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        g = dy
        if ds1 is not None or ds2 is not None:
            gf = dy.float()
            if ds1 is not None:
                gf = gf + ds1.float()
            if ds2 is not None:
                gf = gf + 2.0 * y.float() * ds2.float()
            g = gf.to(dy.dtype)
        db = None
        if ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 1, 2)).to(x.dtype)
        dx, dw = _conv_vjp(x, w, g, ctx.stride, ctx.needs_input_grad[0],
                           ctx.padding)
        return dx, dw, db, None, None, None, None


def _forward_impl(x, w, b, stride, padding):
    dims = _check(x, w, b, stride, padding)
    if x.device.type == "cpu":
        return conv_bn_stats_plain(x, w, b, stride, False, padding)[0]
    if x.device.type == "cuda":
        return _forward_cuda(x, w, b, stride, False, dims, padding)[0]
    raise ValueError(f"no conv_bn_stats kernel for {x.device}")


def _padding_of(text):
    """The op's ``padding`` string (``str(padding)``) as the wrappers
    take it."""
    return int(text) if text.isdigit() else text


@torch.library.custom_op("tf2_yolo_tpu_torch::conv_bn_forward",
                         mutates_args=())
def _forward_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                stride: int, padding: str = "darknet") -> torch.Tensor:
    return _forward_impl(x, w, b, stride, _padding_of(padding))


@_forward_op.register_fake
def _(x, w, b, stride, padding="darknet"):
    n, h, wd, _ = x.shape
    g = conv_geometry(h, wd, w.shape[0], stride, _padding_of(padding))
    return x.new_empty((n, g.ho, g.wo, w.shape[-1]))


def geometry_key(ksize, stride, padding="darknet", route="tc"):
    """The key of ``conv_bn_stats.by_geometry``: e.g. ``"3x3s2 same
    tc"``; the darknet pad is ``"darknet"`` at stride 2 and the only pad
    of a stride-1 conv (``"same"``); an int pad p is ``"padp"``
    (``"7x7s2 pad3 im2col"``). The route is ``"tc"`` (the ring),
    ``"im2col"`` (the small-Ci tensor-core kernel) or ``"cuda_core"``."""
    kind = f"pad{padding}" if type(padding) is int else \
        "darknet" if stride == 2 and padding == "darknet" else "same"
    return f"{ksize}x{ksize}s{stride} {kind} {route}"


def conv_bn_stats(x, w, b, stride=1, want_stats=True, plain=False,
                  padding="darknet"):
    """See the module docstring. CPU tensors take the plain version;
    CUDA tensors launch the kernel, or raise. ``plain=True`` forces the
    plain version on any device (the reference route).
    ``padding`` (:func:`conv_geometry`): ``"darknet"``, ``"same"`` or
    an int."""
    if not (want_stats or plain) and torch.compiler.is_compiling():
        return _forward_op(x, w, b, stride, str(padding)), None, None
    out = _ConvBNStats.apply(x, w, b, stride, want_stats, plain, padding)
    return out if want_stats else (out, None, None)


conv_bn_stats.launches = 0
conv_bn_stats.tc_launches = 0
# launches by geometry_key(ksize, stride, padding, route)
conv_bn_stats.by_geometry = collections.Counter()
# launches by (n, h, w, ci, co, ksize, stride, padding)
conv_bn_stats.by_shape = collections.Counter()
