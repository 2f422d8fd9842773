"""Fused prologue + 3x3 conv + BN-statistic sums (NHWC), with its backward.

``fused_conv3x3(x4, w, affine, stride, act, dtype)`` returns
``(y4, s1, s2)``:

    g  = act(x4 * a + b) in f32, rounded to ``dtype``, for
         ``affine = (a, b)``; x4 as it is for ``None``. Outside the image
         g is 0 (the window's padding applies AFTER the prologue)
    y4 = conv3x3(g, w) accumulated in f32, rounded to ``dtype``:
         stride 1 SAME, or stride 2 with the darknet pad (one zero row on
         top, one zero column on the left, then VALID; H and W even)
    s1 = sum y4, s2 = sum y4 * y4 over B*Ho*Wo     [N] f32, of the
         ROUNDED y4

``x4`` is the producer's RAW NHWC output [B, H, W, K] and ``affine`` its
BatchNorm affine, so neither the normalised nor the activated tensor is
ever stored. ``w`` is [3, 3, K, N] (HWIO, the flax layout). It is
differentiable: a ``torch.autograd.Function`` whose forward and backward
both launch hand-written kernels on CUDA tensors.

Backward, from the stored y (the TPU kernels' arithmetic, rounding by
rounding): dyf = T(dy + y * (2 ds2)); dg = the transposed conv of dyf plus,
in f32, ds1 @ w_tap^T for every tap whose output pixel exists (ds1 stays
apart from dyf and is not rounded: a constant pre-added into a bf16 sum
would swamp small dy entries); dx = T(dg * act'(z) * a); da = sum dg *
act'(z) * x, db = sum dg * act'(z) (f32); dW_tap = shift(g)^T @
T(dyf + ds1) (f32).

Source note. On CUDA tensors this launches ``csrc/fused_conv3x3.cu``, the
Hopper port of the Pallas TPU kernels ``_fwd_s1_kernel``,
``_fwd_s2_kernel``, ``_bwd_s1_kernel`` and ``_bwd_s2_kernel``
(tf2_yolo_tpu/ops/pallas/packed_conv3x3.py, reached through ``_fwd_call``
and ``_bwd_call``). Both directions have two routes, chosen by shape in
:func:`_tc_plan` and :func:`_tc_bwd_plan`: bf16 with K % 16 == 0 and N % 8
== 0 (all five layers of ``packed=3``) runs on the tensor cores
(``mma.sync`` bf16 -> f32 fed by ``ldmatrix``); f32 (whose tensor-core
route would be TF32) and K = 3 run on the CUDA cores, implicit GEMMs that
gather their window by index and recompute the prologue once per tap.

- Forward on the tensor cores: one block per 8 x 16 output pixels and
  all of N <= 128; per slice of 16 input channels it stages the raw input
  halo with ``cp.async``, runs the prologue once per halo element, and
  feeds nine shifted tiles of the activated halo to ``mma.sync``. It is
  bound by bytes and by the prologue's f32 arithmetic.
- Backward on the tensor cores, three launches: a tiny pass folds ds1
  into a per-(tap, k) f32 table ``sum_n ds1[n] w[tap, k, n]``; the dx
  kernel (one block per 8 x 16 output-grid positions: at stride 2 the
  input pixels of all four parity classes there, each reached by only 1,
  2 or 4 taps; slices of 16 output channels through a two-stage
  ``cp.async`` ring) builds e = T(dy + 2 y ds2) once per element of the
  tile's output-pixel halo and adds the table entries of the taps whose
  output pixel exists in its epilogue, with dx and the da/db
  reductions; the dW kernel (one warp per tap, 32 input x 64 output
  channels a block) activates the input halo and builds T(dyf + ds1)
  once per element per tile, contracts over pixels, and adds its
  chunk's sums into dW with f32 atomics.
- On the CUDA cores the backward is two launches: dx with the da/db
  reductions (by parity class at stride 2), and a split-M dW (chunks of
  1024 output pixels); ds1 is added to e in f32 in the operand.

``fused_conv3x3.launches`` counts every forward launch,
``fused_conv3x3.tc_launches`` those on the tensor cores;
``fused_conv3x3.bwd_launches`` counts every backward call,
``fused_conv3x3.tc_bwd_launches`` those whose kernels ran on the tensor
cores. The tensor-core routes raise on a tensor that does not start on a
16-byte boundary. The fold ``dy + 2 y ds2``, a separate pass before the
TPU kernel, happens in the kernels' loads. The sums over all pixels (s1,
s2, da, db) are per-block f32 partials added with f64 atomics and
rounded to f32 here, so block order does not show in them; dW is added
with f32 atomics (one per block), so its last bits depend on block
order. On CPU tensors it computes :func:`fused_conv3x3_plain` and
:func:`fused_conv3x3_bwd_plain`.

Not carried over (TPU machinery): the (h, w, b)-major row layout with its
``spatial`` argument, the halo blocks with clamped index maps and edge
gates, ``BLOCK_ROWS`` / ``_chunk_cols``, the even/odd ``dx0``/``dx1``
interleave of the stride-2 backward, and the ``im2col`` flag (an
MXU-occupancy variant of the same function: the one kernel here also
takes K as small as 3).
"""

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.nn.grad import conv2d_input, conv2d_weight

from ._build import load_library
from .conv_bn import _SMS, SMEM_MAX, Plan, _check_aligned
from .conv_bn import _TC_TILES as _DX_TILES
from .fused_gemm import _ACT_CODES, _DTYPE_CODES, _prologue

# source and extra nvcc flags: no contraction, so the f32 prologue
# rounds as the plain version does
SOURCE = ("fused_conv3x3.cu", ("--fmad=false",))
_INT32_MAX = 2 ** 31 - 1
_DW_CHUNK = 1024               # output pixels per dW block (M_CHUNK)
# the forward's tensor-core tiles: 8 x 16 output pixels; slices of 16
# input channels; BN by config id
_TC_TH, _TC_TW, _TC_KC = 8, 16, 16
_TC_TILES = {0: (128, 2), 1: (64, 4)}  # config: (BN, warps along M)
_CC_TILE = 64                          # the CUDA-core kernel's BM = BN
# the backward's tensor-core tiles: dx takes BN of K by config (the
# conv's tiles, _DX_TILES); dW blocks of 32 input x 64 output channels,
# 9 warps
_DW_KC, _DW_BN = 32, 64


def _tc_smem(config, stride):
    """Bytes of dynamic shared memory of the tensor-core forward: the
    halo of one slice ((s*7 + 3) x (s*15 + 3) pixels, rows of 16 + 8
    bf16) and its nine weight taps (rows of BN + 8), or the epilogue, as
    ``HaloSmem`` in fused_conv3x3.cu."""
    bn, warps_m = _TC_TILES[config]
    halo = (stride * (_TC_TH - 1) + 3) * (stride * (_TC_TW - 1) + 3)
    main = (halo * (_TC_KC + 8) + 9 * _TC_KC * (bn + 8)) * 2
    epilogue = 128 * (bn + 8) * 2 + 2 * warps_m * bn * 4
    return max(main, epilogue)


def _tc_plan(bsz, h, wd, k, n, stride, dtype):
    """The forward's launch plan (pure Python: the CPU tests reach it).
    bf16 with K % 16 == 0 and N % 8 == 0 takes the tensor cores: grid
    (tiles of 8 x 16 output pixels of an image, column blocks of BN = 64
    for N <= 64 or else 128, images); anything else of a supported dtype
    (f32, K = 3) the CUDA-core kernel: grid (64-row blocks of B*Ho*Wo,
    64-column blocks). Raises ValueError on a shape the kernels do not
    take."""
    if stride not in (1, 2):
        raise ValueError(f"unsupported stride {stride}")
    if stride == 2 and (h % 2 or wd % 2):
        raise ValueError(f"stride 2 needs even H and W, got {h}x{wd}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {dtype}")
    if min(bsz, h, wd, k, n) < 1:
        raise ValueError(f"empty conv {(bsz, h, wd, k)} -> {n}")
    ho, wo = h // stride, wd // stride
    if dtype == torch.bfloat16 and k % _TC_KC == 0 and n % 8 == 0:
        config = 1 if n <= 64 else 0
        tiles = -(-ho // _TC_TH) * -(-wo // _TC_TW)
        plan = Plan("tc", config, (tiles, -(-n // _TC_TILES[config][0]), bsz),
                    _tc_smem(config, stride))
    else:
        plan = Plan("cuda_core", -1, (-(-bsz * ho * wo // _CC_TILE),
                                      -(-n // _CC_TILE), 1), 0)
    if plan.grid[0] > _INT32_MAX or max(plan.grid[1:]) > 65535 \
            or plan.smem_bytes > SMEM_MAX:
        raise ValueError(f"unsupported size {(bsz, h, wd, k)} -> {n}")
    return plan


class BwdPlan(NamedTuple):
    """How one backward launches: ``route`` "tc" or "cuda_core"; the dx
    kernel's tile ``dx_config`` (-1 on the CUDA cores), ``dx_grid`` and
    ``dx_smem``; the dW kernel's ``dw_grid`` (x: chunks of output pixels)
    and ``dw_smem`` (0 on the CUDA cores: static shared memory)."""
    route: str
    dx_config: int
    dx_grid: tuple
    dx_smem: int
    dw_grid: tuple
    dw_smem: int


def _tc_bwd_smem(dx_config, stride):
    """Bytes of dynamic shared memory of the tensor-core dx kernel (two
    stages of: the output-pixel halo of a slice of 16 channels as e, rows
    of 16 + 8 bf16, and as raw y, rows of 16; the nine taps' weight rows,
    BN of 16 + 8 each; or the epilogue; then the [9][BN] f32 ds1 table
    and its [classes][BN] sums) and of the dW kernel (the input halo of
    32 channels, rows of 32 + 8; dyt, 128 rows of 64 + 8; raw y, 128 rows
    of 64), as ``DxSmem`` and ``DwSmem`` in fused_conv3x3.cu."""
    bn, warps_m = _DX_TILES[dx_config]
    eh, ew = (_TC_TH + 2, _TC_TW + 2) if stride == 1 else (_TC_TH + 1,
                                                          _TC_TW + 1)
    main = 2 * (eh * ew * (_TC_KC + 8) + eh * ew * _TC_KC
                + 9 * bn * (_TC_KC + 8)) * 2
    epilogue = 128 * (bn + 8) * 2 + 2 * warps_m * bn * 4
    dx = -(-max(main, epilogue) // 16) * 16 \
        + (9 + stride * stride) * bn * 4
    halo = (stride * (_TC_TH - 1) + 3) * (stride * (_TC_TW - 1) + 3)
    dw = (halo * (_DW_KC + 8) + 128 * (_DW_BN + 8) + 128 * _DW_BN) * 2
    return dx, dw


def _tc_bwd_plan(bsz, h, wd, k, n, stride, dtype):
    """The backward's launch plan (pure Python: the CPU tests reach it).
    bf16 with K % 16 == 0 and N % 8 == 0 takes the tensor cores: dx grid
    (tiles of 8 x 16 output-grid positions, each the input pixels of all
    parity classes there; column blocks of BN = 32, 64 or 128: at stride
    1 the narrowest that holds K, else 128, at stride 2 always 32, which
    holds the four classes' accumulators; images);
    dW grid (chunks of output-pixel tiles, blocks of 32 input x 64 output
    channels), with about two blocks per SM in all. Anything else of a
    supported dtype (f32, K = 3) the CUDA-core kernels: dx grid (64-row
    blocks of a class's pixels, 64-column blocks, classes), dW grid
    (64-row blocks of 9K, 64-column blocks, chunks of 1024 output
    pixels). Raises ValueError on a shape the kernels do not take."""
    if stride not in (1, 2):
        raise ValueError(f"unsupported stride {stride}")
    if stride == 2 and (h % 2 or wd % 2):
        raise ValueError(f"stride 2 needs even H and W, got {h}x{wd}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {dtype}")
    if min(bsz, h, wd, k, n) < 1:
        raise ValueError(f"empty conv {(bsz, h, wd, k)} -> {n}")
    ho, wo = h // stride, wd // stride
    classes = stride * stride
    if dtype == torch.bfloat16 and k % _TC_KC == 0 and n % 8 == 0:
        config = 2 if k <= 32 or stride == 2 else 1 if k <= 64 else 0
        dx_grid = (-(-ho // _TC_TH) * -(-wo // _TC_TW),
                   -(-k // _DX_TILES[config][0]), bsz)
        tiles = bsz * -(-ho // _TC_TH) * -(-wo // _TC_TW)
        blocks = -(-k // _DW_KC) * -(-n // _DW_BN)
        per_chunk = -(-tiles // -(-2 * _SMS // blocks))
        dx_smem, dw_smem = _tc_bwd_smem(config, stride)
        plan = BwdPlan("tc", config, dx_grid, dx_smem,
                       (-(-tiles // per_chunk), blocks, 1), dw_smem)
    else:
        plan = BwdPlan(
            "cuda_core", -1,
            (-(-bsz * ho * wo // _CC_TILE), -(-k // _CC_TILE), classes), 0,
            (-(-9 * k // _CC_TILE), -(-n // _CC_TILE),
             -(-bsz * ho * wo // _DW_CHUNK)), 0)
    grids = plan.dx_grid + plan.dw_grid
    if max(grids[0], grids[3]) > _INT32_MAX \
            or max(grids[1:3] + grids[4:]) > 65535 \
            or max(plan.dx_smem, plan.dw_smem) > SMEM_MAX:
        raise ValueError(f"unsupported size {(bsz, h, wd, k)} -> {n}")
    return plan


def _check(x4, w, a, b, stride, act):
    if act not in _ACT_CODES:
        raise ValueError(f"unsupported fused-conv activation: {act!r}")
    if stride not in (1, 2):
        raise ValueError(f"unsupported stride {stride}")
    if x4.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (
            3, 3, x4.shape[-1]) or w.shape[-1] < 1:
        raise ValueError(f"want x [B, H, W, K] and w [3, 3, K, N], got "
                         f"{tuple(x4.shape)}, {tuple(w.shape)}")
    bsz, h, wd, k = x4.shape
    n = w.shape[-1]
    if min(bsz, h, wd, k) < 1:
        raise ValueError(f"empty input {tuple(x4.shape)}")
    if stride == 2 and (h % 2 or wd % 2):
        raise ValueError(f"stride 2 needs even H and W, got {h}x{wd}")
    if x4.dtype not in _DTYPE_CODES or w.dtype != x4.dtype:
        raise TypeError(f"want x and w in one dtype of "
                        f"{list(_DTYPE_CODES)}, got {x4.dtype}, {w.dtype}")
    if (a is None) != (b is None):
        raise ValueError("an affine is a pair (a, b) or None")
    tensors = [x4, w]
    if a is not None:
        if a.shape != (k,) or b.shape != a.shape \
                or a.dtype != torch.float32 or b.dtype != torch.float32:
            raise ValueError(
                f"want a, b f32 of shape ({k},), got {tuple(a.shape)} "
                f"{a.dtype}, {tuple(b.shape)} {b.dtype}")
        tensors += [a, b]
    for t in tensors:
        if t.device != x4.device:
            raise ValueError(f"tensors on {t.device} and {x4.device}")
        if not t.is_contiguous():
            raise ValueError("x, w, a and b must be contiguous")
    ho, wo = h // stride, wd // stride
    # the kernels index elements in 64 bits; pixel counts and the dW
    # kernel's chunk count (grid.z) are what is bounded
    if bsz * h * wd > _INT32_MAX or bsz * ho * wo > 65535 * _DW_CHUNK:
        raise ValueError(f"unsupported size {tuple(x4.shape)} -> {n}")
    return bsz, h, wd, k, n, ho, wo


def _nchw(t4):
    """NHWC tensor as an NCHW view (no copy)."""
    return t4.permute(0, 3, 1, 2)


def _oihw(w):
    return w.float().permute(3, 2, 0, 1)           # HWIO -> OIHW


def fused_conv3x3_plain(x4, w, a, b, stride=1, act="mish"):
    """Plain forward: the f32 prologue rounded to the compute dtype, a
    conv of it accumulated in f32 (its zero padding applies to g, after
    the prologue), rounded to the compute dtype, then the statistics of
    the rounded y. On even H and W the darknet stride-2 window (top/left
    pad, then VALID) reads the same pixels as a symmetric pad of 1 whose
    bottom/right edge is never touched, so one padding rule serves."""
    g = x4 if a is None else _prologue(x4, a, b, act)[0]
    yf = torch.nn.functional.conv2d(_nchw(g.float()), _oihw(w),
                                    stride=stride, padding=1)
    y = yf.to(x4.dtype).permute(0, 2, 3, 1).contiguous()
    ys = y.float()
    return y, ys.sum(dim=(0, 1, 2)), (ys * ys).sum(dim=(0, 1, 2))


def fused_conv3x3_bwd_plain(x4, w, a, b, y, dy, ds1, ds2, stride=1,
                            act="mish"):
    """Plain backward from the stored y: returns (dx, dW, da, db) with dx
    in the compute dtype and dW [3, 3, K, N], da, db in f32 (da, db
    ``None`` without a prologue). The roundings are the TPU kernels':
    dyf = T(dy + 2 y ds2) once; the ds1 term enters dg in f32, as the
    transposed conv of a constant image (a tap adds ds1 @ w_tap^T exactly
    where its output pixel exists); dW takes T(dyf + ds1)."""
    dt = y.dtype
    bsz, h, wd, k = x4.shape
    ho, wo, n = y.shape[1:]
    wf = _oihw(w)
    dyf = (dy.float() + y.float() * (2.0 * ds2)).to(dt)
    dg = conv2d_input((bsz, k, h, wd), wf, _nchw(dyf.float()), stride, 1)
    const = conv2d_input(
        (1, k, h, wd), wf,
        ds1.view(1, n, 1, 1).expand(1, n, ho, wo).contiguous(), stride, 1)
    dg = (dg + const).permute(0, 2, 3, 1)
    if a is None:
        g = x4
        dx, da, db = dg.to(dt), None, None
    else:
        g, gp, xf = _prologue(x4, a, b, act)
        dz = dg * gp
        dx = (dz * a).to(dt)
        da = (dz * xf).sum(dim=(0, 1, 2))
        db = dz.sum(dim=(0, 1, 2))
    dyt = (dyf.float() + ds1).to(dt)
    dw = conv2d_weight(_nchw(g.float()), wf.shape, _nchw(dyt.float()),
                       stride, 1)
    return dx.contiguous(), dw.permute(2, 3, 1, 0).contiguous(), da, db


@functools.cache
def _library():
    lib = load_library(*SOURCE)
    lib.fused_conv3x3_fwd_launch.argtypes = [ctypes.c_void_p] * 7 \
        + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    lib.fused_conv3x3_fwd_launch.restype = ctypes.c_int
    lib.fused_conv3x3_bwd_launch.argtypes = [ctypes.c_void_p] * 12 \
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.fused_conv3x3_bwd_launch.restype = ctypes.c_int
    lib.fused_conv3x3_bwd_tc_launch.argtypes = [ctypes.c_void_p] * 13 \
        + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    lib.fused_conv3x3_bwd_tc_launch.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward_cuda(x4, w, a, b, stride, act, dims):
    bsz, h, wd, k, n, ho, wo = dims
    plan = _tc_plan(bsz, h, wd, k, n, stride, x4.dtype)
    y = torch.empty((bsz, ho, wo, n), dtype=x4.dtype, device=x4.device)
    s = torch.zeros((2, n), dtype=torch.float64, device=x4.device)
    if plan.route == "tc":
        _check_aligned([x4, w, y], "fused_conv3x3")
    lib = _library()
    err = lib.fused_conv3x3_fwd_launch(
        x4.data_ptr(), w.data_ptr(), _ptr(a), _ptr(b), y.data_ptr(),
        s[0].data_ptr(), s[1].data_ptr(), bsz, h, wd, k, n, stride,
        _DTYPE_CODES[x4.dtype], _ACT_CODES[act], plan.config, *plan.grid,
        plan.smem_bytes, torch.cuda.current_stream(x4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_conv3x3 forward launch failed: "
                           f"cudaError {err} ({plan})")
    fused_conv3x3.launches += 1
    fused_conv3x3.tc_launches += plan.route == "tc"
    s1, s2 = s.float()
    return y, s1, s2


def _backward_cuda(x4, w, a, b, y, dy, ds1, ds2, stride, act):
    bsz, h, wd, k = x4.shape
    n = y.shape[-1]
    plan = _tc_bwd_plan(bsz, h, wd, k, n, stride, y.dtype)
    dx = torch.empty_like(x4)
    dw = torch.zeros((3, 3, k, n), dtype=torch.float32, device=x4.device)
    dab = None
    if a is not None:
        dab = torch.zeros((2, k), dtype=torch.float64, device=x4.device)
    if plan.route == "tc":
        _check_aligned([x4, w, y, dy, dx], "fused_conv3x3 backward")
    lib = _library()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    head = (x4.data_ptr(), w.data_ptr(), _ptr(a), _ptr(b), y.data_ptr(),
            dy.data_ptr(), ds1.data_ptr(), ds2.data_ptr())
    tail = (dx.data_ptr(), dw.data_ptr(),
            None if dab is None else dab[0].data_ptr(),
            None if dab is None else dab[1].data_ptr(), bsz, h, wd, k, n,
            stride)
    if plan.route == "tc":
        ctab = torch.empty(9 * k, dtype=torch.float32, device=x4.device)
        err = lib.fused_conv3x3_bwd_tc_launch(
            *head, ctab.data_ptr(), *tail, _ACT_CODES[act], plan.dx_config,
            *plan.dx_grid, plan.dx_smem, *plan.dw_grid[:2], plan.dw_smem,
            stream)
    else:
        err = lib.fused_conv3x3_bwd_launch(
            *head, *tail, _DTYPE_CODES[y.dtype], _ACT_CODES[act], stream)
    if err != 0:
        raise RuntimeError(f"fused_conv3x3 backward launch failed: "
                           f"cudaError {err} ({plan})")
    # one count per call: all its kernels
    fused_conv3x3.bwd_launches += 1
    fused_conv3x3.tc_bwd_launches += plan.route == "tc"
    da, db = (None, None) if dab is None else dab.float()
    return dx, dw, da, db


class _FusedConv3x3(torch.autograd.Function):
    """apply(x4, w, a, b, stride, act, plain) -> (y4, s1, s2)."""

    @staticmethod
    def forward(ctx, x4, w, a, b, stride, act, plain):
        dims = _check(x4, w, a, b, stride, act)
        device = x4.device.type
        if plain or device == "cpu":
            y, s1, s2 = fused_conv3x3_plain(x4, w, a, b, stride, act)
        elif device == "cuda":
            y, s1, s2 = _forward_cuda(x4, w, a, b, stride, act, dims)
        else:
            raise ValueError(f"no fused_conv3x3 kernel for {x4.device}")
        ctx.stride, ctx.act, ctx.plain = stride, act, plain
        ctx.save_for_backward(x4, w, a, b, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x4, w, a, b, y = ctx.saved_tensors
        dy = dy.contiguous()
        ds1 = ds1.float().contiguous()
        ds2 = ds2.float().contiguous()
        if ctx.plain or y.device.type == "cpu":
            dx, dw, da, db = fused_conv3x3_bwd_plain(
                x4, w, a, b, y, dy, ds1, ds2, ctx.stride, ctx.act)
        else:
            dx, dw, da, db = _backward_cuda(
                x4, w, a, b, y, dy, ds1, ds2, ctx.stride, ctx.act)
        # the cotangent takes the primal's dtype: one last rounding of
        # the f32 dW to the compute dtype, as at fused_gemm's
        return dx, dw.to(w.dtype), da, db, None, None, None


def fused_conv3x3(x4, w, affine, stride=1, act="mish", dtype=torch.bfloat16,
                  plain=False):
    """See the module docstring. ``x4``: raw NHWC [B, H, W, K]; ``w``:
    [3, 3, K, N] HWIO; ``affine``: ``None`` or ``(a, b)`` broadcastable
    to [K]. ``act`` is the PRODUCER's activation, applied in the input
    read. Inputs are cast to ``dtype``. CPU tensors take the plain
    version; CUDA tensors launch the kernels, or raise. ``plain=True``
    forces the plain version on any device (the reference route)."""
    a = b = None
    if affine is not None:
        k = x4.shape[-1]
        a = affine[0].reshape(k).float().contiguous()
        b = affine[1].reshape(k).float().contiguous()
    return _FusedConv3x3.apply(x4.to(dtype).contiguous(),
                               w.to(dtype).contiguous(), a, b, stride, act,
                               plain)


fused_conv3x3.launches = 0
fused_conv3x3.tc_launches = 0
fused_conv3x3.bwd_launches = 0
fused_conv3x3.tc_bwd_launches = 0
