"""Fused prologue + 1x1-conv GEMM + BN-statistic sums, with its backward.

``fused_gemm(xs, ws, affines, act, dtype)`` returns ``(y, s1, s2)``:

    y  = sum_i g_i @ w_i                       [M, N] in ``dtype``
    g_i = act(x_i * a_i + b_i) in f32, rounded to ``dtype``, for an input
          with ``affines[i] = (a_i, b_i)``; x_i as it is for ``None``
    s1 = sum_m y,  s2 = sum_m y * y            [N] f32, of the ROUNDED y

Several inputs express a channel concat that is never stored (each w_i a
row slice of the concat's kernel) or, with equal w_i, a sum of activated
terms. It is differentiable: a ``torch.autograd.Function`` whose forward
and backward both launch hand-written kernels on CUDA tensors.

Source note. On CUDA tensors this launches ``csrc/fused_gemm.cu``, the
Hopper port of the Pallas TPU kernels ``_fwd_kernel`` and ``_bwd_kernel``
(tf2_yolo_tpu/ops/pallas/packed_gemm.py, reached through ``_fwd_call``
and ``_bwd_call``). The forward has two kernels, one per route, chosen by
shape in :func:`_tc_plan`: bf16 with every K_i % 8 == 0 and N % 8 == 0
(all 43 GEMMs of a ``packed=3`` step) runs on the tensor cores
(``mma.sync`` bf16 -> f32 fed by ``ldmatrix`` from a 4-stage ``cp.async``
ring; 128-row tiles of 128, 64 or 32 columns; an input with a prologue is
activated once per element in shared memory per column block), bound by
bytes and by the prologue's f32 arithmetic; f32 (whose tensor-core route
would be TF32) runs on the CUDA cores, tiled f32-FMA GEMMs bounded by
their FMA rate. ``fused_gemm.launches`` counts every forward launch,
``fused_gemm.tc_launches`` those on the tensor cores. The backward (CUDA
cores) reads the stored y instead of recomputing it (the consumer keeps y
alive anyway), and is two launches per input: dx with the da/db
reductions, and a split-M dW. The column sums over M (s1, s2, da, db) are
per-block f32 partials added with f64 atomics and rounded to f32 here,
so block order does not show in them; dW is added with f32 atomics (one
per chunk of 1024 rows), so its last bits depend on block order. On CPU
tensors it computes :func:`fused_gemm_plain` and
:func:`fused_gemm_bwd_plain`, which repeat the TPU kernels' arithmetic
step by step with the same roundings. The TPU row-block sizing
(``mblk_fwd``/``mblk_bwd``) is not carried over: any M >= 1 is taken.
"""

import ctypes
import functools

import torch

from ._build import load_library
from .conv_bn import _SMS, _TC_BM, _TC_TILES, SMEM_MAX, Plan, _tc_smem

# source and extra nvcc flags: no contraction, so the f32 prologue
# rounds as the plain version does
SOURCE = ("fused_gemm.cu", ("--fmad=false",))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"mish": 0, "leaky": 1, "linear": 2}
MAX_INPUTS = 9
_INT32_MAX = 2 ** 31 - 1
_CC_TILE = 64                          # the CUDA-core kernel's BM = BN


def act_and_grad(z, act):
    """Activation value and derivative at ``z`` (f32). Mish is the
    reused-exponential training form with the exponent clamped at 20."""
    if act == "mish":
        u = torch.exp(torch.clamp(z, max=20.0))
        d = (1.0 + u) * (1.0 + u) + 1.0
        c = 1.0 - 2.0 / d
        g = z * c
        # dg/dz = c + z * (2/d^2) * 2(1+u)u; beyond the clamp c is
        # constant and the second term vanishes
        gp = c + z * (2.0 / (d * d)) * (2.0 * (1.0 + u) * u)
        return g, gp
    if act == "leaky":
        pos = z >= 0
        return (torch.where(pos, z, z * 0.1),
                torch.where(pos, torch.ones_like(z),
                            torch.full_like(z, 0.1)))
    if act == "linear":
        return z, torch.ones_like(z)
    raise ValueError(f"unsupported fused-gemm activation: {act!r}")


def _prologue(x, a, b, act):
    """f32 prologue: (g in x.dtype for the product, g' in f32, x in f32)."""
    xf = x.float()
    g, gp = act_and_grad(xf * a + b, act)
    return g.to(x.dtype), gp, xf


def _tc_plan(m, ks, n, dtype):
    """The forward's launch plan (pure Python: the CPU tests reach it).
    bf16 with every K_i % 8 == 0 and N % 8 == 0 (16-byte rows) takes the
    tensor cores, with the widest tile of 128, 64 or 32 columns that N
    fills, halved while the grid would not cover the 132 SMs once: grid
    (128-row blocks, column blocks); the tiles and the ring of 4 slices
    32 deep are the conv's (``conv_bn._TC_TILES``, ``tc::Ring``).
    Anything else of a supported dtype (f32) takes the CUDA-core kernel:
    grid (64-row blocks, 64-column blocks). Raises ValueError on a shape
    the kernels do not take."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {dtype}")
    if not 1 <= len(ks) <= MAX_INPUTS or min(m, n, *ks) < 1:
        raise ValueError(f"unsupported gemm M={m}, K={list(ks)}, N={n}")
    if dtype == torch.bfloat16 and all(k % 8 == 0 for k in ks) \
            and n % 8 == 0:
        config = next(c for c, (bn, _) in _TC_TILES.items()
                      if bn <= n or c == 2)
        grid = lambda c: (-(-m // _TC_BM), -(-n // _TC_TILES[c][0]))
        while config < 2 and grid(config)[0] * grid(config)[1] < _SMS:
            config += 1
        plan = Plan("tc", config, grid(config), _tc_smem(config))
    else:
        plan = Plan("cuda_core", -1, (-(-m // _CC_TILE), -(-n // _CC_TILE)),
                    0)
    if plan.grid[0] > _INT32_MAX or plan.grid[1] > 65535 \
            or plan.smem_bytes > SMEM_MAX:
        raise ValueError(f"unsupported gemm M={m}, K={list(ks)}, N={n}")
    return plan


def _check(xs, ws, aas, bbs, act):
    if act not in _ACT_CODES:
        raise ValueError(f"unsupported fused-gemm activation: {act!r}")
    nx = len(xs)
    if not (1 <= nx <= MAX_INPUTS and len(ws) == len(aas) == len(bbs) == nx):
        raise ValueError(f"want 1..{MAX_INPUTS} inputs with a weight and an "
                         f"affine entry each, got {nx}")
    x0 = xs[0]
    if x0.dtype not in _DTYPE_CODES:
        raise TypeError(f"want one dtype of {list(_DTYPE_CODES)}, got "
                        f"{x0.dtype}")
    if x0.dim() != 2 or x0.shape[0] < 1:
        raise ValueError(f"want x [M, K] with M >= 1, got {tuple(x0.shape)}")
    m, n = x0.shape[0], ws[0].shape[-1]
    for x, w, a, b in zip(xs, ws, aas, bbs):
        if x.dim() != 2 or w.dim() != 2 or x.shape[0] != m \
                or w.shape != (x.shape[1], n) or x.shape[1] < 1 or n < 1:
            raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                             f"w {tuple(w.shape)}, M {m}, N {n}")
        if x.dtype != x0.dtype or w.dtype != x0.dtype:
            raise TypeError(f"want x and w in {x0.dtype}, got {x.dtype}, "
                            f"{w.dtype}")
        if (a is None) != (b is None):
            raise ValueError("an affine is a pair (a, b) or None")
        tensors = [x, w]
        if a is not None:
            if a.shape != (x.shape[1],) or b.shape != a.shape \
                    or a.dtype != torch.float32 or b.dtype != torch.float32:
                raise ValueError(
                    f"want a, b f32 of shape ({x.shape[1]},), got "
                    f"{tuple(a.shape)} {a.dtype}, {tuple(b.shape)} {b.dtype}")
            tensors += [a, b]
        for t in tensors:
            if t.device != x0.device:
                raise ValueError(f"tensors on {t.device} and {x0.device}")
            if not t.is_contiguous():
                raise ValueError("x, w, a and b must be contiguous")
        if x.numel() > _INT32_MAX or m * n > _INT32_MAX:
            raise ValueError(f"unsupported size {tuple(x.shape)} -> {n}")
    return m, n


def fused_gemm_plain(xs, ws, aas, bbs, act):
    """Plain forward: per input the f32 prologue rounded to the compute
    dtype, a product accumulated in f32, the sum rounded to the compute
    dtype, then the statistics of the rounded y."""
    acc = None
    for x, w, a, b in zip(xs, ws, aas, bbs):
        g = x if a is None else _prologue(x, a, b, act)[0]
        part = g.float() @ w.float()
        acc = part if acc is None else acc + part
    y = acc.to(xs[0].dtype)
    yf = y.float()
    return y, yf.sum(dim=0), (yf * yf).sum(dim=0)


def fused_gemm_bwd_plain(xs, ws, aas, bbs, y, dy, ds1, ds2, act):
    """Plain backward from the stored y: returns (dxs, dws, das, dbs)
    with dx in the compute dtype and dW, da, db in f32 (da, db ``None``
    for an input without a prologue).

    The total cotangent of y is dy + ds1 + 2 y ds2. For dx it is split
    per term, each rounded to the compute dtype at its own scale (one
    pre-rounded sum lets the constant ds1 term swamp small dy entries);
    only dW takes the summed, rounded cotangent."""
    dt = y.dtype
    yf = y.float()
    yds2 = y * (2.0 * ds2).to(dt)
    dyt = (dy.float() + ds1 + 2.0 * yf * ds2).to(dt)
    ds1_row = ds1.to(dt).float()[None, :]
    dxs, dws, das, dbs = [], [], [], []
    for x, w, a, b in zip(xs, ws, aas, bbs):
        wt = w.float().t()
        dg = dy.float() @ wt + yds2.float() @ wt + ds1_row @ wt
        if a is None:
            g = x
            dxs.append(dg.to(dt))
            das.append(None)
            dbs.append(None)
        else:
            g, gp, xf = _prologue(x, a, b, act)
            dz = dg * gp
            dxs.append((dz * a).to(dt))
            das.append((dz * xf).sum(dim=0))
            dbs.append(dz.sum(dim=0))
        dws.append(g.float().t() @ dyt.float())
    return dxs, dws, das, dbs


@functools.cache
def _library():
    lib = load_library(*SOURCE)
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    ints = ctypes.POINTER(ctypes.c_int)
    lib.fused_gemm_fwd_launch.argtypes = [
        ptrs, ptrs, ptrs, ptrs, ints, ctypes.c_int] \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.fused_gemm_fwd_launch.restype = ctypes.c_int
    lib.fused_gemm_fwd_tc_launch.argtypes = [
        ptrs, ptrs, ptrs, ptrs, ints, ctypes.c_int] \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.fused_gemm_fwd_tc_launch.restype = ctypes.c_int
    lib.fused_gemm_bwd_launch.argtypes = [ctypes.c_void_p] * 12 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.fused_gemm_bwd_launch.restype = ctypes.c_int
    return lib


def _ptr_array(tensors):
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _check_aligned(tensors, what):
    """The tensor-core kernels copy 16-byte chunks: every tensor must
    start on a 16-byte boundary (a row slice of a larger tensor may not)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the tensor-core route needs 16-byte "
                         "aligned tensors")


def _forward_cuda(xs, ws, aas, bbs, act, m, n, raw_stats=False):
    """Launch the forward kernel of the plan's route. ``raw_stats`` sums
    the f32 product before it is rounded (the probe kernel of
    ``tools/bench_packed_probe.py``, which counts its own launches).
    Returns (y, s1, s2) and the plan."""
    x0 = xs[0]
    plan = _tc_plan(m, [x.shape[1] for x in xs], n, x0.dtype)
    lib = _library()
    y = torch.empty((m, n), dtype=x0.dtype, device=x0.device)
    s = torch.zeros((2, n), dtype=torch.float64, device=x0.device)
    ks = (ctypes.c_int * len(xs))(*[x.shape[1] for x in xs])
    args = (_ptr_array(xs), _ptr_array(ws), _ptr_array(aas), _ptr_array(bbs),
            ks, len(xs), y.data_ptr(), s[0].data_ptr(), s[1].data_ptr(), m,
            n)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    if plan.route == "tc":
        _check_aligned([*xs, *ws, y], "fused_gemm")
        err = lib.fused_gemm_fwd_tc_launch(
            *args, _ACT_CODES[act], int(raw_stats), plan.config, *plan.grid,
            plan.smem_bytes, stream)
    else:
        err = lib.fused_gemm_fwd_launch(
            *args, _DTYPE_CODES[x0.dtype], _ACT_CODES[act], int(raw_stats),
            stream)
    if err != 0:
        raise RuntimeError(f"fused_gemm forward launch failed: cudaError "
                           f"{err} ({plan})")
    if not raw_stats:
        fused_gemm.launches += 1
        fused_gemm.tc_launches += plan.route == "tc"
    s1, s2 = s.float()
    return (y, s1, s2), plan


def _backward_cuda(xs, ws, aas, bbs, y, dy, ds1, ds2, act):
    lib = _library()
    m, n = y.shape
    stream = torch.cuda.current_stream(y.device).cuda_stream
    dxs, dws, das, dbs = [], [], [], []
    for x, w, a, b in zip(xs, ws, aas, bbs):
        k = x.shape[1]
        dx = torch.empty_like(x)
        dw = torch.zeros((k, n), dtype=torch.float32, device=x.device)
        dab = None
        if a is not None:
            dab = torch.zeros((2, k), dtype=torch.float64, device=x.device)
        err = lib.fused_gemm_bwd_launch(
            x.data_ptr(), w.data_ptr(),
            None if a is None else a.data_ptr(),
            None if a is None else b.data_ptr(),
            y.data_ptr(), dy.data_ptr(), ds1.data_ptr(), ds2.data_ptr(),
            dx.data_ptr(), dw.data_ptr(),
            None if dab is None else dab[0].data_ptr(),
            None if dab is None else dab[1].data_ptr(),
            m, k, n, _DTYPE_CODES[y.dtype], _ACT_CODES[act], stream)
        if err != 0:
            raise RuntimeError(f"fused_gemm backward launch failed: "
                               f"cudaError {err}")
        # one count per input: its dx kernel and its dW kernel
        fused_gemm.bwd_launches += 1
        dxs.append(dx)
        dws.append(dw)
        da, db = (None, None) if dab is None else dab.float()
        das.append(da)
        dbs.append(db)
    return dxs, dws, das, dbs


class _FusedGemm(torch.autograd.Function):
    """apply(act, plain, nx, *xs, *ws, *aas, *bbs) -> (y, s1, s2)."""

    @staticmethod
    def forward(ctx, act, plain, nx, *tensors):
        xs, ws = tensors[:nx], tensors[nx:2 * nx]
        aas, bbs = tensors[2 * nx:3 * nx], tensors[3 * nx:]
        m, n = _check(xs, ws, aas, bbs, act)
        device = xs[0].device.type
        if plain or device == "cpu":
            y, s1, s2 = fused_gemm_plain(xs, ws, aas, bbs, act)
        elif device == "cuda":
            (y, s1, s2), _ = _forward_cuda(xs, ws, aas, bbs, act, m, n)
        else:
            raise ValueError(f"no fused_gemm kernel for {xs[0].device}")
        ctx.act, ctx.plain, ctx.nx = act, plain, nx
        ctx.save_for_backward(*tensors, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        *tensors, y = ctx.saved_tensors
        nx = ctx.nx
        xs, ws = tensors[:nx], tensors[nx:2 * nx]
        aas, bbs = tensors[2 * nx:3 * nx], tensors[3 * nx:]
        dy = dy.contiguous()
        ds1 = ds1.float().contiguous()
        ds2 = ds2.float().contiguous()
        if ctx.plain or y.device.type == "cpu":
            dxs, dws, das, dbs = fused_gemm_bwd_plain(
                xs, ws, aas, bbs, y, dy, ds1, ds2, ctx.act)
        else:
            dxs, dws, das, dbs = _backward_cuda(
                xs, ws, aas, bbs, y, dy, ds1, ds2, ctx.act)
        # cotangents take the primals' dtypes: one last rounding of the
        # f32 dW to the compute dtype, as a conv's gradient pays at the
        # parameter cast
        dws = [dw.to(w.dtype) for dw, w in zip(dws, ws)]
        return (None, None, None, *dxs, *dws, *das, *dbs)


def fused_gemm(xs, ws, affines, act="mish", dtype=torch.bfloat16,
               plain=False):
    """See the module docstring. ``xs``: [M, K_i] tensors; ``ws``:
    [K_i, N]; ``affines``: per input ``None`` or ``(a, b)`` broadcastable
    to [K_i]. Inputs are cast to ``dtype``. CPU tensors take the plain
    version; CUDA tensors launch the kernels, or raise. ``plain=True``
    forces the plain version on any device (the reference route)."""
    aas, bbs = [], []
    for x, aff in zip(xs, affines):
        if aff is None:
            aas.append(None)
            bbs.append(None)
        else:
            k = x.shape[1]
            aas.append(aff[0].reshape(k).float().contiguous())
            bbs.append(aff[1].reshape(k).float().contiguous())
    return _FusedGemm.apply(
        act, plain, len(xs), *[x.to(dtype).contiguous() for x in xs],
        *[w.to(dtype).contiguous() for w in ws], *aas, *bbs)


fused_gemm.launches = 0
fused_gemm.tc_launches = 0
fused_gemm.bwd_launches = 0
