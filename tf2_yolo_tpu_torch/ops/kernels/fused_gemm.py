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
and ``_bwd_call``). Both directions have two routes, chosen by shape in
:func:`_tc_plan` and :func:`_tc_bwd_plan`: bf16 with every K_i % 8 == 0
and N % 8 == 0 (every GEMM of a ``packed=3`` step) runs on the tensor
cores (``mma.sync`` bf16 -> f32 fed by ``ldmatrix`` from a ring of
``cp.async`` slices 32 deep); f32 (whose tensor-core route would be
TF32) runs on the CUDA cores, tiled f32-FMA GEMMs bounded by their FMA
rate.

- Forward on the tensor cores: 128-row tiles of 128, 64 or 32 columns,
  the inputs' K ranges walked as one sequence of slices; an input with a
  prologue is activated once per element in shared memory per column
  block. Bound by bytes and by the prologue's f32 arithmetic.
- Backward on the tensor cores, three launches for all inputs, whose K
  ranges are one column space of sum K_i columns (a block may span
  inputs, so dy and y are read once for all of them): a tiny pass folds
  ds1 (rounded to the compute dtype) into an f32 vector ``c =
  T(ds1) @ w_i^T``, so that ds1 never enters a bf16 operand; the dx
  kernel (128 rows x 128, 64 or 32 columns) stages dy and y per 32-deep
  slice of N in a 2-stage ``cp.async`` ring and the x tile of its
  columns beside them, builds ``T(y * T(2 ds2))`` once per element in
  place, runs both products into one f32 accumulator against the same
  slice of w (read without ``.trans``), and its epilogue adds ``c``,
  recomputes the prologue's derivative, writes dx and adds da, db with
  f64 atomics; the dW kernel (tiles of 128 or 64 of the column space by
  128 or 64 of N, split over chunks of rows so that about two blocks per
  SM run) activates x and builds ``dyt = T(dy + ds1 + 2 y ds2)`` once
  per element per block, contracts over rows with both operands through
  ``ldmatrix .trans``, and adds its tile to the zeroed dW with f32
  atomics.
- Backward on the CUDA cores (f32): two launches per input, dx with the
  da/db reductions, and a split-M dW.

``fused_gemm.launches`` counts every forward launch,
``fused_gemm.tc_launches`` those on the tensor cores;
``fused_gemm.bwd_launches`` counts the input operands of every backward,
``fused_gemm.bwd_tc_launches`` those whose kernels ran on the tensor
cores. The tensor-core routes raise on a tensor that does not start on a
16-byte boundary. The backward reads the stored y instead of recomputing
it (the consumer keeps y alive anyway). The column sums over M (s1, s2,
da, db) are per-block f32 partials added with f64 atomics and rounded to
f32 here, so block order does not show in them; dW is added with f32
atomics (one per chunk of rows), so its last bits depend on block order.
On CPU tensors it computes :func:`fused_gemm_plain` and
:func:`fused_gemm_bwd_plain`, which repeat the TPU kernels' arithmetic
step by step with the same roundings. The TPU row-block sizing
(``mblk_fwd``/``mblk_bwd``) is not carried over: any M >= 1 is taken.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from ._build import load_library
from .conv_bn import (_SMS, _TC_BM, _TC_TILES, SMEM_MAX, Plan,
                      _check_aligned, _tc_smem)

# source and extra nvcc flags: no contraction, so the f32 prologue
# rounds as the plain version does
SOURCE = ("fused_gemm.cu", ("--fmad=false",))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"mish": 0, "leaky": 1, "linear": 2}
MAX_INPUTS = 9
_INT32_MAX = 2 ** 31 - 1
_CC_TILE = 64                          # the CUDA-core kernel's BM = BN
# the tensor-core backward, over the inputs' K ranges as one column
# space: the dx kernel's ring of 2 slices, 32 deep; the dW kernel's
# tiles of (column space, N) by config (8 warps as 2 x 4), its ring of 3
# slices of 32 rows, and the rows of a chunk (a multiple of 32)
_DX_STAGES, _DW_STAGES = 2, 3
_DW_TILES = {0: (128, 128), 1: (64, 64), 2: (128, 64), 3: (64, 128)}
_BK = 32


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


class BwdPlan(NamedTuple):
    """How one fused GEMM backward launches: ``route`` "tc" or
    "cuda_core"; on the tensor cores, over the inputs' K ranges as one
    column space, the dx kernel's tile config (0, 1, 2: BN = 128, 64, 32
    columns), grid (128-row blocks, column blocks) and shared memory, and
    the dW kernel's tile config (``_DW_TILES``), grid (chunks of rows,
    column tiles, N tiles), shared memory and rows a chunk. On the CUDA
    cores the C entry sizes its own grids (-1 and 0 here)."""
    route: str
    dx_config: int
    dx_grid: tuple
    dx_smem: int
    dw_config: int
    dw_grid: tuple
    dw_smem: int
    dw_rows: int


def _tc_bwd_smem(dx_config, dw_config):
    """Bytes of dynamic shared memory of the backward's dx and dW
    kernels (``DxSmem`` and ``DwTile`` in fused_gemm.cu): the dx kernel's
    ring holds per stage the dy and y tiles (128 rows of 32 + 8) and the
    w tile (BN rows of 32 + 8), or the epilogue, whichever is larger,
    then the x tile (128 rows of BN + 8) and three f32 per column; the
    dW ring per stage the x tile (32 rows of TK + 8), the dy tile (32
    rows of TN + 8) and the y tile (32 rows of TN)."""
    bn, warps_m = _TC_TILES[dx_config]
    ring = _DX_STAGES * (2 * _TC_BM + bn) * (_BK + 8) * 2
    epilogue = _TC_BM * (bn + 8) * 2 + 2 * warps_m * bn * 4
    dx = max(ring, epilogue) + _TC_BM * (bn + 8) * 2 + 3 * bn * 4
    tk, tn = _DW_TILES[dw_config]
    dw = _DW_STAGES * _BK * ((tk + 8) + (tn + 8) + tn) * 2
    return dx, dw


def _tc_bwd_plan(m, ks, n, dtype):
    """The backward's launch plan (pure Python: the CPU tests reach it).
    bf16 with every K_i % 8 == 0 and N % 8 == 0 takes the tensor cores,
    the inputs' K ranges taken as one column space of sum K_i columns (a
    block may span inputs, so dy and y are read once for all of them):
    the dx tile is the widest of 128, 64 or 32 columns that divides the
    column space (else the widest it fills), halved while the grid would
    not cover the 132 SMs once; the dW tile is 128 or 64 of the column
    space (128 where 128 divides it) by 128 or 64 of N (likewise); its
    tiles come first and chunks of rows (multiples of 32) cover what is
    left of about two blocks per SM.
    Anything else of a supported dtype (f32) takes the CUDA-core
    kernels. Raises ValueError on a shape the kernels do not take."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {dtype}")
    if not 1 <= len(ks) <= MAX_INPUTS or min(m, n, *ks) < 1:
        raise ValueError(f"unsupported gemm M={m}, K={list(ks)}, N={n}")
    if dtype != torch.bfloat16 or any(k % 8 for k in ks) or n % 8:
        if -(-m // 1024) > 65535 or -(-n // _CC_TILE) > 65535:
            raise ValueError(f"unsupported gemm M={m}, K={list(ks)}, N={n}")
        return BwdPlan("cuda_core", -1, (), 0, -1, (), 0, 0)
    ktot = sum(ks)
    fits = [c for c, (bn, _) in _TC_TILES.items() if bn <= ktot] or [2]
    dx_config = next((c for c in fits if ktot % _TC_TILES[c][0] == 0),
                     fits[0])
    cols = lambda c: -(-ktot // _TC_TILES[c][0])
    while dx_config < 2 and -(-m // _TC_BM) * cols(dx_config) < _SMS:
        dx_config += 1
    tiles = tuple(128 if size % 128 == 0 else 64 for size in (ktot, n))
    dw_config = next(c for c, t in _DW_TILES.items() if t == tiles)
    tk, tn = tiles
    k_tiles, n_tiles = -(-ktot // tk), -(-n // tn)
    chunks = max(1, -(-2 * _SMS // (k_tiles * n_tiles)))
    per_chunk = -(-m // chunks)
    rows = -(-per_chunk // _BK) * _BK
    dx_smem, dw_smem = _tc_bwd_smem(dx_config, dw_config)
    plan = BwdPlan("tc", dx_config, (-(-m // _TC_BM), cols(dx_config)),
                   dx_smem, dw_config, (-(-m // rows), k_tiles, n_tiles),
                   dw_smem, rows)
    if plan.dx_grid[0] > _INT32_MAX \
            or max(plan.dx_grid[1], *plan.dw_grid[1:]) > 65535 \
            or max(dx_smem, dw_smem) > SMEM_MAX:
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
    lib.fused_gemm_bwd_tc_launch.argtypes = [
        ptrs, ptrs, ptrs, ptrs, ints, ctypes.c_int] \
        + [ctypes.c_void_p] * 5 + [ptrs] * 2 + [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    lib.fused_gemm_bwd_tc_launch.restype = ctypes.c_int
    return lib


def _ptr_array(tensors):
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _forward_cuda(xs, ws, aas, bbs, act, m, n, raw_stats=False):
    """Launch the forward kernel of the plan's route. ``raw_stats`` sums
    the f32 product before it is rounded (the probe kernel of
    ``tools/bench_packed_probe.py``, which counts its own launches).
    Returns (y, s1, s2) and the plan."""
    x0 = xs[0]
    plan = _tc_plan(m, [x.shape[1] for x in xs], n, x0.dtype)
    y = torch.empty((m, n), dtype=x0.dtype, device=x0.device)
    s = torch.zeros((2, n), dtype=torch.float64, device=x0.device)
    if plan.route == "tc":
        _check_aligned([*xs, *ws, y], "fused_gemm")
    lib = _library()
    ks = (ctypes.c_int * len(xs))(*[x.shape[1] for x in xs])
    args = (_ptr_array(xs), _ptr_array(ws), _ptr_array(aas), _ptr_array(bbs),
            ks, len(xs), y.data_ptr(), s[0].data_ptr(), s[1].data_ptr(), m,
            n)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    if plan.route == "tc":
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
    m, n = y.shape
    ks = [x.shape[1] for x in xs]
    plan = _tc_bwd_plan(m, ks, n, y.dtype)
    dxs = [torch.empty_like(x) for x in xs]
    dws = [torch.zeros((k, n), dtype=torch.float32, device=y.device)
           for k in ks]
    # da, db of every input with a prologue, at its offset in the column
    # space of the concatenated K ranges
    dab = torch.zeros((2, sum(ks)), dtype=torch.float64, device=y.device)
    offs = [sum(ks[:i]) for i in range(len(ks))]
    if plan.route == "tc":
        _check_aligned([*xs, *ws, y, dy, *dxs], "fused_gemm backward")
    lib = _library()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    if plan.route == "tc":
        ctab = torch.empty(sum(ks), dtype=torch.float32, device=y.device)
        err = lib.fused_gemm_bwd_tc_launch(
            _ptr_array(xs), _ptr_array(ws), _ptr_array(aas),
            _ptr_array(bbs), (ctypes.c_int * len(xs))(*ks), len(xs),
            y.data_ptr(), dy.data_ptr(), ds1.data_ptr(), ds2.data_ptr(),
            ctab.data_ptr(), _ptr_array(dxs), _ptr_array(dws),
            dab[0].data_ptr(), dab[1].data_ptr(), m, n, _ACT_CODES[act],
            plan.dx_config, *plan.dx_grid, plan.dx_smem, plan.dw_config,
            *plan.dw_grid, plan.dw_smem, plan.dw_rows, stream)
        if err != 0:
            raise RuntimeError(f"fused_gemm backward launch failed: "
                               f"cudaError {err} ({plan})")
    else:
        for x, w, a, b, dx, dw, off in zip(xs, ws, aas, bbs, dxs, dws,
                                           offs):
            k = x.shape[1]
            err = lib.fused_gemm_bwd_launch(
                x.data_ptr(), w.data_ptr(),
                None if a is None else a.data_ptr(),
                None if a is None else b.data_ptr(),
                y.data_ptr(), dy.data_ptr(), ds1.data_ptr(), ds2.data_ptr(),
                dx.data_ptr(), dw.data_ptr(), dab[0, off:off + k].data_ptr(),
                dab[1, off:off + k].data_ptr(), m, k, n,
                _DTYPE_CODES[y.dtype], _ACT_CODES[act], stream)
            if err != 0:
                raise RuntimeError(f"fused_gemm backward launch failed: "
                                   f"cudaError {err}")
    # one count per input operand: its share of the launches
    fused_gemm.bwd_launches += len(xs)
    fused_gemm.bwd_tc_launches += len(xs) * (plan.route == "tc")
    dabf = dab.float()
    das = [None if a is None else dabf[0, off:off + x.shape[1]]
           for x, a, off in zip(xs, aas, offs)]
    dbs = [None if a is None else dabf[1, off:off + x.shape[1]]
           for x, a, off in zip(xs, aas, offs)]
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
fused_gemm.bwd_tc_launches = 0
