"""Launch plans of the tensor-core fused GEMM forward and backward and
fused 3x3 conv backward, and the edges their tiles meet, on the CPU.

``fused_gemm._tc_plan``, ``fused_gemm._tc_bwd_plan`` and
``fused_conv3x3._tc_bwd_plan`` pick, per shape, the route (bf16 on the
tensor cores, f32 and K = 3 on the CUDA cores), the tile configs, the
grids and the dynamic shared memory that the C launchers take as they
are. They are held here over every fused GEMM and every fused 3x3 conv
of one ``packed=3`` and one ``packed=True`` training step of YOLOv4@416
(enumerated from the port's own model) at batches 1 to 128. Every
tensor-core route checks the 16-byte alignment of its tensors before it
loads its library, which the CPU reaches. The plain
versions, which the card holds the kernels to, are held to the JAX
package's Pallas kernels in interpret mode at the shapes where the new
tiles have ragged edges: M that ends inside a 128-row tile, N of 24, 32
and 72 against tiles of 32 and 64 columns, K of 40 and 48 against slices
of 32, a multi-input GEMM with a prologue on one input only, stride-2
parity classes from 26^2 to 13^2, and images whose edges cut the dx
kernel's tap table. The CUDA kernels themselves run only on the card,
through ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf2_yolo_tpu.ops.pallas import packed_gemm
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.test_torch_fused_conv3x3 import (_case, _compare,  # noqa: F401
                                            interpret)
from tests.test_torch_fused_gemm import TOL, _close
from tests.test_torch_fused_gemm import _case as _gemm_case
from tf2_yolo_tpu_torch.models import YoloV4
from tf2_yolo_tpu_torch.models import packed_region as region
from tf2_yolo_tpu_torch.ops.kernels import conv_bn, fused_conv3x3, fused_gemm
from tf2_yolo_tpu_torch.ops.kernels.conv_bn import _check_aligned

torch.set_num_threads(1)

BATCHES = (1, 8, 32, 128)
GRID_YZ_MAX = 65535
GRID_X_MAX = 2 ** 31 - 1
SMS = 132
# the GEMM forward's block: 128 rows; its column widths by config
TC_BM = 128
GEMM_BN = {0: 128, 1: 64, 2: 32}
# the dx kernel's tile: 8 x 16 pixels of a parity class, BN of K by
# config; the dW kernel's blocks of 32 input x 64 output channels
DX_BN = {0: 128, 1: 64, 2: 32}
# the fused GEMM backward over the inputs' K ranges as one column space:
# dx tiles of 128 rows x BN columns (DX_BN), dW tiles of columns x N by
# config, chunks of rows in multiples of 32
GEMM_DW_TILE = {0: (128, 128), 1: (64, 64), 2: (128, 64), 3: (64, 128)}
ANCHORS = np.stack([np.linspace(0.05, 0.75, 9),
                    np.linspace(0.07, 0.65, 9)], axis=1)


@pytest.fixture
def gemm_interpret():
    packed_gemm.set_interpret(True)
    yield
    packed_gemm.set_interpret(False)


@pytest.fixture(scope="module")
def packed_calls():
    """{packed: ([(M at 416^2 per image, [K_i], N)] of every fused_gemm
    call, [(H, W, K, N, stride)] of every fused_conv3x3 call)} of one
    train-mode forward of the port's YoloV4 at 32^2 on the CPU, sizes
    times 13."""
    out = {}
    for packed in (1, 3):
        gemms, convs = [], []
        real_gemm, real_conv = region.fused_gemm, region.fused_conv3x3

        def gemm(xs, ws, *a, **kw):
            gemms.append((xs[0].shape[0] * 169, [x.shape[1] for x in xs],
                          ws[0].shape[1]))
            return real_gemm(xs, ws, *a, **kw)

        def conv(x4, w, affine, stride=1, **kw):
            convs.append((x4.shape[1] * 13, x4.shape[2] * 13, x4.shape[3],
                          w.shape[-1], stride))
            return real_conv(x4, w, affine, stride=stride, **kw)

        region.fused_gemm, region.fused_conv3x3 = gemm, conv
        try:
            model = YoloV4(ANCHORS, 3, device="cpu", packed=packed).train()
            with torch.no_grad():
                model(torch.rand(1, 32, 32, 3))
        finally:
            region.fused_gemm, region.fused_conv3x3 = real_gemm, real_conv
        out[packed] = (gemms, convs)
    return out


def test_a_packed_step_has_43_and_32_gemms_and_five_convs(packed_calls):
    gemms3, convs3 = packed_calls[3]
    gemms1, convs1 = packed_calls[1]
    assert len(gemms3) == 43 and len(gemms1) == 32
    assert convs3 == [(416, 416, 32, 64, 2), (208, 208, 32, 64, 1),
                      (208, 208, 64, 128, 2), (104, 104, 64, 64, 1),
                      (104, 104, 64, 64, 1)]
    assert convs1 == []
    # every K_i and N has 16-byte rows for the tensor cores, and M at
    # 13^2 ends inside a 128-row tile
    assert all(k % 8 == 0 for _, ks, _ in gemms3 for k in ks)
    assert all(n % 8 == 0 for _, _, n in gemms3)
    assert 169 in {m for m, _, _ in gemms3}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("packed", [3, 1])
def test_gemm_plan_covers_every_packed_gemm(packed_calls, packed, batch,
                                            dtype):
    for rows, ks, n in packed_calls[packed][0]:
        m = batch * rows
        plan = fused_gemm._tc_plan(m, ks, n, dtype)
        assert plan.smem_bytes <= conv_bn.SMEM_MAX, (m, ks, n, plan)
        assert plan.grid[0] <= GRID_X_MAX and plan.grid[1] <= GRID_YZ_MAX
        if dtype == torch.bfloat16:
            bn = GEMM_BN[plan.config]
            assert plan.route == "tc"
            assert plan.smem_bytes > 48 * 1024            # dynamic memory
            assert plan.grid == (-(-m // TC_BM), -(-n // bn))
            # the widest tile that N fills, or a narrower one where the
            # grid would not cover the 132 SMs once
            assert bn <= max(n, 32)
            assert plan.config == 2 or bn == 128 or bn * 2 > n \
                or -(-m // TC_BM) * -(-n // (2 * bn)) < SMS
        else:
            assert plan.route == "cuda_core" and plan.config == -1
            assert plan.grid == (-(-m // 64), -(-n // 64))
            assert plan.smem_bytes == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", BATCHES)
def test_conv3x3_bwd_plan_covers_the_five_layers(packed_calls, batch,
                                                 dtype):
    for h, w, k, n, stride in packed_calls[3][1]:
        plan = fused_conv3x3._tc_bwd_plan(batch, h, w, k, n, stride, dtype)
        assert max(plan.dx_smem, plan.dw_smem) <= conv_bn.SMEM_MAX
        assert max(plan.dx_grid[0], plan.dw_grid[0]) <= GRID_X_MAX
        assert max(plan.dx_grid[1:] + plan.dw_grid[1:]) <= GRID_YZ_MAX
        ho, wo = h // stride, w // stride
        tiles = -(-ho // 8) * -(-wo // 16)
        if dtype == torch.bfloat16:
            assert plan.route == "tc"
            # dx: one block per 8 x 16 positions of the output grid (at
            # stride 2 the pixels of all four parity classes there, in
            # 32-column blocks), at stride 1 all of K <= 128
            bn = DX_BN[plan.dx_config]
            if stride == 2:
                assert bn == 32
            else:
                assert k <= bn and (bn == 32 or bn // 2 < k)
            assert plan.dx_grid == (tiles, -(-k // bn), batch)
            # dW: chunks of whole tiles that cover them all, about two
            # blocks per SM in all (or one tile a block)
            blocks = -(-k // 32) * -(-n // 64)
            chunks = plan.dw_grid[0]
            per_chunk = -(-batch * tiles // chunks)
            assert plan.dw_grid[1:] == (blocks, 1)
            assert per_chunk * (chunks - 1) < batch * tiles \
                <= per_chunk * chunks
            assert chunks * blocks <= 2 * SMS + blocks or per_chunk == 1
            assert min(plan.dx_smem, plan.dw_smem) > 16 * 1024
        else:
            assert plan.route == "cuda_core" and plan.dx_config == -1
            assert plan.dx_smem == plan.dw_smem == 0
            assert plan.dx_grid == (-(-batch * ho * wo // 64), -(-k // 64),
                                    stride * stride)
            assert plan.dw_grid == (-(-9 * k // 64), -(-n // 64),
                                    -(-batch * ho * wo // 1024))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("packed", [3, 1])
def test_gemm_bwd_plan_covers_every_packed_gemm(packed_calls, packed, batch,
                                                dtype):
    for rows, ks, n in packed_calls[packed][0]:
        m = batch * rows
        plan = fused_gemm._tc_bwd_plan(m, ks, n, dtype)
        if dtype == torch.float32:
            assert plan.route == "cuda_core" and plan.dx_config == -1
            continue
        assert plan.route == "tc"
        assert max(plan.dx_smem, plan.dw_smem) <= conv_bn.SMEM_MAX
        assert min(plan.dx_smem, plan.dw_smem) > 32 * 1024
        # dx: 128-row blocks against the inputs' K ranges as one column
        # space, the widest tile that divides it (every column space of
        # a step is a multiple of 32), narrowed only while the grid would
        # not cover the 132 SMs once
        ktot = sum(ks)
        bn = DX_BN[plan.dx_config]
        assert plan.dx_grid == (-(-m // TC_BM), -(-ktot // bn))
        assert ktot % bn == 0
        assert bn == 128 or ktot % (2 * bn) \
            or -(-m // TC_BM) * (ktot // (2 * bn)) < SMS
        # dW: tiles of 128 columns (or rows of N) where 128 divides them,
        # else 64; the chunks of rows (multiples of 32) cover M once,
        # about two blocks per SM in all
        tk, tn = GEMM_DW_TILE[plan.dw_config]
        assert (tk == 128) == (ktot % 128 == 0)
        assert (tn == 128) == (n % 128 == 0)
        tiles = -(-ktot // tk) * -(-n // tn)
        chunks = plan.dw_grid[0]
        assert plan.dw_grid[1:] == (-(-ktot // tk), -(-n // tn))
        assert plan.dw_rows * (chunks - 1) < m <= plan.dw_rows * chunks
        want = max(1, -(-2 * SMS // tiles))
        per_chunk = -(-m // want)
        assert plan.dw_rows == -(-per_chunk // 32) * 32 and chunks <= want


@pytest.mark.parametrize("args,err", [
    ((100, [64], 64, torch.float16), TypeError),
    ((0, [64], 64, torch.bfloat16), ValueError),               # empty
    ((100, [64] * 10, 64, torch.bfloat16), ValueError),        # 10 inputs
    ((100, [64, 0], 64, torch.bfloat16), ValueError),
    ((100, [64] * 8 + [128 * 65536], 64, torch.bfloat16),
     ValueError),                                              # dx grid.y
    ((100, [128], 128 * 65536, torch.bfloat16), ValueError),   # dW grid.z
    ((1024 * 65536 + 1, [64], 64, torch.float32), ValueError),  # chunks
])
def test_gemm_bwd_plan_rejects(args, err):
    with pytest.raises(err):
        fused_gemm._tc_bwd_plan(*args)


def test_conv3x3_bwd_plan_routes_the_stem_shape_to_the_cuda_cores():
    plan = fused_conv3x3._tc_bwd_plan(32, 416, 416, 3, 32, 1,
                                      torch.bfloat16)
    assert plan.route == "cuda_core"


@pytest.mark.parametrize("args,err", [
    ((100, [64], 64, torch.float16), TypeError),
    ((0, [64], 64, torch.bfloat16), ValueError),               # empty
    ((100, [64] * 10, 64, torch.bfloat16), ValueError),        # 10 inputs
    ((100, [64, 0], 64, torch.bfloat16), ValueError),
    ((100, [64], 128 * 65536, torch.bfloat16), ValueError),    # grid.y
    ((100, [64], 64 * 65536, torch.float32), ValueError),      # grid.y
])
def test_gemm_plan_rejects(args, err):
    with pytest.raises(err):
        fused_gemm._tc_plan(*args)


@pytest.mark.parametrize("dims,dtype,err", [
    ((2, 8, 8, 32, 32, 3), torch.bfloat16, ValueError),        # stride 3
    ((2, 7, 8, 32, 32, 2), torch.bfloat16, ValueError),        # odd s2
    ((2, 8, 8, 32, 32, 1), torch.float16, TypeError),
    ((2, 8, 8, 0, 32, 1), torch.bfloat16, ValueError),         # empty
    ((65536, 8, 8, 32, 32, 1), torch.bfloat16, ValueError),    # dx grid.z
    ((1, 8, 8, 128 * 65536 // 4, 8, 2), torch.bfloat16, ValueError),
])
def test_conv3x3_bwd_plan_rejects(dims, dtype, err):
    with pytest.raises(err):
        fused_conv3x3._tc_bwd_plan(*dims, dtype)


def test_tensor_core_route_needs_aligned_tensors():
    base = torch.zeros(64, dtype=torch.bfloat16)
    _check_aligned([base, base[8:]], "test")           # 16 bytes in
    with pytest.raises(ValueError, match="aligned"):
        _check_aligned([base, base[4:]], "test")
    # one check, shared by every wrapper
    assert fused_gemm._check_aligned is fused_conv3x3._check_aligned \
        is _check_aligned


def _misaligned(*shape):
    """A contiguous bf16 tensor that starts 2 bytes past a 16-byte
    boundary."""
    base = torch.ones(int(np.prod(shape)) + 1, dtype=torch.bfloat16)
    t = base[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16
    return t


def _counters():
    return (conv_bn.conv_bn_stats.launches, conv_bn.conv_bn_stats.tc_launches,
            fused_gemm.fused_gemm.launches, fused_gemm.fused_gemm.tc_launches,
            fused_gemm.fused_gemm.bwd_launches,
            fused_gemm.fused_gemm.bwd_tc_launches,
            fused_conv3x3.fused_conv3x3.launches,
            fused_conv3x3.fused_conv3x3.bwd_launches)


def _ones(*shape, dtype=torch.bfloat16):
    return torch.ones(shape, dtype=dtype)


@pytest.mark.parametrize("route", [
    "conv ring", "conv small-Ci", "gemm forward", "gemm backward",
    "conv3x3 forward", "conv3x3 backward"])
def test_tensor_core_routes_raise_on_misaligned_tensors(route):
    # each route's CUDA entry checks its tensors before it loads its
    # library or launches: a CPU tensor reaches the check here
    f32 = lambda n: torch.zeros(n)
    if route == "conv ring":
        x, w, b = _misaligned(2, 13, 13, 32), _ones(3, 3, 32, 32), _ones(32)
        run = lambda: conv_bn._forward_cuda(
            x, w, b, 1, True, conv_bn._check(x, w, b, 1))
    elif route == "conv small-Ci":
        x, w, b = _ones(2, 9, 7, 3), _misaligned(3, 3, 3, 32), _ones(32)
        run = lambda: conv_bn._forward_cuda(
            x, w, b, 1, True, conv_bn._check(x, w, b, 1))
    elif route == "gemm forward":
        run = lambda: fused_gemm._forward_cuda(
            [_misaligned(200, 64)], [_ones(64, 64)], [None], [None], "mish",
            200, 64)
    elif route == "gemm backward":
        run = lambda: fused_gemm._backward_cuda(
            [_ones(200, 64)], [_ones(64, 64)], [f32(64)], [f32(64)],
            _ones(200, 64), _misaligned(200, 64), f32(64), f32(64), "mish")
    elif route == "conv3x3 forward":
        x, w = _misaligned(1, 9, 11, 16), _ones(3, 3, 16, 8)
        run = lambda: fused_conv3x3._forward_cuda(
            x, w, None, None, 1, "mish",
            fused_conv3x3._check(x, w, None, None, 1, "mish"))
    else:
        run = lambda: fused_conv3x3._backward_cuda(
            _ones(1, 9, 11, 16), _ones(3, 3, 16, 8), None, None,
            _ones(1, 9, 11, 8), _misaligned(1, 9, 11, 8), f32(8), f32(8), 1,
            "mish")
    before = _counters()
    with pytest.raises(ValueError, match="aligned"):
        run()
    assert _counters() == before


def _gemm_matches_pallas(m, ks, n, pattern, act, dtype):
    xs, ws, affines, cts = _gemm_case(m + n, m, ks, n, pattern)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]

    def jf(jxs, jws, jaffs):
        return packed_gemm.fused_gemm(jxs, jws, jaffs, act=act, dtype=jdt)

    jaffs = [None if a is None else (jnp.asarray(a[0]), jnp.asarray(a[1]))
             for a in affines]
    want, vjp = jax.vjp(jf, [jnp.asarray(x, jdt) for x in xs],
                        [jnp.asarray(w, jdt) for w in ws], jaffs)
    want_dxs, want_dws, want_daffs = vjp(
        (jnp.asarray(cts[0], jdt), jnp.asarray(cts[1]), jnp.asarray(cts[2])))

    txs = [torch.from_numpy(x).to(tdt).requires_grad_() for x in xs]
    tws = [torch.from_numpy(w).to(tdt).requires_grad_() for w in ws]
    taffs = [None if a is None else
             (torch.from_numpy(a[0]).requires_grad_(),
              torch.from_numpy(a[1]).requires_grad_()) for a in affines]
    y, s1, s2 = fused_gemm.fused_gemm(txs, tws, taffs, act=act, dtype=tdt)
    tol = TOL[dtype]
    for got, wv, name in zip((y, s1, s2), want, ("y", "s1", "s2")):
        _close(got.detach(), wv, tol, name)
    leaves = txs + tws + [t for a in taffs if a is not None for t in a]
    grads = torch.autograd.grad(
        (y, s1, s2), leaves, (torch.from_numpy(cts[0]).to(tdt),
                              torch.from_numpy(cts[1][0]),
                              torch.from_numpy(cts[2][0])))
    nx = len(xs)
    for i in range(nx):
        _close(grads[i], want_dxs[i], tol, f"dx{i}")
        _close(grads[nx + i], want_dws[i], tol, f"dw{i}")
    rest = iter(grads[2 * nx:])
    for i, aff in enumerate(want_daffs):
        if affines[i] is not None:
            _close(next(rest), aff[0], tol, f"da{i}")
            _close(next(rest), aff[1], tol, f"db{i}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,ks,n,pattern,act", [
    (136, [64], 32, [True], "mish"),            # rows end 8 into a tile
    (136, [96, 40], 72, [True, False], "leaky"),  # K 40; N 72 ends 8 in
    (200, [32, 32, 32], 24, [False, True, False], "linear"),   # N 24
    (136, [128], 128, [False], "mish"),         # activated input
])
def test_gemm_edges_match_pallas(gemm_interpret, m, ks, n, pattern, act,
                                 dtype):
    # so few rows narrow the tile to 32 columns (the grid would not cover
    # the SMs): N = 24 and 72 end inside one
    plan = fused_gemm._tc_plan(m, ks, n, torch.bfloat16)
    assert plan.route == "tc" and plan.config == 2
    # and the backward's tiles: dx columns of 32 over the inputs' K
    # ranges as one column space (96 + 40: a tile spans both inputs),
    # dW tiles of 64 or 128 columns by 64 or 128 of N (N = 24, 72 end
    # inside one), chunks of rows that end inside a 32-row slice
    bplan = fused_gemm._tc_bwd_plan(m, ks, n, torch.bfloat16)
    assert bplan.route == "tc" and bplan.dx_config == 2
    assert m % 32 and bplan.dw_grid[0] * bplan.dw_rows >= m
    _gemm_matches_pallas(m, ks, n, pattern, act, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bq,h,w,k,n,stride", [
    (1, 26, 26, 32, 64, 2),      # parity classes 26^2 -> 13^2, one dW block
    (2, 10, 10, 48, 72, 2),      # 5 x 5 classes: every pixel on an edge;
                                 # K 48 and N 72 end inside dW blocks
    (1, 9, 11, 16, 8, 1),        # odd sizes: the tap table at all 4 edges
    (2, 6, 34, 32, 16, 1),       # three 16-wide tiles, the last 2 wide
])
def test_fused_conv3x3_bwd_edges_match_pallas(interpret, bq, h, w, k, n,
                                              stride, dtype):
    plan = fused_conv3x3._tc_bwd_plan(bq, h, w, k, n, stride,
                                      torch.bfloat16)
    assert plan.route == "tc"
    _compare(_case(17, bq, h, w, k, n, stride), stride, "mish", True, dtype)
