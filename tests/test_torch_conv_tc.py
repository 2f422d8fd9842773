"""Launch plans of the tensor-core conv kernels, and the edges their tiles
meet, on the CPU.

``conv_bn._tc_plan`` and ``fused_conv3x3._tc_plan`` pick, per shape, the
route (bf16 on the tensor cores, the stem's Ci = 3 through the conv's
small-Ci kernel; f32 on the CUDA cores), the tile config, the grid and
the dynamic shared memory that the C launchers take as they are. They
are held here over every conv of YOLOv4@416 (110 convs, enumerated from
the port's own model, and the five fused 3x3 convs of ``packed=3``) at
batches 1 to 128. The plain versions, which the
card holds the kernels to, are held to the JAX package's Pallas kernels
in interpret mode at the shapes where the new tiles have ragged edges:
odd spatial sizes, 24 output channels, 3 and 8 input channels (the
small-Ci kernel's K = 27 and 72, padded to 32 and 96), stride 2 from
26^2 to 13^2, and a batch whose last 128-row tile spans two images. The
CUDA kernels themselves run only on the card, through ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tf2_yolo_tpu.ops.pallas.conv_bn_kernel import (conv1x1_stats,
                                                    conv3x3_stats)
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.test_torch_fused_conv3x3 import (_case, _compare,  # noqa: F401
                                            interpret)
from tf2_yolo_tpu_torch.models import YoloV4
from tf2_yolo_tpu_torch.models.layers import Conv
from tf2_yolo_tpu_torch.ops.kernels import conv_bn, fused_conv3x3
from tf2_yolo_tpu_torch.ops.kernels.conv_bn import conv_bn_stats

torch.set_num_threads(1)

BATCHES = (1, 8, 32, 128)
GRID_YZ_MAX = 65535
GRID_X_MAX = 2 ** 31 - 1
# the block tile of the tensor-core conv: 128 output pixels; its column
# widths by config (the small-Ci kernel's configs are 3 + these, its
# pixel tile 8 x 16); the fused conv's output tile of 8 x 16 pixels
TC_BM = 128
K1_BN = {0: 128, 1: 64, 2: 32}
IC_CONFIG = 3
K3_BN = {0: 128, 1: 64}
# the five fused 3x3 convs of packed=3 (stages 1-2 of the backbone)
K3_LAYERS = ("backbone.stage1.down", "backbone.stage1.block1.expand",
             "backbone.stage2.down", "backbone.stage2.block1.expand",
             "backbone.stage2.block2.expand")


@pytest.fixture(scope="module")
def yolo_convs():
    """{module name: (H, W, Ci, Co, k, stride)} of every conv of
    YOLOv4@416: one forward of the port's model at 32^2 on the CPU with a
    hook on every ``Conv``, spatial sizes times 13."""
    anchors = np.stack([np.linspace(0.05, 0.75, 9),
                        np.linspace(0.07, 0.65, 9)], axis=1)
    model = YoloV4(anchors, 3, device="cpu").eval()
    shapes = {}
    handles = [
        mod.register_forward_hook(
            lambda m, inp, out, name=name: shapes.__setitem__(
                name[:-len(".conv")] if name.endswith(".conv") else name,
                (inp[0].shape[1] * 13, inp[0].shape[2] * 13,
                 *m.kernel.shape[2:], m.kernel.shape[0], m.stride)))
        for name, mod in model.named_modules() if isinstance(mod, Conv)]
    with torch.no_grad():
        model(torch.rand(1, 32, 32, 3))
    for h in handles:
        h.remove()
    return shapes


def test_yolo_has_110_convs_and_five_fused(yolo_convs):
    assert len(yolo_convs) == 110
    assert yolo_convs["backbone.stem"] == (416, 416, 3, 32, 3, 1)
    assert [yolo_convs[n] for n in K3_LAYERS] == [
        (416, 416, 32, 64, 3, 2), (208, 208, 32, 64, 3, 1),
        (208, 208, 64, 128, 3, 2), (104, 104, 64, 64, 3, 1),
        (104, 104, 64, 64, 3, 1)]
    # every conv but the stem has 16-byte rows for the tensor cores
    odd = sorted(n for n, (_, _, ci, co, _, _) in yolo_convs.items()
                 if ci % 32 or co % 8)
    assert odd == ["backbone.stem"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", BATCHES)
def test_conv_plan_covers_every_yolo_conv(yolo_convs, batch, dtype):
    routes = {}
    for name, (h, w, ci, co, k, stride) in yolo_convs.items():
        plan = conv_bn._tc_plan(batch, h, w, ci, co, k, stride, dtype)
        routes[name] = plan.route
        assert plan.smem_bytes <= conv_bn.SMEM_MAX, (name, plan)
        assert plan.grid[0] <= GRID_X_MAX and plan.grid[1] <= GRID_YZ_MAX
        m = batch * (h // stride) * (w // stride)
        if plan.route == "tc" and ci < 32:
            # the stem: the small-Ci kernel, 8 x 16 pixel tiles of every
            # image, one 32-wide column block, K = 27 padded to 32
            assert name == "backbone.stem" and plan.config == IC_CONFIG + 2
            assert plan.grid == (batch * -(-h // 8) * -(-w // 16), 1)
            assert plan.smem_bytes == conv_bn._ic_smem(2, ci) < 48 * 1024
        elif plan.route == "tc":
            bn = K1_BN[plan.config]
            assert plan.smem_bytes > 48 * 1024, name     # dynamic memory
            assert plan.grid == (-(-m // TC_BM), -(-co // bn)), name
            # the widest tile that the channels fill, or a narrower one
            # where the grid would not cover the 132 SMs once
            assert bn <= max(co, 32), name
        else:
            assert plan.config == -1 and plan.smem_bytes == 0
            assert plan.grid == (-(-m // 64), -(-co // 64)), name
    # every bf16 conv on the tensor cores, the stem included
    want_tc = set(yolo_convs) if dtype == torch.bfloat16 else set()
    assert {n for n, r in routes.items() if r == "tc"} == want_tc


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", BATCHES)
def test_fused_conv3x3_plan_covers_the_five_layers(yolo_convs, batch, dtype):
    for name in K3_LAYERS:
        h, w, k, n, _, stride = yolo_convs[name]
        plan = fused_conv3x3._tc_plan(batch, h, w, k, n, stride, dtype)
        assert plan.smem_bytes <= conv_bn.SMEM_MAX, (name, plan)
        assert plan.grid[0] <= GRID_X_MAX
        assert max(plan.grid[1:]) <= GRID_YZ_MAX
        ho, wo = h // stride, w // stride
        if dtype == torch.bfloat16:
            assert plan.route == "tc", name
            # one block covers all of N <= 128: the prologue runs once
            assert plan.grid == (-(-ho // 8) * -(-wo // 16), 1, batch)
            assert K3_BN[plan.config] >= n
        else:
            assert plan.route == "cuda_core" and plan.smem_bytes == 0
            assert plan.grid == (-(-batch * ho * wo // 64), -(-n // 64), 1)


@pytest.mark.parametrize("dims,dtype,err", [
    ((2, 8, 8, 32, 32, 5, 1), torch.bfloat16, ValueError),    # 5x5
    ((2, 8, 8, 32, 32, 1, 2), torch.bfloat16, ValueError),    # 1x1 s2
    ((2, 7, 8, 32, 32, 3, 2), torch.bfloat16, ValueError),    # odd s2
    ((2, 8, 8, 32, 32, 3, 1), torch.float16, TypeError),
    ((2, 8, 8, 0, 32, 3, 1), torch.bfloat16, ValueError),     # empty
    ((1, 8, 8, 4, 64 * 65536, 1, 1), torch.float32, ValueError),  # grid.y
])
def test_conv_plan_rejects(dims, dtype, err):
    with pytest.raises(err):
        conv_bn._tc_plan(*dims, dtype)


@pytest.mark.parametrize("ci", [1, 3, 8, 31])
@pytest.mark.parametrize("co", [8, 32, 64, 128, 256])
def test_small_ci_plan(ci, co):
    # bf16 3x3 stride 1 with Ci < 32 and Co % 8 == 0 takes the small-Ci
    # kernel: the widest column tile that Co fills (narrowed while the
    # grid would not cover the SMs), 8 x 16 pixel tiles of every image,
    # and the shared memory of its A, B, halo and tap table
    n, h, w = 32, 416, 416
    plan = conv_bn._tc_plan(n, h, w, ci, co, 3, 1, torch.bfloat16)
    tile = plan.config - IC_CONFIG
    assert plan.route == "tc" and tile in K1_BN
    bn = K1_BN[tile]
    assert bn <= max(co, 32) and (bn == 128 or bn >= co or tile == 2)
    assert plan.grid == (n * 52 * 26, -(-co // bn))
    kp = -(-9 * ci // 32) * 32
    main = (128 * (kp + 8) + kp * (bn + 8)) * 2 \
        + -(-10 * 18 * ci * 2 // 16) * 16 + 4 * kp
    warps_m = {0: 2, 1: 4, 2: 4}[tile]
    epilogue = 128 * (bn + 8) * 2 + 2 * warps_m * bn * 4
    assert plan.smem_bytes == max(main, epilogue)
    assert plan.smem_bytes <= conv_bn.SMEM_MAX
    # the other geometries and f32 keep their kernels
    assert conv_bn._tc_plan(n, h, w, ci, co, 3, 2, torch.bfloat16).route \
        == "cuda_core"
    assert conv_bn._tc_plan(n, h, w, ci, co, 1, 1, torch.bfloat16).route \
        == "cuda_core"
    assert conv_bn._tc_plan(n, h, w, ci, co, 3, 1, torch.float32).route \
        == "cuda_core"


@pytest.mark.parametrize("dims,dtype,err", [
    ((2, 8, 8, 32, 32, 3), torch.bfloat16, ValueError),        # stride 3
    ((2, 7, 8, 32, 32, 2), torch.bfloat16, ValueError),        # odd s2
    ((2, 8, 8, 32, 32, 1), torch.float16, TypeError),
    ((65536, 8, 8, 32, 32, 1), torch.bfloat16, ValueError),    # grid.z
    ((1, 8, 8, 16, 128 * 65536, 1), torch.bfloat16, ValueError),  # grid.y
])
def test_fused_conv3x3_plan_rejects(dims, dtype, err):
    with pytest.raises(err):
        fused_conv3x3._tc_plan(*dims, dtype)


# the JAX package's bound for its kernels against XLA, as
# tests/test_torch_kernels.py holds conv_bn_stats in f32; in bf16 a sum
# that differs in its last f32 bits may round y to the neighbouring bf16
# value (2^-7 of it), and the sums follow (1e-4 of their scale)
CONV_TOL = {"f32": dict(rtol=2e-5, atol=1e-5),
            "bf16": dict(rtol=2 ** -7, atol=1e-4)}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,ci,co,k,stride,route", [
    (2, 13, 13, 32, 32, 3, 1, "tc"),     # odd size: rows end mid-tile
    (1, 7, 9, 32, 64, 1, 1, "tc"),
    (1, 7, 9, 32, 32, 3, 1, "tc"),
    (2, 13, 13, 32, 24, 1, 1, "tc"),     # Co = 24 in a 32-wide tile
    (2, 9, 7, 8, 16, 3, 1, "tc"),        # Ci = 8: small-Ci, K 72 -> 96
    (2, 9, 7, 3, 24, 3, 1, "tc"),        # the stem's Ci = 3, K 27 -> 32;
                                         # 9 x 7 inside one 8 x 16 tile
    (3, 26, 18, 3, 32, 3, 1, "tc"),      # 26 x 18: tiles overhang both
                                         # ways, three images
    (2, 9, 7, 8, 16, 1, 1, "cuda_core"),  # Ci = 8, 1x1: no 32-deep slice
    (1, 26, 26, 32, 64, 3, 2, "tc"),     # stride 2, 26^2 -> 13^2
    (3, 7, 9, 32, 32, 3, 1, "tc"),       # rows 128-188: images 2 and 3
])
def test_conv_edges_match_pallas(n, h, w, ci, co, k, stride, route, dtype):
    rng = np.random.RandomState(n * 1000 + h * 10 + co)
    x = rng.randn(n, h, w, ci).astype(np.float32)
    wk = (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(np.float32)
    b = (rng.randn(co) * 0.5).astype(np.float32)    # a nonzero bias
    tdt, jdt = TDT[dtype], JDT[dtype]
    plan = conv_bn._tc_plan(n, h, w, ci, co, k, stride, tdt)
    assert plan.route == (route if dtype == "bf16" else "cuda_core")
    got = conv_bn_stats(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(wk).to(tdt),
                        torch.from_numpy(b).to(tdt), stride)
    args = (jnp.asarray(x, jdt), jnp.asarray(wk, jdt), jnp.asarray(b, jdt))
    want = conv1x1_stats(*args) if k == 1 else conv3x3_stats(*args, stride)
    tol = CONV_TOL[dtype]
    assert got[0].dtype == tdt and got[0].shape == want[0].shape
    for g, wv, name in zip(got, want, ("y", "s1", "s2")):
        wv = np.asarray(wv, np.float32)
        scale = max(1.0, float(np.abs(wv).max()))
        np.testing.assert_allclose(g.float().numpy(), wv, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale, err_msg=name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bq,h,w,k,n,stride,route", [
    (1, 13, 13, 16, 16, 1, "tc"),        # odd size: 8 x 16 tiles overhang
    (1, 7, 9, 16, 8, 1, "tc"),
    (1, 9, 7, 16, 24, 1, "tc"),          # N = 24 in a 64-wide tile
    (1, 9, 7, 8, 16, 1, "cuda_core"),    # K = 8: no 16-deep slice
    (1, 26, 26, 16, 8, 2, "tc"),         # stride 2, 26^2 -> 13^2
    (3, 7, 9, 16, 8, 1, "tc"),           # three images, one tile each
])
def test_fused_conv3x3_edges_match_pallas(interpret, bq, h, w, k, n, stride,
                                          route, dtype):
    plan = fused_conv3x3._tc_plan(bq, h, w, k, n, stride, TDT[dtype])
    assert plan.route == (route if dtype == "bf16" else "cuda_core")
    _compare(_case(11, bq, h, w, k, n, stride), stride, "mish", True, dtype)
