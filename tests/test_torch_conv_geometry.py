"""The conv geometries and layers of the YOLOv1.5, v2 and v3 families,
port against the JAX package, on the CPU.

- ``conv_bn_stats`` (its plain version here: the kernel K1 runs only on
  the card, ``chip_smoke.py`` phase 3) at flax's ``"SAME"`` geometries
  that v1 and the UNet add: 7x7 stride 2, 3x3 stride 2 and 2x2 stride 1,
  on odd and even H and W, against ``flax.linen.Conv(padding="SAME")``:
  y, the statistic sums, and dx, dw, db through ``_conv_vjp`` against
  ``jax.vjp``; the launch plans of those geometries; and the same at the
  geometries the ResNets and MobileNetV2 add (1x1 stride 2, the 7x7
  stride 2 after an explicit pad of 3, the 3x3 stride-2 SAME stem at Ci
  = 3);
- ``max_pool`` (VALID and SAME), ``space_to_depth``, ``ConvActBN`` in
  train and eval mode, ``HeadV1`` and the softmax / constant-anchor
  ``AnchorHead``;
- the int8 form of a biased ConvBN (``Int8ConvBN``) against the JAX
  ``_quant_call`` applied eagerly, and ``make_serving_fn(quant=)``
  serving a calibrated ConvBN of each SAME geometry through kernel Q.

Weights come from one JAX ``init`` through ``bridge.from_flax``; inputs
from a numpy seed. Single modules compare at 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as jnn

from tests.helpers_torch import numpy_tree
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu.models import heads as jheads
from tf2_yolo_tpu.models import layers as jlayers
from tf2_yolo_tpu_torch import export
from tf2_yolo_tpu_torch.bridge import from_flax
from tf2_yolo_tpu_torch.models import heads, layers
from tf2_yolo_tpu_torch.ops.kernels import conv_bn
from tf2_yolo_tpu_torch.ops.kernels import conv_int8 as int8_mod
from tf2_yolo_tpu_torch.ops.kernels.conv_bn import (conv_bn_stats,
                                                    conv_bn_stats_plain)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
# (kernel, stride, H, W): the three SAME geometries on odd and even
# sizes, and the stride-1 3x3 and 1x1 that SAME shares with the darknet
# pad
SAME_CASES = [(7, 2, 20, 20), (7, 2, 21, 18), (3, 2, 14, 14),
              (3, 2, 13, 15), (2, 1, 8, 8), (2, 1, 9, 7), (3, 1, 9, 8),
              (1, 1, 5, 6)]


def _same_ids(cases):
    return [f"{k}x{k}s{s}_{h}x{w}" for k, s, h, w in cases]


def _conv_case(k, s, h, w, seed, ci=5, co=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, w, ci).astype(np.float32)
    kernel = (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(
        np.float32)
    bias = (0.1 * rng.randn(co)).astype(np.float32)
    return rng, x, kernel, bias


@pytest.mark.parametrize("k,s,h,w", SAME_CASES, ids=_same_ids(SAME_CASES))
def test_conv_same_forward_and_vjp_match_flax(k, s, h, w):
    rng, x, kernel, bias = _conv_case(k, s, h, w, k * 100 + h)
    conv = jnn.Conv(8, (k, k), strides=(s, s), padding="SAME")

    def jfun(x, kernel, bias):
        y = conv.apply({"params": {"kernel": kernel, "bias": bias}}, x)
        return y, jnp.sum(y, axis=(0, 1, 2)), jnp.sum(y * y, axis=(0, 1, 2))

    (y, s1, s2), vjp = jax.vjp(jfun, x, kernel, bias)
    xt, kt, bt = (torch.from_numpy(a).requires_grad_()
                  for a in (x, kernel, bias))
    got = conv_bn_stats(xt, kt, bt, s, True, padding="same")
    g = conv_bn.conv_geometry(h, w, k, s, padding="same")
    assert got[0].shape == y.shape == (2, g.ho, g.wo, 8)
    assert (g.ho, g.wo) == (-(-h // s), -(-w // s))
    for a, b in zip(got, (y, s1, s2)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5 * np.abs(b).max())
    # cotangents of y and both sums (the BatchNorm backward's fold)
    cts = (rng.randn(*y.shape).astype(np.float32),
           (0.1 * rng.randn(8)).astype(np.float32),
           (0.01 * rng.randn(8)).astype(np.float32))
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cts])
    for name, a, b in zip(("dx", "dw", "db"), (xt, kt, bt), vjp(cts)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


# (kernel, stride, padding, H, W, Ci): the geometries the ResNets and
# MobileNetV2 add: 1x1 stride 2 (flax SAME, which pads nothing) on even
# and odd sizes, the ResNet stem's jnp.pad of 3 before its 7x7 stride-2
# VALID conv, and MobileNetV2's 3x3 stride-2 SAME stem at Ci = 3
BACKBONE_CASES = [(1, 2, "same", 16, 16, 8), (1, 2, "same", 13, 15, 8),
                  (7, 2, 3, 20, 20, 3), (7, 2, 3, 21, 18, 3),
                  (3, 2, "same", 20, 20, 3), (3, 2, "same", 21, 19, 3)]


@pytest.mark.parametrize("k,s,pad,h,w,ci", BACKBONE_CASES, ids=[
    f"{k}x{k}s{s}_{p if p == 'same' else f'pad{p}'}_{h}x{w}_ci{ci}"
    for k, s, p, h, w, ci in BACKBONE_CASES])
def test_backbone_geometries_forward_and_vjp_match_jax(k, s, pad, h, w, ci):
    """The plain version and ``_conv_vjp`` (the CPU route of K1) against
    flax's conv as the JAX ResNet and MobileNetV2 call it, and its VJP."""
    rng, x, kernel, bias = _conv_case(k, s, h, w, k * 100 + h + ci, ci=ci)
    conv = jnn.Conv(8, (k, k), strides=(s, s),
                    padding="SAME" if pad == "same" else "VALID")

    def jfun(x, kernel, bias):
        if pad != "same":                    # resnet.py's stem
            x = jnp.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        y = conv.apply({"params": {"kernel": kernel, "bias": bias}}, x)
        return y, jnp.sum(y, axis=(0, 1, 2)), jnp.sum(y * y, axis=(0, 1, 2))

    (y, s1, s2), vjp = jax.vjp(jfun, x, kernel, bias)
    xt, kt, bt = (torch.from_numpy(a).requires_grad_()
                  for a in (x, kernel, bias))
    got = conv_bn_stats(xt, kt, bt, s, True, padding=pad)
    g = conv_bn.conv_geometry(h, w, k, s, pad)
    assert got[0].shape == y.shape == (2, g.ho, g.wo, 8)
    for a, b in zip(got, (y, s1, s2)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5 * np.abs(b).max())
    cts = (rng.randn(*y.shape).astype(np.float32),
           (0.1 * rng.randn(8)).astype(np.float32),
           (0.01 * rng.randn(8)).astype(np.float32))
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cts])
    for name, a, b in zip(("dx", "dw", "db"), (xt, kt, bt), vjp(cts)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


def test_explicit_pad_is_not_same():
    """The ResNet stem's pad of 3 reads other pixels than SAME (pad 2 on
    top at even H), and its output differs; a pad outside 0 <= p < k
    raises, as an unsupported geometry does."""
    assert conv_bn.conv_geometry(416, 416, 7, 2, 3) == (208, 208, 3, 3)
    assert conv_bn.conv_geometry(416, 416, 7, 2, "same") == (208, 208, 2, 2)
    assert conv_bn.conv_geometry(17, 16, 1, 2, "same") == (9, 8, 0, 0)
    _, x, kernel, bias = _conv_case(7, 2, 20, 20, 0, ci=3)
    x, kernel, bias = (torch.from_numpy(a) for a in (x, kernel, bias))
    padded = conv_bn_stats(x, kernel, bias, 2, False, padding=3)[0]
    same = conv_bn_stats(x, kernel, bias, 2, False, padding="same")[0]
    assert padded.shape == same.shape
    assert (padded - same).abs().max() > 0.1 * same.abs().max()
    for bad in (-1, 7):
        with pytest.raises(ValueError, match="explicit pad"):
            conv_bn.conv_geometry(20, 20, 7, 2, bad)
    with pytest.raises(ValueError, match="smaller"):
        conv_bn.conv_geometry(2, 2, 7, 2, 0)
    # a padding that is neither 'darknet', 'same' nor an int (a bool too)
    for bad in ("valid", True, None):
        with pytest.raises(ValueError, match="padding"):
            conv_bn.conv_geometry(20, 20, 7, 2, bad)


# (name, N, H, W, Ci, Co, k, s, padding): the backbones' geometries at
# 416^2 and batch 8: the ResNet stem and MobileNetV2's stem on the
# small-Ci kernel, the 1x1 stride-2 projections on the ring
BACKBONE_PLANS = [
    ("resnet stem 7x7s2 pad3", 8, 416, 416, 3, 64, 7, 2, 3),
    ("mobilenet stem 3x3s2 same", 8, 416, 416, 3, 32, 3, 2, "same"),
    ("resnet proj 104^2 256->512 1x1s2", 8, 104, 104, 256, 512, 1, 2,
     "same"),
    ("resnet conv1 26^2 1024->512 1x1s2", 8, 26, 26, 1024, 512, 1, 2,
     "same"),
]


@pytest.mark.parametrize("case", BACKBONE_PLANS,
                         ids=[c[0] for c in BACKBONE_PLANS])
def test_backbone_geometry_plans(case):
    _, n, h, w, ci, co, k, s, pad = case
    g = conv_bn.conv_geometry(h, w, k, s, pad)
    plan = conv_bn._tc_plan(n, h, w, ci, co, k, s, torch.bfloat16, pad)
    assert plan.route == "tc" and plan.smem_bytes <= conv_bn.SMEM_MAX
    if ci < 32:
        # 8 x 16 output tiles of every image; the halo (8 - 1) s + k
        # rows of (16 - 1) s + k pixels; K = k^2 Ci rounded up to 32
        assert plan.config >= conv_bn._IM2COL
        assert plan.grid[0] == n * -(-g.ho // 8) * -(-g.wo // 16)
        tile = plan.config - conv_bn._IM2COL
        bn, warps_m = conv_bn._TC_TILES[tile]
        kp = -(-k * k * ci // 32) * 32
        halo = -(-(7 * s + k) * (15 * s + k) * ci * 2 // 16) * 16
        main = (128 * (kp + 8) + kp * (bn + 8)) * 2 + halo + 4 * kp
        epilogue = 128 * (bn + 8) * 2 + 2 * warps_m * bn * 4
        assert plan.smem_bytes == max(main, epilogue)
    else:
        assert plan.config in conv_bn._TC_TILES
        assert plan.grid[0] == -(-n * g.ho * g.wo // 128)
    # MobileNetV2's 1x1 convs of Ci 16, 24 and 144 fail the ring's Ci % 32
    # test and take the CUDA cores
    for ci_odd in (16, 24, 144):
        assert conv_bn._tc_plan(n, 104, 104, ci_odd, 96, 1, 1,
                                torch.bfloat16).route == "cuda_core"


@pytest.mark.parametrize("h,w,k,s,want", [
    # (H, W, k, s) -> (Ho, Wo, pad top, pad left) and the pad below
    (448, 448, 7, 2, (224, 224, 2, 2, 3)),      # DarknetV1's stem
    (14, 14, 3, 2, (7, 7, 0, 0, 1)),            # DarknetV1's 14 -> 7
    (26, 26, 2, 1, (26, 26, 0, 0, 1)),          # the UNet decoder
    (13, 13, 3, 2, (7, 7, 1, 1, 1)),
    (447, 445, 7, 2, (224, 223, 3, 3, 3)),
])
def test_same_geometry(h, w, k, s, want):
    g = conv_bn.conv_geometry(h, w, k, s, padding="same")
    assert (*g, (g.ho - 1) * s + k - h - g.pad_top) == want
    # total pad max((ceil(H/s) - 1) s + k - H, 0), the smaller half above
    total = max((-(-h // s) - 1) * s + k - h, 0)
    assert g.pad_top == total // 2


def test_darknet_pad_unchanged_and_refusals():
    # the darknet stride-2 pad is the default: one row and column on top
    # and left, H / 2 out, even H only; a 7x7 stride 2 has no darknet pad
    assert conv_bn.conv_geometry(416, 416, 3, 2) == (208, 208, 1, 1)
    assert conv_bn.conv_geometry(416, 416, 3, 2, "same") == (208, 208, 0, 0)
    with pytest.raises(ValueError, match="even"):
        conv_bn.conv_geometry(13, 14, 3, 2)
    with pytest.raises(ValueError, match="darknet"):
        conv_bn.conv_geometry(448, 448, 7, 2)
    for k, s in ((5, 1), (5, 2), (2, 2), (7, 1)):
        with pytest.raises(ValueError, match="unsupported"):
            conv_bn.conv_geometry(16, 16, k, s, "same")
    x, w, b = torch.zeros(1, 8, 8, 3), torch.zeros(7, 7, 3, 8), \
        torch.zeros(8)
    with pytest.raises(ValueError):
        conv_bn_stats(x, w, b, 2)                 # darknet pad, 7x7
    assert conv_bn_stats(x, w, b, 2, padding="same")[0].shape \
        == (1, 4, 4, 8)


# (name, N, H, W, Ci, Co, k, s): the new geometries at the shapes of
# YOLOv1@448 and the UNet@416, at batch 8
PLAN_CASES = [
    ("v1 stem 7x7s2", 8, 448, 448, 3, 64, 7, 2),
    ("v1 14->7 3x3s2", 8, 14, 14, 1024, 1024, 3, 2),
    ("unet 2x2 26^2", 8, 26, 26, 1024, 512, 2, 1),
    ("unet 2x2 52^2", 8, 52, 52, 512, 256, 2, 1),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_same_geometry_plans(case):
    _, n, h, w, ci, co, k, s = case
    g = conv_bn.conv_geometry(h, w, k, s, "same")
    plan = conv_bn._tc_plan(n, h, w, ci, co, k, s, torch.bfloat16, "same")
    assert plan.route == "tc" and plan.smem_bytes <= conv_bn.SMEM_MAX
    if ci < 32:
        # the small-Ci kernel: 8 x 16 output tiles of every image, the
        # halo (8 - 1) 2 + 7 = 21 rows of (16 - 1) 2 + 7 = 37 pixels, K =
        # 147 padded to 160
        assert plan.config >= conv_bn._IM2COL
        assert plan.grid[0] == n * -(-g.ho // 8) * -(-g.wo // 16)
        tile = plan.config - conv_bn._IM2COL
        bn = conv_bn._TC_TILES[tile][0]
        main = (128 * (160 + 8) + 160 * (bn + 8)) * 2 \
            + -(-21 * 37 * ci * 2 // 16) * 16 + 4 * 160
        warps_m = conv_bn._TC_TILES[tile][1]
        epilogue = 128 * (bn + 8) * 2 + 2 * warps_m * bn * 4
        assert plan.smem_bytes == max(main, epilogue)
    else:
        assert plan.config in conv_bn._TC_TILES
        assert plan.grid[0] == -(-n * g.ho * g.wo // 128)
    f32 = conv_bn._tc_plan(n, h, w, ci, co, k, s, torch.float32, "same")
    assert f32.route == "cuda_core"
    assert f32.grid == (-(-n * g.ho * g.wo // 64), -(-co // 64))


def test_small_ci_kernel_keeps_to_the_stems():
    # the small-Ci kernel takes 3x3 s1, 7x7 s2 and the SAME 3x3 s2 (the
    # MobileNetV2 stem); a small-Ci darknet 3x3 s2, 2x2 or 1x1 s2 stays
    # on the CUDA cores
    for k, s, pad in ((3, 2, "darknet"), (2, 1, "same"), (1, 2, "same")):
        assert conv_bn._tc_plan(8, 64, 64, 3, 32, k, s, torch.bfloat16,
                                pad).route == "cuda_core"
    assert conv_bn._tc_plan(8, 64, 64, 3, 32, 3, 2, torch.bfloat16,
                            "same").config >= conv_bn._IM2COL


def test_geometry_counter_key():
    assert conv_bn.geometry_key(7, 2, "same") == "7x7s2 same tc"
    assert conv_bn.geometry_key(7, 2, 3, "tc") == "7x7s2 pad3 tc"
    assert conv_bn.geometry_key(1, 2, "same") == "1x1s2 same tc"
    assert conv_bn.geometry_key(3, 2) == "3x3s2 darknet tc"
    assert conv_bn.geometry_key(3, 1, "darknet", "cuda_core") \
        == "3x3s1 same cuda_core"
    # the CPU route counts nothing
    before = dict(conv_bn_stats.by_geometry)
    conv_bn_stats_plain(torch.zeros(1, 8, 8, 3), torch.zeros(7, 7, 3, 8),
                        torch.zeros(8), 2, True, "same")
    conv_bn_stats(torch.zeros(1, 8, 8, 3), torch.zeros(7, 7, 3, 8),
                  torch.zeros(8), 2, True, padding="same")
    assert dict(conv_bn_stats.by_geometry) == before


# ----------------------------------------------------------------------
@pytest.mark.parametrize("window,stride,padding,h,w", [
    (2, 2, "VALID", 8, 8), (2, 2, "VALID", 9, 7), (2, 2, "SAME", 9, 7),
    (2, 2, "SAME", 8, 8), (2, 1, "SAME", 6, 5), (3, 2, "SAME", 7, 8),
])
def test_max_pool_matches_flax(window, stride, padding, h, w):
    x = np.random.RandomState(h * w).randn(2, h, w, 3).astype(np.float32)
    want = np.asarray(jnn.max_pool(jnp.asarray(x), (window, window),
                                   (stride, stride), padding))
    got = layers.max_pool(torch.from_numpy(x), window, stride, padding)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_space_to_depth_matches_jax():
    x = np.random.RandomState(1).randn(2, 6, 4, 5).astype(np.float32)
    want = np.asarray(jlayers.space_to_depth(jnp.asarray(x), 2))
    got = layers.space_to_depth(torch.from_numpy(x), 2)
    assert got.shape == want.shape == (2, 3, 2, 20)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kernel", [3, 2])
@pytest.mark.parametrize("train", [False, True])
def test_conv_act_bn_matches_jax(kernel, train):
    rng = np.random.RandomState(kernel)
    x = rng.randn(2, 9, 8, 6).astype(np.float32)
    jm = jlayers.ConvActBN(16, kernel)
    v = numpy_tree(jm.init(jax.random.PRNGKey(kernel), jnp.asarray(x)))
    v["params"]["bn"]["scale"] = (1 + 0.2 * rng.randn(16)).astype(np.float32)
    v["params"]["bn"]["bias"] = (0.1 * rng.randn(16)).astype(np.float32)
    v["batch_stats"]["bn"]["mean"] = (0.1 * rng.rand(16)).astype(np.float32)
    v["batch_stats"]["bn"]["var"] = (0.5 + rng.rand(16)).astype(np.float32)
    tm = layers.ConvActBN(6, 16, kernel, device="cpu")
    tm.load_state_dict(from_flax(v), strict=True)
    tm.train(train)
    if train:
        want, new = jm.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    else:
        want, new = jm.apply(v, jnp.asarray(x), train=False), v
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)
    for stat in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(tm.bn, stat).numpy(),
            np.asarray(new["batch_stats"]["bn"][stat]), **TOL)
    if train:
        # the gradient through the batch statistics of relu(conv(x))
        ct = rng.randn(*got.shape).astype(np.float32)
        _, vjp = jax.vjp(lambda p: jm.apply(
            {**v, "params": p}, jnp.asarray(x), train=True,
            mutable=["batch_stats"])[0], v["params"])
        (jg,) = vjp(ct)
        got.backward(torch.from_numpy(ct))
        for name in ("kernel", "bias"):
            want_g = np.asarray(jg["conv"][name])
            np.testing.assert_allclose(
                getattr(tm.conv, name).grad.numpy(), want_g, rtol=1e-5,
                atol=1e-5 * np.abs(want_g).max(), err_msg=name)


def test_head_v1_matches_jax():
    x = np.random.RandomState(2).randn(2, 3, 3, 32).astype(np.float32)
    jm = jheads.HeadV1(2, 3)
    v = numpy_tree(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    tm = heads.HeadV1(32, 2, 3, device="cpu")
    tm.load_state_dict(from_flax(v), strict=True)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 3, 3, 13)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[..., 10:].sum(-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("prob_act", ["softmax", "sigmoid"])
def test_anchor_head_constant_anchors_match_jax(prob_act):
    anchors = [[0.1, 0.2], [0.3, 0.25], [0.6, 0.5]]
    x = np.random.RandomState(3).randn(2, 4, 4, 16).astype(np.float32)
    jm = jheads.AnchorHead(anchors, 3, prob_act=prob_act)
    v = numpy_tree(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    assert set(v["params"]) == {"conv"}          # no anchors leaf
    tm = heads.AnchorHead(16, anchors, 3, prob_act=prob_act,
                          anchors_as_params=False, device="cpu")
    assert "anchors" not in tm.state_dict()
    tm.load_state_dict(from_flax(v), strict=True)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # constants: moved with the module, never trained
    assert not any(p is tm.anchors for p in tm.parameters())


# ----------------------------------------------------------------------
# Int8 of a biased ConvBN (every v1/v2 ConvBN has a conv bias), the plain
# int8 route against the JAX ``_quant_call`` applied eagerly, as
# tests/test_torch_export.py holds the unbiased ones.
@pytest.mark.parametrize("k", [1, 3])
def test_int8_biased_convbn_matches_jax(k):
    rng = np.random.RandomState(10 + k)
    ci, co = 16, 24
    x = (rng.rand(2, 10, 8, ci) * 2 - 1).astype(np.float32)
    jm = jlayers.ConvBN(co, k, act="leaky", use_bias=True,
                        darknet_pad=False, fused=False)
    v = numpy_tree(jm.init(jax.random.PRNGKey(k), jnp.asarray(x)))
    v["params"]["conv"]["bias"] = (0.3 * rng.randn(co)).astype(np.float32)
    v["params"]["bn"]["scale"] = (1 + 0.2 * rng.randn(co)).astype(np.float32)
    v["params"]["bn"]["bias"] = (0.1 * rng.randn(co)).astype(np.float32)
    v["batch_stats"]["bn"]["mean"] = (0.05 * rng.randn(co)).astype(
        np.float32)
    v["batch_stats"]["bn"]["var"] = (0.5 + rng.rand(co)).astype(np.float32)
    tm = layers.ConvBN(ci, co, k, act="leaky", use_bias=True,
                       darknet_pad=False, device="cpu").eval()
    tm.load_state_dict(from_flax(v), strict=True)
    sx = np.float32(np.maximum(np.abs(x).max(), 1e-6) / np.float32(127))
    prev = jlayers.INT8_MIN_CHANNELS
    jlayers.set_int8_min_channels(0)
    try:
        # eager, the scale an argument: each division compiled alone
        want = np.asarray(jm.apply({**v, "quant": {"in_scale": sx}},
                                   jnp.asarray(x), train=False))
    finally:
        jlayers.set_int8_min_channels(prev)
    served = export._serving_copy(tm, {"quant": {"in_scale": sx}}, 0)
    assert isinstance(served, layers.Int8ConvBN)
    with torch.no_grad():
        got = served(torch.from_numpy(x)).numpy()
    # the bias rides in the affine's t, the JAX package adds b * s_bn to
    # the f32 sum after it: one rounding apart (the unbiased cases'
    # bound, 1e-6 of max |out|, with the bias term's rounding on top)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
    # without the bias in t the outputs differ by b * s_bn
    assert np.abs(got - want).max() < 0.01 * np.abs(
        v["params"]["conv"]["bias"]).max()


@pytest.mark.parametrize("k,stride,darknet_pad", [
    (3, 2, False), (7, 2, False), (2, 1, False)])
def test_int8_refuses_the_same_geometries(k, stride, darknet_pad):
    """Kernel Q takes flax's SAME geometries (a run-time top/left pad):
    a calibrated ConvBN of each serves as an ``Int8ConvBN`` whose output
    is the plain int8 conv at ``padding="same"`` (then the activation),
    of ceil(H / s) x ceil(W / s); below the channel gate it stays a
    float ConvBN. tests/test_torch_int8_same.py holds these against the
    JAX ``_quant_call``."""
    tm = layers.ConvBN(8, 16, k, stride, use_bias=True,
                       darknet_pad=darknet_pad, device="cpu").eval()
    quant = {"quant": {"in_scale": torch.tensor(0.01)}}
    assert layers.int8_geometry_ok(tm)
    served = export._serving_copy(tm, quant, 0)
    assert isinstance(served, layers.Int8ConvBN)
    assert served.padding == "same"
    x = torch.from_numpy(
        np.random.RandomState(k).randn(2, 9, 8, 8).astype(np.float32))
    with torch.no_grad():
        got = served(x)
    want = layers.ACTS_EVAL["leaky"](int8_mod.conv_int8_plain(
        x, served.wq, served.c, served.t, 0.01, k, stride, torch.float32,
        "same"))
    assert got.shape == (2, -(-9 // stride), -(-8 // stride), 16)
    assert torch.equal(got, want)
    # below the channel gate it stays a float ConvBN
    assert isinstance(export._serving_copy(tm, quant, 256), layers.ConvBN)
    # the darknet 3x3 stride 2 is Q's
    assert layers.int8_geometry_ok(layers.ConvBN(8, 16, 3, 2, device="cpu"))
