"""Kernel Q at flax's SAME geometries (YOLOv1.5's 7x7 stride-2 stem and
3x3 stride 2), port against the JAX package, on the CPU: Q's plain
version (the kernel runs only on the card, ``chip_smoke.py`` phases 16a
and 16b hold it to this plain version bit for bit) against eager JAX
``_quant_call`` arithmetic, its int32 sums exact, every split of K
included; the launch plans at the served shapes; a biased SAME ConvBN's
int8 form against the JAX ``_quant_call``; and a small YOLOv1.5 twin
served int8 at gate 0 against the JAX program (three ConvBNs, the SAME
stem, pool, the SAME stride 2, a 1x1, and the v1 head), under the
small-twin rule of ``tests/test_torch_export.py``: the int8 outputs of
a small net agree to f32 rounding. Last, the whole YOLOv1.5 of the port
calibrates and serves at gates 0 and 256 with every DarknetV1 ConvBN on
Q at gate 0.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from tests.helpers_families import _calibrate_bn
from tests.helpers_torch import numpy_tree
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu import export as jexport
from tf2_yolo_tpu.models import layers as jlayers
from tf2_yolo_tpu.models.heads import HeadV1 as JHeadV1
from tf2_yolo_tpu_torch import export
from tf2_yolo_tpu_torch.bridge import from_flax, to_flax
from tf2_yolo_tpu_torch.models import YoloV1
from tf2_yolo_tpu_torch.models.heads import HeadV1
from tf2_yolo_tpu_torch.models.layers import (ConvBN, Int8ConvBN,
                                              int8_geometry_ok, max_pool)
from tf2_yolo_tpu_torch.ops.kernels import conv_int8 as q

torch.set_num_threads(1)

# (kernel, stride, H, W, Ci, Co): the stem (Ci = 3, the gather route)
# and the stride-2 3x3 (the ring) on even and odd sizes
SAME_CASES = [(7, 2, 20, 20, 3, 8), (7, 2, 21, 18, 3, 8),
              (3, 2, 14, 14, 32, 16), (3, 2, 13, 15, 32, 16)]


def _ids(cases):
    return [f"{k}x{k}s{s}_{h}x{w}_ci{ci}" for k, s, h, w, ci, _ in cases]


@pytest.mark.parametrize("case", SAME_CASES, ids=_ids(SAME_CASES))
def test_plain_q_int32_sums_match_jax(case):
    k, s, h, w, ci, co = case
    rng = np.random.RandomState(h * w + ci)
    x = (rng.rand(2, h, w, ci) * 2 - 1).astype(np.float32)
    kernel = rng.randn(k, k, ci, co).astype(np.float32)
    sx = np.float32(np.abs(x).max() / np.float32(127))
    xq = q.quantize_int8_plain(torch.from_numpy(x), float(sx))
    wq8, _ = q.quantize_weights(torch.from_numpy(kernel))
    wq = q.weight_layout(wq8)
    acc = q.conv_int8_acc_plain(xq, wq, k, s, padding="same")
    # eager JAX, the JAX ConvBN's quantized conv
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq.numpy()), jnp.asarray(wq8.numpy()), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    assert acc.shape == want.shape == (2, -(-h // s), -(-w // s), co)
    assert np.array_equal(acc.numpy(), want)
    # the kernel's split-K partial sums add up to the same integers
    plan = q._plan(2, h, w, ci, co, k, s, "same")
    slices = -(-plan.kp // 128)
    for splits in q._split_choices(slices):
        per = slices // splits * 128
        parts = sum(q.conv_int8_acc_plain(xq, wq, k, s, lo, lo + per,
                                          padding="same")
                    for lo in range(0, plan.kp, per))
        assert torch.equal(parts, acc)
    # the whole plain version: float(acc) * c, then + t
    c = torch.from_numpy((0.5 + rng.rand(co)).astype(np.float32) * 1e-3)
    t = torch.from_numpy(rng.randn(co).astype(np.float32))
    y = q.conv_int8_plain(torch.from_numpy(x), wq, c, t, float(sx), k, s,
                          torch.float32, "same")
    assert torch.equal(y, torch.from_numpy(np.array(want)).float() * c + t)
    assert torch.equal(
        y, q.conv_int8_xq_plain(xq, wq, c, t, k, s, torch.float32, "same"))


@pytest.mark.parametrize("batch", [8, 32])
def test_plans_at_the_served_shapes(batch):
    """YOLOv1.5 at 448^2: the stem on the gather route, K = 147 padded to
    160 (two 128-byte slices, one split); the 14^2 -> 7^2 stride 2 on the
    ring, K split where its few row tiles leave SMs idle."""
    stem = q._plan(batch, 448, 448, 3, 64, 7, 2, "same")
    assert (stem.route, stem.kp, stem.splits) == ("gather", 160, 1)
    assert stem.grid[0] == -(-batch * 224 * 224 // 128)
    s2 = q._plan(batch, 14, 14, 1024, 1024, 3, 2, "same")
    assert s2.route == "ring" and s2.kp == 9 * 1024
    m = batch * 7 * 7
    assert s2.grid[0] == -(-m // 128)
    assert s2.grid[0] * s2.grid[1] * s2.splits >= 132
    assert (9 * 1024 // 128) % s2.splits == 0
    # the darknet pad stays a 3x3 stride-2 pad
    with pytest.raises(ValueError, match="darknet"):
        q._plan(batch, 448, 448, 3, 64, 7, 2)


@pytest.mark.parametrize("k", [7, 3])
def test_int8_same_convbn_matches_jax(k):
    """A biased SAME stride-2 ConvBN (the DarknetV1 conv), its int8 form
    against the JAX ``_quant_call`` applied eagerly (bound as
    tests/test_torch_conv_geometry.py's biased case: 2e-6 of max |out|,
    the bias term rides in t)."""
    rng = np.random.RandomState(30 + k)
    ci, co = (3, 16) if k == 7 else (24, 16)
    x = (rng.rand(2, 13, 10, ci) * 2 - 1).astype(np.float32)
    jm = jlayers.ConvBN(co, k, 2, act="leaky", use_bias=True,
                        darknet_pad=False, fused=False)
    v = numpy_tree(jm.init(jax.random.PRNGKey(k), jnp.asarray(x)))
    v["params"]["conv"]["bias"] = (0.3 * rng.randn(co)).astype(np.float32)
    v["params"]["bn"]["scale"] = (1 + 0.2 * rng.randn(co)).astype(np.float32)
    v["params"]["bn"]["bias"] = (0.1 * rng.randn(co)).astype(np.float32)
    v["batch_stats"]["bn"]["mean"] = (0.05 * rng.randn(co)).astype(
        np.float32)
    v["batch_stats"]["bn"]["var"] = (0.5 + rng.rand(co)).astype(np.float32)
    tm = ConvBN(ci, co, k, 2, act="leaky", use_bias=True, darknet_pad=False,
                device="cpu").eval()
    tm.load_state_dict(from_flax(v), strict=True)
    assert int8_geometry_ok(tm)
    sx = np.float32(np.maximum(np.abs(x).max(), 1e-6) / np.float32(127))
    prev = jlayers.INT8_MIN_CHANNELS
    jlayers.set_int8_min_channels(0)
    try:
        want = np.asarray(jm.apply({**v, "quant": {"in_scale": sx}},
                                   jnp.asarray(x), train=False))
    finally:
        jlayers.set_int8_min_channels(prev)
    served = export._serving_copy(tm, {"quant": {"in_scale": sx}}, 0)
    assert isinstance(served, Int8ConvBN) and served.padding == "same"
    with torch.no_grad():
        got = served(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 7, 5, co)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


# ----------------------------------------------------------------------
TWIN = 64
TWIN_CLASSES = 2
TWIN_THRESHOLD = 0.3


class _JTwin(fnn.Module):
    """A small YOLOv1.5 in flax: the SAME 7x7 stride-2 stem (the gather
    route), a pool, the SAME 3x3 stride 2 and a 1x1 (the ring), the v1
    head."""

    @fnn.compact
    def __call__(self, x, train=False):
        conv = dict(act="leaky", use_bias=True, darknet_pad=False,
                    fused=False)
        x = jlayers.ConvBN(32, 7, 2, name="c1", **conv)(x, train)
        x = jlayers.max_pool(x)
        x = jlayers.ConvBN(64, 3, 2, name="c2", **conv)(x, train)
        x = jlayers.ConvBN(32, 1, 1, name="c3", **conv)(x, train)
        return JHeadV1(2, TWIN_CLASSES, name="head")(x)


class _Twin(torch.nn.Module):
    """Its torch twin, with the same names."""

    def __init__(self):
        super().__init__()
        conv = dict(act="leaky", use_bias=True, darknet_pad=False,
                    device="cpu")
        self.c1 = ConvBN(3, 32, 7, 2, **conv)
        self.c2 = ConvBN(32, 64, 3, 2, **conv)
        self.c3 = ConvBN(64, 32, 1, 1, **conv)
        self.head = HeadV1(32, 2, TWIN_CLASSES, device="cpu")

    def forward(self, x):
        return self.head(self.c3(self.c2(max_pool(self.c1(x)))))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", float(np.asarray(v))


def _kept(rows, keep):
    rows, keep = np.asarray(rows), np.asarray(keep)
    return np.concatenate([r[k] for r, k in zip(rows, keep)])


def test_v1_twin_int8_serving_matches_jax():
    x = np.random.RandomState(5).rand(4, TWIN, TWIN, 3).astype(np.float32)
    jmodel = _JTwin()
    init = numpy_tree(jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    model = _Twin().eval()
    model.load_state_dict(from_flax(init), strict=True)
    xt = torch.from_numpy(x)
    _calibrate_bn(model, xt)
    variables = to_flax(model.state_dict())
    quant = export.calibrate_int8(model, [xt[:2], xt[2:]])
    jquant = numpy_tree(jexport.calibrate_int8(jmodel, variables,
                                               [x[:2], x[2:]]))
    got_q, want_q = dict(_leaves(quant)), dict(_leaves(jquant))
    assert got_q.keys() == want_q.keys() and len(want_q) == 3
    for key, w in want_q.items():
        assert abs(got_q[key] - w) <= 1e-5 * w, key
    prev = jlayers.INT8_MIN_CHANNELS
    jlayers.set_int8_min_channels(0)
    try:
        jrows, jkeep = jexport.make_serving_fn(
            jmodel, variables, TWIN_CLASSES, 1, threshold=TWIN_THRESHOLD,
            quant=jquant)(jnp.asarray(x))
    finally:
        jlayers.set_int8_min_channels(prev)
    joint = np.asarray(jrows[..., 4] * jrows[..., 6])
    serve = export.make_serving_fn(model, TWIN_CLASSES, 1,
                                   threshold=TWIN_THRESHOLD, quant=quant,
                                   int8_min_channels=0)
    assert sum(isinstance(m, Int8ConvBN)
               for m in serve.program.modules()) == 3
    rows, keep = serve(xt)
    want, got = _kept(jrows, jkeep), _kept(rows.numpy(), keep.numpy())
    assert 0 < len(want) < int((joint >= TWIN_THRESHOLD).sum())
    assert got.shape == want.shape
    # class ids exact; the rest within f32 rounding of the int8 outputs
    # (the small-twin bound of tests/test_torch_export.py, 1e-5)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_yolov1_serves_int8_at_both_gates():
    """The port's full-width YOLOv1.5 (at 64^2 on the CPU): every one of
    DarknetV1's 23 ConvBNs takes Q at gate 0, those with min(Ci, Co) >=
    256 at gate 256, and both programs serve finite rows."""
    gen = torch.Generator().manual_seed(0)
    model = YoloV1(2, 3, generator=gen, device="cpu").eval()
    convbns = {n: m for n, m in model.named_modules()
               if isinstance(m, ConvBN)}
    assert len(convbns) == 23 and all(map(int8_geometry_ok,
                                          convbns.values()))
    x = torch.rand(2, 64, 64, 3, generator=gen)
    _calibrate_bn(model, x)
    quant = export.calibrate_int8(model, [x])
    for gate in (0, 256):
        serve = export.make_serving_fn(model, 3, 1, threshold=0.1,
                                       quant=quant, int8_min_channels=gate)
        int8 = [m for m in serve.program.modules()
                if isinstance(m, Int8ConvBN)]
        want = sum(min(m.conv.kernel.shape[2:]) >= gate
                   for m in convbns.values())
        assert len(int8) == want and want >= (23 if gate == 0 else 14)
        assert {m.padding for m in int8} == {"same"}
        rows, keep = serve(x)
        assert rows.shape == (2, 128, 7) and torch.isfinite(rows).all()
