"""The port's modules and ops against their JAX counterparts, at narrow
widths in f32, on bridged weights.

JAX weights come from one ``init`` with ``PRNGKey(0)``; BatchNorm
parameters and statistics are then set from a seeded numpy draw (the
init's identity BN would leave the BN math untested), and the same
numpy tree goes to both sides through ``bridge.from_flax``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as jnn

from tf2_yolo_tpu.models import layers as jlayers
from tf2_yolo_tpu.models.backbones import CSPStage as JCSPStage
from tf2_yolo_tpu.models.detectors import FPNStage as JFPNStage
from tf2_yolo_tpu.models.heads import AnchorHead as JAnchorHead
from tf2_yolo_tpu.ops.decode import decode_multi_level as jdecode
from tf2_yolo_tpu.ops.nms import apply_nms_device as japply_nms
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch.bridge import from_flax, to_flax
from tf2_yolo_tpu_torch.models.backbones import CSPStage
from tf2_yolo_tpu_torch.models.detectors import FPNStage
from tf2_yolo_tpu_torch.models.heads import AnchorHead
from tf2_yolo_tpu_torch.models.layers import ConvBN, spp, upsample2x
from tf2_yolo_tpu_torch.ops.decode import decode_multi_level
from tf2_yolo_tpu_torch.ops.nms import apply_nms_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_random_bn(variables, rng):
    """Replace every BN scale/bias/mean/var leaf with a seeded draw."""
    def walk(params, stats):
        for name, node in params.items():
            if name == "bn":
                f = node["scale"].shape[0]
                node["scale"] = (1 + 0.2 * rng.randn(f)).astype(np.float32)
                node["bias"] = (0.1 * rng.randn(f)).astype(np.float32)
                stats[name]["mean"] = (0.05 * rng.randn(f)).astype(np.float32)
                stats[name]["var"] = (0.01 + 0.05 * rng.rand(f)).astype(
                    np.float32)
            elif isinstance(node, dict):
                walk(node, stats.get(name, {}))
    v = _numpy_tree(variables)
    walk(v["params"], v.get("batch_stats", {}))
    return v


def _bridged(jmodule, tmodule, x, rng, **init_kw):
    v = jmodule.init(jax.random.PRNGKey(0), jnp.asarray(x), **init_kw)
    v = _with_random_bn(v, rng)
    tmodule.load_state_dict(from_flax(v), strict=True)
    return v, tmodule.eval()


def _port(tmodule, x):
    with torch.no_grad():
        return tmodule(torch.from_numpy(x))


@pytest.mark.parametrize("kernel,stride,act", [
    (1, 1, "mish"), (3, 1, "mish"), (3, 2, "mish"),
    (1, 1, "leaky"), (3, 1, "leaky"), (3, 2, "leaky"),
])
def test_convbn_matches_fused_jax(kernel, stride, act):
    rng = np.random.RandomState(10 + kernel + stride)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    jm = jlayers.ConvBN(16, kernel, stride, act=act, fused=True,
                        kernel_init=jlayers.DARKNET_NORMAL)
    v, tm = _bridged(
        jm, ConvBN(8, 16, kernel, stride, act=act, device="cpu"), x, rng,
        train=False)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    got = _port(tm, x).numpy()
    # a conv of <= 72 products summed in another order, then the BN
    # divide by sqrt(var + 1e-3) >= 0.1: measured max |diff| 2.4e-6 on
    # outputs up to 5.2; the bound is the JAX package's own for its
    # fused-vs-XLA ConvBN, 4x above that
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


def test_biased_conv_without_bn_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    jm = jlayers.ConvBN(12, 1, act="linear", use_bn=False)
    v = _numpy_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["conv"]["bias"] = rng.randn(12).astype(np.float32)
    tm = ConvBN(8, 12, 1, act="linear", use_bn=False, device="cpu")
    tm.load_state_dict(from_flax(v), strict=True)
    # 8-term f32 dots: measured max |diff| 4.8e-7 on outputs up to 6.1
    np.testing.assert_allclose(
        _port(tm, x).numpy(), np.asarray(jm.apply(v, jnp.asarray(x))),
        rtol=2e-5, atol=1e-5)


def test_spp_and_upsample_match_jax():
    x = np.random.RandomState(4).randn(2, 7, 9, 4).astype(np.float32)
    want = np.asarray(jlayers.SPP().apply({}, jnp.asarray(x)))
    got = spp(torch.from_numpy(x)).numpy()
    # max pools and copies: exact
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        upsample2x(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.upsample2x(jnp.asarray(x))))


def test_csp_stage_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, 16, 16).astype(np.float32)
    jm = JCSPStage(features=32, blocks=1)
    v, tm = _bridged(jm, CSPStage(16, 32, 1, device="cpu"), x, rng,
                     train=False)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    # six ConvBN layers and a residual, f32 summation order only:
    # measured max |diff| 2.1e-7 on outputs up to 0.79; bound 10x that
    np.testing.assert_allclose(_port(tm, x).numpy(), want,
                               rtol=2e-6, atol=2e-6)


def test_fpn_stage_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 8, 24).astype(np.float32)
    jm = JFPNStage(16, make_out=False, kernel_init=jlayers.DARKNET_NORMAL)
    v, tm = _bridged(jm, FPNStage(24, 16, device="cpu"), x, rng, train=False)
    want, _ = jm.apply(v, jnp.asarray(x), train=False)
    # five ConvBN layers, f32 summation order only: measured max |diff|
    # 2.0e-7 on outputs up to 0.91; bound 10x that
    np.testing.assert_allclose(_port(tm, x).numpy(), np.asarray(want),
                               rtol=2e-6, atol=2e-6)


def test_anchor_head_matches_jax():
    rng = np.random.RandomState(7)
    x = (5 * rng.randn(2, 6, 6, 32)).astype(np.float32)
    anchors = np.array([[0.1, 0.2], [0.3, 0.25], [0.5, 0.6]], np.float32)
    jm = JAnchorHead(anchors, 3, prob_act="sigmoid", anchors_as_params=True,
                     kernel_init=jnn.initializers.normal(stddev=0.02))
    v = _numpy_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = AnchorHead(32, anchors, 3, device="cpu")
    tm.load_state_dict(from_flax(v), strict=True)
    # sigmoid/exp of a 32-term f32 dot: measured max |diff| 4.8e-7 on
    # outputs up to 2.1 (the exp'd wh)
    np.testing.assert_allclose(
        _port(tm, x).numpy(), np.asarray(jm.apply(v, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    assert to_flax(tm.state_dict())["params"]["anchors"].shape == (3, 2)


def test_decode_multi_level_matches_jax():
    rng = np.random.RandomState(8)
    levels = [rng.rand(2, s, s, 24).astype(np.float32) for s in (3, 6, 12)]
    want_rows, want_valid = jdecode([jnp.asarray(a) for a in levels],
                                    class_num=3, threshold=0.7,
                                    max_boxes=128, version=4)
    rows, valid = decode_multi_level([torch.from_numpy(a) for a in levels],
                                     class_num=3, threshold=0.7,
                                     max_boxes=128)
    want_valid = np.asarray(want_valid)
    assert 0 < want_valid.sum() < want_valid.size
    # same selection and order, invalid rows included (they tie at -1 and
    # keep the lower index first on both sides); the values are the same
    # f32 operations, so only a last-bit difference is allowed
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_allclose(rows.numpy(), np.asarray(want_rows),
                               rtol=1e-6, atol=0)


def _nms_rows(seed):
    rng = np.random.RandomState(seed)
    rows = np.zeros((2, 128, 7), np.float32)
    rows[:, :40] = rng.rand(2, 40, 7)
    rows[:, :40, :2] = 0.5 + rng.randn(2, 40, 2) * 0.1
    rows[:, :40, 2:4] = rows[:, :40, 2:4] * 0.3 + 0.2
    rows[:, :40, 5] = rng.randint(0, 3, (2, 40))
    valid = np.zeros((2, 128), bool)
    valid[:, :35] = True
    return rows, valid


def _kept_sorted(rows, keep):
    kept = np.asarray(rows)[np.asarray(keep)]
    return kept[np.lexsort(kept.T[::-1])]


@pytest.mark.parametrize("nms_mode", [1, 3])
def test_apply_nms_device_matches_jax(nms_mode):
    rows, valid = _nms_rows(9 + nms_mode)
    jr, jk = japply_nms(jnp.asarray(rows), jnp.asarray(valid),
                        nms_mode=nms_mode, nms_threshold=0.45)
    tr, tk = apply_nms_device(torch.from_numpy(rows),
                              torch.from_numpy(valid), nms_mode=nms_mode,
                              nms_threshold=0.45)
    want = _kept_sorted(jr, jk)
    assert 0 < len(want) < valid.sum()
    # the kept rows are input rows, reordered: exactly equal
    np.testing.assert_array_equal(_kept_sorted(tr.numpy(), tk.numpy()), want)
    # and in the same confidence order as the JAX sort
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_apply_nms_device_modes_0_and_2():
    rows, valid = _nms_rows(1)
    r, v = apply_nms_device(torch.from_numpy(rows), torch.from_numpy(valid),
                            nms_mode=0)
    assert torch.equal(v, torch.from_numpy(valid))
    # Soft-NMS: the rows sorted as JAX sorts them, the same keep mask
    jr, jk = japply_nms(jnp.asarray(rows), jnp.asarray(valid), nms_mode=2,
                        nms_threshold=0.45, conf_threshold=0.5,
                        nms_sigma=0.5)
    tr, tk = apply_nms_device(r, v, nms_mode=2, nms_threshold=0.45,
                              conf_threshold=0.5, nms_sigma=0.5)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < tk.sum() < valid.sum()
    with pytest.raises(ValueError, match="nms_mode"):
        apply_nms_device(r, v, nms_mode=4)


def test_port_imports_no_jax():
    code = ("import sys, tf2_yolo_tpu_torch, tf2_yolo_tpu_torch.models, "
            "tf2_yolo_tpu_torch.export, tf2_yolo_tpu_torch.bridge, "
            "tf2_yolo_tpu_torch.ops.kernels; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'tf2_yolo_tpu')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
