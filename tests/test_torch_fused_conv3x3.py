"""The port's fused 3x3 conv on the CPU (its plain versions) against the
JAX package's Pallas kernels in interpret mode, forward and backward.

``fused_conv3x3`` is held to ``packed_conv3x3.fused_conv3x3`` and its
custom VJP on the same numpy-seeded inputs. The JAX function takes
(h, w, b)-major rows and a ``spatial`` argument, the port the NHWC tensor;
the JAX ``im2col`` flag is a variant of the same function and is held to
the port's one route at K = 3. The explicit plain backward is also held
to autograd through an independent padded conv, so that the two plain
versions agree with each other. The CUDA kernels themselves run only on
the card, through ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tf2_yolo_tpu.models import packed_region as jpr
from tf2_yolo_tpu.ops.pallas import packed_conv3x3
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch.ops.kernels.fused_conv3x3 import (
    fused_conv3x3, fused_conv3x3_bwd_plain, fused_conv3x3_plain)
from tf2_yolo_tpu_torch.ops.kernels.fused_gemm import act_and_grad

torch.set_num_threads(1)

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# Every bound is relative to the tensor's largest element (``scale``).
# f32: sums of <= 9 * 8 products (y, dx) or <= 240 pixels (dW, da, db) in
# another order, and exp from two libraries. Measured max |diff| / scale:
# y and dx 2.9e-7, s1 and s2 4.3e-7, dW, da and db 4.7e-7 (values up to
# 574). Bound 1e-5 of scale, 20 times that.
# bf16: both sides round the same f32 values to 8 bits. Measured: no
# element of y, dx or dW differs; s1, s2, da and db (f32 sums of bf16
# values) within 1.5e-7 of scale. Where two f32 sums differ in their last
# bit a result may round to the neighbouring bf16 value, 1 ulp: the bound
# allows that (2^-7 of the value) plus 1e-4 of scale.
TOL = {"f32": dict(rtol=0, atol=1e-5), "bf16": dict(rtol=2 ** -7,
                                                     atol=1e-4)}


@pytest.fixture
def interpret():
    packed_conv3x3.set_interpret(True)
    yield
    packed_conv3x3.set_interpret(False)


def _case(seed, bq, h, w, k, n, stride):
    """Inputs at the scales of tests/test_packed_conv3x3.py, and the
    cotangents of a loss that uses y, s1 and s2."""
    rng = np.random.RandomState(seed)
    x4 = (rng.randn(bq, h, w, k) * 0.5).astype(np.float32)
    wk = (rng.randn(3, 3, k, n) * 0.3).astype(np.float32)
    a = (rng.rand(k) + 0.5).astype(np.float32)
    b = (rng.randn(k) * 0.2).astype(np.float32)
    cts = (rng.randn(bq, h // stride, w // stride, n).astype(np.float32),
           rng.randn(n).astype(np.float32),
           (rng.randn(n) * 0.1).astype(np.float32))
    return x4, wk, a, b, cts


def _close(got, want, tol, tag):
    want = np.asarray(want, np.float32).reshape(got.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale, err_msg=tag)


def _jax_side(x4, wk, a, b, cts, stride, act, has_affine, dtype, im2col):
    """(y4, s1, s2) and (dx4, dw, da, db) of the JAX function, with the
    rows laid out (h, w, b)-major as it takes them."""
    bq, h, w, _ = x4.shape
    jdt = JDT[dtype]

    def jf(x4j, wj, aj, bj):
        aff = (aj.reshape(1, -1), bj.reshape(1, -1)) if has_affine else None
        y2, s1, s2 = packed_conv3x3.fused_conv3x3(
            jpr.rows_of(x4j), wj, aff, spatial=(bq, h, w), stride=stride,
            act=act, im2col=im2col, dtype=jdt)
        return jpr.rows_to(y2, bq, h // stride, w // stride), s1, s2

    want, vjp = jax.vjp(jf, jnp.asarray(x4, jdt), jnp.asarray(wk, jdt),
                        jnp.asarray(a), jnp.asarray(b))
    grads = vjp((jnp.asarray(cts[0], jdt), jnp.asarray(cts[1])[None],
                 jnp.asarray(cts[2])[None]))
    return want, grads


def _port_side(x4, wk, a, b, cts, stride, act, has_affine, dtype):
    tdt = TDT[dtype]
    tx = torch.from_numpy(x4).to(tdt).requires_grad_()
    tw = torch.from_numpy(wk).to(tdt).requires_grad_()
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    before = fused_conv3x3.launches, fused_conv3x3.bwd_launches
    got = fused_conv3x3(tx, tw, (ta, tb) if has_affine else None,
                        stride=stride, act=act, dtype=tdt)
    leaves = [tx, tw] + ([ta, tb] if has_affine else [])
    grads = torch.autograd.grad(
        got, leaves, (torch.from_numpy(cts[0]).to(tdt),
                      torch.from_numpy(cts[1]), torch.from_numpy(cts[2])))
    # a CPU tensor takes the plain versions, which are no launches
    assert (fused_conv3x3.launches, fused_conv3x3.bwd_launches) == before
    return got, grads


def _compare(case, stride, act, has_affine, dtype, im2col=False):
    x4, wk, a, b, cts = case
    want, want_g = _jax_side(x4, wk, a, b, cts, stride, act, has_affine,
                             dtype, im2col)
    (y, s1, s2), grads = _port_side(x4, wk, a, b, cts, stride, act,
                                    has_affine, dtype)
    tol = TOL[dtype]
    assert y.dtype == TDT[dtype] and s1.dtype == s2.dtype == torch.float32
    assert y.shape == want[0].shape and y.is_contiguous()
    _close(y.detach(), want[0], tol, "y")
    _close(s1.detach(), want[1], tol, "s1")
    _close(s2.detach(), want[2], tol, "s2")
    assert grads[0].dtype == grads[1].dtype == TDT[dtype]
    for name, g, wg in zip(("dx", "dw", "da", "db"), grads, want_g):
        _close(g, wg, tol, name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("has_affine", [True, False])
@pytest.mark.parametrize("act", ["mish", "leaky"])
@pytest.mark.parametrize("stride", [1, 2])
def test_fused_conv3x3_matches_pallas(interpret, stride, act, has_affine,
                                      dtype):
    _compare(_case(stride, 2, 8, 8, 4, 6, stride), stride, act, has_affine,
             dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("stride", [1, 2])
def test_rectangular_and_bigger_batch_matches_pallas(interpret, stride,
                                                     dtype):
    _compare(_case(3, 4, 10, 6, 8, 4, stride), stride, "mish", True, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("im2col", [True, False])
@pytest.mark.parametrize("has_affine", [True, False])
def test_small_k_matches_both_pallas_variants(interpret, has_affine, im2col,
                                              dtype):
    """K = 3, the stem's shape class: the JAX package picks its ``im2col``
    variant there; the port's one route equals both."""
    _compare(_case(4, 2, 6, 8, 3, 8, 1), 1, "mish", has_affine, dtype,
             im2col)


def _independent_forward(x, w, a, b, stride, act):
    """The same function written another way: activate, pad the ACTIVATED
    tensor explicitly (all round for stride 1, top/left for stride 2),
    then a VALID conv; differentiated by autograd."""
    g = x if a is None else act_and_grad(x * a + b, act)[0]
    pad = (1, 0, 1, 0) if stride == 2 else (1, 1, 1, 1)
    gp = F.pad(g.permute(0, 3, 1, 2), pad)
    y = F.conv2d(gp, w.permute(3, 2, 0, 1), stride=stride).permute(
        0, 2, 3, 1)
    return y, y.sum(dim=(0, 1, 2)), (y * y).sum(dim=(0, 1, 2))


@pytest.mark.parametrize("has_affine", [True, False])
@pytest.mark.parametrize("act", ["mish", "leaky", "linear"])
@pytest.mark.parametrize("stride", [1, 2])
def test_plain_versions_match_autograd_of_a_padded_conv(stride, act,
                                                        has_affine):
    x4, wk, a, b, cts = _case(7, 3, 6, 10, 5, 7, stride)
    tx, tw, ta, tb = (torch.from_numpy(v).requires_grad_()
                      for v in (x4, wk, a, b))
    if not has_affine:
        ta = tb = None
    dy, ds1, ds2 = map(torch.from_numpy, cts)
    want = _independent_forward(tx, tw, ta, tb, stride, act)
    leaves = [t for t in (tx, tw, ta, tb) if t is not None]
    want_g = torch.autograd.grad(want, leaves, (dy, ds1, ds2))
    with torch.no_grad():
        y, s1, s2 = fused_conv3x3_plain(tx, tw, ta, tb, stride, act)
        got_g = fused_conv3x3_bwd_plain(tx, tw, ta, tb, y, dy, ds1, ds2,
                                        stride, act)
    # f32, the same sums written two ways (measured: the forward is
    # equal bit for bit, the gradients within 2.5e-7 of their largest
    # element, up to 919): 1e-5 of the largest element
    for got, ref in zip((y, s1, s2), want):
        _close(got, ref.detach().numpy(), TOL["f32"], "forward")
    for got, ref in zip([g for g in got_g if g is not None], want_g):
        _close(got, ref.numpy(), TOL["f32"], "backward")
    assert (got_g[2] is None) == (got_g[3] is None) == (not has_affine)


@pytest.mark.parametrize("stride", [1, 2])
def test_padding_applies_after_the_prologue(stride):
    """A pixel outside the image contributes 0, not act(0 * a + b): a
    zero-padded INPUT run through the prologue would be wrong."""
    x4, wk, a, b, _ = _case(8, 2, 6, 6, 4, 5, stride)
    b = b + 1.0                                   # act(b) far from 0
    tx, tw, ta, tb = map(torch.from_numpy, (x4, wk, a, b))
    y, _, _ = fused_conv3x3(tx, tw, (ta, tb), stride=stride,
                            dtype=torch.float32)
    want, _, _ = _independent_forward(tx, tw, ta, tb, stride, "mish")
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=2e-5, atol=1e-5)
    pad = (0, 0, 1, 0, 1, 0) if stride == 2 else (0, 0, 1, 1, 1, 1)
    g_wrong = act_and_grad(F.pad(tx, pad) * ta + tb, "mish")[0]
    wrong = F.conv2d(g_wrong.permute(0, 3, 1, 2), tw.permute(3, 2, 0, 1),
                     stride=stride).permute(0, 2, 3, 1)
    # the two agree in the interior and differ on the padded edges
    assert (y - wrong).abs().max() > 0.1
    np.testing.assert_allclose(y[:, 1:-1, 1:-1].numpy(),
                               wrong[:, 1:-1, 1:-1].numpy(), rtol=2e-5,
                               atol=1e-5)


def test_ds1_enters_in_f32_and_dyf_is_rounded_once():
    """bf16: the constant ds1 term is not rounded to the compute type (it
    would swamp small dy entries) while dy + 2 y ds2 is rounded once."""
    x4, wk, a, b, cts = _case(9, 2, 6, 6, 4, 5, 1)
    dt = torch.bfloat16
    tx, tw = (torch.from_numpy(v).to(dt) for v in (x4, wk))
    ta, tb = map(torch.from_numpy, (a, b))
    dy = (1e-3 * torch.from_numpy(cts[0])).to(dt)
    ds1 = torch.full((5,), 1.0 + 2.0 ** -10)      # not a bf16 value
    ds2 = torch.zeros(5)
    y, _, _ = fused_conv3x3_plain(tx, tw, ta, tb, 1, "mish")
    dx, dw, da, db = fused_conv3x3_bwd_plain(tx, tw, ta, tb, y, dy, ds1, ds2)
    # reference in f64 with ds1 exact; one with ds1 rounded to bf16 first
    def ref(ds1_used):
        xd = tx.double().requires_grad_()
        yy, s1, _ = _independent_forward(xd, tw.double(), ta.double(),
                                         tb.double(), 1, "mish")
        (gx,) = torch.autograd.grad((yy, s1), [xd],
                                    (dy.double(), ds1_used.double()))
        return gx
    exact, rounded = ref(ds1), ref(ds1.to(dt).float())
    err = (dx.double() - exact).abs().max().item()
    # dx itself is rounded to bf16 (2^-9 relative); rounding ds1 moves it
    # by 2^-10 relative on top, which the exact term must not show
    assert err <= 2 ** -8 * exact.abs().max().item()
    assert (rounded - exact).abs().max().item() > 0
    assert dx.dtype == dt and dw.dtype == da.dtype == db.dtype \
        == torch.float32 and dw.shape == (3, 3, 4, 5)


@pytest.mark.parametrize("case", ["act", "stride", "dtype", "rank", "weight",
                                  "affine", "odd", "device"])
def test_fused_conv3x3_wrapper_rejects(case):
    x, w = torch.zeros(2, 4, 4, 3), torch.zeros(3, 3, 3, 5)
    aff, stride, act, dtype, err = None, 1, "mish", torch.float32, ValueError
    if case == "act":
        act = "relu"
    elif case == "stride":
        stride = 3
    elif case == "dtype":
        dtype, err = torch.float64, TypeError
    elif case == "rank":
        x = torch.zeros(32, 3)
    elif case == "weight":
        w = torch.zeros(3, 3, 4, 5)
    elif case == "affine":
        aff = (torch.ones(2), torch.zeros(2))
    elif case == "odd":
        x, stride = torch.zeros(2, 5, 4, 3), 2
    elif case == "device":
        x, w = x.to("meta"), w.to("meta")
    with pytest.raises((err, RuntimeError) if case == "affine" else err):
        fused_conv3x3(x, w, aff, stride=stride, act=act, dtype=dtype)
