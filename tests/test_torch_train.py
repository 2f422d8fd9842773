"""The port's training path against the JAX package's, module by module
and for one whole train step, in f32 on the CPU on bridged weights.

JAX weights come from one ``init`` with ``PRNGKey(0)``; for the single
modules, BatchNorm parameters and statistics are then set from a seeded
numpy draw. Where the JAX side reaches a Pallas kernel (the fused ConvBN,
the fused GEMMs of the packed backbone) it runs in interpret mode. Every
JAX global a test sets is reset by its fixture.
"""

import inspect

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tf2_yolo_tpu.models import YoloV4 as JYoloV4
from tf2_yolo_tpu.models import layers as jlayers
from tf2_yolo_tpu.models import packed_region as jpr
from tf2_yolo_tpu.models.backbones import CSPDarknet53 as JCSPDarknet53
from tf2_yolo_tpu.models.backbones import CSPStage as JCSPStage
from tf2_yolo_tpu.ops import wrap_yolo_loss_v4 as jwrap_yolo_loss_v4
from tf2_yolo_tpu.ops.pallas import packed_gemm
from tf2_yolo_tpu.parallel import create_train_state as jcreate_train_state
from tf2_yolo_tpu.parallel import make_optimizer as jmake_optimizer
from tf2_yolo_tpu.parallel import make_train_step as jmake_train_step
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.helpers_torch import (assert_leaves, flat, labels, loss_fns,
                                 numpy_tree, rel_l2, release_memory,
                                 with_random_bn)
from tf2_yolo_tpu_torch import bridge
from tf2_yolo_tpu_torch.models import YoloV4
from tf2_yolo_tpu_torch.models import packed_region as region
from tf2_yolo_tpu_torch.models.backbones import CSPDarknet53, CSPStage
from tf2_yolo_tpu_torch.models.heads import AnchorHead
from tf2_yolo_tpu_torch.models.layers import (BNState, Conv, ConvBN, mish,
                                              mish_eval, spp, upsample2x)
from tf2_yolo_tpu_torch.ops.kernels.conv_bn import conv_bn_stats
from tf2_yolo_tpu_torch.ops.losses import wrap_yolo_loss_v4
from tf2_yolo_tpu_torch.parallel import (create_train_state,
                                         get_lr_multiplier, make_eval_step,
                                         make_optimizer, make_train_step,
                                         set_lr_multiplier)

torch.set_num_threads(1)

CLASSES = 3
ANCHORS = np.stack([np.linspace(0.05, 0.75, 9),
                    np.linspace(0.07, 0.65, 9)], axis=1)


@pytest.fixture
def packed_jax():
    """The JAX package's fused-GEMM backbone (stages 3-5, p = 1) with its
    Pallas kernels in interpret mode."""
    packed_gemm.set_interpret(True)
    jlayers.set_packed_early(True)
    yield
    jlayers.set_packed_early(False)
    packed_gemm.set_interpret(False)
    release_memory()         # a whole-model test leaves ~4 GB of cached heap


# ------------------------------------------------------------- ConvBN

@pytest.mark.parametrize("kernel,stride,act", [
    (1, 1, "mish"), (3, 1, "mish"), (3, 2, "mish"), (3, 2, "leaky"),
    (1, 1, "leaky"),
])
def test_convbn_train_matches_fused_jax(kernel, stride, act):
    rng = np.random.RandomState(20 + kernel + stride)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    ct = rng.randn(2, 8 // stride, 8 // stride, 16).astype(np.float32)
    jm = jlayers.ConvBN(16, kernel, stride, act=act, fused=True,
                        kernel_init=jlayers.DARKNET_NORMAL)
    v = with_random_bn(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                train=False), rng)

    def jf(params, xx):
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * ct), (out, mut["batch_stats"])

    (_, (want, want_stats)), (want_gp, want_gx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))

    tm = ConvBN(8, 16, kernel, stride, act=act, device="cpu")
    tm.load_state_dict(bridge.from_flax(v), strict=True)
    tm.train()
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx)
    (out * torch.from_numpy(ct)).sum().backward()
    # a conv of <= 72 products and batch statistics over 128 or 32
    # pixels, f32, another summation order: measured max |diff| 9.5e-7 on
    # outputs up to 4.9; bound as the eval-mode test's
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=1e-5)
    leaves = bridge.flax_leaves(tm)
    for name, leaf in flat(want_stats, "batch_stats/").items():
        # running = 0.99 old + 0.01 batch, biased variance
        np.testing.assert_allclose(leaves[name].numpy(), leaf, rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    # gradients through the batch statistics: measured rel L2 <= 4.1e-7
    assert_leaves(bridge.flax_leaves(tm, grad=True),
                   flat(want_gp, "params/"), 2e-5, "grad")
    assert rel_l2(tx.grad.numpy(), np.asarray(want_gx)) <= 2e-5


def test_convbn_eval_does_not_touch_running_statistics():
    tm = ConvBN(4, 8, 3, device="cpu", act="mish").eval()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        tm(torch.randn(2, 6, 6, 4))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_mish_training_form_value_and_gradient():
    z = np.concatenate([np.linspace(-25, 25, 101), [20.0, 30.0, 88.0]]
                       ).astype(np.float32)
    want, vjp = jax.vjp(jlayers.mish, jnp.asarray(z))
    (want_g,) = vjp(jnp.ones_like(want))
    t = torch.from_numpy(z).requires_grad_()
    out = mish(t)
    out.sum().backward()
    # the same f32 formula and its analytic derivative; exp from two
    # libraries: 2e-6 relative
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g),
                               rtol=2e-6, atol=1e-7)
    # the two forms are one function; below -16 the training form's
    # 1 - 2 / (...) cancels to 0 where the eval form keeps x e^x < 2e-6
    np.testing.assert_allclose(out.detach().numpy(),
                               mish_eval(torch.from_numpy(z)).numpy(),
                               rtol=1e-6, atol=5e-6)


def test_spp_and_upsample_gradients_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 7, 9, 4).astype(np.float32)
    ct_s = rng.randn(2, 7, 9, 16).astype(np.float32)
    ct_u = rng.randn(2, 14, 18, 4).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jlayers.SPP().apply({}, v), jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    spp(t).backward(torch.from_numpy(ct_s))
    # distinct values: each window has one maximum, so the cotangent goes
    # to the same pixel on both sides; sums of <= 3 * 25 + 1 terms
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ct_s))[0]),
                               rtol=1e-5, atol=1e-5)
    _, vjp = jax.vjp(jlayers.upsample2x, jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    upsample2x(t).backward(torch.from_numpy(ct_u))
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ct_u))[0]),
                               rtol=1e-6, atol=1e-6)


def test_spp_gradient_with_tied_maxima_keeps_the_cotangent_sum():
    """Where a window holds equal maxima the two frameworks may credit
    different pixels (bf16 activations tie often); the total is kept."""
    x = torch.zeros(1, 6, 6, 2, requires_grad=True)
    ct = torch.randn(1, 6, 6, 8)
    spp(x).backward(ct)
    np.testing.assert_allclose(x.grad.sum(dim=(1, 2)).numpy(),
                               ct.view(1, 36, 4, 2).sum(dim=(1, 2)).numpy(),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------- packed region parts

def test_activate_and_sums_match_jax():
    rng = np.random.RandomState(5)
    y = rng.randn(3, 5, 5, 8).astype(np.float32)
    a = (1 + 0.2 * rng.randn(1, 8)).astype(np.float32)
    b = (0.3 * rng.randn(1, 8)).astype(np.float32)
    ct = rng.randn(3, 5, 5, 8).astype(np.float32)
    for act in ("mish", "leaky", "linear"):
        want, vjp = jax.vjp(
            lambda yy, aa, bb: jpr.activate(yy, (aa, bb), act, jnp.float32),
            jnp.asarray(y), jnp.asarray(a), jnp.asarray(b))
        wants = vjp(jnp.asarray(ct))
        ts = [torch.from_numpy(v).requires_grad_() for v in (y, a, b)]
        out = region.activate(ts[0], (ts[1], ts[2]), act, torch.float32)
        out.backward(torch.from_numpy(ct))
        # f32 elementwise chain and sums of 75 terms (measured rel L2
        # 2.9e-7): 1e-5
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        for t, w in zip(ts, wants):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)
    want, vjp = jax.vjp(jpr._sums, jnp.asarray(y))
    cts = (rng.randn(8).astype(np.float32), rng.randn(8).astype(np.float32))
    # the port has no separate sums: they come with the conv, whose
    # backward folds ds1 + 2 y ds2; an identity 1x1 kernel makes y = x
    t = torch.from_numpy(y).requires_grad_()
    out, s1, s2 = conv_bn_stats(t, torch.eye(8).reshape(1, 1, 8, 8),
                                torch.zeros(8), 1, want_stats=True)
    assert torch.equal(out, t)
    torch.autograd.backward((s1, s2), tuple(map(torch.from_numpy, cts)))
    np.testing.assert_allclose(s1.detach().numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2.detach().numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        t.grad.numpy(), np.asarray(vjp(tuple(map(jnp.asarray, cts)))[0]),
        rtol=1e-6, atol=1e-6)


def test_bn_affine_and_rows_match_jax():
    rng = np.random.RandomState(6)
    mean, bias = rng.randn(2, 8).astype(np.float32)
    var, scale = (0.5 + rng.rand(2, 8)).astype(np.float32)
    ja, jb = jpr.bn_affine(*map(jnp.asarray, (mean, var, scale, bias)), p=1)
    a, b = region.bn_affine(*map(torch.from_numpy, (mean, var, scale, bias)))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja)[0], rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb)[0], rtol=1e-6,
                               atol=1e-7)
    y4 = torch.arange(2 * 3 * 4 * 5.0).reshape(2, 3, 4, 5)
    rows = region.rows_of(y4)
    # (b, h, w)-major rows: a view, no copy
    assert rows.shape == (24, 5) and rows.data_ptr() == y4.data_ptr()
    assert torch.equal(region.rows_to(rows, 2, 3, 4), y4)


def test_packed_stage_matches_jax_cspstage(packed_jax):
    """``packed_stage`` over the port's CSPStage against the JAX plain
    CSPStage in train mode (as the JAX package's own
    test_packed_p1_only_forward_matches does for its packed path):
    output, new running statistics, gradients."""
    rng = np.random.RandomState(7)
    x = rng.randn(4, 12, 12, 16).astype(np.float32)
    ct = rng.randn(4, 6, 6, 32).astype(np.float32)
    jm = JCSPStage(features=32, blocks=2)
    v = with_random_bn(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                train=False), rng)

    def jf(params, xx):
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * ct), (out, mut["batch_stats"])

    (_, (want, want_stats)), (want_gp, want_gx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))

    tm = CSPStage(16, 32, 2, device="cpu")
    tm.load_state_dict(bridge.from_flax(v), strict=True)
    tm.train()
    tx = torch.from_numpy(x).requires_grad_()
    before = region.fused_gemm.launches
    y2, aff, (b, h, w) = region.packed_stage(tm, tx)
    out = region.rows_to(
        region.activate(y2, aff, "mish", torch.float32), b, h, w)
    (out * torch.from_numpy(ct)).sum().backward()
    assert region.fused_gemm.launches == before       # CPU: plain versions
    # nine ConvBN layers in train mode on 144 pixels a channel, f32,
    # another summation order and the fused affine in place of flax's
    # normalise: measured max |diff| 2.4e-6 on outputs up to 4.5
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    leaves = bridge.flax_leaves(tm)
    for name, leaf in flat(want_stats, "batch_stats/").items():
        np.testing.assert_allclose(leaves[name].numpy(), leaf, rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # measured worst leaf 1.5e-6 rel L2, input gradient 6.9e-7; bound
    # 2e-5
    assert_leaves(bridge.flax_leaves(tm, grad=True),
                   flat(want_gp, "params/"), 2e-5, "grad")
    assert rel_l2(tx.grad.numpy(), np.asarray(want_gx)) <= 2e-5


def test_packed_gemm_convbn_sum_inputs_is_the_sum():
    """``sum_inputs``: y = (sum_i g_i(x_i)) @ w over the full kernel."""
    torch.manual_seed(0)
    cb = ConvBN(8, 6, 1, act="mish", device="cpu").train()
    xs = [torch.randn(10, 8) for _ in range(3)]
    aff = (1 + 0.1 * torch.randn(8), 0.1 * torch.randn(8))
    y, _ = region.packed_gemm_convbn(cb, [(xs[0], aff), (xs[1], None),
                                      (xs[2], aff)], sum_inputs=True)
    g = [region.activate(xs[0], aff, "mish", torch.float32), xs[1],
         region.activate(xs[2], aff, "mish", torch.float32)]
    want = sum(g) @ cb.conv.kernel[0, 0]
    # 24 products in f32, summed as three dots or one
    np.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="channels"):
        region.packed_gemm_convbn(cb, [(xs[0], None), (xs[1], None)])


def test_packed_backbone_matches_jax(packed_jax):
    rng = np.random.RandomState(8)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    jm = JCSPDarknet53()
    v = numpy_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                            train=False))
    want, mut = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    tm = CSPDarknet53(packed=True, device="cpu")
    tm.load_state_dict(bridge.from_flax(v), strict=True)
    tm.train()
    before = region.fused_gemm.launches
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert region.fused_gemm.launches == before
    # 72 train-mode ConvBN layers, down to 2 x 2 x 2 = 8 pixels a channel
    # at the last stage; batch normalisation keeps each layer's scale, so
    # f32 rounding is amplified less than in the eval-mode random net:
    # measured max |diff| 2.2e-4 on taps up to 2.5; bound 10x that
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=2e-3,
                                   atol=2e-3)
    leaves = bridge.flax_leaves(tm)
    for name, leaf in flat(mut["batch_stats"], "batch_stats/").items():
        np.testing.assert_allclose(leaves[name].numpy(), leaf, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # eval mode takes the plain path whatever ``packed`` says
    plain = CSPDarknet53(device="cpu").eval()
    plain.load_state_dict(tm.state_dict())
    with torch.no_grad():
        for g, w_ in zip(tm.eval()(torch.from_numpy(x)),
                         plain(torch.from_numpy(x))):
            assert torch.equal(g, w_)


# ---------------------------------------------------------- train step

def _labels(rng, batch, size):
    return labels(rng, batch, size, CLASSES)


def _loss_fns(wrap, size):
    return loss_fns(wrap, size, CLASSES, ANCHORS)


# The untrained YOLOv4 is chaotically conditioned: 107 BatchNorm + mish
# layers amplify a perturbation of 1e-6 in the input into 5-10% relative
# L2 in most gradient leaves, on the pure JAX path too (the JAX package's
# own tests/test_packed_region.py meets the same and calibrates its bounds
# by it). So the whole-model tests below run the JAX side twice, on x and
# on x + 1e-6, and hold the port to a small multiple of that measured
# noise, leaf by leaf, with an absolute floor for the leaves that are well
# conditioned (heads, last neck layers: 1e-5). What is sharp whatever the
# conditioning is asserted sharply: the first loss, the running statistics
# after one step, Adam's arithmetic (its own test) and every single module
# above.
EPS_PROBE = 1e-6


def test_two_train_steps_match_jax(packed_jax):
    """Two whole train steps (forward with batch statistics, three v4
    losses, backward, Adam 1e-3) from one bridged state: the JAX package
    with its fused-GEMM backbone in interpret mode against the port with
    ``packed=True``."""
    size, batch = 64, 4
    rng = np.random.RandomState(0)
    x = rng.rand(batch, size, size, 3).astype(np.float32)
    ys = _labels(rng, batch, size)

    jm = JYoloV4(anchors=ANCHORS, class_num=CLASSES)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                        train=False)
    jtx = jmake_optimizer("adam", 1e-3)
    jstate = jcreate_train_state(variables, jtx)
    jprobe = jcreate_train_state(variables, jtx)
    start = flat(numpy_tree(jstate.params), "params/")
    jstep = jax.jit(jmake_train_step(jm.apply, jtx,
                                     _loss_fns(jwrap_yolo_loss_v4, size)))

    start_state = bridge.from_flax(jstate)

    # the JAX side first, kept as numpy, and its memory handed back
    # before the port's model is built
    jys = tuple(jnp.asarray(y) for y in ys)

    def copied(tree, prefix):
        return {k: np.array(v) for k, v in flat(tree, prefix).items()}

    wants = []
    for _ in range(2):
        jstate, jlogs = jstep(jstate, jnp.asarray(x), jys)
        jprobe, plogs = jstep(jprobe, jnp.asarray(x + EPS_PROBE), jys)
        wants.append(dict(
            step=int(jstate.step), loss=float(jlogs["loss"]),
            probe_loss=float(plogs["loss"]),
            stats=copied(jstate.batch_stats, "batch_stats/"),
            probe_stats=copied(jprobe.batch_stats, "batch_stats/"),
            params=copied(jstate.params, "params/"),
            probe_params=copied(jprobe.params, "params/")))
    del jstate, jprobe, jstep, variables
    release_memory()

    model = YoloV4(ANCHORS, CLASSES, device="cpu", packed=True)
    model.load_state_dict(start_state, strict=True)
    state = create_train_state(model, make_optimizer("adam", 1e-3),
                               device="cpu")
    step = make_train_step(_loss_fns(wrap_yolo_loss_v4, size))
    tys = tuple(torch.from_numpy(y) for y in ys)

    def stat_excess(got, want):
        """Worst |got - want| / (1e-5 + 1e-4 |want|) over the statistics
        (running = 0.99 old + 0.01 batch: a batch statistic off by 1e-3
        relative moves the running one by 1e-5)."""
        return max(float((np.abs(got[k] - v)
                          / (1e-5 + 1e-4 * np.abs(v))).max())
                   for k, v in want.items())

    for n, want in zip((1, 2), wants):
        state, logs = step(state, torch.from_numpy(x), tys)
        assert state.step == n == want["step"]
        want_loss = want["loss"]
        noise = abs(want["probe_loss"] - want_loss)
        # measured: step 1 |d| 2.8e-4 of 79.86 (3.5e-6 relative; noise
        # 4.1e-6), step 2 3.2% (noise 2.0%: the first Adam update is a
        # sign-like step, see below)
        assert abs(float(logs["loss"]) - want_loss) \
            <= max(4 * noise, 2e-5 * want_loss), (n, noise)

        leaves = {k: v.detach().numpy()
                  for k, v in bridge.flax_leaves(state.model).items()}
        want_stats, want_params = want["stats"], want["params"]
        assert set(want_stats) | set(want_params) == set(leaves)
        # measured excess 0.37 at step 1 (noise 0.30), 318 at step 2
        # (noise 349)
        noise = stat_excess(want["probe_stats"], want_stats)
        assert stat_excess(leaves, want_stats) <= max(1.0, 4 * noise), n

        # Adam's first updates are lr * g / (|g| + 1e-7), the sign of g:
        # where a gradient element lies within the noise of 0 the two
        # sides step in opposite directions, 2 lr apart after one step
        # and 4 lr after two. So: no element further apart than that;
        # per leaf the distance between the two sides stays under 0.75
        # of the distance moved from the start (measured largest 0.56 and
        # 0.62; unrelated directions give 1.41); and over all parameters
        # together it stays within 1.5 times the probe's (measured 0.26
        # against 0.25 at step 1, 0.44 against 0.43 at step 2).
        probe_params = want["probe_params"]
        apart = moved = noise = 0.0
        for name, leaf in want_params.items():
            assert np.abs(leaves[name] - leaf).max() <= 2.05e-3 * n, name
            d2 = float(np.sum((leaves[name] - leaf) ** 2))
            m2 = float(np.sum((leaf - start[name]) ** 2))
            assert 0 < m2 and d2 <= 0.75 ** 2 * m2, (n, name, d2 / m2)
            apart, moved = apart + d2, moved + m2
            noise += float(np.sum((probe_params[name] - leaf) ** 2))
        assert apart ** 0.5 <= 1.5 * noise ** 0.5, (n, apart, noise, moved)


def test_first_step_gradients_match_jax(packed_jax):
    """d(loss)/d(params) of the whole packed model, leaf by leaf."""
    size, batch = 64, 4
    rng = np.random.RandomState(1)
    x = rng.rand(batch, size, size, 3).astype(np.float32)
    ys = _labels(rng, batch, size)
    jm = JYoloV4(anchors=ANCHORS, class_num=CLASSES)
    v = numpy_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                            train=False))
    jfns = _loss_fns(jwrap_yolo_loss_v4, size)

    def jloss(params, xx):
        outs, _ = jm.apply({"params": params,
                            "batch_stats": v["batch_stats"]}, xx,
                           train=True, mutable=["batch_stats"])
        return sum(f(jnp.asarray(y), o) for f, y, o in zip(jfns, ys, outs))

    jgrad = jax.jit(jax.value_and_grad(jloss))
    want_loss, want = jgrad(v["params"], jnp.asarray(x))
    _, probe = jgrad(v["params"], jnp.asarray(x + EPS_PROBE))
    want_loss = float(want_loss)
    want, probe = flat(want, "params/"), flat(probe, "params/")
    del jgrad
    release_memory()         # the JAX side is numpy now

    model = YoloV4(ANCHORS, CLASSES, device="cpu", packed=True).train()
    model.load_state_dict(bridge.from_flax(v), strict=True)
    outs = model(torch.from_numpy(x))
    loss = sum(f(torch.from_numpy(y), o) for f, y, o in
               zip(_loss_fns(wrap_yolo_loss_v4, size), ys, outs))
    loss.backward()
    # measured 3.0e-6 relative
    np.testing.assert_allclose(loss.item(), want_loss, rtol=2e-5)
    got = bridge.flax_leaves(model, grad=True)
    assert got.keys() == want.keys()
    sharp = 0
    for name, leaf in want.items():
        err = rel_l2(got[name].numpy(), leaf)
        noise = rel_l2(probe[name], leaf)
        # measured: err / noise median 0.91, largest 3.5 (head3 anchors,
        # 4.2e-5 against 1.2e-5); err itself median 6.8e-2, largest
        # 9.8e-2, as the probe's (7.4e-2, 9.6e-2). A wrong term or a
        # missing factor in a backward shows as 0.5-1.4 on every leaf
        # upstream of it, above the ceiling.
        assert err <= max(8 * noise, 1e-4), (name, err, noise)
        assert err <= 0.2, (name, err)
        sharp += err < 1e-3
    # the heads and the last neck layers are well conditioned (measured
    # 11 leaves under 1e-3, the head convs at 3e-6 to 3e-5)
    assert sharp >= 8


def test_adam_update_equals_optax():
    """The port's Adam against optax's on the same gradient sequence."""
    rng = np.random.RandomState(3)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [(rng.randn(5, 7) * 10.0 ** rng.randint(-6, 2, (5, 7))
              ).astype(np.float32) for _ in range(4)]
    jtx = jmake_optimizer("adam", 1e-3)
    jp = {"w": jnp.asarray(p0)}
    jopt = jtx.init(jp)

    class One(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(p0.copy()))

    m = One()
    opt = make_optimizer("adam", 1e-3)(m)
    for g in grads:
        upd, jopt = jtx.update({"w": jnp.asarray(g)}, jopt, jp)
        jp = optax.apply_updates(jp, upd)
        m.w.grad = torch.from_numpy(g.copy())
        opt.step()
        # m_hat / (sqrt(v_hat) + 1e-7), eps outside the root, on both
        # sides; the bias corrections are folded in another order
        # (measured max |diff| 1.8e-7 on values up to 2)
        np.testing.assert_allclose(m.w.detach().numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6, atol=1e-7)


def test_lr_multiplier_and_frozen_parameters():
    torch.manual_seed(0)
    head = AnchorHead(8, ANCHORS[:3], CLASSES, device="cpu")
    tx = make_optimizer("adam", 1e-2,
                        frozen=lambda name, p: name.endswith("anchors"))
    state = create_train_state(head, tx, device="cpu")
    assert get_lr_multiplier(state.optimizer) == 1.0
    before = {k: v.detach().clone() for k, v in head.named_parameters()}

    def one_step():
        state.optimizer.zero_grad()
        head(torch.randn(2, 4, 4, 8)).square().mean().backward()
        state.optimizer.step()

    one_step()
    assert torch.equal(head.anchors, before["anchors"])       # frozen
    assert head.anchors.grad is not None
    moved = (head.conv.kernel - before["conv.kernel"]).abs().max().item()
    assert 0.5e-2 < moved <= 1.01e-2                  # Adam: ~lr a step
    set_lr_multiplier(state.optimizer, 0.1)
    assert get_lr_multiplier(state.optimizer) == 0.1
    assert state.optimizer.state_dict()["param_groups"][0][
        "lr_multiplier"] == 0.1
    mid = head.conv.kernel.detach().clone()
    one_step()
    moved = (head.conv.kernel - mid).abs().max().item()
    assert moved <= 1.5e-3                            # 0.1 * lr, moments kept
    # every optimizer of the JAX package is ported; others raise as there
    with pytest.raises(ValueError, match="Unknown optimizer"):
        make_optimizer("lamb")


def test_uint8_input_rescales_on_the_device_and_eval_step():
    torch.manual_seed(0)
    model = YoloV4(ANCHORS, CLASSES, device="cpu")
    state = create_train_state(model, make_optimizer("adam", 1e-3),
                               device="cpu")
    rng = np.random.RandomState(2)
    x8 = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    ys = tuple(torch.from_numpy(y) for y in _labels(rng, 2, 64))
    eval_step = make_eval_step(_loss_fns(wrap_yolo_loss_v4, 64))
    stats = {k: v.clone() for k, v in model.named_buffers()}
    a = eval_step(state, torch.from_numpy(x8), ys)["loss"]
    b = eval_step(state, torch.from_numpy(x8.astype(np.float32) / 255), ys)[
        "loss"]
    # x * (1/255) against x / 255 in f32: the last bit of some pixels
    np.testing.assert_allclose(a.item(), b.item(), rtol=1e-5)
    assert not model.training and not a.requires_grad
    for k, v in model.named_buffers():
        assert torch.equal(v, stats[k]), k


# ------------------------------------------------------------ defaults

@pytest.mark.parametrize("ctor", [YoloV4, ConvBN, Conv, BNState, AnchorHead,
                                  create_train_state])
def test_constructors_default_to_the_card(ctor):
    """Entry points run on the card unless the caller asks for the CPU
    (read from the signature: no card is needed)."""
    target = ctor if ctor is create_train_state else ctor.__init__
    assert inspect.signature(target).parameters["device"].default == "cuda"
