"""The port's all-fused early backbone (``packed=3``) against the JAX
package's ``BENCH_PACKED=3`` route, module by module and for one whole
train step, in f32 on the CPU on bridged weights.

JAX weights come from one ``init`` with ``PRNGKey(0)`` and are bridged,
never drawn twice; for the single modules BatchNorm parameters and
statistics are then set from a seeded numpy draw. The JAX side runs as
its own tests run it: both Pallas kernel families in interpret mode and,
for the whole model, ``set_packed_early(True, p3=True)``; every global is
restored by its fixture. The JAX modules run at p = 1, the only packing
the port has.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tf2_yolo_tpu.models import YoloV4 as JYoloV4
from tf2_yolo_tpu.models import layers as jlayers
from tf2_yolo_tpu.models import packed_region as jpr
from tf2_yolo_tpu.ops import wrap_yolo_loss_v4 as jwrap_yolo_loss_v4
from tf2_yolo_tpu.ops.pallas import packed_conv3x3, packed_gemm
from tf2_yolo_tpu.parallel import create_train_state as jcreate_train_state
from tf2_yolo_tpu.parallel import make_optimizer as jmake_optimizer
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.helpers_torch import (assert_leaves, flat, labels, loss_fns,
                                 numpy_tree, rel_l2, release_memory,
                                 with_random_bn)
from tf2_yolo_tpu_torch import bridge
from tf2_yolo_tpu_torch.models import YoloV4
from tf2_yolo_tpu_torch.models import packed_region as region
from tf2_yolo_tpu_torch.models.backbones import CSPDarknet53, CSPStage
from tf2_yolo_tpu_torch.models.layers import ConvBN
from tf2_yolo_tpu_torch.ops.losses import wrap_yolo_loss_v4
from tf2_yolo_tpu_torch.parallel import (create_train_state, make_optimizer,
                                         make_train_step)

torch.set_num_threads(1)

CLASSES = 2
ANCHORS = np.stack([np.linspace(0.1, 0.8, 9),
                    np.linspace(0.1, 0.7, 9)], axis=1)
SIZE, BATCH = 64, 4
EPS_PROBE = 1e-6


@pytest.fixture(scope="module")
def interpret():
    packed_gemm.set_interpret(True)
    packed_conv3x3.set_interpret(True)
    yield
    packed_conv3x3.set_interpret(False)
    packed_gemm.set_interpret(False)


@pytest.fixture(scope="module")
def p3_jax(interpret):
    """The JAX package's all-fused early region (``BENCH_PACKED=3``)."""
    jlayers.set_packed_early(True, p3=True)
    yield
    jlayers.set_packed_early(False)


def _rows(x4):
    """NHWC -> the JAX package's (h, w, b)-major rows."""
    b, h, w, c = x4.shape
    return np.ascontiguousarray(x4.transpose(1, 2, 0, 3)).reshape(
        h * w * b, c)


def _unrows(y2, b, h, w):
    return np.asarray(y2).reshape(h, w, b, -1).transpose(2, 0, 1, 3)


def _producer(rng, shape):
    """A raw producer output and its BN affine."""
    x = rng.randn(*shape).astype(np.float32)
    a = (1 + 0.2 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.3 * rng.randn(shape[-1])).astype(np.float32)
    return x, a, b


# ----------------------------------------------------- single modules

@pytest.mark.parametrize("stride", [1, 2])
def test_fused_conv3x3_convbn_matches_jax(interpret, stride):
    """``fused_conv3x3_convbn`` over the port's ConvBN against
    ``PackedPallasConvBN3x3`` at p = 1: raw output, consumer affine,
    running statistics and every gradient."""
    rng = np.random.RandomState(30 + stride)
    bsz, h, w, ci, co = 4, 16, 16, 8, 16
    x, a, b = _producer(rng, (bsz, h, w, ci))
    ho, wo = h // stride, w // stride
    ct_y = rng.randn(bsz, ho, wo, co).astype(np.float32)
    ct_a, ct_b = rng.randn(2, co).astype(np.float32)
    jm = jpr.PackedPallasConvBN3x3(co, stride, p=1)
    spatial = (bsz, h, w)
    aff = (jnp.asarray(a)[None], jnp.asarray(b)[None])
    v = with_random_bn(jm.init(jax.random.PRNGKey(0), jnp.asarray(_rows(x)),
                                aff, spatial), rng)

    def jf(params, x2, aa, bb):
        (y2, (oa, ob)), mut = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x2,
            (aa, bb), spatial, train=True, mutable=["batch_stats"])
        loss = (jnp.sum(y2 * _rows(ct_y)) + jnp.sum(oa * ct_a)
                + jnp.sum(ob * ct_b))
        return loss, (y2, oa, ob, mut["batch_stats"])

    (_, (want_y, want_a, want_b, want_stats)), want_g = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True)(
            v["params"], jnp.asarray(_rows(x)), *aff)

    tm = ConvBN(ci, co, 3, stride, act="mish", device="cpu").train()
    tm.load_state_dict(bridge.from_flax(v), strict=True)
    tx, ta, tb = (torch.from_numpy(t).requires_grad_() for t in (x, a, b))
    y4, (oa, ob) = region.fused_conv3x3_convbn(tm, tx, (ta, tb))
    ((y4 * torch.from_numpy(ct_y)).sum() + (oa * torch.from_numpy(ct_a)).sum()
     + (ob * torch.from_numpy(ct_b)).sum()).backward()
    # one conv of 72 products and batch statistics over 1024 or 256
    # pixels, f32, another summation order (measured max |diff| 2.1e-7 on
    # y up to 0.55, 1.9e-6 on the affine up to 15.5; gradients <= 5.7e-7
    # rel L2): 1e-5
    np.testing.assert_allclose(y4.detach().numpy(),
                               _unrows(want_y, bsz, ho, wo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(oa.detach().numpy(), np.asarray(want_a)[0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ob.detach().numpy(), np.asarray(want_b)[0],
                               rtol=1e-5, atol=1e-6)
    leaves = bridge.flax_leaves(tm)
    for name, leaf in flat(want_stats, "batch_stats/").items():
        np.testing.assert_allclose(leaves[name].numpy(), leaf, rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert_leaves(bridge.flax_leaves(tm, grad=True),
                   flat(want_g[0], "params/"), 1e-5, "grad")
    assert rel_l2(tx.grad.numpy(),
                   _unrows(want_g[1], bsz, h, w)) <= 1e-5
    assert rel_l2(ta.grad.numpy(), np.asarray(want_g[2])[0]) <= 1e-5
    assert rel_l2(tb.grad.numpy(), np.asarray(want_g[3])[0]) <= 1e-5


@pytest.mark.parametrize("features,blocks,narrow", [(16, 2, True),
                                                    (16, 1, False)])
def test_p3_stage_matches_jax(interpret, features, blocks, narrow):
    """``p3_stage`` over the port's CSPStage against ``P3CSPStage`` at
    p = 1 on a [4, 16, 16, 8] raw input with its affine (stage 2's form:
    two blocks, narrow; stage 1's: one block, full width)."""
    rng = np.random.RandomState(40 + blocks)
    bsz, h, w, ci = 4, 16, 16, 8
    x, a, b = _producer(rng, (bsz, h, w, ci))
    ct_y = rng.randn(bsz, h // 2, w // 2, features).astype(np.float32)
    ct_a, ct_b = rng.randn(2, features).astype(np.float32)
    jm = jpr.P3CSPStage(features, blocks, narrow, p=1)
    aff = (jnp.asarray(a)[None], jnp.asarray(b)[None])
    carry = (jnp.asarray(_rows(x)), aff, (bsz, h, w))
    v = with_random_bn(jm.init(jax.random.PRNGKey(0), carry), rng)

    def jf(params, x2, aa, bb):
        (y2, (oa, ob), sp), mut = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            (x2, (aa, bb), (bsz, h, w)), train=True, mutable=["batch_stats"])
        assert sp == (bsz, h // 2, w // 2)
        loss = (jnp.sum(y2 * _rows(ct_y)) + jnp.sum(oa * ct_a)
                + jnp.sum(ob * ct_b))
        return loss, (y2, oa, ob, mut["batch_stats"])

    (_, (want_y, want_a, want_b, want_stats)), want_g = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True)(v["params"], carry[0], *aff)

    tm = CSPStage(ci, features, blocks, narrow, device="cpu").train()
    tm.load_state_dict(bridge.from_flax(v), strict=True)
    tx, ta, tb = (torch.from_numpy(t).requires_grad_() for t in (x, a, b))
    y2, (oa, ob), sp = region.p3_stage(tm, tx, (ta, tb))
    assert sp == (bsz, h // 2, w // 2)
    y4 = region.rows_to(y2, *sp)
    ((y4 * torch.from_numpy(ct_y)).sum() + (oa * torch.from_numpy(ct_a)).sum()
     + (ob * torch.from_numpy(ct_b)).sum()).backward()
    # seven or nine ConvBN layers in train mode on 256 pixels a channel,
    # f32, another summation order (measured max |diff| 2.1e-7 on y up to
    # 0.40, 3.8e-6 on the affine up to 25; worst gradient leaf 1.6e-6 rel
    # L2): 2e-5 as packed_stage's test
    np.testing.assert_allclose(y4.detach().numpy(),
                               _unrows(want_y, *sp), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(oa.detach().numpy(), np.asarray(want_a)[0],
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(ob.detach().numpy(), np.asarray(want_b)[0],
                               rtol=2e-5, atol=2e-6)
    leaves = bridge.flax_leaves(tm)
    for name, leaf in flat(want_stats, "batch_stats/").items():
        np.testing.assert_allclose(leaves[name].numpy(), leaf, rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert_leaves(bridge.flax_leaves(tm, grad=True),
                   flat(want_g[0], "params/"), 2e-5, "grad")
    assert rel_l2(tx.grad.numpy(), _unrows(want_g[1], bsz, h, w)) <= 2e-5
    assert rel_l2(ta.grad.numpy(), np.asarray(want_g[2])[0]) <= 2e-5
    assert rel_l2(tb.grad.numpy(), np.asarray(want_g[3])[0]) <= 2e-5


def test_p3_res_block_appends_a_term():
    """The residual add distributes over the next GEMM: the activated sum
    of the term list through the plain block equals the route's term."""
    torch.manual_seed(0)
    stage = CSPStage(8, 16, 1, device="cpu").train()
    block, spatial = stage.block1, (2, 6, 6)
    terms = [(torch.randn(72, 8), (1 + 0.1 * torch.randn(8),
                                   0.1 * torch.randn(8))) for _ in range(2)]
    ex_y, ex_aff = region.p3_res_block(block, terms, spatial)
    x_act = sum(region.activate(y, aff, "mish", torch.float32)
                for y, aff in terms)
    want = x_act + region.rows_of(block.expand(
        region.rows_to(block.squeeze(region.rows_to(x_act, *spatial)),
                       *spatial).contiguous()))
    got = x_act + region.activate(ex_y, ex_aff, "mish", torch.float32)
    # two ConvBN layers in train mode, f32, 72 pixels a channel (measured
    # max |diff| 9.5e-7 on values up to 5.6)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=2e-5, atol=2e-5)


# -------------------------------------------------------- whole model

def _loss_fns(wrap):
    return loss_fns(wrap, SIZE, CLASSES, ANCHORS)


@pytest.fixture(scope="module")
def whole(p3_jax):
    """One JAX train step under ``BENCH_PACKED=3`` (and its probe on
    x + 1e-6) and the port's ``packed=3`` step from the same bridged
    state, computed once for the tests below. The JAX step is its loss
    and gradients under one ``jit`` and then the package's Adam applied
    to them as its ``make_train_step`` applies it (a second ``jit`` of
    the whole step would compile the network once more, 0.7 GB)."""
    rng = np.random.RandomState(0)
    x = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    ys = labels(rng, BATCH, SIZE, CLASSES)
    jm = JYoloV4(anchors=ANCHORS, class_num=CLASSES)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                        train=False)
    jtx = jmake_optimizer("adam", 1e-3)
    jstate = jcreate_train_state(variables, jtx)
    start = numpy_tree({"params": jstate.params,
                         "batch_stats": jstate.batch_stats})
    jfns = _loss_fns(jwrap_yolo_loss_v4)
    jys = tuple(jnp.asarray(y) for y in ys)

    def jloss(params, xx):
        outs, mut = jm.apply({"params": params,
                              "batch_stats": start["batch_stats"]}, xx,
                             train=True, mutable=["batch_stats"])
        loss = sum(f(y, o) for f, y, o in zip(jfns, jys, outs))
        return loss, (outs, mut["batch_stats"])

    jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    (jl, (jouts, jstats)), jg = jgrad(start["params"], jnp.asarray(x))
    (_, _), jg_probe = jgrad(start["params"], jnp.asarray(x + EPS_PROBE))

    def adam(grads):
        updates, _ = jtx.update(grads, jstate.opt_state, jstate.params)
        return flat(optax.apply_updates(jstate.params, updates), "params/")

    want = dict(
        jouts=[np.asarray(o) for o in jouts], jloss=float(jl),
        jstats=flat(jstats, "batch_stats/"), jgrads=flat(jg, "params/"),
        jgrads_probe=flat(jg_probe, "params/"),
        jparams=adam(jg), jparams_probe=adam(jg_probe))
    # the JAX side is numpy now: drop its programs and buffers before the
    # port's model is built
    del jouts, jstats, jg, jg_probe, jstate, jgrad, variables
    release_memory()

    model = YoloV4(ANCHORS, CLASSES, device="cpu", packed=3)
    model.load_state_dict(bridge.from_flax(start), strict=True)
    model.train()
    outs = model(torch.from_numpy(x))
    loss = sum(f(torch.from_numpy(y), o) for f, y, o in
               zip(_loss_fns(wrap_yolo_loss_v4), ys, outs))
    loss.backward()
    fwd = dict(outs=[o.detach().numpy() for o in outs], loss=loss.item(),
               grads={k: v.numpy() for k, v in
                      bridge.flax_leaves(model, grad=True).items()},
               stats={k: v.detach().numpy().copy() for k, v in
                      bridge.flax_leaves(model).items()
                      if k.startswith("batch_stats/")})

    stepped = YoloV4(ANCHORS, CLASSES, device="cpu", packed=3)
    stepped.load_state_dict(bridge.from_flax(start), strict=True)
    state = create_train_state(stepped, make_optimizer("adam", 1e-3),
                               device="cpu")
    state, logs = make_train_step(_loss_fns(wrap_yolo_loss_v4))(
        state, torch.from_numpy(x), tuple(torch.from_numpy(y) for y in ys))
    params = {k: v.detach().numpy() for k, v in
              bridge.flax_leaves(state.model).items()
              if k.startswith("params/")}
    del model, stepped, state, outs, loss
    release_memory()
    return dict(want, fwd=fwd, step_loss=float(logs["loss"]), params=params)


def test_packed3_head_outputs_and_statistics_match_jax(whole):
    # 107 train-mode ConvBN layers; batch normalisation keeps each
    # layer's scale, so f32 rounding is amplified less than in the
    # eval-mode net (measured max |diff| 2.8e-4 on head outputs up to
    # 2.2); the bound is the full-network one of tests/test_torch_serving.py
    for got, want in zip(whole["fwd"]["outs"], whole["jouts"]):
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-3 * max(1.0, np.abs(want).max()))
    assert whole["fwd"]["stats"].keys() == whole["jstats"].keys()
    for name, leaf in whole["jstats"].items():
        # running = 0.99 old + 0.01 batch (measured max |diff| 4.5e-6)
        np.testing.assert_allclose(whole["fwd"]["stats"][name], leaf,
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_packed3_first_loss_matches_jax(whole):
    # measured 7.1e-7 relative of 75.2, and the train step's the same
    np.testing.assert_allclose(whole["fwd"]["loss"], whole["jloss"],
                               rtol=1e-5)
    np.testing.assert_allclose(whole["step_loss"], whole["jloss"],
                               rtol=1e-5)


def test_packed3_gradients_match_jax_within_the_probe(whole):
    """The untrained net is chaotic (a 1e-6 input change moves most
    gradient leaves 5-10%), so each leaf is held to a multiple of the JAX
    side's own probe noise, as tests/test_torch_train.py does, with a
    floor: the probe perturbs the input only, while two implementations
    round differently in every layer, and the three leaves under the
    coarse head (``out_s``, ``bu2.conv5``: BatchNorm over 16 values a
    channel) answer the latter far more than the former."""
    got, want, probe = (whole["fwd"]["grads"], whole["jgrads"],
                        whole["jgrads_probe"])
    assert got.keys() == want.keys()
    sharp = 0
    for name, leaf in want.items():
        err = rel_l2(got[name], leaf)
        noise = rel_l2(probe[name], leaf)
        # measured: err median 6.9e-2 (probe 4.6e-2), largest 9.1e-2;
        # err / noise median 1.5 and under 2.5 on all leaves but three:
        # out_s.conv.kernel 1.3e-2 (probe 7.2e-4), bu2.conv5.bn.scale
        # 1.4e-2 (7.2e-4), out_s.bn.bias 7.1e-3 (1.2e-4). Floor 2e-2. A
        # wrong term in a backward shows as 0.5-1.4 on every leaf
        # upstream of it
        assert err <= max(8 * noise, 2e-2), (name, err, noise)
        assert err <= 0.2, (name, err)
        sharp += err < 1e-3
    assert sharp >= 8


def test_packed3_adam_update_matches_jax_within_the_probe(whole):
    """Adam's first update is lr * g / (|g| + 1e-7), the sign of g: an
    element whose gradient lies within the noise of 0 steps the other
    way, 2 lr apart; over all parameters the distance stays within 1.5
    times the probe's (measured 1.18; unrelated directions give about
    5)."""
    apart = noise = 0.0
    for name, leaf in whole["jparams"].items():
        got = whole["params"][name]
        assert np.abs(got - leaf).max() <= 2.05e-3, name
        apart += float(np.sum((got - leaf) ** 2))
        noise += float(np.sum((whole["jparams_probe"][name] - leaf) ** 2))
    assert 0 < apart ** 0.5 <= 1.5 * noise ** 0.5, (apart, noise)


# ------------------------------------------------- routes of the port

def _port_models(*packed):
    torch.manual_seed(0)
    models = [YoloV4(ANCHORS, CLASSES, device="cpu", packed=p)
              for p in packed]
    for m in models[1:]:
        m.load_state_dict(models[0].state_dict())
    return models


def test_packed3_eval_mode_is_the_plain_path_exactly():
    plain, fused = _port_models(False, 3)
    x = torch.rand(2, SIZE, SIZE, 3)
    with torch.no_grad():
        for got, want in zip(fused.eval()(x), plain.eval()(x)):
            assert torch.equal(got, want)


def test_packed3_takes_any_batch_on_the_fused_route(monkeypatch):
    """A batch of 3 (the JAX route needs a batch that 4 divides and
    otherwise falls back) runs the fused route and matches the plain
    path."""
    plain, fused = _port_models(False, 3)
    calls = []
    real = region.fused_conv3x3
    monkeypatch.setattr(
        region, "fused_conv3x3",
        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    x = torch.rand(3, SIZE, SIZE, 3)
    with torch.no_grad():
        got, want = fused.train()(x), plain.train()(x)
    assert len(calls) == 5 and all(s[0] == 3 for s in calls)
    for g, w_ in zip(got, want):
        # train-mode forward, f32, another summation order through 16
        # layers (measured max |diff| 3.0e-4 on outputs up to 1.6;
        # running statistics 6.8e-6)
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=0,
                                   atol=5e-3 * max(1.0, w_.abs().max().item()))
    for (k, a), (_, b) in zip(fused.named_buffers(), plain.named_buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("packed,ok", [(False, True), (0, True), (True, True),
                                       (1, True), (3, True), (2, False),
                                       (4, False), ("3", False)])
def test_packed_values(packed, ok):
    if ok:
        assert CSPDarknet53(packed=packed, device="cpu").packed == int(packed)
    else:
        with pytest.raises(ValueError, match="packed"):
            CSPDarknet53(packed=packed, device="cpu")
