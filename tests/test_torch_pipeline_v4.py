"""The port's pipeline cuts of YOLOv4 against the JAX package's
(tests/test_pipeline.py's YOLOv4 cases): the 2- and 3-stage pipelined
eval forward and frozen-statistics gradients at 32^2, and the train-mode
BatchNorm step at 64^2 with its running statistics, from the JAX init
through ``bridge``. Each is held to the port's single-program model bit
for bit and to the JAX package by a probe of the JAX computation itself
(the input moved by 1e-6), as the JAX package's own test of its
train-mode cut does: the random net amplifies f32 rounding about 1e4
times in eval mode and is chaotic in train mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.helpers_torch import flat, numpy_tree, rel_l2
from tf2_yolo_tpu_torch import bridge
from tf2_yolo_tpu_torch.models import YoloV4
from tf2_yolo_tpu_torch.parallel import (PipelineExecutor, make_optimizer,
                                         split_yolov4)

torch.set_num_threads(1)
EPS_PROBE = 1e-6
ANCHORS = np.stack([np.linspace(0.1, 0.8, 9), np.linspace(0.1, 0.7, 9)],
                   axis=1)
SIZE = 32


def _log1p_loss(out, *_):
    """The JAX test's loss: log1p keeps the exp(wh) channels' gradient
    bounded."""
    return sum(torch.log1p(o ** 2).mean() for o in out)


def _jlog1p_loss(out):
    return sum(jnp.mean(jnp.log1p(o ** 2)) for o in out)


@pytest.fixture(scope="module")
def v4():
    """The JAX YOLOv4 (2 classes): its init, and on 4 images (and on the
    images moved by EPS_PROBE) the gradient of the log1p loss with the
    running statistics (frozen; its eval outputs beside) at 32^2, and
    with train-mode BatchNorm (its new statistics beside) at 64^2, where
    the JAX package tests its train-mode cut (at 32^2 the last stage's
    statistics are over 4 values a channel, and the net's chaos swamps
    the probe): two programs."""
    from tf2_yolo_tpu.models import YoloV4 as JYoloV4
    module = JYoloV4(anchors=ANCHORS, class_num=2)
    rng = np.random.RandomState(4)
    x = rng.rand(4, SIZE, SIZE, 3).astype(np.float32)
    x64 = rng.rand(4, 64, 64, 3).astype(np.float32)
    v = numpy_tree(module.init(jax.random.PRNGKey(0), x[:1], train=False))

    def frozen(p, xin):
        out = module.apply({**v, "params": p}, xin, train=False)
        return _jlog1p_loss(out), out

    def train(p, xin):
        out, mut = module.apply({**v, "params": p}, xin, train=True,
                                mutable=["batch_stats"])
        return _jlog1p_loss(out), mut["batch_stats"]

    g_frozen = jax.jit(jax.value_and_grad(frozen, has_aux=True))
    g_train = jax.jit(jax.value_and_grad(train, has_aux=True))
    out = {}
    for key, eps in (("x", 0.0), ("probe", EPS_PROBE)):
        (lf, heads), gf = g_frozen(v["params"], x + eps)
        (lt, st), gt = g_train(v["params"], x64 + eps)
        out[key] = dict(eval=[np.asarray(o) for o in heads],
                        frozen_loss=float(lf), frozen=flat(gf, "params/"),
                        train_loss=float(lt), train=flat(gt, "params/"),
                        stats=flat(st, "batch_stats/"))
    return v, (x, x64), out


def _check_loss(got, jout, key):
    """A loss within 8 times the JAX probe's distance, or 1e-5."""
    want, probe = jout["x"][key], jout["probe"][key]
    assert abs(got - want) <= max(8 * abs(probe - want), 1e-5 * abs(want)), \
        (got, want, probe)


def _port_v4(v, packed=False):
    model = YoloV4(ANCHORS, 2, device="cpu", packed=packed)
    model.load_state_dict(bridge.from_flax(v), strict=True)
    return model


def _check_heads(got, want, probe):
    """Each head within 8 times the JAX probe's distance (and 1e-5 of
    its scale), at most 5e-3 of it: the random net amplifies f32
    rounding about 1e4 times in eval mode."""
    for g, w, p in zip(got, want, probe):
        err = np.abs(g.numpy() - w).max()
        noise = np.abs(p - w).max()
        scale = np.abs(w).max()
        assert err <= max(8 * noise, 1e-5 * scale), (err, noise, scale)
        assert err <= 5e-3 * scale, (err, scale)


def _check_probed(got, want, probe):
    """Per-stage gradients against JAX's, leaf by leaf: within 100 times
    the probe's distance or 5e-3 relative L2, and 0.2 at most (the JAX
    package's rule for its own train-mode cut)."""
    got = {"params/" + k.replace(".", "/"): v for g in got
           for k, v in g.items()}
    assert got.keys() == want.keys()
    for name, leaf in want.items():
        err = rel_l2(got[name].numpy(), leaf)
        noise = rel_l2(probe[name], leaf)
        assert err <= max(100 * noise, 5e-3), (name, err, noise)
        assert err <= 0.2, (name, err)


@pytest.mark.parametrize("n_stages", [2, 3])
def test_split_yolov4_pipeline_matches_full_apply(v4, n_stages):
    """The pipelined eval forward equals the port's whole model bit for
    bit and the JAX apply by the probe; the cut is a disjoint, complete
    partition of the state_dict; (3 stages) the frozen-statistics
    gradients match JAX's, and a step with them trains the parameters
    only."""
    v, (x, _), jout = v4
    model = _port_v4(v).eval()
    with torch.no_grad():
        whole = model(torch.from_numpy(x))
    stages, params = split_yolov4(model, n_stages=n_stages)
    keys = [set(m.state_dict()) for m in params]
    assert set().union(*keys) == set(model.state_dict())
    assert sum(len(k) for k in keys) == len(model.state_dict())
    if n_stages == 3:
        assert {k.split(".")[1] for k in keys[0]} == {
            "stem", "stage1", "stage2", "stage3"}
        assert {k.split(".")[1] for k in keys[1]} == {"stage4", "stage5"}
        assert not any(k.startswith("backbone.") for k in keys[2])
    else:
        assert all(k.startswith("backbone.") for k in keys[0])
    pipe = PipelineExecutor(stages, params, devices=["cpu"] * n_stages)
    got = pipe.run(torch.from_numpy(x), microbatch=2)
    for g, w in zip(got, whole):
        assert torch.equal(g, w)
    _check_heads(got, jout["x"]["eval"], jout["probe"]["eval"])
    if n_stages == 2:
        return
    loss, grads = pipe.value_and_grad(_log1p_loss)(torch.from_numpy(x),
                                                   microbatch=2)
    _check_loss(float(loss), jout, "frozen_loss")
    _check_probed(grads, jout["x"]["frozen"], jout["probe"]["frozen"])
    tx = make_optimizer("sgd", 1e-4)
    opt = pipe.init_opt(tx)
    before = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in pipe.params]
    pipe.apply_grads(tx, opt, grads)
    for m, b in zip(pipe.params, before):
        for k, val in m.state_dict().items():
            if k.endswith((".mean", ".var")):
                assert torch.equal(val, b[k]), k
        assert any(not torch.equal(p, b[k])
                   for k, p in m.named_parameters())


def test_split_detector_train_mode_v4(v4):
    """with_train=True on YOLOv4 (packed=3, the fused routes on the CPU's
    plain versions): a full-microbatch pipeline step equals the port's
    single train step bit for bit (loss, gradients, running statistics)
    and the JAX train-mode step by the probe; merged_variables carries
    the updated statistics."""
    v, (_, x), jout = v4
    single = _port_v4(v, packed=3).train()
    loss_1 = _log1p_loss(single(torch.from_numpy(x)))
    loss_1.backward()
    for n_stages in (2, 3):
        model = _port_v4(v, packed=3)
        stages, params, train_stages = split_yolov4(
            model, n_stages=n_stages, with_train=True)
        pipe = PipelineExecutor(stages, params, devices=["cpu"] * n_stages,
                                train_stages=train_stages)
        loss, grads = pipe.value_and_grad(_log1p_loss)(torch.from_numpy(x))
        assert float(loss) == loss_1.item()
        one = dict(single.named_parameters())
        for g in grads:
            for k, t in g.items():
                assert torch.equal(t, one[k].grad), k
        merged = pipe.merged_variables()
        for k, t in single.state_dict().items():
            assert torch.equal(merged[k], t), k
    _check_loss(float(loss), jout, "train_loss")
    _check_probed(grads, jout["x"]["train"], jout["probe"]["train"])
    leaves = {"batch_stats/" + k.replace(".", "/"): t
              for k, t in merged.items() if k.endswith((".mean", ".var"))}
    assert leaves.keys() == jout["x"]["stats"].keys()
    for k, want in jout["x"]["stats"].items():
        # the batch statistics' reductions in another order: measured
        # by the JAX package's own cut at 2e-6 absolute
        np.testing.assert_allclose(leaves[k].numpy(), want, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


