"""``split_detector`` on every family (tests/test_pipeline.py's
``test_split_detector_all_families``): the backbone | neck + head cut of
YOLOv1, v2, v3 and v3 tiny reproduces the JAX package's eval forward
(weights bridged from its init; held by a probe of the JAX forward, the
input moved by 1e-6), and for v3 tiny and the v2 UNet and MobileNetV2
bodies the pipelined eval forward, the frozen-statistics gradients and
the train-mode step equal the port's single-program model bit for bit
(v1, v2, v3 and YOLOv4 with ResNet-50: tests/test_torch_pipeline_exact.py).
"""

import numpy as np
import pytest
import torch

import jax

from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.helpers_torch import jit_init, numpy_tree
from tf2_yolo_tpu_torch import bridge
from tf2_yolo_tpu_torch import models as tm
from tf2_yolo_tpu_torch.parallel import PipelineExecutor, split_detector

torch.set_num_threads(1)
EPS_PROBE = 1e-6
A5 = np.stack([np.linspace(0.1, 0.8, 5), np.linspace(0.1, 0.7, 5)], axis=1)
A9 = np.stack([np.linspace(0.1, 0.8, 9), np.linspace(0.1, 0.7, 9)], axis=1)
A6 = A9[:6]


def _outs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _loss(out, *_):
    return sum(torch.log1p(o ** 2).mean() for o in _outs(out))


# name -> (JAX module or None, port constructor, input size)
def _cases():
    from tf2_yolo_tpu.models import YoloV1, YoloV2, YoloV3
    return {
        "v1": (YoloV1(bbox_num=2, class_num=2),
               lambda **k: tm.YoloV1(2, 2, **k), 64),
        "v2": (YoloV2(anchors=A5, class_num=2),
               lambda **k: tm.YoloV2(A5, 2, **k), 32),
        "v3": (YoloV3(anchors=A9, class_num=2),
               lambda **k: tm.YoloV3(A9, 2, **k), 32),
        "v3_tiny": (YoloV3(anchors=A6, class_num=2,
                           backbone="tiny_darknet"),
                    lambda **k: tm.YoloV3(A6, 2, backbone="tiny_darknet",
                                          **k), 32),
        "v2_unet": (None, lambda **k: tm.YoloV2(A5, 2, backbone="unet",
                                                **k), 32),
        "v2_mobilenet": (None, lambda **k: tm.YoloV2(
            A5, 2, backbone="mobilenet", **k), 32),
        "v4_resnet50": (None, lambda **k: tm.YoloV4(
            A9, 2, backbone="resnet50", **k), 32),
    }


@pytest.fixture(autouse=True)
def fast_init(monkeypatch):
    """Draw the kernels as a clamped normal: torch's truncated normal
    takes seconds a model on the CPU, and these tests need random
    weights, not the init's distribution."""
    def trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=None):
        with torch.no_grad():
            return t.normal_(mean, std, generator=generator).clamp_(a, b)
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", trunc_normal_)


def _model(ctor, seed=0):
    return ctor(device="cpu", generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("name", ["v1", "v2", "v3", "v3_tiny"])
def test_split_detector_matches_jax_eval(name):
    jm, ctor, size = _cases()[name]
    x = np.random.RandomState(5).rand(2, size, size, 3).astype(np.float32)
    v = numpy_tree(jit_init(jm, x[:1]))
    fwd = jax.jit(lambda xin: jm.apply(v, xin, train=False))
    want = [np.asarray(o) for o in _outs(fwd(x))]
    probe = [np.asarray(o) for o in _outs(fwd(x + EPS_PROBE))]
    model = _model(ctor)
    model.load_state_dict(bridge.from_flax(v), strict=True)
    stages, params = split_detector(model)
    assert all(k.startswith("backbone.") for k in params[0].state_dict())
    assert not any(k.startswith("backbone.")
                   for k in params[1].state_dict())
    pipe = PipelineExecutor(stages, params, devices=["cpu", "cpu"])
    got = _outs(pipe.run(torch.from_numpy(x), microbatch=1))
    assert len(got) == len(want)
    for g, w, p in zip(got, want, probe):
        err = np.abs(g.numpy() - w).max()
        noise = np.abs(p - w).max()
        scale = np.abs(w).max()
        # 8 times the JAX probe's own distance (or 1e-5 of the scale),
        # at most tests/test_pipeline.py's 2e-3 relative
        assert err <= max(8 * noise, 1e-5 * scale), (err, noise, scale)
        assert err <= 2e-3 * scale + 1e-5, (err, scale)


@pytest.mark.parametrize("name", ["v3_tiny", "v2_unet", "v2_mobilenet"])
def test_split_detector_equals_the_whole_model(name):
    """Both BN modes: the cut changes nothing in the port's arithmetic
    (the whole model first, then the pipeline over views of the same
    model from the same state)."""
    _, ctor, size = _cases()[name]
    x = torch.from_numpy(
        np.random.RandomState(6).rand(2, size, size, 3).astype(np.float32))
    model = _model(ctor)
    start = {k: t.clone() for k, t in model.state_dict().items()}
    stages, params, train_stages = split_detector(model, with_train=True)
    pipe = PipelineExecutor(stages, params, devices=["cpu", "cpu"],
                            train_stages=train_stages)
    for train in (False, True):
        model.load_state_dict(start)
        model.zero_grad(set_to_none=True)
        model.train(train)
        out = model(x)
        want = [o.detach() for o in _outs(out)]    # eval: the forward
        loss_1 = _loss(out)
        loss_1.backward()
        grads_1 = {k: p.grad for k, p in model.named_parameters()}
        after = {k: t.clone() for k, t in model.state_dict().items()}
        model.load_state_dict(start)
        if not train:
            for g, w in zip(_outs(pipe.run(x)), want):
                assert torch.equal(g, w)
        loss, grads = pipe.value_and_grad(_loss, train=train)(x)
        assert float(loss) == loss_1.item(), (train, name)
        assert sum(len(g) for g in grads) == len(grads_1)
        for g in grads:
            for k, t in g.items():
                assert torch.equal(t, grads_1[k]), (train, k)
        merged = pipe.merged_variables()
        for k, t in after.items():
            assert torch.equal(merged[k], t), (train, k)
