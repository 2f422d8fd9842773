"""The classifier functions of the port against the JAX package's, on
the CPU.

- ``Classifier``: every leaf against the JAX init's, and its forward
  (DarkNet-19's 1x1 conv head at 64^2, DarkNet-v1's Dense head at 128^2,
  BN set to the batch statistics of what it normalises) within 4 times
  the port's own floor, its output moved by one f32 ulp of the input;
- the four functions (``darknet``, ``darknet19``, ``darknet53``,
  ``csp_darknet53``, with and without the top), their ``ValueError``s
  (the JAX messages), and a named weight set with no file: a warning and
  the random init.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import helpers_families as fam
from tests.helpers_torch import flat, numpy_tree
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu.models import backbones as jbackbones
from tf2_yolo_tpu.models import classifiers as jclassifiers
from tf2_yolo_tpu_torch import bridge
from tf2_yolo_tpu_torch.models import Classifier, classifiers
from tf2_yolo_tpu_torch.models import backbones

torch.set_num_threads(1)


# ---------------------------------------------------------------- Classifier
@functools.lru_cache(maxsize=None)
def _classifier_pair(kind):
    size, jbody, tbody, conv_head = {
        "darknet19": (64, jbackbones.Darknet19, backbones.Darknet19, True),
        "darknet": (128, jbackbones.DarknetV1, backbones.DarknetV1, False),
    }[kind]
    x = np.random.RandomState(3).rand(2, size, size, 3).astype(np.float32)
    jm = jbackbones.Classifier(backbone=jbody(), class_num=10,
                               conv_head=conv_head)
    init = numpy_tree(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x[:1])))
    model = Classifier(tbody(device="cpu"), 10, conv_head, device="cpu")
    model.load_state_dict(bridge.from_flax(init), strict=True)
    fam._calibrate_bn(model, torch.from_numpy(x))
    return x, jm, init, model


@pytest.mark.parametrize("kind", ["darknet19", "darknet"])
def test_classifier_matches_jax(kind):
    x, jm, init, model = _classifier_pair(kind)
    want = {**flat(init["params"], "params/"),
            **flat(init["batch_stats"], "batch_stats/")}
    got = bridge.flax_leaves(model)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
    variables = bridge.to_flax(model.state_dict())
    jout = np.asarray(jax.jit(functools.partial(jm.apply, train=False))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x)).numpy()
        probe = model(torch.from_numpy(np.nextafter(
            x, np.float32(2)))).numpy()
    assert out.shape == jout.shape == (2, 10)
    np.testing.assert_allclose(out.sum(-1), 1, rtol=1e-5)
    err = np.abs(out - jout).max()
    assert err <= 4 * np.abs(probe - out).max() + 1e-6, err


@pytest.mark.parametrize("fn_name,kw,head,shape", [
    ("darknet", dict(input_shape=(128, 128, 3)), "Dense_0", (1, 10)),
    ("darknet19", dict(input_shape=(64, 64, 3)), "ConvBN_0", (1, 10)),
    ("darknet53", dict(weights=None, input_shape=(64, 64, 3), class_num=5),
     "Dense_0", (1, 5)),
    ("darknet53", dict(include_top=False, weights=None,
                       input_shape=(64, 64, 3)), None, (1, 2, 2, 1024)),
    ("csp_darknet53", dict(weights=None, input_shape=(64, 64, 3),
                           class_num=5), "Dense_0", (1, 5)),
    ("csp_darknet53", dict(include_top=False, weights=None,
                           input_shape=(64, 64, 3)), None, (1, 2, 2, 1024)),
], ids=["darknet", "darknet19", "darknet53", "darknet53_notop",
        "csp_darknet53", "csp_darknet53_notop"])
def test_classifier_functions(fn_name, kw, head, shape):
    model = getattr(classifiers, fn_name)(device="cpu", **kw)
    assert tuple(model.output_shapes) == shape
    if head is None:
        assert type(model.module).__name__ == "_FeatureOnly"
    else:
        assert hasattr(model.module, head)
    x = torch.rand(2, *model.input_shape)
    with torch.no_grad():
        out = model.module.eval()(x)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("fn_name", ["darknet53", "csp_darknet53"])
@pytest.mark.parametrize("kw", [
    dict(input_shape=(65, 64, 3)), dict(input_shape=(64, 64, 1)),
    dict(input_shape=(64, 64, 3), class_num=10)],
    ids=["odd_size", "one_channel", "class_num"])
def test_classifier_functions_refuse_imagenet_shapes_as_jax(fn_name, kw):
    kw = dict(dict(class_num=1000), **kw)
    with pytest.raises(ValueError) as want:
        getattr(jclassifiers, fn_name)(weights="imagenet", **kw)
    with pytest.raises(ValueError) as got:
        getattr(classifiers, fn_name)(weights="imagenet", device="cpu",
                                      **kw)
    assert str(got.value) == str(want.value)


def test_named_weights_without_a_file_warn(tmp_path, monkeypatch):
    monkeypatch.setenv("TF2_YOLO_TPU_TORCH_WEIGHTS", str(tmp_path))
    with pytest.warns(UserWarning, match="imagenet"):
        model = classifiers.csp_darknet53(input_shape=(64, 64, 3),
                                          device="cpu")
    again = classifiers.csp_darknet53(weights=None, input_shape=(64, 64, 3),
                                      device="cpu")
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, again.module.state_dict()[k]), k
