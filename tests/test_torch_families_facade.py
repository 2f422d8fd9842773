"""The port's YOLOv1.5, v2 and v3 facades against the JAX package's, in
f32 on the CPU, on bridged weights: ``create_model`` (the output
shapes, the grid, the anchors per level, the variable tree), the loss
and metric closures on the same outputs, one epoch of ``fit`` (one step
of 4 images: its logs, from the forward before the update) and
``predict`` on the starting weights; then ``fit`` and ``predict`` of the
tiny and UNet variants, and ``make_version_aliases(1..3)``.

v1.5 at 128^2, v2 at 64^2, v3 at 96^2, 3 classes; this file holds v3
and the surface shared by the three (``tests/test_torch_families_
facade_v12.py`` holds v1.5 and v2 with the same checks). A facade
builds its model with BatchNorm statistics at their init values (mean 0,
variance 1), as the JAX facade does; before anything runs they are
calibrated on the images (the networks' recipe), and that tree goes to
both sides.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from tests import helpers_families as fam
from tests.helpers_data import make_dataset
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.helpers_torch import flat, numpy_tree
from tf2_yolo_tpu import facade_base as jfacade_base
from tf2_yolo_tpu import yolov1_5 as jyolov1_5
from tf2_yolo_tpu import yolov2 as jyolov2
from tf2_yolo_tpu import yolov3 as jyolov3
from tf2_yolo_tpu_torch import bridge, facade_base, yolov1_5, yolov2, yolov3
from tf2_yolo_tpu_torch.models import ResNet

torch.set_num_threads(1)

NAMES = ["square", "bar", "tall"]
SPEC = "obj+iou+class+recall0.6"
LR = 1e-3
ANCHORS6 = [[0.05 + 0.1 * i, 0.07 + 0.09 * i] for i in range(6)]
# name: (JAX facade module, port facade module, size, create_model
# keyword arguments, loss keyword arguments)
FACADES = {
    "v1_5": (jyolov1_5, yolov1_5, 128, {}, dict(binary_weight=0.5)),
    "v2": (jyolov2, yolov2, 64, {}, {}),
    "v3": (jyolov3, yolov3, 96, dict(pretrained_body=None), {}),
}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    return {size: make_dataset(str(tmp_path_factory.mktemp(f"fam{size}")),
                               n_images=4, size=(size, size),
                               class_names=NAMES, seed=size)
            for size in (64, 96, 128)}


def _as_list(outs):
    return list(outs) if isinstance(outs, (list, tuple)) else [outs]


@functools.lru_cache(maxsize=None)
def _jax_run(name, data):
    """The JAX facade: create_model, readers, predict on the starting
    weights, then compile and one epoch of fit."""
    jmod, _, size, create_kw, loss_kw = FACADES[name]
    yolo = jmod.Yolo(input_shape=(size, size, 3), class_names=NAMES)
    m = yolo.create_model(**create_kw)
    img, labels = yolo.read_file_to_dataset(*data, seed=0)
    # BN statistics calibrated on the images (tests/helpers_families.py):
    # at their init values the heads saturate and every difference of
    # rounding grows without bound
    port = FACADES[name][1].Yolo(input_shape=(size, size, 3),
                                 class_names=NAMES).create_model(
        device="cpu", **create_kw)
    port.set_variables(bridge.from_flax(numpy_tree(m.variables)))
    fam._calibrate_bn(port.module, torch.from_numpy(img))
    start = {k: v.clone() for k, v in port.module.state_dict().items()}
    m.set_variables(bridge.to_flax(start))
    pred = [np.asarray(p) for p in _as_list(m.predict(img))]
    m.compile("adam", loss=yolo.loss(**loss_kw), metrics=yolo.metrics(SPEC),
              learning_rate=LR)
    hist = m.fit(img, labels, epochs=1, batch_size=4, seed=1, verbose=0)
    out = dict(yolo=yolo, start=start, img=img, labels=labels, pred=pred,
               hist=hist, shapes=m.output_shapes,
               leaves=set(flat(numpy_tree(m.variables["params"]),
                               "params/")))
    jax.clear_caches()
    return out


@pytest.fixture(scope="module", params=["v3"])
def pair(request, datasets):
    name = request.param
    run = _jax_run(name, datasets[FACADES[name][2]])
    yield name, run
    _jax_run.cache_clear()


def _port(name, run, **kw):
    _, tmod, size, create_kw, loss_kw = FACADES[name]
    yolo = tmod.Yolo(input_shape=(size, size, 3), class_names=NAMES)
    m = yolo.create_model(device="cpu", **create_kw, **kw)
    m.set_variables(run["start"])
    m.compile("adam", loss=yolo.loss(**loss_kw), metrics=yolo.metrics(SPEC),
              learning_rate=LR)
    return yolo, m


def test_create_model_matches_jax(pair):
    name, run = pair
    yolo, m = _port(name, run)
    jyolo = run["yolo"]
    assert m.output_shapes == run["shapes"]
    assert yolo.grid_shape == jyolo.grid_shape
    assert yolo._bbox_num == jyolo._bbox_num
    assert {"params/" + k.replace(".", "/")
            for k, _ in m.module.named_parameters()} == run["leaves"]
    if name == "v3":
        assert yolo.fpn_layers == jyolo.fpn_layers == 3
        assert np.allclose(yolo.anchors, jyolo.anchors)


def test_readers_loss_and_metrics_match_jax(pair, datasets):
    name, run = pair
    yolo, _ = _port(name, run)
    img, labels = yolo.read_file_to_dataset(
        *datasets[FACADES[name][2]], seed=0)
    assert np.array_equal(img, run["img"])
    for got, want in zip(_as_list(labels), _as_list(run["labels"])):
        assert np.array_equal(got, want)
    jyolo = run["yolo"]
    loss_kw = FACADES[name][4]
    jl, tl = (_as_list(y.loss(**loss_kw)) for y in (jyolo, yolo))
    jm, tm = jyolo.metrics(SPEC), yolo.metrics(SPEC)
    if len(tl) == 1:
        jm, tm = [jm], [tm]
    worst = 0.0
    for level, (y, out) in enumerate(zip(_as_list(run["labels"]),
                                         run["pred"])):
        pairs = [(jl[level], tl[level])] + list(zip(jm[level], tm[level]))
        for jf, tf in pairs:
            got = float(tf(torch.from_numpy(y), torch.from_numpy(out)))
            want = float(jf(y, out))
            worst = max(worst, abs(got - want) / max(abs(want), 1e-30))
    # f32 sums in another order
    assert worst <= 1e-5, worst


def test_predict_and_first_epoch_match_jax(pair):
    name, run = pair
    yolo, m = _port(name, run)
    img = run["img"]
    pred = [p.numpy() if torch.is_tensor(p) else np.asarray(p)
            for p in _as_list(m.predict(img))]
    probe = [np.asarray(p) for p in _as_list(m.predict(
        np.nextafter(np.float32(img), np.float32(2))))]
    for got, want, p in zip(pred, run["pred"], probe):
        # 4 times the port's floor, as tests/helpers_families.py holds
        # the networks
        assert got.shape == want.shape and np.isfinite(got).all()
        err = np.abs(got - want).max()
        assert err <= 4 * np.abs(p - got).max() + 1e-6, (name, err)
    hist = m.fit(img, run["labels"], epochs=1, batch_size=4, seed=1,
                 verbose=0)
    want = run["hist"]
    keys = [k for k in want if k != "epoch_time"]
    assert sorted(keys) == sorted(k for k in hist if k != "epoch_time")
    for k in keys:
        # the first step's logs, before the update: the loss of a
        # train-mode forward over the whole net (mean_iou reads the
        # untrained net's boxes, as tests/test_torch_facade.py holds it)
        rtol = 1e-3 if k.endswith("mean_iou") else 1e-4
        np.testing.assert_allclose(hist[k], want[k], rtol=rtol, atol=1e-6,
                                   err_msg=f"{name} {k}")
    after = _as_list(m.predict(img))
    assert all(np.isfinite(np.asarray(a)).all() for a in after)


@pytest.mark.parametrize("name,backbone,size,anchors", [
    ("v3", "tiny_darknet", 96, ANCHORS6)])
def test_other_backbones_fit_and_predict(name, backbone, size, anchors,
                                         datasets):
    tmod = FACADES[name][1]
    yolo = tmod.Yolo(input_shape=(size, size, 3), class_names=NAMES)
    kw = dict(anchors=anchors) if anchors else {}
    m = yolo.create_model(backbone=backbone, device="cpu", seed=3,
                          **({"pretrained_body": None} if name == "v3"
                             else {}), **kw)
    img, labels = yolo.read_file_to_dataset(*datasets[size], seed=0)
    m.compile("adam", loss=yolo.loss(), metrics=yolo.metrics("obj"),
              learning_rate=LR)
    before = {k: v.clone() for k, v in m.module.state_dict().items()}
    hist = m.fit(img, labels, epochs=1, batch_size=4, verbose=0)
    assert np.isfinite(hist["loss"]).all()
    assert any(not torch.equal(before[k], v)
               for k, v in m.module.state_dict().items())
    shapes = m.output_shapes if name == "v3" else [m.output_shapes]
    pred = _as_list(m.predict(img))
    assert [tuple(p.shape) for p in pred] == [(4, *s[1:]) for s in shapes]
    if name == "v3":
        assert yolo.fpn_layers == 2 and yolo.abox_num == 3


@pytest.mark.parametrize("version", [1, 2, 3])
def test_version_aliases_match_jax(version):
    got = facade_base.make_version_aliases(version)
    want = jfacade_base.make_version_aliases(version)
    assert got.keys() == want.keys()
    assert got["wrap_yolo_loss"].__name__ == want["wrap_yolo_loss"].__name__
    mod = {1: yolov1_5, 2: yolov2, 3: yolov3}[version]
    assert mod.wrap_yolo_loss is got["wrap_yolo_loss"]
    assert mod.wrap_obj_acc.keywords == {"version": version}


@pytest.mark.parametrize("call,body,levels", [
    (lambda: yolov3.Yolo((64, 64, 3), NAMES).create_model(
        backbone="resnet50", pretrained_body=None, device="cpu"),
     "ResNet", 3),
    (lambda: yolov3.Yolo((64, 64, 3), NAMES).create_model(
        backbone=lambda **kw: ResNet(depth=50, **kw), pretrained_body=None,
        device="cpu"), "ResNet", 3),
    (lambda: yolov2.Yolo((64, 64, 3), NAMES).create_model(
        backbone="mobilenet", device="cpu"), "MobileNetV2", 1),
], ids=["v3_resnet", "v3_callable", "v2_mobilenet"])
def test_unported_backbones_raise(call, body, levels):
    """These backbones raised NotImplementedError until the ResNets,
    MobileNetV2 and backbone factories were ported: now each builds, and
    its outputs have the facade's grids (input / 32, then / 16, / 8)."""
    model = call()
    assert type(model.module.backbone).__name__ == body
    shapes = model.output_shapes if levels > 1 else [model.output_shapes]
    assert [s[1] for s in shapes] == [2, 4, 8][:levels]


def test_invalid_backbones_raise():
    with pytest.raises(ValueError, match="Invalid backbone"):
        yolov3.Yolo((96, 96, 3), NAMES).create_model(backbone="x",
                                                      device="cpu")
    with pytest.raises(ValueError, match="Invalid backbone"):
        yolov2.Yolo((64, 64, 3), NAMES).create_model(backbone="x",
                                                      device="cpu")
