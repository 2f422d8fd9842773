"""The port's YOLOv4 facade (``tf2_yolo_tpu_torch.yolov4.Yolo``) against
the JAX package's at 64², 3 classes, 6 images, in f32 on the CPU, on
bridged weights: the readers' label pyramids, the loss and metric
closures on the same outputs, and one epoch of ``fit`` (one step of all
six images). The first step's logs are compared sharply; the parameters
after it by the probe: the untrained YOLOv4's gradients are chaotic
(ROADMAP parity rules), and Adam's first update is lr * g / (|g| + 1e-7),
the sign of g, so the port is held to the JAX package by a multiple of
its own distance from a run on x + 1e-6."""

import inspect
import os

import numpy as np
import pytest
import torch

import jax

from tests.helpers_convert import remove_files_after_test  # noqa: F401
from tests.helpers_data import make_dataset
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.helpers_torch import flat, numpy_tree
from tf2_yolo_tpu import yolov4 as jyolov4
from tf2_yolo_tpu_torch import bridge, facade_base, yolov4

torch.set_num_threads(1)

SIZE = 64
NAMES = ["square", "bar", "tall"]
ANCHORS = [[0.05 + 0.08 * i, 0.07 + 0.07 * i] for i in range(9)]
SPEC = "obj+iou+class+recall0.6"
LR = 1e-3
EPS_PROBE = 1e-6


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("facade")), n_images=6,
                        size=(SIZE, SIZE), class_names=NAMES, seed=4)


def _facades():
    return (jyolov4.Yolo(input_shape=(SIZE, SIZE, 3), class_names=NAMES),
            yolov4.Yolo(input_shape=(SIZE, SIZE, 3), class_names=NAMES))


@pytest.fixture(scope="module")
def jax_run(dataset):
    """The JAX facade's one compile: create_model, one epoch of fit."""
    jyolo, _ = _facades()
    m = jyolo.create_model(anchors=ANCHORS, pretrained_body=None)
    start = bridge.from_flax(numpy_tree(m.variables))
    img, labels = jyolo.read_file_to_dataset(*dataset, seed=0)
    m.compile("adam", loss=jyolo.loss(), metrics=jyolo.metrics(SPEC),
              learning_rate=LR)
    hist = m.fit(img, labels, epochs=1, batch_size=6, seed=1, verbose=0)
    out = dict(start=start, hist=hist, img=img, labels=labels,
               anchors=jyolo.anchors, facade=jyolo,
               params=flat(numpy_tree(m.params), "params/"))
    jax.clear_caches()
    return out


def _port_model(yolo, start, **kw):
    m = yolo.create_model(anchors=ANCHORS, pretrained_body=None,
                          device="cpu", **kw)
    m.set_variables(start)
    m.compile("adam", loss=yolo.loss(), metrics=yolo.metrics(SPEC),
              learning_rate=LR)
    return m


def test_readers_equal(dataset):
    jyolo, tyolo = _facades()
    jimg, jlabels = jyolo.read_file_to_dataset(*dataset, seed=2)
    timg, tlabels = tyolo.read_file_to_dataset(*dataset, seed=2)
    assert np.array_equal(timg, jimg)
    assert [t.shape for t in tlabels] == [(6, 2, 2, 8), (6, 4, 4, 8),
                                          (6, 8, 8, 8)]
    assert all(np.array_equal(t, j) for t, j in zip(tlabels, jlabels))
    assert tyolo.file_names == jyolo.file_names
    jseq = jyolo.read_file_to_sequence(*dataset, batch_size=4, seed=3,
                                       uint8=True)
    tseq = tyolo.read_file_to_sequence(*dataset, batch_size=4, seed=3,
                                       uint8=True)
    assert len(tseq) == len(jseq) == 2 and tseq.uint8
    for (ji, jl), (ti, tl) in zip(jseq.as_iterator(), tseq.as_iterator()):
        assert ti.dtype == np.uint8 and np.array_equal(ti, ji)
        assert all(np.array_equal(t, j) for t, j in zip(tl, jl))


def test_loss_and_metric_closures_equal(jax_run):
    """The closures on the same outputs and labels: outputs drawn as the
    head makes them (xy, conf, probs in (0, 1), wh positive)."""
    jyolo = jax_run["facade"]
    tyolo = yolov4.Yolo(input_shape=(SIZE, SIZE, 3), class_names=NAMES)
    _port_model(tyolo, jax_run["start"])
    rng = np.random.RandomState(6)
    jl, tl = jyolo.loss(), tyolo.loss()
    jm, tm = jyolo.metrics(SPEC), tyolo.metrics(SPEC)
    assert [[f.__name__ for f in lv] for lv in tm] == \
        [["obj_acc", "mean_iou", "class_acc", "recall"]] * 3
    worst = 0.0
    for level, y in enumerate(jax_run["labels"]):
        out = rng.rand(*y.shape[:3], 24).astype(np.float32)
        out.reshape(*y.shape[:3], 3, 8)[..., 4] **= 4    # mostly low conf
        got = float(tl[level](torch.from_numpy(y), torch.from_numpy(out)))
        want = float(jl[level](y, out))
        worst = max(worst, abs(got - want) / abs(want))
        for jf, tf in zip(jm[level], tm[level]):
            got = float(tf(torch.from_numpy(y), torch.from_numpy(out)))
            want = float(jf(y, out))
            worst = max(worst, abs(got - want) / max(abs(want), 1e-30))
    # measured: largest relative difference 1.2e-7 (f32 sums)
    assert worst <= 1e-6, worst


def test_first_epoch_matches_jax_by_the_probe(jax_run):
    tyolo = yolov4.Yolo(input_shape=(SIZE, SIZE, 3), class_names=NAMES)
    img, labels = jax_run["img"], jax_run["labels"]
    runs = {}
    for name, x in (("port", img), ("probe", img + EPS_PROBE)):
        m = _port_model(tyolo, jax_run["start"])
        hist = m.fit(x, labels, epochs=1, batch_size=6, seed=1, verbose=0)
        runs[name] = hist, {k: v.detach().numpy() for k, v in
                            bridge.flax_leaves(m.module).items()
                            if k.startswith("params/")}
    hist, got = runs["port"]
    want = jax_run["hist"]
    keys = [k for k in want if k != "epoch_time"]
    assert sorted(keys) == sorted(k for k in hist if k != "epoch_time")
    assert len(keys) == 13                    # loss + 4 metrics x 3 levels
    for k in keys:
        # The first step's logs, before any update, against JAX on the
        # eight CPU devices that tests/conftest.py pins: the loss within
        # 1e-4 (measured 3.3e-6), obj_acc, class_acc and recall equal.
        # mean_iou reads the predicted boxes of the untrained net, whose
        # train-mode forward amplifies rounding: on these flat-background
        # images the BatchNorm variances cancel (E[x^2] - E[x]^2 of
        # near-constant channels). Measured: out1 1.03e-4 (its 2x2 grid
        # averages the fewest boxes), out2 1.9e-5, out3 1.1e-5; held at
        # 1e-3.
        rtol = 1e-3 if k.endswith("mean_iou") else 1e-4
        np.testing.assert_allclose(hist[k], want[k], rtol=rtol, atol=1e-6,
                                   err_msg=k)
    ref, probe = jax_run["params"], runs["probe"][1]
    assert set(got) == set(ref)
    apart = noise = 0.0
    for name, leaf in ref.items():
        # Adam's first update is about lr a leaf element: where a gradient
        # element lies within the noise of 0 the two sides step apart
        assert np.abs(got[name] - leaf).max() <= 2.05 * LR, name
        apart += float(np.sum((got[name] - leaf) ** 2))
        noise += float(np.sum((probe[name] - got[name]) ** 2))
    # measured: distance to JAX 2.12, to the probe 1.69 (ratio 1.26;
    # 2.12 against JAX on one device)
    assert apart ** 0.5 <= 2 * noise ** 0.5, (apart, noise)


def test_anchors(jax_run):
    tyolo = yolov4.Yolo(input_shape=(SIZE, SIZE, 3), class_names=NAMES)
    with pytest.raises(ValueError, match="create_model"):
        tyolo.model
    with pytest.raises(ValueError, match="read files"):
        tyolo.file_names
    m = _port_model(tyolo, jax_run["start"])
    assert np.array_equal(np.float32(tyolo.anchors),
                          np.float32(jax_run["anchors"]))
    img, labels = jax_run["img"], jax_run["labels"]
    before = [h.anchors.detach().clone() for h in tyolo._heads()]
    m.fit(img[:2], [y[:2] for y in labels], epochs=1, batch_size=2,
          verbose=0)
    # not trainable (the default): bit-identical after an update
    assert all(torch.equal(b, h.anchors)
               for b, h in zip(before, tyolo._heads()))
    tyolo.anchors_trainable = True
    m.compile("adam", loss=tyolo.loss(), learning_rate=LR)
    m.fit(img[:2], [y[:2] for y in labels], epochs=1, batch_size=2,
          verbose=0)
    assert not any(torch.equal(b, h.anchors)
                   for b, h in zip(before, tyolo._heads()))
    tyolo.anchors = ANCHORS
    tyolo.reshape_anchors((128, 96))
    want = np.float32(ANCHORS) * np.float32([2.0, 1.5])
    assert np.array_equal(np.float32(tyolo.anchors), want)


def _export_model_to_a_tpu(y):
    """``export_model`` is ported (tests/test_torch_export.py); what it
    refuses is the JAX package's lowering list."""
    y.create_model(anchors=ANCHORS, pretrained_body=None, device="cpu")
    y.export_model("x", platforms=("tpu",))


@pytest.mark.parametrize("call, exc, match", [
    # ported since: builds (exc None), the ResNet-50 under the v4 neck
    (lambda y: y.create_model(anchors=ANCHORS, backbone="resnet50",
                              pretrained_body=None, device="cpu"),
     None, "ResNet"),
    (_export_model_to_a_tpu, ValueError, "platforms"),
    # ported since (tests/test_torch_convert.py, test_torch_native.py):
    # each reaches the error of its own arguments
    (lambda y: y.export_reference_h5("x"), ValueError, "create_model"),
    (lambda y: facade_base.graft_backbone_file(None, "x"),
     FileNotFoundError, "x"),
    (lambda y: y.read_file_to_sequence("a", "b", reader="native"),
     FileNotFoundError, "'a'"),
], ids=["backbone", "export_model", "export_reference_h5",
        "graft_backbone_file", "native_reader"])
def test_unported_options_raise(call, exc, match):
    yolo = yolov4.Yolo(input_shape=(SIZE, SIZE, 3), class_names=NAMES)
    if exc is None:
        assert type(call(yolo).module.backbone).__name__ == match
        assert yolo.grid_shape == (SIZE // 32, SIZE // 32)
        return
    with pytest.raises(exc, match=match):
        call(yolo)


def test_pretrained_and_defaults(jax_run, tmp_path, monkeypatch):
    assert inspect.signature(
        yolov4.Yolo.create_model).parameters["device"].default == "cuda"
    monkeypatch.setenv("TF2_YOLO_TPU_TORCH_WEIGHTS", str(tmp_path))
    with pytest.warns(UserWarning, match="random initialization"):
        assert facade_base.resolve_pretrained("ms_coco", "yolov4") is None
    # a save_weights file of the port is what create_model loads
    a = yolov4.Yolo(input_shape=(SIZE, SIZE, 3), class_names=NAMES)
    _port_model(a, jax_run["start"]).save_weights(
        os.path.join(str(tmp_path), "yolov4_mine.pt"))
    b = yolov4.Yolo(input_shape=(SIZE, SIZE, 3), class_names=NAMES)
    mb = b.create_model(pretrained_weights="mine", device="cpu")
    # its anchors too: no `anchors` argument, so not the placeholder ones
    for k, v in mb.variables.items():
        assert torch.equal(v, jax_run["start"][k]), k
    # a Model as pretrained_body: its backbone only
    c = yolov4.Yolo(input_shape=(SIZE, SIZE, 3), class_names=NAMES)
    mc = c.create_model(anchors=ANCHORS, pretrained_body=mb, seed=7,
                        device="cpu")
    for k, v in mc.variables.items():
        if k.startswith("backbone."):
            assert torch.equal(v, mb.variables[k]), k
        elif k.endswith("kernel"):           # drawn from seed 7
            assert not torch.equal(v, mb.variables[k]), k
