"""``YoloConfig`` and the class-name assets of the port against the JAX
package's, on the CPU.

- ``YoloConfig``: the JSON text equal to the JAX package's, both ways;
  ``build(device="cpu")`` for versions 1-4 and every backbone the
  facades take; ``build_loss`` equal to the JAX loss on the same
  tensors (1e-6 relative); the v4 facade's refusals;
- ``load_class_names``: the port's copies of the three lists equal to
  the JAX package's.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import helpers_families as fam
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu import assets as jassets
from tf2_yolo_tpu import config as jconfig
from tf2_yolo_tpu import yolov1_5 as jyolov1_5
from tf2_yolo_tpu import yolov2 as jyolov2
from tf2_yolo_tpu import yolov3 as jyolov3
from tf2_yolo_tpu import yolov4 as jyolov4
from tf2_yolo_tpu_torch import assets, config, yolov4
from tf2_yolo_tpu_torch.models import MobileNetV2, ResNet

torch.set_num_threads(1)

NAMES = ["a", "b", "c"]


# ---------------------------------------------------------------- config
def _config_kw():
    return dict(version=3, input_shape=(96, 96, 3), class_names=NAMES,
                anchors=fam.ANCHORS9, backbone="resnet50",
                pretrained_weights=None)


def test_config_json_matches_jax(tmp_path):
    port = config.YoloConfig(**_config_kw(),
                             loss=config.LossConfig(ignore_thresh=0.5),
                             nms=config.NmsConfig(nms_mode=3),
                             train=config.TrainConfig(batch_size=4))
    jax_cfg = jconfig.YoloConfig(**_config_kw(),
                                 loss=jconfig.LossConfig(ignore_thresh=0.5),
                                 nms=jconfig.NmsConfig(nms_mode=3),
                                 train=jconfig.TrainConfig(batch_size=4))
    text = port.to_json(tmp_path / "c.json")
    assert text == jax_cfg.to_json()
    assert (tmp_path / "c.json").read_text() == text
    assert config.YoloConfig.from_json(text) == port
    assert config.YoloConfig.from_json(str(tmp_path / "c.json")) == port
    assert jconfig.YoloConfig.from_json(text) == jax_cfg
    assert config.YoloConfig.from_json(jax_cfg.to_json(indent=None)) == port


# (version, backbone, input size, anchors, the backbone's class)
BUILDS = ([(1, None, 128, None, "DarknetV1")]
          + [(2, b, 64, None, c) for b, c in (
              (None, "Darknet19"), ("darknet", "Darknet19"),
              ("unet", "UNetBody"), ("mobilenet", "MobileNetV2"))]
          + [(3, b, 64, a, c) for b, a, c in (
              ("full_darknet", None, "Darknet53"),
              ("tiny_darknet", fam.ANCHORS6, "TinyDarknet"))]
          + [(v, f"resnet{d}{p}", 64, fam.ANCHORS9, "ResNet")
             for v in (3, 4) for d in (50, 101, 152) for p in ("", "v2")]
          + [(4, "csp_darknet", 64, fam.ANCHORS9, "CSPDarknet53")])


@pytest.mark.parametrize("version,backbone,size,anchors,body", BUILDS,
                         ids=[f"v{v}_{b}" for v, b, *_ in BUILDS])
def test_config_builds_every_backbone(version, backbone, size, anchors,
                                      body):
    if version == 4 and anchors is None:
        anchors = fam.ANCHORS9
    cfg = config.YoloConfig(version=version, input_shape=(size, size, 3),
                            class_names=NAMES, anchors=anchors,
                            backbone=backbone)
    yolo = cfg.build(device="cpu")
    assert yolo.version == version
    module = yolo.model.module
    assert type(module.backbone).__name__ == body
    if body == "ResNet":
        want = dict(depth=int(backbone[6:9].rstrip("v")),
                    preact=backbone.endswith("v2"))
        blocks = sum(len(names) for names in module.backbone.stages)
        assert blocks == {50: 16, 101: 33, 152: 50}[want["depth"]]
        assert module.backbone.preact == want["preact"]
    stride = 64 if version == 1 else 8 if backbone == "unet" else 32
    assert yolo.grid_shape == (size // stride, size // stride)
    assert next(module.parameters()).device.type == "cpu"


def _jax_facade(version, yolo):
    """The JAX facade of ``version`` with the port's built state (grid,
    anchors, levels), without building its model: what ``build_loss``
    reads."""
    mod = {1: jyolov1_5, 2: jyolov2, 3: jyolov3, 4: jyolov4}[version]
    jy = mod.Yolo(input_shape=yolo.input_shape, class_names=NAMES)
    jy.grid_shape = yolo.grid_shape
    if version == 1:
        jy.bbox_num = yolo.bbox_num
    elif version == 4:
        jy.pan_layers = yolo.pan_layers
        jy._model = types.SimpleNamespace(params={
            f"head{i + 1}": {"anchors": jnp.asarray(
                h.anchors.detach().numpy())}
            for i, h in enumerate(yolo._heads())})
    else:
        jy.anchors, jy.abox_num = yolo.anchors, yolo.abox_num
        if version == 3:
            jy.fpn_layers = yolo.fpn_layers
    return jy


@pytest.mark.parametrize("version", [1, 2, 3, 4])
def test_build_loss_matches_jax(version):
    size = 128 if version == 1 else 64
    kw = dict(version=version, input_shape=(size, size, 3),
              class_names=NAMES,
              loss=config.LossConfig(binary_weight=2.0, ignore_thresh=0.5,
                                     label_smooth=0.1, use_scale=False))
    if version == 4:
        kw["anchors"] = fam.ANCHORS9
    cfg = config.YoloConfig(**kw)
    yolo = cfg.build(device="cpu")
    jcfg = jconfig.YoloConfig(**dict(kw, loss=jconfig.LossConfig(
        binary_weight=2.0, ignore_thresh=0.5, label_smooth=0.1,
        use_scale=False)))
    fns = cfg.build_loss(yolo)
    jfns = jcfg.build_loss(_jax_facade(version, yolo))
    fns = fns if isinstance(fns, list) else [fns]
    jfns = jfns if isinstance(jfns, list) else [jfns]
    x = torch.from_numpy(np.random.RandomState(version).rand(
        2, size, size, 3).astype(np.float32))
    with torch.no_grad():
        outs = fam.as_list(yolo.model.module.eval()(x))
    grids = [o.shape[1] for o in outs]
    ys = fam.labels_for(np.random.RandomState(5), version, grids)
    assert len(fns) == len(jfns) == len(outs)
    for fn, jfn, y, o in zip(fns, jfns, ys, outs):
        got = float(fn(torch.from_numpy(y), o))
        want = float(jfn(jnp.asarray(y), jnp.asarray(o.numpy())))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_v4_refuses_as_jax():
    yolo = yolov4.Yolo(input_shape=(64, 64, 3), class_names=NAMES)
    with pytest.raises(ValueError) as got:
        yolo.create_model(anchors=fam.ANCHORS9, backbone="resnet18",
                          pretrained_body=None, device="cpu")
    jy = jyolov4.Yolo(input_shape=(64, 64, 3), class_names=NAMES)
    with pytest.raises(ValueError) as want:
        jy.create_model(anchors=fam.ANCHORS9, backbone="resnet18",
                        pretrained_body=None)
    assert str(got.value) == str(want.value) == "Invalid backbone: resnet18"
    # the fused stages are CSPDarknet-53's
    with pytest.raises(ValueError, match="packed"):
        yolo.create_model(anchors=fam.ANCHORS9, backbone="resnet50",
                          packed=3, pretrained_body=None, device="cpu")
    # a factory must state its taps' channels
    with pytest.raises(ValueError, match="out_channels"):
        yolo.create_model(anchors=fam.ANCHORS9,
                          backbone=lambda **kw: MobileNetV2(**kw),
                          pretrained_body=None, device="cpu")
    m = yolo.create_model(anchors=fam.ANCHORS9,
                          backbone=lambda **kw: ResNet(101, True, **kw),
                          pretrained_body=None, device="cpu")
    assert m.module.backbone.preact and yolo.grid_shape == (2, 2)


# ---------------------------------------------------------------- assets
@pytest.mark.parametrize("name", ["coco", "voc", "imagenet"])
@pytest.mark.parametrize("with_synsets", [False, True])
def test_class_names_match_jax(name, with_synsets):
    got = assets.load_class_names(name, with_synsets=with_synsets)
    assert got == jassets.load_class_names(name, with_synsets=with_synsets)
    assert len(got) == {"coco": 80, "voc": 20, "imagenet": 1000}[name]


def test_class_names_from_a_path(tmp_path):
    path = tmp_path / "names.txt"
    path.write_text("tv,monitor\n\nn01440764,tench\nperson\n")
    for synsets in (False, True):
        assert assets.load_class_names(str(path), synsets) \
            == jassets.load_class_names(str(path), synsets)
