"""The reference-weight converter of the port (``convert.py``) against the
JAX package's, on the CPU: the darknet families (YOLOv4, YOLOv3 full and
tiny, YOLOv2 with DarkNet-19 and with the UNet, YOLOv1.5) through
``tests/helpers_convert.py``'s checks (h5 file -> state_dict bit for
bit, a served forward within the parity bounds, the export bit for bit),
and the converter's API: strict mode, the shape check of
``merge_into_variables``, ``convert_to_cache`` -> ``resolve_pretrained``
under ``TF2_YOLO_TPU_TORCH_WEIGHTS``, ``graft_backbone_file`` and
``YoloBase.export_reference_h5``.
"""

import numpy as np
import pytest
import torch

from tests import helpers_convert as hc
from tests import helpers_families as fam
from tests.helpers_convert import remove_files_after_test  # noqa: F401
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu import convert as jconvert
from tf2_yolo_tpu_torch import bridge, convert, facade_base, yolov1_5
from tf2_yolo_tpu_torch import yolov2, yolov4
from tf2_yolo_tpu_torch.models import YoloV4

torch.set_num_threads(1)

DARKNET_FAMILIES = ["v4", "v3_full", "v3_tiny", "v2_darknet", "v2_unet",
                    "v1"]


@pytest.mark.parametrize("name", DARKNET_FAMILIES)
def test_family_round_trip(name, tmp_path):
    hc.check_family(fam.built(name), tmp_path)


def _v4_weights():
    """The reference layers of the calibrated small YOLOv4."""
    return jconvert.export_reference_weights(fam.built("v4")["variables"],
                                             4, fam.CLASSES)


def test_strict_mode_and_shape_check():
    h5w = _v4_weights()
    del h5w["stage3_block2_3x3_conv"]
    with pytest.raises(KeyError, match="stage3_block2_3x3_conv"):
        convert.convert_yolov4(h5w, fam.CLASSES)
    params, stats = convert.convert_yolov4(h5w, fam.CLASSES, strict=False)
    assert "expand" not in params["backbone"]["stage3"]["block2"]
    assert "conv" in params["backbone"]["stage3"]["block2"]["squeeze"]
    # the JAX package agrees on what a non-strict conversion keeps
    jparams, jstats = jconvert.convert_yolov4(h5w, fam.CLASSES,
                                              strict=False)
    assert bridge.from_flax({"params": params, "batch_stats": stats}) \
        .keys() == bridge.from_flax({"params": jparams,
                                     "batch_stats": jstats}).keys()

    state = YoloV4(fam.ANCHORS9, fam.CLASSES, device="cpu").state_dict()
    h5w = _v4_weights()
    h5w["pan_td1_2_conv"]["kernel"] = h5w["pan_td1_2_conv"]["kernel"][
        ..., :-1]
    with pytest.raises(ValueError, match="shape mismatch at "
                                         "params/td1_pre2/conv/kernel"):
        convert.merge_into_variables(state, *convert.convert_yolov4(
            h5w, fam.CLASSES))
    # a tree works as the JAX package's does, and returns a tree
    tree = convert.merge_into_variables(
        bridge.to_flax(state), *convert.convert_yolov4(_v4_weights(),
                                                       fam.CLASSES))
    assert set(tree) == {"params", "batch_stats"}
    with pytest.raises(KeyError, match="no module"):
        convert.merge_into_variables(state, {"nowhere": {"a": 1}}, {})


def test_convert_to_cache_and_resolve(tmp_path, monkeypatch):
    monkeypatch.setenv("TF2_YOLO_TPU_TORCH_WEIGHTS", str(tmp_path / "c"))
    f = fam.built("v4")
    h5 = str(tmp_path / "ms_coco_small.h5")
    jconvert.export_reference_h5(f["variables"], 4, fam.CLASSES, h5)
    out = convert.convert_to_cache(h5, 4, fam.CLASSES, name="small")
    assert out == str(tmp_path / "c" / "yolov4_small.pt")
    assert facade_base.resolve_pretrained("small", "yolov4") == out
    # the facade loads it by name: the converted weights, anchors too
    yolo = yolov4.Yolo(input_shape=(64, 64, 3),
                       class_names=["a", "b", "c"])
    m = yolo.create_model(anchors=fam.ANCHORS9, pretrained_body=None,
                          pretrained_weights="small", device="cpu")
    assert hc.state_equal(m.variables,
                          bridge.from_flax(f["variables"])) == []
    # both files hold a full-width YOLOv4: drop them before writing more
    (tmp_path / "ms_coco_small.h5").unlink()
    (tmp_path / "c" / "yolov4_small.pt").unlink()

    # a body-only file: a warning with counts; the heads stay the
    # template's
    body = {k: v for k, v in jconvert.export_reference_weights(
        f["variables"], 4, fam.CLASSES).items()
        if not k.startswith("out")}
    jconvert.save_reference_h5(body, str(tmp_path / "body.h5"))
    with pytest.warns(UserWarning, match="body-only"):
        convert.convert_to_cache(str(tmp_path / "body.h5"), 4,
                                 fam.CLASSES)
    # nothing matched: no file of random weights
    jconvert.save_reference_h5({"foo_conv": {"kernel": np.ones(3)}},
                               str(tmp_path / "foreign.h5"))
    with pytest.raises(ValueError, match="no layer"):
        convert.convert_to_cache(str(tmp_path / "foreign.h5"), 4,
                                 fam.CLASSES)


def test_graft_backbone_file(tmp_path, monkeypatch):
    f = fam.built("v2_darknet")
    src = tmp_path / "full.pt"
    torch.save(bridge.from_flax(f["variables"]), src)
    yolo = yolov2.Yolo(input_shape=(64, 64, 3), class_names=["a", "b", "c"])
    m = yolo.create_model(anchors=fam.ANCHORS5, seed=3, device="cpu")
    before = {k: v.clone() for k, v in m.variables.items()}
    facade_base.graft_backbone_file(m, str(src))
    want = bridge.from_flax(f["variables"])
    for k, v in m.variables.items():
        expect = want[k] if k.startswith("backbone.") else before[k]
        assert torch.equal(v, expect), k
    # a bare backbone's file, and through the facade by name
    monkeypatch.setenv("TF2_YOLO_TPU_TORCH_WEIGHTS", str(tmp_path))
    torch.save({k[len("backbone."):]: v for k, v in want.items()
                if k.startswith("backbone.")},
               tmp_path / "darknet_backbone_imagenet.pt")
    m2 = yolo.create_model(anchors=fam.ANCHORS5, seed=3, device="cpu",
                           pretrained_backbone="imagenet")
    assert hc.state_equal(
        m2.variables, {k: (want[k] if k.startswith("backbone.")
                           else before[k]) for k in before}) == []
    # a backbone of other shapes is refused
    bad = {k: v for k, v in want.items() if k.startswith("backbone.")}
    key = "backbone.ConvBN_0.conv.kernel"
    bad[key] = bad[key][..., :-1]
    torch.save(bad, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="shape mismatch"):
        facade_base.graft_backbone_file(m, str(tmp_path / "bad.pt"))


@pytest.mark.parametrize("name", ["v1", "v4"])
def test_facade_export_reference_h5(name, tmp_path):
    f = fam.built(name)
    if name == "v1":
        yolo = yolov1_5.Yolo(input_shape=(128, 128, 3),
                             class_names=["a", "b", "c"])
        m = yolo.create_model(device="cpu")
    else:
        yolo = yolov4.Yolo(input_shape=(64, 64, 3),
                           class_names=["a", "b", "c"])
        m = yolo.create_model(anchors=fam.ANCHORS9, pretrained_body=None,
                              device="cpu")
    m.set_variables(bridge.from_flax(f["variables"]))
    path = str(tmp_path / "ref.h5")
    written = yolo.export_reference_h5(path)
    # the JAX package reads back what the port wrote, bit for bit, and
    # the JAX exporter writes the same layers
    back = jconvert.load_h5_weights(path)
    kw = {"bbox_num": 2} if f["version"] == 1 else {}
    want = jconvert.export_reference_weights(f["variables"], f["version"],
                                             fam.CLASSES, **kw)
    assert list(written) == list(want) and set(back) == set(want)
    for layer, weights in want.items():
        for w, arr in weights.items():
            assert np.array_equal(back[layer][w], arr), (layer, w)
            assert np.array_equal(written[layer][w], arr), (layer, w)
    with pytest.raises(ValueError, match="create_model"):
        yolov1_5.Yolo(class_names=["a"]).export_reference_h5(path)
