"""The reference-weight converter of the port against the JAX package's,
shared by ``tests/test_torch_convert.py`` (the darknet families and the
converter's API) and ``tests/test_torch_convert_backbones.py`` (the
ResNet and MobileNetV2 families).

Each family is a network of ``tests/helpers_families.py`` (its
BN-calibrated variables, its test batch and its JAX outputs). Its
variables are written as a reference keras h5 file in ``tmp_path``: by
the JAX package's ``export_reference_h5`` where the JAX package exports
the family (the darknet bodies), otherwise by :func:`reference_weights`
here, the keras layer names of the reference builders written out from
the JAX tree, and the JAX package's ``save_reference_h5``. Then:

- the port's ``load_h5_weights`` + ``convert_*``, merged into the
  JAX init's tree as a ``state_dict``, equals ``bridge.from_flax`` of
  the JAX converter's output merged into the same tree, bit for bit;
- a fresh port model that loads it serves the test batch within the
  parity bounds of ``helpers_families.check_eval_heads``;
- where the JAX package exports the family, the port's
  ``export_reference_weights`` of the bridged model gives the JAX one's
  layer names, in order, and arrays, bit for bit; where it does not,
  both raise ValueError.
"""

import shutil

import numpy as np
import pytest
import torch

from tests import helpers_families as fam
from tf2_yolo_tpu import convert as jconvert
from tf2_yolo_tpu_torch import bridge
from tf2_yolo_tpu_torch import convert

ABOX = {1: 2, 2: 5, 3: 3, 4: 3}


@pytest.fixture(autouse=True)
def remove_files_after_test(tmp_path):
    """Imported by a test module to empty each test's ``tmp_path`` after
    the test: its h5 and .pt files hold networks at full width (up to
    250 MB each), and pytest keeps the temporary directories of the last
    three runs, which would hold gigabytes of them."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)

# name: (whether the JAX exporter writes it, the converter call); a call
# takes (the converter module, the JAX package's or the port's; h5
# weights or path; the target's variables)
CONVERTERS = {
    "v4": (True, lambda m, h, v: m.convert_yolov4(h, fam.CLASSES)),
    "v3_full": (True, lambda m, h, v: m.convert_yolov3(h, fam.CLASSES)),
    "v3_tiny": (False,
                lambda m, h, v: m.convert_yolov3_tiny(h, fam.CLASSES)),
    "v2_darknet": (True, lambda m, h, v: m.convert_yolov2_positional(
        h, v, fam.CLASSES, 5)),
    "v2_unet": (False, lambda m, h, v: m.convert_yolov2_unet(
        h, v, fam.CLASSES, 5)),
    "v2_mobilenet": (False, lambda m, h, v: m.convert_yolov2_mobilenet(
        h, fam.CLASSES, 5)),
    "v1": (True, lambda m, h, v: m.convert_yolov1_positional(
        h, v, fam.CLASSES, 2)),
    "v4_resnet50": (False, lambda m, h, v: m.convert_yolov4_resnet(
        h, fam.CLASSES, depth=50)),
    # a ResNet-50 v1 through the backbone factory: the v3 FPN on the
    # keras-applications ResNet the reference's v3 builder takes
    "v3_callable": (False, lambda m, h, v: m.convert_yolov3_resnet(
        h, fam.CLASSES, depth=50)),
}


# ----------------------------------------------------------------------
# the reference's keras layers of the families the JAX package does not
# export, written out from a flax tree
def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _bn(params, stats, path):
    bn, st = _get(params, path), _get(stats, path)
    return {"gamma": bn["scale"], "beta": bn["bias"],
            "moving_mean": st["mean"], "moving_variance": st["var"]}


def _pair(h5w, conv_name, bn_name, params, stats, conv_path, bn_path,
          dw=False):
    """One keras conv layer (a depthwise one takes (kh, kw, C, 1) as
    ``depthwise_kernel``) and its BN layer."""
    conv = _get(params, conv_path)
    kernel = np.transpose(conv["kernel"], (0, 1, 3, 2)) if dw \
        else conv["kernel"]
    entry = {"depthwise_kernel" if dw else "kernel": kernel}
    if "bias" in conv:
        entry["bias"] = conv["bias"]
    h5w[conv_name] = entry
    if bn_name is not None:
        h5w[bn_name] = _bn(params, stats, bn_path)


def _positional(h5w, params, stats, paths):
    """conv2d_N / batch_normalization_N, keras' names in creation order;
    a path without a ``bn`` writes the conv alone."""
    for n, path in enumerate(paths):
        tail = "" if n == 0 else f"_{n}"
        node = _get(params, path)
        h5w[f"conv2d{tail}"] = {k: node["conv"][k]
                                for k in ("kernel", "bias")
                                if k in node["conv"]}
        if "bn" in node:
            h5w[f"batch_normalization{tail}"] = _bn(params, stats,
                                                    path + ("bn",))


def _v2_head(h5w, params, first, class_num, abox_num):
    """The per-anchor (xy, wh, conf, prob) head convs, numbered from
    conv2d_``first``."""
    conv = params["head"]["conv"]
    off = 0
    for n, ch in enumerate([2, 2, 1, class_num] * abox_num, start=first):
        tail = "" if n == 0 else f"_{n}"
        h5w[f"conv2d{tail}"] = {"kernel": conv["kernel"][..., off:off + ch],
                                "bias": conv["bias"][off:off + ch]}
        off += ch


def _resnet(h5w, params, stats, blocks=(3, 4, 6, 3)):
    b = ("backbone",)
    _pair(h5w, "conv1_conv", "conv1_bn", params, stats, b + ("stem_conv",),
          b + ("stem_bn",))
    for s, n_blocks in enumerate(blocks, start=1):
        for k in range(1, n_blocks + 1):
            ref, ours = f"conv{s + 1}_block{k}", b + (f"stage{s}_block{k}",)
            if k == 1:
                _pair(h5w, f"{ref}_0_conv", f"{ref}_0_bn", params, stats,
                      ours + ("short_conv",), ours + ("short_bn",))
            for i in (1, 2, 3):
                _pair(h5w, f"{ref}_{i}_conv", f"{ref}_{i}_bn", params,
                      stats, ours + (f"conv{i}",), ours + (f"bn{i}",))


def reference_weights(name, variables):
    """The reference h5's {layer: {weight: array}} of a family the JAX
    package does not export, from its flax ``variables``."""
    p, s = variables["params"], variables["batch_stats"]
    h5w = {}
    if name == "v3_tiny":
        _positional(h5w, p, s, [("backbone", f"ConvBN_{i}") for i in
                                range(8)]
                    + [("tiny_out1",), ("tiny_up",), ("tiny_out2",)])
        for level in (1, 2):
            jconvert._emit_split_head(h5w, p[f"head{level}"], level, 3,
                                      fam.CLASSES, with_anchors=False)
    elif name == "v2_unet":
        keys = sorted(p["backbone"], key=lambda k: int(k.split("_")[1]))
        _positional(h5w, p, s, [("backbone", k) for k in keys])
        _v2_head(h5w, p, len(keys), fam.CLASSES, 5)
    elif name == "v2_mobilenet":
        b = ("backbone",)
        _pair(h5w, "Conv1", "bn_Conv1", p, s, b + ("stem_conv",),
              b + ("stem_bn",))
        for i in range(17):
            ours = b + (f"block{i + 1}",)
            ref = "expanded_conv" if i == 0 else f"block_{i}"
            if i:
                _pair(h5w, f"{ref}_expand", f"{ref}_expand_BN", p, s,
                      ours + ("expand_conv",), ours + ("expand_bn",))
            _pair(h5w, f"{ref}_depthwise", f"{ref}_depthwise_BN", p, s,
                  ours + ("dw_conv",), ours + ("dw_bn",), dw=True)
            _pair(h5w, f"{ref}_project", f"{ref}_project_BN", p, s,
                  ours + ("project_conv",), ours + ("project_bn",))
        _pair(h5w, "Conv_1", "Conv_1_bn", p, s, b + ("head_conv",),
              b + ("head_bn",))
        _v2_head(h5w, p, 0, fam.CLASSES, 5)
    elif name == "v4_resnet50":
        _resnet(h5w, p, s)
        for path, base in jconvert._yolov4_neck_mapping(
                ("pan_out_1", "pan_out_2", "pan_out_3")):
            jconvert._emit_convbn(h5w, base, p, s, path)
        for level in (1, 2, 3):
            jconvert._emit_split_head(h5w, p[f"head{level}"], level, 3,
                                      fam.CLASSES, with_anchors=True)
    elif name == "v3_callable":
        _resnet(h5w, p, s)
        for path, base in jconvert._yolov3_body_mapping():
            if path[0] != "backbone":
                jconvert._emit_convbn(h5w, base, p, s, path)
        for level in (1, 2, 3):
            jconvert._emit_split_head(h5w, p[f"head{level}"], level, 3,
                                      fam.CLASSES, with_anchors=False)
    else:
        raise KeyError(name)
    return h5w


# ----------------------------------------------------------------------
def write_h5(f, tmp_path):
    """The family's calibrated variables as a reference h5 file."""
    version, exported = f["version"], CONVERTERS[f["name"]][0]
    path = str(tmp_path / f"{f['name']}.h5")
    if exported:
        kw = ({"bbox_num": 2} if version == 1
              else {"abox_num": ABOX[version]})
        jconvert.export_reference_h5(f["variables"], version, fam.CLASSES,
                                     path, **kw)
    else:
        jconvert.save_reference_h5(reference_weights(f["name"],
                                                     f["variables"]), path)
    return path


def state_equal(a, b):
    """Two state_dicts with the same keys and bit-equal tensors; returns
    the keys that differ."""
    assert set(a) == set(b)
    return [k for k in a if not torch.equal(a[k], b[k])]


def check_family(f, tmp_path):
    """The module docstring's three checks for one family."""
    name, version = f["name"], f["version"]
    path = write_h5(f, tmp_path)
    call = CONVERTERS[name][1]

    # the port: read the file, convert, merge into the JAX init's tree
    # as a state_dict of a fresh model of the port
    model = fam.FAMILIES[name][3]()
    model.load_state_dict(bridge.from_flax(f["init"]), strict=True)
    h5w = convert.load_h5_weights(path)
    parts = call(convert, h5w, model.state_dict())
    got = convert.merge_into_variables(model.state_dict(), *parts)
    # the JAX package: its converter on the path, merged into the same
    # tree
    jparts = call(jconvert, path, f["init"])
    want = bridge.from_flax(jconvert.merge_into_variables(f["init"],
                                                          *jparts))
    assert state_equal(got, want) == []
    # every array of the file arrived: the merged tree is the source's
    assert state_equal(got, bridge.from_flax(f["variables"])) == []

    # a fresh model that loads it serves the test batch as JAX does
    model.load_state_dict(got, strict=True)
    with torch.no_grad():
        outs = [o.numpy() for o in fam.as_list(
            model.eval()(torch.from_numpy(f["x"])))]
    fam.check_eval_heads(dict(f, outs=outs))

    # the export, beside the JAX package's
    kw = {"bbox_num": 2} if version == 1 else {"abox_num": ABOX[version]}
    if CONVERTERS[name][0]:
        mine = convert.export_reference_weights(model, version,
                                                fam.CLASSES, **kw)
        theirs = jconvert.export_reference_weights(f["variables"], version,
                                                   fam.CLASSES, **kw)
        assert list(mine) == list(theirs)
        for layer, weights in theirs.items():
            assert list(mine[layer]) == list(weights), layer
            for w, arr in weights.items():
                assert mine[layer][w].dtype == np.float32
                assert np.array_equal(mine[layer][w], arr), (layer, w)
    else:
        for mod, variables in ((convert, model.state_dict()),
                               (jconvert, f["variables"])):
            try:
                mod.export_reference_weights(variables, version,
                                             fam.CLASSES, **kw)
            except ValueError:
                continue
            raise AssertionError(f"{mod.__name__} exported {name}")
