"""Reference tf.keras .h5 weights into the port's models, and back.

Port of tf2_yolo_tpu/convert.py with its own copy of the numpy mapping.
The mapping works on flax-shaped trees of numpy arrays, ``{"params":
..., "batch_stats": ...}``, which are the port's ``state_dict`` by name
(``bridge.to_flax`` / ``bridge.from_flax``):

  - Conv2D kernels are HWIO in keras, flax and the port -> direct copy;
  - BatchNormalization (gamma, beta, moving_mean, moving_variance)
    -> ``bn.scale`` / ``bn.bias`` (params) + ``bn.mean`` / ``bn.var``
    (batch_stats);
  - the reference's per-anchor head convs (out{i}_box{j}_{xy,wh,conf,
    prob}_conv) are CONCATENATED channel-wise into the fused per-level
    head conv, in the [xy, wh, conf, prob] * box order the fused head
    expects (models/heads.py);
  - v4 Anchor layer weights (out{i}_box{j}_anchor) stack into the
    per-head (B, 2) ``anchors`` parameter.

Layer names are structural for v3/v4 (the reference builders' ``name=``
arguments) and positional for v1/v2 (keras' auto-generated conv2d_N /
batch_normalization_N in creation order). Every converter takes a
``{layer: {weight: ndarray}}`` dict in place of a path, so only
:func:`load_h5_weights` and :func:`save_reference_h5` need ``h5py``,
which they import when called.

Where the JAX module takes a model's variables, these functions take a
flax-shaped tree, a ``state_dict`` or an ``nn.Module``;
:func:`merge_into_variables` returns the kind it was given, so
``model.set_variables(merge_into_variables(model.variables, *parts))``
loads a conversion into an ``engine.Model``. :func:`convert_to_cache`
writes the port's own ``torch.save`` file, which
``facade_base.resolve_pretrained`` finds.
"""

import numpy as np
import torch

from .bridge import from_flax, to_flax


# ---------------------------------------------------------------------
# h5 reading
# ---------------------------------------------------------------------

def load_h5_weights(path):
    """Read a keras h5 weight file into {layer_name: {weight_name:
    ndarray}} (handles both `model_weights`-rooted training files and
    bare weight files)."""
    import h5py

    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            parts = name.split("/")
            # keras nests as  <layer>/<layer>/<weight>:0  or
            # model_weights/<layer>/<layer>/<weight>:0; a nested
            # sub-MODEL (e.g. the v2 mobilenet backbone) adds a level:
            # <model_layer>/<inner_layer>/<weight>:0 — keying on the
            # second-to-last component names the actual weight owner
            # in every case.
            if parts[0] == "model_weights":
                parts = parts[1:]
            layer = parts[-2] if len(parts) >= 2 else parts[0]
            weight = parts[-1].split(":")[0]
            out.setdefault(layer, {})[weight] = np.array(obj)

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        root.visititems(
            lambda name, obj: visit(
                ("model_weights/" + name) if root is not f else name,
                obj))
    return out


def _weights(h5_path_or_weights):
    return (h5_path_or_weights if isinstance(h5_path_or_weights, dict)
            else load_h5_weights(h5_path_or_weights))


# ---------------------------------------------------------------------
# tree plumbing
# ---------------------------------------------------------------------

def _is_state_dict(variables):
    return not ("params" in variables or "batch_stats" in variables)


def _as_tree(variables):
    """A flax-shaped tree of numpy leaves from a tree, a ``state_dict``
    or an ``nn.Module`` (its ``state_dict``)."""
    if isinstance(variables, torch.nn.Module):
        variables = variables.state_dict()
    if _is_state_dict(variables):
        return to_flax(variables)
    return variables


def _iter_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _iter_leaves(v)
        else:
            yield v


def _set_in(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _to_mutable(tree):
    if hasattr(tree, "items"):
        return {k: _to_mutable(v) for k, v in tree.items()}
    return tree


def _get_in(tree, path):
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            raise KeyError("/".join(map(str, path)))
        node = node[key]
    return node


def _copy_convbn(h5w, base, params, stats, path, used):
    """Copy one ConvBN block: '<base>_conv' (+ optional bias) and
    '<base>_bn'."""
    conv = h5w.get(f"{base}_conv")
    if conv is None:
        raise KeyError(f"missing layer '{base}_conv' in h5 file")
    entry = {"kernel": conv["kernel"]}
    if "bias" in conv:
        entry["bias"] = conv["bias"]
    _set_in(params, path + ("conv",), entry)
    used.add(f"{base}_conv")

    bn = h5w.get(f"{base}_bn")
    if bn is not None:
        _set_in(params, path + ("bn",),
                {"scale": bn["gamma"], "bias": bn["beta"]})
        _set_in(stats, path + ("bn",),
                {"mean": bn["moving_mean"],
                 "var": bn["moving_variance"]})
        used.add(f"{base}_bn")


# ---------------------------------------------------------------------
# YOLOv4 mapping
# ---------------------------------------------------------------------

_CSP_BLOCKS = [1, 2, 8, 8, 4]


def _yolov4_body_mapping():
    """[(module path, reference base name)] for the CSPDarknet-53 body +
    SPP/PAN neck (reference yolov4/models/backbone.py:149-157,
    darknet.py:72-136)."""
    m = [(("backbone", "stem"), "conv1")]
    for n, blocks in enumerate(_CSP_BLOCKS, start=1):
        st = ("backbone", f"stage{n}")
        m += [(st + ("down",), f"stage{n}_dn"),
              (st + ("cross",), f"stage{n}_cross"),
              (st + ("pre",), f"stage{n}_pre")]
        for b in range(1, blocks + 1):
            m += [(st + (f"block{b}", "squeeze"),
                   f"stage{n}_block{b}_1x1"),
                  (st + (f"block{b}", "expand"),
                   f"stage{n}_block{b}_3x3")]
        m += [(st + ("post",), f"stage{n}_post"),
              (st + ("out",), f"stage{n}_out")]

    return m + _yolov4_neck_mapping(
        ("pan_out_l", "pan_out_m", "pan_out_s"))


def _yolov4_neck_mapping(out_names):
    """[(module path, reference base name)] for the v4 SPP/PAN neck. The
    csp ``yolo_body`` and the keras-applications ``yolo_keras_app_body``
    share every neck layer name except the output convs:
    ``pan_out_{l,m,s}`` (yolov4/models/darknet.py:112, :125, :134) vs
    ``pan_out_{1,2,3}`` (backbone.py:231, :247)."""
    m = [(("td1_pre1",), "pan_td1_1"),
         (("td1_pre2",), "pan_td1_2"),
         (("td1_spp_pre",), "pan_td1_spp_pre"),
         (("td1_post1",), "pan_td1_3"),
         (("td1_post2",), "pan_td1_4"),
         (("td1_post3",), "pan_td1_5"),
         (("td1_up",), "pan_td1_up"),
         (("td2_pre",), "pan_td2_pre")]
    for i in range(1, 6):
        m.append((("td2", f"conv{i}"), f"pan_td2_{i}"))
    m += [(("td2_up",), "pan_td2_up"), (("td3_pre",), "pan_td3_pre")]
    for i in range(1, 6):
        m.append((("td3", f"conv{i}"), f"pan_td3_{i}"))
    m += [(("out_l",), out_names[0]), (("bu1_dn",), "pan_bu1_dn")]
    for i in range(1, 6):
        m.append((("bu1", f"conv{i}"), f"pan_bu1_{i}"))
    m += [(("out_m",), out_names[1]), (("bu2_dn",), "pan_bu2_dn")]
    for i in range(1, 6):
        m.append((("bu2", f"conv{i}"), f"pan_bu2_{i}"))
    m += [(("out_s",), out_names[2])]
    return m


def _fuse_head(h5w, level, abox_num, class_num, used):
    """Concatenate the per-box head convs of one level into the fused
    conv kernel/bias + stacked anchors."""
    kernels, biases, anchors = [], [], []
    for j in range(1, abox_num + 1):
        base = f"out{level}_box{j}"
        for part, ch in (("xy", 2), ("wh", 2), ("conf", 1),
                         ("prob", class_num)):
            lay = h5w.get(f"{base}_{part}_conv")
            if lay is None:
                raise KeyError(f"missing head conv {base}_{part}_conv")
            k = lay["kernel"]
            if k.shape[-1] != ch:
                raise ValueError(
                    f"{base}_{part}_conv has {k.shape[-1]} channels, "
                    f"expected {ch}")
            kernels.append(k)
            biases.append(lay.get("bias", np.zeros(ch, np.float32)))
            used.add(f"{base}_{part}_conv")
        anchor = h5w.get(f"{base}_anchor")
        if anchor is not None:
            # Anchor layer weight shape (1,1,1,2)
            anchors.append(list(anchor.values())[0].reshape(2))
            used.add(f"{base}_anchor")
    fused = {"kernel": np.concatenate(kernels, axis=-1),
             "bias": np.concatenate(biases, axis=-1)}
    return fused, (np.stack(anchors) if anchors else None)


def _heads(h5w, params, class_num, abox_num, num_levels, used,
           with_anchors):
    """The fused heads of a v3/v4 file that has them (a body-only file
    has no ``out1_box1_*`` layer)."""
    if not any(k.startswith("out1_box1") for k in h5w):
        return
    for level in range(1, num_levels + 1):
        fused, anchors = _fuse_head(h5w, level, abox_num, class_num, used)
        _set_in(params, (f"head{level}", "conv"), fused)
        if with_anchors and anchors is not None:
            params[f"head{level}"]["anchors"] = anchors


def convert_yolov4(h5_path_or_weights, class_num, abox_num=3,
                   num_levels=3, strict=True):
    """Convert a reference YOLOv4 h5 file (body or full model).

    Returns:
        (params, batch_stats) partial trees to merge into a YoloV4
        model's variables (missing pieces — e.g. heads when converting
        a body-only file — are simply absent).
    """
    h5w = _weights(h5_path_or_weights)
    params, stats, used = {}, {}, set()
    for path, base in _yolov4_body_mapping():
        try:
            _copy_convbn(h5w, base, params, stats, path, used)
        except KeyError:
            if strict:
                raise
    _heads(h5w, params, class_num, abox_num, num_levels, used, True)
    return params, stats


# ---------------------------------------------------------------------
# YOLOv3 mapping
# ---------------------------------------------------------------------

_DN53_BLOCKS = [1, 2, 8, 8, 4]


def _yolov3_fpn_mapping():
    m = []
    for k in range(1, 4):
        m += [((f"fpn{k}", "conv1"), f"last{k}_1_1x1"),
              ((f"fpn{k}", "conv2"), f"last{k}_1_3x3"),
              ((f"fpn{k}", "conv3"), f"last{k}_2_1x1"),
              ((f"fpn{k}", "conv4"), f"last{k}_2_3x3"),
              ((f"fpn{k}", "conv5"), f"last{k}_3_1x1"),
              ((f"fpn{k}", "out"), f"last{k}_3_3x3")]
    return m + [(("up1",), "up1"), (("up2",), "up2")]


def _yolov3_body_mapping():
    """[(module path, reference base name)] for the Darknet-53 body +
    3-level FPN (reference yolov3/models/backbone.py:58-95,
    darknet.py:71-104)."""
    m = [(("backbone", "stem"), "conv1")]
    for n, blocks in enumerate(_DN53_BLOCKS, start=1):
        m.append((("backbone", f"stage{n}_down"), f"block{n}_dn"))
        for b in range(1, blocks + 1):
            m += [(("backbone", f"stage{n}_block{b}", "squeeze"),
                   f"block{n}_{b}_1x1"),
                  (("backbone", f"stage{n}_block{b}", "expand"),
                   f"block{n}_{b}_3x3")]
    return m + _yolov3_fpn_mapping()


def convert_yolov3(h5_path_or_weights, class_num, abox_num=3,
                   num_levels=3, strict=True):
    """Convert a reference YOLOv3 h5 file (body or full model) into
    partial (params, batch_stats) trees for a YoloV3 model."""
    h5w = _weights(h5_path_or_weights)
    params, stats, used = {}, {}, set()
    for path, base in _yolov3_body_mapping():
        try:
            _copy_convbn(h5w, base, params, stats, path, used)
        except KeyError:
            if strict:
                raise
    _heads(h5w, params, class_num, abox_num, num_levels, used, False)
    return params, stats


# ---------------------------------------------------------------------
# YOLOv1 / YOLOv2 positional mapping
# ---------------------------------------------------------------------
# The reference v1/v2 builders use keras auto-generated layer names
# (conv2d, conv2d_1, ..., batch_normalization_N), so the mapping is
# positional: layer creation order in the reference equals module call
# order here.

def _numbered(h5w, prefix):
    """h5 layers named `prefix`, `prefix_1`, ... in numeric order."""
    def idx(name):
        tail = name[len(prefix):]
        return int(tail[1:]) if tail.startswith("_") else 0
    # the exact family (conv2d, not conv2d_transpose)
    names = [k for k in h5w
             if k == prefix or (k.startswith(prefix + "_")
                                and k[len(prefix) + 1:].isdigit())]
    return [h5w[k] for k in sorted(names, key=idx)]


def _suffix_sorted(keys, prefix="ConvBN_"):
    return sorted((k for k in keys if k.startswith(prefix)),
                  key=lambda k: int(k[len(prefix):]))


def _assign_convbn_positional(params, stats, path, conv, bn):
    entry = {"kernel": conv["kernel"]}
    if "bias" in conv:
        entry["bias"] = conv["bias"]
    _set_in(params, path + ("conv",), entry)
    if bn is not None:
        _set_in(params, path + ("bn",),
                {"scale": bn["gamma"], "bias": bn["beta"]})
        _set_in(stats, path + ("bn",),
                {"mean": bn["moving_mean"],
                 "var": bn["moving_variance"]})


def _anchor_head(params, head_convs, class_num, abox_num):
    """The v2 head: per-anchor (xy, wh, conf, prob) convs, fused."""
    kernels, biases = [], []
    for j in range(abox_num):
        group = head_convs[4 * j:4 * j + 4]     # xy, wh, conf, prob
        for lay, ch in zip(group, (2, 2, 1, class_num)):
            k = lay["kernel"]
            if k.shape[-1] != ch:
                raise ValueError(
                    f"head conv channel mismatch: {k.shape[-1]} vs {ch}")
            kernels.append(k)
            biases.append(lay.get("bias", np.zeros(ch, np.float32)))
    _set_in(params, ("head", "conv"),
            {"kernel": np.concatenate(kernels, axis=-1),
             "bias": np.concatenate(biases, axis=-1)})


def convert_yolov2_positional(h5_path_or_weights, variables,
                              class_num, abox_num):
    """Convert a reference YOLOv2 h5 (darknet backbone) by position.

    Layer creation order in the reference (yolov2/models/darknet.py:
    32-106): 18 backbone conv+BN pairs, neck 1024, neck 1024,
    passthrough 64, neck 1024, then per-anchor head convs
    (xy, wh, conf, prob) x abox_num without BN. ``variables``: the
    target model's (tree, ``state_dict`` or module), for its layer
    names.
    """
    h5w = _weights(h5_path_or_weights)
    convs = _numbered(h5w, "conv2d")
    bns = _numbered(h5w, "batch_normalization")

    params, stats = {}, {}
    backbone_keys = _suffix_sorted(_as_tree(variables)["params"]["backbone"])
    ordered = [("backbone", k) for k in backbone_keys]
    ordered += [("neck1",), ("neck2",), ("passthrough",), ("neck3",)]
    if len(convs) != len(ordered) + 4 * abox_num:
        raise ValueError(
            f"expected {len(ordered) + 4 * abox_num} convs, h5 has "
            f"{len(convs)}")
    if len(bns) != len(ordered):
        raise ValueError(
            f"expected {len(ordered)} batch_normalization layers, "
            f"h5 has {len(bns)}")
    for path, conv, bn in zip(ordered, convs, bns):
        _assign_convbn_positional(params, stats, path, conv, bn)
    _anchor_head(params, convs[len(ordered):], class_num, abox_num)
    return params, stats


def convert_yolov2_unet(h5_path_or_weights, variables, class_num,
                        abox_num):
    """Convert a reference YOLOv2 unet-backbone h5 by position.

    The unet body is 16 Conv2D(+bias)+BN pairs in creation order
    (reference yolov2/models/backbone.py:76-108: 10 encoder convs,
    up6 2x2 conv, conv6 x2, up7 2x2 conv, conv7 x2 — the body feeds
    the head directly, no passthrough neck, darknet.py:52-55), then
    the per-anchor head convs (xy, wh, conf, prob) x abox_num."""
    h5w = _weights(h5_path_or_weights)
    convs = _numbered(h5w, "conv2d")
    bns = _numbered(h5w, "batch_normalization")

    params, stats = {}, {}
    backbone_keys = _suffix_sorted(_as_tree(variables)["params"]["backbone"],
                                   prefix="ConvActBN_")
    if len(convs) != len(backbone_keys) + 4 * abox_num:
        raise ValueError(
            f"expected {len(backbone_keys) + 4 * abox_num} convs, "
            f"h5 has {len(convs)}")
    if len(bns) != len(backbone_keys):
        raise ValueError(
            f"expected {len(backbone_keys)} batch_normalization "
            f"layers, h5 has {len(bns)}")
    for key, conv, bn in zip(backbone_keys, convs, bns):
        _assign_convbn_positional(params, stats, ("backbone", key),
                                  conv, bn)
    _anchor_head(params, convs[len(backbone_keys):], class_num, abox_num)
    return params, stats


def convert_yolov3_tiny(h5_path_or_weights, class_num, abox_num=3):
    """Convert a reference tiny-YOLOv3 h5 by position: 11 no-bias
    conv+BN pairs in creation order (reference yolov3/models/
    darknet.py:107-135 — 8 backbone convs 16..1024,256, then the
    512-out head conv, the 128 up conv, the 256 merge conv), plus the
    NAMED per-level per-anchor head convs (out{i}_box{j}_*) fused
    per level like the full v3."""
    h5w = _weights(h5_path_or_weights)
    convs = _numbered(h5w, "conv2d")
    bns = _numbered(h5w, "batch_normalization")

    ordered = [("backbone", f"ConvBN_{i}") for i in range(8)]
    ordered += [("tiny_out1",), ("tiny_up",), ("tiny_out2",)]
    if len(convs) != len(ordered) or len(bns) != len(ordered):
        raise ValueError(
            f"expected {len(ordered)} conv/bn pairs, h5 has "
            f"{len(convs)}/{len(bns)}")

    params, stats = {}, {}
    for path, conv, bn in zip(ordered, convs, bns):
        _assign_convbn_positional(params, stats, path, conv, bn)
    used = set()
    for level in (1, 2):
        fused, _ = _fuse_head(h5w, level, abox_num, class_num, used)
        _set_in(params, (f"head{level}", "conv"), fused)
    return params, stats


def _copy_pair(h5w, conv_name, bn_name, params, stats, conv_path,
               bn_path, dw=False):
    """Copy one keras conv layer (+ optional BN layer) onto explicit
    param paths. ``dw=True`` transposes a keras depthwise kernel
    (kh, kw, C, 1) to the flax feature_group_count layout (kh, kw, 1,
    C), which the port's depthwise conv keeps."""
    conv = h5w[conv_name]
    kernel = conv["kernel"] if "kernel" in conv \
        else conv["depthwise_kernel"]
    if dw:
        kernel = np.transpose(kernel, (0, 1, 3, 2))
    entry = {"kernel": kernel}
    if "bias" in conv:
        entry["bias"] = conv["bias"]
    _set_in(params, conv_path, entry)
    if bn_name is not None:
        bn = h5w[bn_name]
        _set_in(params, bn_path,
                {"scale": bn["gamma"], "bias": bn["beta"]})
        _set_in(stats, bn_path,
                {"mean": bn["moving_mean"],
                 "var": bn["moving_variance"]})


def convert_yolov2_mobilenet(h5_path_or_weights, class_num, abox_num):
    """Convert a reference YOLOv2 mobilenet-backbone h5 (keras
    applications MobileNetV2 nested sub-model + per-anchor head convs,
    reference yolov2/models/darknet.py:57-61, :68-102) onto the
    MobileNetV2-backbone YoloV2 trees by keras layer NAME (the
    backbone layers are explicitly named; only the head convs are
    auto-numbered)."""
    h5w = _weights(h5_path_or_weights)
    params, stats = {}, {}
    B = ("backbone",)

    _copy_pair(h5w, "Conv1", "bn_Conv1", params, stats,
               B + ("stem_conv",), B + ("stem_bn",))
    # 17 inverted residual blocks; keras names block 0 "expanded_conv"
    for i in range(17):
        ours = B + (f"block{i + 1}",)
        ref = "expanded_conv" if i == 0 else f"block_{i}"
        if i != 0:
            _copy_pair(h5w, f"{ref}_expand", f"{ref}_expand_BN",
                       params, stats, ours + ("expand_conv",),
                       ours + ("expand_bn",))
        _copy_pair(h5w, f"{ref}_depthwise", f"{ref}_depthwise_BN",
                   params, stats, ours + ("dw_conv",),
                   ours + ("dw_bn",), dw=True)
        _copy_pair(h5w, f"{ref}_project", f"{ref}_project_BN",
                   params, stats, ours + ("project_conv",),
                   ours + ("project_bn",))
    _copy_pair(h5w, "Conv_1", "Conv_1_bn", params, stats,
               B + ("head_conv",), B + ("head_bn",))

    # per-anchor head convs (xy, wh, conf, prob) — auto-numbered
    head_convs = _numbered(h5w, "conv2d")
    if len(head_convs) != 4 * abox_num:
        raise ValueError(
            f"expected {4 * abox_num} head convs, h5 has "
            f"{len(head_convs)}")
    _anchor_head(params, head_convs, class_num, abox_num)
    return params, stats


_RESNET_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
                        152: (3, 8, 36, 3)}


def _copy_resnet_backbone(h5w, params, stats, depth):
    """Copy a keras-applications ResNet{50,101,152} backbone by layer
    name (stem + bottleneck stages) onto the ResNet module tree."""
    B = ("backbone",)
    _copy_pair(h5w, "conv1_conv", "conv1_bn", params, stats,
               B + ("stem_conv",), B + ("stem_bn",))
    for s, n_blocks in enumerate(_RESNET_STAGE_BLOCKS[depth], start=1):
        for b in range(1, n_blocks + 1):
            ref = f"conv{s + 1}_block{b}"
            ours = B + (f"stage{s}_block{b}",)
            if b == 1:
                _copy_pair(h5w, f"{ref}_0_conv", f"{ref}_0_bn",
                           params, stats, ours + ("short_conv",),
                           ours + ("short_bn",))
            for i in (1, 2, 3):
                _copy_pair(h5w, f"{ref}_{i}_conv", f"{ref}_{i}_bn",
                           params, stats, ours + (f"conv{i}",),
                           ours + (f"bn{i}",))


def convert_yolov3_resnet(h5_path_or_weights, class_num, depth=50,
                          abox_num=3, num_levels=3):
    """Convert a reference YOLOv3 resnet-backbone h5 (keras
    applications ResNet{50,101,152} + Darknet FPN, reference
    yolov3/models/backbone.py:98-126, yolov3/__init__.py:143-156) by
    keras layer name onto the ResNet-backbone YoloV3 trees."""
    h5w = _weights(h5_path_or_weights)
    params, stats, used = {}, {}, set()
    _copy_resnet_backbone(h5w, params, stats, depth)
    for path, base in _yolov3_fpn_mapping():
        _copy_convbn(h5w, base, params, stats, path, used)
    _heads(h5w, params, class_num, abox_num, num_levels, used, False)
    return params, stats


def convert_yolov4_resnet(h5_path_or_weights, class_num, depth=50,
                          abox_num=3, num_levels=3):
    """Convert a reference YOLOv4 resnet-backbone h5 (keras
    applications ResNet{50,101,152} + SPP/PAN neck built by
    ``yolo_keras_app_body``, reference yolov4/models/backbone.py:
    188-250, facade pan_ids [-33, 80] at yolov4/__init__.py:236-239)
    by keras layer name onto the ResNet-backbone YoloV4 trees,
    including the head Anchor-layer weights."""
    h5w = _weights(h5_path_or_weights)
    params, stats, used = {}, {}, set()
    _copy_resnet_backbone(h5w, params, stats, depth)
    for path, base in _yolov4_neck_mapping(
            ("pan_out_1", "pan_out_2", "pan_out_3")):
        _copy_convbn(h5w, base, params, stats, path, used)
    _heads(h5w, params, class_num, abox_num, num_levels, used, True)
    return params, stats


def convert_yolov1_positional(h5_path_or_weights, variables,
                              class_num, bbox_num):
    """Convert a reference YOLOv1.5 h5 by position: 24 backbone
    conv+BN pairs, then the sigmoid xywhc conv (5*B ch) and softmax
    prob conv (C ch) which concatenate into the fused v1 head
    (reference yolov1_5/models/darknet.py:37-55)."""
    h5w = _weights(h5_path_or_weights)
    convs = _numbered(h5w, "conv2d")
    bns = _numbered(h5w, "batch_normalization")

    params, stats = {}, {}
    backbone_keys = _suffix_sorted(_as_tree(variables)["params"]["backbone"])
    if len(convs) != len(backbone_keys) + 2:
        raise ValueError(
            f"expected {len(backbone_keys) + 2} convs, h5 has "
            f"{len(convs)}")
    for key, conv, bn in zip(backbone_keys, convs, bns):
        _assign_convbn_positional(params, stats, ("backbone", key),
                                  conv, bn)

    xywhc, prob = convs[-2], convs[-1]
    if xywhc["kernel"].shape[-1] != 5 * bbox_num:
        raise ValueError("xywhc head conv channel mismatch")
    if prob["kernel"].shape[-1] != class_num:
        raise ValueError("prob head conv channel mismatch")
    _set_in(params, ("head", "conv"), {
        "kernel": np.concatenate(
            [xywhc["kernel"], prob["kernel"]], axis=-1),
        "bias": np.concatenate(
            [xywhc.get("bias", np.zeros(5 * bbox_num, np.float32)),
             prob.get("bias", np.zeros(class_num, np.float32))],
            axis=-1)})
    return params, stats


# ---------------------------------------------------------------------
# cache and merge
# ---------------------------------------------------------------------

def convert_to_cache(h5_path, version, class_num, abox_num=None,
                     name=None, input_shape=(128, 128, 3),
                     anchors=None):
    """Convert a reference h5 file and store it in the local weight
    cache so the facades' named-weights resolution picks it up
    (``facade_base.resolve_pretrained``).

    Args:
        h5_path: reference keras h5 weight file.
        version: 1-4.
        class_num: classes the h5 heads were built for.
        abox_num: boxes per cell (v1) / anchors per level (v2-4).
            Defaults follow the reference: v1=2, v2=5, v3=v4=3.
        name: cache entry name (e.g. "ms_coco"); default the h5 stem.
        input_shape: the JAX signature's template shape; the port's
            modules build without one, so it is not read.
        anchors: anchor priors for the template (defaults to flat 0.3).

    Returns:
        the path of the written file, ``yolov{version}_{name}.pt`` under
        ``facade_base.weights_cache_dir()``: a ``torch.save`` of the
        template model's ``state_dict`` (CPU tensors) with the converted
        arrays in it, usable as ``pretrained_weights``.

    Raises:
        ValueError if NOTHING in the h5 matched the expected layer
        names (misnamed/foreign file) — otherwise the cache would be
        random weights posing as pretrained. Body-only files are fine
        (heads stay randomly initialized; a warning reports counts).
    """
    import os
    import warnings

    from .facade_base import weights_cache_dir
    from .models import YoloV1, YoloV2, YoloV3, YoloV4

    del input_shape
    if abox_num is None:
        abox_num = {1: 2, 2: 5, 3: 3, 4: 3}[version]
    levels = {1: 1, 2: 1, 3: 3, 4: 3}[version]
    if anchors is None:
        anchors = np.full((abox_num * levels, 2), 0.3, np.float32)
    gen = torch.Generator().manual_seed(0)
    kw = dict(class_num=class_num, generator=gen, device="cpu")
    if version == 1:
        model = YoloV1(bbox_num=abox_num, **kw)
    else:
        model = {2: YoloV2, 3: YoloV3, 4: YoloV4}[version](anchors, **kw)
    state = model.state_dict()

    h5w = load_h5_weights(h5_path)
    if version == 1:
        parts = convert_yolov1_positional(h5w, state, class_num, abox_num)
    elif version == 2:
        parts = convert_yolov2_positional(h5w, state, class_num, abox_num)
    elif version == 3:
        parts = convert_yolov3(h5w, class_num, abox_num, strict=False)
    else:
        parts = convert_yolov4(h5w, class_num, abox_num, strict=False)

    converted = sum(1 for _ in _iter_leaves(parts[0])) + sum(
        1 for _ in _iter_leaves(parts[1]))
    if converted == 0:
        raise ValueError(
            f"no layer in {h5_path} matched the expected reference "
            f"yolov{version} layer names — refusing to write a cache "
            "file of random weights")
    has_heads = any(k.startswith("head") for k in parts[0])
    if not has_heads and version >= 3:
        warnings.warn(
            f"{h5_path}: body-only file ({converted} arrays "
            "converted); head convs stay randomly initialized and v4 "
            "anchors keep the template values")
    merged = merge_into_variables(state, *parts)

    stem = name or os.path.splitext(os.path.basename(h5_path))[0]
    cache_dir = weights_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    out = os.path.join(cache_dir, f"yolov{version}_{stem}.pt")
    torch.save(merged, out)
    return out


def merge_into_variables(variables, params, batch_stats):
    """Merge converted partial trees into a model's variables, checking
    that every converted array has a place of the same shape. Takes a
    flax-shaped tree (returns a new one, numpy leaves) or a
    ``state_dict`` (returns a new ``state_dict`` of CPU tensors, the
    same keys in the same order)."""
    as_state = _is_state_dict(variables)
    tree = to_flax(variables) if as_state else _to_mutable(variables)

    def merge(dst, src, where):
        for k, v in src.items():
            if isinstance(v, dict):
                if k not in dst:
                    raise KeyError(f"no module '{where}/{k}' in model")
                merge(dst[k], v, f"{where}/{k}")
            else:
                if k not in dst:
                    raise KeyError(f"no param '{where}/{k}' in model")
                if tuple(np.shape(dst[k])) != tuple(np.shape(v)):
                    raise ValueError(
                        f"shape mismatch at {where}/{k}: model "
                        f"{np.shape(dst[k])} vs h5 {np.shape(v)}")
                dst[k] = np.asarray(v, np.float32)

    merge(tree["params"], params, "params")
    merge(tree.setdefault("batch_stats", {}), batch_stats, "batch_stats")
    if not as_state:
        return tree
    state = from_flax(tree)
    return {k: state[k] for k in variables}


# ---------------------------------------------------------------------
# Reverse conversion: a model's variables -> reference keras h5
# ---------------------------------------------------------------------
# Inverse of the converters above: serialize a model's variables as a
# keras-2 h5 weight file the REFERENCE builders load, so training here
# and deploying with the reference/TF tooling roundtrips. v3/v4 use the
# reference's structural layer names (reference yolov3/models/
# backbone.py:39-55 names sublayers '<base>_conv'/'<base>_bn';
# yolov4/models/__init__.py:38-67 names the head convs
# 'out{i}_box{j}_{part}_conv' and the Anchor layers 'out{i}_box{j}_anchor')
# — load with ``ref_model.load_weights(path, by_name=True)``. v1/v2 use
# keras auto-generated positional names (conv2d_N /
# batch_normalization_N), valid for the FIRST reference model built in a
# fresh process (the keras name counters start there), matching how the
# forward converters read those files.

def _f32(x):
    return np.asarray(x, np.float32)


def _emit_convbn(h5w, base, params, stats, path):
    """Inverse of :func:`_copy_convbn`: one ConvBN module at ``path``
    becomes reference layers '<base>_conv' (+ '<base>_bn' if present).
    Dict insertion order IS the keras weight order."""
    conv = _get_in(params, path + ("conv",))
    entry = {"kernel": _f32(conv["kernel"])}
    if "bias" in conv:
        entry["bias"] = _f32(conv["bias"])
    h5w[f"{base}_conv"] = entry
    try:
        bn = _get_in(params, path + ("bn",))
    except KeyError:
        return
    st = _get_in(stats, path + ("bn",))
    h5w[f"{base}_bn"] = {"gamma": _f32(bn["scale"]),
                         "beta": _f32(bn["bias"]),
                         "moving_mean": _f32(st["mean"]),
                         "moving_variance": _f32(st["var"])}


def _emit_split_head(h5w, head, level, abox_num, class_num,
                     with_anchors):
    """Inverse of :func:`_fuse_head`: slice the fused per-level head
    conv back into the reference's per-box xy/wh/conf/prob 1x1 convs
    (channel groups 2/2/1/C per box, box-major — the fused layout)."""
    kernel = _f32(head["conv"]["kernel"])
    per = 5 + class_num
    if kernel.shape[-1] != abox_num * per:
        raise ValueError(
            f"head{level} has {kernel.shape[-1]} channels, expected "
            f"{abox_num} x (5 + {class_num})")
    bias = _f32(head["conv"].get(
        "bias", np.zeros(kernel.shape[-1], np.float32)))
    anchors = _f32(head["anchors"]) if with_anchors else None
    off = 0
    for j in range(1, abox_num + 1):
        base = f"out{level}_box{j}"
        for part, ch in (("xy", 2), ("wh", 2), ("conf", 1),
                         ("prob", class_num)):
            h5w[f"{base}_{part}_conv"] = {
                "kernel": kernel[..., off:off + ch],
                "bias": bias[off:off + ch]}
            off += ch
        if anchors is not None:
            h5w[f"{base}_anchor"] = {
                "Variable": anchors[j - 1].reshape(1, 1, 1, 2)}


def export_reference_weights(variables, version, class_num,
                             abox_num=None, bbox_num=2):
    """Build the reference-layout weight dict {layer: {weight: arr}}
    from a model's variables (a flax-shaped tree, a ``state_dict`` or
    an ``nn.Module``; tensors on any device): the inverse of the
    convert_* functions (see the section comment for naming/loading
    semantics per version).

    Only the darknet-family backbones are exportable — they are the
    architectures whose reference builders the layer names come from
    (csp_darknet for v4, full_darknet for v3, darknet for v1/v2).
    """
    if abox_num is None:
        abox_num = {1: bbox_num, 2: 5, 3: 3, 4: 3}[version]
    variables = _as_tree(variables)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    h5w = {}

    if version in (3, 4):
        mapping = (_yolov4_body_mapping() if version == 4
                   else _yolov3_body_mapping())
        try:
            for path, base in mapping:
                _emit_convbn(h5w, base, params, stats, path)
        except KeyError as e:
            raise ValueError(
                f"model tree missing module {e} — only the darknet "
                f"family (csp_darknet/full_darknet bodies) exports to "
                f"reference layer names") from e
        for level in range(1, 4):
            _emit_split_head(h5w, params[f"head{level}"], level,
                             abox_num, class_num,
                             with_anchors=(version == 4))
        return h5w

    # v1/v2: positional conv2d_N / batch_normalization_N names in the
    # reference's layer-creation order (the order the forward
    # converters consume them in)
    def positional(n):
        return (("conv2d", "batch_normalization") if n == 0
                else (f"conv2d_{n}", f"batch_normalization_{n}"))

    backbone_keys = _suffix_sorted(params["backbone"])
    if not backbone_keys:
        raise ValueError("positional export needs the darknet "
                         "backbone (no ConvBN_* modules found)")
    ordered = [("backbone", k) for k in backbone_keys]
    if version == 2:
        ordered += [("neck1",), ("neck2",), ("passthrough",),
                    ("neck3",)]
    n_conv = 0
    for path in ordered:
        conv_name, bn_name = positional(n_conv)
        mod = _get_in(params, path)
        entry = {"kernel": _f32(mod["conv"]["kernel"])}
        if "bias" in mod["conv"]:
            entry["bias"] = _f32(mod["conv"]["bias"])
        h5w[conv_name] = entry
        if "bn" in mod:
            st = _get_in(stats, path + ("bn",))
            h5w[bn_name] = {"gamma": _f32(mod["bn"]["scale"]),
                            "beta": _f32(mod["bn"]["bias"]),
                            "moving_mean": _f32(st["mean"]),
                            "moving_variance": _f32(st["var"])}
        n_conv += 1

    head = params["head"]
    kernel = _f32(head["conv"]["kernel"])
    bias = _f32(head["conv"].get(
        "bias", np.zeros(kernel.shape[-1], np.float32)))
    if version == 1:
        groups = [5 * bbox_num, class_num]      # xywhc conv, prob conv
    else:
        groups = [2, 2, 1, class_num] * abox_num
    if kernel.shape[-1] != sum(groups):
        raise ValueError(
            f"head has {kernel.shape[-1]} channels, expected "
            f"{sum(groups)}")
    off = 0
    for ch in groups:
        conv_name, _ = positional(n_conv)
        h5w[conv_name] = {"kernel": kernel[..., off:off + ch],
                          "bias": bias[off:off + ch]}
        off += ch
        n_conv += 1
    return h5w


def save_reference_h5(h5w, path):
    """Write a reference-layout weight dict as a keras-2 h5 weight
    file (layer groups with `weight_names` attrs, datasets at
    '<layer>/<layer>/<name>:0') loadable by
    ``tf.keras Model.load_weights`` — use ``by_name=True`` for the
    v3/v4 structural names. Dict insertion order defines the keras
    per-layer weight order (conv: kernel, bias; bn: gamma, beta,
    moving_mean, moving_variance; Anchor: the single Variable)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array(
            [k.encode() for k in h5w])
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.15.0"
        for layer, weights in h5w.items():
            g = f.create_group(layer)
            names = [f"{layer}/{w}:0" for w in weights]
            g.attrs["weight_names"] = np.array(
                [n.encode() for n in names])
            for n, (_, value) in zip(names, weights.items()):
                g.create_dataset(n, data=np.asarray(value, np.float32))


def export_reference_h5(variables, version, class_num, path,
                        abox_num=None, bbox_num=2):
    """Serialize a model's variables as a reference-loadable keras h5
    weight file (see export_reference_weights / save_reference_h5).

    Returns the weight dict that was written."""
    h5w = export_reference_weights(variables, version, class_num,
                                   abox_num=abox_num, bbox_num=bbox_num)
    save_reference_h5(h5w, path)
    return h5w
