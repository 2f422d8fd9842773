"""Deployment: BatchNorm folding, static-scale int8 calibration, the
serving program and the saved serving artifact.

Port of tf2_yolo_tpu/export.py:

1. :func:`fold_batch_norm` folds every BatchNorm's inference statistics
   into the conv it follows, on a flax-named ``state_dict``; the folded
   BNs become exact pass-throughs.
2. :func:`calibrate_int8` records each ConvBN input's max |x| over eval
   forwards and returns the JAX package's scales tree; given to
   :func:`make_serving_fn` (``quant=``), every calibrated ConvBN with
   min(Ci, Co) >= ``int8_min_channels`` serves through the int8 kernel
   (``models.layers.Int8ConvBN``).
3. :func:`make_serving_fn` builds the serving program (eval forward,
   device decode, device NMS); :func:`export_serving` captures it with
   ``torch.export`` at a fixed batch, the weights inside, and
   :func:`save_serving` / :func:`load_serving` write and read a
   container of one program per batch bucket that needs no
   model-building code: the hand-written kernels are custom ops of this
   package (``ops/kernels``), which ``load_serving`` registers by
   importing it.

The JAX package's jax2tf SavedModel export (``save_saved_model``) has no
counterpart here.
"""

import copy
import io
import json
import re

import torch

from .models.layers import (BNState, ConvBN, Int8ConvBN,
                            capture_input_absmax)
from .ops.decode import decode_multi_level
from .ops.nms import apply_nms_device

BN_EPS = 1e-3
# the container: magic, 8-byte big-endian header length, JSON header,
# then the programs. Not the JAX package's b"TYSRV001", so that neither
# loader misreads the other's file.
MAGIC = b"TYSRVPT1"
JAX_MAGIC = b"TYSRV001"


# ----------------------------------------------------------------------
def _conv_name_for(bn_name):
    if bn_name == "bn":
        return "conv"
    m = re.fullmatch(r"bn(\d+)", bn_name)
    if m:
        return "conv" + m.group(1)
    if bn_name.endswith("_bn"):
        return bn_name[:-3] + "_conv"
    return None


def bn_eps(model):
    """``{qualified name: eps}`` of every BatchNorm (``BNState``) of
    ``model``: the epsilons :func:`fold_batch_norm` folds with."""
    return {name: m.eps for name, m in model.named_modules()
            if isinstance(m, BNState)}


def fold_batch_norm(state_dict, eps=None):
    """Fold BN inference statistics into conv kernels and biases.

    Takes and returns a flax-named ``state_dict`` (``bridge.from_flax``
    naming: ``<scope>.bn.{scale,bias,mean,var}`` beside
    ``<scope>.conv.kernel``) with the same keys. Each BN (an entry pair
    ``<p>.mean``, ``<p>.var``) is paired with its scope's conv by the JAX
    package's name rule (``bn`` -> ``conv``, ``bnN`` -> ``convN``,
    ``X_bn`` -> ``X_conv``: ``short_bn``, ``stem_bn``, MobileNetV2's
    ``expand_bn``, ``dw_bn`` ...); with s = scale * rsqrt(var + eps) (XLA
    rewrites the JAX package's scale / sqrt(var + eps) so) the conv
    kernel becomes kernel * s (output channels last; a depthwise kernel's
    last axis too) and the affine bias - mean * s rides in the conv's
    bias where it has one, else in the BN's bias; the BN keeps scale 1
    and statistics mean 0, var 1 - eps, so its eval-mode normaliser is
    exactly 1. A BN without a conv (ResNet v2's ``pre_bn`` and
    ``post_bn``) keeps s and the affine as its scale and bias. Other
    entries are returned as they are (new tensors only where folded).

    A BN named ``bn`` whose conv has a bias is the JAX package's mark of
    a ConvActBN (activation between conv and BN) and is not folded: its
    affine stays in the BN. The rule also takes the biased ConvBNs of v1
    and v2, as in the JAX package. ``eps`` maps a BN's prefix to the
    epsilon it normalises with (:func:`bn_eps` of the model: the ResNets'
    1.001e-5, MobileNetV2's 1e-3); a BN it does not name takes 1e-3, the
    Darknets'. The JAX package guesses the epsilon from the scope's
    children instead (1.001e-5 beside ``stage{i}_block{j}`` blocks),
    which also takes Darknet-53's BNs, which normalise with 1e-3;
    :func:`folded_copy` folds each BN with its own.
    """
    out = dict(state_dict)
    eps_of = eps or {}
    for key in state_dict:
        if not key.endswith(".mean"):
            continue
        prefix = key[:-len(".mean")]
        if prefix + ".var" not in state_dict:
            continue
        scope, _, bn_name = prefix.rpartition(".")
        eps = eps_of.get(prefix, BN_EPS)
        mean = state_dict[prefix + ".mean"].float()
        var = state_dict[prefix + ".var"].float()
        gamma = state_dict[prefix + ".scale"].float()
        beta = state_dict[prefix + ".bias"].float()
        scale = gamma * torch.rsqrt(var + eps)
        bias = beta - mean * scale
        out[prefix + ".mean"] = torch.zeros_like(mean)
        out[prefix + ".var"] = torch.full_like(var, 1.0 - eps)
        conv_name = _conv_name_for(bn_name)
        conv = (f"{scope}.{conv_name}" if scope else conv_name) \
            if conv_name else None
        if conv is None or conv + ".kernel" not in state_dict or (
                bn_name == "bn" and conv + ".bias" in state_dict):
            out[prefix + ".scale"], out[prefix + ".bias"] = scale, bias
            continue
        out[conv + ".kernel"] = state_dict[conv + ".kernel"].float() * scale
        out[prefix + ".scale"] = torch.ones_like(scale)
        if conv + ".bias" in state_dict:
            out[conv + ".bias"] = (state_dict[conv + ".bias"].float()
                                   * scale + bias)
            out[prefix + ".bias"] = torch.zeros_like(bias)
        else:
            out[prefix + ".bias"] = bias
    return out


def folded_copy(model):
    """A deep copy of ``model`` carrying :func:`fold_batch_norm` of its
    weights, each BN folded with its own epsilon."""
    folded = copy.deepcopy(model)
    folded.load_state_dict(fold_batch_norm(model.state_dict(),
                                           bn_eps(model)))
    return folded


# ----------------------------------------------------------------------
def _device(model):
    return next(model.parameters()).device


def calibrate_int8(model, sample_batches):
    """Static-scale int8 calibration: eval-mode forwards of ``model`` over
    ``sample_batches`` (NHWC f32 images, arrays or tensors), recording
    each ConvBN-with-BN input's max |x|. Returns the JAX package's tree,
    ``{"quant": {<flax path>: {"in_scale": max(absmax, 1e-6) / 127}}}``,
    with 0-dim f32 CPU tensors as leaves. ``model`` keeps its mode."""
    was_training = model.training
    device = _device(model)
    model.eval()
    try:
        with capture_input_absmax(model) as absmax, torch.inference_mode():
            seen = 0
            for xb in sample_batches:
                model(torch.as_tensor(xb, dtype=torch.float32,
                                      device=device))
                seen += 1
    finally:
        model.train(was_training)
    if not seen:
        raise ValueError("calibrate_int8 needs >= 1 sample batch")
    tree = {}
    for name, v in absmax.items():
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        top = torch.clamp(v.cpu(), min=1e-6)
        node["in_scale"] = top / torch.full_like(top, 127.0)
    return {"quant": tree}


def _in_scale(quant, name):
    """The ``in_scale`` leaf at qualified name ``name`` ("" is the root)
    of a ``{"quant": tree}`` scales tree, or None."""
    node = quant["quant"]
    for part in name.split(".") if name else ():
        if not hasattr(node, "get") or part not in node:
            return None
        node = node[part]
    return node.get("in_scale") if hasattr(node, "get") else None


def _serving_copy(module, quant, min_channels, name=""):
    """A copy of ``module``'s tree in eval mode that shares its
    parameters and buffers (no tensor is copied) and leaves ``module``
    as it was: every ConvBN with BN that ``quant`` calibrates and whose
    min(Ci, Co) >= ``min_channels`` becomes an :class:`Int8ConvBN`."""
    if quant and isinstance(module, ConvBN) and module.bn is not None:
        sx = _in_scale(quant, name)
        _, _, ci, co = module.conv.kernel.shape
        if sx is not None and min(ci, co) >= min_channels:
            return Int8ConvBN(module, sx).eval()
    new = copy.copy(module)
    new._parameters = module._parameters.copy()
    new._buffers = module._buffers.copy()
    new._modules = type(module._modules)(
        (child_name, _serving_copy(child, quant, min_channels,
                                   f"{name}.{child_name}" if name
                                   else child_name))
        for child_name, child in module._modules.items())
    new.training = False
    return new


class ServingProgram(torch.nn.Module):
    """The serving program as a module (what :func:`export_serving`
    captures): eval forward, decode, NMS. ``forward(images)`` takes NHWC
    f32 images and returns ``(rows, keep)``."""

    def __init__(self, model, class_num, threshold, nms_mode, nms_threshold,
                 nms_sigma, max_boxes, version=4):
        super().__init__()
        self.model = model
        self.class_num = class_num
        self.version = version
        self.threshold = threshold
        self.nms_mode = nms_mode
        self.nms_threshold = nms_threshold
        self.nms_sigma = nms_sigma
        self.max_boxes = max_boxes

    def forward(self, images):
        outs = self.model(images)
        rows, valid = decode_multi_level(
            outs if isinstance(outs, (list, tuple)) else [outs],
            class_num=self.class_num, threshold=self.threshold,
            max_boxes=self.max_boxes, version=self.version)
        return apply_nms_device(rows, valid, nms_mode=self.nms_mode,
                                nms_threshold=self.nms_threshold,
                                conf_threshold=self.threshold,
                                nms_sigma=self.nms_sigma,
                                plain=getattr(self.model, "plain", False))


def make_serving_fn(model, class_num, version=4, threshold=0.5, nms_mode=1,
                    nms_threshold=0.45, nms_sigma=0.5, max_boxes=128,
                    quant=None, int8_min_channels=0):
    """Return ``serve(images) -> (rows, keep)`` for NHWC f32 images:
    rows (N, max_boxes, 7) = [x, y, w, h, conf, class_idx, class_prob]
    and keep (N, max_boxes) bool, under ``torch.inference_mode()``.

    ``threshold`` is also the confidence under which Soft-NMS
    (``nms_mode=2``, decay ``nms_sigma``) drops a decayed box, as in the
    JAX version. The NMS takes the model's route: the kernel by default,
    the plain version after ``models.layers.use_plain_route(model)``.

    ``quant``: the scales tree of :func:`calibrate_int8` (or the JAX
    package's, with array leaves): every calibrated ConvBN with BN whose
    min(Ci, Co) >= ``int8_min_channels`` serves through the int8 kernel,
    its weights quantized here, once. The JAX package reads that gate
    from a global (``set_int8_min_channels``, default 0). The program
    runs on an eval-mode copy of the module tree that shares the
    model's tensors; ``model`` is left as it was. ``serve.program`` is
    that :class:`ServingProgram`.
    """
    if version not in (1, 2, 3, 4):
        raise ValueError(f"Invalid version: {version}")
    program = ServingProgram(
        _serving_copy(model, quant, int(int8_min_channels)), class_num,
        threshold, nms_mode, nms_threshold, nms_sigma, max_boxes,
        int(version))

    @torch.inference_mode()
    def serve(images):
        return program(images)

    serve.program = program
    return serve


# ----------------------------------------------------------------------
def _check_platforms(platforms):
    if platforms is not None:
        raise ValueError(
            "platforms is jax.export's lowering list; a torch.export "
            "program runs on the device it was exported on (the model's): "
            "pass platforms=None")


def export_serving(model, input_shape, batch_size, class_num, version,
                   fold_bn=True, platforms=None, **serving_kwargs):
    """Capture the serving program at a fixed ``(batch_size,
    *input_shape)`` f32 image shape with ``torch.export`` (weights inside,
    the kernels as custom ops) on the model's device, and return the
    ``torch.export.save`` bytes. ``platforms`` is the JAX package's
    lowering list; a program here runs where it was exported, so only
    ``None`` is taken."""
    _check_platforms(platforms)
    if fold_bn:
        model = folded_copy(model)
    program = make_serving_fn(model, class_num, version,
                              **serving_kwargs).program
    spec = torch.zeros((int(batch_size), *input_shape), dtype=torch.float32,
                       device=_device(model))
    with torch.no_grad():
        exported = torch.export.export(program, (spec,), strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def save_serving(path, model, input_shape, batch_size, class_num, version,
                 class_names=None, fold_bn=True, platforms=None,
                 **serving_kwargs):
    """Write a versioned serving container: :data:`MAGIC`, the header
    length (8 bytes, big-endian), a JSON header with the JAX package's
    keys (``framework`` is ``"tf2_yolo_tpu_torch"``; ``device`` added:
    where the programs run), then one :func:`export_serving` program per
    batch bucket. ``batch_size`` is an int or a list of ints; the loaded
    model dispatches each call to the smallest bucket that fits."""
    _check_platforms(platforms)
    buckets = sorted({int(b) for b in (
        batch_size if isinstance(batch_size, (list, tuple))
        else [batch_size])})
    if fold_bn:
        model = folded_copy(model)
    blobs = [export_serving(model, input_shape, b, class_num, version,
                            fold_bn=False, **serving_kwargs)
             for b in buckets]
    offsets, off = [], 0
    for blob in blobs:
        offsets.append(off)
        off += len(blob)
    meta = {
        "format": 1,
        "framework": "tf2_yolo_tpu_torch",
        "yolo_version": int(version),
        "input_shape": list(input_shape),
        "class_num": int(class_num),
        "class_names": list(class_names) if class_names else None,
        "fold_bn": bool(fold_bn),
        "platforms": None,
        # scalar knobs only; the int8 scales are inside the programs
        "serving": {k: (float(v) if isinstance(v, (int, float)) else v)
                    for k, v in serving_kwargs.items() if k != "quant"},
        "int8": serving_kwargs.get("quant") is not None,
        "device": _device(model).type,
        "buckets": [{"batch_size": b, "offset": o, "length": len(blob)}
                    for b, o, blob in zip(buckets, offsets, blobs)],
    }
    header = json.dumps(meta).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(header).to_bytes(8, "big"))
        f.write(header)
        for blob in blobs:
            f.write(blob)
    return path


class ServingModel:
    """A loaded serving artifact: callable ``(images) -> (rows, keep)``
    plus ``.meta`` (the saved header) and ``.batch_sizes``.

    Calls dispatch to the smallest batch bucket that fits, padding the
    tail batch with zeros and slicing the padding back off; inputs
    larger than the biggest bucket are processed in chunks of it."""

    def __init__(self, fns_by_batch, meta):
        self._fns = dict(sorted(fns_by_batch.items()))
        self.meta = meta

    @property
    def batch_sizes(self):
        return list(self._fns)

    @torch.inference_mode()
    def __call__(self, images):
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.meta["device"])
        n = images.shape[0]
        if n in self._fns:
            return self._fns[n](images)
        fit = [b for b in self.batch_sizes if b >= n]
        if fit:
            b = fit[0]
            padded = torch.cat([images, images.new_zeros(
                (b - n, *images.shape[1:]))])
            rows, keep = self._fns[b](padded)
            return rows[:n], keep[:n]
        b = self.batch_sizes[-1]
        parts = [self(images[lo:lo + b]) for lo in range(0, n, b)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))


def load_serving(path):
    """Load a serving artifact written by :func:`save_serving`. Returns a
    :class:`ServingModel`; no model-building code runs. A file of the
    JAX package (or anything without :data:`MAGIC`) raises
    ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JAX_MAGIC):
        raise ValueError(f"{path} is a serving artifact of the JAX "
                         "package (tf2_yolo_tpu.export.load_serving)")
    if not data.startswith(MAGIC):
        raise ValueError(f"{path} is not a tf2_yolo_tpu_torch serving "
                         "artifact")
    hlen = int.from_bytes(data[8:16], "big")
    meta = json.loads(data[16:16 + hlen].decode("utf-8"))
    body = data[16 + hlen:]
    fns = {}
    for bucket in meta["buckets"]:
        blob = body[bucket["offset"]:bucket["offset"] + bucket["length"]]
        fns[bucket["batch_size"]] = torch.export.load(
            io.BytesIO(blob)).module()
    return ServingModel(fns, meta)

