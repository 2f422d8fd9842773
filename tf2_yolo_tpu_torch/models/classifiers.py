"""The classifier functions: ``darknet``, ``darknet19``, ``darknet53``
and ``csp_darknet53``.

Port of tf2_yolo_tpu/models/classifiers.py. Each returns an
``engine.Model`` (predict, save_weights, load_weights) of a
:class:`~.backbones.Classifier` on its darknet body, or with
``include_top=False`` of the body alone (:class:`_FeatureOnly`, its last
stage's output). A named weight set ("imagenet") resolves through the
local weight cache (``facade_base.resolve_pretrained``): with no file
there it warns and the random init stays, as in the JAX package. The
port's functions also take ``seed`` (the init is drawn from a
``torch.Generator``), ``dtype`` (the compute dtype, default f32) and
``device`` (the card unless told "cpu").
"""

import torch
from torch import nn

from .backbones import (CSPDarknet53, Classifier, Darknet19, Darknet53,
                        DarknetV1)

_BODIES = {"darknet53": Darknet53, "csp_darknet53": CSPDarknet53}


def _kw(seed, dtype, device):
    return dict(dtype=dtype or torch.float32, device=device,
                generator=torch.Generator(device=device).manual_seed(
                    int(seed)))


class _FeatureOnly(nn.Module):
    """A darknet body alone (``include_top=False``): its last stage's
    output."""

    def __init__(self, kind="darknet53", **kw):
        super().__init__()
        self.backbone = _BODIES[kind](**kw)

    def forward(self, x):
        out = self.backbone(x)
        return out[-1] if isinstance(out, tuple) else out


def _model(module, input_shape, weights, kind, device):
    # engine imports the models package: imported here, not at the top
    from ..engine import Model
    from ..facade_base import resolve_pretrained

    model = Model(module, input_shape, device=device)
    resolved = resolve_pretrained(weights, kind)
    if resolved is not None:
        model.load_weights(resolved)
    return model


def _classifier(body, input_shape, class_num, kw, conv_head=False,
                weights=None, kind="classifier"):
    return _model(Classifier(body(**kw), class_num, conv_head, **kw),
                  input_shape, weights, kind, kw["device"])


def _feature_model(kind, input_shape, weights, kw):
    return _model(_FeatureOnly(kind, **kw), input_shape, weights,
                  f"{kind}_notop", kw["device"])


def _validate_imagenet(include_top, weights, input_shape, class_num):
    if include_top and weights == "imagenet":
        if (input_shape[0] % 32 or input_shape[1] % 32
                or input_shape[2] != 3):
            raise ValueError(
                "When setting `include_top=True` and loading "
                "`imagenet` weights, `input_shape` should be "
                "(32x, 32x, 3).")
        if class_num != 1000:
            raise ValueError(
                "If using `weights` as `'imagenet'` with "
                "`include_top` as true, `class_num` should be 1000")


def darknet(input_shape=(224, 224, 3), class_num=10, weights=None, seed=0,
            dtype=None, device="cuda"):
    """DarkNet-v1 classifier (GAP + softmax Dense)."""
    return _classifier(DarknetV1, input_shape, class_num,
                       _kw(seed, dtype, device), weights=weights,
                       kind="darknet")


def darknet19(input_shape=(416, 416, 3), class_num=10, weights=None,
              seed=0, dtype=None, device="cuda"):
    """DarkNet-19 classifier (1x1 conv head + GAP + softmax)."""
    return _classifier(Darknet19, input_shape, class_num,
                       _kw(seed, dtype, device), conv_head=True,
                       weights=weights, kind="darknet19")


def darknet53(include_top=True, weights="imagenet",
              input_shape=(448, 448, 3), class_num=1000, seed=0,
              dtype=None, device="cuda"):
    """Darknet-53 classifier; ``include_top=False`` gives the backbone
    feature model."""
    _validate_imagenet(include_top, weights, input_shape, class_num)
    kw = _kw(seed, dtype, device)
    if include_top:
        return _classifier(Darknet53, input_shape, class_num, kw,
                           weights=weights, kind="darknet53")
    return _feature_model("darknet53", input_shape, weights, kw)


def csp_darknet53(include_top=True, weights="imagenet",
                  input_shape=(448, 448, 3), class_num=1000, seed=0,
                  dtype=None, device="cuda"):
    """CSPDarknet-53 classifier; ``include_top=False`` gives the backbone
    feature model."""
    _validate_imagenet(include_top, weights, input_shape, class_num)
    kw = _kw(seed, dtype, device)
    if include_top:
        return _classifier(CSPDarknet53, input_shape, class_num, kw,
                           weights=weights, kind="csp_darknet53")
    return _feature_model("csp_darknet53", input_shape, weights, kw)
