"""Building-block layers for the YOLOv4 serving path (eval mode, NHWC).

Port of tf2_yolo_tpu/models/layers.py. Parameters keep the flax names
and layouts, so that :mod:`tf2_yolo_tpu_torch.bridge` maps a flax
variables tree onto a ``state_dict`` without per-layer rules:

- ``Conv``: ``kernel`` (k, k, Ci, Co) in HWIO, the flax layout (no
  transpose), and ``bias`` (Co,) where the conv has one;
- ``BNState``: parameters ``scale``, ``bias`` and buffers ``mean``,
  ``var`` (flax's ``params`` and ``batch_stats``).

Every conv runs through ``conv_bn_stats``: the CUDA kernel on a GPU
tensor, its plain version on a CPU tensor. :func:`use_plain_route` sets
one model to the plain version on any device (the reference route).
Parameters stay f32; a module casts them to its compute ``dtype`` at
each call, as flax does.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.conv_bn import conv_bn_stats, conv_bn_stats_plain

BN_EPS = 1e-3                  # tf.keras default, as the JAX package
# std of a unit normal truncated to [-2, 2] (flax/keras variance_scaling)
_TRUNC_STD = 0.87962566103423978


def he_normal_(kernel, generator=None):
    """flax ``he_normal`` on an HWIO kernel: a normal truncated at two
    standard deviations, scaled so its variance is 2 / fan_in, with
    fan_in = k * k * Ci."""
    kh, kw, ci, _ = kernel.shape
    std = math.sqrt(2.0 / (kh * kw * ci)) / _TRUNC_STD
    return nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def darknet_normal_(kernel, generator=None):
    """RandomNormal(0, 0.02), the init of every v4 DarknetConv2D."""
    return nn.init.normal_(kernel, 0.0, 0.02, generator=generator)


def mish_eval(x):
    """x * tanh(softplus(x)). torch's softplus returns x above its
    threshold of 20 and ``jax.nn.softplus`` has no threshold; the two
    differ there by log1p(exp(-x)) < 2.1e-9, which tanh maps to 1 in f32
    either way."""
    return x * torch.tanh(F.softplus(x))


def leaky(x):
    return F.leaky_relu(x, negative_slope=0.1)


ACTS = {"mish": mish_eval, "leaky": leaky, "linear": lambda x: x}


class Conv(nn.Module):
    """Conv parameters in the flax layout, run through ``conv_bn_stats``
    (1x1 s1, 3x3 s1 SAME, 3x3 s2 darknet pad) without the statistics,
    which eval mode does not use. Returns (y, None, None)."""

    def __init__(self, ci, co, kernel, stride=1, use_bias=False,
                 dtype=torch.float32, init=he_normal_, generator=None,
                 device=None):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(kernel, kernel, ci, co, device=device))
        init(self.kernel, generator)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(co, device=device))
        else:
            self.register_parameter("bias", None)
        self.stride = stride
        self.dtype = dtype
        self.plain = False

    def forward(self, x):
        dt = self.dtype
        k = self.kernel.to(dt)
        b = (self.bias.to(dt) if self.bias is not None
             else torch.zeros(k.shape[-1], dtype=dt, device=k.device))
        fn = conv_bn_stats_plain if self.plain else conv_bn_stats
        return fn(x.to(dt).contiguous(), k, b, self.stride, False)


class BNState(nn.Module):
    """BatchNorm parameters and running statistics (flax BatchNorm's
    ``scale``/``bias`` params and ``mean``/``var`` batch_stats)."""

    def __init__(self, features, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))


class ConvBN(nn.Module):
    """Conv (+ eval-mode BatchNorm) + activation, the math of the JAX
    fused path: y = conv(x) in the compute dtype, then
    (y - mean) * rsqrt(var + 1e-3) * scale + bias in that dtype, then the
    activation. ``use_bn=False`` gives a plain biased conv."""

    def __init__(self, ci, features, kernel=3, stride=1, act="leaky",
                 use_bn=True, dtype=torch.float32, init=he_normal_,
                 generator=None, device=None):
        super().__init__()
        if act not in ACTS:
            raise ValueError(f"unknown activation {act!r}")
        self.conv = Conv(ci, features, kernel, stride, not use_bn, dtype,
                         init, generator, device)
        self.bn = BNState(features, device) if use_bn else None
        self.act = act
        self.dtype = dtype

    def forward(self, x):
        y, _, _ = self.conv(x)
        if self.bn is not None:
            dt = self.dtype
            bn = self.bn
            y = ((y - bn.mean.to(dt)) * torch.rsqrt(bn.var.to(dt) + BN_EPS)
                 * bn.scale.to(dt) + bn.bias.to(dt))
        return ACTS[self.act](y)


def upsample2x(x):
    """Nearest-neighbour 2x upsample of an NHWC tensor."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


def spp(x):
    """Spatial pyramid pooling on NHWC: stride-1 SAME max pools of 13, 9
    and 5 computed as a cascade of 5x5 pools (a 5x5 max of 5x5 maxes
    covers 9x9, a third covers 13x13; max padding is -inf), concatenated
    as [p13, p9, p5, x]."""
    xc = x.permute(0, 3, 1, 2)
    p5 = F.max_pool2d(xc, 5, stride=1, padding=2)
    p9 = F.max_pool2d(p5, 5, stride=1, padding=2)
    p13 = F.max_pool2d(p9, 5, stride=1, padding=2)
    out = torch.cat([p13, p9, p5, xc], dim=1)
    return out.permute(0, 2, 3, 1).contiguous()


def use_plain_route(model):
    """Route one model's convs (and, through ``make_serving_fn``, its
    NMS) to the plain PyTorch versions on any device. The default on a
    GPU is the CUDA kernels; this is the reference route they are
    checked against."""
    for m in model.modules():
        if hasattr(m, "plain"):
            m.plain = True
    return model
