"""Building-block layers of YOLOv4 (NHWC), for serving and training.

Port of tf2_yolo_tpu/models/layers.py. Parameters keep the flax names
and layouts, so that :mod:`tf2_yolo_tpu_torch.bridge` maps a flax
variables tree onto a ``state_dict`` without per-layer rules:

- ``Conv``: ``kernel`` (k, k, Ci, Co) in HWIO, the flax layout (no
  transpose), and ``bias`` (Co,) where the conv has one;
- ``BNState``: parameters ``scale``, ``bias`` and buffers ``mean``,
  ``var`` (flax's ``params`` and ``batch_stats``), with the epsilon and
  momentum of its own layer;
- ``DepthwiseConv``: ``kernel`` (k, k, 1, C), flax's
  ``feature_group_count=C`` layout;
- ``Dense``: ``kernel`` (Ci, Co) and ``bias`` (Co,).

Every dense conv runs through ``conv_bn_stats``: the CUDA kernel on a
GPU tensor, its plain version on a CPU tensor. The keras-style backbones
(ResNet, MobileNetV2) pair a ``Conv`` with a ``BNState`` called on its
output (:func:`conv_then_bn`, flax's ``nn.Conv`` then ``nn.BatchNorm``);
MobileNetV2's depthwise convs are the library's grouped conv
(:func:`depthwise_conv`), as XLA computes them in the JAX package.
:func:`use_plain_route` sets one model to the plain version on any
device (the reference route).
Parameters stay f32; a module casts them to its compute ``dtype`` at
each call, as flax does. ``nn.Module.train()`` / ``.eval()`` select
batch or running statistics and the training or eval form of mish.
Modules are built on the card unless ``device`` says otherwise.

Deployment: :class:`Int8ConvBN` is the static-scale int8 form of an
eval-mode ConvBN (``ConvBN._quant_call`` of the JAX package), built by
``export.make_serving_fn(quant=...)``; :func:`capture_input_absmax` is
the calibration capture that ``export.calibrate_int8`` switches on.
Training: :func:`set_bn_stats_sg` sets the frozen-statistics BatchNorm
backward on one model's ConvBNs (``set_bn_stats_stop_gradient`` of the
JAX package, per model instead of process-global); :func:`set_bn_group`
takes one model's train-mode statistics over the processes of a process
group (the JAX package's ``bn_axis_name``); :func:`set_tensor_parallel`
slices one model's wide ConvBNs and head convs over the model axis of a
process grid (``parallel.mesh``), each then running Megatron-style
between the collectives of ``parallel.collectives``.
"""

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.conv_bn import _GEOMETRIES as INT8_GEOMETRIES
from ..ops.kernels.conv_bn import conv_bn_stats
from ..ops.kernels.conv_int8 import conv_int8, quantize_weights, \
    weight_layout
from ..ops.kernels.fused_gemm import act_and_grad
from ..parallel.collectives import (Shard, copy_to_model, gather_channels,
                                    record)

BN_EPS = 1e-3                  # tf.keras default, as the JAX package
BN_MOMENTUM = 0.99             # running = 0.99 running + 0.01 batch
RESNET_BN = dict(eps=1.001e-5, momentum=0.99)      # keras ResNet
MOBILENET_BN = dict(eps=1e-3, momentum=0.999)      # keras MobileNetV2
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


def glorot_uniform_(kernel, generator=None):
    """flax ``glorot_uniform`` (tf.keras's default, the init of the
    keras ResNet, MobileNetV2 and Dense layers): uniform in +-sqrt(6 /
    (r (fan_in + fan_out))) for a (..., fan_in, fan_out) kernel whose
    leading axes hold r taps."""
    *taps, fan_in, fan_out = kernel.shape
    r = math.prod(taps)
    limit = math.sqrt(6.0 / (r * (fan_in + fan_out)))
    return nn.init.uniform_(kernel, -limit, limit, generator=generator)


def mish_eval(x):
    """x * tanh(softplus(x)). torch's softplus returns x above its
    threshold of 20 and ``jax.nn.softplus`` has no threshold; the two
    differ there by log1p(exp(-x)) < 2.1e-9, which tanh maps to 1 in f32
    either way."""
    return x * torch.tanh(F.softplus(x))


class _MishTrain(torch.autograd.Function):
    """Training form of mish, x * (1 - 2 / ((1 + e^x)^2 + 1)) with the
    exponent clamped at 20 (beyond it the value is x exactly and the
    clamp keeps (1 + e^x)^2 finite), computed in x's dtype. Only x is
    saved; the backward recomputes the derivative in f32, where eager
    autograd through the chain would keep seven activation-sized
    tensors."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        u = torch.exp(torch.clamp(x, max=20.0))
        return x * (1.0 - 2.0 / ((1.0 + u) * (1.0 + u) + 1.0))

    @staticmethod
    def backward(ctx, dout):
        (x,) = ctx.saved_tensors
        return (dout.float() * act_and_grad(x.float(), "mish")[1]).to(
            x.dtype)


def mish(x):
    """Mish for training (see :class:`_MishTrain`); the same function as
    :func:`mish_eval`."""
    return _MishTrain.apply(x)


def leaky(x):
    return F.leaky_relu(x, negative_slope=0.1)


relu6 = F.relu6                # min(relu(x), 6): MobileNetV2's activation
ACTS = {"mish": mish, "leaky": leaky, "relu": F.relu,
        "linear": lambda x: x}
ACTS_EVAL = dict(ACTS, mish=mish_eval)


class Conv(nn.Module):
    """Conv parameters in the flax layout, run through ``conv_bn_stats``
    (1x1 s1, 3x3 s1 SAME, 3x3 s2 with the darknet pad, or with flax's SAME
    where ``padding`` is ``"same"``, 1x1 s2, 7x7 s2 and 2x2 s1 SAME; an
    int ``padding`` pads that much on every side, then VALID). Returns
    (y, s1, s2); the statistics are ``None`` unless ``want_stats``."""

    def __init__(self, ci, co, kernel, stride=1, use_bias=False,
                 dtype=torch.float32, init=he_normal_, generator=None,
                 device="cuda", padding="darknet"):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(kernel, kernel, ci, co, device=device))
        init(self.kernel, generator)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(co, device=device))
        else:
            self.register_parameter("bias", None)
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.plain = False
        self.tp = None               # set_tensor_parallel (a head conv)

    def forward(self, x, want_stats=False):
        dt = self.dtype
        if self.tp is not None:
            x = copy_to_model(x, self.tp)
        k = self.kernel.to(dt)
        b = (self.bias.to(dt) if self.bias is not None
             else torch.zeros(k.shape[-1], dtype=dt, device=k.device))
        y, s1, s2 = conv_bn_stats(x.to(dt).contiguous(), k, b, self.stride,
                                  want_stats, self.plain, self.padding)
        if self.tp is not None:
            y = gather_channels(y, self.tp)
        return y, s1, s2


class BNState(nn.Module):
    """BatchNorm parameters and running statistics (flax BatchNorm's
    ``scale``/``bias`` params and ``mean``/``var`` batch_stats), with the
    ``eps`` and ``momentum`` of its own layer (tf.keras's 1e-3 and 0.99
    by default; :data:`RESNET_BN`, :data:`MOBILENET_BN`).

    Called on y, ``bn(y, s1=None, s2=None)`` is flax's ``nn.BatchNorm``
    (the keras backbones' BN): in train mode the batch mean and the
    biased variance mean(y^2) - mean^2, clipped at 0 (``clip=False``:
    the JAX ConvBN's, unclipped), over N*H*W, from the conv kernel's
    sums ``s1``, ``s2`` where a K1 conv precedes (:func:`conv_then_bn`,
    ConvBN), else from an f32 reduction of y, over the processes of
    ``group`` where one is set (:func:`set_bn_group`); the running
    statistics are updated in place. In eval mode the running statistics normalise.
    (y - mean) * (rsqrt(var + eps) * scale) + bias is computed in f32
    and rounded once to y's dtype."""

    def __init__(self, features, device="cuda", eps=BN_EPS,
                 momentum=BN_MOMENTUM):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.eps = eps
        self.momentum = momentum
        self.group = None            # set_bn_group

    @torch.no_grad()
    def update_running(self, mean, var):
        """running = momentum running + (1 - momentum) batch, in place,
        with the biased batch variance as flax and tf.keras take it."""
        self.mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
        self.var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)

    def forward(self, y, s1=None, s2=None, clip=True):
        if self.training:
            count = y.numel() // y.shape[-1]
            if s1 is None:
                a = y.float()
                s1, s2 = a.mean(dim=(0, 1, 2)), (a * a).mean(dim=(0, 1, 2))
                if self.group is None:
                    count = 1
                else:                 # sums again, to add over processes
                    s1, s2 = s1 * count, s2 * count
            mean, var = batch_stats(s1, s2, count, clip, self.group)
            self.update_running(mean, var)
        else:
            mean, var = self.mean, self.var
        return ((y.float() - mean) * (torch.rsqrt(var + self.eps)
                                      * self.scale)
                + self.bias).to(y.dtype)


def conv_then_bn(conv, bn, x):
    """flax ``nn.Conv`` then ``nn.BatchNorm`` (the keras backbones'
    pair): ``bn(conv(x))``, the train-mode statistics taken from the conv
    kernel's sums of its rounded output."""
    y, s1, s2 = conv(x, want_stats=bn.training)
    return bn(y, s1, s2)


def depthwise_conv(x, kernel, stride):
    """flax ``nn.Conv(C, (k, k), stride, padding="SAME",
    feature_group_count=C, use_bias=False)`` on NHWC ``x`` with a (k, k,
    1, C) kernel, both in the compute dtype: the library's grouped conv
    (``F.conv2d(groups=C)``) on NCHW views, the SAME pad's larger half
    below and right. The JAX package runs it as an XLA conv outside any
    Pallas kernel; ``depthwise_conv.calls`` counts the calls."""
    k, c = kernel.shape[0], kernel.shape[-1]
    pads = []
    for size in (x.shape[2], x.shape[1]):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    xc = F.pad(x.permute(0, 3, 1, 2), pads)
    y = F.conv2d(xc, kernel.permute(3, 2, 0, 1), stride=stride, groups=c)
    depthwise_conv.calls += 1
    return y.permute(0, 2, 3, 1)


depthwise_conv.calls = 0


class DepthwiseConv(nn.Module):
    """A depthwise ``k`` x ``k`` SAME conv of ``channels`` channels
    without bias, its kernel (k, k, 1, C) in the flax layout
    (:func:`depthwise_conv`)."""

    def __init__(self, channels, kernel=3, stride=1, dtype=torch.float32,
                 init=glorot_uniform_, generator=None, device="cuda"):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(kernel, kernel, 1, channels, device=device))
        init(self.kernel, generator)
        self.stride = stride
        self.dtype = dtype

    def forward(self, x):
        return depthwise_conv(x.to(self.dtype), self.kernel.to(self.dtype),
                              self.stride)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` (Ci, Co) glorot-uniform, ``bias``
    zeros, x @ kernel + bias in the compute dtype (``F.linear``; the JAX
    package computes it outside any Pallas kernel)."""

    def __init__(self, ci, co, dtype=torch.float32, generator=None,
                 device="cuda"):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(ci, co, device=device))
        glorot_uniform_(self.kernel, generator)
        self.bias = nn.Parameter(torch.zeros(co, device=device))
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.kernel.to(dt).t(), self.bias.to(dt))


class ConvBN(nn.Module):
    """Conv (+ BatchNorm) + activation, the math of the JAX default
    route (``nn.BatchNorm``, which ``bench.py`` and ``make_serving_fn``
    take): y = conv(x) in the compute dtype, then its ``bn``
    (:class:`BNState`): (y - mean) * (rsqrt(var + eps) * scale) + bias in
    f32, rounded once to the compute dtype, then the activation in that
    dtype. In train mode mean = s1 / M and var = s2 / M - mean^2
    (unclipped) come from the conv kernel's sums over the M = N*H*W
    pixels (f32), the running statistics are updated in place, and mish
    takes its training form; in eval mode the running statistics
    normalise.
    ``use_bn=False`` gives a plain biased conv. ``use_bias`` (default
    ``not use_bn``) adds the conv bias before BN, as every v1/v2 ConvBN
    has; ``darknet_pad=False`` takes flax's SAME at stride 2 (the v1/v2
    convs) instead of the darknet top/left pad.

    ``bn_sg`` (default False; :func:`set_bn_stats_sg`) takes the JAX
    package's frozen-statistics route in train mode (``_sg_batch_norm``):
    the same batch statistics, detached, so the backward drops their
    term, and the normalisation in the compute dtype,
    (y - mean) * (scale * rsqrt(var + eps)) + bias with each operand
    cast to it first."""

    def __init__(self, ci, features, kernel=3, stride=1, act="leaky",
                 use_bn=True, dtype=torch.float32, init=he_normal_,
                 generator=None, device="cuda", use_bias=None,
                 darknet_pad=True):
        super().__init__()
        if act not in ACTS:
            raise ValueError(f"unknown activation {act!r}")
        if use_bias is None:
            use_bias = not use_bn
        self.conv = Conv(ci, features, kernel, stride, use_bias, dtype,
                         init, generator, device,
                         "darknet" if darknet_pad else "same")
        self.bn = BNState(features, device) if use_bn else None
        self.act = act
        self.dtype = dtype
        self.bn_sg = False
        self.tp = None               # set_tensor_parallel

    def forward(self, x):
        if self.tp is None:
            return self._forward(x)
        # Megatron's f, the layer on this process's channels, then g
        return gather_channels(self._forward(copy_to_model(x, self.tp)),
                               self.tp)

    def _forward(self, x):
        bn = self.bn
        train = self.training and bn is not None
        y, s1, s2 = self.conv(x, want_stats=train)
        if train and self.bn_sg:
            mean, var = batch_stats(s1, s2, y.numel() // y.shape[-1],
                                    group=bn.group)
            bn.update_running(mean, var)
            mean, var = mean.detach(), var.detach()
            dt = self.dtype
            mul = (bn.scale * torch.rsqrt(var + bn.eps)).to(dt)
            y = (y - mean.to(dt)) * mul + bn.bias.to(dt)
            return ACTS[self.act](y)
        if bn is not None:
            # the JAX ConvBN's variance s2 / M - mean^2 is not clipped
            y = bn(y, s1, s2, clip=False)
        return (ACTS if self.training else ACTS_EVAL)[self.act](y)


def set_bn_stats_sg(model, on, scope=None):
    """Set the frozen-statistics BatchNorm backward on ``model``'s
    ConvBNs (their ``bn_sg``): on all of them when ``on`` and ``scope``
    is None, else on those whose qualified name has a component equal to
    ``scope`` (a name, or any of a sequence of names): ``"backbone"``
    takes ``backbone.stage1.down`` and not ``backbone_neck.conv``, as the
    JAX package tests ``s in self.path``. ``on=False`` clears it
    everywhere. The packed regions (``packed=True`` / ``3`` in train
    mode) read their ConvBNs' parameters without calling them and keep
    exact BatchNorm, as the JAX package's do. Returns ``model``."""
    if scope is not None:
        scope = (scope,) if isinstance(scope, str) else tuple(scope)
    for name, m in model.named_modules():
        if isinstance(m, ConvBN):
            m.bn_sg = bool(on) and (
                scope is None or any(s in name.split(".") for s in scope))
    return model


class Int8ConvBN(nn.Module):
    """The static-scale int8 form of an eval-mode ConvBN with BN (the
    JAX package's ``ConvBN._quant_call``), for serving only.

    Built once from ``convbn`` and its calibrated input scale ``sx``:
    the weights are quantized per output channel
    (:func:`~tf2_yolo_tpu_torch.ops.kernels.conv_int8.quantize_weights`)
    into the kernel's layout, and dequantisation, BN (running
    statistics) and bias collapse into one f32 affine, c = (sx * sw) *
    s_bn and t = bias - mean * s_bn (+ b * s_bn where the conv has a bias
    b) with s_bn = scale * rsqrt(var + eps). ``forward`` quantizes its
    input as it comes (the image at the stem) and runs ``conv_int8``,
    whose output is rounded once to the ConvBN's dtype; the activation
    (eval form) runs in that dtype. ``plain`` follows
    ``use_plain_route``. Q takes the ConvBN's geometry and padding as
    they are (the darknet 3x3 stride-2 pad, or flax's SAME: YOLOv1.5's
    7x7 stride-2 stem and 3x3 stride 2), as the JAX ``_quant_call``
    does (:func:`int8_geometry_ok`)."""

    def __init__(self, convbn, sx):
        super().__init__()
        if convbn.bn is None:
            raise ValueError("Int8ConvBN needs a ConvBN with BatchNorm")
        if not int8_geometry_ok(convbn):
            k = convbn.conv.kernel.shape[0]
            raise ValueError(
                f"int8 conv {k}x{k} stride {convbn.conv.stride} "
                f"(padding {convbn.conv.padding!r}): not a ConvBN geometry")
        kernel = convbn.conv.kernel
        wq, sw = quantize_weights(kernel)
        bn = convbn.bn
        with torch.no_grad():
            sx_t = torch.as_tensor(float(sx), dtype=torch.float32,
                                   device=kernel.device)
            s_bn = bn.scale * torch.rsqrt(bn.var + bn.eps)
            self.register_buffer("wq", weight_layout(wq))
            self.register_buffer("c", ((sx_t * sw) * s_bn).contiguous())
            t = bn.bias - bn.mean * s_bn
            if convbn.conv.bias is not None:
                # the JAX package adds b * s_bn to the f32 sum after the
                # affine; here it rides in t
                t = t + convbn.conv.bias * s_bn
            self.register_buffer("t", t.contiguous())
        self.sx = float(sx_t)
        self.ksize = kernel.shape[0]
        self.stride = convbn.conv.stride
        self.padding = convbn.conv.padding
        self.act = convbn.act
        self.dtype = convbn.dtype
        self.plain = convbn.conv.plain

    def forward(self, x):
        y = conv_int8(x.contiguous(), self.wq, self.c, self.t, self.sx,
                      self.ksize, self.stride, self.dtype, self.plain,
                      self.padding)
        return ACTS_EVAL[self.act](y)


def int8_geometry_ok(convbn):
    """Whether kernel Q takes ``convbn``'s geometry: every ConvBN's, as
    the JAX ``_quant_call`` quantizes every ConvBN: a conv geometry of K1
    (``conv_bn.conv_geometry``) with the darknet pad (SAME at stride 1,
    the darknet pad for 3x3 stride 2) or flax's SAME (YOLOv1.5's 7x7
    stride-2 stem and 3x3 stride 2, the 2x2 of a ConvBN)."""
    k, stride = convbn.conv.kernel.shape[0], convbn.conv.stride
    padding = convbn.conv.padding
    if (k, stride) not in INT8_GEOMETRIES:
        return False
    return padding == "same" or (padding == "darknet"
                                 and (stride == 1 or k == 3))


@contextlib.contextmanager
def capture_input_absmax(model):
    """The calibration capture (the JAX ConvBN's ``sow("quant_calib",
    "in_absmax", max|x|)``): inside the block, every eval-mode forward of
    a ConvBN with BN records the running maximum of |x| over its inputs,
    x as it comes, into the yielded ``{qualified name: f32 tensor}``.
    Nothing is captured outside the block or in train mode."""
    absmax = {}

    def capture(module, args, name):
        if not module.training:
            v = args[0].detach().abs().amax().float()
            prev = absmax.get(name)
            absmax[name] = v if prev is None else torch.maximum(prev, v)

    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: capture(mod, args, name))
        for name, m in model.named_modules()
        if isinstance(m, ConvBN) and m.bn is not None]
    try:
        yield absmax
    finally:
        for h in hooks:
            h.remove()


def set_bn_group(model, group):
    """Take the train-mode BatchNorm statistics of ``model`` over the
    processes of ``group`` (a ``torch.distributed`` process group; None
    takes them over this process's batch): every BNState of the model,
    those of the packed regions' ConvBNs included, adds its sums over the
    group before it divides (the JAX package's
    ``bn_axis_name``: ``psum`` of the sums in ConvBN, ``pmean`` in the
    frozen-statistics route; :func:`batch_stats`). Every process then
    holds the same mean and variance, and the same running statistics.
    Per model, as :func:`set_bn_stats_sg`; returns ``model``."""
    for m in model.modules():
        if isinstance(m, BNState):
            m.group = group
    return model


_TP_NOT_PORTED = ("is not ported yet (ROADMAP.md, queue 1, item 9: "
                  "parallel)")


def _tp_units(model, plan):
    """The layers that ``plan`` slices: ``{module name: (module, {leaf:
    dim})}``, a ConvBN with its conv's and BN's leaves, or a conv alone
    (the biased head convs, whose consumers read the gathered output).
    Raises NotImplementedError for a sliced leaf of any other layer."""
    modules = dict(model.named_modules())
    units = {}
    for key, dim in plan.items():
        if dim is None:
            continue
        path, _, leaf = key.rpartition(".")
        owner = modules[path]
        parent_path = path.rpartition(".")[0]
        parent = modules[parent_path]
        if isinstance(owner, (Conv, BNState)) and isinstance(parent, ConvBN):
            unit, name = parent, parent_path
            leaf = f"{path[len(parent_path):].lstrip('.')}.{leaf}"
        elif isinstance(owner, Conv) and not isinstance(parent, ConvActBN):
            unit, name = owner, path
        else:
            what = (f"{type(parent).__name__} ({parent_path})"
                    if isinstance(parent, ConvActBN)
                    else f"{type(owner).__name__} ({path}; a keras conv "
                         "+ BatchNorm pair or a depthwise or dense layer)")
            raise NotImplementedError(
                f"tensor parallelism of {what} {_TP_NOT_PORTED}")
        units.setdefault(name, (unit, {}))[1][leaf] = dim
    for name, (unit, leaves) in units.items():
        want = {k for k, _ in unit.named_parameters()} | {
            k for k, _ in unit.named_buffers()}
        if set(leaves) != want:
            raise ValueError(f"the plan slices {sorted(leaves)} of {name} "
                             f"but not {sorted(want - set(leaves))}")
    return units


def set_tensor_parallel(model, mesh, plan):
    """Slice ``model`` over the model axis of ``mesh`` by ``plan``
    (``parallel.tensor_parallel_shardings``: ``{state_dict name: dim or
    None}``): each planned ConvBN and head conv keeps only this process's
    ``Co / n_model`` output channels of its kernel, bias, BN scale and
    bias and running statistics (the rest is freed: the memory per card
    falls) and runs Megatron-style, ``parallel.collectives``: f (the
    input's cotangent summed over the model group in the backward), the
    conv kernel on the weight slice, BN and the activation on the
    channel slice, then g (the slices gathered on the channel axis), so
    that every consumer sees the full tensor. The BN sums of a slice are
    taken over the group of :func:`set_bn_group` (the mesh's data
    group). Everything else stays whole and is computed alike in every
    process of the model group. Per model, as :func:`set_bn_group`; the
    sliced entries are kept as ``model.tensor_parallel = (Shard,
    {name: dim})`` (``collectives.gather_state_dict``). Returns
    ``model``.

    Raises ValueError for a ``packed`` model (its fused routes are
    single-device, in the JAX package too) and NotImplementedError for a
    sliced leaf outside a ConvBN or a head conv (the keras backbones'
    conv + BatchNorm pairs, depthwise and dense layers, ConvActBN)."""
    n = mesh.shape["model"]
    if n == 1:
        return model
    if getattr(model, "tensor_parallel", None) is not None:
        raise ValueError("the model is sliced already")
    if any(getattr(m, "packed", False) for m in model.modules()):
        raise ValueError("a packed model's fused routes are single-device: "
                         "tensor parallelism needs packed=False")
    units = _tp_units(model, plan)
    shard = Shard(mesh.model_group, n, mesh.model_index)
    dims = {}
    with torch.no_grad():
        for name, (unit, leaves) in units.items():
            for leaf, dim in leaves.items():
                path, _, attr = leaf.rpartition(".")
                mod = unit.get_submodule(path) if path else unit
                t = getattr(mod, attr)
                part = shard.slice(t, dim).clone()
                if isinstance(t, nn.Parameter):
                    t.data = part
                else:
                    mod._buffers[attr] = part
                dims[f"{name}.{leaf}" if name else leaf] = dim
            unit.tp = shard
    model.tensor_parallel = (shard, dims)
    return model


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group, whose backward is the sum of the
    cotangents over the group (the transpose of ``psum`` is ``psum``)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        record("all_reduce", group, None, out.numel())
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, dout):
        return _AllReduceSum.apply(dout.contiguous(), ctx.group), None


def _all_reduce(t, group):
    """The sum of ``t`` over ``group``, differentiable, so that each
    process's gradient carries every process's loss through the shared
    statistics. An in-place ``all_reduce`` would give the same forward
    and drop the other processes' cotangents."""
    return _AllReduceSum.apply(t, group)


def batch_stats(s1, s2, count, clip=False, group=None):
    """Batch mean and biased variance from the sums of y and y^2 over
    ``count`` values per channel (f32): s2 / count - mean^2, clipped at
    0 where ``clip`` (flax's ``nn.BatchNorm``; the JAX ConvBN does not
    clip). With a process ``group``, s1 and s2 are first summed over its
    processes in one all-reduce (:func:`_all_reduce`) and the count is
    ``count`` times the group's size, so the statistics are those of the
    global batch: every process holds as many rows (``Model.fit`` checks
    it; the JAX ConvBN multiplies by ``axis_size`` the same way). The
    count stays a host number, so that the division is the same
    operation as without a group (on the card, PyTorch multiplies by
    the reciprocal of a host divisor and divides by a tensor one)."""
    if group is not None:
        n = s1.shape[0]
        sums = _all_reduce(torch.cat([s1, s2]), group)
        s1, s2 = sums[:n], sums[n:]
        count = count * torch.distributed.get_world_size(group)
    mean = s1 / count
    var = s2 / count - mean * mean
    return mean, (torch.clamp(var, min=0.0) if clip else var)


class ConvActBN(nn.Module):
    """Conv -> activation -> BatchNorm, the v2 UNet block
    (``ConvActBN`` of the JAX package): a biased SAME conv (HE_NORMAL)
    whose output is activated in the compute dtype and then normalised,
    in f32 with one rounding, by the batch statistics of the activated
    tensor in train mode (flax's: f32 mean and mean square, the variance
    clipped at 0; the running statistics updated in place) or the running
    ones in eval mode. The conv runs without its statistics: they would
    be those of the tensor before the activation."""

    def __init__(self, ci, features, kernel=3, act="relu",
                 dtype=torch.float32, generator=None, device="cuda"):
        super().__init__()
        if act not in ACTS:
            raise ValueError(f"unknown activation {act!r}")
        self.conv = Conv(ci, features, kernel, 1, True, dtype, he_normal_,
                         generator, device, padding="same")
        self.bn = BNState(features, device)
        self.act = act
        self.dtype = dtype

    def forward(self, x):
        y, _, _ = self.conv(x)
        return self.bn(ACTS[self.act](y).float()).to(self.dtype)


def max_pool(x, window=2, stride=None, padding="VALID"):
    """flax ``nn.max_pool`` on NHWC with a square ``window`` and
    ``stride`` (default: the window): ``"VALID"``, or ``"SAME"``, whose
    pad of max((ceil(H/s) - 1) s + window - H, 0) is -inf, the smaller
    half on top and left (``F.max_pool2d``'s ``padding`` is symmetric and
    cannot say that)."""
    stride = stride or window
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        h, wd = x.shape[1:3]
        pads = []
        for size in (wd, h):
            total = max((-(-size // stride) - 1) * stride + window - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            xc = F.pad(xc, pads, value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}: 'VALID' or 'SAME'")
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


def space_to_depth(x, block=2):
    """NHWC space-to-depth in ``tf.nn.space_to_depth``'s channel order
    (the v2 passthrough): (N, H, W, C) -> (N, H/b, W/b, b*b*C), channel
    (dy * b + dx) * C + c."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        n, h // block, w // block, block * block * c)


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
    """Route one model's convs and fused GEMMs (and, through
    ``make_serving_fn``, its NMS) to the plain PyTorch versions on any
    device. The default on a GPU is the CUDA kernels; this is the
    reference route they are checked against."""
    for m in model.modules():
        if hasattr(m, "plain"):
            m.plain = True
    return model
