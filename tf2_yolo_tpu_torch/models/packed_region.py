"""Fused-GEMM execution of the CSPDarknet-53 stages (train mode).

Port of the unpacked (p = 1) part of tf2_yolo_tpu/models/packed_region.py.
In this route every 1x1 ConvBN of a CSP stage is one ``fused_gemm`` call:
the producer's BatchNorm affine + mish is applied in the consumer's input
read (the prologue), the raw output's channel sums come out of the
epilogue, and a channel concat is read as two operands without being
stored. In :func:`packed_stage` (stages 3-5) the 3x3 and stride-2 convs
stay ``conv_bn_stats`` calls on explicitly activated tensors. In
:func:`p3_stage` (stages 1-2 of ``packed=3``) they are ``fused_conv3x3``
calls with the same prologue and epilogue, and the residual chain is a
list of (raw output, affine) terms that the next sum-GEMM reads, so that
nothing but raw conv outputs is stored between kernels: no normalise, no
activation pass, no residual add, no concat.

The functions here are forward routes over the SAME submodules as the
plain path (``CSPStage`` / ``CSPResBlock`` / ``ConvBN``): they read
``convbn.conv.kernel`` and ``convbn.bn`` and add no parameters, so
weights, the bridge and the eval path are untouched. The JAX classes map
to them as ``PackedConvBN3x3`` -> :func:`packed_conv3x3`,
``PackedGemmConvBN`` -> :func:`packed_gemm_convbn`,
``PackedCSPResBlock`` -> :func:`packed_res_block`, ``PackedCSPStage`` ->
:func:`packed_stage`, ``PackedPallasConvBN3x3`` ->
:func:`fused_conv3x3_convbn`, ``P3CSPResBlock`` -> :func:`p3_res_block`,
``P3CSPStage`` -> :func:`p3_stage`.

Rows. The GEMM operands are 2D row matrices [M, C]. The JAX package
orders rows (h, w, b)-major to match a layout XLA assigns on the TPU; on
the card a row matrix is the (b, h, w)-major ``reshape`` of the
contiguous NHWC tensor, a view that costs no copy. Row order changes
nothing in the math (sums over rows, per-row products).

Not ported (TPU machinery): batch-into-lanes packing (``pack_batch``,
``unpack_batch``, ``_block_diag``, ``rows_of_packed``,
``rows_to_unpacked``, the p > 1 tiling in ``bn_affine``, the ``p_down``
branch of ``P3CSPStage`` that runs its down conv at a higher packing
factor; p = 1 throughout), the ``im2col`` flag of
``PackedPallasConvBN3x3``. The cross-replica ``axis_name`` branch of
``_fold_stats`` is the ``group`` of each ConvBN's BNState
(``layers.set_bn_group``).
"""

import torch

from ..ops.kernels.fused_conv3x3 import fused_conv3x3
from ..ops.kernels.fused_gemm import act_and_grad, fused_gemm
from .layers import BN_EPS, batch_stats


def bn_affine(mean, var, scale, bias):
    """Fold BN (normalize, scale, shift) into one per-channel affine
    (a, b), f32."""
    a = scale * torch.rsqrt(var + BN_EPS)
    return a, bias - mean * a


class _Activate(torch.autograd.Function):
    """act(y * a + b) in f32, cast to ``dtype``. Saves (y, a, b) only and
    recomputes the chain in the backward (the JAX package wraps it in
    ``jax.checkpoint`` for the same reason): eager autograd through the
    mish chain would keep four activation-sized f32 tensors per call."""

    @staticmethod
    def forward(ctx, y, a, b, act, dtype):
        ctx.save_for_backward(y, a, b)
        ctx.act = act
        return act_and_grad(y.float() * a + b, act)[0].to(dtype)

    @staticmethod
    def backward(ctx, dout):
        y, a, b = ctx.saved_tensors
        yf = y.float()
        dz = dout.float() * act_and_grad(yf * a + b, ctx.act)[1]
        lead = tuple(range(y.dim() - 1))
        return ((dz * a).to(y.dtype), (dz * yf).sum(dim=lead),
                dz.sum(dim=lead), None, None)


def activate(y, affine, act, dtype):
    """Materialize normalize + activation for consumers that cannot fuse
    the prologue (3x3 convs, residual adds): f32 math, cast to the
    compute dtype, the same semantics as the fused prologue."""
    a, b = affine
    return _Activate.apply(y, a.reshape(-1), b.reshape(-1), act, dtype)


def rows_of(y4):
    """[B, H, W, C] -> [B*H*W, C] rows, a view of the NHWC tensor."""
    return y4.reshape(-1, y4.shape[-1])


def rows_to(y2, b, h, w):
    """Inverse of :func:`rows_of`."""
    return y2.reshape(b, h, w, y2.shape[-1])


def _fold_stats(bn, s1, s2, count):
    """Batch statistics from the sums (over the processes of
    ``bn.group`` where one is set), the running-statistics update, and
    the affine for this layer's consumers."""
    mean, var = batch_stats(s1, s2, count, group=bn.group)
    bn.update_running(mean, var)
    return bn_affine(mean, var, bn.scale, bn.bias)


def packed_conv3x3(convbn, x_act4):
    """3x3 (or stride-2 darknet-pad) ConvBN on an ACTIVATED NHWC tensor.
    Returns (raw conv output, BN affine for its consumers)."""
    y, s1, s2 = convbn.conv(x_act4, want_stats=True)
    return y, _fold_stats(convbn.bn, s1, s2, y.numel() // y.shape[-1])


def packed_gemm_convbn(convbn, inputs, sum_inputs=False):
    """1x1 ConvBN as the fused GEMM. ``inputs`` is a list of
    (x2d [M, Ci], affine-or-None) pairs: a raw producer output brings its
    producer's affine, which is applied with mish in this layer's input
    read; an activated tensor brings ``None``. Returns (raw y2d, consumer
    affine). The mish passed to the kernel is the PRODUCERS' activation
    (every caller's producers are mish layers), as ``act_in`` of the JAX
    ``PackedPallasConvBN3x3`` is; this layer's own activation is its
    consumer's business.

    Several inputs mean a channel concat (the [Cin, Co] kernel is split
    along Cin per operand) or, with ``sum_inputs``, a sum over the full
    kernel: y = (sum_i g_i(x_i)) @ w, a residual chain consumed without
    materializing the adds."""
    w = convbn.conv.kernel[0, 0]
    ws, offset = [], 0
    for x, _ in inputs:
        if sum_inputs:
            ws.append(w)
        else:
            ws.append(w[offset:offset + x.shape[-1]])
            offset += x.shape[-1]
    if not sum_inputs and offset != w.shape[0]:
        raise ValueError(f"inputs carry {offset} channels, the kernel "
                         f"takes {w.shape[0]}")
    y, s1, s2 = fused_gemm([x for x, _ in inputs], ws,
                           [a for _, a in inputs], act="mish",
                           dtype=convbn.dtype, plain=convbn.conv.plain)
    return y, _fold_stats(convbn.bn, s1, s2, y.shape[0])


def packed_res_block(block, x_act, spatial):
    """CSP residual module on rows. Takes the block input as an ACTIVATED
    2D tensor and returns the activated output (the residual add needs
    both materialized)."""
    b, h, w = spatial
    dt = block.squeeze.dtype
    sq_y, sq_aff = packed_gemm_convbn(block.squeeze, [(x_act, None)])
    sq_act = activate(sq_y, sq_aff, "mish", dt)
    ex_y, ex_aff = packed_conv3x3(block.expand, rows_to(sq_act, b, h, w))
    return x_act + rows_of(activate(ex_y, ex_aff, "mish", dt))


def packed_stage(stage, x_act4):
    """CSPStage through the fused GEMMs. Takes the activated NHWC stage
    input; returns (raw y2d of the ``out`` conv, its affine, (B, H, W))
    at half the resolution."""
    dt = stage.down.dtype
    dn_y, dn_aff = packed_conv3x3(stage.down, x_act4)
    b, h, w = dn_y.shape[:3]
    dn2 = rows_of(dn_y)
    cross = packed_gemm_convbn(stage.cross, [(dn2, dn_aff)])
    pre_y, pre_aff = packed_gemm_convbn(stage.pre, [(dn2, dn_aff)])
    z_act = activate(pre_y, pre_aff, "mish", dt)
    for i in range(stage.blocks):
        z_act = packed_res_block(getattr(stage, f"block{i + 1}"), z_act,
                                 (b, h, w))
    post = packed_gemm_convbn(stage.post, [(z_act, None)])
    out_y, out_aff = packed_gemm_convbn(stage.out, [post, cross])
    return out_y, out_aff, (b, h, w)


def fused_conv3x3_convbn(convbn, x_raw4, affine):
    """3x3 (or stride-2 darknet-pad) ConvBN as the fused conv. Takes the
    producer's RAW NHWC output and its affine (``None`` for an activated
    tensor): the producer's BN + mish is applied in this conv's input
    read. Returns (raw y4, consumer affine)."""
    y, s1, s2 = fused_conv3x3(x_raw4, convbn.conv.kernel, affine,
                              stride=convbn.conv.stride, act="mish",
                              dtype=convbn.dtype, plain=convbn.conv.plain)
    return y, _fold_stats(convbn.bn, s1, s2, y.numel() // y.shape[-1])


def p3_res_block(block, terms, spatial):
    """CSP residual module with nothing materialised. ``terms`` is the
    running list [(raw y2d, affine), ...] whose activated sum is the
    block input; returns the expand conv's (raw y2d, affine) term, which
    the caller appends to the list (the residual add distributes over the
    next GEMM, see ``sum_inputs``)."""
    b, h, w = spatial
    sq_y, sq_aff = packed_gemm_convbn(block.squeeze, terms, sum_inputs=True)
    ex_y, ex_aff = fused_conv3x3_convbn(block.expand,
                                        rows_to(sq_y, b, h, w), sq_aff)
    return rows_of(ex_y), ex_aff


def p3_stage(stage, y_raw4, affine):
    """CSPStage with every conv fused. Takes the previous layer's raw
    NHWC output and its affine; returns (raw y2d of the ``out`` conv, its
    affine, (B, H, W)) at half the resolution."""
    dn_y, dn_aff = fused_conv3x3_convbn(stage.down, y_raw4, affine)
    b, h, w = dn_y.shape[:3]
    dn2 = rows_of(dn_y)
    cross = packed_gemm_convbn(stage.cross, [(dn2, dn_aff)])
    terms = [packed_gemm_convbn(stage.pre, [(dn2, dn_aff)])]
    for i in range(stage.blocks):
        terms.append(p3_res_block(getattr(stage, f"block{i + 1}"), terms,
                                  (b, h, w)))
    post = packed_gemm_convbn(stage.post, terms, sum_inputs=True)
    out_y, out_aff = packed_gemm_convbn(stage.out, [post, cross])
    return out_y, out_aff, (b, h, w)
