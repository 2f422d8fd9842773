"""Microbenchmark: a chain of fused (normalise + mish + 1x1 conv +
statistics) layers against the eager (conv1x1 + BN-train + mish) chain at
the stage-1 shape (208^2, 64 channels, bf16).

    python3 -m tf2_yolo_tpu_torch.tools.bench_packed_probe [--batch 128]
        [--layers 4] [--steps 20] [--out DIR]

Port of ``tools/bench_packed_probe.py`` of the JAX package, without its
batch-into-lanes packing: rows are the [M, 64] view of the NHWC tensor
(M = B * 208 * 208) and the weights the plain [64, 64] kernel.

One fused layer (:func:`probe_layer`) applies the previous layer's BN
affine + mish in its input read (f32, rounded to bf16), multiplies by the
weights, writes y in bf16 and returns the channel sums of the UNROUNDED
f32 product (the statistics of the JAX probe's ``fused_kernel``; the
training path's ``fused_gemm`` sums the rounded y). Per layer it reads
the activation once and writes it once; the eager chain makes a conv
pass, a statistics pass and a normalise + mish pass.

Source note. On a CUDA tensor :func:`probe_layer` launches the forward
kernel of ``csrc/fused_gemm.cu`` with its ``raw_stats`` flag, the Hopper
port of ``fused_kernel`` (tools/bench_packed_probe.py, reached through
``fused_chain``): in bf16 the tensor-core kernel (``RAW``), in f32 the
CUDA-core one, by the fused GEMM's plan (``probe_layer.tc_launches``
counts the former). It is bounded by the bytes of x and y. On a CPU
tensor it computes :func:`probe_layer_plain`. The TPU's row-block size
(``MBLK``) is not carried over.

Prints ms per layer of the fused chain, of the plain chain and of the
eager chain with the bound (x read and y written once at the card's
memory rate), and one JSON object. Needs CUDA; prints the card's name and
power limit.
"""

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

from ..models.layers import BN_EPS
from ..ops.kernels import fused_gemm as gemm_mod
from ..ops.kernels.fused_gemm import _prologue, act_and_grad
from .train_profile import card_line

H = W = 208
C = 64
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet


def probe_layer_plain(x, w, a, b):
    """Plain version: f32 prologue rounded to the compute dtype, the
    product in f32, y rounded to the compute dtype, and the sums of the
    UNROUNDED product."""
    acc = _prologue(x, a, b, "mish")[0].float() @ w.float()
    return acc.to(x.dtype), acc.sum(dim=0), (acc * acc).sum(dim=0)


def probe_layer(x, w, a, b, plain=False):
    """``(y, s1, s2)`` of one fused layer: ``x`` [M, K] and ``w`` [K, N]
    in bf16 or f32, ``a`` and ``b`` [K] f32. CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise. ``plain=True``
    forces the plain version on any device."""
    aas, bbs = [a.float().contiguous()], [b.float().contiguous()]
    m, n = gemm_mod._check([x], [w], aas, bbs, "mish")
    if plain or x.device.type == "cpu":
        return probe_layer_plain(x, w, aas[0], bbs[0])
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernel for {x.device}")
    out, plan = gemm_mod._forward_cuda([x], [w], aas, bbs, "mish", m, n,
                                       raw_stats=True)
    probe_layer.launches += 1
    probe_layer.tc_launches += plan.route == "tc"
    return out


probe_layer.launches = 0
probe_layer.tc_launches = 0


def fused_chain(x, ws, aas, bbs, plain=False):
    """The JAX probe's ``fused_chain``: each layer reads the previous
    layer's raw y through its affine."""
    s1 = s2 = None
    for w, a, b in zip(ws, aas, bbs):
        x, s1, s2 = probe_layer(x, w, a, b, plain)
    return x, s1, s2


def eager_chain(x4, ws, scales, biases):
    """The JAX probe's ``xla_chain`` in eager PyTorch: per layer a 1x1
    conv of the NHWC tensor, train-mode BN statistics and normalise in
    f32, mish, a cast to the compute dtype."""
    mean = var = None
    for w, scale, bias in zip(ws, scales, biases):
        y = F.conv2d(x4.permute(0, 3, 1, 2), w.t()[:, :, None, None])
        y = y.permute(0, 2, 3, 1).float()
        mean = y.mean(dim=(0, 1, 2))
        var = (y * y).mean(dim=(0, 1, 2)) - mean * mean
        yn = (y - mean) * torch.rsqrt(var + BN_EPS) * scale + bias
        x4 = act_and_grad(yn, "mish")[0].to(x4.dtype)
    return x4, mean, var


def make_case(seed, batch, layers, dtype=torch.bfloat16, device="cuda"):
    """Rows, weights and unit affines as the JAX probe draws them (x
    0.1 * normal, w 0.05 * normal), from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (0.1 * torch.randn(batch * H * W, C, generator=gen,
                           device=device)).to(dtype)
    ws = [(0.05 * torch.randn(C, C, generator=gen, device=device)).to(dtype)
          for _ in range(layers)]
    ones = [torch.ones(C, device=device) for _ in range(layers)]
    zeros = [torch.zeros(C, device=device) for _ in range(layers)]
    return x, ws, ones, zeros


def _ms(fn, steps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--out", default=None,
                   help="directory for bench_packed_probe.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_packed_probe: CUDA is not available")
    card = card_line()
    print(card)
    x, ws, aas, bbs = make_case(args.seed, args.batch, args.layers)
    m = x.shape[0]
    print(f"device={torch.cuda.get_device_name(0)}  shape b{args.batch} "
          f"{H}x{W}x{C}  M={m}  {args.layers} layers")
    x4 = x.reshape(args.batch, H, W, C)
    times = {
        "fused": _ms(lambda: fused_chain(x, ws, aas, bbs), args.steps),
        "eager": _ms(lambda: eager_chain(x4, ws, aas, bbs), args.steps),
        "plain": _ms(lambda: fused_chain(x, ws, aas, bbs, plain=True),
                     max(1, args.steps // 4)),
    }
    nbytes = 2 * m * C * x.element_size()          # x read, y written
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    per_layer = {k: v / args.layers for k, v in times.items()}
    for name, ms in per_layer.items():
        print(f"{name:6s} chain: {times[name]:8.3f} ms total, {ms:7.3f} "
              f"ms/layer ({nbytes / ms / 1e6:7.0f} GB/s effective; bound "
              f"{bound_ms:.3f} ms/layer by bytes)")
    print(f"ratio fused/eager = {times['fused'] / times['eager']:.3f}")
    result = dict(card=card, batch=args.batch, m=m, layers=args.layers,
                  steps=args.steps, ms_per_layer=per_layer,
                  bound_ms_per_layer=bound_ms,
                  ratio_fused_to_eager=times["fused"] / times["eager"])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "bench_packed_probe.json"),
                  "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
