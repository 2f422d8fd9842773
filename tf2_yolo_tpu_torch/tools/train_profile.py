"""Where one training step, or one served request, of the port spends
its time on the card.

    python3 -m tf2_yolo_tpu_torch.tools.train_profile [--batch 32]
        [--size 416] [--steps 2] [--packed {1,3}] [--serve] [--out DIR]

Builds a bf16 ``YoloV4(packed=...)`` train state (:func:`make_training`:
random v4 init from ``--seed``, Adam 1e-3, synthetic labels; the smoke
script ``chip_smoke.py`` trains the same), warms up, traces ``--steps``
steps with ``torch.profiler`` and sums the device time of every CUDA
kernel by category. With ``--serve`` it traces ``--steps`` requests of
``make_serving_fn`` on the same bf16 network in eval mode instead (pass
``--batch 8`` for the served micro-batch). The categories:

  conv forward       the hand-written conv + statistics kernels (tensor
                     cores; the stem through the small-Ci kernel)
  conv backward      the library conv VJP (cuDNN / CUTLASS kernels and
                     the layout changes around them)
  fused gemm fwd/bwd the hand-written fused GEMM kernels
  fused conv3x3 forward / backward
                     the hand-written fused 3x3 conv kernels (``--packed 3``)
  int8 conv          kernel Q: its quantize passes and its int8 convs
  optimizer          the optimizer chain's multi-tensor kernels
  nms                the hand-written NMS kernels, greedy and Soft-NMS
                     (``--serve``)
  elementwise        everything else (BN normalise, mish, leaky and their
                     backward, casts, reductions, the loss, copies)

and prints one JSON object with ms per step (or request) of each, the
fused GEMM backward by kernel (its route shows in the names), the wall
time per step with and without the profiler, and the device's idle
share
(1 - kernel time / untraced wall time: the profiler's own host cost
stretches the traced wall time). Needs CUDA; prints the card's name and
power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..export import make_serving_fn
from ..models import YoloV4, use_plain_route
from ..models.layers import set_bn_group
from ..ops.losses import wrap_yolo_loss_v4
from ..parallel import create_train_state, make_optimizer, make_train_step

CLASSES = 3
ANCHORS = np.stack([np.linspace(0.05, 0.75, 9),
                    np.linspace(0.07, 0.65, 9)], axis=1)


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def make_training(seed, batch, size, dtype, plain=False, packed=3,
                  group=None):
    """A YoloV4(packed=...) train state on the card with the v4 init
    drawn from ``seed``, Adam 1e-3, the three v4 losses, one batch of
    random images and synthetic labels (four boxes per image and level,
    as the JAX package's training benchmark makes them). With a process
    ``group``, the data-parallel step over it (BatchNorm statistics and
    gradients reduced over the group)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = YoloV4(ANCHORS, CLASSES, dtype=dtype, generator=gen,
                   packed=packed)
    if plain:
        use_plain_route(model)
    set_bn_group(model, group)
    state = create_train_state(model, make_optimizer("adam", 1e-3))
    rng = np.random.RandomState(seed)
    x = torch.rand(batch, size, size, 3, generator=gen, device="cuda")
    loss_fns, ys = [], []
    for level in range(3):
        g = (size // 32) * 2 ** level
        loss_fns.append(wrap_yolo_loss_v4(
            (g, g), 3, CLASSES, ANCHORS[3 * level:3 * level + 3]))
        y = np.zeros((batch, g, g, 5 + CLASSES), np.float32)
        for b in range(batch):
            for _ in range(4):
                gy, gx = rng.randint(0, g, 2)
                y[b, gy, gx, :5] = [*rng.rand(2), 0.2, 0.3, 1.0]
                y[b, gy, gx, 5 + rng.randint(CLASSES)] = 1.0
        ys.append(torch.from_numpy(y).cuda())
    return state, make_train_step(loss_fns, group=group), x, tuple(ys)


def timed_steps(state, step, x, ys, steps):
    """``steps`` steps, each ending in a synchronize; (ms, losses)."""
    times, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, logs = step(state, x, ys)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(logs["loss"]))
    return times, losses


def make_serving(seed, batch, size):
    """``run()``: one request of ``batch`` random images through
    ``make_serving_fn`` on the bf16 network of :func:`make_training`
    (v4 init from ``seed``) in eval mode."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = YoloV4(ANCHORS, CLASSES, dtype=torch.bfloat16, generator=gen)
    serve = make_serving_fn(model, CLASSES, 4)
    x = torch.rand(batch, size, size, 3, generator=gen, device="cuda")
    return lambda: serve(x)


def timed_runs(run, n):
    """ms of ``n`` calls of ``run``, each ending in a synchronize."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


CATEGORIES = (
    ("fused conv3x3 forward", ("fused_conv3x3_fwd_kernel",
                               "fused_conv3x3_fwd_tc_kernel")),
    ("fused conv3x3 backward", ("fused_conv3x3_dx_kernel",
                                "fused_conv3x3_dw_kernel",
                                "fused_conv3x3_dx_tc_kernel",
                                "fused_conv3x3_dw_tc_kernel",
                                "fused_conv3x3_ctab_kernel")),
    ("conv forward", ("conv_bn_stats_kernel", "conv_bn_stats_tc_kernel",
                      "conv_bn_stats_ic_kernel")),
    ("fused gemm forward", ("fused_gemm_fwd_kernel",
                            "fused_gemm_fwd_tc_kernel")),
    ("fused gemm backward", ("fused_gemm_dx_kernel", "fused_gemm_dw_kernel",
                             "fused_gemm_dx_tc_kernel",
                             "fused_gemm_dw_tc_kernel",
                             "fused_gemm_ctab_kernel")),
    ("int8 conv", ("quantize_int8_kernel", "quantize_im2col_kernel",
                   "conv_int8_wgmma_kernel", "conv_int8_kernel")),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("nms", ("nms_lattice_kernel", "nms_scan_kernel", "soft_walk_kernel")),
    # SPP's max-pool kernels carry "nhwc" in their names
    ("elementwise", ("max_pool",)),
    ("conv backward", ("cudnn", "cutlass", "xmma", "dgrad", "wgrad", "nhwc",
                       "nchw", "convolve", "conv2d", "implicit_gemm",
                       "sm90_", "sm80_", "gemm")),
)


def category(name):
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "elementwise"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=416)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--packed", type=int, choices=(1, 3), default=3,
                   help="backbone route: 1 = fused GEMMs in stages 3-5, "
                        "3 = also stages 1-2 all fused")
    p.add_argument("--serve", action="store_true",
                   help="trace served requests instead of training steps")
    p.add_argument("--out", default=None,
                   help="directory for the JSON record")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_profile: CUDA is not available")
    from torch.profiler import ProfilerActivity, profile
    card = card_line()
    print(card)

    if args.serve:
        run = make_serving(args.seed, args.batch, args.size)
    else:
        state, step, x, ys = make_training(
            args.seed, args.batch, args.size, torch.bfloat16,
            packed=args.packed)
        run = lambda: step(state, x, ys)
    timed_runs(run, 2)                          # warm-up
    untraced = timed_runs(run, args.steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    by_cat, by_kernel, launches = {}, {}, 0
    for ev in prof.events():
        # device-side events only; "Optimizer.step#Adam.step" is an
        # annotation that spans kernels already counted
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.name.startswith("Optimizer."):
            continue
        ms = ev.device_time_total / 1e3 / args.steps
        by_cat[category(ev.name)] = by_cat.get(category(ev.name), 0.0) + ms
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ms
        launches += 1
    busy = sum(by_cat.values())
    if busy <= 0:
        raise SystemExit("train_profile: no device time in the "
                         "trace; time with CUDA events instead")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]
    # the fused GEMM backward by kernel (the route shows in the names:
    # ``_tc_`` kernels and the ds1 table on the tensor cores)
    gemm_bwd = {}
    for k, v in by_kernel.items():
        if category(k) == "fused gemm backward":
            base = next(n for n in dict(CATEGORIES)["fused gemm backward"]
                        if n in k)
            gemm_bwd[base] = gemm_bwd.get(base, 0.0) + v
    untraced_ms = sum(untraced) / len(untraced)
    result = dict(card=card, batch=args.batch, size=args.size,
                  packed=None if args.serve else args.packed,
                  serve=args.serve, steps=args.steps,
                  wall_ms_per_step_traced=wall_ms,
                  wall_ms_per_step_untraced=untraced_ms,
                  kernel_ms_per_step=busy,
                  idle_share=max(0.0, 1.0 - busy / untraced_ms),
                  launches_per_step=launches / args.steps,
                  ms_per_step=dict(sorted(by_cat.items())),
                  fused_gemm_backward_ms=dict(sorted(gemm_bwd.items())),
                  top_kernels=[dict(name=k[:120], ms_per_step=v,
                                    category=category(k)) for k, v in top])
    for k, v in top:
        print(f"  {v:9.3f} ms/step  [{category(k)}]  {k[:100]}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = ("serve_profile.json" if args.serve
                else f"train_profile_packed{args.packed}.json")
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(result, f, indent=1)
    result.pop("top_kernels")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
