#!/usr/bin/env python3
"""Smoke run of the PyTorch port's YOLOv4 serving path on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--batch 8] [--size 416] [--requests 3]

Phases (each raises on failure, so the exit code is nonzero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of tf2_yolo_tpu_torch/csrc with nvcc;
  3. check each kernel against its plain PyTorch version on the card at
     YOLOv4@416 layer shapes, bf16 and f32 (TF32 off for the plain conv);
  4. serve ``--requests`` batches of ``--batch`` images through
     ``make_serving_fn`` in bf16, with launch counters proving that every
     conv (107 ConvBN + 3 head convs) and every NMS ran the kernels;
  5. in f32 on the same weights, compare the head logits and outputs of
     the kernel route with the plain route, then the NMS kernel with the
     plain NMS on the same decoded rows;
  6. time both routes per request.

Weights are random, from ``--seed``: conv kernels drawn with the port's
HE_NORMAL from a seeded ``torch.Generator``. With BN at its init
statistics the 107-layer stack then has no scale control (its head
logits run to ~1e3 and every confidence saturates), so each BN's running
statistics are set to the batch statistics of its conv output on a
separate seeded calibration batch, as a trained network's BN holds
them. The confidence threshold is then the one that ~64 of each image's
lattice points pass on that calibration batch.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel JSON summary. The build log and a JSON record of
every measurement go to ``--log-dir`` (default ``build/chip_smoke/``).
"""

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tf2_yolo_tpu_torch.export import make_serving_fn
from tf2_yolo_tpu_torch.models import YoloV4, use_plain_route
from tf2_yolo_tpu_torch.models.layers import Conv, ConvBN, he_normal_
from tf2_yolo_tpu_torch.ops.decode import decode_multi_level
from tf2_yolo_tpu_torch.ops.kernels import _build
from tf2_yolo_tpu_torch.ops.kernels import conv_bn as conv_mod
from tf2_yolo_tpu_torch.ops.kernels import nms as nms_mod
from tf2_yolo_tpu_torch.ops.kernels.conv_bn import (conv_bn_stats,
                                                    conv_bn_stats_plain)
from tf2_yolo_tpu_torch.ops.kernels.nms import nms_keep, nms_keep_plain
from tf2_yolo_tpu_torch.ops.nms import _sorted_by_conf

ROOT = os.path.dirname(os.path.abspath(__file__))
CLASSES = 3
ANCHORS = np.stack([np.linspace(0.05, 0.75, 9),
                    np.linspace(0.07, 0.65, 9)], axis=1)
CONVS_PER_FORWARD = 110          # 107 ConvBN + 3 head convs

# (name, N, H, W, Ci, Co, k, stride): YOLOv4@416 layers at batch 8
CONV_SHAPES = [
    ("stem 416^2 3->32 3x3s1", 8, 416, 416, 3, 32, 3, 1),
    ("stage1.down 416^2 32->64 3x3s2", 8, 416, 416, 32, 64, 3, 2),
    ("stage3.pre 52^2 256->128 1x1", 8, 52, 52, 256, 128, 1, 1),
    ("stage3.block.expand 52^2 128->128 3x3s1", 8, 52, 52, 128, 128, 3, 1),
    ("td1_pre1 13^2 1024->512 1x1", 8, 13, 13, 1024, 512, 1, 1),
    ("td1_pre2 13^2 512->1024 3x3s1", 8, 13, 13, 512, 1024, 3, 1),
]
# Tolerances of kernel against plain, same inputs on the card.
# y: f32 sums of up to 9*Ci products in another order (4.6e3 terms at
# most): 1e-4 of the output's scale in f32; in bf16 both round the f32
# sum to 8 bits, and a sum that differs in its last f32 bits can round
# to the neighbouring bf16 value: 1/128 relative (2 bf16 ulps) plus 1e-3
# of scale.
# s1, s2: per-block partial sums added by f32 atomics in no fixed order,
# plus the y differences: relative to sum|y| and sum(y^2), 1e-5 in f32,
# and in bf16 the share of rounding flips, bounded by 1/128.
TOL = {torch.float32: dict(y_rel=1e-4, y_scale=1e-4, s_rel=1e-5),
       torch.bfloat16: dict(y_rel=2 ** -7, y_scale=1e-3, s_rel=2 ** -7)}
NMS_CASES = [(8, 128), (8, 1024)]


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build(log_dir):
    t0 = time.perf_counter()
    conv_mod._launcher()
    nms_mod._launcher()
    seconds = time.perf_counter() - t0
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "kernel_build.log"), "w") as f:
        for src, info in _build.build_info.items():
            f.write(f"== {src}: {info['seconds']:.2f} s\n{info['log']}\n")
    for src, info in _build.build_info.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  built {src} in {info['seconds']:.2f} s; ptxas: "
              f"{' | '.join(regs[:4])}")
    print(f"phase 2: kernels built in {seconds:.2f} s")
    return seconds


def phase_conv_checks(gen):
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[dtype]
        for name, n, h, w, ci, co, k, stride in CONV_SHAPES:
            x = torch.randn(n, h, w, ci, generator=gen, device="cuda")
            wt = torch.empty(k, k, ci, co, device="cuda")
            he_normal_(wt, gen)
            b = 0.1 * torch.randn(co, generator=gen, device="cuda")
            x, wt, b = x.to(dtype), wt.to(dtype), b.to(dtype)
            y, s1, s2 = conv_bn_stats(x, wt, b, stride, want_stats=True)
            yp, s1p, s2p = conv_bn_stats_plain(x, wt, b, stride, True)
            torch.cuda.synchronize()
            yf, ypf = y.float(), yp.float()
            err = (yf - ypf).abs()
            scale = ypf.abs().max().item()
            bound = tol["y_rel"] * ypf.abs() + tol["y_scale"] * max(1.0,
                                                                     scale)
            y_ok = bool((err <= bound).all())
            abs_sum = ypf.abs().sum(dim=(0, 1, 2))
            sq_sum = (ypf * ypf).sum(dim=(0, 1, 2))
            s1_rel = ((s1 - s1p).abs() / abs_sum.clamp(min=1e-30)).max()
            s2_rel = ((s2 - s2p).abs() / sq_sum.clamp(min=1e-30)).max()
            ms = cuda_ms(lambda: conv_bn_stats(x, wt, b, stride, False), 5)
            plain_ms = cuda_ms(
                lambda: conv_bn_stats_plain(x, wt, b, stride, False), 5)
            flop = 2.0 * n * (h // stride) * (w // stride) * co * k * k * ci
            r = dict(shape=name, dtype=str(dtype).replace("torch.", ""),
                     max_abs_err=err.max().item(), y_scale=scale,
                     s1_rel_err=s1_rel.item(), s2_rel_err=s2_rel.item(),
                     ms=ms, plain_ms=plain_ms,
                     kernel_tflops=flop / ms / 1e9)
            results.append(r)
            print(f"  conv {r['dtype']:8s} {name:40s} max|dy| "
                  f"{r['max_abs_err']:.3e} (|y| <= {scale:.3g}; bound "
                  f"{tol['y_rel']:.3g}*|y| + {tol['y_scale']:.0e}*scale) "
                  f"s1 rel {r['s1_rel_err']:.2e} s2 rel "
                  f"{r['s2_rel_err']:.2e} (bound {tol['s_rel']:.2e}) | "
                  f"kernel {ms:.3f} ms ({r['kernel_tflops']:.2f} TFLOP/s)"
                  f" plain {plain_ms:.3f} ms")
            check(y_ok, f"conv {name} {dtype}: y outside the bound")
            check(r["s1_rel_err"] <= tol["s_rel"]
                  and r["s2_rel_err"] <= tol["s_rel"],
                  f"conv {name} {dtype}: statistics outside the bound")
    return results


def sorted_boxes(gen, n, k, n_box, classes=3):
    """(n, k, 8) rows [x,y,w,h,conf,cls,prob,valid] in clusters, sorted
    by joint confidence, the first n_box valid."""
    rows = torch.rand(n, k, 7, generator=gen, device="cuda")
    rows[..., :2] = 0.5 + 0.15 * torch.randn(n, k, 2, generator=gen,
                                             device="cuda")
    rows[..., 2:4] = rows[..., 2:4] * 0.3 + 0.05
    rows[..., 5] = torch.randint(0, classes, (n, k), generator=gen,
                                 device="cuda").float()
    valid = torch.zeros(n, k, dtype=torch.bool, device="cuda")
    valid[:, :n_box] = True
    rows, valid = _sorted_by_conf(rows, valid)
    return torch.cat([rows, valid[..., None].float()], -1).contiguous()


def phase_nms_checks(gen):
    results = []
    for n, k in NMS_CASES:
        boxes = sorted_boxes(gen, n, k, n_box=k * 3 // 4)
        for mode in (1, 2):
            keep = nms_keep(boxes, 0.45, mode)
            keep_p = nms_keep_plain(boxes, 0.45, mode)
            torch.cuda.synchronize()
            mismatches = int((keep != keep_p).sum())
            max_abs_err = (keep - keep_p).abs().max().item()
            ms = cuda_ms(lambda: nms_keep(boxes, 0.45, mode), 10)
            plain_ms = cuda_ms(lambda: nms_keep_plain(boxes, 0.45, mode), 2)
            r = dict(n=n, k=k, iou_mode=mode, mismatches=mismatches,
                     max_abs_err=max_abs_err,
                     kept=int(keep.sum()), valid=int(boxes[..., 7].sum()),
                     ms=ms, plain_ms=plain_ms)
            results.append(r)
            print(f"  nms N={n} K={k} {'IoU' if mode == 1 else 'DIoU'}: "
                  f"{mismatches} mismatches (bound 0), kept {r['kept']} of "
                  f"{r['valid']} | kernel {ms:.3f} ms plain "
                  f"{plain_ms:.3f} ms")
            check(mismatches == 0, f"nms K={k} mode {mode}: masks differ")
            check(0 < r["kept"] < r["valid"], "nms: degenerate test rows")
    return results


def calibrate_bn(model, images):
    """Set every BN's running mean/var to the batch statistics of its
    conv output on ``images``, layer by layer in one forward."""
    def hook(bn, out):
        y = out[0].float()
        bn.mean.copy_(y.mean(dim=(0, 1, 2)))
        bn.var.copy_(y.var(dim=(0, 1, 2), unbiased=False))

    handles = [m.conv.register_forward_hook(
        lambda conv, inputs, out, bn=m.bn: hook(bn, out))
        for m in model.modules()
        if isinstance(m, ConvBN) and m.bn is not None]
    try:
        with torch.inference_mode():
            model(images)
    finally:
        for h in handles:
            h.remove()


def joint_conf(outs):
    return torch.cat([
        (o.reshape(o.shape[0], -1, 5 + CLASSES)[..., 4:5]
         * o.reshape(o.shape[0], -1, 5 + CLASSES)[..., 5:]).reshape(
             o.shape[0], -1) for o in outs], dim=1)


def build_model(args, gen):
    model = YoloV4(ANCHORS, CLASSES, dtype=torch.bfloat16, generator=gen,
                   device="cuda").eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                he_normal_(m.kernel, gen)
    calib = torch.rand(args.batch, args.size, args.size, 3, generator=gen,
                       device="cuda")
    calibrate_bn(model, calib)
    with torch.inference_mode():
        joint = joint_conf(model(calib)).float()
    per_image = joint.shape[1]
    threshold = float(torch.quantile(joint[0], 1 - 64 / per_image))
    return model, threshold


def serve_stats(rows, keep, threshold):
    valid = (rows[..., 4] * rows[..., 6]) >= threshold
    return int(valid.sum()), int(keep.sum())


def phase_serve(args, model, threshold, images):
    serve = make_serving_fn(model, CLASSES, 4, threshold=threshold,
                            nms_mode=1, nms_threshold=0.45)
    conv_bn_stats.launches = 0
    nms_keep.launches = 0
    times, stats = [], []
    for req in range(args.requests + 1):     # request 0 warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, keep = serve(images[req])
        torch.cuda.synchronize()
        if req:
            times.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(rows).all()), "non-finite served rows")
        check(rows.shape == (args.batch, 128, 7)
              and keep.shape == (args.batch, 128), "served shapes")
        stats.append(serve_stats(rows, keep, threshold))
    forwards = args.requests + 1
    conv_launches, nms_launches = conv_bn_stats.launches, nms_keep.launches
    print(f"  launches in {forwards} requests: conv_bn_stats "
          f"{conv_launches} ({conv_launches / forwards:g} per forward, "
          f"want {CONVS_PER_FORWARD}), nms_keep {nms_launches} "
          f"(want {forwards})")
    check(conv_launches == CONVS_PER_FORWARD * forwards,
          "not every conv of the forward ran the kernel")
    check(nms_launches == forwards, "not every request ran the NMS kernel")
    for req, (valid, kept) in enumerate(stats):
        print(f"  request {req}: valid {valid}, kept {kept}, suppressed "
              f"{valid - kept}")
        check(0 < kept < valid, "degenerate detections")
    return dict(ms_per_request=times, conv_launches=conv_launches,
                nms_launches=nms_launches, forwards=forwards,
                valid_kept=stats)


def head_logits(model, x):
    logits = {}
    handles = [getattr(model, f"head{i}").conv.register_forward_hook(
        lambda m, inp, out, i=i: logits.__setitem__(i, out[0].float()))
        for i in (1, 2, 3)]
    try:
        with torch.inference_mode():
            outs = model(x)
    finally:
        for h in handles:
            h.remove()
    return [logits[i] for i in (1, 2, 3)], outs


def phase_routes_f32(model16, images):
    model = YoloV4(ANCHORS, CLASSES, dtype=torch.float32,
                   device="cuda").eval()
    model.load_state_dict(model16.state_dict())
    plain = use_plain_route(copy.deepcopy(model))
    x = images[:2].contiguous()
    lk, ok = head_logits(model, x)
    lp, op = head_logits(plain, x)
    torch.cuda.synchronize()
    res = {}
    # The random 107-layer stack amplifies f32 rounding about 1e4-fold
    # (measured on the CPU: the same code with 1 vs 8 threads differs by
    # 7.6e-4 at 96^2; the port vs JAX by 4.8e-3 in the logits); bounds
    # as the CPU slice test's, relative to each tensor's scale.
    for i in range(3):
        scale = max(1.0, lp[i].abs().max().item())
        d_logit = (lk[i] - lp[i]).abs().max().item()
        d_out = (ok[i] - op[i]).abs()
        out_ok = bool((d_out <= 5e-3 + 2e-2 * op[i].abs()).all())
        res[f"head{i + 1}"] = dict(logit_max_abs_err=d_logit,
                                   logit_scale=scale,
                                   out_max_abs_err=d_out.max().item())
        print(f"  f32 head{i + 1}: logits max|d| {d_logit:.3e} (scale "
              f"{scale:.3g}, bound 2e-2*scale); outputs max|d| "
              f"{d_out.max().item():.3e} (bound 5e-3 + 2e-2*|out|)")
        check(d_logit <= 2e-2 * scale, f"head{i + 1} logits differ")
        check(out_ok and bool(torch.isfinite(ok[i]).all()),
              f"head{i + 1} outputs differ")
    joint = joint_conf(ok)
    threshold = float(torch.quantile(joint[0], 1 - 64 / joint.shape[1]))
    rows, valid = decode_multi_level(ok, class_num=CLASSES,
                                     threshold=threshold, max_boxes=128)
    rows, valid = _sorted_by_conf(rows, valid)
    boxes = torch.cat([rows, valid[..., None].float()], -1).contiguous()
    for mode in (1, 2):
        keep = nms_keep(boxes, 0.45, mode)
        keep_p = nms_keep_plain(boxes, 0.45, mode)
        mism = int((keep != keep_p).sum())
        res[f"nms_mode{mode}_mismatches"] = mism
        print(f"  f32 decoded rows, nms {'IoU' if mode == 1 else 'DIoU'}: "
              f"kernel vs plain {mism} mismatches (bound 0), kept "
              f"{int(keep.sum())} of {int(valid.sum())}")
        check(mism == 0, "NMS kernel differs on decoded rows")
    return res


def phase_timing(args, model, threshold, images, card):
    plain = use_plain_route(copy.deepcopy(model))
    routes = {"kernel": make_serving_fn(model, CLASSES, 4,
                                        threshold=threshold),
              "plain": make_serving_fn(plain, CLASSES, 4,
                                       threshold=threshold)}
    times = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):   # in turns
        routes[name](images[0])
        for req in range(args.requests):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routes[name](images[1 + req])
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for name, ts in times.items():
        ms = float(np.median(ts))
        out[name] = dict(ms_per_request=ms,
                         img_per_s=args.batch / (ms / 1e3), runs=ts)
        print(f"  {name:6s} route bf16 b{args.batch} {args.size}^2: "
              f"{ms:.2f} ms/request (median of {len(ts)}), "
              f"{out[name]['img_per_s']:.1f} img/s [{card}]")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=416)
    p.add_argument("--requests", type=int, default=3)
    p.add_argument("--log-dir",
                   default=os.path.join(ROOT, "build", "chip_smoke"))
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = card_line()
    print(f"phase 1: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    build_s = phase_build(args.log_dir)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    print("phase 3: kernels against their plain versions")
    conv_res = phase_conv_checks(gen)
    nms_res = phase_nms_checks(gen)

    print(f"phase 4: serving {args.requests} requests of {args.batch} x "
          f"{args.size}^2 in bf16 (HE_NORMAL kernels, seed {args.seed}, "
          "calibrated BN statistics)")
    model, threshold = build_model(args, gen)
    images = [torch.rand(args.batch, args.size, args.size, 3,
                         generator=gen, device="cuda")
              for _ in range(args.requests + 1)]
    with torch.inference_mode():
        joint = joint_conf(model(images[0])).float()
    qs = torch.quantile(joint[0], torch.tensor(
        [0.0, 0.5, 0.99, 1.0], device="cuda")).tolist()
    print(f"  joint confidence, image 0: min {qs[0]:.4f} median "
          f"{qs[1]:.4f} p99 {qs[2]:.4f} max {qs[3]:.4f}; threshold "
          f"{threshold:.4f}")
    served = phase_serve(args, model, threshold, images)
    torch.cuda.synchronize()

    print("phase 5: f32 kernel route against plain route, same weights")
    routes = phase_routes_f32(model, images[0])

    print("phase 6: ms/request, both routes")
    timing = phase_timing(args, model, threshold, images, card)

    bf16 = [r for r in conv_res if r["dtype"] == "bfloat16"]
    nms128 = [r for r in nms_res if r["k"] == 128 and r["iou_mode"] == 1][0]
    kernels = [
        dict(name="conv_bn_stats", route="cuda",
             source="tf2_yolo_tpu_torch/csrc/conv_bn.cu",
             replaces="tf2_yolo_tpu/ops/pallas/conv_bn_kernel.py:114 "
                      "and :346",
             launches=served["conv_launches"],
             max_abs_err=max(r["max_abs_err"] for r in conv_res),
             ms=sum(r["ms"] for r in bf16),
             plain_ms=sum(r["plain_ms"] for r in bf16)),
        dict(name="nms_keep", route="cuda",
             source="tf2_yolo_tpu_torch/csrc/nms.cu",
             replaces="tf2_yolo_tpu/ops/pallas/nms_kernel.py:182",
             launches=served["nms_launches"],
             max_abs_err=max(r["max_abs_err"] for r in nms_res),
             ms=nms128["ms"], plain_ms=nms128["plain_ms"]),
    ]
    record = dict(card=card, build_seconds=build_s, conv=conv_res,
                  nms=nms_res, threshold=threshold, served=served,
                  routes_f32=routes, timing=timing, kernels=kernels)
    os.makedirs(args.log_dir, exist_ok=True)
    with open(os.path.join(args.log_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
