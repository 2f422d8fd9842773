"""Greedy NMS or Soft-NMS of an earlier ``csrc/nms.cu`` against this
checkout's, on one CUDA card, in one process.

    git show <rev>:tf2_yolo_tpu_torch/csrc/nms.cu > build/nms_before.cu
    python3 -m tf2_yolo_tpu_torch.tools.nms_ab --before build/nms_before.cu
    python3 -m tf2_yolo_tpu_torch.tools.nms_ab --soft --before ...

Greedy: the earlier source must have the one-launch C interface of the
first greedy kernel, ``nms_keep_launch(boxes, keep, n, k, threshold,
iou_mode, stream)``; the cases are N=8 and 32 at K=128, N=8 at K=1024 and
one image at ``MAX_K``, IoU and DIoU. ``--soft``: the earlier source must
have the one-launch Soft-NMS interface of the first Soft-NMS kernel,
``soft_nms_keep_launch(boxes, keep, n, k, nms_threshold, conf_threshold,
sigma, stream)``; the cases are ``chip_smoke.py``'s (those above and 64
images at K=256), sigma 0.3 and 0.5 at a confidence threshold of 0.2,
and this checkout's greedy kernel (IoU) is timed on the same rows beside
them. The earlier source is built with this package's nvcc flags and
``--fmad=false``, as ``csrc/nms.cu`` is. At each case both take the same
sorted rows, their keep masks must be equal, and each is timed in turns
(before, after, after, before) three ways, ms per call:

  device   the device time of the call's kernels, summed from a
           ``torch.profiler`` trace of 20 calls: the kernels alone
  graph    20 calls captured in a CUDA graph and replayed between CUDA
           events: the launches and the gaps between them
  wrapper  10 calls through ctypes between CUDA events, after one
           warm-up: the host's work per call included

A reading that fails (a call that cannot be captured) is null. Prints
the card's name and power limit, one line per case, and writes every
reading to ``--out`` (JSON).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from ..ops.kernels import _build
from ..ops.kernels import nms as nms_mod
from ..ops.nms import _sorted_by_conf
from .train_profile import card_line

CASES = [(8, 128), (32, 128), (8, 1024), (1, nms_mod.MAX_K)]
SOFT_CASES = [(8, 128), (32, 128), (64, 256), (8, 1024), (1, nms_mod.MAX_K)]
SOFT_CONF = 0.2
BEFORE_KERNELS = ("nms_keep_kernel",)
AFTER_KERNELS = ("nms_lattice_kernel", "nms_scan_kernel")
SOFT_BEFORE_KERNELS = ("soft_nms_keep_kernel",)
SOFT_AFTER_KERNELS = ("nms_lattice_kernel", "soft_walk_kernel")


def build_before(path, soft=False):
    """Build the earlier source into the package's build directory and
    return its ``nms_keep_launch`` (or ``soft_nms_keep_launch``)."""
    out = _build.BUILD_DIR / "nms_before.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.FLAGS, *nms_mod.SOURCE[1], "-o",
                    str(out), str(path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    if soft:
        fn = lib.soft_nms_keep_launch
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_float] * 3 + [ctypes.c_void_p]
    else:
        fn = lib.nms_keep_launch
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sorted_boxes(gen, n, k):
    """(n, k, 8) rows in clusters, sorted by joint confidence, the first
    3/4 valid (the rows of ``chip_smoke.py``'s greedy checks)."""
    rows = torch.rand(n, k, 7, generator=gen, device="cuda")
    rows[..., :2] = 0.5 + 0.15 * torch.randn(n, k, 2, generator=gen,
                                             device="cuda")
    rows[..., 2:4] = rows[..., 2:4] * 0.3 + 0.05
    rows[..., 5] = torch.randint(0, 3, (n, k), generator=gen,
                                 device="cuda").float()
    valid = torch.zeros(n, k, dtype=torch.bool, device="cuda")
    valid[:, :k * 3 // 4] = True
    rows, valid = _sorted_by_conf(rows, valid)
    return torch.cat([rows, valid[..., None].float()], -1).contiguous()


def device_ms(fn, names, calls=20, split=False):
    """Device ms per call of the kernels whose names contain one of
    ``names``, summed; ``split``: a dict of each name's share instead."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {n: sum(ev.device_time_total for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and n in ev.name) / 1e3 / calls for n in names}
    if split:
        return per
    total = sum(per.values())
    return total if total > 0 else None


def graph_ms(fn, reps=20, iters=5):
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as exc:
        print(f"    graph capture failed: {exc}".splitlines()[0])
        torch.cuda.synchronize()
        return None
    graph.replay()
    torch.cuda.synchronize()
    return events_ms(graph.replay, iters) / reps


def events_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wrapper_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    return events_ms(fn, iters)


def _cases(soft):
    """(n, k, label, before(fn, boxes), after(boxes)) of each case."""
    if soft:
        for n, k in SOFT_CASES:
            for sigma in (0.3, 0.5):
                yield n, k, f"sigma {sigma}", (
                    lambda fn, boxes, keep, s, sigma=sigma: fn(
                        boxes.data_ptr(), keep.data_ptr(), *boxes.shape[:2],
                        0.45, SOFT_CONF, sigma, s)), (
                    lambda boxes, sigma=sigma: nms_mod.soft_nms_keep(
                        boxes, 0.45, SOFT_CONF, sigma))
    else:
        for n, k in CASES:
            for mode in (1, 2):
                yield n, k, "IoU" if mode == 1 else "DIoU", (
                    lambda fn, boxes, keep, s, mode=mode: fn(
                        boxes.data_ptr(), keep.data_ptr(), *boxes.shape[:2],
                        0.45, mode, s)), (
                    lambda boxes, mode=mode: nms_mod.nms_keep(boxes, 0.45,
                                                              mode))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--before", required=True,
                   help="the earlier csrc/nms.cu (one-launch interface)")
    p.add_argument("--soft", action="store_true",
                   help="Soft-NMS (soft_nms_keep_launch) instead of greedy")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="JSON of every reading (default build/nms_ab.json, "
                        "build/nms_ab_soft.json with --soft)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("nms_ab: CUDA is not available")
    out = args.out or os.path.join(
        str(_build.BUILD_DIR.parent),
        "nms_ab_soft.json" if args.soft else "nms_ab.json")
    card = card_line()
    print(card)
    before_fn = build_before(args.before, args.soft)
    names = ((SOFT_BEFORE_KERNELS, SOFT_AFTER_KERNELS) if args.soft
             else (BEFORE_KERNELS, AFTER_KERNELS))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = []
    boxes_of = {}
    for n, k, label, launch_before, launch_after in _cases(args.soft):
        if (n, k) not in boxes_of:
            boxes_of = {(n, k): sorted_boxes(gen, n, k)}
        boxes = boxes_of[(n, k)]

        def before():
            # the earlier wrapper's work: allocate keep, one call on the
            # current stream (a graph captures on its own)
            keep = torch.empty((n, k), dtype=torch.float32, device="cuda")
            err = launch_before(before_fn, boxes, keep,
                                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"earlier kernel: cudaError {err}")
            return keep

        def after():
            return launch_after(boxes)

        keep_b = before()
        keep_a = after()
        torch.cuda.synchronize()
        mismatches = int((keep_a != keep_b).sum())
        if mismatches:
            raise SystemExit(f"nms_ab N={n} K={k} {label}: {mismatches} "
                             "keep mismatches")
        r = dict(n=n, k=k, case=label, kept=int(keep_a.sum()),
                 valid=int(boxes[..., 7].sum()), before={}, after={})
        for name, fn, kernels in (("before", before, names[0]),
                                  ("after", after, names[1]),
                                  ("after", after, names[1]),
                                  ("before", before, names[0])):
            for how, ms in (("device", device_ms(fn, kernels)),
                            ("graph", graph_ms(fn)),
                            ("wrapper", wrapper_ms(fn))):
                r[name].setdefault(how, []).append(ms)
        if args.soft:
            # this checkout's two launches apart, and the greedy kernel
            # on the same rows, for scale
            r["after_split"] = device_ms(after, names[1], split=True)

            def greedy():
                return nms_mod.nms_keep(boxes, 0.45, 1)
            r["greedy"] = {"device": [device_ms(greedy, AFTER_KERNELS)],
                           "graph": [graph_ms(greedy)],
                           "wrapper": [wrapper_ms(greedy)]}
        results.append(r)

        def fmt(v):
            return "/".join("null" if x is None else f"{x:.4f}" for x in v)
        cols = ("before", "after", "greedy") if args.soft else \
            ("before", "after")
        print(f"N={n} K={k} {label} (kept {r['kept']} of {r['valid']}, "
              f"masks equal), ms {' | '.join(cols)}: "
              + "; ".join(f"{how} " + " | ".join(fmt(r[c][how])
                                                 for c in cols)
                          for how in ("device", "graph", "wrapper"))
              + ("; after by kernel (device) " + ", ".join(
                  f"{k} {v:.4f}" for k, v in r["after_split"].items())
                 if args.soft else ""))
    with open(out, "w") as f:
        json.dump(dict(card=card, soft=args.soft, cases=results), f,
                  indent=1)
    print(json.dumps(dict(card=card, soft=args.soft, cases=results)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
