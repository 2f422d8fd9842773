"""Data-feed throughput of the port's readers, and YOLOv4 training fed
from files by each.

    python3 -m tf2_yolo_tpu_torch.tools.bench_reader [--n 256]
        [--size 416] [--src-size S] [--batch 32] [--threads 4] [--fit]
        [--uint8] [--epochs 3] [--prefetch 2] [--seed 0] [--out DIR]

Writes a seeded synthetic labelimg set (:func:`write_labelimg_set`: PNG
images of filled boxes on noise and their XML files) into a temporary
directory, then times ``YoloDataSequence`` over it, one pass after a
warm one (page cache, the native library built): ``reader="PIL"`` at 1
and ``--threads`` threads, ``"cv"`` (where OpenCV is installed) and
``"native"`` (the C++ loader, whole-batch decode + parse + encode; where
it builds, else a row says why not) at ``--threads``: batches/s and
images/s. With ``--fit``, the ms/step of
``Model.fit`` of a bf16 ``YoloV4(packed=3)`` (Adam 1e-3) fed by each
reader through ``Yolo.read_file_to_sequence`` (the label pyramid
included; ``--uint8`` feeds raw uint8 batches), one epoch of warm-up,
then ``--epochs`` - 1 timed; on the card, with its name and power limit.

Prints one JSON line a row, and with ``--out`` writes them all to
``DIR/bench_reader.json``. A tool, not a benchmark: it measures the feed
alone and the feed under training, on synthetic files.
"""

import argparse
import json
import os
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np


def write_labelimg_set(root, n, size, class_names, seed=0, max_boxes=4):
    """``n`` seeded images of ``size`` (H, W) with 1..``max_boxes`` filled
    boxes each on uniform noise, as ``imgs/img_NNN.png`` and labelimg
    XML ``labels/img_NNN.xml`` under ``root``. Returns (img_dir,
    label_dir)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "imgs")
    lab_dir = os.path.join(root, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    h, w = size
    for i in range(n):
        img = rng.randint(0, 64, (h, w, 3)).astype(np.uint8)
        ann = ET.Element("annotation")
        ET.SubElement(ann, "filename").text = f"img_{i:03d}.png"
        sz = ET.SubElement(ann, "size")
        ET.SubElement(sz, "width").text = str(w)
        ET.SubElement(sz, "height").text = str(h)
        for _ in range(rng.randint(1, max_boxes + 1)):
            bw = rng.randint(w // 10, w // 3)
            bh = rng.randint(h // 10, h // 3)
            x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
            img[y1:y1 + bh, x1:x1 + bw] = rng.randint(100, 255, 3)
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = class_names[
                rng.randint(len(class_names))]
            bnd = ET.SubElement(obj, "bndbox")
            for key, v in zip(("xmin", "ymin", "xmax", "ymax"),
                              (x1, y1, x1 + bw, y1 + bh)):
                ET.SubElement(bnd, key).text = str(v)
        Image.fromarray(img).save(os.path.join(img_dir, f"img_{i:03d}.png"))
        ET.ElementTree(ann).write(
            os.path.join(lab_dir, f"img_{i:03d}.xml"))
    return img_dir, lab_dir


def reader_rows(threads):
    """(reader, threads) of the timed rows: PIL at 1 and ``threads``,
    cv where OpenCV imports, native where the C++ loader builds; and
    the readers left out, with the reason."""
    from .. import native

    rows, left_out = [("PIL", 1), ("PIL", threads)], {}
    try:
        import cv2  # noqa: F401
        rows.append(("cv", threads))
    except ImportError as e:
        left_out["cv"] = str(e)
    if native.available():
        rows.append(("native", threads))
    else:
        left_out["native"] = str(native.build_error())
    return rows, left_out


def time_reader(seq):
    """Seconds of one pass over ``seq`` (after a warm one)."""
    for i in range(len(seq)):
        seq[i]
    t0 = time.perf_counter()
    for i in range(len(seq)):
        seq[i]
    return time.perf_counter() - t0


def fit_ms_per_step(img_dir, lab_dir, names, args, reader, threads):
    """ms/step of ``Model.fit`` of a bf16 YoloV4(packed=3) fed by
    ``reader``: the steady epochs after one of warm-up."""
    import torch

    from tf2_yolo_tpu_torch import yolov4

    yolo = yolov4.Yolo(input_shape=(args.size, args.size, 3),
                       class_names=names)
    anchors = np.stack([np.linspace(0.05, 0.6, 9),
                        np.linspace(0.05, 0.5, 9)], axis=1).tolist()
    yolo.create_model(anchors=anchors, pretrained_body=None, packed=3,
                      dtype=torch.bfloat16, seed=args.seed, device="cuda")
    seq = yolo.read_file_to_sequence(
        img_dir, lab_dir, batch_size=args.batch, shuffle=False,
        reader=reader, thread_num=threads, uint8=args.uint8)
    yolo.model.compile("adam", loss=yolo.loss(), learning_rate=1e-3)
    hist = yolo.model.fit(seq, epochs=args.epochs, verbose=0,
                          prefetch=args.prefetch)
    steady = hist["epoch_time"][1:] or hist["epoch_time"]
    steps = len(seq)
    return dict(ms_per_step=1e3 * sum(steady) / (len(steady) * steps),
                epoch_s=hist["epoch_time"], steps_per_epoch=steps,
                loss=[float(v) for v in hist["loss"]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--src-size", type=int, default=None,
                    help="write the images at this size (default --size);"
                         " a larger one times decode-big + resize-down")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--classes", type=int, default=3)
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--uint8", action="store_true")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from tf2_yolo_tpu_torch.data import YoloDataSequence

    names = [f"c{i}" for i in range(args.classes)]
    src = args.src_size or args.size
    out = []

    def emit(row):
        out.append(row)
        print(json.dumps(row), flush=True)

    card = None
    if args.fit:
        from tf2_yolo_tpu_torch.tools.train_profile import card_line
        card = card_line()
        print(card, flush=True)
    with tempfile.TemporaryDirectory(prefix="bench_reader_") as root:
        t0 = time.perf_counter()
        img_dir, lab_dir = write_labelimg_set(root, args.n, (src, src),
                                              names, seed=args.seed)
        emit(dict(write_s=time.perf_counter() - t0, n=args.n,
                  src_size=src))
        grid = (args.size // 8, args.size // 8)      # the v4 finest level
        rows, left_out = reader_rows(args.threads)
        for reader, why in left_out.items():
            emit(dict(reader=reader, left_out=why))
        for reader, threads in rows:
            seq = YoloDataSequence(
                img_path=img_dir, label_path=lab_dir, reader=reader,
                batch_size=args.batch, size=(args.size, args.size),
                grid_shape=grid, class_names=names, shuffle=False,
                thread_num=threads, uint8=args.uint8)
            dt = time_reader(seq)
            emit(dict(reader=reader, threads=threads,
                      batches_per_s=len(seq) / dt, img_per_s=args.n / dt,
                      batch=args.batch, size=args.size, src_size=src,
                      n=args.n, uint8=args.uint8))
        if args.fit:
            for reader, threads in rows:
                if (reader, threads) == ("PIL", 1):
                    continue
                r = fit_ms_per_step(img_dir, lab_dir, names, args, reader,
                                    threads)
                emit(dict(fit=True, reader=reader, threads=threads,
                          batch=args.batch, size=args.size,
                          uint8=args.uint8, prefetch=args.prefetch,
                          card=card, **r))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "bench_reader.json"), "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
