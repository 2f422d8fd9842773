"""Bootstrap the port's pretrained-weight cache from the reference's
releases.

Port of tools/fetch_weights.py. The reference fetches four hosted weight
sets with ``tf.keras.utils.get_file`` (yolov3/models/darknet.py:15-17,
:57-65, :97-101; yolov4/models/darknet.py:14-17, :58-66, :138-144) and
ships ``imagenet_classnames.txt`` next to its models. This tool
downloads those artifacts, records and verifies their sha256 checksums,
converts the h5 files into the port's weight cache
(``convert.convert_to_cache``: ``yolov{N}_{name}.pt`` under
``facade_base.weights_cache_dir()``, ``$TF2_YOLO_TPU_TORCH_WEIGHTS``),
and drops the class-names file into ``tf2_yolo_tpu_torch/assets/``.

Offline behaviour: every download failure is a per-item no-op with a
message; the tool never raises on network absence, so it is safe to run
unconditionally, and a re-run resumes whatever is missing.

Usage:
    python -m tf2_yolo_tpu_torch.tools.fetch_weights          # all
    python -m tf2_yolo_tpu_torch.tools.fetch_weights --list   # status
    python -m tf2_yolo_tpu_torch.tools.fetch_weights --only ms_coco
    python -m tf2_yolo_tpu_torch.tools.fetch_weights --from-dir DIR
        # no network: ingest the artifacts from a local checkout or
        # download directory (found by file name, recursively)
"""

import argparse
import hashlib
import json
import os
import sys
import urllib.error
import urllib.request

from ..facade_base import weights_cache_dir

_RELEASES = "https://github.com/samson6460/tf2_YOLO/releases/download"
_RAW = "https://raw.githubusercontent.com/samson6460/tf2_YOLO/master"

# name -> spec. convert=None stores the raw artifact only. sha256=None
# until the first fetch records it in the lock file.
MANIFEST = {
    "pascal_voc": {
        "url": f"{_RELEASES}/1.0/tf_keras_yolov3_body.h5",
        "file": "tf_keras_yolov3_body.h5",
        "convert": {"version": 3, "class_num": 20,
                    "input_shape": (416, 416, 3), "name": "pascal_voc"},
        "sha256": None,
    },
    "ms_coco": {
        "url": f"{_RELEASES}/YOLOv4/tf_keras_yolov4_608_body.h5",
        "file": "tf_keras_yolov4_608_body.h5",
        "convert": {"version": 4, "class_num": 80,
                    "input_shape": (608, 608, 3), "name": "ms_coco"},
        "sha256": None,
    },
    "darknet53_imagenet_top": {
        "url": f"{_RELEASES}/Weights/tf_keras_darknet53_448_include_top.h5",
        "file": "tf_keras_darknet53_448_include_top.h5",
        "convert": {"version": 3, "class_num": 1000,
                    "input_shape": (448, 448, 3),
                    "name": "imagenet_top", "body_only": True},
        "sha256": None,
    },
    "darknet53_imagenet_notop": {
        "url": f"{_RELEASES}/Weights/tf_keras_darknet53_448_no_top.h5",
        "file": "tf_keras_darknet53_448_no_top.h5",
        "convert": {"version": 3, "class_num": 1000,
                    "input_shape": (448, 448, 3),
                    "name": "imagenet", "body_only": True},
        "sha256": None,
    },
    "csp_darknet53_imagenet_top": {
        "url": f"{_RELEASES}/YOLOv4/tf_keras_darknet53_448_include_top.h5",
        "file": "tf_keras_cspdarknet53_448_include_top.h5",
        "convert": {"version": 4, "class_num": 1000,
                    "input_shape": (448, 448, 3),
                    "name": "imagenet_top", "body_only": True},
        "sha256": None,
    },
    "csp_darknet53_imagenet_notop": {
        "url": f"{_RELEASES}/YOLOv4/tf_keras_darknet53_448_no_top.h5",
        "file": "tf_keras_cspdarknet53_448_no_top.h5",
        "convert": {"version": 4, "class_num": 1000,
                    "input_shape": (448, 448, 3),
                    "name": "imagenet", "body_only": True},
        "sha256": None,
    },
    "imagenet_classnames": {
        "url": f"{_RAW}/yolov3/models/imagenet_classnames.txt",
        "file": "imagenet_classnames.txt",
        "convert": None,
        "asset": "imagenet_classnames.txt",
        "sha256": None,
    },
}

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def _cache_dir():
    d = weights_cache_dir()
    os.makedirs(d, exist_ok=True)
    return d


def _lock_path():
    return os.path.join(_cache_dir(), "fetch_manifest.lock.json")


def _load_lock():
    try:
        with open(_lock_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _download(url, dest, timeout=60):
    tmp = dest + ".part"
    req = urllib.request.Request(
        url, headers={"User-Agent": "tf2-yolo-tpu-fetch/1.0"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r, \
                open(tmp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _find_local(root, filename, url):
    """A manifest artifact in a local directory tree: by the manifest's
    file name, else by the upstream file name of the URL (a reference
    checkout keeps imagenet_classnames.txt under yolov{3,4}/models/). The
    manifest's name always wins: several release URLs share a base name
    (the csp_darknet53 sets are hosted as 'tf_keras_darknet53_448_*.h5',
    as the darknet53 ones), so a match by URL alone could take the wrong
    weights."""
    url_name = url.rsplit("/", 1)[-1]
    fallback = None
    for dirpath, _, files in os.walk(root):
        if filename in files:
            return os.path.join(dirpath, filename)
        if fallback is None and url_name != filename \
                and url_name in files:
            fallback = os.path.join(dirpath, url_name)
    return fallback


def fetch_one(name, spec, lock, force=False, asset_dir=None,
              from_dir=None):
    """Fetch, verify and convert one manifest entry. Returns a status
    string; never raises on network errors."""
    dest = os.path.join(_cache_dir(), spec["file"])

    if not os.path.isfile(dest) or force:
        src = _find_local(from_dir, spec["file"], spec["url"]) \
            if from_dir else None
        if src is not None:
            with open(src, "rb") as s, open(dest, "wb") as d:
                d.write(s.read())
        else:
            try:
                _download(spec["url"], dest)
            except (urllib.error.URLError, OSError, ValueError) as e:
                if not os.path.isfile(dest):
                    return (f"offline/unreachable ({type(e).__name__}):"
                            " skipped")
                # a --force refetch failed but an intact copy is
                # cached: verify and convert it

    digest = _sha256(dest)
    expected = spec.get("sha256") or lock.get(name, {}).get("sha256")
    if expected and digest != expected:
        os.rename(dest, dest + ".corrupt")
        return (f"checksum mismatch (got {digest[:12]}..., expected "
                f"{expected[:12]}...): moved aside, re-run to refetch")
    lock[name] = {"sha256": digest, "url": spec["url"]}

    if spec.get("asset"):
        out = os.path.abspath(os.path.join(asset_dir or _ASSETS,
                                           spec["asset"]))
        with open(dest, "rb") as src, open(out, "wb") as dst:
            dst.write(src.read())
        return f"asset installed at {out}"

    conv = spec.get("convert")
    if conv is None:
        return f"raw artifact cached at {dest}"
    try:
        from ..convert import convert_to_cache
        kwargs = {k: v for k, v in conv.items() if k != "body_only"}
        out = convert_to_cache(dest, **kwargs)
        return f"converted -> {out}"
    except Exception as e:   # a failed conversion must not end the run
        return (f"downloaded to {dest} but conversion failed "
                f"({type(e).__name__}: {e}); raw h5 kept")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--list", action="store_true",
                    help="show manifest and cache status, no fetching")
    ap.add_argument("--only", nargs="*", default=None,
                    help="restrict to these manifest names")
    ap.add_argument("--force", action="store_true",
                    help="re-download even if cached")
    ap.add_argument("--from-dir", default=None,
                    help="ingest artifacts from a local directory tree "
                         "(e.g. a checkout of the upstream repo) "
                         "instead of the network")
    args = ap.parse_args(argv)

    lock = _load_lock()
    names = args.only or list(MANIFEST)
    unknown = [n for n in names if n not in MANIFEST]
    if unknown:
        ap.error(f"unknown manifest names: {unknown}")

    if args.list:
        for name in names:
            spec = MANIFEST[name]
            dest = os.path.join(_cache_dir(), spec["file"])
            status = "cached" if os.path.isfile(dest) else "missing"
            print(f"{name:32s} {status:8s} {spec['url']}")
        return 0

    for name in names:
        print(f"{name}: ", end="", flush=True)
        print(fetch_one(name, MANIFEST[name], lock, force=args.force,
                        from_dir=args.from_dir))

    with open(_lock_path(), "w") as f:
        json.dump(lock, f, indent=2, sort_keys=True)
    print(f"manifest lock: {_lock_path()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
