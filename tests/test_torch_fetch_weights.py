"""The port's fetch_weights tool (``tf2_yolo_tpu_torch.tools.fetch_weights``)
through the cases of tests/test_fetch_weights.py, hermetically: every
URL but a ``file://`` one is refused in the test (no network is tried),
and the conversion runs on an h5 file that the port's own
``convert.save_reference_h5`` writes, found with ``--from-dir``.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.helpers_convert import remove_files_after_test  # noqa: F401
from tf2_yolo_tpu_torch import convert
from tf2_yolo_tpu_torch.models import YoloV4
from tf2_yolo_tpu_torch.tools import fetch_weights

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Only ``file://`` URLs open; any other is refused as a host that
    cannot be reached."""
    urlopen = urllib.request.urlopen

    def local_only(req, *args, **kwargs):
        url = req.full_url if hasattr(req, "full_url") else req
        if not url.startswith("file:"):
            raise urllib.error.URLError("no network in the tests")
        return urlopen(req, *args, **kwargs)

    monkeypatch.setattr(urllib.request, "urlopen", local_only)


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    d = tmp_path / "cache"
    monkeypatch.setenv("TF2_YOLO_TPU_TORCH_WEIGHTS", str(d))
    return d


def test_offline_is_per_item_noop(cache):
    lock = {}
    msg = fetch_weights.fetch_one(
        "pascal_voc", fetch_weights.MANIFEST["pascal_voc"], lock)
    assert "skipped" in msg
    assert lock == {}


def test_fetch_records_checksum_and_verifies(cache, tmp_path):
    src = tmp_path / "payload.bin"
    src.write_bytes(b"weights!" * 100)
    spec = {"url": src.as_uri(), "file": "payload.bin", "convert": None}

    lock = {}
    msg = fetch_weights.fetch_one("payload", spec, lock)
    assert "raw artifact cached" in msg
    assert len(lock["payload"]["sha256"]) == 64

    # a corrupted cached copy: the re-fetch flags the mismatch
    cached = cache / "payload.bin"
    cached.write_bytes(b"tampered")
    msg = fetch_weights.fetch_one("payload", spec, lock)
    assert "checksum mismatch" in msg
    assert (cache / "payload.bin.corrupt").exists()


def test_asset_install(cache, tmp_path):
    names = tmp_path / "names.txt"
    names.write_text("n001,thing\nn002,other\n")
    asset_dir = tmp_path / "assets"
    asset_dir.mkdir()
    spec = {"url": names.as_uri(), "file": "imagenet_classnames.txt",
            "convert": None, "asset": "imagenet_classnames.txt"}
    msg = fetch_weights.fetch_one("imagenet_classnames", spec, {},
                                  asset_dir=str(asset_dir))
    assert "asset installed" in msg
    assert (asset_dir / "imagenet_classnames.txt").read_text() \
        == names.read_text()


def test_the_default_asset_dir_is_the_ports():
    assert fetch_weights._ASSETS.endswith("tf2_yolo_tpu_torch/assets")
    assert (fetch_weights.MANIFEST["imagenet_classnames"]["asset"]
            == "imagenet_classnames.txt")


def test_conversion_failure_keeps_raw(cache, tmp_path):
    bad = tmp_path / "bad.h5"
    bad.write_bytes(b"not an h5 file")
    spec = {"url": bad.as_uri(), "file": "bad.h5",
            "convert": {"version": 4, "class_num": 80,
                        "input_shape": (64, 64, 3), "name": "x"}}
    msg = fetch_weights.fetch_one("bad", spec, {})
    assert "conversion failed" in msg
    assert (cache / "bad.h5").exists()


def test_conversion_from_dir_fills_the_ports_cache(cache, tmp_path):
    """A body-only v4 h5 (the stem's conv and BN, written by the port's
    ``save_reference_h5``) found under ``--from-dir``: converted into
    ``yolov4_<name>.pt``, which holds the stem's arrays."""
    model = YoloV4(np.full((9, 2), 0.3, np.float32), 80, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    h5w = convert.export_reference_weights(model, 4, 80)
    stem = dict(list(h5w.items())[:2])          # conv2d, batch_norm.
    up = tmp_path / "upstream" / "yolov4"
    up.mkdir(parents=True)
    convert.save_reference_h5(stem, str(up / "tf_keras_yolov4_body.h5"))
    spec = {"url": "https://unreachable.invalid/tf_keras_yolov4_body.h5",
            "file": "tf_keras_yolov4_body.h5",
            "convert": {"version": 4, "class_num": 80,
                        "input_shape": (64, 64, 3), "name": "fetched",
                        "body_only": True}}
    with pytest.warns(UserWarning, match="body-only"):
        msg = fetch_weights.fetch_one("v4", spec, {},
                                      from_dir=str(tmp_path / "upstream"))
    assert msg == f"converted -> {cache / 'yolov4_fetched.pt'}"
    state = torch.load(str(cache / "yolov4_fetched.pt"), weights_only=True)
    want = model.state_dict()
    for k in ("backbone.stem.conv.kernel", "backbone.stem.bn.scale",
              "backbone.stem.bn.var"):
        assert torch.equal(state[k], want[k]), k


def test_main_list_runs(cache, capsys):
    assert fetch_weights.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "ms_coco" in out and "github.com/samson6460" in out


def test_lock_written_by_main(cache, tmp_path):
    src = tmp_path / "f.bin"
    src.write_bytes(b"z")
    fetch_weights.MANIFEST["_tmp_test"] = {
        "url": src.as_uri(), "file": "f.bin", "convert": None}
    try:
        assert fetch_weights.main(["--only", "_tmp_test"]) == 0
    finally:
        del fetch_weights.MANIFEST["_tmp_test"]
    lock = json.loads((cache / "fetch_manifest.lock.json").read_text())
    assert "_tmp_test" in lock


def test_from_dir_ingests_without_network(cache, tmp_path):
    # a "checkout" holding the artifact under a nested path, found by
    # the upstream URL's file name
    checkout = tmp_path / "upstream" / "yolov3" / "models"
    checkout.mkdir(parents=True)
    (checkout / "imagenet_classnames.txt").write_text("n001,thing\n")
    asset_dir = tmp_path / "assets"
    asset_dir.mkdir()
    spec = {"url": "https://unreachable.invalid/imagenet_classnames.txt",
            "file": "imagenet_classnames.txt", "convert": None,
            "asset": "imagenet_classnames.txt"}
    msg = fetch_weights.fetch_one(
        "imagenet_classnames", spec, {}, asset_dir=str(asset_dir),
        from_dir=str(tmp_path / "upstream"))
    assert "asset installed" in msg
    assert (asset_dir / "imagenet_classnames.txt").read_text() \
        == "n001,thing\n"


def test_from_dir_prefers_exact_manifest_name(cache, tmp_path):
    # the csp entries share URL basenames with the darknet53 ones; an
    # exact spec["file"] match must beat a URL-basename match
    up = tmp_path / "up"
    up.mkdir()
    (up / "tf_keras_darknet53_448_include_top.h5").write_bytes(b"v3")
    (up / "tf_keras_cspdarknet53_448_include_top.h5").write_bytes(b"v4")
    src = fetch_weights._find_local(
        str(up), "tf_keras_cspdarknet53_448_include_top.h5",
        "https://x/tf_keras_darknet53_448_include_top.h5")
    assert src.endswith("tf_keras_cspdarknet53_448_include_top.h5")
    # the URL's base name when the exact name is absent
    src = fetch_weights._find_local(
        str(up), "not_there.h5",
        "https://x/tf_keras_darknet53_448_include_top.h5")
    assert src.endswith("tf_keras_darknet53_448_include_top.h5")


def test_force_offline_falls_back_to_cached_copy(cache, tmp_path):
    spec = {"url": "https://unreachable.invalid/f.bin",
            "file": "f.bin", "convert": None}
    dest = cache / "f.bin"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_bytes(b"cached-bytes")
    lock = {}
    msg = fetch_weights.fetch_one("f", spec, lock, force=True)
    # the re-fetch failed but the intact cached copy is processed
    assert "raw artifact cached" in msg
    assert len(lock["f"]["sha256"]) == 64
