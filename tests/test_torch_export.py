"""The port's deployment path against the JAX package's: BatchNorm folding,
int8 calibration, the int8 ConvBN (the plain version of kernel Q), int8
serving, and the serving artifact (``torch.export`` programs in a
container), also through the facade's ``export_model``.

Whole-model comparisons run YOLOv4 (it has no width knob) at 96x96, batch
2, 3 classes, f32 on the CPU, as tests/test_torch_serving.py does. The
weights are the port's seeded init with each BN's running statistics set
to its conv output's batch statistics on the test batch (a trained
network's BN holds such statistics; the init ones shrink the heads'
inputs to nothing), bridged to the JAX package. At 64x64 the coarse
level's statistics come from 8 pixels and the network turns chaotic:
port and JAX outputs then differ by 1.5e-2, at 96x96 by 1.2e-3. The
random 107-layer stack amplifies f32 rounding about 1e4-fold, and int8
rounding as much: its int8 outputs differ from its float ones by up to
1.0, and a quantization flip anywhere moves every output. So int8
serving is held to the JAX package on a small detector of three
ConvBNs and a head (twins in both packages), whose int8 outputs agree
to f32 rounding, and the full YOLOv4 int8 program is held to the port's
own plain route on the card (chip_smoke.py phase 11).

The JAX forwards of the full model are jitted with the variables as
arguments (an eager forward compiles each primitive on its own, and a
closure over the weights makes XLA fold constants for a minute). The
int8 ConvBN is held to the JAX one applied eagerly: under jit XLA turns
x / sx and k / sw into products with reciprocals, which round otherwise
than the correctly rounded divisions of both eager JAX and the port.

The artifact's mechanics (buckets, padding, chunking, header, the custom
ops in the graph) are held on the small detector, whose export takes a
second, and the full YOLOv4 is exported once, through the facade, at
64x64.
"""
import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from tf2_yolo_tpu import export as jexport
from tf2_yolo_tpu.models import YoloV4 as JaxYoloV4
from tf2_yolo_tpu.models import layers as jlayers
from tf2_yolo_tpu.models.heads import AnchorHead as JAnchorHead
from tests.helpers_torch import numpy_tree
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch import export, yolov4
from tf2_yolo_tpu_torch.bridge import from_flax, to_flax
from tf2_yolo_tpu_torch.models import YoloV4
from tf2_yolo_tpu_torch.models.heads import AnchorHead
from tf2_yolo_tpu_torch.models.layers import ConvBN, Int8ConvBN
from tf2_yolo_tpu_torch.ops.kernels import conv_int8 as q

torch.set_num_threads(1)

CLASSES = 3
SIZE = 96
ANCHORS = np.stack([np.linspace(0.05, 0.75, 9),
                    np.linspace(0.07, 0.65, 9)], axis=1)


def _calibrate_bn(model, x):
    """Set every BN's mean/var to its conv output's batch statistics."""
    def hook(bn, out):
        y = out[0].float()
        bn.mean.copy_(y.mean(dim=(0, 1, 2)))
        bn.var.copy_(y.var(dim=(0, 1, 2), unbiased=False))

    handles = [m.conv.register_forward_hook(
        lambda conv, inputs, out, bn=m.bn: hook(bn, out))
        for m in model.modules() if isinstance(m, ConvBN) and m.bn is not None]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()


class _Apply:
    """A stand-in for the flax module in ``jexport.calibrate_int8``, whose
    ``apply`` is jitted (the calibration's own logic runs as it is); its
    outputs are the JAX forward's."""

    def __init__(self, module):
        self._fn = jax.jit(lambda v, x: module.apply(
            v, x, train=False, mutable=["quant_calib"]))

    def apply(self, variables, x, train=False, mutable=()):
        assert not train and list(mutable) == ["quant_calib"]
        return self._fn(variables, x)


def test_export_model_through_facade(tmp_path):
    """``Yolo.export_model`` with an int8 calibration (every ConvBN at a
    gate of 0), loaded and called against ``make_serving_fn`` on the same
    calibration. (One bucket: the mechanics of several are held below.)
    It runs first, before the module's fixtures hold their models."""
    size = 64
    yolo = yolov4.Yolo(input_shape=(size, size, 3),
                       class_names=["a", "b", "c"])
    yolo.create_model(anchors=ANCHORS, pretrained_body=None, device="cpu")
    module = yolo.model.module.eval()
    x = np.random.RandomState(3).rand(2, size, size, 3).astype(np.float32)
    _calibrate_bn(module, torch.from_numpy(x))
    path = yolo.export_model(tmp_path / "v4.bin", batch_size=2,
                             threshold=0.3, int8_calibration=[x],
                             int8_min_channels=0)
    loaded = export.load_serving(path)
    assert loaded.meta["int8"] and not loaded.meta["fold_bn"]
    assert loaded.meta["class_names"] == ["a", "b", "c"]
    assert loaded.meta["serving"]["int8_min_channels"] == 0
    serve = export.make_serving_fn(
        module, CLASSES, threshold=0.3,
        quant=export.calibrate_int8(module, [x]), int8_min_channels=0)
    assert sum(isinstance(m, Int8ConvBN)
               for m in serve.program.modules()) == 107
    rows, keep = loaded(x)
    want_rows, want_keep = serve(torch.from_numpy(x))
    assert torch.equal(rows, want_rows) and torch.equal(keep, want_keep)
    with pytest.raises(ValueError, match="platforms"):
        yolo.export_model(tmp_path / "p.bin", platforms=("tpu",))


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(0)
    x = rng.rand(2, SIZE, SIZE, 3).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    model = YoloV4(ANCHORS, CLASSES, generator=gen, device="cpu").eval()
    _calibrate_bn(model, torch.from_numpy(x))
    # one jitted JAX forward (with the calibration's capture) serves the
    # folded outputs and the calibration: one YOLOv4 compile, not two
    japply = _Apply(JaxYoloV4(anchors=ANCHORS, class_num=CLASSES))
    variables = to_flax(model.state_dict())
    return dict(x=x, model=model, japply=japply, variables=variables,
                # eager, as it is called (under jit XLA contracts
                # bias - mean * scale into one rounding)
                folded=numpy_tree(jexport.fold_batch_norm(variables)))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


# ----------------------------------------------------------------------
def test_fold_batch_norm_matches_jax(pair):
    want = dict(_leaves(pair["folded"]))
    got = dict(_leaves(to_flax(export.fold_batch_norm(
        pair["model"].state_dict()))))
    assert got.keys() == want.keys()
    # measured: every leaf equal bit for bit; bound 1 f32 ulp
    for k in want:
        np.testing.assert_array_max_ulp(got[k], want[k], maxulp=1)
    bns = [k for k in want if k.endswith("/bn/var")]
    assert len(bns) == 107
    for k in bns:
        assert (want[k] == np.float32(1 - 1e-3)).all()
        assert (got[k[:-len("var")] + "mean"] == 0).all()
        assert (got[k.replace("batch_stats/", "params/")[:-len("var")]
                    + "scale"] == 1).all()


def test_folded_model_matches_jax(pair):
    """The port's folded model against the JAX one on the same folded
    weights, and against the unfolded port model."""
    folded = export.folded_copy(pair["model"])
    x = torch.from_numpy(pair["x"])
    with torch.no_grad():
        got = [o.numpy() for o in folded(x)]
        base = [o.numpy() for o in pair["model"](x)]
    outs, _ = pair["japply"].apply(pair["folded"], jnp.asarray(pair["x"]),
                                   mutable=["quant_calib"])
    want = [np.asarray(o) for o in outs]
    # f32 rounding amplified by the random stack (tests/test_torch_serving
    # bounds port against JAX by 5e-3); measured 1.5e-3 folded port
    # against folded JAX and 2.2e-3 folded against unfolded port (max
    # |out| 1.36); bound 5e-3.
    for g, w, b in zip(got, want, base):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-3)
        np.testing.assert_allclose(g, b, rtol=0, atol=5e-3)


def _jax_quant(pair):
    return jexport.calibrate_int8(pair["japply"], pair["variables"],
                                  [pair["x"]])


def test_calibrate_int8_matches_jax(pair):
    want = dict(_leaves(numpy_tree(_jax_quant(pair))))
    got = dict(_leaves(export.calibrate_int8(pair["model"], [pair["x"]])))
    assert got.keys() == want.keys()
    names = {n for n, m in pair["model"].named_modules()
             if isinstance(m, ConvBN) and m.bn is not None}
    assert {k[len("quant/"):-len("/in_scale")] for k in got} \
        == {n.replace(".", "/") for n in names}
    assert len(names) == 107
    # Each scale is max |x| / 127 of its layer's input, so it carries the
    # f32 noise of the forward so far: measured median 8.6e-7 relative,
    # largest 7.8e-4 (bu2.conv5, 100 layers deep). Bounds 1e-5 on the
    # median and 2e-3 on each; the small detector below holds every
    # scale at 1e-5.
    rel = np.array([abs(got[k] - want[k]) / want[k] for k in want])
    assert all(want[k].shape == got[k].shape == () for k in want)
    assert np.median(rel) <= 1e-5 and rel.max() <= 2e-3, rel.max()
    assert pair["model"].training is False


# ----------------------------------------------------------------------
# One ConvBN: the plain int8 route of the port against ``_quant_call``.
# (name, Ci, Co, kernel, stride, act): a 1x1, a 3x3 s1 and a 3x3 s2
# darknet-pad case, and one with min(Ci, Co) = 256 for the gate.
CONVBN_CASES = [
    ("1x1", 24, 40, 1, 1, "leaky"),
    ("3x3s1", 16, 32, 3, 1, "mish"),
    ("3x3s2", 32, 24, 3, 2, "leaky"),
    ("3x3s1 256", 256, 256, 3, 1, "mish"),
]


def _convbn_case(ci, co, k, stride, act, seed):
    rng = np.random.RandomState(seed)
    x = (rng.rand(2, 10, 8, ci) * 2 - 1).astype(np.float32)
    jm = jlayers.ConvBN(co, k, stride, act=act, fused=False)
    v = numpy_tree(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    v["params"]["bn"]["scale"] = (1 + 0.2 * rng.randn(co)).astype(np.float32)
    v["params"]["bn"]["bias"] = (0.1 * rng.randn(co)).astype(np.float32)
    v["batch_stats"]["bn"]["mean"] = (0.05 * rng.randn(co)).astype(
        np.float32)
    v["batch_stats"]["bn"]["var"] = (0.5 + rng.rand(co)).astype(np.float32)
    tm = ConvBN(ci, co, k, stride, act=act, device="cpu").eval()
    tm.load_state_dict(from_flax(v), strict=True)
    sx = np.float32(np.maximum(np.abs(x).max(), 1e-6) / np.float32(127))
    return x, jm, v, tm, sx


@pytest.mark.parametrize("gate", [0, 256])
@pytest.mark.parametrize("case", CONVBN_CASES, ids=[c[0] for c in
                                                    CONVBN_CASES])
def test_int8_convbn_matches_jax(case, gate):
    name, ci, co, k, stride, act = case
    x, jm, v, tm, sx = _convbn_case(ci, co, k, stride, act,
                                    CONVBN_CASES.index(case))
    prev = jlayers.INT8_MIN_CHANNELS
    jlayers.set_int8_min_channels(gate)
    try:
        # eager, the scale an argument: each division compiled alone
        want = np.asarray(jm.apply({**v, "quant": {"in_scale": sx}},
                                   jnp.asarray(x), train=False))
    finally:
        jlayers.set_int8_min_channels(prev)
    served = export._serving_copy(tm, {"quant": {"in_scale": sx}}, gate)
    quantized = min(ci, co) >= gate
    assert isinstance(served, Int8ConvBN) == quantized
    with torch.no_grad():
        got = served(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    if quantized:
        # the int8 inputs: equal (a flip would be counted and bounded;
        # measured none)
        xq = q.quantize_int8_plain(torch.from_numpy(x), float(sx)).numpy()
        jxq = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / sx), -127,
                                  127).astype(jnp.int8))
        assert (xq != jxq).sum() == 0
        wq, _ = q.quantize_weights(tm.conv.kernel)
        kf = jnp.asarray(v["params"]["conv"]["kernel"])
        sw = jnp.maximum(jnp.max(jnp.abs(kf), axis=(0, 1, 2)), 1e-8) / 127.0
        jwq = np.asarray(jnp.clip(jnp.round(kf / sw), -127, 127))
        assert (wq.numpy() != jwq).sum() == 0
    # f32 outputs: the same int32 sums; the affine's rsqrt from another
    # library, and XLA may contract its multiply-add. Measured max |d|
    # 9.5e-7 at max |out| 2.7 (3.5e-7 relative) in either route; bound
    # 1e-6 relative to max |out|.
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_int8_kernel_geometry_and_plan():
    """The plain version against a direct f64 conv of the same int8
    values, and the launch plan of every YOLOv4 shape (pure Python)."""
    rng = np.random.RandomState(5)
    for ci, co, k, stride in [(3, 32, 3, 1), (64, 40, 3, 2), (32, 16, 1, 1)]:
        x = torch.from_numpy(rng.randn(2, 6, 8, ci).astype(np.float32))
        wq8, _ = q.quantize_weights(torch.from_numpy(
            rng.randn(k, k, ci, co).astype(np.float32)))
        c = torch.from_numpy(rng.rand(co).astype(np.float32))
        t = torch.from_numpy(rng.randn(co).astype(np.float32))
        y = q.conv_int8(x, q.weight_layout(wq8), c, t, 0.02, k, stride,
                        torch.float32)
        xq = q.quantize_int8_plain(x, 0.02).double().permute(0, 3, 1, 2)
        if stride == 2:
            xq = torch.nn.functional.pad(xq, (1, 0, 1, 0))
        acc = torch.nn.functional.conv2d(
            xq, wq8.double().permute(3, 2, 0, 1), stride=stride,
            padding=k // 2 if stride == 1 else 0)
        want = (acc.float() * c.view(1, -1, 1, 1) + t.view(1, -1, 1, 1))
        torch.testing.assert_close(y, want.permute(0, 2, 3, 1),
                                   rtol=0, atol=0)
    assert q._plan(8, 416, 416, 3, 32, 3, 1) == q.Plan(
        "gather", 3, (10816, 1), 32, 1, 4)
    assert q._plan(8, 13, 13, 512, 1024, 3, 1) == q.Plan(
        "ring", 1, (11, 8), 4608, 2, 6)
    assert q._plan(8, 52, 52, 256, 128, 1, 1).route == "ring"
    with pytest.raises(ValueError, match="even"):
        q._plan(1, 9, 8, 32, 32, 3, 2)
    with pytest.raises(ValueError, match="unsupported conv"):
        q._plan(1, 8, 8, 32, 32, 5, 1)
    x = torch.zeros(1, 4, 4, 32)
    w = torch.zeros(8, 32, dtype=torch.int8)
    one = torch.ones(8)
    with pytest.raises(TypeError):
        q.conv_int8(x, w.float(), one, one, 0.1, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="positive"):
        q.conv_int8(x, w, one, one, 0.0, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="mismatch"):
        q.conv_int8(x, w, one, one, 0.1, 3, 1, torch.float32)


def _kept(rows, keep):
    kept = np.asarray(rows)[np.asarray(keep)]
    return kept[np.lexsort(kept.T[::-1])]


# ----------------------------------------------------------------------
TINY = 32
TINY_CLASSES = 2
TINY_ANCHORS = np.array([[0.1, 0.15], [0.3, 0.25], [0.5, 0.6]], np.float32)
TINY_THRESHOLD = 0.3


class _JTiny(fnn.Module):
    """The small detector in flax: the stem-like Ci = 3 conv takes the
    int8 kernel's gather route, the others its ring route."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = jlayers.ConvBN(32, 3, 2, act="leaky", fused=False,
                           name="c1")(x, train)
        x = jlayers.ConvBN(64, 3, 2, act="mish", fused=False,
                           name="c2")(x, train)
        x = jlayers.ConvBN(32, 1, 1, act="leaky", fused=False,
                           name="c3")(x, train)
        return JAnchorHead(TINY_ANCHORS, TINY_CLASSES, prob_act="sigmoid",
                           anchors_as_params=True, name="head")(x)


class _Tiny(torch.nn.Module):
    """Its torch twin, with the same names."""

    def __init__(self):
        super().__init__()
        self.c1 = ConvBN(3, 32, 3, 2, act="leaky", device="cpu")
        self.c2 = ConvBN(32, 64, 3, 2, act="mish", device="cpu")
        self.c3 = ConvBN(64, 32, 1, 1, act="leaky", device="cpu")
        self.head = AnchorHead(32, TINY_ANCHORS, TINY_CLASSES, device="cpu")

    def forward(self, x):
        return self.head(self.c3(self.c2(self.c1(x))))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The twins on one set of weights (JAX init, BN statistics from the
    port's forward), the port's calibration, and two artifacts of the
    port model, buckets [2, 4]: BN folded, and int8 (every ConvBN)."""
    x = np.random.RandomState(2).rand(5, TINY, TINY, 3).astype(np.float32)
    jmodel = _JTiny()
    init = numpy_tree(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    model = _Tiny().eval()
    model.load_state_dict(from_flax(init), strict=True)
    xt = torch.from_numpy(x)
    _calibrate_bn(model, xt)
    quant = export.calibrate_int8(model, [xt[:2], xt[2:]])
    d = tmp_path_factory.mktemp("artifact")
    paths = {}
    for kind, kw in (("folded", {}),
                     ("int8", dict(fold_bn=False, quant=quant))):
        paths[kind] = export.save_serving(
            d / f"{kind}.bin", model, (TINY, TINY, 3), [4, 2],
            TINY_CLASSES, 4, class_names=["a", "b"],
            threshold=TINY_THRESHOLD, **kw)
    return dict(model=model, x=xt, quant=quant, paths=paths, jmodel=jmodel,
                variables=to_flax(model.state_dict()))


def test_int8_serving_matches_jax(tiny):
    """``make_serving_fn(quant=...)`` against the JAX package's on the
    same calibration: the JAX tree, bridged, and the port's own."""
    x = tiny["x"].numpy()
    jquant = numpy_tree(jexport.calibrate_int8(tiny["jmodel"],
                                               tiny["variables"],
                                               [x[:2], x[2:]]))
    got_quant = dict(_leaves(tiny["quant"]))
    want_quant = dict(_leaves(jquant))
    assert got_quant.keys() == want_quant.keys() and len(want_quant) == 3
    # measured equal; bound 1e-5 relative
    for k, w in want_quant.items():
        assert abs(got_quant[k] - w) <= 1e-5 * w, k
    jrows, jkeep = jexport.make_serving_fn(
        tiny["jmodel"], tiny["variables"], TINY_CLASSES, 4,
        threshold=TINY_THRESHOLD, quant=jquant)(jnp.asarray(x))
    joint = np.asarray(jrows[..., 4] * jrows[..., 6])
    for quant in (from_flax(jquant), tiny["quant"]):
        serve = export.make_serving_fn(tiny["model"], TINY_CLASSES, 4,
                                       threshold=TINY_THRESHOLD, quant=quant)
        assert sum(isinstance(m, Int8ConvBN)
                   for m in serve.program.modules()) == 3
        rows, keep = serve(tiny["x"])
        want, got = _kept(jrows, jkeep), _kept(rows.numpy(), keep.numpy())
        assert 0 < len(want) < int((joint >= TINY_THRESHOLD).sum())
        assert got.shape == want.shape
        # class ids exact; the rest measured 1.4e-6 (of the JAX tree and
        # of the port's); bound 1e-5
        np.testing.assert_array_equal(got[:, 5], want[:, 5])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not any(isinstance(m, Int8ConvBN)
                   for m in tiny["model"].modules())


def _dispatched(serve, x, buckets):
    """What a loaded artifact with ``buckets`` must return for ``x``:
    ``serve`` on the smallest bucket that fits, zero-padded, or on chunks
    of the largest."""
    n = x.shape[0]
    fit = [b for b in buckets if b >= n]
    if not fit:
        parts = [_dispatched(serve, x[lo:lo + buckets[-1]], buckets)
                 for lo in range(0, n, buckets[-1])]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    pad = x.new_zeros((fit[0] - n, *x.shape[1:]))
    rows, keep = serve(torch.cat([x, pad]))
    return rows[:n], keep[:n]


def test_artifact_equals_serving_fn(tiny):
    """Save -> load -> call equals ``make_serving_fn`` bit for bit: at a
    bucket's batch, padded into a bucket, and chunked through the
    largest bucket (5 = 4 + 1 padded into 2)."""
    model, x = tiny["model"], tiny["x"]
    for kind in ("folded", "int8"):
        loaded = export.load_serving(tiny["paths"][kind])
        assert loaded.batch_sizes == [2, 4]
        if kind == "folded":
            serve = export.make_serving_fn(
                export.folded_copy(model), TINY_CLASSES,
                threshold=TINY_THRESHOLD)
        else:
            serve = export.make_serving_fn(
                model, TINY_CLASSES, threshold=TINY_THRESHOLD,
                quant=tiny["quant"])
        for n in (4, 2, 3, 1, 5):
            rows, keep = loaded(x[:n].numpy())
            want_rows, want_keep = _dispatched(serve, x[:n], [2, 4])
            assert rows.shape == (n, 128, 7) and keep.dtype == torch.bool
            assert torch.equal(rows, want_rows), (kind, n)
            assert torch.equal(keep, want_keep), (kind, n)
        assert 0 < int(keep.sum())


def test_artifact_header(tiny):
    model = tiny["model"]
    meta = {k: export.load_serving(p).meta for k, p in tiny["paths"].items()}
    for kind, m in meta.items():
        assert m["framework"] == "tf2_yolo_tpu_torch"
        assert m["format"] == 1 and m["yolo_version"] == 4
        assert m["input_shape"] == [TINY, TINY, 3]
        assert m["class_num"] == TINY_CLASSES
        assert m["class_names"] == ["a", "b"]
        assert m["platforms"] is None and m["device"] == "cpu"
        assert [b["batch_size"] for b in m["buckets"]] == [2, 4]
        assert "quant" not in m["serving"]
        assert m["serving"]["threshold"] == TINY_THRESHOLD
    assert meta["folded"]["fold_bn"] and not meta["folded"]["int8"]
    assert meta["int8"]["int8"] and not meta["int8"]["fold_bn"]
    with open(tiny["paths"]["int8"], "rb") as f:
        assert f.read(8) == export.MAGIC != jexport._MAGIC
    assert not any(isinstance(m, Int8ConvBN) for m in model.modules())


def test_artifact_runs_the_custom_ops(tiny):
    """The exported graph calls the kernels' custom ops (on the card the
    kernels, here their plain versions), not inlined plain code."""
    def ops(path):
        gm = next(iter(export.load_serving(path)._fns.values()))
        names = [str(n.target) for n in gm.graph.nodes
                 if n.op == "call_function"]
        return {op: sum(f".{op}." in n for n in names)
                for op in ("conv_bn_forward", "conv_int8", "nms_keep",
                           "soft_nms_keep")}
    assert ops(tiny["paths"]["folded"]) == dict(
        conv_bn_forward=4, conv_int8=0, nms_keep=1, soft_nms_keep=0)
    assert ops(tiny["paths"]["int8"]) == dict(
        conv_bn_forward=1, conv_int8=3, nms_keep=1, soft_nms_keep=0)


def test_artifact_refusals(tiny, tmp_path):
    jax_file = tmp_path / "jax.bin"
    jax_file.write_bytes(jexport._MAGIC + (2).to_bytes(8, "big") + b"{}")
    with pytest.raises(ValueError, match="JAX package"):
        export.load_serving(jax_file)
    other = tmp_path / "other.bin"
    other.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not a tf2_yolo_tpu_torch"):
        export.load_serving(other)
    with pytest.raises(ValueError, match="platforms"):
        export.save_serving(tmp_path / "p.bin", tiny["model"],
                            (TINY, TINY, 3), 1, TINY_CLASSES, 4,
                            platforms=("cpu",))
    with pytest.raises(ValueError, match="sample batch"):
        export.calibrate_int8(tiny["model"], [])
    with pytest.raises(ValueError, match="on its own"):
        from_flax({"params": {}, "quant": {}})
