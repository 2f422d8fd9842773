"""The port's ``engine.Model`` against the JAX package's on a small module
pair: three ConvBNs and a v4 anchor head, a flax twin defined here and a
torch twin on the same (bridged) weights, in f32 on the CPU. ``fit``
(history and parameters after two epochs), ``evaluate`` and ``predict``
(ragged batches) are held to the JAX engine; uint8 feeding, prefetch,
checkpoint resume (after an epoch and after a SIGTERM mid-epoch) and the
learning-rate multiplier to the port's own uninterrupted run, bit for
bit; the callbacks to the JAX package's on the same logs. The module is
small and its gradients are not chaotic, so the comparisons are sharp."""

import os
import signal

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.helpers_torch import flat, numpy_tree
from tf2_yolo_tpu import engine as jengine
from tf2_yolo_tpu.models import layers as jlayers
from tf2_yolo_tpu.models.heads import AnchorHead as JAnchorHead
from tf2_yolo_tpu.ops import metrics as jmetrics
from tf2_yolo_tpu.ops import wrap_yolo_loss_v4 as jwrap_yolo_loss_v4
from tf2_yolo_tpu_torch import bridge, engine
from tf2_yolo_tpu_torch.models.heads import AnchorHead
from tf2_yolo_tpu_torch.models.layers import ConvBN
from tf2_yolo_tpu_torch.ops import metrics
from tf2_yolo_tpu_torch.ops.losses import wrap_yolo_loss_v4

torch.set_num_threads(1)

SIZE, GRID, CLASSES, N = 32, 8, 2, 8
ANCHORS = np.array([[0.1, 0.15], [0.3, 0.25], [0.5, 0.6]], np.float32)
METRICS = ("wrap_obj_acc", "wrap_mean_iou", "wrap_class_acc", "wrap_recall")


class JNet(fnn.Module):
    """The flax twin."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = jlayers.ConvBN(8, 3, 2, act="leaky", name="c1")(x, train)
        x = jlayers.ConvBN(16, 3, 2, act="mish", name="c2")(x, train)
        x = jlayers.ConvBN(16, 1, 1, act="leaky", name="c3")(x, train)
        return JAnchorHead(ANCHORS, CLASSES, prob_act="sigmoid",
                           anchors_as_params=True, name="head")(x)


class TNet(torch.nn.Module):
    """The torch twin: the same names, so the bridge maps one onto the
    other."""

    def __init__(self):
        super().__init__()
        self.c1 = ConvBN(3, 8, 3, 2, act="leaky", device="cpu")
        self.c2 = ConvBN(8, 16, 3, 2, act="mish", device="cpu")
        self.c3 = ConvBN(16, 16, 1, 1, act="leaky", device="cpu")
        self.head = AnchorHead(16, ANCHORS, CLASSES, device="cpu")

    def forward(self, x):
        return self.head(self.c3(self.c2(self.c1(x))))


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    x8 = rng.randint(0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)
    y = np.zeros((n, GRID, GRID, 5 + CLASSES), np.float32)
    for b in range(n):
        for _ in range(3):
            gy, gx = rng.randint(0, GRID, 2)
            y[b, gy, gx, :5] = [*rng.rand(2), *(0.1 + 0.4 * rng.rand(2)), 1]
            y[b, gy, gx, 5 + rng.randint(CLASSES)] = 1.0
    # the float images as the device makes them from uint8: f32 * f32
    return x8, x8.astype(np.float32) * np.float32(1 / 255), y


def _closures(wrap_loss, mod):
    loss = wrap_loss((GRID, GRID), 3, CLASSES, ANCHORS)
    fns = [getattr(mod, name)((GRID, GRID), 3, CLASSES) for name in METRICS]
    return loss, fns


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine's run, once: initial variables, fit history and
    parameters after two epochs, evaluate and predict."""
    x8, x, y = _data()
    m = jengine.Model(JNet(), (SIZE, SIZE, 3), seed=0)
    start = bridge.from_flax(numpy_tree(m.variables))
    loss, fns = _closures(jwrap_yolo_loss_v4, jmetrics)
    m.compile("adam", loss=loss, metrics=fns, learning_rate=1e-3)
    hist = m.fit(x, y, epochs=2, batch_size=4, seed=3, verbose=0)
    out = dict(start=start, hist=hist,
               params=flat(numpy_tree(m.params), "params/"),
               stats=flat(numpy_tree(m.batch_stats), "batch_stats/"),
               evaluate=m.evaluate(x, y, batch_size=3, verbose=0),
               predict=m.predict(x[:7], batch_size=3))
    del m
    jax.clear_caches()
    return out


def _port(start, **compile_kw):
    m = engine.Model(TNet(), (SIZE, SIZE, 3), device="cpu")
    m.set_variables(start)
    loss, fns = _closures(wrap_yolo_loss_v4, metrics)
    kw = dict(loss=loss, metrics=fns, learning_rate=1e-3)
    kw.update(compile_kw)
    m.compile("adam", **kw)
    return m


def _assert_same_params(a, b):
    for (ka, va), (kb, vb) in zip(a.module.state_dict().items(),
                                  b.module.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_fit_evaluate_predict_match_jax(jax_run):
    x8, x, y = _data()
    m = _port(jax_run["start"])
    hist = m.fit(x, y, epochs=2, batch_size=4, seed=3, verbose=0)
    want = jax_run["hist"]
    assert set(hist) == set(want) == {"loss", "obj_acc", "mean_iou",
                                      "class_acc", "recall", "epoch_time"}
    for k in ("loss", "obj_acc", "mean_iou", "class_acc", "recall"):
        # measured: largest relative difference 1.8e-7 (mean_iou)
        np.testing.assert_allclose(hist[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    leaves = {k: v.detach().numpy()
              for k, v in bridge.flax_leaves(m.module).items()}
    ref = {**jax_run["params"], **jax_run["stats"]}
    assert set(leaves) == set(ref)
    # measured: largest relative L2 per leaf 3.0e-6 after 4 Adam steps
    # (2.6e-6 against JAX on one device instead of the suite's eight)
    worst = max(_rel(leaves[k], v) for k, v in ref.items())
    assert worst <= 1e-5, worst

    ev = m.evaluate(x, y, batch_size=3, verbose=0)
    assert set(ev) == set(jax_run["evaluate"])
    for k, v in ev.items():
        # measured: largest relative difference 8.5e-8
        np.testing.assert_allclose(v, jax_run["evaluate"][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    pred = m.predict(x[:7], batch_size=3)       # batches of 3, 3 and 1
    assert pred.shape == jax_run["predict"].shape == (7, GRID, GRID, 21)
    # measured: relative L2 6.7e-8
    assert _rel(pred, jax_run["predict"]) <= 1e-5


def test_predict_rows_uint8_and_empty(jax_run):
    x8, x, _ = _data()
    m = _port(jax_run["start"])
    whole = m.predict(x, batch_size=N)
    for bs in (1, 3, 5):                     # ragged tails, no padding
        assert np.array_equal(m.predict(x, batch_size=bs), whole), bs
    assert np.array_equal(m.predict(x8, batch_size=3), whole)
    empty = m.predict(x[:0])
    assert empty.shape == (0, GRID, GRID, 21) and empty.dtype == np.float32


def test_uint8_feed_trains_as_float(jax_run):
    x8, x, y = _data()
    a, b = _port(jax_run["start"]), _port(jax_run["start"])
    ha = a.fit(x8, y, epochs=2, batch_size=4, seed=3, verbose=0)
    hb = b.fit(x, y, epochs=2, batch_size=4, seed=3, verbose=0)
    assert ha["loss"] == hb["loss"]
    _assert_same_params(a, b)


def test_prefetch_matches_inline(jax_run):
    x8, x, y = _data()
    a, b = _port(jax_run["start"]), _port(jax_run["start"])
    ha = a.fit(x, y, epochs=2, batch_size=3, seed=5, verbose=0, prefetch=2)
    hb = b.fit(x, y, epochs=2, batch_size=3, seed=5, verbose=0)
    assert ha["loss"] == hb["loss"] and ha["recall"] == hb["recall"]
    _assert_same_params(a, b)


def test_fit_resume_is_bit_exact(jax_run, tmp_path):
    """Two epochs, then a new Model resumes to the four-epoch target:
    the same parameters, optimizer moments and step as one run of four;
    a resume past the target is a no-op. Periodic checkpoints written in
    the background, the oldest pruned."""
    x8, x, y = _data()
    ref = _port(jax_run["start"])
    ref.fit(x, y, epochs=4, batch_size=3, seed=11, verbose=0)

    ck = str(tmp_path / "ck")
    m1 = _port(jax_run["start"])
    m1.fit(x, y, epochs=2, batch_size=3, seed=11, verbose=0,
           checkpoint_dir=ck, checkpoint_every=1, checkpoint_async=True,
           checkpoint_keep=1)
    assert sorted(os.listdir(ck)) == ["step_6"]
    m2 = _port(jax_run["start"])
    hist = m2.fit(x, y, epochs=4, batch_size=3, seed=11, verbose=0,
                  checkpoint_dir=ck, checkpoint_every=1, resume=True)
    assert len(hist["loss"]) == 2 and m2._state.step == 12
    _assert_same_params(ref, m2)
    for a, b in zip(ref._state.optimizer.state.values(),
                    m2._state.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)

    m3 = _port(jax_run["start"])
    assert m3.fit(x, y, epochs=4, batch_size=3, seed=11, verbose=0,
                  checkpoint_dir=ck, resume=True)["loss"] == []
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _port(jax_run["start"]).fit(x, y, verbose=0, resume=True)


def test_sigterm_mid_epoch_then_resume_is_bit_exact(jax_run, tmp_path):
    x8, x, y = _data()
    ref = _port(jax_run["start"])
    ref.fit(x, y, epochs=3, batch_size=4, seed=11, verbose=0)

    class KillAtStep:
        seen = 0

        def on_train_batch_end(self, batch, logs, model):
            self.seen += 1
            if self.seen == 3:                 # a real SIGTERM
                os.kill(os.getpid(), signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    ck = str(tmp_path / "ck")
    m1 = _port(jax_run["start"])
    # two steps an epoch: killed after step 3, in the middle of epoch 2
    hist = m1.fit(x, y, epochs=3, batch_size=4, seed=11, verbose=0,
                  checkpoint_dir=ck, checkpoint_on_interrupt=True,
                  callbacks=[KillAtStep()])
    assert signal.getsignal(signal.SIGTERM) is prev      # restored
    assert len(hist["loss"]) == 1 and m1._state.step == 3

    m2 = _port(jax_run["start"])
    m2.fit(x, y, epochs=3, batch_size=4, seed=11, verbose=0,
           checkpoint_dir=ck, resume=True)
    assert m2._state.step == 6
    _assert_same_params(ref, m2)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _port(jax_run["start"]).fit(x, y, verbose=0,
                                    checkpoint_on_interrupt=True)


def test_lr_multiplier_survives_resume(jax_run, tmp_path):
    x8, x, y = _data()
    ck = str(tmp_path / "ck")
    m1 = _port(jax_run["start"])
    m1.lr_multiplier = 0.25
    m1.fit(x, y, epochs=1, batch_size=4, seed=11, verbose=0,
           checkpoint_dir=ck, checkpoint_every=1)
    m2 = _port(jax_run["start"])
    assert m2.lr_multiplier == 1.0
    m2.fit(x, y, epochs=2, batch_size=4, seed=11, verbose=0,
           checkpoint_dir=ck, resume=True)
    assert m2.lr_multiplier == 0.25


class _Fake:
    """What the callbacks read and write of a Model."""

    def __init__(self):
        self.stop_training = False
        self.lr_multiplier = 1.0
        self._base_lr = 1e-3
        self.saved = []

    def save_weights(self, path):
        self.saved.append(path)


# each callback fed the same epoch logs in both packages; what each
# decides (stop, the multiplier, files saved, the CSV) must agree
LOSSES = [3.0, 2.0, 2.5, 2.6, float("nan"), 2.7]
CALLBACKS = {
    "EarlyStopping": lambda mod, d: mod.EarlyStopping(patience=2),
    "ModelCheckpoint": lambda mod, d: mod.ModelCheckpoint(
        os.path.join(d, "w{epoch}.pt"), monitor="val_recall"),
    "ReduceLROnPlateau": lambda mod, d: mod.ReduceLROnPlateau(
        factor=0.5, patience=1, cooldown=1),
    "TerminateOnNaN": lambda mod, d: mod.TerminateOnNaN(),
    "LearningRateScheduler": lambda mod, d: mod.LearningRateScheduler(
        lambda epoch, lr: lr * 0.9 if epoch else lr),
    "CSVLogger": lambda mod, d: mod.CSVLogger(os.path.join(d, "log.csv")),
}


@pytest.mark.parametrize("name", sorted(CALLBACKS))
def test_callback_decisions_match_jax(name, tmp_path):
    seen = {}
    for pkg, mod in (("jax", jengine), ("torch", engine)):
        d = tmp_path / pkg
        d.mkdir()
        cb, fake = CALLBACKS[name](mod, str(d)), _Fake()
        trace = []
        for epoch, loss in enumerate(LOSSES):
            if hasattr(cb, "on_epoch_begin"):
                cb.on_epoch_begin(epoch, fake)
            if hasattr(cb, "on_epoch_end"):
                cb.on_epoch_end(epoch, {"loss": loss,
                                        "val_recall": 0.1 * (epoch % 3)},
                                fake)
            trace.append((fake.stop_training, fake.lr_multiplier,
                          [os.path.basename(p) for p in fake.saved]))
        files = {f: (d / f).read_text() for f in os.listdir(d)}
        seen[pkg] = trace, files
    assert seen["torch"] == seen["jax"]


def test_callbacks_in_fit(jax_run, tmp_path):
    """The callbacks on a real fit: batch logs are device tensors, the
    multiplier and the CSV move, and TerminateOnNaN reads per batch
    only when asked."""
    x8, x, y = _data()
    m = _port(jax_run["start"])
    batch_logs = []

    class Spy:
        def on_train_batch_end(self, batch, logs, model):
            batch_logs.append(logs)

    csv = tmp_path / "log.csv"
    m.fit(x, y, epochs=3, batch_size=4, seed=0, verbose=0,
          validation_data=(x, y),
          callbacks=[Spy(), engine.TerminateOnNaN(on_batch=True),
                     engine.ReduceLROnPlateau(monitor="val_loss",
                                              factor=0.5, patience=1,
                                              min_delta=1e9),
                     engine.CSVLogger(csv),
                     engine.ModelCheckpoint(tmp_path / "w{epoch}.pt",
                                            save_best_only=False)])
    assert len(batch_logs) == 6
    assert all(torch.is_tensor(v) and v.dim() == 0
               for logs in batch_logs for v in logs.values())
    assert m.lr_multiplier == 0.25       # halved after epochs 2 and 3
    rows = csv.read_text().splitlines()
    assert len(rows) == 4 and rows[0].startswith("epoch,class_acc")
    w = _port(jax_run["start"])
    w.load_weights(tmp_path / "w3.pt")
    _assert_same_params(w, m)


def test_profile_dir_writes_a_trace(jax_run, tmp_path):
    x8, x, y = _data()
    m = _port(jax_run["start"])
    m.fit(x, y, epochs=2, batch_size=4, verbose=0,
          profile_dir=str(tmp_path / "prof"))
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_weights_round_trip_and_variables(jax_run, tmp_path):
    x8, x, y = _data()
    m = _port(jax_run["start"])
    m.fit(x, y, epochs=1, batch_size=4, verbose=0)
    m.save_weights(tmp_path / "w.pt")
    other = _port(jax_run["start"])
    other.load_weights(tmp_path / "w.pt")
    _assert_same_params(m, other)
    assert other._state is None                 # optimizer state reset
    assert m.count_params() == sum(
        v.size for k, v in jax_run["params"].items())
    assert set(m.batch_stats) == {f"c{i}.bn.{s}" for i in (1, 2, 3)
                                  for s in ("mean", "var")}
    m.params = {"head.anchors": np.ones((3, 2), np.float32)}
    assert torch.equal(m.module.head.anchors, torch.ones(3, 2))
    with pytest.raises(KeyError):
        m.params = {"nope": np.zeros(1)}


@pytest.mark.parametrize("kw, exc, match", [
    # ported: one process cannot hold a model axis of 2, as the JAX engine
    # refuses it on one device (tests/test_torch_tensor_parallel.py runs
    # it in four processes)
    (dict(n_model=2), ValueError, "must divide the 1 processes"),
    (dict(xla_options={"x": "1"}), NotImplementedError, "ROADMAP"),
    # ported: what it refuses now is a scope of the wrong type, as the
    # JAX engine does (tests/test_torch_bn_sg.py holds the rest)
    (dict(bn_stats_sg_scope=["backbone", 3]), ValueError,
     "bn_stats_sg_scope")], ids=["n_model", "xla_options", "bn_stats_sg"])
def test_compile_refuses_what_is_not_ported(jax_run, kw, exc, match):
    with pytest.raises(exc, match=match):
        _port(jax_run["start"], **kw)


def test_model_defaults_to_the_card():
    import inspect
    sig = inspect.signature(engine.Model.__init__)
    assert sig.parameters["device"].default == "cuda"
