"""The port's pipeline executor (``parallel.pipeline``) against the JAX
package's pipeline tests (tests/test_pipeline.py), case by case:
the pipelined forward and ``value_and_grad`` of small two-stage nets
against ``jax.value_and_grad`` of the same composed computation at every
microbatch split, ``apply_grads``, train-mode BatchNorm with the full
batch and split into microbatches, and YOLOv4 cut in 2 and 3 stages
(the cut's partition, train-mode BatchNorm with microbatches against
the port's single-program steps bit for bit, save / load / merge); the
YOLOv4 cases against the JAX package are in
tests/test_torch_pipeline_v4.py. PP x DP (``meshes=``,
``test_pipeline_meshes_dp_within_stage``) runs the two small stages in
four gloo processes on the CPU, stage meshes {0, 1} and {2, 3}
(tests/_torch_multiprocess_worker.py, mode "pipe"), against the JAX
composed program computed here while they run.

Not mirrored: the JAX device sets of ``test_pipeline_stage_placement``
(here: every stage's tensors on its torch device). The two-stage nets'
weights come from the JAX ``init``s through ``bridge``.
"""

import shutil
import threading

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from tests._torch_multiprocess_worker import Stage as _Stage
from tests.helpers_convert import remove_files_after_test  # noqa: F401
from tests.helpers_multiprocess import LIMIT_S, run_workers
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.helpers_torch import flat, numpy_tree
from tf2_yolo_tpu_torch import bridge
from tf2_yolo_tpu_torch.models import YoloV4
from tf2_yolo_tpu_torch.parallel import (PipelineExecutor, make_optimizer,
                                         split_detector, split_yolov4)
from tf2_yolo_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)
CPU2 = ["cpu", "cpu"]
EPS_PROBE = 1e-6


# ------------------------------------------------------ two small stages

def _jax_stages(bn):
    from flax import linen as fnn

    class Stage0(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            x = fnn.Conv(8, (3, 3))(x)
            if bn:
                x = fnn.BatchNorm(use_running_average=not train,
                                  momentum=0.9)(x)
            return fnn.relu(x)

    class Stage1(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            x = fnn.Conv(4, (3, 3), strides=(2, 2))(x)
            if bn:
                x = fnn.BatchNorm(use_running_average=not train,
                                  momentum=0.9)(x)
            return x.mean(axis=(1, 2))

    return Stage0(), Stage1()


def _two_stage(bn=False, batch=8, seed=0):
    """(JAX modules, JAX variables, port stages, port modules, x)."""
    rng = np.random.RandomState(7 if bn else seed)
    x = rng.rand(batch, 16, 16, 3).astype(np.float32)
    m0, m1 = _jax_stages(bn)
    p0 = numpy_tree(m0.init(jax.random.PRNGKey(0), x))
    p1 = numpy_tree(m1.init(jax.random.PRNGKey(1), m0.apply(p0, x)))
    mods = [_Stage(3, 8, 1, bn, False), _Stage(8, 4, 2, bn, True)]
    for m, p in zip(mods, (p0, p1)):
        m.load_state_dict(bridge.from_flax(p), strict=True)

    def stage(train):
        def fn(module, a):
            module.train(train)
            return module(a)
        return fn

    return (m0, m1), [p0, p1], [stage(False)] * 2, mods, x, [stage(True)] * 2


def _mse(out, yb):
    return ((out - yb) ** 2).mean()


def _assert_grads(got, want, rtol=2e-5, atol=1e-6):
    """``got`` per stage {name: tensor}, ``want`` per stage a flax
    ``params`` tree."""
    for g, w in zip(got, want):
        w = {k.replace("/", "."): v for k, v in flat(w, "").items()}
        assert g.keys() == w.keys()
        for k, v in w.items():
            np.testing.assert_allclose(g[k].numpy(), v, rtol=rtol,
                                       atol=atol, err_msg=k)


def test_pipeline_forward_matches_composed():
    (m0, m1), params, stages, mods, x, _ = _two_stage()
    pipe = PipelineExecutor(stages, mods, devices=CPU2)
    want = np.asarray(m1.apply(params[1], m0.apply(params[0], x)))
    for mb in (None, 4, 2):
        got = pipe.run(torch.from_numpy(x), microbatch=mb)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_pipeline_stage_placement():
    _, _, stages, mods, x, _ = _two_stage()
    pipe = PipelineExecutor(stages, mods, devices=CPU2)
    assert pipe.devices == [torch.device("cpu")] * 2
    for m, d in zip(pipe.params, pipe.devices):
        assert all(t.device == d for t in m.state_dict().values())
    assert pipe.run(torch.from_numpy(x), microbatch=4).device == \
        pipe.devices[-1]


def test_pipeline_refuses_what_it_cannot_run():
    _, _, stages, mods, x, _ = _two_stage()

    def grid(ranks, n_model=1):
        return Mesh(shape={"data": len(ranks) // n_model, "model": n_model},
                    ranks=tuple(ranks))
    for meshes, match in (
            ([grid([0])], "2 stages need 2 meshes"),
            ([grid([0, 1], 2), grid([2, 3], 2)], "model axis must be 1"),
            ([grid([0, 1]), grid([2])], "the same data size"),
            ([grid([0]), grid([0])], "disjoint"),
            ([grid([1]), grid([2])], "process 0 is in no stage mesh")):
        with pytest.raises(ValueError, match=match):
            PipelineExecutor(stages, mods, meshes=meshes)
    with pytest.raises(ValueError, match="need 2 devices"):
        PipelineExecutor(stages, mods, devices=["cpu"])
    with pytest.raises(ValueError, match="2 stages but 1 params"):
        PipelineExecutor(stages, mods[:1], devices=CPU2)
    pipe = PipelineExecutor(stages, mods, devices=CPU2)
    with pytest.raises(ValueError, match="not divisible by microbatch 3"):
        pipe.run(torch.from_numpy(x), microbatch=3)
    with pytest.raises(ValueError, match="requires train_stages"):
        pipe.value_and_grad(_mse, train=True)


def test_pipeline_value_and_grad_exact():
    """Pipelined training step == jax.value_and_grad of the composed
    computation at every microbatch split (mean over microbatches)."""
    (m0, m1), params, stages, mods, x, _ = _two_stage()
    y = np.random.RandomState(2).rand(8, 4).astype(np.float32)

    def composed(p0p1):
        p0, p1 = p0p1
        return jnp.mean((m1.apply(p1, m0.apply(p0, x)) - y) ** 2)

    want_l, want_g = jax.value_and_grad(composed)(tuple(params))
    pipe = PipelineExecutor(stages, mods, devices=CPU2)
    step = pipe.value_and_grad(_mse)
    for mb in (None, 4, 2, 1):
        loss, grads = step(torch.from_numpy(x), torch.from_numpy(y),
                           microbatch=mb)
        assert float(loss) == pytest.approx(float(want_l), rel=1e-5)
        _assert_grads(grads, [g["params"] for g in want_g])


def test_pipeline_apply_grads_trains():
    """Three optimizer steps through the pipeline reduce the loss; each
    stage's chain updates its own parameters."""
    _, _, stages, mods, x, _ = _two_stage()
    y = torch.zeros(8, 4)
    tx = make_optimizer("sgd", 0.1)
    pipe = PipelineExecutor(stages, mods, devices=CPU2)
    opt_states = pipe.init_opt(tx)
    step = pipe.value_and_grad(_mse)
    losses = []
    for _ in range(3):
        loss, grads = step(torch.from_numpy(x), y, microbatch=4)
        opt_states = pipe.apply_grads(tx, opt_states, grads)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def _jax_train_step(modules, params, x, y):
    """Single-device train-mode step: loss, per-stage param grads, and
    the EMA-updated batch_stats (tests/test_pipeline.py's oracle)."""
    m0, m1 = modules

    def fwd(p0p1):
        p0t, p1t = p0p1
        h, mut0 = m0.apply({**params[0], "params": p0t}, x, train=True,
                           mutable=["batch_stats"])
        out, mut1 = m1.apply({**params[1], "params": p1t}, h, train=True,
                             mutable=["batch_stats"])
        return jnp.mean((out - y) ** 2), (mut0["batch_stats"],
                                          mut1["batch_stats"])

    (loss, stats), grads = jax.value_and_grad(fwd, has_aux=True)(
        (params[0]["params"], params[1]["params"]))
    return float(loss), grads, stats


def _assert_stats(pipe, want_stats):
    for m, st in zip(pipe.params, want_stats):
        want = {k.replace("/", "."): v for k, v in flat(st, "").items()}
        got = {k: v for k, v in m.state_dict().items()
               if k.endswith(("mean", "var"))}
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_pipeline_train_mode_bn_full_microbatch_matches_single_device():
    modules, params, stages, mods, x, train_stages = _two_stage(bn=True)
    y = np.random.RandomState(8).rand(8, 4).astype(np.float32)
    want_l, want_g, want_stats = _jax_train_step(modules, params, x, y)
    before = [{k: v.clone() for k, v in m.named_buffers()} for m in mods]
    pipe = PipelineExecutor(stages, mods, devices=CPU2,
                            train_stages=train_stages)
    loss, grads = pipe.value_and_grad(_mse)(torch.from_numpy(x),
                                            torch.from_numpy(y))
    assert float(loss) == pytest.approx(want_l, rel=1e-5)
    _assert_grads(grads, want_g)
    _assert_stats(pipe, want_stats)
    for m, b in zip(pipe.params, before):
        assert all(not torch.equal(v, b[k]) for k, v in m.named_buffers())


def test_pipeline_train_mode_bn_microbatched_matches_sequential():
    """microbatch < batch: the train steps of the microbatches in turn
    (their own batch statistics, the running statistics chained) with
    the gradients accumulated."""
    modules, params, stages, mods, x, train_stages = _two_stage(bn=True)
    y = np.random.RandomState(9).rand(8, 4).astype(np.float32)
    mb, n = 4, 2
    cur = [dict(p) for p in params]
    acc, total = None, 0.0
    for i in range(n):
        sl = slice(i * mb, (i + 1) * mb)
        loss, g, stats = _jax_train_step(modules, cur, x[sl], y[sl])
        total += loss / n
        g = jax.tree_util.tree_map(lambda a: a / n, g)
        acc = g if acc is None else jax.tree_util.tree_map(jnp.add, acc, g)
        cur = [{**c, "batch_stats": s} for c, s in zip(cur, stats)]
    pipe = PipelineExecutor(stages, mods, devices=CPU2,
                            train_stages=train_stages)
    loss, grads = pipe.value_and_grad(_mse, train=True)(
        torch.from_numpy(x), torch.from_numpy(y), microbatch=mb)
    assert float(loss) == pytest.approx(total, rel=1e-5)
    _assert_grads(grads, acc)
    _assert_stats(pipe, [c["batch_stats"] for c in cur])


# ------------------------------------------ PP x DP: four processes

@pytest.fixture(scope="module")
def pp_dp(tmp_path_factory):
    """The four workers' results (mode "pipe") and the JAX oracles of
    tests/test_pipeline.py's ``test_pipeline_meshes_dp_within_stage``
    (the composed program's forward and ``value_and_grad``) and of the
    train-mode step of the BatchNorm stages on the whole batch."""
    io_dir = tmp_path_factory.mktemp("pipe")
    (m0, m1), params, _, _, x, _ = _two_stage()
    y = np.random.RandomState(2).rand(8, 4).astype(np.float32)
    bmods, bparams, _, _, xb, _ = _two_stage(bn=True)
    yb = np.random.RandomState(8).rand(8, 4).astype(np.float32)
    torch.save(dict(plain_weights=[bridge.from_flax(p) for p in params],
                    bn_weights=[bridge.from_flax(p) for p in bparams],
                    x=torch.from_numpy(x), y=torch.from_numpy(y),
                    bn_x=torch.from_numpy(xb), bn_y=torch.from_numpy(yb)),
               str(io_dir / "pipe.pt"))
    errors = []

    def workers():
        try:
            run_workers("pipe", str(io_dir), nprocs=4)
        except BaseException as exc:        # pytest.fail's outcome
            errors.append(exc)

    t = threading.Thread(target=workers)
    t.start()
    try:
        def composed(p0p1):
            p0, p1 = p0p1
            return jnp.mean((m1.apply(p1, m0.apply(p0, x)) - y) ** 2)

        loss, grads = jax.value_and_grad(composed)(tuple(params))
        oracle = dict(out=np.asarray(m1.apply(params[1],
                                              m0.apply(params[0], x))),
                      loss=float(loss), grads=[g["params"] for g in grads],
                      bn=_jax_train_step(bmods, bparams, xb, yb))
        t.join(LIMIT_S + 10)
        assert not t.is_alive(), "the pipe workers did not end"
        if errors:
            raise errors[0]
        results = [torch.load(str(io_dir / f"pipe_{pid}.pt"),
                              weights_only=False) for pid in range(4)]
    finally:
        t.join(LIMIT_S + 10)
        shutil.rmtree(io_dir, ignore_errors=True)
    return results, oracle


def test_pipeline_meshes_dp_within_stage(pp_dp):
    """PP x DP: each stage over its own two processes, the microbatch's
    rows split over them; the forward on every process equals the
    composed program (rtol / atol 1e-6), the loss (rtol 1e-5) and each
    stage's gradients (rtol 2e-5, atol 1e-6) its value_and_grad, and
    three SGD steps lower the loss (tests/test_pipeline.py's bounds)."""
    results, oracle = pp_dp
    assert [r["stage"] for r in results] == [0, 0, 1, 1]
    for r in results:
        np.testing.assert_allclose(r["run"].numpy(), oracle["out"],
                                   rtol=1e-6, atol=1e-6)
        assert r["loss"] == pytest.approx(oracle["loss"], rel=1e-5)
        assert r["grads"][1 - r["stage"]] is None
        _assert_grads([r["grads"][r["stage"]]],
                      [oracle["grads"][r["stage"]]])
        assert r["sgd_losses"][-1] < r["sgd_losses"][0], r["sgd_losses"]
        assert r["sgd_losses"] == results[0]["sgd_losses"]
    # the trained stages, merged in every process from their owners
    for r in results[1:]:
        for k, v in r["merged"].items():
            assert torch.equal(v, results[0]["merged"][k]), k


def test_pipeline_meshes_train_mode_bn(pp_dp):
    """Train-mode BatchNorm under PP x DP: each stage's statistics over
    its two processes, so a step of the whole batch is the single-device
    train step: loss, gradients and the running statistics."""
    results, oracle = pp_dp
    want_l, want_g, want_stats = oracle["bn"]
    for r in results:
        s = r["stage"]
        assert r["bn_loss"] == pytest.approx(want_l, rel=1e-5)
        _assert_grads([r["bn_grads"][s]], [want_g[s]])
        want = {k.replace("/", "."): v
                for k, v in flat(want_stats[s], "").items()}
        assert r["bn_stats"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(r["bn_stats"][k].numpy(), v,
                                       rtol=1e-5, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------- YOLOv4

ANCHORS = np.stack([np.linspace(0.1, 0.8, 9), np.linspace(0.1, 0.7, 9)],
                   axis=1)
SIZE = 32


def _log1p_loss(out, *_):
    """The JAX test's loss: log1p keeps the exp(wh) channels' gradient
    bounded."""
    return sum(torch.log1p(o ** 2).mean() for o in out)


def _jlog1p_loss(out):
    return sum(jnp.mean(jnp.log1p(o ** 2)) for o in out)


def _port_v4(packed=False):
    """A YOLOv4 at the port's own seeded init (2 classes)."""
    return YoloV4(ANCHORS, 2, device="cpu", packed=packed,
                  generator=torch.Generator().manual_seed(0))


def _images(size=SIZE):
    return torch.from_numpy(
        np.random.RandomState(4).rand(4, size, size, 3).astype(np.float32))


def test_split_yolov4_train_microbatched_matches_sequential():
    """3 stages, train mode, microbatch 2 of 4: the port's train steps
    of the two halves in turn, gradients accumulated, bit for bit."""
    x = _images()
    seq = _port_v4(packed=3).train()
    for half in (x[:2], x[2:]):
        (_log1p_loss(seq(half)) / 2).backward()
    model = _port_v4(packed=3)
    stages, params, train_stages = split_yolov4(model, 3, with_train=True)
    pipe = PipelineExecutor(stages, params, devices=["cpu"] * 3,
                            train_stages=train_stages)
    _, grads = pipe.value_and_grad(_log1p_loss)(x,
                                                microbatch=2)
    one = dict(seq.named_parameters())
    for g in grads:
        for k, t in g.items():
            np.testing.assert_allclose(t.numpy(), one[k].grad.numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
    for k, t in seq.state_dict().items():
        assert torch.equal(pipe.merged_variables()[k], t), k


def test_pipeline_save_load_merge(tmp_path):
    """save / load round-trips every stage bit for bit, and
    merged_variables loads into a fresh YoloV4 whose eval forward is the
    pipeline's."""
    x = _images()
    model = _port_v4()
    stages, params = split_yolov4(model, n_stages=3)
    pipe = PipelineExecutor(stages, params, devices=["cpu"] * 3)
    merged = pipe.merged_variables()
    assert list(merged) == list(model.state_dict())
    tx = make_optimizer("sgd", 1e-3)
    opt = pipe.init_opt(tx)
    _, grads = pipe.value_and_grad(_log1p_loss)(x,
                                                microbatch=2)
    pipe.apply_grads(tx, opt, grads)
    trained = [{k: t.clone() for k, t in m.state_dict().items()}
               for m in pipe.params]
    path = str(tmp_path / "pp_state.pt")
    pipe.save(path)
    for m in pipe.params:                   # reset
        m.load_state_dict({k: torch.zeros_like(t)
                           for k, t in m.state_dict().items()})
    pipe.load(path)
    for m, want in zip(pipe.params, trained):
        for k, t in m.state_dict().items():
            assert torch.equal(t, want[k]), k
    fresh = YoloV4(ANCHORS, 2, device="cpu")
    fresh.load_state_dict(pipe.merged_variables(), strict=True)
    with torch.no_grad():
        out_m = fresh.eval()(x)
    for a, b in zip(pipe.run(x, microbatch=2), out_m):
        assert torch.equal(a, b)


def test_split_errors():
    """The JAX package's errors."""
    model = YoloV4(ANCHORS, 2, device="cpu", backbone="resnet50")
    with pytest.raises(ValueError, match="n_stages must be 2 or 3"):
        split_yolov4(model, n_stages=4)
    with pytest.raises(ValueError, match="stock csp_darknet backbone"):
        split_yolov4(model, n_stages=3)
    with pytest.raises(ValueError, match="stock csp_darknet"):
        model(torch.zeros(1, SIZE, SIZE, 3),
              pipeline_stage="backbone_early")
    with pytest.raises(ValueError, match="Invalid pipeline_stage"):
        model(torch.zeros(1, SIZE, SIZE, 3), pipeline_stage="head")
    with pytest.raises(ValueError, match="'backbone' param scope"):
        split_detector(nn.Sequential(nn.Linear(2, 2)))
