"""The port's tensor parallelism against the JAX package's
(tests/test_sharding.py, tests/test_aux.py's TP checkpoint): the shard
plan leaf by leaf, and four gloo processes on the CPU in one
``(data 2, model 2)`` grid running tests/test_sharding.py's TinyDetector
through ``Model.compile(n_model=2, tp_min_channels=16)``
(tests/_torch_multiprocess_worker.py, mode "tp"): the first step against
JAX's single-device step at that file's bounds, ``fit`` against the
same fit at ``n_model=1``, the structure of the step's collectives, the
checkpoint round trip, and the whole leaves equal in each model group.
The JAX reference is computed once, in this process, while the workers
run.
"""

import shutil
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.helpers_multiprocess import LIMIT_S, run_workers
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch import bridge
from tf2_yolo_tpu_torch.engine import Model
from tf2_yolo_tpu_torch.models import YoloV2, YoloV4
from tf2_yolo_tpu_torch.models.layers import set_tensor_parallel
from tf2_yolo_tpu_torch.parallel import tensor_parallel_shardings
from tf2_yolo_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

GRID = Mesh(shape={"data": 1, "model": 2}, ranks=(0, 1))   # no groups
V4_ANCHORS = np.stack([np.linspace(0.1, 0.8, 9),
                       np.linspace(0.1, 0.7, 9)], axis=1)


def _spec_dim(sharding):
    spec = tuple(sharding.spec)
    return spec.index("model") if "model" in spec else None


def _jax_plan(variables, min_channels):
    from tf2_yolo_tpu.parallel import make_mesh, tensor_parallel_shardings
    rules = tensor_parallel_shardings(variables, make_mesh(4, 2),
                                      min_channels=min_channels)
    return {k: _spec_dim(v) for k, v in
            bridge.state_dict_names(rules).items()}


@pytest.fixture(scope="module")
def plan_models():
    """name -> (the JAX variables' shapes, the port's model), each made
    once for the plan's cases."""
    from tests._torch_multiprocess_worker import TinyDetector
    from tests.test_sharding import TinyDetector as JTiny
    from tf2_yolo_tpu.models import YoloV4 as JYoloV4
    out = {}
    for name, jmod, x, port in (
            ("tiny", JTiny(), jnp.zeros((1, 64, 64, 3)), TinyDetector()),
            ("v4", JYoloV4(anchors=V4_ANCHORS, class_num=3),
             jnp.zeros((1, 32, 32, 3)), YoloV4(V4_ANCHORS, 3,
                                                device="cpu"))):
        out[name] = (jax.eval_shape(lambda: jmod.init(
            jax.random.PRNGKey(0), x, train=False)), port)
    return out


@pytest.mark.parametrize("model,min_channels", [
    ("tiny", 16), ("tiny", 32), ("v4", 128), ("v4", 16)])
def test_shard_plan_matches_jax(plan_models, model, min_channels):
    """tensor_parallel_shardings of the port's state_dict, leaf by leaf,
    against the JAX package's NamedSharding specs, names through the
    bridge."""
    variables, port = plan_models[model]
    want = _jax_plan(variables, min_channels)
    got = tensor_parallel_shardings(port, GRID, min_channels=min_channels)
    assert got == want
    assert any(d is not None for d in got.values())


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The four workers' results and the JAX package's single-device
    step (tests/test_sharding.py's ``_setup``) on the same weights and
    batch, computed while they run."""
    from tests.test_sharding import _setup

    io_dir = tmp_path_factory.mktemp("tp")
    state, step, x, y = _setup()
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    torch.save({"weights": bridge.from_flax(variables),
                "x": torch.from_numpy(x), "y": torch.from_numpy(y)},
               str(io_dir / "tp.pt"))
    errors = []

    def workers():
        try:
            run_workers("tp", str(io_dir), nprocs=4)
        except BaseException as exc:        # pytest.fail's outcome
            errors.append(exc)

    t = threading.Thread(target=workers)
    t.start()
    try:
        s1, logs = jax.jit(step)(state, jnp.asarray(x), (jnp.asarray(y),))
        oracle = dict(loss=float(logs["loss"]),
                      params=bridge.from_flax({"params": s1.params}),
                      stats=bridge.from_flax({"batch_stats":
                                              s1.batch_stats}),
                      n_params=sum(np.prod(v.shape) for v in
                                   jax.tree_util.tree_leaves(state.params)),
                      n_stats=sum(np.prod(v.shape) for v in
                                  jax.tree_util.tree_leaves(
                                      state.batch_stats)))
        t.join(LIMIT_S + 10)
        assert not t.is_alive(), "the tp workers did not end"
        if errors:
            raise errors[0]
        results = [torch.load(str(io_dir / f"tp_{pid}.pt"),
                              weights_only=False) for pid in range(4)]
    finally:
        t.join(LIMIT_S + 10)
        shutil.rmtree(io_dir, ignore_errors=True)
    return results, oracle


def test_tp_grid_and_feed(tp_run):
    """Rank r at data index r // 2, model index r % 2; the processes of a
    model group read the same rows."""
    results, _ = tp_run
    for pid, r in enumerate(results):
        assert r["mesh"]["data_index"] == pid // 2
        assert r["mesh"]["model_index"] == pid % 2
        lo = 4 * (pid // 2)
        assert r["mesh"]["rows"] == (lo, lo + 4)


def test_tp_step_matches_jax(tp_run):
    """The (data 2, model 2) step equals JAX's single-device step:
    tests/test_sharding.py's bounds (loss rtol 1e-5; parameters rtol
    2e-4, atol 1e-6; BN statistics rtol 1e-4, atol 1e-7), the gathered
    variables the same in every process."""
    results, oracle = tp_run
    r0 = results[0]
    assert r0["step1_loss"] == pytest.approx(oracle["loss"], rel=1e-5)
    for k, want in oracle["params"].items():
        np.testing.assert_allclose(r0["step1"][k].numpy(), want.numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=k)
    for k, want in oracle["stats"].items():
        np.testing.assert_allclose(r0["step1"][k].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    for r in results[1:]:
        assert r["step1_loss"] == r0["step1_loss"]
        for k, v in r0["step1"].items():
            assert torch.equal(r["step1"][k], v), k


def test_tp_fit_matches_data_parallel(tp_run):
    """Model.fit at n_model=2 against n_model=1 on the same global
    batches: histories within rtol 1e-5 (tests/test_sharding.py)."""
    results, _ = tp_run
    for r in results:
        assert len(r["loss"]) == 2
        np.testing.assert_allclose(r["loss"], r["dp_loss"], rtol=1e-5)


def test_tp_collectives_are_channel_gathers(tp_run):
    """The structure of the TP step's communication
    (tests/test_sharding.py's): channel-axis (NHWC dim 3) gathers on the
    model group only, each within a layer's activation; all-reduces on
    the model group activation-sized (the gathers' backward), on the
    data group gradient- or statistics-sized; nothing else."""
    results, oracle = tp_run
    rows = 4                                  # a data shard's batch
    act_budget = 2 * (rows * 33 * 33 * 16)    # ConvBN_1's padded input
    budget = 3 * (oracle["n_params"] + oracle["n_stats"])
    for r in results:
        records = r["collectives"]
        assert {c["kind"] for c in records} <= {"all_gather", "all_reduce"}
        assert {c["axis"] for c in records} <= {"model", "data"}
        gathers = [c for c in records if c["kind"] == "all_gather"]
        assert len(gathers) == 2                # the two sliced ConvBNs
        for c in gathers:
            assert c["axis"] == "model" and c["dim"] == 3, c
            assert c["numel"] <= act_budget, c
        model_reduces = [c for c in records if c["kind"] == "all_reduce"
                         and c["axis"] == "model"]
        assert model_reduces, "expected the gathers' backward all-reduces"
        for c in model_reduces:
            assert c["numel"] <= act_budget, c
        data_reduces = [c for c in records if c["kind"] == "all_reduce"
                        and c["axis"] == "data"]
        assert data_reduces, "expected data-axis gradient all-reduces"
        for c in data_reduces:
            assert c["numel"] <= budget, c


def test_tp_slices_and_whole_leaves(tp_run):
    """Each process holds half of every sliced leaf (the memory falls),
    counts the whole model's parameters, and holds the whole leaves and
    their optimizer moments bit for bit as the other process of its
    model group does, after fit."""
    results, oracle = tp_run
    r0 = results[0]
    assert r0["count_params"] == oracle["n_params"]
    for k, dim in r0["sharded"].items():
        assert r0["local_shapes"][k][dim] * 2 == \
            r0["final"][k].shape[dim], k
    assert set(r0["replicated"]) == {"AnchorHead_0.conv.kernel",
                                     "AnchorHead_0.conv.bias"}
    for a, b in ((0, 1), (2, 3)):
        ra, rb = results[a], results[b]
        for k, v in ra["replicated"].items():
            assert torch.equal(v, rb["replicated"][k]), (a, b, k)
        for k, moments in ra["replicated_moments"].items():
            for m, v in moments.items():
                assert torch.equal(v, rb["replicated_moments"][k][m]), k


def test_tp_checkpoint_round_trip_exact(tp_run):
    """The checkpoint of the sliced run is the unsharded tree: restored
    into an unsliced model it holds the gathered variables and moments
    exactly (tests/test_aux.py's TP round trip); a sliced model resumed
    from the first epoch's ends bit for bit where the run did."""
    results, _ = tp_run
    r0 = results[0]
    for k, v in r0["final"].items():
        assert torch.equal(r0["restored"][k], v), k
    want = r0["final_moments"]["state"]
    got = r0["restored_moments"]["state"]
    assert set(got) == set(want)
    for i, moments in want.items():
        for m, v in moments.items():
            assert torch.equal(got[i][m], v), (i, m)
    for r in results:
        assert r["resume_loss"] == [r["loss"][-1]]
        for k, v in r["final"].items():
            assert torch.equal(r["resumed"][k], v), k


def _v4(**kw):
    return YoloV4(V4_ANCHORS, 3, device="cpu", **kw)


def _v2(backbone):
    return YoloV2(V4_ANCHORS[:5], 3, device="cpu", backbone=backbone)


@pytest.mark.parametrize("build,exc,match", [
    (lambda: _v4(packed=3), ValueError, "packed=False"),
    (lambda: _v4(backbone="resnet50"), NotImplementedError,
     "queue 1, item 9"),
    (lambda: _v2("mobilenet"), NotImplementedError, "queue 1, item 9"),
    (lambda: _v2("unet"), NotImplementedError, "ConvActBN.*queue 1, item 9"),
], ids=["packed", "resnet", "mobilenet", "unet"])
def test_tp_refuses_what_it_cannot_slice(build, exc, match):
    """The fused routes are single-device (ValueError); the keras conv +
    BatchNorm pairs, the depthwise convs and the UNet's ConvActBN are
    not sliced yet (queue 1, item 9), and nothing is sliced before the
    refusal."""
    model = build()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    plan = tensor_parallel_shardings(model, GRID)
    with pytest.raises(exc, match=match):
        set_tensor_parallel(model, GRID, plan)
    assert getattr(model, "tensor_parallel", None) is None
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_compile_n_model_needs_the_processes():
    """compile(n_model) must divide the process count (JAX: the device
    count)."""
    model = Model(_v4(), (32, 32, 3), device="cpu")
    with pytest.raises(ValueError, match="must divide the 1 processes"):
        model.compile("sgd", loss=lambda *a: 0.0, n_model=2)
