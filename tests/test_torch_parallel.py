"""The port's parallel layer against the JAX package's: the per-process
feed and the data axis (``process_batch_slice``, ``put_global_batch``,
``best_data_axis``, ``make_mesh``), the process group in one process, and
the data-parallel step in two processes on small stacks.

Tensor parallelism's grid (``make_mesh(n_model=2)``) and a ConvBN
sliced over it run in the same two workers; its plan is held to the JAX
rule here. The two-process checks run tests/_torch_multiprocess_worker.py twice
(gloo on the CPU, a FileStore rendezvous), each process on half of the
rows, and hold one train step of a two-ConvBN stack, of a CSP stage on
the fused-GEMM route (``packed=1``) and of the v2 UNet's ConvActBN to
``jax.value_and_grad`` of the flax modules on all the rows at 1e-5:
outputs, batch and running statistics, gradients. The same step with an
in-place (non-differentiable) reduce of the statistics gets the forward
right and the gradients wrong, and the check sees it.
"""

import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from tests.helpers_multiprocess import run_workers
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.helpers_torch import flat, rel_l2, with_random_bn
from tf2_yolo_tpu_torch import bridge
from tf2_yolo_tpu_torch.engine import Model
from tf2_yolo_tpu_torch.models.layers import ConvActBN, ConvBN
from tf2_yolo_tpu_torch.parallel import input as pinput
from tf2_yolo_tpu_torch.parallel import (best_data_axis,
                                         distributed_initialize,
                                         distributed_shutdown,
                                         is_multiprocess, make_mesh,
                                         make_mesh_spatial, process_count,
                                         process_index, put_global_batch,
                                         spatial_sharding,
                                         tensor_parallel_shardings)

torch.set_num_threads(1)


# ------------------------------------------------- the feed and the mesh

@pytest.mark.parametrize("batch,max_devices", [
    (8, 8), (6, 8), (7, 4), (12, 8), (1, 8), (16, 3)])
def test_best_data_axis_matches_jax(batch, max_devices):
    from tf2_yolo_tpu.parallel import best_data_axis as jbest
    assert best_data_axis(batch, max_devices) == jbest(batch, max_devices)


def test_best_data_axis_defaults_to_the_processes():
    # one process: the JAX package counts devices, the port processes
    assert best_data_axis(8) == 1


@pytest.mark.parametrize("processes", [1, 2, 3, 4])
def test_process_batch_slice_matches_jax(monkeypatch, processes):
    from tf2_yolo_tpu.parallel import input as jinput
    for index in range(processes):
        monkeypatch.setattr(jinput.jax, "process_count", lambda: processes)
        monkeypatch.setattr(jinput.jax, "process_index", lambda: index)
        monkeypatch.setattr(pinput, "process_count", lambda: processes)
        monkeypatch.setattr(pinput, "process_index", lambda: index)
        for n in (12, 24):
            assert pinput.process_batch_slice(n) == \
                jinput.process_batch_slice(n)
    if processes > 1:
        with pytest.raises(ValueError) as want:
            jinput.process_batch_slice(processes * 4 + 1)
        with pytest.raises(ValueError) as got:
            pinput.process_batch_slice(processes * 4 + 1)
        assert str(got.value) == str(want.value)


def test_put_global_batch_matches_jax():
    from tf2_yolo_tpu.parallel import make_mesh as jmake_mesh
    from tf2_yolo_tpu.parallel import put_global_batch as jput
    rng = np.random.RandomState(0)
    x = rng.rand(8, 4, 4, 3).astype(np.float32)
    y = rng.rand(8, 2, 2, 7).astype(np.float32)
    img = (rng.rand(8, 4, 4, 3) * 255).astype(np.uint8)
    got = put_global_batch({"x": x, "ys": (y,), "img": img}, device="cpu")
    want = jput(jmake_mesh(8), {"x": x, "ys": (y,), "img": img})
    assert got["img"].dtype == torch.uint8
    assert isinstance(got["ys"], tuple)
    for a, b in ((got["x"], want["x"]), (got["ys"][0], want["ys"][0]),
                 (got["img"], want["img"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_make_mesh_matches_jax():
    from tf2_yolo_tpu.parallel import make_mesh as jmake_mesh
    want = jmake_mesh(1)
    got = make_mesh()
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.size == want.size and got.ranks == (0,)
    assert make_mesh(1) == got
    with pytest.raises(ValueError, match="every process"):
        make_mesh(2)


def _grid_of_two_processes(stacks):
    """``make_mesh(n_model=2)`` in the two stack workers: one row of the
    model axis (rank r at model index r), made once; a ConvBN sliced over
    it gathers the whole layer's output and input gradient (one channel
    gather forward, one cotangent all-reduce backward)."""
    _, results = stacks
    for pid, r in enumerate(results):
        mesh = r["mesh"]
        assert mesh["shape"] == {"data": 1, "model": 2}
        assert mesh["ranks"] == (0, 1)
        assert (mesh["data_index"], mesh["model_index"]) == (0, pid)
        assert mesh["data_ranks"] == (pid,) and mesh["no_data_group"]
        assert mesh["same"] and mesh["model_group_size"] == 2
        whole, sliced = mesh["whole"], mesh["sliced"]
        assert sliced["kernel"] == (3, 3, 8, 8) and not whole["records"]
        np.testing.assert_allclose(sliced["y"].numpy(), whole["y"].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(sliced["gx"].numpy(),
                                   whole["gx"].numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert sliced["records"] == [
            ("all_gather", 3, whole["y"].numel()),
            ("all_reduce", None, whole["gx"].numel())]


def _plan_matches_jax(stacks):
    """``tensor_parallel_shardings`` of the two-ConvBN stack against the
    JAX package's rule on its variables, at two gates."""
    from tf2_yolo_tpu.parallel import make_mesh as jmake_mesh
    from tf2_yolo_tpu.parallel import tensor_parallel_shardings as jplan
    from tests._torch_multiprocess_worker import Stack
    from tf2_yolo_tpu_torch.parallel.mesh import Mesh
    variables = jax.eval_shape(lambda: _jax_stack().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8)), train=False))
    grid = Mesh(shape={"data": 1, "model": 2}, ranks=(0, 1))
    for gate in (16, 32):
        want = {k: (None if v.spec == jax.sharding.PartitionSpec()
                    else len(v.spec) - 1)
                for k, v in bridge.state_dict_names(
                    jplan(variables, jmake_mesh(4, 2), gate)).items()}
        assert tensor_parallel_shardings(Stack(), grid, gate) == want


def _spatial_grid_of_one_process(stacks):
    """``make_mesh_spatial`` in one process without a process group: a
    ``("data", "space")`` grid of one, its place and its axis sizes;
    a space axis that the processes do not fill is a ValueError."""
    mesh = make_mesh_spatial(1, 1)
    assert mesh.axis_names == ("data", "space")
    assert mesh.shape == {"data": 1, "space": 1} and mesh.ranks == (0,)
    assert (mesh.data_index, mesh.space_index) == (0, 0)
    assert mesh.space_ranks == (0,)
    with pytest.raises(ValueError, match="n_space=2 must divide the 1"):
        make_mesh_spatial(1, 2)


def _spatial_cut_of_one_process(stacks):
    """``spatial_sharding`` of a grid of one: the whole batch, each
    image whole; a ConvBN spatially partitioned over it gives the
    unpartitioned layer's output."""
    from tf2_yolo_tpu_torch.models.layers import set_spatial_parallel
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, 10, 8, 3).astype(np.float32))
    cut = spatial_sharding(make_mesh_spatial(1, 1))(x)
    assert torch.equal(cut, x)
    torch.manual_seed(0)
    whole = ConvBN(x.shape[-1], 16, 3, 2, device="cpu").eval()
    part = ConvBN(x.shape[-1], 16, 3, 2, device="cpu").eval()
    part.load_state_dict(whole.state_dict())
    set_spatial_parallel(part, make_mesh_spatial(1, 1), tuple(x.shape[1:3]))
    with torch.no_grad():
        np.testing.assert_allclose(part(cut).numpy(), whole(x).numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("call", [
    _grid_of_two_processes, _plan_matches_jax,
    _spatial_grid_of_one_process, _spatial_cut_of_one_process],
    ids=[f"<lambda>{i}" for i in range(4)])
def test_tensor_and_spatial_parallelism_raise(call, stacks):
    """Tensor parallelism and spatial partitioning are ported: the grid
    of two processes and the plan against JAX's (the first two cases),
    the spatial grid and cut in one process (the last two)."""
    call(stacks)


# ------------------------------------------ the process group in one process

@pytest.fixture
def group():
    """A gloo group of one process through a HashStore (no socket)."""
    device = distributed_initialize(device="cpu")
    try:
        yield device
    finally:
        distributed_shutdown()


def test_no_group_means_one_process():
    assert not dist.is_initialized()
    assert (process_count(), process_index(), is_multiprocess()) == (1, 0,
                                                                     False)


def test_initialize_one_process(group):
    assert group == torch.device("cpu")
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert (process_count(), process_index(), is_multiprocess()) == (1, 0,
                                                                     False)
    with pytest.raises(RuntimeError, match="already initialized"):
        distributed_initialize(device="cpu")


def test_initialize_refuses_what_cannot_meet():
    with pytest.raises(ValueError, match="store or a coordinator"):
        distributed_initialize(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        distributed_initialize(num_processes=2, process_id=2, device="cpu")
    with pytest.raises(ValueError, match="nccl backend needs a CUDA"):
        distributed_initialize(device="cpu", backend="nccl")
    assert not dist.is_initialized()


class _Net(torch.nn.Module):
    """A ConvBN and a ConvActBN (the kernel's sums and the fallback
    reduction) and a head, 16^2."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.a = ConvBN(3, 8, 3, 2, act="mish", device="cpu")
        self.b = ConvActBN(8, 8, 3, act="relu", device="cpu")
        self.head = ConvBN(8, 4, 1, use_bn=False, act="linear",
                           device="cpu")

    def forward(self, x):
        return self.head(self.b(self.a(x)))


def _fit(x, y, grouped):
    model = Model(_Net(), (16, 16, 3), device="cpu")
    model.compile("adam", learning_rate=1e-2,
                  loss=lambda yt, out: ((out - yt) ** 2).mean())
    assert (model._group is not None) == grouped
    hist = model.fit(x, y, epochs=2, batch_size=4, shuffle=False, verbose=0,
                     validation_data=(x[:4], y[:4]))
    return hist, {k: v.clone() for k, v in model.variables.items()}


def test_one_process_group_changes_nothing(group):
    """With a group of one process the statistics and gradient reduces,
    the shard check, the broadcast and the means over processes are all
    exact: fit is bit for bit the ungrouped fit on the CPU (the
    ConvActBN's means pass through sums and back, within 1 ulp)."""
    rng = np.random.RandomState(1)
    x = rng.rand(8, 16, 16, 3).astype(np.float32)
    y = rng.randn(8, 8, 8, 4).astype(np.float32)
    hist_g, var_g = _fit(x, y, True)
    distributed_shutdown()
    hist, var = _fit(x, y, False)
    assert hist_g["loss"] == pytest.approx(hist["loss"], rel=1e-6)
    assert hist_g["val_loss"] == pytest.approx(hist["val_loss"], rel=1e-6)
    for k, v in var.items():
        np.testing.assert_allclose(var_g[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


# ------------------------------------------------ two processes, the stacks

def _jax_stack():
    from flax import linen as nn
    from tf2_yolo_tpu.models import layers as jlayers

    class Stack(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            x = jlayers.ConvBN(16, 3, 1, act="mish", fused=True,
                               name="a")(x, train)
            return jlayers.ConvBN(16, 3, 2, act="leaky", fused=True,
                                  name="b")(x, train)
    return Stack()


def _zero_running(v):
    """Running statistics 0, so that the step leaves 0.01 x the batch
    statistics in them (train mode reads only the batch's)."""
    v["batch_stats"] = jax.tree_util.tree_map(np.zeros_like,
                                              v["batch_stats"])
    return v


STACKS = [("convbn", ""), ("csp", "stage."), ("convactbn", "block.")]


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """(JAX oracle, worker results) per stack: the JAX step on all rows,
    the two processes' steps on their halves."""
    from tf2_yolo_tpu.models.backbones import CSPStage as JCSPStage
    from tf2_yolo_tpu.models.layers import ConvActBN as JConvActBN

    io_dir = tmp_path_factory.mktemp("stacks")
    rng = np.random.RandomState(11)
    cases = {
        "convbn": (_jax_stack(), rng.randn(4, 8, 8, 8), (4, 4, 4, 16)),
        "csp": (JCSPStage(features=32, blocks=2), rng.randn(4, 12, 12, 16),
                (4, 6, 6, 32)),
        "convactbn": (JConvActBN(16, 3, act="relu"), rng.randn(4, 8, 8, 8),
                      (4, 8, 8, 16)),
    }
    data, oracle = {}, {}
    for name, prefix in STACKS:
        jm, x, ct_shape = cases[name]
        x = x.astype(np.float32)
        ct = rng.randn(*ct_shape).astype(np.float32)
        v = _zero_running(with_random_bn(
            jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False),
            rng))

        def jf(params, _jm=jm, _v=v, _x=x, _ct=ct):
            out, mut = _jm.apply({"params": params,
                                  "batch_stats": _v["batch_stats"]},
                                 jnp.asarray(_x), train=True,
                                 mutable=["batch_stats"])
            return (jnp.sum(out * _ct) / _x.shape[0],
                    (out, mut["batch_stats"]))

        (loss, (out, st)), g = jax.value_and_grad(jf, has_aux=True)(
            v["params"])
        oracle[name] = dict(loss=float(loss), out=np.asarray(out),
                            stats=flat(st, "batch_stats/"),
                            grads=flat(g, "params/"))
        data[f"{name}_weights"] = {prefix + k: t for k, t in
                                   bridge.from_flax(v).items()}
        data[f"{name}_x"] = torch.from_numpy(x)
        data[f"{name}_ct"] = torch.from_numpy(ct)
    try:
        torch.save(data, str(io_dir / "stacks.pt"))
        run_workers("stacks", str(io_dir))
        results = [torch.load(str(io_dir / f"stacks_{pid}.pt"),
                              weights_only=True) for pid in range(2)]
    finally:
        shutil.rmtree(io_dir, ignore_errors=True)
    return oracle, results


def _unprefixed(leaves, prefix):
    """flax paths of a leaf dict, the worker module's prefix taken out."""
    p = prefix.replace(".", "/")
    return {k.replace(p, "", 1) if p else k: v for k, v in leaves.items()}


@pytest.mark.parametrize("name,prefix", STACKS)
def test_two_process_step_matches_jax(stacks, name, prefix):
    oracle, results = stacks
    want = oracle[name]
    r0, r1 = (r[f"{name}/differentiable"] for r in results)
    out = torch.cat([r0["out"], r1["out"]]).numpy()
    # the single-process bounds of these modules (tests/test_torch_train.py
    # measured 9.5e-7 and 2.4e-6); two processes add the all-reduce's
    # order of summation
    np.testing.assert_allclose(out, want["out"], rtol=1e-5, atol=1e-5)
    # logs: the mean over the processes of their batch means
    assert float(r0["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    assert float(r0["loss"]) == float(r1["loss"])
    # batch statistics: 100 x the running statistics that the JAX step
    # left after starting from 0; the same in both processes
    assert len(r0["batch"]) == len([k for k in want["stats"]
                                    if k.endswith("/mean")])
    for mod_name, (mean, var) in r0["batch"].items():
        path = "batch_stats/" + mod_name[len(prefix):].replace(".", "/")
        for got, key in ((mean, "mean"), (var, "var")):
            np.testing.assert_allclose(
                got.numpy(),
                want["stats"][f"{path}/{key}"] / np.float32(0.01),
                rtol=1e-5, atol=1e-6, err_msg=f"{path}/{key}")
        m1, v1 = r1["batch"][mod_name]
        assert torch.equal(m1, mean) and torch.equal(v1, var)
    # running statistics, bit for bit the same in both processes
    leaves = _unprefixed(r0["leaves"], prefix)
    for path, leaf in want["stats"].items():
        np.testing.assert_allclose(leaves[path].numpy(), leaf, rtol=1e-5,
                                   atol=1e-8, err_msg=path)
    for k, v in r0["leaves"].items():
        assert torch.equal(v, r1["leaves"][k]), k
    # gradients of the global batch's mean loss, in both processes
    g0 = _unprefixed(r0["grads"], prefix)
    g1 = _unprefixed(r1["grads"], prefix)
    assert g0.keys() == want["grads"].keys()
    for path, leaf in want["grads"].items():
        assert rel_l2(g0[path].numpy(), leaf) <= 1e-5, path
        assert torch.equal(g0[path], g1[path]), path


@pytest.mark.parametrize("name,prefix", STACKS)
def test_inplace_reduce_is_caught(stacks, name, prefix):
    """An in-place all-reduce of the sums gives the same forward, and
    gradients that miss the other process's cotangents."""
    oracle, results = stacks
    want = oracle[name]
    r0 = results[0][f"{name}/inplace"]
    r1 = results[1][f"{name}/inplace"]
    out = torch.cat([r0["out"], r1["out"]]).numpy()
    np.testing.assert_allclose(out, want["out"], rtol=1e-5, atol=1e-5)
    g0 = _unprefixed(r0["grads"], prefix)
    errs = {p: rel_l2(g0[p].numpy(), leaf)
            for p, leaf in want["grads"].items()}
    assert max(errs.values()) > 1e-2, errs
