"""The port's spatial partitioning against the JAX package's
(tests/test_sharding.py's ``test_spatial_*``) and against the port's own
unsharded models.

Four gloo processes on the CPU (tests/_torch_multiprocess_worker.py,
mode "space", one launch for the file): tests/test_sharding.py's
TinyDetector step on a ``(data 1, space 4)`` grid (its pooled level
splits 1 + 1 + 0 + 0) and on a ``(2, 2)`` grid against JAX's jitted
single-device step, at that file's bounds, with the structure of the
row exchanges; then six family networks on the ``(2, 2)`` grid, f32,
batch 2, 96 rows (the 3-row levels split 2 + 1), each exercising its
windowed layers: YOLOv4 (SPP, upsample), YOLOv2 with DarkNet-19
(``space_to_depth``, pools), with MobileNetV2 (the depthwise SAME stride
2) and with the UNet (2x2 stride-1 SAME, upsample), YOLOv4 with
ResNet-50 (the zero-padded stem pool, 1x1 stride 2) and YOLOv1.5 (flax's
SAME 7x7 stride 2). Their eval forward (running statistics: BatchNorm an
affine map) and its backward, the heads, the input's gradient and every
leaf's, are held to the unsharded model's at 1e-5, or at 8 times the
unsharded model's own distance when it runs each image alone where the
library convs' rounding at another shape is larger. Their train-mode
step is chaotic (a 1e-6 change of the input moves the random networks'
gradients by 1-7%, measured on the unsharded models alone), so its
loss, gradients and running statistics are held by the probe rule of
tests/helpers_families.py (8 times the unsharded step's own distance
under that change), capped at ``PROBE_CAP``. The references are
computed in this process while the workers run.
"""

import shutil
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_multiprocess_worker import (_layer_statistics,
                                              family_model, linear_loss,
                                              sampled)
from tests.helpers_families import _calibrate_bn
from tests.helpers_multiprocess import LIMIT_S, run_workers
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.helpers_torch import rel_l2
from tf2_yolo_tpu_torch import bridge
from tf2_yolo_tpu_torch.models import YoloV4
from tf2_yolo_tpu_torch.models.layers import set_spatial_parallel
from tf2_yolo_tpu_torch.parallel import (make_optimizer, make_train_step,
                                         spatial_sharding)
from tf2_yolo_tpu_torch.parallel.mesh import Mesh
from tf2_yolo_tpu_torch.parallel.spatial import split_rows
from tf2_yolo_tpu_torch.parallel.train import TrainState

torch.set_num_threads(1)

BATCH = 4          # the TinyDetector's (tests/test_sharding.py's)
FAMILY_BATCH = 2   # a row of each data index's
# name -> (the image's H x W, the windowed layers it exercises): 96 rows
# (the stride-32 level's 3 rows split 2 + 1), the width cut to the
# least the network takes
FAMILIES = {"v4": ((96, 32), "SPP, upsample"),
            "v2_darknet": ((96, 32), "space_to_depth, pools"),
            "v2_mobilenet": ((96, 32), "depthwise SAME s2"),
            "v2_unet": ((96, 32), "2x2 s1 SAME, upsample"),
            "v4_resnet50": ((96, 32), "zero-padded stem pool, 1x1 s2"),
            "v1": ((96, 64), "flax SAME 7x7 s2")}
EPS_PROBE = 1e-6
# train-mode gradients of a leaf upstream of an activation whose input
# lies within rounding of its kink (relu6 has two) may take the other
# one-sided derivative, which no probe of the input reproduces
# (tests/helpers_families.py's KINK_BOUND; a wrong backward moves leaves
# by 0.5 or more, and the eval-mode backward is held at 1e-5)
KINK_BOUND = 0.05
# the most the probe rule allows: well below what a wrong backward moves
PROBE_CAP = 0.2
# families whose train step moves gradient leaves by more than PROBE_CAP
# under the probe itself (YOLOv4-ResNet-50: 38-67% median at 96 x 32 to
# 192 x 192, measured on the unsharded model): no rel L2 rule tells
# those leaves from a wrong backward, so the eval backward holds them
CHAOTIC_STEPS = {"v4_resnet50"}
GRIDS = {"1x4": (1, 4), "2x2": (2, 2)}


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _eval_pass(model, x, cts=None):
    """The eval forward's heads and, with ``cts``, the gradients of the
    linear loss: the input's and every leaf's (``sampled``)."""
    xt = torch.from_numpy(x).requires_grad_(cts is not None)
    if cts is None:
        with torch.no_grad():
            return [h.detach() for h in _as_list(model.eval()(xt))]
    model.zero_grad(set_to_none=True)
    heads = _as_list(model.eval()(xt))
    sum(linear_loss(ct, h) for ct, h in zip(cts, heads)).backward()
    grads = {k: v.numpy() for k, v in sampled(
        {k: p.grad for k, p in model.named_parameters()}).items()}
    model.zero_grad(set_to_none=True)
    return ([h.detach().numpy().copy() for h in heads], xt.grad.numpy(),
            grads)


def _step(model, bn_stats, x, cts):
    """The unsharded model's step of the workers' linear loss (SGD at
    learning rate 0) from the running statistics ``bn_stats``: (loss,
    gradients, running statistics)."""
    model.load_state_dict(bn_stats, strict=False)
    state = TrainState(model, make_optimizer("sgd", 0.0)(model))
    step = make_train_step([linear_loss] * len(cts))
    _, logs = step(state, torch.from_numpy(x), tuple(cts))
    return (float(logs["loss"]),
            {k: v.numpy() for k, v in sampled(
                {k: p.grad for k, p in model.named_parameters()}).items()},
            {k: v.numpy().copy() for k, v in model.named_buffers()
             if k.endswith(("mean", "var"))},
            {k: float(p.grad.norm()) for k, p in model.named_parameters()})


def _family_data(name, rng):
    """The workers' data: the running statistics of the eval passes
    (``eval_stats``: one mean and variance a layer,
    ``_layer_statistics``, so that no activation vanishes or blows up
    with depth), those of the train step (each BN's set to the batch
    statistics of its input on the test batch), the batch and the loss's
    cotangents."""
    model = family_model(name)
    x = rng.rand(FAMILY_BATCH, *FAMILIES[name][0], 3).astype(np.float32)
    eval_stats = _layer_statistics(family_model(name), torch.from_numpy(x))
    _calibrate_bn(model, torch.from_numpy(x))
    bn_stats = {k: v.clone() for k, v in model.named_buffers()
                if k.endswith(("mean", "var"))}
    cts = [torch.from_numpy(rng.randn(*h.shape).astype(np.float32))
           for h in _eval_pass(model, x)]
    return dict(eval_stats=eval_stats, bn_stats=bn_stats,
                x=torch.from_numpy(x), cts=cts)


def _family_refs(name, data):
    """The unsharded model's references: the eval forward on the
    statistics ``eval_stats`` and its gradients, and the same on each
    image alone (``split``: the library convs round differently at
    another shape); the train step, also on the input moved by
    ``EPS_PROBE``."""
    model = family_model(name)
    model.load_state_dict(data["eval_stats"], strict=False)
    x, cts = data["x"].numpy(), data["cts"]
    alone = [_eval_pass(model, x[i:i + 1], [ct[i:i + 1] / FAMILY_BATCH
                                            for ct in cts])
             for i in range(FAMILY_BATCH)]
    split = ([np.concatenate(h) for h in zip(*(a[0] for a in alone))],
             np.concatenate([a[1] for a in alone]),
             {k: sum(a[2][k] for a in alone) for k in alone[0][2]})
    return dict(cts=cts, eval=_eval_pass(model, x, cts), split=split,
                step=_step(model, data["bn_stats"], x, cts),
                probe=_step(model, data["bn_stats"], x + EPS_PROBE, cts))


@pytest.fixture(scope="module")
def space_run(tmp_path_factory):
    """The four workers' results; JAX's single-device TinyDetector step
    (tests/test_sharding.py's ``_setup(batch=4)``) and the unsharded
    families' references, computed while they run."""
    return _space_run(tmp_path_factory.mktemp("space"))


def _space_run(io_dir):
    from tests.test_sharding import _setup

    state, step, x, y = _setup(batch=BATCH)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    rng = np.random.RandomState(18)
    families = {name: _family_data(name, rng) for name in FAMILIES}
    torch.save({"tiny": {"weights": bridge.from_flax(variables),
                         "x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                "families": families}, str(io_dir / "space.pt"))
    errors = []

    def workers():
        try:
            run_workers("space", str(io_dir), nprocs=4)
        except BaseException as exc:        # pytest.fail's outcome
            errors.append(exc)

    t = threading.Thread(target=workers)
    t.start()
    try:
        s1, logs = jax.jit(step)(state, jnp.asarray(x), (jnp.asarray(y),))
        oracle = dict(loss=float(logs["loss"]),
                      params=bridge.from_flax({"params": s1.params}))
        refs = {name: _family_refs(name, data)
                for name, data in families.items()}
        t.join(LIMIT_S + 10)
        assert not t.is_alive(), "the space workers did not end"
        if errors:
            raise errors[0]
        results = [torch.load(str(io_dir / f"space_{pid}.pt"),
                              weights_only=False) for pid in range(4)]
    finally:
        t.join(LIMIT_S + 10)
        shutil.rmtree(io_dir, ignore_errors=True)
    return results, oracle, refs


def test_split_rule():
    """The balanced split: the first H % n shards hold one row more; a
    shard may hold none."""
    assert split_rows(13, 2) == [(0, 7), (7, 13)]
    assert split_rows(13, 4) == [(0, 4), (4, 7), (7, 10), (10, 13)]
    assert split_rows(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert split_rows(416, 2) == [(0, 208), (208, 416)]


def test_spatial_sharding_cut():
    """``spatial_sharding``: the data index's batch rows, then the space
    index's image rows (process 3 of a (2, 2) grid)."""
    mesh = Mesh(shape={"data": 2, "space": 2}, ranks=(0, 1, 2, 3),
                data_index=1, inner_index=1, axis_names=("data", "space"))
    x = torch.arange(4 * 13 * 5 * 3).reshape(4, 13, 5, 3)
    assert torch.equal(spatial_sharding(mesh)(x), x[2:4, 7:13])
    assert mesh.space_index == 1 and mesh.space_ranks == (2, 3)
    with pytest.raises(ValueError, match="no space axis"):
        Mesh(shape={"data": 2, "model": 2}, ranks=(0, 1, 2, 3)).space_group


def test_set_spatial_parallel_refuses_packed():
    """The fused routes of ``packed`` are single-device: ValueError, and
    nothing is set."""
    mesh = Mesh(shape={"data": 1, "space": 2}, ranks=(0, 1),
                axis_names=("data", "space"))
    model = YoloV4(np.full((9, 2), 0.2), 3, device="cpu", packed=3)
    with pytest.raises(ValueError, match="packed=False"):
        set_spatial_parallel(model, mesh, (64, 64))
    assert getattr(model, "spatial_parallel", None) is None
    assert all(getattr(m, "spatial", None) is None for m in model.modules())


def test_space_grid(space_run):
    """Rank r at data index r // n_space, space index r % n_space; the
    meshes are cached."""
    results, _, _ = space_run
    for pid, r in enumerate(results):
        assert r["max_rss_bytes"] < 3 * 2 ** 30      # measured 1.7 GB
        for key, (nd, ns) in GRIDS.items():
            m = r["mesh"][key]
            assert m["shape"] == {"data": nd, "space": ns}
            assert (m["data_index"], m["space_index"]) == divmod(pid, ns)
            lo = ns * (pid // ns)
            assert m["space_ranks"] == tuple(range(lo, lo + ns))
            assert m["same"]


@pytest.mark.parametrize("grid", list(GRIDS))
def test_tiny_step_matches_jax(space_run, grid):
    """The spatially partitioned TinyDetector step equals JAX's
    single-device step at tests/test_sharding.py's bounds (loss rtol
    2e-5; parameters rtol 2e-4, atol 2e-6), the same on every process;
    each process ran its own rows."""
    results, oracle, _ = space_run
    nd, ns = GRIDS[grid]
    for pid, r in enumerate(results):
        got = r[f"tiny_{grid}"]
        lo, hi = split_rows(64, ns)[pid % ns]
        assert got["rows"] == (BATCH // nd, hi - lo, 64, 3)
        np.testing.assert_allclose(got["loss"], oracle["loss"], rtol=2e-5)
        for k, want in oracle["params"].items():
            np.testing.assert_allclose(got["variables"][k].numpy(),
                                       want.numpy(), rtol=2e-4, atol=2e-6,
                                       err_msg=k)
        for k, v in results[0][f"tiny_{grid}"]["variables"].items():
            assert torch.equal(got["variables"][k], v), (pid, k)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_spatial_halo_exchange_is_thin(space_run, grid):
    """The structure of the step's communication
    (``test_spatial_halo_exchange_is_thin`` of tests/test_sharding.py),
    from the collective log: every row message is at most 6 rows; the
    rows moved by all processes, forward and backward, are less than half
    the forward activations; the only all-gather of an activation is the
    heads' (dim 1, once); the rest are all-reduces (BatchNorm sums, the
    gradients, the logs) on the whole grid."""
    results, _, _ = space_run
    act_floats = BATCH * (64 * 64 * 3 + 32 * 32 * 16 + 16 * 16 * 32)
    moved = 0
    for r in results:
        records = r[f"tiny_{grid}"]["records"]
        rows = [c for c in records if c["kind"].startswith("row_")]
        assert rows, "no row exchange: spatial partitioning not engaged?"
        for c in rows:
            assert c["axis"] == "space" and c["dim"] == 1, c
            assert 1 <= c["rows"] <= 6, c
        moved += sum(c["numel"] for c in rows)
        gathers = [c for c in records if c["kind"] == "all_gather"]
        assert len(gathers) == 1 and gathers[0]["dim"] == 1, gathers
        assert gathers[0]["axis"] == "space"
        others = [c for c in records if not c["kind"].startswith("row_")
                  and c["kind"] != "all_gather"]
        assert {c["kind"] for c in others} == {"all_reduce"}
        assert {c["axis"] for c in others} == {"grid"}
    assert moved < 0.5 * act_floats, (moved, act_floats)


def _zero_grad_leaf(k, norms):
    """Whether ``k`` is a bias whose exact gradient is 0 (a BatchNorm
    after it, or after the linear layer it feeds, takes a constant out):
    the reference's holds rounding, small beside the gradient of its
    layer's kernel or scale (``norms``: each leaf's gradient norm); the
    norm of that gradient."""
    base = k[:-len("bias")]
    other = norms.get(base + "kernel", norms.get(base + "scale"))
    if not k.endswith("bias") or other is None:
        return False, None
    return norms[k] <= 1e-5 * other, other


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_forward_and_step(space_run, name):
    """A family network on the (2, 2) grid, whose 3-row levels split
    2 + 1 (its windowed layers: ``FAMILIES``), against the unsharded
    model.

    The eval forward on one mean and variance a layer
    (``_layer_statistics``; BatchNorm an affine map: no chaos) and its
    backward, tightly: the gathered heads
    and each process's rows of the input's gradient (max abs error over
    the scale), every leaf's gradient summed over the grid (``sampled``;
    rel L2), each within max(1e-5, 8 x the unsharded model's own
    distance when it runs each image alone, :func:`_rounding`): every
    windowed layer's forward, its slab backward and the row exchanges'.

    The train step, whose BatchNorm statistics over a few values make
    the random networks chaotic (a 1e-6 change of the input moves their
    gradients by 1-7%), by the probe rule capped at ``PROBE_CAP``: its
    loss, every gradient (``KINK_BOUND`` at least; a bias whose exact
    gradient is 0, :func:`_zero_grad_leaf`, holds rounding on both
    sides) and every running statistic (1e-4 at least), each within
    8 x the unsharded step's own distance on the input moved by
    ``EPS_PROBE``."""
    results, _, refs = space_run
    ref = refs[name]
    cts = ref["cts"]
    heads, dx, eval_grads = ref["eval"]
    bounds = _rounding(ref["eval"], ref["split"])
    h_img = FAMILIES[name][0][0]
    for pid, r in enumerate(results):
        got = r[name]
        assert 1 <= got["fetched"] <= 6
        sl = slice(pid // 2, pid // 2 + 1)
        for h, want in zip(got.get("heads", ()), heads):
            _close(h.numpy(), want[sl], np.abs(want).max(), bounds[0],
                   "heads")
        # each process's rows of the input's gradient (its loss is the
        # mean over its data index's row, the reference's over both)
        lo, hi = split_rows(h_img, 2)[pid % 2]
        _close(got["dx"].numpy() / 2, dx[sl, lo:hi], np.abs(dx).max(),
               bounds[1], "dx")
    for k, want in eval_grads.items():
        total = sum(r[name]["eval_grads"][k] for r in results).numpy() / 2
        assert rel_l2(total, want) <= bounds[2], (k, rel_l2(total, want))
    got = results[0][name]
    loss, grads, stats, norms = ref["step"]
    p_loss, p_grads, p_stats, _ = ref["probe"]
    # the loss is a sum of terms of both signs: its scale is theirs
    scale = sum(np.abs(h * ct.numpy()).sum() for h, ct in zip(heads, cts))
    assert abs(got["loss"] - loss) <= min(
        PROBE_CAP * abs(loss),
        max(8 * abs(p_loss - loss), 1e-5 * scale / FAMILY_BATCH))
    for r in results[1:]:
        assert r[name]["loss"] == got["loss"]
    _check_grads(got["grads"], got["norms"], grads, norms, p_grads,
                 chaotic=name in CHAOTIC_STEPS)
    assert got["stats"].keys() == stats.keys()
    for k, want in stats.items():
        err = rel_l2(got["stats"][k].numpy(), want)
        assert err <= min(PROBE_CAP, max(8 * rel_l2(p_stats[k], want),
                                         1e-4)), (k, err)


def _rounding(whole, split):
    """The eval checks' bounds (heads, dx, leaf gradients): max(1e-5, 8 x
    the distance of ``split`` (each image alone) from ``whole``), the
    worst over the heads (max abs error over the scale) and over the
    leaves (rel L2)."""
    def rel_max(got, want):
        return np.abs(got - want).max() / np.abs(want).max()

    heads = max(rel_max(g, w) for g, w in zip(split[0], whole[0]))
    leaves = max(rel_l2(split[2][k], w) for k, w in whole[2].items())
    return tuple(max(1e-5, 8 * d)
                 for d in (heads, rel_max(split[1], whole[1]), leaves))


def _close(got, want, scale, bound, what):
    err = np.abs(got - want).max() / scale
    assert err <= bound, (what, err, bound)


def _check_grads(got, got_norms, want, norms, probe, chaotic=False):
    """Each gradient leaf (``sampled``) within min(``PROBE_CAP``, max(8 x
    the probe's rel L2, ``KINK_BOUND``)) of ``want``, or, a bias whose
    exact gradient is 0, small on both sides. With ``chaotic`` (a family
    of ``CHAOTIC_STEPS``), the leaves that the probe alone moves by more
    than ``PROBE_CAP`` are not held here."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        zero, scale = _zero_grad_leaf(k, norms)
        if zero:
            assert got_norms[k] <= 1e-5 * scale, k
            continue
        err, noise = rel_l2(got[k].numpy(), w), rel_l2(probe[k], w)
        if chaotic and noise > PROBE_CAP:
            continue
        assert err <= min(PROBE_CAP, max(8 * noise, KINK_BOUND)), \
            (k, err, noise)
