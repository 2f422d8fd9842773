"""The port's data-parallel training in two processes (gloo on the CPU,
a FileStore rendezvous) against the JAX package in one process on the
concatenated batches.

The workers (tests/_torch_multiprocess_worker.py) import the port and
never JAX; each takes half of the rows. YOLOv2 at 64^2 goes through
``engine.Model`` as tests/test_multihost.py runs the JAX package in two
processes: evaluate and predict, fit of 2 epochs with a checkpoint after
each, the first step apart, and a resume from the first checkpoint,
against the JAX package's train and eval steps on the same global
batches, at that file's bounds. (The single-step checks of small stacks
at 1e-5 are in tests/test_torch_parallel.py.)
"""

import json
import shutil
import threading

import numpy as np
import pytest
import torch

import jax

from tests.helpers_multiprocess import LIMIT_S, fixture_data, run_workers
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tests.helpers_torch import jit_init
from tf2_yolo_tpu_torch import bridge

torch.set_num_threads(1)

RSS_LIMIT = 1.5 * 2 ** 30     # a worker's peak resident memory


def _jax_abs_sum(variables):
    return float(sum(np.abs(np.float64(np.asarray(leaf))).sum()
                     for leaf in jax.tree_util.tree_leaves(variables)))


@pytest.fixture(scope="module")
def fit_runs(tmp_path_factory):
    """The two workers' results, and the JAX package's oracle computed
    while they run: its train and eval steps (``parallel.make_train_step``
    / ``make_eval_step``, jitted on one device, as ``Model.fit`` and
    ``Model.evaluate`` run them batch by batch) on the same global
    batches, from the JAX engine's initial weights (``Model(seed=0)``'s
    init)."""
    from tf2_yolo_tpu.models import YoloV2
    from tf2_yolo_tpu.ops import wrap_yolo_loss_v2
    from tf2_yolo_tpu.parallel import (create_train_state, make_eval_step,
                                       make_optimizer, make_train_step)

    io_dir = tmp_path_factory.mktemp("fit")
    x, y, anchors, g, classes = fixture_data()
    module = YoloV2(anchors=anchors, class_num=classes)
    # Model(seed=0)'s init, jitted: the same bits
    variables = jit_init(module, np.zeros((1, 64, 64, 3), np.float32))
    torch.save(bridge.from_flax(variables), str(io_dir / "v2.pt"))
    errors = []

    def workers():
        try:
            run_workers("fit", str(io_dir))
        except BaseException as exc:        # pytest.fail's outcome
            errors.append(exc)

    t = threading.Thread(target=workers)
    t.start()
    try:
        loss = [wrap_yolo_loss_v2((g, g), 5, classes, anchors)]
        tx = make_optimizer("adam", 1e-3)
        step = jax.jit(make_train_step(module.apply, tx, loss))
        evaluate = jax.jit(make_eval_step(module.apply, loss))
        forward = jax.jit(lambda v, xb: module.apply(v, xb, train=False))
        # global batch k = [process 0's rows, process 1's rows]: rows
        # [0:4] + [8:12], then [4:8] + [12:16], each epoch
        batches = [np.r_[0:4, 8:12], np.r_[4:8, 12:16]]
        state = create_train_state(variables, tx)
        oracle = dict(
            eval0=float(np.mean([evaluate(state, x[b], (y[b],))["loss"]
                                 for b in batches])),
            pred=[float(np.abs(np.float64(forward(variables, x[lo:lo + 4])))
                        .sum()) for lo in (0, 8)],
            loss=[])
        for _ in range(2):
            logs = []
            for b in batches:
                state, lg = step(state, x[b], (y[b],))
                logs.append(float(lg["loss"]))
            oracle["loss"].append(float(np.mean(logs)))
        oracle["abs_sum"] = _jax_abs_sum((state.params, state.batch_stats))
        state, lg = step(create_train_state(variables, tx), x[batches[0]],
                         (y[batches[0]],))
        oracle["step1_loss"] = float(lg["loss"])
        oracle["step1_abs_sum"] = _jax_abs_sum((state.params,
                                                state.batch_stats))
        del state
        t.join(LIMIT_S + 10)
        assert not t.is_alive(), "the fit workers did not end"
        if errors:
            raise errors[0]
        results = {}
        for pid in range(2):
            with open(io_dir / f"fit_{pid}.json") as f:
                results[pid] = json.load(f)
    finally:
        t.join(LIMIT_S + 10)
        shutil.rmtree(io_dir, ignore_errors=True)
    return results, oracle


def test_two_process_fit_matches_jax(fit_runs):
    results, oracle = fit_runs
    r0, r1 = results[0], results[1]
    # both processes trained on the same global batches: the same loss
    # history and the same parameters and running statistics, bit for bit
    assert r0["loss"] == r1["loss"]
    assert r0["digest"]["hashes"] == r1["digest"]["hashes"]
    assert r0["digest"]["buffers"] == r1["digest"]["buffers"]
    # tight on the initial weights, which both packages share: the global
    # eval loss and each process's predictions (tests/test_multihost.py's
    # bounds)
    for r in (r0, r1):
        assert r["eval0"] == pytest.approx(oracle["eval0"], rel=1e-5)
    assert r0["pred_abs_sum"] == pytest.approx(oracle["pred"][0], rel=1e-5)
    assert r1["pred_abs_sum"] == pytest.approx(oracle["pred"][1], rel=1e-5)
    # the trajectory, loose: the untrained net's BatchNorm amplifies the
    # reduction order's 1e-6 into percents within an epoch (the bounds of
    # tests/test_multihost.py)
    np.testing.assert_allclose(r0["loss"], oracle["loss"], rtol=0.2)
    assert r0["digest"]["abs_sum"] == pytest.approx(oracle["abs_sum"],
                                                    rel=0.01)


def test_two_process_single_step_tight(fit_runs):
    """One step of the global batch of 8 from the shared initial
    weights: tests/test_multihost.py's tight bounds."""
    results, oracle = fit_runs
    r0, r1 = results[0], results[1]
    assert r0["step1_loss"] == r1["step1_loss"]
    assert r0["step1"]["hashes"] == r1["step1"]["hashes"]
    assert r0["step1_loss"] == pytest.approx(oracle["step1_loss"], rel=1e-4)
    assert r0["step1"]["abs_sum"] == pytest.approx(oracle["step1_abs_sum"],
                                                   rel=1e-5)


def test_two_process_checkpoint_resume_bit_exact(fit_runs):
    """Process 0 writes, both wait, both resume: the resumed run skips
    epoch 1 and ends bit for bit where the uninterrupted run did, in
    every process; each worker stays within the memory budget."""
    results, _ = fit_runs
    for r in results.values():
        assert len(r["resume_loss"]) == 1
        assert r["resume_loss"][0] == r["loss"][-1]
        assert r["resume"]["hashes"] == r["digest"]["hashes"]
        assert r["max_rss_bytes"] <= RSS_LIMIT, (r["pid"], r["rss"])
