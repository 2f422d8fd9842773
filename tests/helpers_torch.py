"""Shared helpers of the tests that hold the PyTorch port's training path
to the JAX package (``tests/test_torch_train.py``, ``tests/test_torch_p3.py``):
flax trees as numpy, seeded BatchNorm state, leaf-by-leaf comparison and
the training benchmark's synthetic labels; and the fixture with which every
``tests/test_torch_*.py`` file hands its memory back when it is done."""

import ctypes
import gc

import numpy as np
import pytest

import jax


def release_memory():
    """Drop JAX's compiled programs and return freed heap pages to the
    system. A whole-model comparison leaves about 4 GB of freed but
    cached heap in its process (measured: 4.4 GB resident before, 1.1 GB
    after), and the suite's workers run many files one after the other
    beside the multi-process tests, on a machine whose memory they can
    exhaust."""
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):        # no glibc: nothing to trim
        pass


@pytest.fixture(scope="module", autouse=True)
def release_memory_after_module():
    """Imported by a test module to run :func:`release_memory` after its
    last test."""
    yield
    release_memory()


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jit_init(module, x, seed=0):
    """``module.init(PRNGKey(seed), x, train=False)`` as one jitted
    program: the same bits as the eager init for the darknet detectors
    (checked for YOLOv1, v2, v3 and v3 tiny), in a third of the time on
    the CPU (the eager init compiles and runs op by op)."""
    return jax.jit(lambda key, xin: module.init(key, xin, train=False))(
        jax.random.PRNGKey(seed), x)


def with_random_bn(variables, rng):
    """Replace every BN scale/bias/mean/var leaf with a seeded draw."""
    def walk(params, stats):
        for name, node in params.items():
            if name == "bn":
                f = node["scale"].shape[0]
                node["scale"] = (1 + 0.2 * rng.randn(f)).astype(np.float32)
                node["bias"] = (0.1 * rng.randn(f)).astype(np.float32)
                stats[name]["mean"] = (0.05 * rng.randn(f)).astype(np.float32)
                stats[name]["var"] = (0.5 + rng.rand(f)).astype(np.float32)
            elif isinstance(node, dict):
                walk(node, stats.get(name, {}))
    v = numpy_tree(variables)
    walk(v["params"], v.get("batch_stats", {}))
    return v


def flat(tree, prefix):
    """``{prefix + flax path: numpy leaf}`` of a flax tree."""
    return {prefix + "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def assert_leaves(got, want, bound, what):
    """Every leaf of ``got`` ({flax path: tensor}) within ``bound``
    relative L2 of the flax leaf; returns the largest difference."""
    assert got.keys() == want.keys(), (sorted(got)[:3], sorted(want)[:3])
    worst = 0.0
    for path, leaf in want.items():
        err = rel_l2(got[path].detach().numpy(), leaf)
        assert err <= bound, (what, path, err)
        worst = max(worst, err)
    return worst


def labels(rng, batch, size, classes):
    """Four boxes per image and level, as the JAX package's training
    benchmark makes them."""
    ys = []
    for level in range(3):
        g = (size // 32) * 2 ** level
        y = np.zeros((batch, g, g, 5 + classes), np.float32)
        for b in range(batch):
            for _ in range(4):
                gy, gx = rng.randint(0, g, 2)
                y[b, gy, gx, :5] = [*rng.rand(2), 0.2, 0.3, 1.0]
                y[b, gy, gx, 5 + rng.randint(classes)] = 1.0
        ys.append(y)
    return ys


def loss_fns(wrap, size, classes, anchors):
    """The three v4 level losses of ``wrap`` (either package's
    ``wrap_yolo_loss_v4``), coarse to fine."""
    return [wrap(((size // 32) * 2 ** lvl,) * 2, 3, classes,
                 anchors[3 * lvl:3 * lvl + 3]) for lvl in range(3)]
