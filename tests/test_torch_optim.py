"""The port's optimizer chain (``parallel.train.make_optimizer``) against
optax's ``make_optimizer`` of the JAX package, on the same seeded
parameters and gradient sequence: every inner optimizer with a float
learning rate and with a schedule, with and without gradient
accumulation, the EMA of the updates and a frozen leaf. Each case takes
nine steps (three applies at ``accumulate_steps=3``), sets the
learning-rate multiplier after the fourth and carries the optimizer
through a ``state_dict`` round trip after the fifth."""

import io

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu.parallel import make_optimizer as jmake_optimizer
from tf2_yolo_tpu.parallel.train import \
    set_lr_multiplier as jset_lr_multiplier
from tf2_yolo_tpu_torch.parallel import (get_lr_multiplier, make_optimizer,
                                         set_lr_multiplier)

torch.set_num_threads(1)

STEPS = 9
SHAPES = {"a": (5, 7), "b": (3,), "head": (3, 2)}   # head holds "anchors"


def _leaf(name):
    return "anchors" if name == "head" else "w"


class Params(torch.nn.Module):
    """``a.w``, ``b.w`` and ``head.anchors`` from numpy arrays."""

    def __init__(self, arrays):
        super().__init__()
        for name, arr in arrays.items():
            sub = torch.nn.Module()
            sub.register_parameter(
                _leaf(name), torch.nn.Parameter(torch.from_numpy(arr.copy())))
            self.add_module(name, sub)


def _schedule(count):
    """optax.exponential_decay(1e-2, 2, 0.5) written out: lr * 0.5^(c/2),
    the same arithmetic on a Python int (port) or an int32 array (JAX)."""
    return 1e-2 * 0.5 ** (count / 2)


def _port_frozen(name, p):
    return name.endswith("anchors")


def _jax_frozen(path, leaf):
    return any(getattr(k, "key", None) == "anchors" for k in path)


@pytest.mark.parametrize("frozen", [False, True], ids=["all", "frozen"])
@pytest.mark.parametrize("ema", [None, 0.9], ids=["no_ema", "ema"])
@pytest.mark.parametrize("accumulate", [1, 3], ids=["k1", "k3"])
@pytest.mark.parametrize("lr", ["float", "schedule"])
@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd", "rmsprop"])
def test_chain_matches_optax(optimizer, lr, accumulate, ema, frozen):
    rng = np.random.RandomState(7)
    # small parameters: the f32 rounding of p + u is then relative to
    # the distance moved, not to p
    p0 = {k: (1e-4 * rng.randn(*s)).astype(np.float32)
          for k, s in SHAPES.items()}
    # magnitudes 1e-6 .. 10, so that eps and the decays both matter
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.randint(-6, 2, s)
                  ).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    learning_rate = 1e-2 if lr == "float" else _schedule
    kw = dict(accumulate_steps=accumulate, ema_decay=ema)

    jtx = jmake_optimizer(optimizer, learning_rate,
                          _jax_frozen if frozen else None, **kw)
    jp = {k: {_leaf(k): jnp.asarray(v)} for k, v in p0.items()}
    jopt = jtx.init(jp)
    tx = make_optimizer(optimizer, learning_rate,
                        _port_frozen if frozen else None, **kw)
    model = Params(p0)
    opt = tx(model)

    for i, g in enumerate(grads):
        if i == 4:
            jopt = jset_lr_multiplier(jopt, 0.5)
            set_lr_multiplier(opt, 0.5)
        if i == 5:
            # a fresh module and optimizer from the saved state
            buf = io.BytesIO()
            torch.save({"model": model.state_dict(),
                        "opt": opt.state_dict()}, buf)
            buf.seek(0)
            saved = torch.load(buf, weights_only=True)
            model = Params(p0)
            model.load_state_dict(saved["model"])
            opt = tx(model)
            opt.load_state_dict(saved["opt"])
            assert get_lr_multiplier(opt) == 0.5
        before = {k: v.detach().clone() for k, v in model.named_parameters()}
        jbefore = jp
        upd, jopt = jtx.update(
            {k: {_leaf(k): jnp.asarray(v)} for k, v in g.items()}, jopt, jp)
        jp = optax.apply_updates(jp, upd)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(g[name.split(".")[0]].copy())
        opt.step()
        applied = accumulate == 1 or i % accumulate == accumulate - 1
        for name, p in model.named_parameters():
            k = name.split(".")[0]
            got = p.detach().numpy()
            want = np.asarray(jp[k][_leaf(k)])
            if not applied or (frozen and k == "head"):
                # MultiSteps' zero updates between applies, and a frozen
                # leaf: bit-identical on both sides
                assert np.array_equal(got, before[name].numpy()), (i, name)
                assert np.array_equal(want, jbefore[k][_leaf(k)]), (i, name)
                continue
            # the distance moved from the start, relative per leaf:
            # measured up to 3.7e-7 over the 64 cases (f32 rounding of
            # the same operations, in places fused or ordered another way)
            moved_want = want.astype(np.float64) - p0[k]
            moved_got = got.astype(np.float64) - p0[k]
            err = (np.linalg.norm(moved_got - moved_want)
                   / np.linalg.norm(moved_want))
            assert err <= 1e-6, (i, name, err)

