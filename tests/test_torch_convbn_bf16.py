"""One bf16 ``ConvBN`` of the port against the JAX package's default route
(``fused=False``: ``nn.Conv`` then ``nn.BatchNorm``, the route that the
benchmarks and ``make_serving_fn`` take), in train and in eval mode.

``nn.BatchNorm`` normalises in f32 and rounds once to bf16. The case is
built so that any other rounding shows: the conv output has a mean near
20 and a standard deviation of 0.37 (1x1) to 1.05 (3x3); a bf16 mean of
20 is off by up to 1/16, 6-17% of a standard deviation on every pixel.
Inputs and weights are small multiples of 1/8, so that the conv itself
is exact in bf16 on both sides and every difference comes from the
normalise and the activation. The batch has 2*8*8 = 128 pixels, so the
batch means are exact as well.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf2_yolo_tpu.models import layers as jlayers
from tests.helpers_torch import numpy_tree
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch.bridge import from_flax
from tf2_yolo_tpu_torch.models.layers import ConvBN

torch.set_num_threads(1)

CI, CO = 8, 16
# bf16 units in the last place allowed, by activation. Measured: linear
# 0 (the normalise matches bit for bit); leaky 1 ulp on 8-12% of the
# outputs (JAX multiplies the negative side by 0.1 rounded to bf16,
# torch by 0.1 in f32); mish 0 in train mode and 2 ulps on 14-16% of the
# outputs in eval mode (tanh and softplus from two libraries). The
# parent's bf16 normalise was off by up to 0.19 (thousands of ulps).
ULPS = {"linear": 0, "leaky": 1, "mish": 2}


def _case(kernel, stride, act, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(-1, 2, size=(2, 8, 8, CI)).astype(np.float32)
    x[..., 0] = 1.0                      # a constant channel carries 20
    w = (rng.randint(-2, 3, size=(kernel, kernel, CI, CO)) / 8.0).astype(
        np.float32)
    w[:, :, 0, :] = 0.0
    w[kernel // 2, kernel // 2, 0, :] = 20.0
    jm = jlayers.ConvBN(CO, kernel, stride, act=act, fused=False,
                        dtype=jnp.bfloat16)
    v = numpy_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["conv"]["kernel"] = w
    v["params"]["bn"]["scale"] = (1 + 0.2 * rng.randn(CO)).astype(np.float32)
    v["params"]["bn"]["bias"] = (0.1 * rng.randn(CO)).astype(np.float32)
    v["batch_stats"]["bn"]["mean"] = (20 + 0.5 * rng.randn(CO)).astype(
        np.float32)
    v["batch_stats"]["bn"]["var"] = (0.5 + rng.rand(CO)).astype(np.float32)
    tm = ConvBN(CI, CO, kernel, stride, act=act, dtype=torch.bfloat16,
                device="cpu")
    tm.load_state_dict(from_flax(v), strict=True)
    return x, jm, v, tm


def _ulp(v):
    """One bf16 unit in the last place of each |v| (8 bits of
    precision)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
                   - 7)


@pytest.mark.parametrize("act", ["linear", "leaky", "mish"])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 1), (3, 2)])
def test_bf16_convbn_matches_jax_batchnorm_route(kernel, stride, train,
                                                 act):
    x, jm, v, tm = _case(kernel, stride, act, 20 + 2 * kernel + stride)
    if train:
        want, upd = jm.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(x), train=False)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    # the case holds what it should: conv outputs near 20, spread 0.3-3
    with torch.no_grad():
        y = tm.conv(torch.from_numpy(x))[0].float().numpy()
    assert 19 < y.mean() < 21 and 0.3 < y.std() < 3, (y.mean(), y.std())
    d = np.abs(got.float().numpy() - want)
    assert (d <= ULPS[act] * _ulp(want)).all(), (
        f"max |d| {d.max()}, {int((d > 0).sum())} of {d.size} differ")
    if train:
        for k in ("mean", "var"):
            # running statistics from the same exact sums: f32 apart by
            # the order of one multiply-add at most
            np.testing.assert_allclose(
                getattr(tm.bn, k).numpy(),
                np.asarray(upd["batch_stats"]["bn"][k]), rtol=1e-6,
                atol=1e-6, err_msg=k)
