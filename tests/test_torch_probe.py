"""The port's probe layer (``tools.bench_packed_probe``) on the CPU against
the JAX package's probe kernel ``fused_kernel`` in interpret mode.

The JAX tool calls its kernel at one fixed size on the TPU; here the same
kernel function runs through ``pl.pallas_call(..., interpret=True)`` at a
small size, with the tool's block layout (row blocks of x and y, whole
weights and affines, sums carried across the grid).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tools import bench_packed_probe as jprobe
from tf2_yolo_tpu_torch.ops.kernels.fused_gemm import fused_gemm
from tf2_yolo_tpu_torch.tools import bench_packed_probe as probe

torch.set_num_threads(1)


def _jax_layer(x, w, a, b, blk):
    m, k = x.shape
    n = w.shape[1]
    row = lambda i: (i, 0)
    whole = lambda i: (0, 0)
    return pl.pallas_call(
        jprobe.fused_kernel, grid=(m // blk,),
        in_specs=[pl.BlockSpec((blk, k), row), pl.BlockSpec((k, n), whole),
                  pl.BlockSpec((1, k), whole), pl.BlockSpec((1, k), whole)],
        out_specs=[pl.BlockSpec((blk, n), row), pl.BlockSpec((1, n), whole),
                   pl.BlockSpec((1, n), whole)],
        out_shape=[jax.ShapeDtypeStruct((m, n), jnp.bfloat16),
                   jax.ShapeDtypeStruct((1, n), jnp.float32),
                   jax.ShapeDtypeStruct((1, n), jnp.float32)],
        interpret=True)(x, w, a, b)


def _case(seed, m, k, layers):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    ws = [(rng.randn(k, k) * 0.2).astype(np.float32) for _ in range(layers)]
    aas = [(1 + 0.2 * rng.randn(k)).astype(np.float32) for _ in range(layers)]
    bbs = [(0.3 * rng.randn(k)).astype(np.float32) for _ in range(layers)]
    return x, ws, aas, bbs


def _torch(j):
    return torch.from_numpy(np.array(j, np.float32))


@pytest.mark.parametrize("m,k,blk", [(48, 16, 16), (64, 128, 32)])
def test_probe_layers_match_the_pallas_probe_kernel(m, k, blk):
    """Layer by layer on the JAX side's own inputs, then the chain."""
    x, ws, aas, bbs = _case(m, m, k, 3)
    tws = [torch.from_numpy(w).bfloat16() for w in ws]
    tas, tbs = map(lambda vs: [torch.from_numpy(v) for v in vs], (aas, bbs))
    jx = jnp.asarray(x, jnp.bfloat16)
    before = probe.probe_layer.launches
    for w, a, b, tw, ta, tb in zip(ws, aas, bbs, tws, tas, tbs):
        tx = _torch(jx).bfloat16()
        jx, js1, js2 = _jax_layer(jx, jnp.asarray(w, jnp.bfloat16),
                                  jnp.asarray(a)[None], jnp.asarray(b)[None],
                                  blk)
        ty, t1, t2 = probe.probe_layer(tx, tw, ta, tb)
        assert ty.dtype == torch.bfloat16
        assert t1.dtype == t2.dtype == torch.float32
        want = np.asarray(jx, np.float32)
        # both sides round the same f32 products to bf16: 1 ulp where two
        # f32 sums differ in their last bit (measured: 0 to 2 elements)
        np.testing.assert_allclose(ty.float().numpy(), want, rtol=2 ** -7,
                                   atol=1e-4 * np.abs(want).max())
        # f32 sums of m f32 products in another order (measured 3.8e-6 on
        # sums up to 42): 1e-5 of the largest
        for got, ref in ((t1, js1), (t2, js2)):
            ref = np.asarray(ref)[0]
            np.testing.assert_allclose(
                got.numpy(), ref, rtol=0,
                atol=1e-5 * max(1.0, np.abs(ref).max()))
    ty, _, _ = probe.fused_chain(torch.from_numpy(x).bfloat16(), tws, tas,
                                 tbs)
    assert probe.probe_layer.launches == before       # CPU: plain version
    # through the chain an element that flipped by an ulp in one layer
    # moves the next layer's sums (measured 1.1e-3 of the largest element
    # at K = 128): 2^-7 of the largest element
    np.testing.assert_allclose(ty.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


def test_probe_statistics_are_of_the_unrounded_product():
    """The probe sums the f32 product, ``fused_gemm`` the rounded y."""
    x, ws, aas, bbs = _case(1, 256, 32, 1)
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(ws[0]).bfloat16()
    ta, tb = torch.from_numpy(aas[0]), torch.from_numpy(bbs[0])
    y, s1, s2 = probe.probe_layer(tx, tw, ta, tb)
    yg, g1, g2 = fused_gemm([tx], [tw], [(ta, tb)], dtype=torch.bfloat16)
    assert torch.equal(y, yg)
    acc = probe._prologue(tx, ta, tb, "mish")[0].double() @ tw.double()
    np.testing.assert_allclose(s2.numpy(), (acc * acc).sum(0).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(g2.numpy(),
                               (yg.double() ** 2).sum(0).numpy(), rtol=1e-5)
    assert not torch.allclose(s2, g2, rtol=1e-5, atol=0)


def test_eager_chain_is_the_same_network_as_the_fused_chain():
    """conv1x1 + BN-train + mish layer by layer equals the fused chain fed
    each layer's own batch statistics as the next affine (f32)."""
    x, ws, _, _ = _case(2, 2 * 6 * 6, 8, 3)
    tx = torch.from_numpy(x)
    tws = [torch.from_numpy(w) for w in ws]
    scales = [torch.full((8,), 1.5), torch.ones(8), torch.full((8,), 0.7)]
    biases = [torch.full((8,), 0.1), torch.zeros(8), torch.full((8,), -0.2)]
    want, mean, var = probe.eager_chain(tx.reshape(2, 6, 6, 8), tws, scales,
                                        biases)
    # the fused form: layer 0 reads x as it is (a linear 1x1 conv), every
    # later layer reads the raw y through the producer's BN affine + mish
    y = tx @ tws[0]
    for i in range(3):
        m_, v_ = y.mean(0), (y * y).mean(0) - y.mean(0) ** 2
        a = scales[i] * torch.rsqrt(v_ + 1e-3)
        b = biases[i] - m_ * a
        if i < 2:
            y, s1, s2 = probe.probe_layer(y, tws[i + 1], a, b)
    got = probe.act_and_grad(y * a + b, "mish")[0]
    # f32, three layers of 8 products and statistics over 72 rows
    np.testing.assert_allclose(got.numpy(), want.reshape(72, 8).numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(m_.numpy(), mean.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(v_.numpy(), var.numpy(), rtol=1e-4, atol=1e-6)


def test_probe_layer_rejects_what_the_kernel_does_not_take():
    x, w = torch.zeros(6, 4), torch.zeros(4, 8)
    with pytest.raises(ValueError):
        probe.probe_layer(x, torch.zeros(3, 8), torch.ones(4), torch.zeros(4))
    with pytest.raises(ValueError):
        probe.probe_layer(x, w, torch.ones(3), torch.zeros(3))
    with pytest.raises(TypeError):
        probe.probe_layer(x.double(), w.double(), torch.ones(4),
                          torch.zeros(4))
