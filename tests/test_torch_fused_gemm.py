"""The port's fused GEMM on the CPU (its plain versions) against the JAX
package's Pallas kernels in interpret mode, forward and backward.

``fused_gemm`` is held to ``packed_gemm.fused_gemm`` and its custom VJP
on the same numpy-seeded inputs; the explicit plain backward is also held
to autograd through the plain forward, so that the two plain versions
agree with each other. The CUDA kernels themselves run only on the card,
through ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf2_yolo_tpu.ops.pallas import packed_gemm
from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch.ops.kernels.fused_gemm import (
    act_and_grad, fused_gemm, fused_gemm_bwd_plain, fused_gemm_plain)

torch.set_num_threads(1)

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# f32: products of <= 3 * 24 terms summed in another order, and exp from
# two libraries (measured max |diff| 3.6e-7 on values up to 1.4): rtol
# 2e-5, atol 1e-5, the bound the JAX package holds its own kernels to.
# bf16: both sides round the same f32 values to 8 bits; where two f32 sums
# differ in their last bit a result may round to the neighbouring bf16
# value, 2^-8 relative (measured: one dx entry, 9.8e-4 at 0.5): rtol 2^-7
# and atol 2^-7 of the tensor's scale.
TOL = {"f32": dict(rtol=2e-5, atol=1e-5), "bf16": dict(rtol=2 ** -7,
                                                        atol=2 ** -7)}


@pytest.fixture
def interpret():
    packed_gemm.set_interpret(True)
    yield
    packed_gemm.set_interpret(False)


def _case(seed, m, ks, n, pattern):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(m, k).astype(np.float32) for k in ks]
    ws = [(rng.randn(k, n) / np.sqrt(sum(ks))).astype(np.float32)
          for k in ks]
    affines = [((1 + 0.2 * rng.randn(1, k)).astype(np.float32),
                (0.3 * rng.randn(1, k)).astype(np.float32)) if on else None
               for k, on in zip(ks, pattern)]
    cts = ((0.1 * rng.randn(m, n)).astype(np.float32),
           (0.1 * rng.randn(1, n)).astype(np.float32),
           (0.01 * rng.randn(1, n)).astype(np.float32))
    return xs, ws, affines, cts


def _close(got, want, tol, tag):
    want = np.asarray(want, np.float32).reshape(got.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale, err_msg=tag)


CASES = [
    # m, ks, n, prologue pattern, act
    (24, [16], 8, [True], "mish"),
    (24, [16], 8, [False], "mish"),
    (13, [8, 12], 16, [True, True], "mish"),       # concat split, odd M
    (24, [8, 8], 8, [True, False], "leaky"),
    (20, [8, 8, 8], 8, [True, True, False], "linear"),
    (20, [8, 8, 8], 8, [True, True, True], "mish"),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,ks,n,pattern,act", CASES)
def test_fused_gemm_matches_pallas(interpret, m, ks, n, pattern, act, dtype):
    xs, ws, affines, cts = _case(len(ks) + n, m, ks, n, pattern)
    tol = TOL[dtype]

    def jf(jxs, jws, jaffs):
        return packed_gemm.fused_gemm(jxs, jws, jaffs, act=act,
                                      dtype=JDT[dtype])

    jxs = [jnp.asarray(x, JDT[dtype]) for x in xs]
    jws = [jnp.asarray(w, JDT[dtype]) for w in ws]
    jaffs = [None if a is None else (jnp.asarray(a[0]), jnp.asarray(a[1]))
             for a in affines]
    want, vjp = jax.vjp(jf, jxs, jws, jaffs)
    jcts = (jnp.asarray(cts[0], JDT[dtype]), jnp.asarray(cts[1]),
            jnp.asarray(cts[2]))
    want_dxs, want_dws, want_daffs = vjp(jcts)

    txs = [torch.from_numpy(x).to(TDT[dtype]).requires_grad_() for x in xs]
    tws = [torch.from_numpy(w).to(TDT[dtype]).requires_grad_() for w in ws]
    taffs = [None if a is None else
             (torch.from_numpy(a[0]).requires_grad_(),
              torch.from_numpy(a[1]).requires_grad_()) for a in affines]
    before = fused_gemm.launches, fused_gemm.bwd_launches
    y, s1, s2 = fused_gemm(txs, tws, taffs, act=act, dtype=TDT[dtype])
    assert y.dtype == TDT[dtype] and s1.dtype == s2.dtype == torch.float32
    _close(y.detach(), want[0], tol, "y")
    _close(s1.detach(), want[1], tol, "s1")
    _close(s2.detach(), want[2], tol, "s2")

    leaves = txs + tws + [t for a in taffs if a is not None for t in a]
    grads = torch.autograd.grad(
        (y, s1, s2), leaves,
        (torch.from_numpy(cts[0]).to(TDT[dtype]),
         torch.from_numpy(cts[1][0]), torch.from_numpy(cts[2][0])))
    # a CPU tensor takes the plain versions, which are no launches
    assert (fused_gemm.launches, fused_gemm.bwd_launches) == before
    nx = len(xs)
    for i in range(nx):
        assert grads[i].dtype == TDT[dtype]
        _close(grads[i], want_dxs[i], tol, f"dx{i}")
        _close(grads[nx + i], want_dws[i], tol, f"dw{i}")
    rest = iter(grads[2 * nx:])
    for i, a in enumerate(want_daffs):
        if a is not None:
            _close(next(rest), a[0], tol, f"da{i}")
            _close(next(rest), a[1], tol, f"db{i}")


@pytest.mark.parametrize("m,ks,n,pattern,act", CASES)
def test_plain_backward_matches_autograd_of_plain_forward(m, ks, n, pattern,
                                                          act):
    xs, ws, affines, cts = _case(7, m, ks, n, pattern)
    txs = [torch.from_numpy(x).requires_grad_() for x in xs]
    tws = [torch.from_numpy(w).requires_grad_() for w in ws]
    aas = [None if a is None else torch.from_numpy(a[0][0]).requires_grad_()
           for a in affines]
    bbs = [None if a is None else torch.from_numpy(a[1][0]).requires_grad_()
           for a in affines]
    dy, ds1, ds2 = (torch.from_numpy(cts[0]), torch.from_numpy(cts[1][0]),
                    torch.from_numpy(cts[2][0]))
    y, s1, s2 = fused_gemm_plain(txs, tws, aas, bbs, act)
    leaves = txs + tws + [t for t in aas + bbs if t is not None]
    auto = dict(zip(map(id, leaves),
                    torch.autograd.grad((y, s1, s2), leaves, (dy, ds1, ds2))))
    with torch.no_grad():
        dxs, dws, das, dbs = fused_gemm_bwd_plain(
            txs, tws, aas, bbs, y, dy, ds1, ds2, act)
    # f32, the same sums written two ways (three products and an analytic
    # derivative against autograd's chain): measured max |diff| 3.6e-7 on
    # gradients up to 1.8; bound rtol 2e-5, atol 1e-5
    for got, leaf in zip(dxs + dws + das + dbs, txs + tws + aas + bbs):
        if leaf is not None:
            np.testing.assert_allclose(got.numpy(), auto[id(leaf)].numpy(),
                                       rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["mish", "leaky", "linear"])
def test_act_and_grad_matches_jax(act):
    z = np.concatenate([np.linspace(-30, 30, 241), [0.0, 20.0, 25.0, 88.0]]
                       ).astype(np.float32)
    g, gp = act_and_grad(torch.from_numpy(z), act)
    jg, jgp = packed_gemm._act_and_grad(jnp.asarray(z), act)
    # the same f32 formulas; exp from two libraries (measured max |diff|
    # 3.7e-9 on values up to 1.1): 2e-6 relative
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-6,
                               atol=1e-7)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), rtol=2e-6,
                               atol=1e-7)
    assert np.isfinite(gp.numpy()).all()


@pytest.mark.parametrize("case", ["act", "dtype", "rows", "weight", "affine",
                                  "count", "device"])
def test_fused_gemm_wrapper_rejects(case):
    x, w = torch.zeros(6, 4), torch.zeros(4, 8)
    xs, ws, affs, act, dtype, err = [x], [w], [None], "mish", \
        torch.float32, ValueError
    if case == "act":
        act = "relu"
    elif case == "dtype":
        dtype, err = torch.float64, TypeError
    elif case == "rows":
        xs, ws, affs = [x, torch.zeros(5, 4)], [w, w], [None, None]
    elif case == "weight":
        ws = [torch.zeros(3, 8)]
    elif case == "affine":
        affs = [(torch.ones(3), torch.zeros(3))]
    elif case == "count":
        xs, ws, affs = [x] * 10, [w] * 10, [None] * 10
    elif case == "device":
        xs, ws = [x.to("meta")], [w.to("meta")]
    with pytest.raises((err, RuntimeError) if case == "affine" else err):
        fused_gemm(xs, ws, affs, act=act, dtype=dtype)
