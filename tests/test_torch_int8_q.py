"""Kernel Q's two halves and its launch plan, on the CPU.

Q (``tf2_yolo_tpu_torch/ops/kernels/conv_int8.py``) runs on the card as
a quantize pass and an int8 conv split over K. Here, with no card:

- the quantize half (``quantize_int8_plain``) against the JAX package's
  rule, ``clip(round(x / sx), -127, 127)`` applied eagerly (under ``jit``
  XLA divides by multiplying with the reciprocal, which rounds otherwise),
  on seeded inputs with exact .5 ties and both saturations;
- the conv half on int8 input (``conv_int8_xq_plain``) after it, equal
  bit for bit to ``conv_int8_plain`` at the three geometries, and its
  int32 sums equal to a direct numpy conv;
- split-K: the int32 sums over the K slices of each split that ``_plan``
  may choose add up to the whole sum;
- ``_plan`` at every distinct shape that the int8 program of YOLOv4@416
  puts on Q at a gate of 256 channels, at batch 8 and 32: enough blocks
  for the 132 SMs, splits that divide the slices, the kernel's alignment
  preconditions, and the shapes it refuses;
- the CUDA entry's alignment check, reached with CPU tensors before any
  library is loaded.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.helpers_torch import release_memory_after_module  # noqa: F401
from tf2_yolo_tpu_torch.models import YoloV4
from tf2_yolo_tpu_torch.models.layers import ConvBN
from tf2_yolo_tpu_torch.ops.kernels import conv_int8 as q

torch.set_num_threads(1)

SMS = 132
SMEM_MAX = 232448            # bytes of shared memory a block may use
TILES = {0: 256, 1: 128, 2: 64, 3: 32}

# (H = W of the input, Ci, Co, k, stride): the 16 distinct shapes of the
# 61 ConvBNs with min(Ci, Co) >= 256 in YOLOv4@416
GATE256_SHAPES = [
    (13, 512, 256, 1, 1), (13, 512, 512, 1, 1), (13, 512, 512, 3, 1),
    (13, 512, 1024, 3, 1), (13, 1024, 512, 1, 1), (13, 1024, 1024, 1, 1),
    (13, 2048, 512, 1, 1), (26, 256, 256, 1, 1), (26, 256, 256, 3, 1),
    (26, 256, 512, 3, 1), (26, 256, 512, 3, 2), (26, 512, 256, 1, 1),
    (26, 512, 512, 1, 1), (26, 512, 1024, 3, 2), (52, 256, 256, 1, 1),
    (52, 256, 512, 3, 2),
]


def _jax_quantize(x, sx, dtype):
    """The JAX package's rule, eager, the scale an argument."""
    xj = jnp.asarray(x, dtype=dtype).astype(jnp.float32)
    return np.asarray(jnp.clip(jnp.round(xj / jnp.asarray(sx, jnp.float32)),
                               -127, 127).astype(jnp.int8))


def _quant_inputs(rng, sx, tie_max):
    """Seeded normals around the scale, every tie (k + 0.5) * sx for
    |k + 0.5| <= tie_max, values at ±127.5 sx, saturations, zeros."""
    ties = (np.arange(-tie_max, tie_max) + 0.5) * sx
    sat = np.array([127.5, -127.5, 128.0, -128.0, 300.0, -300.0, 1e6, -1e6,
                    0.0, -0.0]) * sx
    normal = rng.randn(4000) * 60 * sx
    return np.concatenate([ties, sat, normal]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sx", [2.0 ** -6, 0.0173], ids=["pow2", "odd"])
def test_quantize_int8_plain_matches_eager_jax(dtype, sx):
    rng = np.random.RandomState(11)
    # bf16 holds (k + 0.5) exactly up to 127.5 (8 significant bits)
    x = _quant_inputs(rng, sx, 130 if dtype == "float32" else 127)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x, dtype=getattr(jnp, dtype))
    # the same input values in both frameworks
    np.testing.assert_array_equal(xt.float().numpy(),
                                  np.asarray(xj.astype(jnp.float32)))
    got = q.quantize_int8_plain(xt, sx)
    assert got.dtype == torch.int8
    want = _jax_quantize(x, sx, getattr(jnp, dtype))
    np.testing.assert_array_equal(got.numpy(), want)
    if sx == 2.0 ** -6:
        # exact ties round half to even; the saturations clamp
        n_ties = 260 if dtype == "float32" else 254
        k = np.arange(-n_ties // 2, n_ties // 2) + 0.5
        even = np.clip(np.round(k), -127, 127)
        np.testing.assert_array_equal(got.numpy()[:n_ties], even)
        np.testing.assert_array_equal(
            got.numpy()[n_ties:n_ties + 8], [127, -127, 127, -127, 127,
                                             -127, 127, -127])


def _conv_case(seed, ci, co, k, stride, dtype, n=2, h=6, w=8):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, h, w, ci).astype(np.float32)) \
        .to(dtype)
    wq8, _ = q.quantize_weights(torch.from_numpy(
        rng.randn(k, k, ci, co).astype(np.float32)))
    c = torch.from_numpy((0.01 + 0.02 * rng.rand(co)).astype(np.float32))
    t = torch.from_numpy(rng.randn(co).astype(np.float32))
    return x, wq8, q.weight_layout(wq8), c, t


def _numpy_acc(xq, wq8, k, stride):
    """A direct int64 conv of the int8 values: input pixel (ho * stride -
    pad + ky, wo * stride - pad + kx), pad 1 for 3x3 (the darknet top /
    left pad at stride 2), zero outside the image."""
    n, h, w, ci = xq.shape
    pad = 1 if k == 3 else 0
    xp = np.zeros((n, h + 2, w + 2, ci), np.int64)
    xp[:, 1:h + 1, 1:w + 1] = xq
    ho, wo = h // stride, w // stride
    acc = np.zeros((n, ho, wo, wq8.shape[3]), np.int64)
    for ky in range(k):
        for kx in range(k):
            r0, c0 = 1 - pad + ky, 1 - pad + kx
            patch = xp[:, r0:r0 + stride * (ho - 1) + 1:stride,
                       c0:c0 + stride * (wo - 1) + 1:stride]
            acc += np.einsum("nhwc,co->nhwo", patch,
                             wq8[ky, kx].astype(np.int64))
    return acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ci", [3, 32], ids=["gather", "ring"])
@pytest.mark.parametrize("geometry", [(1, 1), (3, 1), (3, 2)],
                         ids=["1x1", "3x3s1", "3x3s2"])
def test_quantize_then_conv_equals_conv_int8_plain(geometry, ci, dtype):
    k, stride = geometry
    x, wq8, wq, c, t = _conv_case(ci + 7 * k + stride, ci, 24, k, stride,
                                  dtype)
    sx = float(x.float().abs().max()) / 127.0
    want = q.conv_int8_plain(x, wq, c, t, sx, k, stride, dtype)
    xq = q.quantize_int8_plain(x, sx)
    got = q.conv_int8_xq_plain(xq, wq, c, t, k, stride, dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    acc = q.conv_int8_acc_plain(xq, wq, k, stride)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(),
                                  _numpy_acc(xq.numpy(), wq8.numpy(), k,
                                             stride))


# (Ci, Co, k, stride): K long enough for several 128-byte slices, and
# splits of 2, 3, 6 and 9 among the choices
SPLIT_CASES = [(48, 16, 3, 1), (512, 8, 1, 1), (128, 8, 3, 2),
               (256, 8, 3, 1), (2048, 8, 1, 1)]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"{c[0]}->{c[1]}_{c[2]}x{c[2]}s{c[3]}"
                              for c in SPLIT_CASES])
def test_split_k_partial_sums_add_up(case):
    ci, co, k, stride = case
    x, _, wq, _, _ = _conv_case(ci, ci, co, k, stride, torch.float32,
                                n=1, h=4, w=6)
    xq = q.quantize_int8_plain(x, 0.02)
    whole = q.conv_int8_acc_plain(xq, wq, k, stride)
    kp = wq.shape[1]
    slices = -(-kp // 128)
    choices = q._split_choices(slices)
    assert choices[0] == 1 and len(choices) > 1
    for splits in choices:
        assert slices % splits == 0
        sps = slices // splits
        assert splits == 1 or sps >= 2
        total = torch.zeros_like(whole)
        for s in range(splits):       # split s: slices s*sps .. +sps
            total += q.conv_int8_acc_plain(xq, wq, k, stride,
                                           s * sps * 128,
                                           min(kp, (s + 1) * sps * 128))
        assert torch.equal(total, whole), splits


def test_gate256_shapes_are_the_models():
    """GATE256_SHAPES are the distinct (H, Ci, Co, k, stride) of YOLOv4's
    ConvBNs with min(Ci, Co) >= 256 at 416^2 (traced at 64^2: every
    spatial size scales by 416 / 64), 61 layers."""
    model = YoloV4(np.ones((9, 2)) * 0.1, 3, device="cpu").eval()
    seen = []

    def hook(mod, args, out):
        kern = mod.conv.kernel
        seen.append((args[0].shape[1] * 416 // 64, kern.shape[2],
                     kern.shape[3], kern.shape[0], mod.conv.stride))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, ConvBN) and m.bn is not None]
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3))
    for handle in handles:
        handle.remove()
    gated = [s for s in seen if min(s[1], s[2]) >= 256]
    assert len(seen) == 107 and len(gated) == 61
    assert sorted(set(gated)) == GATE256_SHAPES


@pytest.mark.parametrize("batch", [8, 32])
@pytest.mark.parametrize("shape", GATE256_SHAPES,
                         ids=[f"{s[0]}^2_{s[1]}->{s[2]}_{s[3]}x{s[3]}s{s[4]}"
                              for s in GATE256_SHAPES])
def test_plan_at_gate256_shapes(shape, batch):
    h, ci, co, k, stride = shape
    plan = q._plan(batch, h, h, ci, co, k, stride)
    m = batch * (h // stride) ** 2
    kp = q.padded_k(k, ci)
    slices = -(-kp // 128)
    bn = TILES[plan.config]
    # the tiles cover the output, and with the split fill the 132 SMs
    assert plan.grid == (-(-m // 128), -(-co // bn))
    assert plan.grid[0] * plan.grid[1] * plan.splits >= SMS
    # the split divides the slices and leaves each at least two
    assert slices % plan.splits == 0
    assert plan.splits in q._split_choices(slices)
    assert plan.splits == 1 or slices // plan.splits >= 2
    # the 256-channel tile only unsplit, where it alone gives two waves
    assert bn != 256 or (plan.splits == 1 and plan.grid[0] * plan.grid[1]
                         >= 2 * SMS)
    # the fewest splits that reach 132 blocks with this tile
    choices = q._split_choices(slices)
    assert all(plan.grid[0] * plan.grid[1] * d < SMS
               for d in choices[:choices.index(plan.splits)])
    # alignment preconditions of the ring route: 16-byte chunks of K lie
    # in one tap (Ci % 16), the weight rows and K steps are whole k32
    # steps (kp % 32), the ring fits the shared memory
    assert plan.route == "ring" and ci % 16 == 0
    assert plan.kp == kp == k * k * ci and kp % 32 == 0
    assert plan.stages in (4, 6) and plan.smem_bytes <= SMEM_MAX
    assert plan.stages == 6 or slices // plan.splits <= 2 or bn == 256


@pytest.mark.parametrize("dims,match", [
    ((1, 8, 8, 32, 32, 5, 1), "unsupported conv"),
    ((1, 8, 8, 32, 32, 1, 2), "the darknet pad is a 3x3 stride-2 pad"),
    ((1, 9, 8, 32, 32, 3, 2), "even"),
    ((0, 8, 8, 32, 32, 3, 1), "empty"),
    ((1, 8, 8, 32, 65536 * 256 + 1, 1, 1), "unsupported size"),
], ids=["5x5", "1x1s2", "odd-s2", "empty", "too-many-columns"])
def test_plan_refusals(dims, match):
    with pytest.raises(ValueError, match=match):
        q._plan(*dims)


def _misaligned(shape, dtype):
    """A contiguous CPU tensor one element past a 16-byte boundary."""
    base = torch.ones(int(np.prod(shape)) + 1, dtype=dtype)
    view = base[1:].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("route", ["ring x", "gather x", "int8 weights"])
def test_cuda_entry_refuses_misaligned_tensors(route):
    # the CUDA entry checks every operand and its scratch before it loads
    # its library or launches: a CPU tensor reaches the check here
    ci = 3 if route == "gather x" else 32
    x = torch.ones(2, 9, 8, ci, dtype=torch.bfloat16)
    wq = torch.zeros(16, q.padded_k(3, ci), dtype=torch.int8)
    if route == "int8 weights":
        wq = _misaligned(wq.shape, torch.int8)
    else:
        x = _misaligned(x.shape, torch.bfloat16)
    c = t = torch.ones(16)
    counts = lambda: (q.conv_int8.launches, q.conv_int8.tc_launches,
                      q.conv_int8.quant_launches)
    before = counts()
    with pytest.raises(ValueError, match="aligned"):
        q._forward_cuda(x, wq, c, t, 0.1, 3, 1, torch.bfloat16,
                        q._check(x, wq, c, t, 0.1, 3, 1, torch.bfloat16))
    assert counts() == before
