"""K1 on the row slabs of spatial partitioning (``parallel.spatial``),
through its plain version on the CPU: for every conv geometry of the
port and each ``padding`` kind, the image's rows split over 2, 3 and 4
shards by the balanced rule, each shard's slab (the rows its output rows
read, as the row fetch hands them over) run with its explicit
``Geometry`` (the image's top pad where the slab reaches the top edge,
else 0; the shard's own output rows; 0 rows where it holds none), equals
the matching rows of the whole conv: the forward, the statistics summed
over the slabs, and ``_conv_vjp``'s dx (added back over the slabs'
overlapping rows) and dw (summed), at 1e-5 in f32. The same through the
autograd function ``conv_bn_stats``, whose empty slabs launch nothing
and give zero cotangents."""

import numpy as np
import pytest
import torch

from tf2_yolo_tpu_torch.ops.kernels.conv_bn import (Geometry, _conv_vjp,
                                                    conv_bn_stats,
                                                    conv_bn_stats_plain,
                                                    conv_geometry)
from tf2_yolo_tpu_torch.parallel.spatial import split_rows, window_need

torch.set_num_threads(1)

# (ksize, stride, padding, H, W): the 1x1 and 3x3 of every family, the
# darknet stride-2 pad (even H), flax's SAME at stride 2 (the v1 stem's
# 7x7, MobileNetV2's 3x3, the ResNets' 1x1 projections), the ResNet
# stem's explicit pad 3 and the UNet's 2x2
GEOMETRIES = [
    (1, 1, "darknet", 13, 9), (3, 1, "darknet", 13, 9),
    (3, 2, "darknet", 14, 10), (3, 2, "same", 13, 9),
    (1, 2, "same", 13, 9), (7, 2, "same", 14, 11), (7, 2, 3, 13, 10),
    (2, 1, "same", 13, 9), (3, 1, "darknet", 3, 5), (1, 2, "same", 3, 5),
]


def _slabs(h, g, ksize, stride, n):
    """Per shard: (input rows [a, b), its explicit Geometry, its output
    rows [lo, hi)), as ``SpaceRows.slab`` computes them."""
    need = window_need(ksize, stride, g.pad_top)
    out = []
    for lo, hi in split_rows(g.ho, n):
        a, b = need(lo, hi) if hi > lo else (0, 0)
        out.append(((min(max(a, 0), h), max(min(b, h), 0)),
                    Geometry(hi - lo, g.wo, max(0, -a), g.pad_left),
                    (lo, hi)))
    return out


@pytest.mark.parametrize("ksize,stride,padding,h,w", GEOMETRIES)
def test_slabs_equal_the_whole_conv(ksize, stride, padding, h, w):
    rng = np.random.RandomState(ksize * 100 + stride * 10 + h)
    x = torch.from_numpy(rng.randn(2, h, w, 4).astype(np.float32))
    wt = torch.from_numpy(rng.randn(ksize, ksize, 4, 5).astype(np.float32))
    b = torch.from_numpy(rng.randn(5).astype(np.float32))
    y, s1, s2 = conv_bn_stats_plain(x, wt, b, stride, True, padding)
    g = conv_geometry(h, w, ksize, stride, padding)
    ct = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
    dx, dw = _conv_vjp(x, wt, ct, stride, True, padding)
    for n in (2, 3, 4):
        part_dx = torch.zeros_like(x)
        part_dw = torch.zeros_like(wt)
        sums = torch.zeros(2, 5)
        for (a, bb), geom, (lo, hi) in _slabs(h, g, ksize, stride, n):
            slab = x[:, a:bb].contiguous()
            ys, t1, t2 = conv_bn_stats_plain(slab, wt, b, stride, True,
                                             geom)
            assert ys.shape == (2, hi - lo, g.wo, 5)
            np.testing.assert_allclose(ys.numpy(), y[:, lo:hi].numpy(),
                                       rtol=1e-5, atol=1e-5)
            sums += torch.stack([t1, t2])
            sdx, sdw = _conv_vjp(slab, wt, ct[:, lo:hi].contiguous(),
                                 stride, True, geom)
            assert sdx.shape == slab.shape
            part_dx[:, a:bb] += sdx
            part_dw += sdw
        for got, want in ((sums[0], s1), (sums[1], s2), (part_dx, dx),
                          (part_dw, dw)):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ksize,stride,padding,h,w", GEOMETRIES[:8:3])
def test_slabs_through_the_autograd_function(ksize, stride, padding, h, w):
    """``conv_bn_stats`` on the slabs of 4 shards, the 0-row ones
    included: the forward's rows and the gradients of x, w and b."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, h, w, 4).astype(np.float32))
    wt = torch.from_numpy(rng.randn(ksize, ksize, 4, 5).astype(np.float32))
    b = torch.from_numpy(rng.randn(5).astype(np.float32))
    g = conv_geometry(h, w, ksize, stride, padding)
    ct = torch.from_numpy(rng.randn(2, g.ho, g.wo, 5).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (x, wt, b)]
    y, s1, _ = conv_bn_stats(*leaves, stride, True, padding=padding)
    ((y * ct).sum() + s1.sum()).backward()
    want = [t.grad for t in leaves]
    n = 4 if g.ho >= 4 else g.ho + 2          # some shards hold no row
    parts = [t.clone().requires_grad_() for t in (x, wt, b)]
    total = 0
    for (a, bb), geom, (lo, hi) in _slabs(h, g, ksize, stride, n):
        ys, t1, _ = conv_bn_stats(parts[0][:, a:bb].contiguous(), parts[1],
                                  parts[2], stride, True, padding=geom)
        np.testing.assert_allclose(ys.detach().numpy(),
                                   y[:, lo:hi].detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        total = total + (ys * ct[:, lo:hi]).sum() + t1.sum()
    total.backward()
    for got, w_ in zip(parts, want):
        np.testing.assert_allclose(got.grad.numpy(), w_.numpy(), rtol=1e-5,
                                   atol=1e-4)


def test_explicit_geometry_is_checked():
    """A Geometry whose pad exceeds the window, or whose last output row
    reads past the slab, is a ValueError; odd slabs take the darknet
    stride 2."""
    with pytest.raises(ValueError, match="want 0 <= pad"):
        conv_geometry(5, 5, 3, 2, Geometry(2, 2, 3, 1))
    with pytest.raises(ValueError, match="reads no pixel"):
        conv_geometry(3, 5, 3, 1, Geometry(5, 5, 0, 1))
    assert conv_geometry(7, 10, 3, 2, Geometry(3, 5, 0, 1)) == \
        Geometry(3, 5, 0, 1)


def test_custom_op_takes_a_slab_geometry():
    """The served conv's custom op (``torch.export``'s route) carries an
    explicit geometry as its padding string; its fake gives the slab's
    output shape."""
    from tf2_yolo_tpu_torch.ops.kernels.conv_bn import (_padding_of,
                                                        _padding_text)
    geom = Geometry(3, 5, 0, 1)
    assert _padding_of(_padding_text(geom)) == geom
    assert _padding_of(_padding_text(3)) == 3
    assert _padding_of(_padding_text("same")) == "same"
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 7, 10, 4).astype(np.float32))
    wt = torch.from_numpy(rng.randn(3, 3, 4, 5).astype(np.float32))
    b = torch.zeros(5)
    op = torch.ops.tf2_yolo_tpu_torch.conv_bn_forward
    y = op(x, wt, b, 2, _padding_text(geom))
    want = conv_bn_stats_plain(x, wt, b, 2, False, geom)[0]
    assert torch.equal(y, want)
    with torch._subclasses.FakeTensorMode():
        fake = op(torch.empty(2, 7, 10, 4), torch.empty(3, 3, 4, 5),
                  torch.empty(5), 2, _padding_text(geom))
    assert tuple(fake.shape) == (2, 3, 5, 5)
