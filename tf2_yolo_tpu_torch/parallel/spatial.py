"""Spatial partitioning: the image height split over the ``space`` axis
of a ``("data", "space")`` process grid (``mesh.make_mesh_spatial``).

In the JAX package one ``NamedSharding`` of the images, ``P("data",
"space")``, is enough: GSPMD derives the halo exchanges of every conv and
pool from it. Here each process holds the rows of its shard of every
activation and the layers fetch what they lack themselves
(``models.layers.set_spatial_parallel`` attaches a :class:`SpaceRows` to
each windowed layer). Three parts:

- **The split rule** (:func:`split_rows`): every level of height H is
  split over the n processes of a space group by one balanced rule, the
  first ``H % n`` shards holding one row more (13 rows at n 2 are 7 + 6,
  at n 4 4 + 3 + 3 + 3; 2 rows at n 4 are 1 + 1 + 0 + 0). A shard may
  hold no row.
- **The row fetch** (:meth:`SpaceRows.slab`): an op with a window in H
  computes, from its own geometry, which input rows ``[a, b)`` the output
  rows of its shard need, and fetches the rows it lacks from whichever
  shards hold them (point to point, host copies under gloo, whose
  send / recv takes no CUDA tensor). Rows outside ``[0, H)`` are not
  fetched: they are the op's pad, which the op adds itself. The backward
  sends each fetched row's cotangent back to its owner, which adds it.
- **The gather of the heads** (:func:`gather_rows`): the model's outputs
  gathered on H over the space group (padded to the largest shard for
  the all-gather and cut again), so that every process of a space group
  computes the same loss and decode, and no loss term or grid offset has
  to know the split. Its backward takes this process's rows.

Every exchange is logged by ``collectives.record``: kind ``"row_fetch"``
(forward) or ``"row_return"`` (backward) by the receiving process, one
record a message, with its rows; the heads' gather is an
``"all_gather"`` on dim 1.

Every process of a space group runs the same ops in the same order,
those of a shard without rows included (their outputs have 0 rows): the
backward's exchanges and the BatchNorm all-reduces then meet in the same
order on every process.
"""

from dataclasses import dataclass

import torch
import torch.distributed as dist

from .collectives import all_gather, record


def split_rows(h, n):
    """``[(lo, hi)]`` of the ``n`` shards of ``h`` rows: the first
    ``h % n`` shards hold one row more."""
    q, r = divmod(int(h), int(n))
    out, lo = [], 0
    for i in range(n):
        hi = lo + q + (i < r)
        out.append((lo, hi))
        lo = hi
    return out


@dataclass(frozen=True)
class SpaceShard:
    """A process's place on the space axis: the space ``group`` (None in
    one process), its size ``n``, this process's ``index`` on it, the
    group's global ``ranks`` in index order, and the size ``n_data`` of
    the data axis (the BatchNorm count's factor)."""
    group: object
    n: int
    index: int
    ranks: tuple
    n_data: int = 1

    def rows(self, h):
        """This process's rows ``(lo, hi)`` of a level of ``h`` rows."""
        return split_rows(h, self.n)[self.index]


@dataclass(frozen=True)
class SpaceRows:
    """A windowed layer's place: its :class:`SpaceShard` and the global
    height ``h`` of its input (``layers.set_spatial_parallel``'s shape
    pass)."""
    shard: SpaceShard
    h: int

    def own(self):
        """This process's rows ``(lo, hi)`` of the input."""
        return self.shard.rows(self.h)

    def slab(self, x, ho, need):
        """The rows of the global input that this process's output rows
        read: ``(slab, top, bottom, (olo, ohi))``. ``x`` holds this
        process's rows of the input (dim 1); ``ho`` is the op's global
        output height and ``need(lo, hi)`` the input rows ``[a, b)``
        (unclipped: negative or past ``h`` where the window reaches into
        the pad) that output rows ``[lo, hi)`` read. ``slab`` holds the
        rows ``[max(a, 0), min(b, h))``; ``top`` and ``bottom`` are the
        rows of pad the op adds above and below it; ``(olo, ohi)`` are
        this process's output rows. A shard without output rows gets a
        slab of 0 rows and no pad."""
        lo, hi = self.own()
        if x.shape[1] != hi - lo:
            raise ValueError(f"a shard of {x.shape[1]} rows of a {self.h}-row"
                             f" input; the split gives shard "
                             f"{self.shard.index} rows [{lo}, {hi})")
        outs = split_rows(ho, self.shard.n)
        wants = [need(*o) if o[1] > o[0] else (0, 0) for o in outs]
        needs = tuple((min(max(a, 0), self.h), max(min(b, self.h), 0))
                      for a, b in wants)
        slab = _FetchRows.apply(x, self.shard, self.h, needs)
        a, b = wants[self.shard.index]
        return (slab, max(0, -a), max(0, b - self.h),
                outs[self.shard.index])


def window_need(ksize, stride, pad_top):
    """``need`` of :meth:`SpaceRows.slab` for a window of ``ksize`` rows
    at ``stride`` under ``pad_top`` rows of pad: output row r reads
    input rows r s - pad_top ... r s - pad_top + k - 1."""
    return lambda lo, hi: (lo * stride - pad_top,
                           (hi - 1) * stride - pad_top + ksize)


def _host(group, t):
    """Gloo's send / recv take no CUDA tensor: a host copy there."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def _exchange(sends, recvs, shard, kind):
    """Point to point: ``sends`` ``[(space index, tensor)]`` and ``recvs``
    ``[(space index, empty tensor)]``, all posted, then waited for;
    returns the received tensors on the tensors' device, each logged as
    ``kind``."""
    group, ranks = shard.group, shard.ranks
    reqs, bufs = [], []
    for i, t in recvs:
        buf = _host(group, t)
        reqs.append(dist.irecv(buf, src=ranks[i], group=group))
        bufs.append((t, buf))
    keep = []
    for j, t in sends:
        t = _host(group, t.contiguous())
        keep.append(t)
        reqs.append(dist.isend(t, dst=ranks[j], group=group))
    for r in reqs:
        r.wait()
    out = []
    for t, buf in bufs:
        record(kind, group, 1, buf.numel(), rows=buf.shape[1])
        out.append(buf if buf is t else buf.to(t.device))
    return out


def _overlap(a, b, c, d):
    lo, hi = max(a, c), min(b, d)
    return (lo, hi) if hi > lo else None


class _FetchRows(torch.autograd.Function):
    """apply(x, shard, h, needs): the rows ``needs[shard.index]`` of the
    global tensor whose shard ``x`` this process holds (see
    :meth:`SpaceRows.slab`)."""

    @staticmethod
    def forward(ctx, x, shard, h, needs):
        ctx.shard, ctx.h, ctx.needs = shard, h, needs
        me, owners = shard.index, split_rows(h, shard.n)
        lo, hi = owners[me]
        a, b = needs[me]
        sends = [(j, x[:, s0 - lo:s1 - lo])
                 for j, nj in enumerate(needs) if j != me
                 for s0, s1 in [_overlap(*nj, lo, hi) or (0, 0)] if s1 > s0]
        pieces, recvs = [], []           # in row order; None: received
        for i, (olo, ohi) in enumerate(owners):
            part = _overlap(a, b, olo, ohi)
            if part is None:
                continue
            if i == me:
                pieces.append(x[:, part[0] - lo:part[1] - lo])
            else:
                recvs.append((i, x.new_empty((x.shape[0], part[1] - part[0],
                                              *x.shape[2:]))))
                pieces.append(None)
        got = iter(_exchange(sends, recvs, shard, "row_fetch"))
        out = [next(got) if p is None else p for p in pieces]
        if not out:
            return x.new_empty((x.shape[0], 0, *x.shape[2:]))
        return torch.cat(out, dim=1)

    @staticmethod
    def backward(ctx, dy):
        shard, h, needs = ctx.shard, ctx.h, ctx.needs
        me, owners = shard.index, split_rows(h, shard.n)
        lo, hi = owners[me]
        a, _ = needs[me]
        # the cotangents of the rows fetched go back to their owners; the
        # owner adds those of the rows it lent
        sends = []
        for i, (olo, ohi) in enumerate(owners):
            part = _overlap(*needs[me], olo, ohi)
            if part is not None and i != me:
                sends.append((i, dy[:, part[0] - a:part[1] - a]))
        recvs, spans = [], []
        for j, nj in enumerate(needs):
            part = _overlap(*nj, lo, hi)
            if part is not None and j != me:
                recvs.append((j, dy.new_empty((dy.shape[0], part[1] - part[0],
                                               *dy.shape[2:]))))
                spans.append(part)
        dx = dy.new_zeros((dy.shape[0], hi - lo, *dy.shape[2:]))
        own = _overlap(*needs[me], lo, hi)
        if own is not None:
            dx[:, own[0] - lo:own[1] - lo] += dy[:, own[0] - a:own[1] - a]
        for (s0, s1), g in zip(spans, _exchange(sends, recvs, shard,
                                                "row_return")):
            dx[:, s0 - lo:s1 - lo] += g
        return dx, None, None, None


class _GatherRows(torch.autograd.Function):
    """apply(y, shard, h): the whole height ``h`` of the tensor whose
    shard ``y`` this process holds (:func:`gather_rows`)."""

    @staticmethod
    def forward(ctx, y, shard, h):
        ctx.shard, ctx.h = shard, h
        owners = split_rows(h, shard.n)
        m = owners[0][1] - owners[0][0]          # the largest shard
        if y.shape[1] < m:
            y = torch.cat([y, y.new_zeros((y.shape[0], m - y.shape[1],
                                           *y.shape[2:]))], dim=1)
        full = all_gather(y, 1, shard.group)
        return torch.cat([full[:, i * m:i * m + hi - lo]
                          for i, (lo, hi) in enumerate(owners)], dim=1)

    @staticmethod
    def backward(ctx, dy):
        lo, hi = ctx.shard.rows(ctx.h)
        return dy[:, lo:hi].contiguous(), None, None


def gather_rows(y, shard, h):
    """The whole height ``h`` of a tensor of which this process holds its
    shard's rows ``y`` (dim 1), gathered over ``shard.group``; the
    backward takes this process's rows of the cotangent. In one process
    (``shard.n`` 1) ``y`` itself."""
    if shard.n == 1:
        return y
    return _GatherRows.apply(y, shard, h)
