"""The collectives of tensor parallelism, and a log of what the port
issues.

GSPMD derives the collectives of a channel-sharded conv net from the
shardings (tf2_yolo_tpu/parallel/mesh.py, ``tensor_parallel_shardings``);
here they are written out, Megatron-style, around each sharded layer
(``models.layers``: ``ConvBN``, ``Conv``, a keras conv + BatchNorm pair,
``DepthwiseConv``, ``ConvActBN``, ``Dense``):

- :func:`copy_to_model` (Megatron's f): the identity forward; in the
  backward the input's cotangent, which each process computed from its
  slice of the output channels only, is summed over the model group;
- :func:`gather_channels` (g): the layer's slice of the channels (the
  last axis of an NHWC tensor) gathered over the model group, so that
  every consumer sees the full tensor; its backward takes this process's
  slice of the cotangent;
- :func:`slice_channels`: this process's slice of the channels of a
  full input (a depthwise conv's or a lone BatchNorm's, whose slices
  read only their own channels); its backward puts the slice's
  cotangent back in place and sums over the model group.

:func:`gather_state_dict` and :func:`slice_state_dict` move a sharded
model's variables to and from the full, unsharded tree (checkpoints,
``Model.variables``).

:func:`recording` logs each collective that the layers and the train
step issue (``kind``, the group, the tensor's dim where it has one, its
element count), as ``chip_smoke.py`` counts kernel launches; the tests
pin the structure of a step's communication with it.
"""

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

_LOG = {"records": None}


@dataclass(frozen=True)
class Collective:
    """One collective: ``kind`` "all_gather" or "all_reduce", its
    ``group``, the ``dim`` gathered (None for a reduce) and the
    ``numel`` of the full result; or one message of a spatial row
    exchange (``parallel.spatial``), "row_fetch" or "row_return", as its
    receiver got it: ``dim`` 1, its ``numel`` and its ``rows``."""
    kind: str
    group: object
    dim: object
    numel: int
    rows: object = None


@contextlib.contextmanager
def recording():
    """Inside the block, every collective of the layers and the train
    step is appended to the yielded list (:class:`Collective`)."""
    records, prev = [], _LOG["records"]
    _LOG["records"] = records
    try:
        yield records
    finally:
        _LOG["records"] = prev


def record(kind, group, dim, numel, rows=None):
    if _LOG["records"] is not None:
        _LOG["records"].append(Collective(kind, group, dim, int(numel),
                                          rows))


def all_reduce_(t, group):
    """In-place sum of ``t`` over ``group``, logged."""
    record("all_reduce", group, None, t.numel())
    dist.all_reduce(t, group=group)
    return t


def all_gather(t, dim, group):
    """``t`` of every process of ``group`` concatenated on ``dim`` in the
    group's rank order (not differentiable), logged."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    record("all_gather", group, dim % t.dim(), t.numel() * n)
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


@dataclass(frozen=True)
class Shard:
    """A layer's place on the model axis: its ``group``, the axis size
    ``n`` and this process's ``index`` on it."""
    group: object
    n: int
    index: int

    def slice(self, t, dim):
        """This process's slice of the full ``t`` on ``dim`` (a view)."""
        width = t.shape[dim] // self.n
        return t.narrow(dim, self.index * width, width)

    def gather(self, t, dim):
        """The full tensor of every process's slice ``t`` on ``dim``."""
        return all_gather(t, dim, self.group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, dx):
        return all_reduce_(dx.contiguous().clone(), ctx.group), None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, shard):
        ctx.shard = shard
        return shard.gather(y, -1)

    @staticmethod
    def backward(ctx, dy):
        return ctx.shard.slice(dy, -1).contiguous(), None


class _SliceChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.shape = shard, x.shape
        return shard.slice(x, -1).contiguous()

    @staticmethod
    def backward(ctx, dy):
        dx = dy.new_zeros(ctx.shape)
        ctx.shard.slice(dx, -1).copy_(dy)
        return all_reduce_(dx, ctx.shard.group), None


def slice_channels(x, shard):
    """This process's channel slice of the full ``x`` (see the module
    docstring)."""
    return _SliceChannels.apply(x, shard)


def copy_to_model(x, shard):
    """Megatron's f over ``shard.group`` (see the module docstring)."""
    return _CopyToModel.apply(x, shard.group)


def gather_channels(y, shard):
    """Megatron's g over ``shard.group`` (see the module docstring)."""
    return _GatherChannels.apply(y, shard)


def sharded_dims(model):
    """``{state_dict name: dim}`` of the entries of ``model`` that
    ``layers.set_tensor_parallel`` sliced ({} for an unsharded model)."""
    tp = getattr(model, "tensor_parallel", None)
    return {} if tp is None else tp[1]


def gather_state_dict(model, state=None):
    """The full, unsharded ``state_dict`` of a sharded ``model`` (its own
    ``state_dict()`` when unsharded): each sliced entry gathered over the
    model group. ``state`` (default ``model.state_dict()``) may be a
    detached copy with the same keys. Collective over the model group."""
    state = model.state_dict() if state is None else state
    tp = getattr(model, "tensor_parallel", None)
    if tp is None:
        return state
    shard, dims = tp
    return {k: (shard.gather(v, dims[k]) if k in dims else v)
            for k, v in state.items()}


def slice_state_dict(model, state):
    """This process's slice of each entry of the full ``state`` that
    ``model`` holds sliced: what ``model.load_state_dict`` takes."""
    tp = getattr(model, "tensor_parallel", None)
    if tp is None:
        return state
    shard, dims = tp
    return {k: (shard.slice(v, dims[k]).contiguous() if k in dims else v)
            for k, v in state.items()}
