"""The ``("data", "model")`` process grid and the tensor-parallel plan.

Port of tf2_yolo_tpu/parallel/mesh.py. A JAX mesh lays devices out along
named axes and GSPMD derives the collectives from it; here one process
drives one card, so a mesh is a grid of processes with one
``torch.distributed`` subgroup per row and per column, and the port's
layers issue the collectives themselves (``models.layers``,
``parallel.train``):

- the data axis: the processes of a column hold different rows of the
  batch; their BatchNorm sums and gradients are reduced over the column
  (``Mesh.data_group``);
- the model axis: the processes of a row hold the same rows and each
  holds a slice of the output channels of the wide convs
  (:func:`tensor_parallel_shardings`); the sliced activations are
  gathered over the row (``Mesh.model_group``).

Rank r sits at data index ``r // n_model`` and model index ``r %
n_model``, the row-major layout of the JAX mesh over its device list.
Spatial partitioning (:func:`make_mesh_spatial`,
:func:`spatial_sharding`) is not ported and raises NotImplementedError.
"""

from dataclasses import dataclass
from typing import Optional, Sequence

import torch.distributed as dist

from .multihost import process_count, process_index

_NOT_PORTED = ("spatial partitioning is not ported yet (ROADMAP.md, "
               "queue 1, item 9: parallel)")

# make_mesh's meshes of the live process group: creating a subgroup is
# collective, so a repeated call returns the mesh made before
_MESHES = {"world": None, "meshes": {}}


@dataclass(frozen=True)
class Mesh:
    """A ``("data", "model")`` grid of processes.

    ``shape`` maps each axis to its size; ``ranks`` are the grid's
    processes, row-major (data index, model index); ``group`` spans them
    all (None in a single process without a process group). For the
    process that calls :func:`make_mesh`: ``data_index`` and
    ``model_index`` its place (None outside the grid), ``data_group`` its
    column (the processes with its model index; the whole grid's group
    when the model axis is 1) and ``model_group`` its row (those with
    its data index); otherwise an axis of size 1 has no group (None)."""
    shape: dict
    ranks: tuple
    group: object = None
    data_group: object = None
    model_group: object = None
    data_index: Optional[int] = 0
    model_index: Optional[int] = 0
    axis_names: tuple = ("data", "model")

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def data_ranks(self) -> tuple:
        """The ranks of this process's column (data indices 0, 1, ...)."""
        m = self.shape["model"]
        return self.ranks[self.model_index::m]

    def __contains__(self, rank) -> bool:
        return rank in self.ranks


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The ``("data", "model")`` grid over ``ranks`` (default: every
    process of the process group).

    Args:
        n_data: size of the data axis; default ``len(ranks) / n_model``.
            ``n_data * n_model`` must be ``len(ranks)``: a smaller grid
            would leave the other processes' rows out of the batch.
        n_model: size of the model axis (tensor parallelism).
        ranks: the processes of the grid, e.g. one stage's under PP x
            DP (``PipelineExecutor(meshes=)``); disjoint meshes may share
            the process group.

    Collective: every process of the group calls it with the same
    arguments in the same order (subgroups are created in a fixed order,
    the whole grid's, then each row's, then each column's); a repeated
    call returns the same mesh and creates nothing."""
    n_model = int(n_model)
    world = process_count()
    ranks = tuple(range(world)) if ranks is None else tuple(
        int(r) for r in ranks)
    if n_model < 1 or len(ranks) % n_model:
        raise ValueError(f"n_model={n_model} must divide the {len(ranks)} "
                         "processes of the mesh")
    n = len(ranks) // n_model if n_data is None else int(n_data)
    if n * n_model != len(ranks):
        raise ValueError(f"the data axis spans every process: n_data {n} "
                         f"x n_model {n_model} for {len(ranks)} processes")
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world
                                                for r in ranks):
        raise ValueError(f"ranks {ranks}: distinct ranks of the {world} "
                         "processes")
    shape = {"data": n, "model": n_model}
    if not dist.is_initialized():
        return Mesh(shape=shape, ranks=ranks)
    if _MESHES["world"] is not dist.group.WORLD:
        _MESHES.update(world=dist.group.WORLD, meshes={})
    key = (n, n_model, ranks)
    if key not in _MESHES["meshes"]:
        _MESHES["meshes"][key] = _grid(shape, ranks)
    return _MESHES["meshes"][key]


def _grid(shape, ranks):
    """The mesh's subgroups, every one created by every process."""
    n, m = shape["data"], shape["model"]
    whole = (dist.group.WORLD if ranks == tuple(range(process_count()))
             else dist.new_group(list(ranks)))
    rows = [dist.new_group(list(ranks[i * m:(i + 1) * m])) if m > 1
            else None for i in range(n)]
    cols = [whole if m == 1 else
            dist.new_group(list(ranks[j::m])) if n > 1 else None
            for j in range(m)]
    me = process_index()
    if me not in ranks:
        return Mesh(shape=shape, ranks=ranks, group=None, data_index=None,
                    model_index=None)
    pos = ranks.index(me)
    i, j = divmod(pos, m)
    return Mesh(shape=shape, ranks=ranks, group=whole, data_group=cols[j],
                model_group=rows[i], data_index=i, model_index=j)


def best_data_axis(batch_size: int, max_devices: Optional[int] = None
                   ) -> int:
    """Largest device count <= max_devices (default: the number of
    processes) that divides batch_size (equal shards)."""
    n = max_devices if max_devices is not None else process_count()
    for k in range(min(n, batch_size), 0, -1):
        if batch_size % k == 0:
            return k
    return 1


def tensor_parallel_shardings(model, mesh: Mesh, min_channels: int = 128,
                              axis: str = "model"):
    """Megatron-style channel sharding of a conv net, as
    ``{state_dict name: shard dim or None}`` over ``model`` (an
    ``nn.Module`` or a ``state_dict``), by the JAX package's rule, leaf
    by leaf:

    - kernels of two or more dims (convs, HWIO; dense, (Ci, Co)) whose
      last dim (Cout) is ``>= min_channels`` and divides by the
      ``axis`` size: sharded on that dim;
    - 1-D per-channel vectors (conv bias, BN scale and bias, the running
      statistics) under the same size rule: sharded on dim 0;
    - everything else (small kernels, heads below the gate, anchors):
      replicated (None).

    The port's layouts are flax's (HWIO kernels, ``bridge``), so the
    dims are the JAX package's. ``models.layers.set_tensor_parallel``
    applies a plan to a model."""
    n = mesh.shape[axis]
    sd = model.state_dict() if hasattr(model, "state_dict") else model

    def rule(shape):
        if len(shape) >= 1 and shape[-1] >= min_channels \
                and shape[-1] % n == 0:
            return len(shape) - 1
        return None

    return {name: rule(tuple(t.shape)) for name, t in sd.items()}


def make_mesh_spatial(*args, **kwargs):
    raise NotImplementedError(f"make_mesh_spatial: {_NOT_PORTED}")


def spatial_sharding(*args, **kwargs):
    raise NotImplementedError(f"spatial_sharding: {_NOT_PORTED}")
