"""The data axis over the process group.

Port of the data-parallel part of tf2_yolo_tpu/parallel/mesh.py. A JAX
mesh lays devices out along named axes and GSPMD derives the collectives
from it; here one process drives one card, so the ``("data", "model")``
mesh is a description of the process group: its data axis is the
processes, its model axis 1. Tensor parallelism and spatial partitioning
(``n_model > 1``, :func:`tensor_parallel_shardings`,
:func:`make_mesh_spatial`, :func:`spatial_sharding`) are not ported and
raise NotImplementedError.
"""

from dataclasses import dataclass
from typing import Optional

from .multihost import default_group, process_count

_NOT_PORTED = ("tensor parallelism and spatial partitioning are not ported "
               "yet (ROADMAP.md, queue 1, item 9: parallel)")


@dataclass(frozen=True)
class Mesh:
    """A ``("data", "model")`` mesh over the processes of the process
    group: ``shape`` maps each axis name to its size, ``ranks`` are the
    processes along the data axis, ``group`` the process group (None in
    a single process without one)."""
    shape: dict
    ranks: tuple
    group: object = None
    axis_names: tuple = ("data", "model")

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The ``("data", "model")`` mesh of the process group.

    Args:
        n_data: size of the data axis: the number of processes, its
            default (one card each); a smaller axis would leave the other
            processes' rows out of the global batch and raises.
        n_model: 1; tensor parallelism is not ported.
    """
    if int(n_model) != 1:
        raise NotImplementedError(f"n_model={n_model}: {_NOT_PORTED}")
    world = process_count()
    n = world if n_data is None else int(n_data)
    if n != world:
        raise ValueError(f"the data axis spans every process: n_data "
                         f"{n} for {world} processes")
    return Mesh(shape={"data": n, "model": 1}, ranks=tuple(range(n)),
                group=default_group())


def best_data_axis(batch_size: int, max_devices: Optional[int] = None
                   ) -> int:
    """Largest device count <= max_devices (default: the number of
    processes) that divides batch_size (equal shards)."""
    n = max_devices if max_devices is not None else process_count()
    for k in range(min(n, batch_size), 0, -1):
        if batch_size % k == 0:
            return k
    return 1


def tensor_parallel_shardings(*args, **kwargs):
    raise NotImplementedError(f"tensor_parallel_shardings: {_NOT_PORTED}")


def make_mesh_spatial(*args, **kwargs):
    raise NotImplementedError(f"make_mesh_spatial: {_NOT_PORTED}")


def spatial_sharding(*args, **kwargs):
    raise NotImplementedError(f"spatial_sharding: {_NOT_PORTED}")
