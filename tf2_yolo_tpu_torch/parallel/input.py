"""Host-to-device input placement, single- and multi-process.

Port of tf2_yolo_tpu/parallel/input.py. Every process loads a disjoint
slice of the global batch (:func:`process_batch_slice`, or
``YoloDataSequence.shard``) and :func:`put_global_batch` moves those
rows to its own card. No process holds the global batch: the optimizer
sees it through the collectives of the step (the BatchNorm sums summed
over the processes, the gradients averaged; ``parallel.train``), which
is what JAX's ``make_array_from_process_local_data`` gives the one GSPMD
program. In a single process both are the whole batch on the device.
Under tensor parallelism the processes of one model group load the same
rows (``process_batch_slice(n, mesh)``).
"""

from typing import Any

import numpy as np
import torch

from .multihost import process_count, process_device, process_index


def put_global_batch(batch: Any, device=None):
    """This process's rows of the global batch on ``device``.

    Args:
        batch: an array or tensor, or a tuple / list / dict of them: in
            a multi-process run this process's OWN rows (``global rows /
            process_count`` of them, see :func:`process_batch_slice`); in
            one process the whole batch.
        device: default the device of ``distributed_initialize``, else
            the card.

    Returns:
        the same structure of tensors on ``device`` (uint8 stays uint8,
        other arrays become f32).
    """
    if device is None:
        device = process_device() or "cuda"

    def put(a):
        if isinstance(a, dict):
            return {k: put(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(put(v) for v in a)
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        if t.dtype != torch.uint8:
            t = t.float()
        return t.to(device)

    return put(batch)


def process_batch_slice(global_batch_size: int, mesh=None) -> slice:
    """The slice of the global batch this process should load.

    Even split by the process's place on the data axis; requires the
    global batch to divide by the axis (every process takes as many
    rows). Without ``mesh`` the data axis is every process, by rank;
    with a ``parallel.mesh.Mesh`` it is the mesh's, by data index, so
    that the processes of one model group (tensor parallelism) read the
    same rows, as the JAX engine binds one global batch over the
    ``("data", "model")`` mesh."""
    if mesh is None:
        n, i = process_count(), process_index()
    else:
        n, i = mesh.shape["data"], mesh.data_index
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} must divide by the "
            f"process count {n}")
    per = global_batch_size // n
    return slice(i * per, (i + 1) * per)
