"""Multi-process runtime: one process per card, joined in one
``torch.distributed`` process group.

Port of tf2_yolo_tpu/parallel/multihost.py. JAX joins the processes of a
slice into one global device mesh, and one GSPMD program spans it; here
each process drives its own card and the processes meet in collectives
(the BatchNorm sums and the gradients, see ``models.layers.set_bn_group``
and ``parallel.train.make_train_step``). Call
:func:`distributed_initialize` first thing in every process, then build
the model and call ``Model.compile`` and ``Model.fit`` as in one process,
each process with its own shard of the data
(``parallel.input.process_batch_slice``).

The rendezvous is a store: a ``FileStore`` on a path every process sees
(``store="/shared/dir/rendezvous"``), a ``HashStore`` in a single
process, or a TCP store at ``coordinator_address`` ("host:port" of
process 0). The first two need no socket. Every wait (the rendezvous,
each barrier) gives up after ``timeout_s`` seconds rather than hang.
"""

import datetime
from typing import Optional

import torch
import torch.distributed as dist

# the device and timeout of the group this process initialized
_STATE = {"device": None, "timeout_s": None}


def distributed_initialize(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           device=None, timeout_s: float = 60.0,
                           store=None) -> torch.device:
    """Join this process to the default process group; return its
    device.

    Args:
        coordinator_address: "host:port" (or "tcp://host:port") of
            process 0's TCP store; leave None with ``store``.
        num_processes: the world size (default 1).
        process_id: this process's rank in [0, num_processes) (default
            0).
        backend: "gloo" or "nccl"; default "gloo" for a CPU ``device``
            and "nccl" for a CUDA one. Gloo also reduces CUDA tensors
            (through the host), so several processes can share one card.
        device: this process's device; default ``cuda:<rank mod the
            number of cards>``, the card unless the caller asks for the
            CPU.
        timeout_s: seconds before the rendezvous or a collective gives
            up (at most 60 by default; a hung peer raises instead).
        store: a ``torch.distributed.Store``, or the path of a
            ``FileStore`` shared by all processes. With none and no
            address, a single process uses a ``HashStore``.
    """
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized; "
                           "call distributed_shutdown() first")
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside [0, {world})")
    if device is None:
        device = f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
    device = torch.device(device)
    if backend is None:
        backend = "gloo" if device.type == "cpu" else "nccl"
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                         f"{backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    timeout = datetime.timedelta(seconds=float(timeout_s))
    if isinstance(store, str):
        store = dist.FileStore(store, world)
    elif store is None and coordinator_address is None:
        if world != 1:
            raise ValueError(f"{world} processes need a store or a "
                             "coordinator_address to meet at")
        store = dist.HashStore()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = dict(backend=backend, world_size=world, rank=rank,
              timeout=timeout)
    if store is not None:
        dist.init_process_group(store=store, **kw)
    else:
        address = coordinator_address
        if not address.startswith("tcp://"):
            address = "tcp://" + address
        dist.init_process_group(init_method=address, **kw)
    _STATE.update(device=device, timeout_s=timeout_s)
    return device


def distributed_shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, timeout_s=None)


def is_multiprocess() -> bool:
    """True when a process group of more than one process is up."""
    return process_count() > 1


def process_count() -> int:
    """The world size; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def default_group():
    """The default process group, or None without one."""
    return dist.group.WORLD if dist.is_initialized() else None


def process_device() -> Optional[torch.device]:
    """The device given at :func:`distributed_initialize` (None without
    a process group)."""
    return _STATE["device"]


def host_device() -> torch.device:
    """Where the group reduces host values (row counts, logs): the CPU
    under gloo, this process's card under nccl."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Wait for every process, at most ``timeout_s`` of
    :func:`distributed_initialize` (60 s for a group made elsewhere);
    under gloo, ``monitored_barrier`` names the rank that did not
    come."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=datetime.timedelta(
            seconds=float(_STATE["timeout_s"] or 60.0)))
    else:
        dist.barrier(device_ids=[torch.cuda.current_device()])
