"""Training-state checkpoints: parameters, optimizer chain, step and the
fit position.

Port of tf2_yolo_tpu/parallel/checkpoint.py with ``torch.save`` in place
of Orbax. A checkpoint is the directory ``path/step_N`` holding
``state.pt``: the model's ``state_dict`` (parameters and BatchNorm
statistics), the optimizer chain's ``state_dict`` (moments, counters,
learning-rate multiplier), the step, and the fit position (the epoch to
run next and the batches of it already trained). It is written into a
temporary directory and renamed into place, so a listed ``step_N`` is
complete. ``block=False`` snapshots the state to host memory at once (the
next step may then change it) and writes on a background thread, one
write in flight at a time; :func:`wait_for_saves` fences it. Plain
weight files are ``Model.save_weights``.

Multi-process runs (``parallel.distributed_initialize``): the state is
the same in every process (data parallelism), so :func:`save_checkpoint`
is collective: process 0 writes and prunes, then every process waits at
a barrier, so that none lists or reads the directory before the write
and the pruning are done; ``block=False`` blocks there. Every process
restores from the same file. The directory must be one that every
process sees. Under tensor parallelism (``Model.compile(n_model > 1)``)
process 0 holds a slice of the wide layers: every process first gathers
each sliced entry of the model and of the optimizer's moments over its
model group, so a checkpoint is always the unsharded tree, and
:func:`restore_checkpoint` into a sliced model takes this process's
slice (``collectives.slice_state_dict``).
"""

import os
import re
import shutil
import tempfile
import threading
from typing import Optional

import torch

from .collectives import (Shard, gather_state_dict, sharded_dims,
                          slice_state_dict)
from .multihost import barrier, process_count, process_index

_STEP_DIR = re.compile(r"^step_(\d+)$")
_FILE = "state.pt"

# the one background write in flight in this process, and its error
_pending = {"thread": None, "error": None}


def wait_for_saves() -> None:
    """Block until the in-flight background write has committed; raise
    its error, if it had one."""
    thread = _pending["thread"]
    if thread is not None:
        thread.join()
        _pending["thread"] = None
    err, _pending["error"] = _pending["error"], None
    if err is not None:
        raise err


def _host_copy(obj):
    """A deep copy of a state_dict tree with every tensor on the host
    (a clone for CPU tensors: the next step updates them in place)."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _step_dirs(path: str):
    """Committed step_N entries, sorted by N (a write in flight lives in
    a temporary directory that does not match)."""
    out = []
    for e in os.listdir(path):
        m = _STEP_DIR.match(e)
        if m:
            out.append((int(m.group(1)), e))
    return [e for _, e in sorted(out)]


def _prune(path: str, keep: int) -> None:
    # keep < 1 would keep everything; the latest checkpoint always stays
    keep = max(int(keep), 1)
    for stale in _step_dirs(path)[:-keep]:
        shutil.rmtree(os.path.join(path, stale))


def _write(path, ckpt_dir, tree, keep):
    os.makedirs(path, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(ckpt_dir) + ".tmp-",
                           dir=path)
    try:
        torch.save(tree, os.path.join(tmp, _FILE))
        if os.path.isdir(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        os.rename(tmp, ckpt_dir)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
    _prune(path, keep)


def save_checkpoint(path: str, state, keep: int = 3, block: bool = True,
                    position=(0, 0)) -> str:
    """Save a TrainState under ``path/step_N``; return the directory.

    ``position`` is the fit position (epoch to run next, batches of it
    already trained). ``block=False``: snapshot now, write in the
    background (call :func:`wait_for_saves`, or save or restore again,
    to fence). Collective in a multi-process run: every process calls
    it, process 0 writes, all wait for the write (``block`` is
    ignored)."""
    path = os.path.abspath(path)
    ckpt_dir = os.path.join(path, f"step_{int(state.step)}")
    # one write in flight: fence the previous before pruning or saving
    wait_for_saves()
    multi = process_count() > 1
    # collective under tensor parallelism: every process gathers
    model_tree = gather_state_dict(state.model)
    opt_tree = _optimizer_tree(state, Shard.gather)
    if multi and process_index() != 0:
        barrier()
        return ckpt_dir
    tree = {"model": model_tree, "optimizer": opt_tree,
            "step": int(state.step),
            "position": tuple(int(p) for p in position)}
    if multi:
        try:
            _write(path, ckpt_dir, tree, keep)
        finally:                 # the others wait here, written or not
            barrier()
        return ckpt_dir
    if block:
        _write(path, ckpt_dir, tree, keep)
        return ckpt_dir
    tree = _host_copy(tree)      # the next step updates the live tensors

    def work():
        try:
            _write(path, ckpt_dir, tree, keep)
        except Exception as exc:           # raised by wait_for_saves
            _pending["error"] = exc

    thread = threading.Thread(target=work, name="tf2yolo-torch-ckpt",
                              daemon=True)
    _pending["thread"] = thread
    thread.start()
    return ckpt_dir


def _slice(shard, t, dim):
    return shard.slice(t, dim).contiguous()


def _optimizer_tree(state, fn, tree=None):
    """The optimizer's ``state_dict`` (``tree``, default the live one)
    with ``fn(shard, moment, dim)`` applied to each moment of a sliced
    parameter (``collectives.sharded_dims``): the moments have their
    parameter's shape. The tree as it is for an unsliced model."""
    tree = state.optimizer.state_dict() if tree is None else tree
    dims = sharded_dims(state.model)
    if not dims:
        return tree
    shard = state.model.tensor_parallel[0]
    names = {id(p): n for n, p in state.model.named_parameters()}
    order = [names[id(p)] for p in state.optimizer.param_groups[0]["params"]]
    moments = {}
    for idx, entry in tree["state"].items():
        dim = dims.get(order[idx])
        moments[idx] = entry if dim is None else {
            k: (fn(shard, v, dim) if torch.is_tensor(v) and v.dim() > 0
                else v) for k, v in entry.items()}
    return {**tree, "state": moments}


def latest_checkpoint(path: str) -> Optional[str]:
    wait_for_saves()
    if not os.path.isdir(path):
        return None
    entries = _step_dirs(path)
    return os.path.join(path, entries[-1]) if entries else None


def restore_checkpoint(ckpt_dir: str, state):
    """Load a checkpoint into ``state`` (its model and optimizer, in
    place, on their devices); return ``(state, position)``."""
    wait_for_saves()
    tree = torch.load(os.path.join(ckpt_dir, _FILE), map_location="cpu",
                      weights_only=True)
    state.model.load_state_dict(slice_state_dict(state.model,
                                                 tree["model"]))
    state.optimizer.load_state_dict(
        _optimizer_tree(state, _slice, tree["optimizer"]))
    state.step = int(tree["step"])
    return state, tuple(tree["position"])
