"""Host->device feeding utilities.

Port of tf2_yolo_tpu/data/pipeline.py. ``threaded_prefetch`` runs a host
iterator on a background thread, as there. ``prefetch_to_device`` keeps
``size`` batches in flight to the card: each array is copied into pinned
host memory and sent with a ``non_blocking`` copy on a side stream; the
consumer's stream waits on the copy's event before it reads the batch,
and every tensor is ``record_stream``'d on the consumer's stream so that
its memory is not reused while that stream may still read it.
"""

import collections
import queue
import threading

import numpy as np
import torch


def _tree_map(fn, batch):
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_map(fn, b) for b in batch)
    return fn(batch)


def _leaves(batch):
    if isinstance(batch, (list, tuple)):
        for b in batch:
            yield from _leaves(b)
    else:
        yield batch


def to_device(arr, device):
    """One numpy array (or tensor) as a tensor on ``device``. A copy to
    the card goes through pinned memory and is always non-blocking: the
    host does not wait for the stream's earlier work."""
    t = torch.as_tensor(np.asarray(arr)) if not torch.is_tensor(arr) \
        else arr
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def prefetch_to_device(iterator, size=2, device="cuda"):
    """Yield batches (arrays or nested lists/tuples of arrays) as tensors
    on ``device``, keeping ``size`` batches in flight ahead of the
    consumer. On the CPU this is a plain conversion."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield _tree_map(lambda a: to_device(a, device), batch)
        return

    stream = torch.cuda.Stream(device)
    buf = collections.deque()

    def put(batch):
        with torch.cuda.stream(stream):
            moved = _tree_map(lambda a: to_device(a, device), batch)
            done = torch.cuda.Event()
            done.record(stream)
        return moved, done

    def take(item):
        moved, done = item
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in _leaves(moved):
            t.record_stream(current)
        return moved

    for batch in iterator:
        buf.append(put(batch))
        if len(buf) > size:
            yield take(buf.popleft())
    while buf:
        yield take(buf.popleft())


def threaded_prefetch(make_iterator, size=2):
    """Run a host iterator in a background thread with a bounded
    queue (host-side overlap; compose with prefetch_to_device for the
    transfer overlap).

    Cancellation-safe: if the consumer abandons the generator
    mid-epoch (exception in the train step, early break), the producer
    notices via a stop event instead of blocking forever on the full
    queue. Producer exceptions re-raise in the consumer.
    """
    q = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()

    def producer():
        try:
            for item in make_iterator():
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(sentinel)
        except BaseException as exc:      # surface in the consumer
            q.put(exc)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
