"""Shared by the tests that run the port in several processes on the CPU
(``tests/test_torch_parallel.py``, ``tests/test_torch_multiprocess.py``,
``tests/test_torch_pipeline.py``, ``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_spatial.py``):
starting the workers of ``tests/_torch_multiprocess_worker.py`` under a
time limit, one launch at a time in a test run and never beside
``tests/test_multihost.py``'s workers, and the fixture data they share."""

import contextlib
import fcntl
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_multiprocess_worker.py")
TIMEOUT_S = 180          # for all the workers of one run together
START_WAIT_S = 900       # the longest wait for a launch's turn
MAX_YIELDS = 2           # launches killed to let the JAX workers through
# the longest a run_workers call takes: its turn, yields and runs together
LIMIT_S = START_WAIT_S + TIMEOUT_S
JAX_WORKER = os.path.join(REPO, "tests", "_multihost_worker.py")


def _jax_workers_alive():
    """Whether a worker of ``tests/test_multihost.py`` runs: its two
    processes must reach each gloo handshake within 30 s of each other,
    which a launch of more processes beside them has broken."""
    target = JAX_WORKER.encode()
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if target in f.read().split(b"\0"):
                    return True
        except OSError:          # the process ended meanwhile
            continue
    return False


def _wait_for_jax_workers(until):
    while _jax_workers_alive() and time.monotonic() < until:
        time.sleep(1)


@contextlib.contextmanager
def _launch_slot(io_dir, until):
    """Held while one launch's workers run. ``io_dir`` is a directory of
    ``tmp_path_factory.mktemp``: the lock file lies in the run's base
    temporary directory, which every xdist worker of the run shares (a
    worker's own, ``popen-gwN``, lies in it), so that the launches of
    the run take turns (four processes at most at once). Then the JAX
    package's workers are waited for. At ``until`` (a ``time.monotonic``
    time), a launch that has its turn goes ahead; one that has none
    fails."""
    base = os.path.dirname(os.path.abspath(io_dir))
    if os.path.basename(base).startswith("popen-"):
        base = os.path.dirname(base)
    lock = os.path.join(base, "torch-workers.lock")
    with open(lock, "a") as f:
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > until:
                    pytest.fail(f"no turn to launch in {START_WAIT_S} s")
                time.sleep(1)
        try:
            _wait_for_jax_workers(until)
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run_workers(mode, io_dir, nprocs=2):
    """Start ``nprocs`` workers in their turn (:func:`_launch_slot`), wait
    for all of them (TIMEOUT_S in all, from their start), kill every one
    that is left on any failure. Should ``tests/test_multihost.py``'s
    JAX workers start while they run, they are killed, those workers
    waited for, and the launch started again (at most MAX_YIELDS times):
    the JAX workers' gloo handshakes allow 30 s between their two
    processes, which the CPU and memory of a launch beside them have
    broken. One deadline, LIMIT_S from the call, holds the turn, the
    yields and the runs together: the waits for a turn and for the JAX
    workers end TIMEOUT_S before it, and a run ends at it."""
    deadline = time.monotonic() + LIMIT_S
    with _launch_slot(io_dir, deadline - TIMEOUT_S):
        for attempt in range(MAX_YIELDS + 1):
            if _run_workers(mode, io_dir, nprocs, deadline,
                            may_yield=attempt < MAX_YIELDS):
                return
            _wait_for_jax_workers(deadline - TIMEOUT_S)


def _run_workers(mode, io_dir, nprocs, until, may_yield):
    """One launch of at most TIMEOUT_S, ending at ``until`` at the
    latest; False if it was killed to yield to the JAX workers
    (``may_yield``), True once every worker ended well."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # every large block mapped apart and unmapped when freed: glibc
    # otherwise raises this threshold as blocks are freed and keeps the
    # freed models' memory in the worker's heap
    env["MALLOC_MMAP_THRESHOLD_"] = str(1 << 20)
    store = os.path.join(io_dir, "store")
    if os.path.exists(store):        # a killed launch's rendezvous
        os.remove(store)
    logs = [open(os.path.join(io_dir, f"{mode}_{pid}.log"), "w+")
            for pid in range(nprocs)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(pid), str(nprocs), store,
         io_dir], env=env, cwd=REPO, stdout=log,
        stderr=subprocess.STDOUT, text=True)
        for pid, log in zip(range(nprocs), logs)]
    start = time.monotonic()
    deadline = min(start + TIMEOUT_S, until)
    try:
        while any(p.poll() is None for p in procs):
            if may_yield and _jax_workers_alive():
                return False
            if time.monotonic() > deadline:
                pytest.fail(f"{mode} worker timed out after "
                            f"{deadline - start:.0f} s")
            time.sleep(0.5)
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                log.seek(0)
                pytest.fail(f"{mode} worker failed (rc={p.returncode}):\n"
                            f"{log.read()[-4000:]}")
        return True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()


def fixture_data():
    """The worker's data (tests/test_multihost.py's, same seed)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        from _torch_multiprocess_worker import fixture_data as data
    finally:
        sys.path.pop(0)
    return data()
