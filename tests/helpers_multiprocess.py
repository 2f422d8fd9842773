"""Shared by the tests that run the port in several processes on the CPU
(``tests/test_torch_parallel.py``, ``tests/test_torch_multiprocess.py``,
``tests/test_torch_pipeline.py``, ``tests/test_torch_tensor_parallel.py``):
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
LIMIT_S = START_WAIT_S + TIMEOUT_S   # the longest a run_workers call takes
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


@contextlib.contextmanager
def _launch_slot(io_dir):
    """Held while one launch's workers run. ``io_dir`` is a directory of
    ``tmp_path_factory.mktemp``: the lock file lies in the run's base
    temporary directory, which every xdist worker of the run shares (a
    worker's own, ``popen-gwN``, lies in it), so that the launches of
    the run take turns (four processes at most at once). Then the JAX
    package's workers are waited for. After START_WAIT_S in all, a
    launch that has its turn goes ahead; one that has none fails."""
    base = os.path.dirname(os.path.abspath(io_dir))
    if os.path.basename(base).startswith("popen-"):
        base = os.path.dirname(base)
    lock = os.path.join(base, "torch-workers.lock")
    deadline = time.monotonic() + START_WAIT_S
    with open(lock, "a") as f:
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    pytest.fail(f"no turn to launch in {START_WAIT_S} s")
                time.sleep(1)
        try:
            while _jax_workers_alive() and time.monotonic() < deadline:
                time.sleep(1)
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run_workers(mode, io_dir, nprocs=2):
    """Start ``nprocs`` workers in their turn (:func:`_launch_slot`), wait
    for all of them (TIMEOUT_S in all, from their start; LIMIT_S with
    the wait for the turn), kill every one that is left on any
    failure."""
    with _launch_slot(io_dir):
        _run_workers(mode, io_dir, nprocs)


def _run_workers(mode, io_dir, nprocs):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # every large block mapped apart and unmapped when freed: glibc
    # otherwise raises this threshold as blocks are freed and keeps the
    # freed models' memory in the worker's heap
    env["MALLOC_MMAP_THRESHOLD_"] = str(1 << 20)
    store = os.path.join(io_dir, "store")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(pid), str(nprocs), store,
         io_dir], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(nprocs)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            try:
                log, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"{mode} worker timed out after {TIMEOUT_S} s")
            if p.returncode != 0:
                pytest.fail(f"{mode} worker failed (rc={p.returncode}):\n"
                            f"{log[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def fixture_data():
    """The worker's data (tests/test_multihost.py's, same seed)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        from _torch_multiprocess_worker import fixture_data as data
    finally:
        sys.path.pop(0)
    return data()
