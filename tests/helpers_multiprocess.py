"""Shared by the tests that run the port in several processes on the CPU
(``tests/test_torch_parallel.py``, ``tests/test_torch_multiprocess.py``):
starting the workers of ``tests/_torch_multiprocess_worker.py`` under a
time limit, and the fixture data they share."""

import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_multiprocess_worker.py")
TIMEOUT_S = 180          # for all the workers of one run together


def run_workers(mode, io_dir, nprocs=2):
    """Start ``nprocs`` workers, wait for all of them (TIMEOUT_S in
    all), kill every one that is left on any failure."""
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
