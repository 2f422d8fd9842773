"""Build a CUDA source of this package into a shared library at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at the
root of the checkout (a directory ``.gitignore`` lists), keyed by a hash
of the source, the headers beside it (``csrc/*.cuh``) and the flags, then
loaded with ``ctypes``. Nothing here
runs at import time: the CPU tests import the wrappers without a CUDA
toolkit.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what each build printed (ptxas registers/spills) and took, by source
build_info = {}


def _nvcc():
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels of tf2_yolo_tpu_torch are built at first use")
    return path


def _plan(source, extra_flags):
    flags = (*FLAGS, *extra_flags)
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + "\0".join(flags).encode()
    ).hexdigest()[:16]
    return src, flags, BUILD_DIR / f"{src.stem}-{digest}.so"


def build_libraries(specs):
    """Build every ``(source, extra_flags)`` of ``specs`` that has no
    library of the same source and flags yet, one ``nvcc`` process each,
    all started together. Raises on a failed build."""
    plans = [(source, *_plan(source, flags)) for source, flags in specs]
    plans = [p for p in plans if not p[3].exists()]
    if not plans:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for source, src, flags, out in plans:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        procs.append((source, src, tmp, out, proc, time.perf_counter()))
    failed = []
    for source, src, tmp, out, proc, t0 in procs:
        _, log = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{log}")
            continue
        os.replace(tmp, out)
        build_info[source] = {"seconds": time.perf_counter() - t0,
                              "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source, extra_flags=()):
    """Return the ``ctypes.CDLL`` of ``csrc/<source>``, building it first
    if no library of the same source and flags exists. Each wrapper
    loads its library once (``functools.cache`` on its launcher)."""
    build_libraries([(source, extra_flags)])
    return ctypes.CDLL(str(_plan(source, extra_flags)[2]))
