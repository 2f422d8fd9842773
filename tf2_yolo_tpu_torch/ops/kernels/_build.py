"""Build a CUDA source of this package into a shared library at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at the
root of the checkout (a directory ``.gitignore`` lists), keyed by a hash
of the source and the flags, then loaded with ``ctypes``. Nothing here
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


def load_library(source, extra_flags=()):
    """Return the ``ctypes.CDLL`` of ``csrc/<source>``, building it first
    if no library of the same source and flags exists. Raises on a
    failed build. Each wrapper loads its library once
    (``functools.cache`` on its launcher)."""
    flags = (*FLAGS, *extra_flags)
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + "\0".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)
        build_info[source] = {"seconds": time.perf_counter() - t0,
                              "log": proc.stderr}
    return ctypes.CDLL(str(out))
