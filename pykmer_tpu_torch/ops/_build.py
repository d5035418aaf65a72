"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (Hopper) into one shared
library with a plain C interface, under ``build/kernels/`` at the root of the
checkout. The file name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree loads the cached library. Only the kernel
wrappers import this module, and only when a CUDA tensor reaches them, so the
package imports and its CPU tests run without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# nvcc's output of the build that produced the loaded library (ptxas
# register / shared-memory report), or a note that a cached one was loaded
BUILD_LOG = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME); the CUDA "
            "toolkit is needed to build pykmer_tpu_torch/csrc"
        )
    return path


def _sources():
    srcs = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def _digest(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> None:
    for name in ("pykmer_sweep_sorted_i32", "pykmer_sweep_sorted_i64"):
        fn = getattr(lib, name)
        # pointers and the stream as c_void_p, sizes as int64: the ctypes
        # default (C int) would cut both to 32 bits
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """The kernels' library, built first if the sources changed."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = _sources()
        so = os.path.join(BUILD_DIR, f"libpykmer_kernels_{_digest(srcs)}.so")
        if os.path.exists(so):
            BUILD_LOG = f"loaded cached {so}"
        else:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                capture_output=True, text=True,
            )
            BUILD_LOG = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
            os.replace(tmp, so)  # atomic: a concurrent builder sees all or none
        lib = ctypes.CDLL(so)
        _bind(lib)
        _LIB = lib
        return lib
