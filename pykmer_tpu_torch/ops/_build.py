"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (Hopper), one process a
source, all started together, and links the objects into one shared library
with a plain C interface, under ``build/kernels/`` at the root of the
checkout. The file name carries a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so an edit rebuilds and an unchanged tree
loads the cached library. Only the kernel
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
# the flags of a one-step build of a shared library (``scripts/`` builds its
# variants so); the library here compiles each source with them, less
# ``-shared``, and links the objects with ``-shared``
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_COMPILE_FLAGS = [f for f in NVCC_FLAGS if f != "-shared"]

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


def _headers():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def _digest(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> None:
    # pointers and the stream as c_void_p, sizes as int64: the ctypes
    # default (C int) would cut both to 32 bits
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    signatures = {
        # (plane, n_cells, codes, m, stream)
        "pykmer_sweep_sorted": [ptr, i64, ptr, i64, ptr],
        # (bases2, bytes, maskbits or NULL, bytes, windows, K, out,
        #  count or NULL, stream)
        "pykmer_encode_packed": [ptr, i64, ptr, i64, i64, i64, ptr, ptr, ptr],
        # (chunk, bases, K, out, stream)
        "pykmer_encode_bases": [ptr, i64, i64, ptr, ptr],
    }
    for stem, argtypes in signatures.items():
        for suffix in ("_i32", "_i64"):
            fn = getattr(lib, stem + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    untyped = {
        # (raw, n, K, workspace, totals, stream)
        "pykmer_fasta_scan": [ptr, i64, i64, ptr, ptr, ptr],
        # (raw, n, K, workspace, bases, bytes, mask, bytes, n_codes, n_recs,
        #  name_off, name_end, rec_start, has_valid, stream)
        "pykmer_fasta_write": [ptr, i64, i64, ptr, ptr, i64, ptr, i64, i64, i64,
                               ptr, ptr, ptr, ptr, ptr],
        # (folded from cell c0, c0, out, a, n, K, counts or NULL, stream)
        "pykmer_unfold_file": [ptr, i64, ptr, i64, i64, i64, ptr, ptr],
        # (comp, bytes, c_offs, u_offs, n_blocks, c_base, u_base, out, bytes,
        #  status, stream)
        "pykmer_inflate_bgzf": [ptr, i64, ptr, ptr, i64, i64, i64, ptr, i64, ptr, ptr],
        # (data, bytes, records, syms, slots, sizes, out, stream)
        "pykmer_deflate_bgzf": [ptr, i64, ptr, ptr, ptr, ptr, ptr, ptr],
    }
    for name, argtypes in untyped.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pykmer_fasta_workspace.argtypes = [i64]
    lib.pykmer_fasta_workspace.restype = i64


def _compile_and_link(srcs, so: str) -> str:
    """Compile ``srcs`` in parallel, link them into ``so``; returns nvcc's
    output. Raises with that output if a step fails."""
    nvcc = _nvcc()
    work = f"{so}.{os.getpid()}.d"
    os.makedirs(work, exist_ok=True)
    try:
        objs = [os.path.join(work, os.path.basename(src) + ".o") for src in srcs]
        procs = [subprocess.Popen([nvcc, *_COMPILE_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(srcs, objs)]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(outs)
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed ({[p.returncode for p in procs]}):\n{log}")
        tmp = os.path.join(work, "lib.so")
        proc = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent build sees all or none
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return log


def load() -> ctypes.CDLL:
    """The kernels' library, built first if the sources changed."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = _sources()
        so = os.path.join(BUILD_DIR, f"libpykmer_kernels_{_digest(srcs + _headers())}.so")
        if os.path.exists(so):
            BUILD_LOG = f"loaded cached {so}"
        else:
            BUILD_LOG = _compile_and_link(srcs, so)
        lib = ctypes.CDLL(so)
        _bind(lib)
        _LIB = lib
        return lib
