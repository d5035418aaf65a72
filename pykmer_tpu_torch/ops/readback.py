"""Device→host tail of the index path: fetch, unfold, write + sha256.

One device-to-host copy of the folded plane into a pinned host buffer, the
native unfold to the full 4^K array (numpy blockwise where the native library
is absent), then a concurrent positional write and sha256. The JAX package's
packed, sparse and escape readback modes exist for a slow host link and are
not ported.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Optional

import numpy as np
import torch

from pykmer_tpu.utils.bigmem import big_empty


def fetch_plane(plane: torch.Tensor) -> np.ndarray:
    """The plane as a host numpy array: one copy into pinned memory on CUDA,
    a view of the tensor's storage on the CPU."""
    if plane.device.type == "cpu":
        return plane.numpy()
    host = torch.empty(plane.shape, dtype=plane.dtype, pin_memory=True)
    host.copy_(plane)  # synchronous: the host reads it next
    return host.numpy()


def _rc_codes_np(u: np.ndarray, kmer_len: int) -> np.ndarray:
    """Vectorised reverse-complement of K 2-bit symbol codes (host numpy)."""
    v = u.astype(np.uint64)
    r = np.zeros_like(v)
    for _ in range(kmer_len):
        r = (r << np.uint64(2)) | (~v & np.uint64(3))
        v = v >> np.uint64(2)
    return r


def unfold_canonical(
    folded: np.ndarray, kmer_len: int, out: Optional[np.ndarray] = None
) -> np.ndarray:
    """Expand the folded half-plane (counts stored at min(c, M-c)) to the
    full 4^K dense array: the canonical member of each {u, M-u} pair gets
    folded[u], the other 0. Native threaded pass, with a blockwise numpy
    version where the native library is absent."""
    half = folded.shape[0]
    size = 2 * half
    if size != 4**kmer_len:
        raise ValueError(f"folded plane of {half} cells is not 4^{kmer_len}/2")
    if out is None:
        out = big_empty(size)
    if out.shape[0] != size or out.dtype != np.uint8:
        raise ValueError("out must be uint8[4^K]")
    try:
        from pykmer_tpu.io.native import unfold_canonical_native

        unfold_canonical_native(np.ascontiguousarray(folded), out, kmer_len)
        return out
    except ImportError:
        pass
    m = size - 1
    block = 1 << 22
    for lo in range(0, half, block):
        hi = min(half, lo + block)
        u = np.arange(lo, hi, dtype=np.uint64)
        canon = u <= _rc_codes_np(u, kmer_len)
        vals = folded[lo:hi]
        out[lo:hi] = np.where(canon, vals, 0)
        # mirror cells [m-hi+1, m-lo] in descending-u order
        out[m - hi + 1 : m - lo + 1] = np.where(canon, 0, vals)[::-1]
    return out


def write_and_hash(fd, arr: np.ndarray) -> str:
    """Concurrent whole-buffer write + sha256 (hashlib releases the GIL on
    large updates); returns the hex digest. ``fd`` may be None (hash only)."""
    wt = None
    err: list = []

    def write() -> None:
        try:
            pwrite_all(fd, arr, 0)
        except BaseException as exc:  # re-raised on the calling thread
            err.append(exc)

    if fd is not None:
        wt = threading.Thread(target=write)
        wt.start()
    hex_ = hashlib.sha256(arr).hexdigest()
    if wt is not None:
        wt.join()
    if err:
        raise err[0]
    return hex_


def pwrite_all(fd, arr: np.ndarray, offset: int) -> None:
    """Positional write of a contiguous uint8 array (loops on short writes).

    ``fd`` may be a raw file descriptor or a ``pykmer_tpu.io.direct
    .DirectWriter``."""
    if hasattr(fd, "pwrite"):
        fd.pwrite(arr, offset)
        return
    view = memoryview(arr)
    pos = offset
    while len(view):
        n = os.pwrite(fd, view, pos)
        view = view[n:]
        pos += n
