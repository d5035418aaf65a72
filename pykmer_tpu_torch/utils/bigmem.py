"""Pooled, pre-populated allocation for large host buffers.

This environment (Firecracker guest with a virtio balloon) hands new
physical memory to the guest slowly, and at *degrading* rates as the
process footprint grows: demand-paging runs ~370 us per 4 KiB page, and
even ``MAP_POPULATE`` (fast at ~3 GB/s for the first ~1 GB of footprint)
degrades to 20 MB/s and worse for subsequent GiB-scale regions (measured
0.24 s → 39 s → 180 s for three successive 862 MB populates kept live).
Memory already faulted into the process, by contrast, stays fast.

So this module does two things:

- routes big allocations through anonymous ``MAP_POPULATE`` mmaps (one
  syscall faults the whole region — still the cheapest way to obtain
  *new* memory);
- **pools the blocks forever**: when the numpy array dies, the underlying
  mmap stays in the pool and the next request reuses it (checked via the
  block's refcount — the array's base chain holds the mmap, so a block is
  free exactly when only the pool references it). The fault cost is paid
  once per block per process instead of once per allocation.

``MADV_HUGEPAGE`` is deliberately NOT applied: THP fault-in runs ~47 MB/s
here (18 s to touch 850 MB) and the madvise kicks khugepaged into
background collapses that stall subsequent populates further.

No reference analog (the reference never allocates at this scale in one
process); this is host-runtime glue for the TPU pipeline's GiB-scale
decode/readback buffers.

Copy of ``pykmer_tpu/utils/bigmem.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import mmap
import os
import sys
import threading
from typing import Tuple, Union

import numpy as np

# below this, normal heap allocation is fine (glibc reuses it)
BIG_THRESHOLD = 8 << 20
# block sizes are rounded up to this class size so differently-sized
# requests (e.g. the 850 MB input buffer and the 862 MB code stream)
# land on reusable blocks
CLASS_BYTES = 64 << 20
# pooled bytes beyond this are released back to the OS (largest-first)
POOL_CAP = int(os.environ.get("PYKMER_TPU_POOL_CAP", str(16 << 30)))

_LOCK = threading.Lock()
# each entry: [mmap, fresh] — fresh means never handed out (still all-zero)
_POOL: list = []


def _try_new_block(nbytes: int):
    flags = mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
    flags |= getattr(mmap, "MAP_POPULATE", 0x8000)
    try:
        return mmap.mmap(-1, nbytes, flags=flags)
    except (ValueError, OSError):
        return None


def _acquire(nbytes: int):
    """Return (mmap, fresh) with len >= nbytes, reusing a pooled block."""
    want = -(-nbytes // CLASS_BYTES) * CLASS_BYTES
    with _LOCK:
        best = None
        for entry in _POOL:
            m = entry[0]
            # refs: pool entry list + loop var + getrefcount arg = 3
            if len(m) >= want and sys.getrefcount(m) <= 3:
                if best is None or len(m) < len(best[0]):
                    best = entry
        if best is not None:
            fresh, best[1] = best[1], False
            return best[0], fresh
        m = _try_new_block(want)
        if m is None:
            return None, False
        _POOL.append([m, False])  # handed out now, so not fresh
        # cap: drop free blocks (largest first) beyond POOL_CAP
        total = sum(len(e[0]) for e in _POOL)
        if total > POOL_CAP:
            for e in sorted(_POOL, key=lambda e: -len(e[0])):
                if total <= POOL_CAP:
                    break
                blk = e[0]
                # refs: pool entry + blk var + getrefcount arg = 3 if free
                if blk is not m and sys.getrefcount(blk) <= 3:
                    _POOL.remove(e)
                    total -= len(blk)
        return m, True


def pool_stats() -> Tuple[int, int]:
    """(total pooled bytes, free pooled bytes) — for tests/diagnostics."""
    total = free = 0
    with _LOCK:
        for e in _POOL:
            blk = e[0]
            total += len(blk)
            # refs: pool entry + blk var + getrefcount arg = 3 if free
            if sys.getrefcount(blk) <= 3:
                free += len(blk)
    return total, free


def big_empty(shape: Union[int, Tuple[int, ...]], dtype=np.uint8) -> np.ndarray:
    """np.empty for large buffers, backed by a pooled pre-populated map.

    The block returns to the pool (stays faulted-in) when the array is
    garbage-collected; contents of a reused block are arbitrary, exactly
    like np.empty.
    """
    if isinstance(shape, int):
        shape = (shape,)
    count = int(np.prod(shape, dtype=np.int64))
    nbytes = count * np.dtype(dtype).itemsize
    if nbytes < BIG_THRESHOLD:
        return np.empty(shape, dtype=dtype)
    m, _fresh = _acquire(nbytes)
    if m is None:
        return np.empty(shape, dtype=dtype)
    return np.frombuffer(m, dtype=dtype, count=count).reshape(shape)


def extend_view(arr: np.ndarray, count: int):
    """Re-view a ``big_empty``-backed contiguous array as a longer one (same
    dtype, same start address) if its underlying pooled block has capacity.

    Returns the longer array (extra elements uninitialised) or ``None`` when
    the array is not pool-backed, is an offset view, or the block is too
    small. Lets callers append framing/padding in place instead of paying a
    full copy into a fresh block (GiB-scale populates are slow here)."""
    base = arr
    while isinstance(base, np.ndarray):
        if base.ctypes.data != arr.ctypes.data or not base.flags.c_contiguous:
            return None
        base = base.base
    # numpy wraps the pool mmap in a memoryview; accept either form
    if isinstance(base, memoryview):
        cap = base.nbytes
    elif isinstance(base, mmap.mmap):
        cap = len(base)
    else:
        return None
    nbytes = count * arr.dtype.itemsize
    if cap < nbytes:
        return None
    return np.frombuffer(base, dtype=arr.dtype, count=count)


def big_zeros(shape, dtype=np.uint8) -> np.ndarray:
    """Zero-filled variant (fresh anonymous pages are already zero)."""
    if isinstance(shape, int):
        shape = (shape,)
    count = int(np.prod(shape, dtype=np.int64))
    nbytes = count * np.dtype(dtype).itemsize
    if nbytes < BIG_THRESHOLD:
        return np.zeros(shape, dtype=dtype)
    m, fresh = _acquire(nbytes)
    if m is None:
        return np.zeros(shape, dtype=dtype)
    arr = np.frombuffer(m, dtype=dtype, count=count).reshape(shape)
    if not fresh:
        arr.reshape(-1).view(np.uint8)[...] = 0
    return arr
