"""Device→host tail of the index path: the chased readback.

:func:`stream_plane_to_out` reads the flat folded plane back in fixed-size
slices and unfolds each into the full 4^K host array while the next slice is
in flight; a :class:`ChaseSink` writes each finished region and its mirror to
the `.kin` and advances the output sha256 behind the unfold. So the copy, the
unfold, the write and the hash overlap, and host memory holds the 4^K output
plus two slices, never a second whole-plane copy.

The plane may also come as the S local planes of a sharded run
(``parallel/histogram.py``): folded cell w is ``shards[w % S][w // S]``, so
each output slice [a, b) (a, b multiples of S) is assembled as
``stack(shard[a/S : b/S] for shard in shards, dim=1).reshape(-1)`` on the
first shard's device. No device and no host buffer ever holds the whole flat
plane beyond the 4^K output.

Port of the raw path of ``pykmer_tpu/ops/readback.py`` (``_ChaseSink``,
``unfold_range``, ``stream_dense_to_out``). The JAX package's packed, sparse
and escape readback modes exist for a slow host link and are not ported.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..formats.header import fast_counts256
from ..utils.bigmem import big_empty
from ..utils.profiling import StageTimer

SLICE_CELLS = 64 << 20  # folded cells per device-to-host slice
UNFOLD_THREADS = 4  # host threads that unfold one slice (native, GIL-free)
WRITE_THREADS = 2


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
        from ..io.native import unfold_canonical_native

        unfold_canonical_native(np.ascontiguousarray(folded), out, kmer_len)
        return out
    except ImportError:
        pass
    unfold_range(folded, out, kmer_len, 0)
    return out


def unfold_range(
    folded_slice: np.ndarray, out: np.ndarray, kmer_len: int, lo: int
) -> None:
    """Expand folded cells [lo, lo + len(folded_slice)) into the full 4^K
    array ``out``: the cells themselves and their mirrors. Native single
    thread (callers run disjoint ranges on several threads), with a blockwise
    numpy version where the native library is absent."""
    try:
        from ..io.native import unfold_canonical_range_native

        unfold_canonical_range_native(
            np.ascontiguousarray(folded_slice), out, kmer_len, lo)
        return
    except ImportError:
        pass
    m = out.shape[0] - 1
    end = lo + folded_slice.shape[0]
    block = 1 << 22  # bounds the uint64 temporaries
    for blo in range(lo, end, block):
        bhi = min(end, blo + block)
        u = np.arange(blo, bhi, dtype=np.uint64)
        canon = u <= _rc_codes_np(u, kmer_len)
        vals = folded_slice[blo - lo : bhi - lo]
        out[blo:bhi] = np.where(canon, vals, 0)
        # mirror cells [m-bhi+1, m-blo] in descending-u order
        out[m - bhi + 1 : m - blo + 1] = np.where(canon, 0, vals)[::-1]


def pwrite_all(fd, arr: np.ndarray, offset: int) -> None:
    """Positional write of a contiguous uint8 array (loops on short writes).

    ``fd`` may be a raw file descriptor or an ``io.direct.DirectWriter``."""
    if hasattr(fd, "pwrite"):
        fd.pwrite(arr, offset)
        return
    view = memoryview(arr)
    pos = offset
    while len(view):
        n = os.pwrite(fd, view, pos)
        view = view[n:]
        pos += n


class ChaseSink:
    """Write + sha256 chasing the finished regions of the unfolded plane.

    ``region_done(lo, hi)`` takes ascending first-half cell ranges as they
    become final. It queues the range and its mirror for the background
    writers (``fd`` may be None: no file) and the range for the hasher
    thread, which advances the sha256 frontier through the first half of
    ``out`` in order. The second half completes in reverse region order, so
    :meth:`finish` hashes it as one pass: the only serial remainder.
    ``region_done`` is called from one thread."""

    def __init__(self, out: np.ndarray, fd=None):
        self.out = out
        self.fd = fd
        self.full = out.shape[0]
        self.h = hashlib.sha256()
        self.writers = ThreadPoolExecutor(WRITE_THREADS) if fd is not None else None
        self.hasher = ThreadPoolExecutor(1)  # one worker: updates stay in order
        self._futs: List = []
        self.expected = 0

    def region_done(self, lo: int, hi: int) -> None:
        if hi <= lo:
            return
        if lo != self.expected:
            raise ValueError(f"region [{lo}, {hi}) out of order; expected {self.expected}")
        if self.writers is not None:
            full = self.full
            self._futs.append(self.writers.submit(pwrite_all, self.fd, self.out[lo:hi], lo))
            self._futs.append(self.writers.submit(
                pwrite_all, self.fd, self.out[full - hi : full - lo], full - hi))
        self._futs.append(self.hasher.submit(self.h.update, self.out[lo:hi]))
        self.expected = hi

    def finish(self) -> str:
        """Wait for every write (re-raising a failure) and return the sha256
        of the whole of ``out``."""
        if self.expected != self.full // 2:
            raise ValueError(f"regions end at {self.expected}, not {self.full // 2}")
        self._futs.append(self.hasher.submit(self.h.update, self.out[self.full // 2 :]))
        self.abort()
        for f in self._futs:
            f.result()  # surface any pwrite failure (ENOSPC, EIO, ...)
        return self.h.hexdigest()

    def abort(self) -> None:
        """Drain the writers and the hasher. On an error path this must run
        before the caller closes ``fd``: a pwrite landing after the fd number
        is recycled would write into an unrelated file."""
        if self.writers is not None:
            self.writers.shutdown(wait=True)
        self.hasher.shutdown(wait=True)


def _slice_bounds(half: int, slice_cells: int) -> List[Tuple[int, int]]:
    return [(lo, min(half, lo + slice_cells)) for lo in range(0, half, slice_cells)]


def _interleaved(shards: Sequence[torch.Tensor]) -> Callable[[int, int], torch.Tensor]:
    """Folded cells [lo, hi) of a sharded plane (lo, hi multiples of S),
    assembled on the first shard's device."""
    # imported here: the parallel package imports the indexer, which imports
    # this module
    from ..parallel.collectives import move

    s = len(shards)
    dev = shards[0].device

    def view(lo: int, hi: int) -> torch.Tensor:
        if lo % s or hi % s:
            raise ValueError(f"slice [{lo}, {hi}) does not split over {s} shards")
        parts = [move(p[lo // s : hi // s], dev) for p in shards]
        return torch.stack(parts, dim=1).reshape(-1)

    return view


def _cuda_slices(
    view: Callable[[int, int], torch.Tensor], dev: torch.device,
    bounds: List[Tuple[int, int]]
) -> Iterator[np.ndarray]:
    """Host copies of ``view(lo, hi)`` for each bound, in order: two pinned
    buffers that alternate, filled on a side stream of ``dev``, so slice i+1
    is in flight while the caller unfolds slice i. A buffer is refilled only
    after the caller has asked for the next slice, i.e. finished with it."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))  # the plane is final
    width = max(hi - lo for lo, hi in bounds)
    bufs = [torch.empty(width, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    ready = [torch.cuda.Event(), torch.cuda.Event()]

    def enqueue(i: int) -> None:
        lo, hi = bounds[i]
        with torch.cuda.stream(side):
            bufs[i % 2][: hi - lo].copy_(view(lo, hi), non_blocking=True)
            ready[i % 2].record(side)

    try:
        enqueue(0)
        for i, (lo, hi) in enumerate(bounds):
            if i + 1 < len(bounds):
                enqueue(i + 1)
            ready[i % 2].synchronize()
            yield bufs[i % 2].numpy()[: hi - lo]
    finally:
        side.synchronize()  # no copy may outlive its buffer


def stream_plane_to_out(
    plane: Union[torch.Tensor, Sequence[torch.Tensor]],
    kmer_len: int,
    out: np.ndarray,
    fd=None,
    slice_cells: int = SLICE_CELLS,
    stages: Optional[StageTimer] = None,
) -> Tuple[np.ndarray, str]:
    """Read the flat folded ``plane`` (uint8[4^K/2], on the card or the CPU)
    back slice by slice, unfold it into ``out`` (uint8[4^K]), write ``out``
    to ``fd`` (optional) and hash it, each chasing the one before.

    ``plane`` may instead be the S local planes (uint8[4^K/2/S] each, S a
    power of two, on one device type) of a sharded run, read as their
    interleave. Returns (256-bin counts of the folded plane as int64[256],
    sha256 hex of ``out``), as ``stream_dense_to_out(..., hash_out=True)``
    does. A CPU plane is read in place. ``stages`` receives two entries: the
    slice loop ("copy + unfold") and what remains after it ("write + hash
    drain": the writes and hashes still queued, then the mirror half's
    hash)."""
    shards = [plane] if isinstance(plane, torch.Tensor) else list(plane)
    for p in shards:
        if p.dtype != torch.uint8 or p.dim() != 1 or not p.is_contiguous():
            raise ValueError("plane must be a contiguous 1-D uint8 tensor")
    half = sum(p.shape[0] for p in shards)
    if len({p.shape[0] for p in shards}) != 1 or len({p.device.type for p in shards}) != 1:
        raise ValueError("shards must be equal in size and on one device type")
    if 2 * half != 4**kmer_len or out.shape[0] != 2 * half or out.dtype != np.uint8:
        raise ValueError(f"need a 4^{kmer_len}/2-cell plane and a uint8[4^{kmer_len}] out")
    bounds = _slice_bounds(half, slice_cells)
    view = (lambda lo, hi: shards[0][lo:hi]) if len(shards) == 1 else _interleaved(shards)
    dev = shards[0].device
    if dev.type == "cpu":
        slices = (view(lo, hi).numpy() for lo, hi in bounds)
    elif dev.type == "cuda":
        slices = _cuda_slices(view, dev, bounds)
    else:
        raise ValueError(f"no readback from device {dev}")

    stages = stages or StageTimer()
    counts = np.zeros(256, dtype=np.int64)
    sink = ChaseSink(out, fd)
    try:
        with stages.stage("copy + unfold"), ThreadPoolExecutor(UNFOLD_THREADS) as pool:
            for (lo, hi), folded in zip(bounds, slices):
                part = -(-(hi - lo) // UNFOLD_THREADS)
                unfolds = [pool.submit(unfold_range, folded[a : a + part], out,
                                       kmer_len, lo + a)
                           for a in range(0, hi - lo, part)]
                counts += fast_counts256(folded)
                for f in unfolds:
                    f.result()
                sink.region_done(lo, hi)
        with stages.stage("write + hash drain"):
            return counts, sink.finish()
    except BaseException:
        sink.abort()
        raise
    finally:
        slices.close()
