"""Record-aligned segments of a raw FASTA buffer, and the streaming reader.

Copies of ``_find_record_start``, ``_segment_targets``,
``_segment_record_bounds``, ``_StreamingInput`` and
``_iter_segments_streaming`` from ``pykmer_tpu/index/indexer.py`` (which
imports jax), held against the originals by tests/test_torch_pipeline.py.

Records never span segments and k-mer windows never span records, so each
segment decodes and counts on its own: the basis of the pipelined input
(``host/pipeline.py``).
"""

from __future__ import annotations

import hashlib
import mmap
import os
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utils import renice_current_thread
from ..utils.bigmem import BIG_THRESHOLD, big_empty
from ..utils.profiling import carry, span


def find_record_start(buf: np.ndarray, start: int, limit: int) -> Optional[int]:
    """First record start (a ``>`` preceded by ``\\n``) in [start+1, limit),
    scanning pairs whose bytes both lie in [start, limit). None if absent."""
    p = start
    win = 8 << 20
    while p < limit - 1:
        w = buf[p : min(p + win, limit)]
        hits = np.flatnonzero(w[1:] == ord(">"))
        for h in hits:
            if w[h] == ord("\n"):
                return p + int(h) + 1
        p += w.shape[0] - 1
    return None


def segment_targets(target: int) -> Iterator[int]:
    """Ramped segment sizes: small first segments so the first chunk reaches
    the device early, then ``target``-byte segments."""
    for t in (target // 16, target // 8, target // 4, target // 2):
        if t >= (1 << 20):
            yield t
    while True:
        yield target


def segment_record_bounds(buf: np.ndarray, target: int) -> List[Tuple[int, int]]:
    """Split a raw FASTA byte buffer into ~``target``-byte segments at record
    starts (a ``>`` at a line start); the bounds cover ``buf`` contiguously."""
    n = buf.shape[0]
    starts = [0]
    tgt = segment_targets(target)
    pos = next(tgt)
    while pos < n:
        found = find_record_start(buf, pos - 1, n)
        if found is None:
            break
        starts.append(found)
        pos = found + next(tgt)
    return [(starts[i], starts[i + 1] if i + 1 < len(starts) else n)
            for i in range(len(starts))]


class _Pinned:
    """A page-locked host buffer of ``size`` bytes, registered with CUDA, so
    that copies from it to a card run asynchronously; page-aligned, so that
    O_DIRECT reads land in it. A large one is a block of the host pool,
    whose pages are made resident when the block is made: on an H100 host,
    850 MB took 0.20 s to make and 0.03 s to register, where a fresh map took
    0.63 s to register."""

    def __init__(self, size: int):
        import torch

        self.size = size
        self.array = big_empty(size) if size >= BIG_THRESHOLD \
            else np.frombuffer(mmap.mmap(-1, max(size, 1)), dtype=np.uint8)
        torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
            self.array.ctypes.data, self.array.shape[0], 0))

    def free(self) -> None:
        import torch

        torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(self.array.ctypes.data))
        self.array = None  # back to the host pool, or unmapped, with its last view


class _PinnedPool:
    """One page-locked buffer of the process, leased to one index at a time
    and kept between indexes. It grows only when a larger one is asked for,
    so the pinning (0.2-0.25 s for 850 MB on an H100 host) is paid once and
    not on every index. The streaming input leases it with :meth:`lease`:
    the indexes of a process run one after another, and a second lease
    before the first is given back is an error. :meth:`try_lease` returns
    None instead, for a caller that can do without it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._buf: Optional[_Pinned] = None
        self._leased = False

    def lease(self, size: int) -> _Pinned:
        buf = self.try_lease(size)
        if buf is None:
            raise RuntimeError("the page-locked input buffer is leased to another "
                               "streaming input; release that one first")
        return buf

    def try_lease(self, size: int) -> Optional[_Pinned]:
        """The buffer, grown to at least ``size`` bytes, or None while
        another lease holds it."""
        with self._lock:
            if self._leased:
                return None
            if self._buf is None or self._buf.size < size:
                if self._buf is not None:
                    self._buf.free()
                    self._buf = None
                self._buf = _Pinned(size)
            self._leased = True
            return self._buf

    def give_back(self) -> None:
        with self._lock:
            self._leased = False


PINNED = _PinnedPool()
# the `.kin` where the card unfolds it in file order, up to
# ``ops/readback.PINNED_OUT_MAX`` bytes (``ops/readback.output_array``)
PINNED_OUT = _PinnedPool()


class StreamingInput:
    """Background O_DIRECT read of a plain FASTA file into one buffer.

    The segment scan chases the reader (``wait_until(pos)`` blocks until
    ``pos`` bytes are resident) and the input sha256 chases it too, so the
    disk read, the input hash, the decode and the uploads overlap. Both
    threads run at nice+10 so the dispatch thread wins the cores.

    The buffer is a pooled host block, or, where ``card`` names a CUDA
    device the segments are copied to, the process's page-locked buffer
    (:data:`PINNED`). :meth:`release` stops the threads and gives the buffer
    back; the page-locked one only once ``card`` has finished its copies."""

    def __init__(self, path: str, extent: int = 64 << 20, card=None):
        self.size = os.path.getsize(path)
        self._card = card
        self._pinned = PINNED.lease(self.size) if card is not None else None
        self.buf = (self._pinned.array if self._pinned is not None
                    else big_empty(max(self.size, 1)))[: self.size]
        self._path = path
        self._extent = extent
        self._cond = threading.Condition()
        self._filled = 0
        self._exc: Optional[BaseException] = None
        self._stop = False
        self._sha_hex: Optional[str] = None
        self._reader = threading.Thread(target=self._read, daemon=True, name="input-read")
        self._reader.start()
        # its spans record under the span open here
        self._hasher = threading.Thread(target=carry(self._hash), daemon=True,
                                        name="input-hash")
        self._hasher.start()

    def _read(self) -> None:
        # looked up at call time so tests can throttle the reader
        from ..io import direct

        renice_current_thread(10)
        try:
            with direct.DirectReader(self._path) as rd:
                pos = 0
                while pos < self.size:
                    if self._stop:
                        raise RuntimeError(f"{self._path}: input released mid-read")
                    hi = min(self.size, pos + self._extent)
                    got = direct.pread_into_mt(
                        rd, self.buf[pos:hi], pos, threads=2, chunk=32 << 20
                    )
                    if got != hi - pos:
                        raise IOError(f"{self._path}: short read at {pos} ({got} bytes)")
                    with self._cond:
                        self._filled = hi
                        self._cond.notify_all()
                    pos = hi
        except BaseException as exc:  # surfaced by wait_until
            with self._cond:
                self._exc = exc
                self._cond.notify_all()

    def _hash(self) -> None:
        renice_current_thread(10)
        h = hashlib.sha256()
        pos = 0
        while pos < self.size:
            hi = min(self.size, pos + (32 << 20))
            try:
                self.wait_until(hi)
            except BaseException:
                return  # the reader failed; wait_until reports it to the pipeline
            if self._stop:
                return
            with span("input sha256", bytes=hi - pos):
                h.update(self.buf[pos:hi])
            pos = hi
        self._sha_hex = h.hexdigest()

    def filled(self) -> int:
        with self._cond:
            return self._filled

    def wait_until(self, pos: int) -> None:
        with self._cond:
            while self._filled < pos and self._exc is None:
                self._cond.wait()
            if self._exc is not None and self._filled < pos:
                raise self._exc

    def input_checksum(self) -> str:
        self._hasher.join()
        if self._sha_hex is None:
            self.wait_until(self.size)  # raises the reader's error
            raise RuntimeError(f"{self._path}: input hash thread died")
        return self._sha_hex

    def release(self) -> None:
        """Stop the reader and the hasher (each ends at its next extent),
        then give the buffer back; ``buf`` is not to be read after this.
        A second call does nothing."""
        if self.buf is None:
            return
        self._stop = True
        self._reader.join()
        self._hasher.join()
        if self._pinned is not None:
            import torch

            torch.cuda.synchronize(self._card)  # no copy from the buffer in flight
            PINNED.give_back()
            self._pinned = None
        self.buf = None


def iter_segments_streaming(
    stream: StreamingInput, target: int, wait_slack: int = 8 << 20
) -> Iterator[Tuple[int, int]]:
    """Yield (lo, hi) record-aligned segment bounds, chasing the reader; the
    same bounds as :func:`segment_record_bounds` on the whole buffer.

    ``wait_slack`` is how far past the scan point each wait asks the reader
    to fill (small values force the partial-fill rescan in tests)."""
    size = stream.size
    lo = 0
    tgt = segment_targets(target)
    while lo < size:
        scan_from = min(size, lo + next(tgt)) - 1
        found = None
        while found is None:
            avail = stream.filled()
            with span("input wait"):
                stream.wait_until(min(size, max(avail, scan_from + wait_slack)))
            avail = stream.filled()
            found = find_record_start(stream.buf, scan_from, avail)
            if found is None:
                if avail >= size:
                    break
                # a boundary pair may straddle the fill point: rescan from it
                scan_from = max(scan_from, avail - 1)
        hi = found if found is not None else size
        yield (lo, hi)
        lo = hi
