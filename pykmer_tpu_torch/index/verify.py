"""The index's verify: the written `.kin` read back from the file and
counted on a thread of its own, beside the output hash.

A readback sink (``ops/readback.ChaseSink``, ``PieceSink``) starts the
:class:`FileVerifier` once every write to the file has landed, with the
ranges it is to read itself; the pieces tail counts the mirror half from the
buffers it already reads back from the file to hash it. The index then
compares the file's counts with its in-memory stats before the rename.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, Tuple

import numpy as np

from ..formats.header import fast_counts256
from ..io.direct import DirectReader, pread_into_mt
from ..utils.bigmem import big_empty
from ..utils.profiling import carry, span

BLOCK = 1 << 28  # bytes a read of the verifier


class FileVerifier:
    """The 256-bin counts of the ``size`` bytes of the file ``path``, every
    byte read back from the file by O_DIRECT.

    :meth:`start` reads the ranges it is given on the "verify" thread,
    reading each block (a "verify read" span, on the "verify-read" thread)
    while the one before it is counted. :meth:`count` adds a buffer that
    another thread read from the file. Every count is a "verify count" span
    of its bytes. :meth:`result` waits for the reads and returns the counts;
    it raises unless the counted ranges tile [0, ``size``) exactly once."""

    def __init__(self, path: str, size: int, block: int = BLOCK):
        self.path = path
        self.size = size
        self.block = block
        self._counts = np.zeros(256, dtype=np.int64)
        self._counted: List[Tuple[int, int]] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()

    def count(self, arr: np.ndarray, offset: int) -> None:
        """Count ``arr``, the file's bytes read from ``offset``."""
        with span("verify count", bytes=arr.nbytes):
            counts = fast_counts256(arr)
        with self._lock:
            self._counts += counts
            self._counted.append((offset, offset + arr.nbytes))

    def start(self, ranges: Iterable[Tuple[int, int]]) -> None:
        """Read and count the byte ranges ``ranges`` of the file, on a thread
        of its own; called once every write to the file has landed."""
        self._thread = threading.Thread(target=carry(self._run), args=(list(ranges),),
                                        name="verify", daemon=True)
        self._thread.start()

    def _run(self, ranges: List[Tuple[int, int]]) -> None:
        try:
            self._read(ranges)
        except BaseException as e:  # raised again by result()
            self._error = e

    def _read(self, ranges: List[Tuple[int, int]]) -> None:
        blocks = [(a, min(hi, a + self.block)) for lo, hi in ranges
                  for a in range(lo, hi, self.block)]
        if not blocks:
            return
        width = max(hi - lo for lo, hi in blocks)
        bufs = [big_empty(width) for _ in range(2)]
        with DirectReader(self.path) as reader, \
                ThreadPoolExecutor(1, thread_name_prefix="verify-read") as pre:

            @carry
            def read(i: int) -> np.ndarray:
                lo, hi = blocks[i]
                buf = bufs[i % 2][: hi - lo]
                with span("verify read", bytes=hi - lo):
                    if pread_into_mt(reader, buf, lo) != hi - lo:
                        raise OSError(f"short read of {self.path} at {lo}")
                return buf

            nxt = pre.submit(read, 0)
            for i, (lo, _) in enumerate(blocks):
                buf = nxt.result()
                if self._stop.is_set():
                    return
                if i + 1 < len(blocks):
                    nxt = pre.submit(read, i + 1)
                self.count(buf, lo)

    def result(self) -> np.ndarray:
        """The file's 256-bin counts, once the reads are done."""
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error
        at = 0
        for lo, hi in sorted(self._counted):
            if lo != at:
                raise RuntimeError(f"verify counted {self.path} from {lo}, not from {at}")
            at = hi
        if at != self.size:
            raise RuntimeError(f"verify counted {at} bytes of {self.path}, not {self.size}")
        return self._counts.copy()

    def close(self) -> None:
        """Stop the reads after the block in hand (on an error path) and wait
        for the thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
