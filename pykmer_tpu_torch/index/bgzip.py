"""The index's bgzip output: the finished `.kin` written again as
`.kin.bgz` with its `.gzi`, the files htslib's ``bgzip -i`` makes.

The `.kin` is read back by O_DIRECT in runs of whole 65,280-byte blocks;
each run deflates on a pool of one thread a core the process may run on,
through the native block codec at zlib level 6 (ctypes releases the GIL);
the dispatch thread writes the blocks in file order, then the 28-byte EOF
block, and the `.gzi` (the count, then a (compressed, uncompressed) offset
pair for every block but the first). Both files are written under
temporary names and renamed into place once whole, so a file that exists
under its final name is finished. The bytes are ``io/bgzf.bgzip_kin``'s.

Spans: "kin read" (bytes), each read of the `.kin`; "bgzf deflate" on the
pool's threads ("bgzf-deflate_<i>"), one run, with ``blocks``, ``bytes``
(in) and ``bytes_out``; "bgzf write" (bytes), each write of the `.kin.bgz`.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from ..io.bgzf import BGZF_BLOCK_SIZE, BGZF_EOF, _compress_block, write_gzi
from ..io.direct import DirectReader, DirectWriter
from ..utils.bigmem import big_empty
from ..utils.profiling import carry, span

LEVEL = 6  # bgzip's default
# blocks a deflate task takes: 64 blocks start at 4096-aligned offsets of
# the file (65,280 x 16 is), so the runs read by O_DIRECT
RUN_BLOCKS = 64
RUNS_AHEAD = 2  # runs read ahead of the write, for each deflate thread
WRITE_BYTES = 8 << 20  # the compressed bytes gathered for one write


def deflate_threads() -> int:
    """The deflate pool's size: one thread for each CPU the process may run
    on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def _deflate(run: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``run`` as BGZF blocks: (their bytes, each block's compressed size)."""
    try:
        from ..io.native import bgzf_compress_buffer_native
    except ImportError:
        blocks = [_compress_block(run[a: a + BGZF_BLOCK_SIZE].tobytes(), LEVEL)
                  for a in range(0, run.shape[0], BGZF_BLOCK_SIZE)]
        return (np.frombuffer(b"".join(blocks), dtype=np.uint8),
                np.array([len(b) for b in blocks], dtype=np.int64))
    result = bgzf_compress_buffer_native(run, level=LEVEL, block_size=BGZF_BLOCK_SIZE,
                                         threads=1)
    if result is None:
        raise IOError("BGZF deflate failed")
    return result


def _deflate_run(run: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    with span("bgzf deflate", blocks=-(-run.shape[0] // BGZF_BLOCK_SIZE),
              bytes=run.shape[0]) as counts:
        out, sizes = _deflate(run)
        counts["bytes_out"] = int(out.shape[0])
    return out, sizes


class _StagedWriter:
    """Appends bytes to a new file through a staging buffer, written in
    aligned pieces of ``WRITE_BYTES`` (O_DIRECT) and the rest at
    :meth:`finish`."""

    def __init__(self, path: str):
        self.fd = DirectWriter(path)
        self.buf = big_empty(WRITE_BYTES)
        self.fill = self.at = 0

    def write(self, data: np.ndarray) -> None:
        while data.shape[0]:
            n = min(data.shape[0], WRITE_BYTES - self.fill)
            self.buf[self.fill: self.fill + n] = data[:n]
            self.fill += n
            data = data[n:]
            if self.fill == WRITE_BYTES:
                self._flush()

    def _flush(self) -> None:
        with span("bgzf write", bytes=self.fill):
            self.fd.pwrite(self.buf[: self.fill], self.at)
        self.at += self.fill
        self.fill = 0

    def finish(self) -> None:
        if self.fill:
            self._flush()


def write_bgzip(kin: str, size: int) -> Tuple[str, str]:
    """Write ``kin`` (``size`` bytes) as ``kin``.bgz and its ``.gzi``;
    returns their paths. A failure raises and leaves neither file, nor a
    temporary."""
    bgz, gzi = kin + ".bgz", kin + ".bgz.gzi"
    tmp_bgz, tmp_gzi = bgz + ".tmp", gzi + ".tmp"
    run_bytes = RUN_BLOCKS * BGZF_BLOCK_SIZE
    threads = deflate_threads()
    depth = RUNS_AHEAD * threads
    slots = big_empty(depth * run_bytes)
    sizes: List[np.ndarray] = []
    try:
        with DirectReader(kin) as reader, \
                ThreadPoolExecutor(threads, thread_name_prefix="bgzf-deflate") as pool:
            out = _StagedWriter(tmp_bgz)
            try:
                pending: collections.deque = collections.deque()

                def write_oldest() -> None:
                    data, block_sizes = pending.popleft().result()
                    out.write(data)
                    sizes.append(block_sizes)

                deflate = carry(_deflate_run)
                for i, at in enumerate(range(0, size, run_bytes)):
                    if len(pending) == depth:
                        write_oldest()  # frees the slot this run reads into
                    n = min(run_bytes, size - at)
                    slot = slots[(i % depth) * run_bytes:][:n]
                    with span("kin read", bytes=n):
                        if reader.pread_into(slot, at) != n:
                            raise IOError(f"short read of {kin} at {at}")
                    pending.append(pool.submit(deflate, slot))
                while pending:
                    write_oldest()
                out.write(np.frombuffer(BGZF_EOF, dtype=np.uint8))
                out.finish()
            finally:
                for fut in pending:
                    fut.cancel()
                out.fd.close()
        block_sizes = np.concatenate(sizes) if sizes else np.empty(0, np.int64)
        c_offs = np.cumsum(block_sizes) - block_sizes
        u_offs = np.arange(block_sizes.shape[0], dtype=np.int64) * BGZF_BLOCK_SIZE
        write_gzi(tmp_gzi, list(zip(c_offs.tolist(), u_offs.tolist())))
        os.rename(tmp_bgz, bgz)
        os.rename(tmp_gzi, gzi)
    except BaseException:
        for path in (tmp_bgz, tmp_gzi):
            if os.path.exists(path):
                os.remove(path)
        raise
    return bgz, gzi

