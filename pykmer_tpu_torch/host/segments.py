"""Record-aligned segments of a raw FASTA buffer, and the streaming inputs.

Copies of ``_find_record_start``, ``_segment_targets``,
``_segment_record_bounds``, ``_StreamingInput`` and
``_iter_segments_streaming`` from ``pykmer_tpu/index/indexer.py`` (which
imports jax), held against the originals by tests/test_torch_pipeline.py.

Records never span segments and k-mer windows never span records, so each
segment decodes and counts on its own: the basis of the pipelined input
(``host/pipeline.py``).

Beside the O_DIRECT reader of a plain file, :class:`BgzfInput` streams a
BGZF file (what ``bgzip`` writes, usually named ``.gz``): :func:`read_bgzf`
reads the compressed file whole and walks its block headers, and runs of
whole blocks are inflated, in file order, into one buffer at the offsets the
blocks' ISIZEs give: by a pool of threads through zlib, or, for an input
bound for a card, on that card (``ops/inflate`` → ``csrc/inflate.cu``). Both
inputs share the surface the segment scan and the chunk producers read:
``buf``, ``size``, ``filled``, ``wait_until``, ``input_checksum`` and
``release``.
"""

from __future__ import annotations

import hashlib
import mmap
import os
import struct
import threading
import zlib
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


BGZF_MAGIC = b"\x1f\x8b\x08\x04"  # gzip, deflate, FEXTRA: a BGZF block's first bytes
BGZF_MAX_ISIZE = 1 << 16  # a block inflates to at most 64 KiB (SAMv1 §4.1)
INFLATE_EXTENT = 2 << 20  # inflated bytes a thread takes at a time, in whole blocks
INFLATE_SPARE_CPUS = 2  # the cores the inflate pool leaves: input hash, dispatch
_XLEN = struct.Struct("<H")
_U32 = struct.Struct("<I")


def inflate_threads() -> int:
    """The inflate pool's size: the process's CPUs less
    ``INFLATE_SPARE_CPUS``, at least 1."""
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:
        cpus = os.cpu_count() or 1
    return max(1, cpus - INFLATE_SPARE_CPUS)


def _block_size(data, pos: int) -> Optional[int]:
    """BSIZE of the BGZF block whose header starts at ``pos`` of ``data``
    (its ``BC`` extra subfield, plus one), or None where no BGZF header
    starts there."""
    n = len(data)
    if pos + 18 > n or bytes(data[pos:pos + 4]) != BGZF_MAGIC:
        return None
    (xlen,) = _XLEN.unpack_from(data, pos + 10)
    p, end = pos + 12, min(pos + 12 + xlen, n)
    while p + 4 <= end:
        (slen,) = _XLEN.unpack_from(data, p + 2)
        if bytes(data[p:p + 2]) == b"BC" and slen == 2 and p + 6 <= end:
            bsize = _XLEN.unpack_from(data, p + 4)[0] + 1
            return bsize if bsize >= 12 + xlen + 8 else None
        p += 4 + slen
    return None


def is_bgzf(path: str) -> bool:
    """Whether the file's first block has a BGZF header."""
    with open(path, "rb") as fh:
        head = fh.read(12 + 0xFFFF)  # the header and the largest extra field
    return _block_size(head, 0) is not None


class BgzfFile:
    """A BGZF file read whole and walked: its compressed bytes ``data`` (a
    pooled host block), the block starts ``c_offs`` in ``data`` and
    ``u_offs`` in the inflated bytes, each with an end sentinel, and
    ``size``, the inflated size."""

    def __init__(self, path: str, data: np.ndarray, c_offs: np.ndarray,
                 u_offs: np.ndarray):
        self.path = path
        self.data = data
        self.c_offs = c_offs
        self.u_offs = u_offs
        self.size = int(u_offs[-1])


def walk_bgzf(data: np.ndarray, path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(``c_offs``, ``u_offs``) of the BGZF bytes ``data``, as
    :class:`BgzfFile` holds them. Raises IOError where a block has no BGZF
    header, the file ends inside a block, or an ISIZE is above 64 KiB."""
    n = data.shape[0]
    mv = memoryview(data)
    c, u = [0], [0]
    pos = total = 0
    while pos < n:
        bsize = _block_size(mv, pos)
        if bsize is None:
            raise IOError(f"{path}: no BGZF block header at byte {pos}")
        if pos + bsize > n:
            raise IOError(f"{path}: truncated: the block at byte {pos} needs {bsize} "
                          f"bytes, {n - pos} remain")
        (isize,) = _U32.unpack_from(mv, pos + bsize - 4)
        if isize > BGZF_MAX_ISIZE:
            raise IOError(f"{path}: the block at byte {pos} claims {isize} bytes")
        pos += bsize
        total += isize
        c.append(pos)
        u.append(total)
    return np.asarray(c, np.int64), np.asarray(u, np.int64)


def read_bgzf(path: str) -> Optional[BgzfFile]:
    """``path`` read whole (O_DIRECT) and walked, or None where its first
    block has no BGZF header (a plain gzip member, or no gzip at all)."""
    if not is_bgzf(path):
        return None
    from ..io.direct import read_file_into

    size = os.path.getsize(path)
    data = big_empty(size)[:size]
    got = read_file_into(path, data)
    if got != size:
        raise IOError(f"{path}: short read ({got} of {size} bytes)")
    return BgzfFile(path, data, *walk_bgzf(data, path))


def bgzf_runs(u_offs: np.ndarray, first: int, most: int) -> List[Tuple[int, int]]:
    """Runs (b0, b1) of whole blocks in file order, given the blocks'
    starts ``u_offs`` in the inflated bytes (with the end sentinel): the
    first run of about ``first`` inflated bytes, each next of twice the last,
    up to ``most``; every run holds at least one block."""
    n_blocks = u_offs.shape[0] - 1
    runs: List[Tuple[int, int]] = []
    b, extent = 0, first
    while b < n_blocks:
        e = min(max(int(np.searchsorted(u_offs, u_offs[b] + extent)), b + 1), n_blocks)
        runs.append((b, e))
        b = e
        extent = min(2 * extent, most)
    return runs


# the card inflate's stream of each card, kept for the process so that its
# buffers' cached blocks serve the next input; one card input runs at a time
# (it holds the page-locked lease)
_CARD_STREAMS: dict = {}


def _card_stream():
    """The card inflate's stream on the current card."""
    import torch

    key = torch.cuda.current_device()
    if key not in _CARD_STREAMS:
        _CARD_STREAMS[key] = torch.cuda.Stream()
    return _CARD_STREAMS[key]


def inflate_blocks(comp: np.ndarray, out: np.ndarray, c_offs: np.ndarray,
                   u_offs: np.ndarray) -> None:
    """Inflate ``comp``, a run of whole BGZF blocks (itself a BGZF buffer),
    into ``out`` on this thread through the native library's
    ``gzip_decompress``, which checks each block's ISIZE; then check each
    block's CRC32. ``c_offs`` and ``u_offs`` are the run's block starts in
    ``comp`` and ``out``, with end sentinels. Raises IOError."""
    from ..io import native

    got = native._lib.gzip_decompress(comp.ctypes.data, comp.shape[0], out.ctypes.data,
                                      out.shape[0], 1)
    if got != out.shape[0]:
        raise IOError(f"bad BGZF block in a run of {len(c_offs) - 1} "
                      f"({got} of {out.shape[0]} bytes)")
    for i in range(len(c_offs) - 1):
        (crc,) = _U32.unpack_from(comp, int(c_offs[i + 1]) - 8)
        if zlib.crc32(out[u_offs[i]:u_offs[i + 1]]) != crc:
            raise IOError(f"BGZF block CRC mismatch at compressed byte {c_offs[i]} of a run")


class BgzfInput:
    """Background inflate of a walked BGZF file (:func:`read_bgzf`) into one
    buffer, with :class:`StreamingInput`'s surface.

    Without a card, :func:`inflate_threads` threads each take the next run
    of whole blocks of about ``INFLATE_EXTENT`` inflated bytes (both read
    when the input is made, so tests can change them), in file order,
    inflate it into the buffer (:func:`inflate_blocks`) and advance
    ``filled`` over the runs finished from the front. Where ``card`` names
    a CUDA device, one thread walks runs that grow from ``INFLATE_EXTENT``
    to an eighth of the file (:func:`bgzf_runs`), and inflates each on the
    card: the run's compressed bytes copied there, ``ops/inflate``'s kernel
    (which checks each block's CRC32 and ISIZE) on a stream of its own, the
    result copied into the buffer, then ``filled`` advanced over it. Each
    run is the span "bgzf inflate", counts ``blocks``, ``bytes_in`` and
    ``bytes``, and on the card ``card_blocks`` (= ``blocks``). The segment
    scan chases ``filled`` as it chases the O_DIRECT reader, and
    ``wait_until`` records the span "inflate wait" while it waits for blocks
    still inflating. A bad block raises through ``wait_until``, never a
    short buffer; a block the card reports bad is inflated again on the
    host, whose error is raised, or, where the host inflates it, an error
    that names the block. The input sha256 covers the compressed bytes
    ("input sha256", bytes). The threads run at nice+10, so the dispatch
    thread wins the cores.

    The buffer is a pooled host block or, where ``card`` names a CUDA device,
    the process's page-locked buffer (:data:`PINNED`), as the reader's."""

    def __init__(self, src: BgzfFile, card=None):
        self.size = src.size
        self._src = src
        self._path = src.path
        self._card = card
        self._pinned = PINNED.lease(self.size) if card is not None else None
        self.buf = (self._pinned.array if self._pinned is not None
                    else big_empty(max(self.size, 1)))[: self.size]
        # the card's runs double from INFLATE_EXTENT up to an eighth of the
        # file: the first lands early, the later ones launch many blocks at
        # once, and a small file still streams in several runs
        self._runs = bgzf_runs(src.u_offs, INFLATE_EXTENT, INFLATE_EXTENT if card is None
                               else max(INFLATE_EXTENT, self.size // 8))
        self._next = 0  # the next run to hand out
        self._done = [False] * len(self._runs)
        self._front = 0  # runs finished from the front
        self._cond = threading.Condition()
        self._filled = 0
        self._exc: Optional[BaseException] = None
        self._stop = False
        self._sha_hex: Optional[str] = None
        # their spans record under the span open here
        if card is not None:
            self._inflaters = [threading.Thread(target=carry(self._inflate_on_card),
                                                daemon=True, name="bgzf-inflate_card")]
        else:
            n = min(inflate_threads(), len(self._runs))
            self._inflaters = [threading.Thread(target=carry(self._inflate), daemon=True,
                                                name=f"bgzf-inflate_{i}") for i in range(n)]
        for t in self._inflaters:
            t.start()
        self._hasher = threading.Thread(target=carry(self._hash), daemon=True,
                                        name="input-hash")
        self._hasher.start()

    def _fail(self, exc: BaseException) -> None:
        """Keep the first inflate error, for wait_until to raise."""
        with self._cond:
            if self._exc is None:
                self._exc = exc
            self._cond.notify_all()

    def _inflate(self) -> None:
        renice_current_thread(10)
        src, runs = self._src, self._runs
        c, u = src.c_offs, src.u_offs
        try:
            while True:
                with self._cond:
                    if self._stop or self._exc is not None or self._next == len(runs):
                        return
                    r = self._next
                    self._next += 1
                b0, b1 = runs[r]
                c0, c1, u0, u1 = int(c[b0]), int(c[b1]), int(u[b0]), int(u[b1])
                with span("bgzf inflate", blocks=b1 - b0, bytes_in=c1 - c0, bytes=u1 - u0):
                    # looked up at call time so tests can plant faults
                    inflate_blocks(src.data[c0:c1], self.buf[u0:u1], c[b0:b1 + 1] - c0,
                                   u[b0:b1 + 1] - u0)
                with self._cond:
                    self._done[r] = True
                    while self._front < len(runs) and self._done[self._front]:
                        self._front += 1
                    self._filled = int(u[runs[self._front - 1][1]]) if self._front else 0
                    self._cond.notify_all()
        except BaseException as exc:
            self._fail(exc)

    def _inflate_on_card(self) -> None:
        import torch

        # looked up at call time so tests can plant faults
        from ..ops import inflate as card

        renice_current_thread(10)
        src, runs, dev = self._src, self._runs, self._card
        c, u = src.c_offs, src.u_offs
        try:
            with torch.cuda.device(dev):
                stream = _card_stream()
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                c_dev, u_dev = torch.from_numpy(c).to(dev), torch.from_numpy(u).to(dev)
                comp = torch.empty(-(-max(int(c[b1] - c[b0]) for b0, b1 in runs) // 4) * 4,
                                   dtype=torch.uint8, device=dev)
                out = torch.empty(max(int(u[b1] - u[b0]) for b0, b1 in runs),
                                  dtype=torch.uint8, device=dev)
                status = torch.empty(c.shape[0] - 1, dtype=torch.int32, device=dev)
                status_host = torch.empty(c.shape[0] - 1, dtype=torch.int32, pin_memory=True)
                host_comp, host_out = torch.from_numpy(src.data), torch.from_numpy(self.buf)
                done = torch.cuda.Event()
                for b0, b1 in runs:
                    if self._stop:
                        return
                    c0, c1, u0, u1 = int(c[b0]), int(c[b1]), int(u[b0]), int(u[b1])
                    with span("bgzf inflate", blocks=b1 - b0, bytes_in=c1 - c0, bytes=u1 - u0,
                              card_blocks=b1 - b0):
                        comp[: c1 - c0].copy_(host_comp[c0:c1], non_blocking=True)
                        card.inflate_bgzf(comp, c_dev[b0:b1 + 1], u_dev[b0:b1 + 1], out,
                                          status[b0:b1], c_base=c0, u_base=u0)
                        host_out[u0:u1].copy_(out[: u1 - u0], non_blocking=True)
                        status_host[b0:b1].copy_(status[b0:b1], non_blocking=True)
                        done.record(stream)
                        done.synchronize()
                    bad = np.flatnonzero(status_host[b0:b1].numpy())
                    if bad.size:
                        b = b0 + int(bad[0])
                        # the host's inflate of the run raises its own error
                        inflate_blocks(src.data[c0:c1], self.buf[u0:u1], c[b0:b1 + 1] - c0,
                                       u[b0:b1 + 1] - u0)
                        raise IOError(
                            f"{self._path}: the card's inflate of the BGZF block at compressed "
                            f"byte {c[b]} (block {b}) reports "
                            f"{card.STATUS.get(int(status_host[b]), 'an unknown status')}, "
                            "but the host's zlib inflates it")
                    with self._cond:
                        self._filled = u1
                        self._cond.notify_all()
        except BaseException as exc:
            self._fail(exc)

    def _hash(self) -> None:
        renice_current_thread(10)
        h = hashlib.sha256()
        data = self._src.data
        for lo in range(0, data.shape[0], 32 << 20):
            if self._stop:
                return
            hi = min(data.shape[0], lo + (32 << 20))
            with span("input sha256", bytes=hi - lo):
                h.update(data[lo:hi])
        self._sha_hex = h.hexdigest()

    def filled(self) -> int:
        with self._cond:
            return self._filled

    def wait_until(self, pos: int) -> None:
        """Block until ``pos`` bytes are inflated; raise the inflate's error
        once there is one, wherever ``pos`` lies, as the buffer will never
        fill."""
        with self._cond:
            if self._filled < pos and self._exc is None:
                with span("inflate wait"):
                    while self._filled < pos and self._exc is None:
                        self._cond.wait()
            if self._exc is not None:
                raise self._exc

    def input_checksum(self) -> str:
        self._hasher.join()
        if self._sha_hex is None:
            raise RuntimeError(f"{self._path}: input hash thread died")
        return self._sha_hex

    def release(self) -> None:
        """Stop the inflate threads and the hasher (each ends at its next
        run or piece), then give the buffer back; ``buf`` is not to be read
        after this. A second call does nothing."""
        if self.buf is None:
            return
        with self._cond:
            self._stop = True
        for t in self._inflaters:
            t.join()
        self._hasher.join()
        if self._pinned is not None:
            import torch

            torch.cuda.synchronize(self._card)  # no copy from the buffer in flight
            PINNED.give_back()
            self._pinned = None
        self.buf = self._src = None


def iter_segments_streaming(
    stream: "StreamingInput | BgzfInput", target: int, wait_slack: int = 8 << 20
) -> Iterator[Tuple[int, int]]:
    """Yield (lo, hi) record-aligned segment bounds, chasing the reader (or
    the inflate); the same bounds as :func:`segment_record_bounds` on the
    whole buffer.

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
