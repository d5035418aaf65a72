"""Device→host tail of the index path: the chased readback, in every mode.

:func:`stream_plane_to_out` reads the flat folded plane back in fixed-size
slices and unfolds each into the full 4^K host array while the next slice is
in flight; a :class:`ChaseSink` writes each finished region and its mirror to
the `.kin` and advances the output sha256 behind the unfold. So the copy, the
unfold, the write and the hash overlap, and host memory holds the 4^K output
plus two slices, never a second whole-plane copy. A raw plane on the card
unfolds there instead (``ops/unfold``, ``csrc/unfold.cu``), in file order:
each slice of the file reaches the host final, and the sink writes and
hashes it once, so the sha256 chases the whole file.

Its ``mode`` says what crosses the link (``ops/packing.py`` holds the device
ops and the choice, ``pick_mode``):

- "raw": the cells themselves. The plane may also come as the S local planes
  of a sharded run (``parallel/histogram.py``): folded cell w is
  ``shards[w % S][w // S]``, so each output slice [a, b) (a, b multiples of
  S) is assembled as ``stack(shard[a/S : b/S] for shard in shards,
  dim=1).reshape(-1)`` on the first shard's device.
- "2bit", "3bit", "packed": each slice packed on the device to 2, 3 or 4 bits
  a cell, clipped at an escape marker (3, 7, 15). The host scans the packed
  slice for markers, gathers their true values from the plane, and unfolds
  straight from the packed bytes; the markers are patched before the slice's
  region reaches the sink.
- "sparse": each 2^28-cell segment compacted on the device to one token a
  nonzero cell (``packing.pack_sparse_segment``); the host decodes the tokens
  into the segment's two unfolded ranges. A segment denser than the ~20%
  token cap reads back through the 2-bit plane instead, and the stage
  table counts it.

:func:`stream_sparse_pieces` is the arena-free tail for a plane of more than
2^30 cells (K >= 17): each segment decodes into two piece buffers that are
written and hashed directly, so the 4^K host array never exists; the mirror
half is hashed by reading the written file back.

Both sinks take the index's verifier (``index/verify.FileVerifier``) and
start it once the file's writes have landed, so the verify's re-read of the
file runs beside the hash that paces the tail.

:func:`plane_to_host` copies the folded plane (or the interleave) into a host
array through the same slices, for the multi-host build's combine;
:func:`fetch_dense` does so in any mode.

Port of ``pykmer_tpu/ops/readback.py`` (``_ChaseSink``, ``unfold_range``,
``stream_dense_to_out``, ``_stream_sparse``, ``_PieceSink``,
``stream_sparse_planes_pieces``, ``fetch_dense``). The JAX package's TPU
glue is not ported: fixed gather shapes and fetch grains (here exact
prefixes), the sub-plane walk (the port's plane is flat), the tunnel's
multi-threaded fetch and the keepalive.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..formats.header import fast_counts256
from ..host.segments import PINNED_OUT
from ..io.direct import DirectReader, pread_into_mt
from ..utils.bigmem import big_empty
from ..utils.profiling import StageTimer, carry, span
from . import packing, unfold

SLICE_CELLS = 64 << 20  # folded cells per device-to-host slice
# the largest `.kin` that lands in the process's page-locked output (the
# K=15 file): a larger one would lock 16 GiB or more of host memory for
# the life of the process, and lands in pageable memory
PINNED_OUT_MAX = 1 << 30
UNFOLD_THREADS = 4  # host threads that unfold one slice (native, GIL-free)
WRITE_THREADS = 2
DECODE_THREADS = 4  # host threads that decode sparse segments
# True: a sparse segment decodes on the host while the next one packs and
# copies; False serialises them (the JAX package's PYKMER_TPU_SPARSE_OVERLAP)
SPARSE_OVERLAP = True
PIECES_IN_FLIGHT = 4  # decoded sparse pieces (2 x 256 MiB each) not yet written
MIRROR_READ_CELLS = 256 << 20  # bytes per read of the pieces tail's mirror re-read


def _rc_codes_np(u: np.ndarray, kmer_len: int) -> np.ndarray:
    """Vectorised reverse-complement of K 2-bit symbol codes (host numpy)."""
    v = u.astype(np.uint64)
    r = np.zeros_like(v)
    for _ in range(kmer_len):
        r = (r << np.uint64(2)) | (~v & np.uint64(3))
        v = v >> np.uint64(2)
    return r


def _canonical_positions(u: np.ndarray, kmer_len: int) -> np.ndarray:
    """Where folded cells ``u`` land in the unfolded 4^K array: u itself
    where it is canonical, else its mirror 4^K - 1 - u."""
    u = u.astype(np.uint64)
    return np.where(u <= _rc_codes_np(u, kmer_len), u, np.uint64(4**kmer_len - 1) - u)


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


def unfold_piece(
    folded_piece: np.ndarray, kmer_len: int, g0: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Expand folded cells [g0, g0+n) WITHOUT the full 4^K output buffer.

    Returns (primary, mirror, mirror_offset): the piece's two contiguous
    unfolded regions — primary belongs at offset ``g0``, mirror at
    ``mirror_offset = 4^K - g0 - n``. The multi-host writer pwrites each
    host's owner pieces directly into the shared output file, so no host
    materialises the whole plane (index/multihost).

    Copy of ``pykmer_tpu/ops/readback.py::unfold_piece``."""
    n = folded_piece.shape[0]
    size = 4**kmer_len
    m = size - 1
    assert g0 + n <= size // 2
    primary = np.empty(n, dtype=np.uint8)
    mirror = np.empty(n, dtype=np.uint8)
    try:
        from ..io.native import unfold_canonical_piece_native

        unfold_canonical_piece_native(
            np.ascontiguousarray(folded_piece), primary, mirror, kmer_len, g0
        )
        return primary, mirror, size - g0 - n
    except ImportError:
        pass
    block = 1 << 22
    for blo in range(0, n, block):
        bhi = min(n, blo + block)
        u = np.arange(g0 + blo, g0 + bhi, dtype=np.uint64)
        canon = u <= _rc_codes_np(u, kmer_len)
        vals = folded_piece[blo:bhi]
        primary[blo:bhi] = np.where(canon, vals, 0)
        # mirror cells [m-(g0+bhi-1), m-(g0+blo)] in descending-u order →
        # positions [n-bhi, n-blo) of the mirror buffer
        mirror[n - bhi : n - blo] = np.where(canon, 0, vals)[::-1]
    return primary, mirror, size - g0 - n


def unpack(packed: np.ndarray, width: int, out: Optional[np.ndarray] = None) -> np.ndarray:
    """A fixed-width packed plane (``packing.PACKS[width]``'s layout) back to
    one uint8 a cell, into ``out`` (uint8[8 * len / width]) or a new array.
    Native threaded pass, with numpy where the native library is absent."""
    flat = np.ascontiguousarray(packed).reshape(-1)
    if out is None:
        out = big_empty(flat.shape[0] * 8 // width)
    try:
        from ..io.native import unpack_2bit_native, unpack_3bit_native, unpack_4bit_native

        {2: unpack_2bit_native, 3: unpack_3bit_native, 4: unpack_4bit_native}[width](flat, out)
        return out
    except ImportError:
        pass
    if width == 3:
        g = flat.reshape(-1, 3).astype(np.uint32)
        word = g[:, 0] | (g[:, 1] << 8) | (g[:, 2] << 16)
        cells = out.reshape(-1, 8)
        for i in range(8):
            cells[:, i] = (word >> (3 * i)) & 7
    else:
        per = 8 // width
        shifts = np.arange(0, 8, width, dtype=np.uint8)
        np.right_shift(flat[:, None], shifts, out=out.reshape(-1, per))
        out &= (1 << width) - 1
    return out


def _patch_counts(counts: np.ndarray, vals: np.ndarray, escape: int) -> np.ndarray:
    """256-bin counts in which ``vals``' cells were counted as ``escape``
    markers, moved to their true values."""
    counts[escape] -= vals.shape[0]
    counts += np.bincount(vals, minlength=256)
    return counts


class ChaseSink:
    """Write + sha256 chasing the finished regions of the unfolded plane.

    ``region_done(lo, hi)`` takes ascending ranges of ``out`` as they become
    final, from one thread. It queues each for the background writers
    (``fd`` may be None: no file) and for the hasher thread, which advances
    the sha256 frontier through ``out`` in order. Where ``mirrored`` (the
    host unfold's layout) the ranges are first-half cell ranges, each also
    final in its mirror, which is written beside it; the second half
    completes in reverse region order, so :meth:`finish` hashes it as one
    pass: the only serial remainder. Otherwise (the card's unfold, in file
    order) the ranges ascend through the whole of ``out``, each written once
    and hashed as it comes, and nothing remains to hash after them."""

    def __init__(self, out: np.ndarray, fd=None, mirrored: bool = True):
        self.out = out
        self.fd = fd
        self.full = out.shape[0]
        self.mirrored = mirrored
        self.end = self.full // 2 if mirrored else self.full
        self.h = hashlib.sha256()
        self.writers = ThreadPoolExecutor(WRITE_THREADS, thread_name_prefix="chase-write") \
            if fd is not None else None
        # one worker: updates stay in order
        self.hasher = ThreadPoolExecutor(1, thread_name_prefix="chase-hash")
        self._futs: List = []
        self.expected = 0

    def region_done(self, lo: int, hi: int) -> None:
        if hi <= lo:
            return
        if lo != self.expected:
            raise ValueError(f"region [{lo}, {hi}) out of order; expected {self.expected}")
        if self.writers is not None:
            full = self.full
            write = carry(_spanned_pwrite)
            self._futs.append(self.writers.submit(write, self.fd, self.out[lo:hi], lo))
            if self.mirrored:
                self._futs.append(self.writers.submit(
                    write, self.fd, self.out[full - hi : full - lo], full - hi))
        self._futs.append(self.hasher.submit(carry(_spanned_update), self.h, self.out[lo:hi]))
        self.expected = hi

    def finish(self, verifier=None) -> str:
        """Wait for every write (re-raising a failure) and return the sha256
        of the whole of ``out``. A ``verifier`` (``index/verify.FileVerifier``)
        starts reading the whole file back once the writes have landed, while
        the hash drains."""
        if self.expected != self.end:
            raise ValueError(f"regions end at {self.expected}, not {self.end}")
        if self.mirrored:
            self._futs.append(self.hasher.submit(carry(_spanned_update), self.h,
                                                 self.out[self.full // 2 :]))
        if self.writers is not None:
            with span("write drain wait"):
                self.writers.shutdown(wait=True)
        if verifier is not None:
            verifier.start([(0, self.full)])
        with span("hash drain wait"):
            self.hasher.shutdown(wait=True)
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


class PieceSink:
    """pwrite + sha256 for the arena-free pieces tail.

    ``piece_done(lo, hi, primary, mirror)`` takes the two unfolded buffers of
    one first-half range [lo, hi), in ascending order from one thread:
    primary belongs at file offset ``lo``, mirror at ``full - hi``. It queues
    both writes and the primary's hash update (one hasher thread, so the
    updates stay in order); the futures keep the buffers alive until they
    land, and at most ``PIECES_IN_FLIGHT`` pieces are queued (a wait for the
    oldest is a "piece queue wait" span). The second half's file order is
    the reverse of completion order, so :meth:`finish` hashes it by reading
    the written file back, reading each chunk (a "mirror read" span, on the
    reader's thread) while the one before it is hashed. A verifier given to
    :meth:`finish` reads the first half back itself and counts the second
    half's chunks as they are read."""

    def __init__(self, fd, path: str, full: int):
        self.fd = fd
        self.path = path
        self.full = full
        self.h = hashlib.sha256()
        self.writers = ThreadPoolExecutor(WRITE_THREADS, thread_name_prefix="piece-write")
        self.hasher = ThreadPoolExecutor(1, thread_name_prefix="piece-hash")
        self._pieces: collections.deque = collections.deque()
        self.expected = 0

    def piece_done(self, lo: int, hi: int, primary: np.ndarray, mirror: np.ndarray) -> None:
        if lo != self.expected:
            raise ValueError(f"piece [{lo}, {hi}) out of order; expected {self.expected}")
        n = hi - lo
        write = carry(_spanned_pwrite)
        self._pieces.append([
            self.writers.submit(write, self.fd, primary[:n], lo),
            self.writers.submit(write, self.fd, mirror[:n], self.full - hi),
            self.hasher.submit(carry(_spanned_update), self.h, primary[:n]),
        ])
        self.expected = hi
        if len(self._pieces) > PIECES_IN_FLIGHT:
            with span("piece queue wait"):
                while len(self._pieces) > PIECES_IN_FLIGHT:
                    for f in self._pieces.popleft():
                        f.result()

    def finish(self, verifier=None) -> str:
        """Wait for every write (re-raising a failure), then hash the second
        half from the file; returns the sha256 of the whole file. A
        ``verifier`` (``index/verify.FileVerifier``) starts reading the first
        half back once the writes have landed, and counts each chunk of the
        second half after it is read and before it is hashed."""
        half = self.full // 2
        if self.expected != half:
            raise ValueError(f"pieces end at {self.expected}, not {half}")
        self.writers.shutdown(wait=True)
        if verifier is not None:
            verifier.start([(0, half)])
        self.hasher.shutdown(wait=True)
        while self._pieces:
            for f in self._pieces.popleft():
                f.result()
        bounds = _slice_bounds(half, MIRROR_READ_CELLS)
        bufs = [big_empty(min(MIRROR_READ_CELLS, half)) for _ in range(2)]
        with DirectReader(self.path) as reader, ThreadPoolExecutor(1) as pre:

            @carry
            def read(i: int) -> np.ndarray:
                lo, hi = bounds[i]
                buf = bufs[i % 2][: hi - lo]
                with span("mirror read", bytes=hi - lo):
                    if pread_into_mt(reader, buf, half + lo) != hi - lo:
                        raise OSError(f"short read of {self.path} at {half + lo}")
                if verifier is not None:
                    verifier.count(buf, half + lo)
                return buf

            nxt = pre.submit(read, 0)
            for i in range(len(bounds)):
                buf = nxt.result()
                if i + 1 < len(bounds):
                    nxt = pre.submit(read, i + 1)
                _spanned_update(self.h, buf)
        return self.h.hexdigest()

    def abort(self) -> None:
        """Drain the writers and the hasher (before the caller closes ``fd``,
        as :meth:`ChaseSink.abort`)."""
        self.writers.shutdown(wait=True)
        self.hasher.shutdown(wait=True)


def _spanned_pwrite(fd, arr: np.ndarray, offset: int) -> None:
    """:func:`pwrite_all` as a "pwrite" span of its bytes."""
    with span("pwrite", bytes=arr.nbytes):
        pwrite_all(fd, arr, offset)


def _spanned_update(h, arr: np.ndarray) -> None:
    """``h.update(arr)`` as a "sha256" span of its bytes."""
    with span("sha256", bytes=arr.nbytes):
        h.update(arr)


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


def _cells(lo: int, hi: int) -> int:
    return hi - lo


def _cuda_slices(
    view: Callable[[int, int], torch.Tensor], dev: torch.device,
    bounds: List[Tuple[int, int]], out_len: Callable[[int, int], int] = _cells,
) -> Iterator[np.ndarray]:
    """Host copies of ``view(lo, hi)`` (``out_len(lo, hi)`` bytes) for each
    bound, in order: two pinned buffers that alternate, filled on a side
    stream of ``dev`` (which also runs ``view``'s own ops, a pack for one),
    so slice i+1 is in flight while the caller unfolds slice i. A buffer is
    refilled only after the caller has asked for the next slice, i.e.
    finished with it."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))  # the plane is final
    width = max(out_len(lo, hi) for lo, hi in bounds)
    bufs = [torch.empty(width, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    ready = [torch.cuda.Event(), torch.cuda.Event()]

    def enqueue(i: int) -> None:
        lo, hi = bounds[i]
        with torch.cuda.stream(side):
            bufs[i % 2][: out_len(lo, hi)].copy_(view(lo, hi), non_blocking=True)
            ready[i % 2].record(side)

    try:
        enqueue(0)
        for i, (lo, hi) in enumerate(bounds):
            if i + 1 < len(bounds):
                enqueue(i + 1)
            with span("d2h wait", bytes=out_len(lo, hi)):
                ready[i % 2].synchronize()
            yield bufs[i % 2].numpy()[: out_len(lo, hi)]
    finally:
        side.synchronize()  # no copy may outlive its buffer


def _host_slices(
    view: Callable[[int, int], torch.Tensor], dev: torch.device,
    bounds: List[Tuple[int, int]], out_len: Callable[[int, int], int] = _cells,
) -> Iterator[np.ndarray]:
    """``view(lo, hi)`` for each bound as a host array: through
    :func:`_cuda_slices` on the card, in place on the CPU."""
    if dev.type == "cpu":
        return (view(lo, hi).numpy() for lo, hi in bounds)
    if dev.type == "cuda":
        return _cuda_slices(view, dev, bounds, out_len)
    raise ValueError(f"no readback from device {dev}")


def _packed_slices(
    plane: torch.Tensor, width: int, bounds: List[Tuple[int, int]]
) -> Iterator[np.ndarray]:
    """Each [lo, hi) of ``plane`` packed to ``width`` bits a cell on its
    device, as a host array of the packed bytes."""
    pack = packing.PACKS[width]
    return _host_slices(lambda lo, hi: pack(plane[lo:hi]), plane.device, bounds,
                        lambda lo, hi: packing.packed_len(hi - lo, width))


def _unpack_patched(
    plane: torch.Tensor, packed: np.ndarray, width: int, lo: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Folded cells [lo, ...) of ``plane`` from their packed bytes: unpacked,
    each escape marker (found by the native scan of the packed bytes, else
    in the unpacked cells) replaced by the cell's value gathered from the
    plane."""
    folded = unpack(packed, width, out)
    try:
        from ..io.native import scan_escapes_native

        esc = scan_escapes_native(packed, width).astype(np.int64)  # + lo passes 2^32
    except ImportError:
        esc = np.flatnonzero(folded == packing.ESCAPE_OF_WIDTH[width])
    if esc.shape[0]:
        folded[esc] = packing.gather_cells(plane, esc + lo)
    return folded


def fetch_dense(plane: torch.Tensor, mode: str = "auto",
                slice_cells: int = SLICE_CELLS) -> np.ndarray:
    """The flat ``plane`` as a host uint8 array, read back through ``mode``
    ("auto", "raw", "2bit", "3bit", "packed"; "sparse" reads the 2-bit plane,
    as in the JAX package, which has no token decoder into a flat array):
    lossless whatever the mode. Port of
    ``pykmer_tpu/ops/readback.py::fetch_dense``."""
    size = plane.shape[0]
    mode = packing.pick_mode(plane, size, mode)
    width = packing.WIDTHS.get("2bit" if mode == "sparse" else mode)
    out = big_empty(size)
    bounds = _slice_bounds(size, max(8, slice_cells // 8 * 8))
    if width is None:
        slices = _host_slices(lambda lo, hi: plane[lo:hi], plane.device, bounds)
    else:
        slices = _packed_slices(plane, width, bounds)
    try:
        for (lo, hi), host in zip(bounds, slices):
            if width is None:
                out[lo:hi] = host
            else:
                _unpack_patched(plane, host, width, lo, out[lo:hi])
    finally:
        slices.close()
    return out


def stream_plane_to_out(
    plane: Union[torch.Tensor, Sequence[torch.Tensor]],
    kmer_len: int,
    out: np.ndarray,
    fd=None,
    slice_cells: int = SLICE_CELLS,
    stages: Optional[StageTimer] = None,
    mode: str = "raw",
    verifier=None,
) -> Tuple[np.ndarray, str]:
    """Read the flat folded ``plane`` (uint8[4^K/2], on the card or the CPU)
    back in ``mode``, unfold it into ``out`` (uint8[4^K]), write ``out`` to
    ``fd`` (optional) and hash it, each chasing the one before.

    ``mode`` is a concrete mode of ``packing.MODES`` (``packing.pick_mode``
    resolves "auto"). ``plane`` may instead be the S local planes
    (uint8[4^K/2/S] each, S a power of two, on one device type) of a sharded
    run, read as their interleave, raw only. Returns (256-bin counts of the
    folded plane as int64[256], sha256 hex of ``out``), as
    ``stream_dense_to_out(..., hash_out=True)`` does. A CPU plane is read in
    place. ``stages`` receives the slice loop ("copy + unfold", with the
    mode in its name where it is not raw; for "sparse" the segment loop and,
    where segments overflowed the token caps, a "2-bit fallback" entry) and
    what remains after it ("write + hash drain": the writes and hashes still
    queued, then, after a host unfold, the mirror half's hash). A raw plane
    on the card unfolds there, in file order (:func:`_file_order_to_out`).
    A ``verifier``
    (``index/verify.FileVerifier``) reads ``fd``'s file back from the moment
    its writes have landed (:meth:`ChaseSink.finish`)."""
    shards = [plane] if isinstance(plane, torch.Tensor) else list(plane)
    for p in shards:
        if p.dtype != torch.uint8 or p.dim() != 1 or not p.is_contiguous():
            raise ValueError("plane must be a contiguous 1-D uint8 tensor")
    half = sum(p.shape[0] for p in shards)
    if len({p.shape[0] for p in shards}) != 1 or len({p.device.type for p in shards}) != 1:
        raise ValueError("shards must be equal in size and on one device type")
    if 2 * half != 4**kmer_len or out.shape[0] != 2 * half or out.dtype != np.uint8:
        raise ValueError(f"need a 4^{kmer_len}/2-cell plane and a uint8[4^{kmer_len}] out")
    if mode not in packing.MODES:
        raise ValueError(f"unknown readback mode {mode!r}")
    if mode != "raw" and len(shards) > 1:
        raise ValueError("a sharded plane reads back raw")

    stages = stages or StageTimer()
    card = card_unfolds(plane, mode)
    sink = ChaseSink(out, fd, mirrored=not card)
    try:
        if mode == "sparse":
            counts = _sparse_to_out(shards[0], kmer_len, out, sink, stages)
        else:
            with stages.stage("copy + unfold" if mode == "raw" else f"copy + unfold ({mode})"):
                counts = _file_order_to_out(shards, kmer_len, out, sink, slice_cells) if card \
                    else _slices_to_out(shards, kmer_len, out, sink, slice_cells, mode)
        with stages.stage("write + hash drain"):
            return counts, sink.finish(verifier)
    except BaseException:
        sink.abort()
        raise


def _slices_to_out(
    shards: List[torch.Tensor], kmer_len: int, out: np.ndarray, sink: ChaseSink,
    slice_cells: int, mode: str,
) -> np.ndarray:
    """The slice loop of :func:`stream_plane_to_out` for "raw" and the fixed
    widths: each slice unfolded on ``UNFOLD_THREADS`` threads while the next
    is in flight, then handed to ``sink``. Returns the 256-bin counts."""
    half = sum(p.shape[0] for p in shards)
    width = packing.WIDTHS.get(mode)
    plane = shards[0]
    if width is None:
        bounds = _slice_bounds(half, slice_cells)
        view = (lambda lo, hi: plane[lo:hi]) if len(shards) == 1 else _interleaved(shards)
        slices = _host_slices(view, plane.device, bounds)
        fused = None
    else:
        # whole 8-cell groups: the 3-bit pack's unit and the native unpack's
        bounds = _slice_bounds(half, max(8, slice_cells // 8 * 8))
        slices = _packed_slices(plane, width, bounds)
        try:
            from ..io.native import scan_escapes_native, unpack_unfold_native

            fused = (scan_escapes_native, unpack_unfold_native)
        except ImportError:
            fused = None
    counts = np.zeros(256, dtype=np.int64)
    try:
        with ThreadPoolExecutor(UNFOLD_THREADS) as pool:
            for (lo, hi), host in zip(bounds, slices):
                with span("unfold", cells=hi - lo):
                    if fused is not None:
                        counts += _unpack_unfold(plane, host, width, out, kmer_len, lo,
                                                 pool, *fused)
                    else:
                        folded = host if width is None \
                            else _unpack_patched(plane, host, width, lo)
                        counts += _unfold(folded, out, kmer_len, lo, pool)
                sink.region_done(lo, hi)
    finally:
        slices.close()
    return counts


def card_unfolds(plane: Union[torch.Tensor, Sequence[torch.Tensor]], mode: str) -> bool:
    """Whether :func:`stream_plane_to_out` unfolds ``plane`` (or a sharded
    run's local planes) on the card, in file order: a raw plane on CUDA."""
    first = plane if isinstance(plane, torch.Tensor) else plane[0]
    return mode == "raw" and first.device.type == "cuda"


@contextlib.contextmanager
def output_array(plane: Union[torch.Tensor, Sequence[torch.Tensor]], mode: str,
                 size: int, stages: StageTimer) -> Iterator[np.ndarray]:
    """The uint8[``size``] host array that :func:`stream_plane_to_out`
    fills from ``plane`` in ``mode``, for the ``with`` block; taken in
    ``stages``' "output alloc" stage. Where the card unfolds
    (:func:`card_unfolds`) a file of at most ``PINNED_OUT_MAX`` bytes, it is
    the process's page-locked output (``host/segments.PINNED_OUT``,
    registered once and kept), which a 64 MiB slice reaches in ~1.3 ms on an
    H100 host, unless another index holds it. Otherwise it is a fresh
    pageable array, which the card's slices reach ~5x slower."""
    with stages.stage("output alloc"):
        pinned = PINNED_OUT.try_lease(size) \
            if card_unfolds(plane, mode) and size <= PINNED_OUT_MAX else None
        out = big_empty(size) if pinned is None else pinned.array[:size]
    try:
        yield out
    finally:
        if pinned is not None:
            PINNED_OUT.give_back()


def _file_order_to_out(
    shards: List[torch.Tensor], kmer_len: int, out: np.ndarray, sink: ChaseSink,
    slice_cells: int,
) -> np.ndarray:
    """The slice loop of :func:`stream_plane_to_out` for a raw plane on the
    card: the whole file, [0, 4^K), in slices of ``slice_cells`` bytes in
    file order, each unfolded on the device (``ops/unfold``: one launch a
    slice), copied into ``out`` and handed to ``sink`` (a file-order
    :class:`ChaseSink`). The copy waits for the slice: in a page-locked
    ``out`` (:func:`output_array`) a 64 MiB slice lands in ~1.3 ms on an
    H100, far inside the ~60 ms its hash takes, so the hasher never waits
    for the loop. A slice reads the same folded cells as its mirror, so a
    sharded plane's slices stay multiples of S. On a CPU plane the plain
    version runs. Returns the 256-bin counts, which the first half's
    unfolds add up on the device."""
    plane = shards[0]
    full = out.shape[0]
    first = _slice_bounds(full // 2, slice_cells)
    bounds = first + [(full - hi, full - lo) for lo, hi in reversed(first)]
    view = (lambda lo, hi: plane[lo:hi]) if len(shards) == 1 else _interleaved(shards)
    counts = torch.zeros(256, dtype=torch.int64, device=plane.device)
    card = plane.device.type == "cuda"
    for lo, hi in bounds:
        f0, f1 = unfold.folded_range(kmer_len, lo, hi)
        # half the slice's bytes (a slice and its mirror, each once): the
        # cells a host unfold's slice counts
        n = (hi - lo + (hi <= full // 2)) // 2
        with span("unfold", cells=n, card_cells=n if card else 0):
            torch.from_numpy(out[lo:hi]).copy_(
                unfold.unfold_file(view(f0, f1), f0, kmer_len, lo, hi, counts))
        sink.region_done(lo, hi)
    return counts.cpu().numpy()


def _unfold(folded: np.ndarray, out: np.ndarray, kmer_len: int, lo: int,
            pool: ThreadPoolExecutor) -> np.ndarray:
    """Unfold folded cells [lo, lo + len) into ``out`` on ``pool``'s
    threads; returns their 256-bin counts."""
    n = folded.shape[0]
    part = -(-n // UNFOLD_THREADS)
    unfolds = [pool.submit(unfold_range, folded[a : a + part], out, kmer_len, lo + a)
               for a in range(0, n, part)]
    counts = fast_counts256(folded)
    for f in unfolds:
        f.result()
    return counts


def _unpack_unfold(
    plane: torch.Tensor, packed: np.ndarray, width: int, out: np.ndarray,
    kmer_len: int, lo: int, pool: ThreadPoolExecutor, scan, fused,
) -> np.ndarray:
    """One packed slice, folded cells [lo, ...): the native scan finds its
    escape markers, their values are gathered from the plane while
    ``pool``'s threads unfold straight from the packed bytes (native fused
    unpack + unfold + counts), then the markers are patched in ``out``.
    Returns the slice's 256-bin counts."""
    esc = scan(packed, width).astype(np.int64)
    part = -(-packed.shape[0] // UNFOLD_THREADS // width) * width  # whole 8-cell groups
    unfolds = [pool.submit(fused, packed[a : a + part], width, out, kmer_len,
                           lo + a * 8 // width)
               for a in range(0, packed.shape[0], part)]
    vals = packing.gather_cells(plane, esc + lo) if esc.shape[0] else None
    counts = np.zeros(256, dtype=np.int64)
    for f in unfolds:
        counts += f.result()[0]
    if vals is not None:
        out[_canonical_positions(esc + lo, kmer_len)] = vals
        _patch_counts(counts, vals, packing.ESCAPE_OF_WIDTH[width])
    return counts


# --- the sparse token stream --------------------------------------------------


def _segment_reads(plane: torch.Tensor, fallbacks: List[float]) -> Iterator[tuple]:
    """Each ``packing.SPARSE_SEG_CELLS`` segment of the flat plane read back,
    in order: (lo, hi, (tokens, side, escpos, escape values)) as host arrays
    from its token stream, or (lo, hi, folded cells) through the 2-bit plane
    where the segment overflows the token caps (its seconds appended to
    ``fallbacks``)."""
    for lo, hi in _slice_bounds(plane.shape[0], packing.SPARSE_SEG_CELLS):
        seg = plane[lo:hi]
        cap = packing.sparse_cap(hi - lo)
        with span("sparse pack", cells=hi - lo, tokens=0, bytes=0) as counts:
            tok, side, escpos, (n_nz, _, _) = packing.pack_sparse_segment(seg, cap)
            if n_nz <= cap:
                vals = seg[escpos.to(torch.int64)]
                host = tuple(t.cpu().numpy() for t in (tok, side, escpos, vals))
                counts["tokens"] = host[0].shape[0]
                counts["bytes"] = sum(a.nbytes for a in host)
        if n_nz > cap:
            t0 = time.perf_counter()
            with span("2-bit fallback", cells=hi - lo):
                folded = fetch_dense(seg, "2bit")
            fallbacks.append(time.perf_counter() - t0)
            yield lo, hi, folded
        else:
            yield lo, hi, host


def _decode_in_order(
    plane: torch.Tensor, decode: Callable, emit: Callable[..., np.ndarray],
    stages: StageTimer, label: str, wait: str,
) -> np.ndarray:
    """Read each segment of ``plane`` (:func:`_segment_reads`) and run
    ``decode(lo, hi, item)`` on ``DECODE_THREADS`` host threads while the
    next segment packs and copies; ``emit(lo, hi, decoded)`` runs on this
    thread in segment order and returns the segment's 256-bin counts, which
    are summed. ``stages`` receives the loop as ``label`` and the segments
    read through the 2-bit plane as a "2-bit fallback" entry: rows of the
    loop less the fallbacks, and of the fallbacks; its spans are the loop's,
    each segment's "sparse pack" and each fallback's, the decodes' (on the
    pool's threads, under the loop) and each wait for a decode (``wait``)."""
    fallbacks: List[float] = []
    pending: collections.deque = collections.deque()
    counts = np.zeros(256, dtype=np.int64)
    n_segs = 0
    t0 = time.perf_counter()

    def result(fut):
        with span(wait):
            return fut.result()

    with stages.span(label), ThreadPoolExecutor(DECODE_THREADS) as pool:
        try:
            run = carry(decode)
            for lo, hi, item in _segment_reads(plane, fallbacks):
                n_segs += 1
                pending.append((lo, hi, pool.submit(run, lo, hi, item)))
                while pending and (not SPARSE_OVERLAP or pending[0][2].done()
                                   or len(pending) > DECODE_THREADS):
                    lo_, hi_, fut = pending.popleft()
                    counts += emit(lo_, hi_, result(fut))
            while pending:
                lo_, hi_, fut = pending.popleft()
                counts += emit(lo_, hi_, result(fut))
        except BaseException:
            for _, _, fut in pending:
                fut.cancel()
            raise
    fb = sum(fallbacks)
    stages.add(label, time.perf_counter() - t0 - fb)
    if fallbacks:
        stages.add(f"2-bit fallback, {len(fallbacks)} of {n_segs} segs", fb)
    return counts


def _sparse_to_out(plane: torch.Tensor, kmer_len: int, out: np.ndarray,
                   sink: ChaseSink, stages: StageTimer) -> np.ndarray:
    """The "sparse" mode of :func:`stream_plane_to_out`: each segment's
    tokens decode into its two unfolded ranges of ``out`` (native: the ranges
    are zeroed and only the nonzeros written), its escapes are patched, and
    its region goes to ``sink`` in order. Raises ImportError without the
    native decoder, as the JAX package does."""
    from ..io.native import sparse_decode_segment_native

    def decode(lo: int, hi: int, item) -> np.ndarray:
        if isinstance(item, np.ndarray):  # read through the 2-bit plane
            unfold_range(item, out, kmer_len, lo)
            return fast_counts256(item)
        tok, side, escpos, vals = item
        counts = sparse_decode_segment_native(tok, side, out, kmer_len, lo, hi - lo)
        counts[0] += hi - lo - tok.shape[0]
        if escpos.shape[0]:
            out[_canonical_positions(escpos.astype(np.int64) + lo, kmer_len)] = vals
        return _patch_counts(counts, vals, packing.ESCAPE2)

    def emit(lo: int, hi: int, counts: np.ndarray) -> np.ndarray:
        sink.region_done(lo, hi)
        return counts

    return _decode_in_order(plane, decode, emit, stages, "copy + decode (sparse)",
                            "sparse decode wait")


def stream_sparse_pieces(
    plane: torch.Tensor, kmer_len: int, fd, path: str,
    stages: Optional[StageTimer] = None, verifier=None,
) -> Tuple[np.ndarray, str]:
    """Arena-free readback of the flat folded ``plane`` into the file
    ``path`` (open as ``fd``, 4^K bytes): each sparse segment decodes into
    two piece buffers (native), its escapes are patched there, and a
    :class:`PieceSink` writes and hashes them. Host memory holds a few
    pieces, never the 4^K array. A segment denser than the token caps reads
    back through the 2-bit plane and unfolds to pieces. Whether a plane
    takes this tail is ``index/indexer.choose_tail``'s decision (the JAX
    package's gate).

    Returns (counts of the folded plane int64[256], sha256 hex of the
    file). ``stages`` receives the segment loop, any "2-bit fallback", and
    "write drain + mirror hash" (the writes still queued, then the second
    half re-read and hashed); each segment's decode is a "piece decode" span
    on the decode pool, and the loop's wait for it a "piece decode wait". A
    ``verifier`` reads the file back as :meth:`PieceSink.finish` says. Port
    of ``pykmer_tpu/ops/readback.py::stream_sparse_planes_pieces``, over the
    flat plane's segments instead of 2^30-cell sub-planes."""
    size = plane.shape[0]
    if 2 * size != 4**kmer_len:
        raise ValueError(f"need a 4^{kmer_len}/2-cell plane")
    from ..io.native import sparse_decode_segment_piece_native

    stages = stages or StageTimer()

    def decode(lo: int, hi: int, item):
        n = hi - lo
        dense = isinstance(item, np.ndarray)  # read through the 2-bit plane
        with span("piece decode", cells=n, tokens=0 if dense else item[0].shape[0]):
            if dense:
                primary, mirror, _ = unfold_piece(item, kmer_len, lo)
                return fast_counts256(item), primary, mirror
            tok, side, escpos, vals = item
            primary, mirror = big_empty(n), big_empty(n)
            counts = sparse_decode_segment_piece_native(tok, side, primary, mirror,
                                                        kmer_len, lo, n)
            counts[0] += n - tok.shape[0]
            if escpos.shape[0]:
                u = escpos.astype(np.int64) + lo
                canon = u.astype(np.uint64) <= _rc_codes_np(u, kmer_len)
                primary[escpos[canon]] = vals[canon]
                mirror[n - 1 - escpos[~canon]] = vals[~canon]
            return _patch_counts(counts, vals, packing.ESCAPE2), primary, mirror

    sink = PieceSink(fd, path, 2 * size)

    def emit(lo: int, hi: int, decoded) -> np.ndarray:
        counts, primary, mirror = decoded
        sink.piece_done(lo, hi, primary, mirror)
        return counts

    try:
        counts = _decode_in_order(plane, decode, emit, stages, "copy + decode (pieces)",
                                  "piece decode wait")
        with stages.stage("write drain + mirror hash"):
            return counts, sink.finish(verifier)
    except BaseException:
        sink.abort()
        raise


def plane_to_host(
    plane: Union[torch.Tensor, Sequence[torch.Tensor]], slice_cells: int = SLICE_CELLS
) -> np.ndarray:
    """The flat folded ``plane`` (or the interleave of a sharded run's S
    local planes, as in :func:`stream_plane_to_out`) copied into a new host
    array, slice by slice: the multi-host build's partial plane
    (index/multihost), which combines folded."""
    shards = [plane] if isinstance(plane, torch.Tensor) else list(plane)
    half = sum(p.shape[0] for p in shards)
    bounds = _slice_bounds(half, slice_cells)
    view = (lambda lo, hi: shards[0][lo:hi]) if len(shards) == 1 else _interleaved(shards)
    slices = _host_slices(view, shards[0].device, bounds)
    out = big_empty(half)
    try:
        for (lo, hi), part in zip(bounds, slices):
            out[lo:hi] = part
    finally:
        slices.close()
    return out
