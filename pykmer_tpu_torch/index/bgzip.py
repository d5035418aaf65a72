"""The index's bgzip output: the finished `.kin` written again as
`.kin.bgz` with its `.gzi`, the files htslib's ``bgzip -i`` makes.

The `.kin` goes in runs of whole 65,280-byte blocks to a deflate at zlib
level 6, and the dispatch thread writes the members in file order, then the
28-byte EOF block, and the `.gzi` (the count, then a (compressed,
uncompressed) offset pair for every block but the first). Where the index's
plane is on a card, the card deflates (``ops/deflate.deflate_bgzf``, the
kernels of ``csrc/deflate.cu``) on one thread, runs of ``CARD_RUN_BLOCKS``,
each run's bytes unfolded again from the plane where the finish holds it as
one tensor (``ops/unfold``), else read back from the file; elsewhere the
file is read back by O_DIRECT in runs of ``RUN_BLOCKS`` and deflated on a
pool of one thread a core the process may run on, through the native block
codec (ctypes releases the GIL). Both files are written under temporary
names and renamed into place once whole, so a file that exists under its
final name is finished. The bytes are ``io/bgzf.bgzip_kin``'s.

Spans: "kin read" (bytes), each read of the `.kin` (none where the card
unfolds the plane); "bgzf deflate", one run, with ``blocks``, ``bytes``
(in) and ``bytes_out``, on the pool's threads ("bgzf-deflate_<i>") or on
"bgzf-deflate_card" with ``card_blocks`` (= ``blocks``); "bgzf write"
(bytes), each write of the `.kin.bgz`.
"""

from __future__ import annotations

import collections
import contextlib
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..host.segments import PINNED_OUT
from ..io.bgzf import BGZF_BLOCK_SIZE, BGZF_EOF, write_gzi
from ..io.direct import DirectReader, DirectWriter
from ..ops.deflate import host_members
from ..utils.bigmem import big_empty
from ..utils.profiling import carry, span

# blocks a deflate task of the host pool takes: 64 blocks start at
# 4096-aligned offsets of the file (65,280 x 16 is), so the runs read by
# O_DIRECT
RUN_BLOCKS = 64
RUNS_AHEAD = 2  # runs read ahead of the write, for each deflate thread
# blocks a run of the card: the most within 64 MiB that keeps a run a whole
# number of 16 blocks, so that a run read back by O_DIRECT starts aligned
CARD_RUN_BLOCKS = 1024
WRITE_BYTES = 8 << 20  # the compressed bytes gathered for one write
_deflate = host_members  # the host pool's codec


def deflate_threads() -> int:
    """The deflate pool's size: one thread for each CPU the process may run
    on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


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


def _host_deflate(kin: str, size: int, out: _StagedWriter) -> List[np.ndarray]:
    """The host's route: runs of ``RUN_BLOCKS`` read back by O_DIRECT and
    deflated on a pool of :func:`deflate_threads` threads, written in file
    order; returns each run's member sizes."""
    run_bytes = RUN_BLOCKS * BGZF_BLOCK_SIZE
    threads = deflate_threads()
    depth = RUNS_AHEAD * threads
    slots = big_empty(depth * run_bytes)
    sizes: List[np.ndarray] = []
    with DirectReader(kin) as reader, \
            ThreadPoolExecutor(threads, thread_name_prefix="bgzf-deflate") as pool:
        pending: collections.deque = collections.deque()

        def write_oldest() -> None:
            data, block_sizes = pending.popleft().result()
            out.write(data)
            sizes.append(block_sizes)

        deflate = carry(_deflate_run)
        try:
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
        finally:
            for fut in pending:
                fut.cancel()
    return sizes


def _card_deflate(kin: str, size: int, out: _StagedWriter, device: torch.device,
                  plane: Optional[torch.Tensor]) -> List[np.ndarray]:
    """The card's route: runs of ``CARD_RUN_BLOCKS`` deflated on ``device``
    (``ops/deflate.deflate_bgzf``) by the thread "bgzf-deflate_card", each
    run's bytes unfolded from ``plane`` (the whole folded plane of the
    4^K-byte `.kin`, a CUDA tensor) or, without one, read back from ``kin``
    by O_DIRECT and copied in; each run's members come back into one of two
    page-locked slots, which this thread writes in file order while the card
    deflates the next run. Returns each run's member sizes."""
    from ..ops import deflate as card, unfold

    kmer_len = (size.bit_length() - 1) // 2  # the .kin holds 4^K bytes
    run_bytes = CARD_RUN_BLOCKS * BGZF_BLOCK_SIZE
    runs = [(a, min(size, a + run_bytes)) for a in range(0, size, run_bytes)]
    slot_bytes = CARD_RUN_BLOCKS * card.MEMBER_MAX
    need = 2 * slot_bytes + (run_bytes if plane is None else 0)
    pinned = PINNED_OUT.try_lease(need)
    host = big_empty(need) if pinned is None else pinned.array[:need]
    free: queue.Queue = queue.Queue()
    done: queue.Queue = queue.Queue()
    for slot in (0, 1):
        free.put(slot)
    stop = threading.Event()

    def deflate_runs() -> None:
        try:
            with contextlib.ExitStack() as held, torch.cuda.device(device):
                reader = held.enter_context(DirectReader(kin)) if plane is None else None
                for a, b in runs:
                    slot = free.get()
                    if stop.is_set():
                        return
                    if reader is not None:
                        staged = host[2 * slot_bytes:][: b - a]
                        with span("kin read", bytes=b - a):
                            if reader.pread_into(staged, a) != b - a:
                                raise IOError(f"short read of {kin} at {a}")
                        data = torch.from_numpy(staged).to(device)
                    else:
                        data = unfold.unfold_file(plane, 0, kmer_len, a, b)
                    blocks = -(-(b - a) // BGZF_BLOCK_SIZE)
                    with span("bgzf deflate", blocks=blocks, bytes=b - a,
                              card_blocks=blocks) as counts:
                        members, sizes = card.deflate_bgzf(data)
                        sizes = sizes.cpu().numpy()  # waits for the kernels
                        total = int(sizes.sum())
                        got = host[slot * slot_bytes:][:total]
                        torch.from_numpy(got).copy_(members[:total])
                        counts["bytes_out"] = total
                    done.put((slot, got, sizes))
        except BaseException as exc:
            done.put(exc)

    worker = threading.Thread(target=carry(deflate_runs), name="bgzf-deflate_card",
                              daemon=True)
    sizes: List[np.ndarray] = []
    try:
        worker.start()
        for _ in runs:
            item = done.get()
            if isinstance(item, BaseException):
                raise item
            slot, data, run_sizes = item
            out.write(data)
            sizes.append(run_sizes)
            free.put(slot)
    finally:
        stop.set()
        free.put(0)  # wakes a worker waiting for a slot
        if worker.ident is not None:
            worker.join()
        if pinned is not None:
            PINNED_OUT.give_back()
    return sizes


def write_bgzip(kin: str, size: int, device: Optional[torch.device] = None,
                plane: Optional[torch.Tensor] = None) -> Tuple[str, str]:
    """Write ``kin`` (``size`` bytes) as ``kin``.bgz and its ``.gzi``;
    returns their paths. On a CUDA ``device`` the card deflates (from
    ``plane``, the `.kin`'s whole folded plane as one CUDA tensor, where the
    finish holds one; else from the file read back), elsewhere the host's
    zlib pool. A failure raises and leaves neither file, nor a
    temporary."""
    bgz, gzi = kin + ".bgz", kin + ".bgz.gzi"
    tmp_bgz, tmp_gzi = bgz + ".tmp", gzi + ".tmp"
    try:
        out = _StagedWriter(tmp_bgz)
        try:
            if device is not None and device.type == "cuda":
                sizes = _card_deflate(kin, size, out, device, plane)
            else:
                sizes = _host_deflate(kin, size, out)
            out.write(np.frombuffer(BGZF_EOF, dtype=np.uint8))
            out.finish()
        finally:
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
