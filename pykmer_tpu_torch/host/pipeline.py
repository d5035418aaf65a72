"""The pipelined chunk producers: input and decode overlap upload and device work.

:func:`iter_pipelined_chunks` is the port of ``_iter_pipelined_chunks``
(``pykmer_tpu/index/indexer.py``). A producer thread decodes record-aligned
segments of the raw input with the native decoder, up to two segments ahead
of the consumer, which turns each decoded segment into packed device chunks.
With a :class:`StreamingInput` (or a :class:`BgzfInput`) the disk read (or
the inflate) overlaps too: segment bounds are found as bytes arrive, and the
wait happens on the producer, never on the dispatch thread.

:func:`iter_card_chunks` decodes on the card instead, for a streaming input
whose buffer is page-locked: the producer thread only finds the segment
bounds as the reader fills the buffer, and the dispatch thread copies each
segment's raw bytes to the card, where ``ops/fasta.decode_packed`` writes the
upload planes; the chunks are views of those planes on the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Tuple, TypeVar, Union

import numpy as np

from ..utils import renice_current_thread
from ..utils.profiling import carry, span

from .chunks import (chunk_stream, frame_prepacked, iter_chunks_packed_lazy,
                     iter_chunks_prepacked)
from .segments import (BgzfInput, StreamingInput, iter_segments_streaming,
                       segment_record_bounds)

TARGET_SEGMENT = 192 << 20  # raw bytes per steady-state segment
QUEUE_DEPTH = 2  # produced segments held ahead of the consumer

T = TypeVar("T")


def _ahead(produce: Callable[[], Optional[T]], name: str) -> Iterator[T]:
    """Yield what ``produce`` returns, called on a background thread (named
    ``name``, at nice 10) up to ``QUEUE_DEPTH`` items ahead, until it
    returns None. The consumer's wait is the span "decode queue wait". An
    error of ``produce`` is re-raised here, on the consumer's thread; a
    consumer that stops early stops the producer."""
    q: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
    dead = threading.Event()  # the consumer is gone: stop the producer

    def put(item) -> bool:
        while not dead.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                pass
        return False

    def producer() -> None:
        renice_current_thread(10)  # the producer has slack; dispatch does not
        try:
            while True:
                nxt = produce()
                if not put(("ok", nxt)) or nxt is None:
                    return
        except BaseException as exc:  # re-raised on the consumer's thread
            put(("err", exc))

    # the producer's spans nest under the span open here
    prod = threading.Thread(target=carry(producer), daemon=True, name=name)
    prod.start()
    try:
        while True:
            with span("decode queue wait"):
                status, nxt = q.get()
            if status == "err":
                raise nxt
            if nxt is None:
                prod.join()
                return
            yield nxt
    finally:
        dead.set()  # abandoned mid-iteration: let the producer exit


def iter_pipelined_chunks(
    data: Union[bytes, np.ndarray, StreamingInput, BgzfInput],
    kmer_len: int,
    chunk_windows: int,
    sink: dict,
    target_segment: int = TARGET_SEGMENT,
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Yield (bases2, maskbits-or-None) chunks of ``data`` while the next
    segments decode on a background thread.

    ``sink`` receives "chromosomes" (list) and "total_bp" (int), complete once
    the generator is exhausted. A decode error is re-raised here, on the
    consumer's thread; a consumer that stops early stops the producer. Needs
    the native library (``io/native.py``)."""
    from ..io import native

    if isinstance(data, (StreamingInput, BgzfInput)):
        buf = data.buf
        seg_iter = iter_segments_streaming(data, target_segment)
    else:
        buf = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
        seg_iter = iter(segment_record_bounds(buf, target_segment))
    headroom = chunk_windows + kmer_len

    def decode_next():
        seg = next(seg_iter, None)  # streaming: may block for disk bytes
        if seg is None:
            return None
        lo, hi = seg
        with span("decode", bytes=hi - lo) as counts:
            # the packed decode writes the upload planes directly, so the
            # consumer does no packing: its chunks are views
            res = native.fasta_decode_joined_packed_native(
                buf[lo:hi], kmer_len, threads=2, tail_headroom=headroom + 8)
            if res is not None:
                counts["bases"] = res[4]
                return ("packed", res)
            res = native.fasta_decode_joined_native(
                buf[lo:hi], kmer_len, threads=2, tail_headroom=headroom)
            counts["bases"] = res[2]
            return ("codes", res)

    sink["chromosomes"] = []
    sink["total_bp"] = 0
    for kind, res in _ahead(decode_next, "decode"):
        if kind == "packed":
            bases, mask, n_codes, chroms, bp = res
            sink["chromosomes"].extend(chroms)
            sink["total_bp"] += bp
            if n_codes >= kmer_len:
                yield from iter_chunks_prepacked(
                    bases, mask, n_codes, kmer_len, chunk_windows)
            del bases, mask
        else:
            stream, chroms, bp = res
            sink["chromosomes"].extend(chroms)
            sink["total_bp"] += bp
            if stream.shape[0] >= kmer_len:
                padded, n_chunks = chunk_stream(stream, kmer_len, chunk_windows)
                yield from iter_chunks_packed_lazy(
                    padded, kmer_len, chunk_windows, n_chunks)
                del padded
            del stream
        del res


def iter_card_chunks(
    data: Union[StreamingInput, BgzfInput],
    kmer_len: int,
    chunk_windows: int,
    sink: dict,
    device,
    target_segment: int = TARGET_SEGMENT,
):
    """Yield (bases2, maskbits) chunks of ``data`` as views of upload
    planes decoded on ``device`` (``ops/fasta.decode_packed``), segment by
    segment as the reader fills the buffer; every chunk carries its mask
    (the encoder's masked entry gives an all-valid chunk the codes of its
    all-valid entry).

    Each segment is one copy of its raw bytes to the device (asynchronous
    where the buffer is page-locked) and one decode, the span "card
    decode" (counts: raw ``bytes``, ``records``); the decode waits once for
    the segment's totals. ``sink`` receives "chromosomes" and "total_bp"
    once the generator is exhausted, equal to the host decode's: the
    records' lengths and flags come back in one copy at the end, and their
    names are read from the host buffer at the offsets the device found."""
    import torch

    from ..ops.fasta import decode_packed

    seg_iter = iter_segments_streaming(data, target_segment)
    tail_headroom = chunk_windows + kmer_len + 8
    found = []  # per segment: (name offsets in the input, lengths, seq_len, has_valid)
    for lo, hi in _ahead(lambda: next(seg_iter, None), "segments"):
        with span("card decode", bytes=hi - lo) as counts:
            raw = torch.from_numpy(data.buf[lo:hi]).to(device, non_blocking=True)
            dec = decode_packed(raw, kmer_len, tail_headroom=tail_headroom)
            counts["records"] = dec.name_off.shape[0]
        found.append(torch.stack([dec.name_off + lo, dec.name_len, dec.seq_len,
                                  dec.has_valid.to(torch.int64)]))
        if dec.n_codes >= kmer_len:
            yield from frame_prepacked(dec.bases, dec.mask, dec.n_codes, kmer_len,
                                       chunk_windows)
        del raw, dec
    table = torch.cat(found, 1).cpu().numpy() if found else np.zeros((4, 0), np.int64)
    off, length, seq_len, has_valid = table
    sink["chromosomes"] = [
        (data.buf[o : o + n].tobytes().decode(errors="replace"), int(s))
        for o, n, s, v in zip(off, length, seq_len, has_valid) if v
    ]
    sink["total_bp"] = int(seq_len.sum())
