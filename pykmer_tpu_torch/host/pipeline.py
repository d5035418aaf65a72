"""The pipelined chunk producer: decode overlaps upload and device work.

Port of ``_iter_pipelined_chunks`` (``pykmer_tpu/index/indexer.py``). A
producer thread decodes record-aligned segments of the raw input with the
native decoder, up to two segments ahead of the consumer, which turns each
decoded segment into packed device chunks. With a :class:`StreamingInput`
the disk read overlaps too: segment bounds are found as bytes arrive, and the
wait happens on the producer, never on the dispatch thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple, Union

import numpy as np

from ..utils import renice_current_thread
from ..utils.profiling import carry, span

from .chunks import chunk_stream, iter_chunks_packed_lazy, iter_chunks_prepacked
from .segments import StreamingInput, iter_segments_streaming, segment_record_bounds

TARGET_SEGMENT = 192 << 20  # raw bytes per steady-state segment
QUEUE_DEPTH = 2  # decoded segments held ahead of the consumer


def iter_pipelined_chunks(
    data: Union[bytes, np.ndarray, StreamingInput],
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

    if isinstance(data, StreamingInput):
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
        renice_current_thread(10)  # decode has slack; dispatch does not
        try:
            while True:
                nxt = decode_next()
                if not put(("ok", nxt)) or nxt is None:
                    return
        except BaseException as exc:  # re-raised on the consumer's thread
            put(("err", exc))

    # the producer's spans nest under the span open here
    prod = threading.Thread(target=carry(producer), daemon=True, name="decode")
    prod.start()
    try:
        while True:
            with span("decode queue wait"):
                status, nxt = q.get()
            if status == "err":
                raise nxt
            if nxt is None:
                prod.join()
                break
            kind, res = nxt
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
    finally:
        dead.set()  # abandoned mid-iteration: let the producer exit
