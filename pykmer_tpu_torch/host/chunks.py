"""Host-side chunk framing and 2-bit packing (numpy only).

Copies of the numpy helpers in ``pykmer_tpu/ops/encode.py``: that module
imports jax, so the port cannot import them from there. Kept byte-for-byte
equal in behaviour (tests/test_torch_indexer.py holds them against the
originals).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def chunk_stream(
    concat_codes: np.ndarray, kmer_len: int, chunk_windows: int
) -> Tuple[np.ndarray, int]:
    """Host-side framing: pad the concatenated code stream so it splits into
    fixed-size chunks of ``chunk_windows`` window starts with K-1 halo overlap.

    Returns (padded array, number of chunks). Padding uses the invalid code 4,
    so windows that touch padding are dropped on device.
    """
    k = kmer_len
    n = concat_codes.shape[0]
    n_windows = max(n - k + 1, 0)
    n_chunks = max((n_windows + chunk_windows - 1) // chunk_windows, 1)
    need = n_chunks * chunk_windows + k - 1
    if need > n:
        # pad in place when the stream's pooled block has tail capacity
        # (the decode path over-allocates for exactly this)
        from ..utils.bigmem import extend_view

        ext = extend_view(concat_codes, need)
        if ext is None:
            pad = np.full(need - n, 4, dtype=np.uint8)
            concat_codes = np.concatenate([concat_codes, pad])
        else:
            ext[n:need] = 4
            concat_codes = ext
    return concat_codes, n_chunks


def iter_chunks(padded: np.ndarray, kmer_len: int, chunk_windows: int, n_chunks: int):
    """Yield the overlapping device chunks of a padded stream."""
    span = chunk_windows + kmer_len - 1
    for c in range(n_chunks):
        start = c * chunk_windows
        yield padded[start : start + span]


def pack_base_stream(padded: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pack base codes to (2-bit bases, 1-bit validity bitmap) — 0.375
    bytes/base of host→device upload (vs 1). Invalid codes (>= 4) pack as
    base 0 with validity bit 0; the device restores them to 4. Base ``4j+i``
    is bits [2i, 2i+2) of ``bases[j]``; validity of base ``8j+i`` is bit i of
    ``mask[j]``. Native threaded pass with a numpy fallback. Tail-pads to a
    multiple of 8 with invalid bases (unused by any chunk)."""
    n = padded.shape[0]
    if n % 8:
        padded = np.concatenate([padded, np.full(8 - n % 8, 4, np.uint8)])
    try:
        from ..io.native import pack_base_2bit_mask_native

        # thread spawn/join costs more than the work below ~8 MB
        threads = 8 if padded.shape[0] >= (8 << 20) else 1
        return pack_base_2bit_mask_native(padded, threads=threads)
    except ImportError:
        valid = padded < 4
        b = np.where(valid, padded, 0).reshape(-1, 4)
        bases = (b[:, 0] | (b[:, 1] << 2) | (b[:, 2] << 4) | (b[:, 3] << 6)).astype(
            np.uint8
        )
        mask = np.packbits(valid.reshape(-1, 8), axis=1, bitorder="little")
        return bases, mask.reshape(-1)


def mask_all_valid(mask: np.ndarray, span: int) -> bool:
    """True iff the first ``span`` validity bits are all set — the chunk has
    no Ns, no record separators, no tail padding."""
    full = span // 8
    if full and not (mask[:full] == 0xFF).all():
        return False
    rem = span % 8
    if rem:
        want = (1 << rem) - 1
        return (int(mask[full]) & want) == want
    return True


def iter_chunks_packed(
    packed: Tuple[np.ndarray, np.ndarray],
    kmer_len: int,
    chunk_windows: int,
    n_chunks: int,
):
    """Yield (bases2, maskbits) device chunks: chunk c covers bases
    [c*W, c*W + W + K - 1); W % 8 == 0 keeps every chunk start aligned in
    both planes, and the final partial bytes exist because chunk_stream pads
    to exactly W*n_chunks + K - 1 bases."""
    if chunk_windows % 8:
        raise ValueError(f"chunk_windows must be a multiple of 8, got {chunk_windows}")
    bases, mask = packed
    span = chunk_windows + kmer_len - 1
    b_span = (span + 3) // 4
    m_span = (span + 7) // 8
    for c in range(n_chunks):
        start = c * chunk_windows
        b0 = start // 4
        m0 = start // 8
        yield bases[b0 : b0 + b_span], mask[m0 : m0 + m_span]


def frame_prepacked(bases, mask, n_codes: int, kmer_len: int, chunk_windows: int):
    """Yield (bases2, maskbits) views of the chunks of planes that a packed
    decode wrote (numpy arrays of the native decode, or tensors of the
    card's, ``ops/fasta.decode_packed``): invalid-padded past ``n_codes``,
    with capacity for the final chunk's span. Chunk c covers bases
    [c*W, c*W + W + K - 1)."""
    if chunk_windows % 8:
        raise ValueError(f"chunk_windows must be a multiple of 8, got {chunk_windows}")
    k = kmer_len
    n_windows = max(n_codes - k + 1, 0)
    n_chunks = max((n_windows + chunk_windows - 1) // chunk_windows, 1)
    span = chunk_windows + k - 1
    b_span = (span + 3) // 4
    m_span = (span + 7) // 8
    last = (n_chunks - 1) * chunk_windows
    if last // 4 + b_span > bases.shape[0] or last // 8 + m_span > mask.shape[0]:
        raise ValueError("packed planes lack the tail capacity of the last chunk")
    for c in range(n_chunks):
        start = c * chunk_windows
        yield bases[start // 4 : start // 4 + b_span], mask[start // 8 : start // 8 + m_span]


def iter_chunks_prepacked(
    bases: np.ndarray,
    mask: np.ndarray,
    n_codes: int,
    kmer_len: int,
    chunk_windows: int,
):
    """Yield (bases2, maskbits-or-None) chunks as views of planes that the
    native packed decode (``io.native.fasta_decode_joined_packed_native``)
    wrote (:func:`frame_prepacked`); the mask is None where a chunk is all
    valid. No packing happens here."""
    span = chunk_windows + kmer_len - 1
    for b, m in frame_prepacked(bases, mask, n_codes, kmer_len, chunk_windows):
        yield b, (None if mask_all_valid(m, span) else m)


def iter_chunks_packed_lazy(
    padded: np.ndarray, kmer_len: int, chunk_windows: int, n_chunks: int
):
    """Yield (bases2, maskbits) chunks packed on the fly — same shapes as
    :func:`iter_chunks_packed`, but each chunk is packed on a worker thread
    while the consumer uploads and launches the previous one. All-valid
    chunks yield ``None`` for the mask (the mask-free device step)."""
    span = chunk_windows + kmer_len - 1
    b_span = (span + 3) // 4
    m_span = (span + 7) // 8
    from concurrent.futures import ThreadPoolExecutor

    def pack_one(piece):
        from ..utils import renice_current_thread

        renice_current_thread(10)  # yield the cores to the dispatch thread
        bases, mask = pack_base_stream(piece)
        mask = mask[:m_span]
        return bases[:b_span], (None if mask_all_valid(mask, span) else mask)

    # one pack kept in flight: chunk i+1 packs (native, GIL-free) while the
    # consumer dispatches chunk i
    with ThreadPoolExecutor(1) as ex:
        fut = None
        for piece in iter_chunks(padded, kmer_len, chunk_windows, n_chunks):
            nxt = ex.submit(pack_one, piece)
            if fut is not None:
                yield fut.result()
            fut = nxt
        if fut is not None:
            yield fut.result()
