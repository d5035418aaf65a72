"""FASTA bytes → the joined base-code stream (numpy + the native library).

Copies of ``_record_has_valid_window``, ``_concat_records`` and
``_decode_joined_bytes`` from ``pykmer_tpu/index/indexer.py``, which imports
jax. The native one-pass decoder is the port's copy, ``io/native.py``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..io.fasta import FastaRecord, decode_fasta_bytes


def record_has_valid_window(codes: np.ndarray, kmer_len: int) -> bool:
    """True iff the record yields at least one k-mer: a run of >=K valid bases."""
    if codes.shape[0] < kmer_len:
        return False
    valid = (codes < 4).astype(np.int32)
    # longest run via cumulative-sum-reset trick
    csum = np.cumsum(valid)
    reset = np.where(valid == 0, csum, 0)
    best = csum - np.maximum.accumulate(reset)
    return bool(best.max() >= kmer_len)


def concat_records(
    records: List[FastaRecord], kmer_len: int
) -> Tuple[np.ndarray, List[Tuple[str, int]], int]:
    """Concatenate record codes with K-1 invalid separator bases.

    Separators poison every window that would span two records, so the flat
    stream yields exactly the per-record k-mers. Returns (stream,
    chromosomes, total_bp); ``chromosomes`` lists (name, seq_len) for records
    producing at least one k-mer, in order (barren records are omitted).
    """
    sep = np.full(kmer_len - 1, 4, dtype=np.uint8)
    parts: List[np.ndarray] = []
    chromosomes: List[Tuple[str, int]] = []
    total_bp = 0
    for rec in records:
        total_bp += rec.seq_len
        if parts:
            parts.append(sep)
        parts.append(rec.codes)
        if record_has_valid_window(rec.codes, kmer_len):
            chromosomes.append((rec.name, rec.seq_len))
    stream = np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)
    return stream, chromosomes, total_bp


def decode_joined_bytes(data, kmer_len: int, tail_headroom: int = 0):
    """Decode in-memory FASTA bytes to (joined code stream, chromosomes,
    total_bp): the native one-pass path, with the numpy record path where the
    native library is absent or overflows. Both give identical results."""
    try:
        from ..io.native import fasta_decode_joined_native

        result = fasta_decode_joined_native(
            data, kmer_len, tail_headroom=tail_headroom
        )
        if result is not None:
            return result
    except ImportError:
        pass
    return concat_records(decode_fasta_bytes(data), kmer_len)
