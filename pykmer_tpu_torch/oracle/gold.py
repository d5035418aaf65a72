"""Slow NumPy gold implementation of the reference semantics.

This module is the test-suite's source of truth: it re-implements, in
deliberately simple Python/NumPy, the exact counting semantics of the
reference pipeline —

- canonical k-mer generation: per-window forward code
  ``sum(base[p] * 4^(K-1-p))``, reverse-complement code
  ``sum((3-base[p]) * 4^p)``, canonical = min(fwd, rev); windows containing an
  invalid base are dropped (reference indexer.py:130-160, 341);
- flush-buffered counting: codes buffered ``flush_every`` at a time, each
  flush's per-code counts clipped to 255 and saturating-added into the dense
  uint8 array (reference indexer.py:162-297, 333-390);
- chromosome bookkeeping: a record enters ``chromosomes`` when its first
  valid k-mer is produced, so records yielding no k-mers are omitted
  (reference indexer.py:345-351);
- the pairwise valid/shared counts of the merge stage (reference
  tools.py:439-493).

It is used on small inputs only; the JAX pipeline must match it exactly.

Copy of ``pykmer_tpu/oracle/gold.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import DEFAULT_FLUSH_EVERY, MAX_VAL
from ..formats.header import KinHeader
from ..formats import kin as kinfmt
from ..io.fasta import FastaRecord, read_fasta_codes


def oracle_canonical_codes(codes: np.ndarray, kmer_len: int) -> np.ndarray:
    """All canonical k-mer codes of one sequence, in order (valid windows only)."""
    k = kmer_len
    seq = codes.astype(np.int64)
    n = seq.shape[0]
    out: List[int] = []
    pos_val = [4 ** (k - p - 1) for p in range(k)]
    for i in range(0, n - k + 1):
        window = seq[i : i + k]
        if (window >= 4).any():
            continue
        fwd = 0
        rev = 0
        for p in range(k):
            fwd += pos_val[p] * int(window[p])
            rev += pos_val[k - p - 1] * (3 - int(window[p]))
        out.append(min(fwd, rev))
    return np.asarray(out, dtype=np.int64)


def oracle_count_stream(
    code_stream: Sequence[np.ndarray],
    kmer_len: int,
    flush_every: int = DEFAULT_FLUSH_EVERY,
) -> np.ndarray:
    """Flush-buffered saturating dense histogram over a stream of code chunks."""
    data_size = 4**kmer_len
    dense = np.zeros(data_size, dtype=np.uint8)
    buffer: List[np.ndarray] = []
    buffered = 0

    def flush(codes: np.ndarray) -> None:
        uniq, cnt = np.unique(codes, return_counts=True)
        cnt = np.minimum(cnt, MAX_VAL)
        old = dense[uniq].astype(np.int64)
        dense[uniq] = np.minimum(old + cnt, MAX_VAL).astype(np.uint8)

    for chunk in code_stream:
        pos = 0
        while pos < chunk.shape[0]:
            take = min(chunk.shape[0] - pos, flush_every - buffered)
            buffer.append(chunk[pos : pos + take])
            buffered += take
            pos += take
            if buffered >= flush_every:
                flush(np.concatenate(buffer))
                buffer, buffered = [], 0
    if buffered:
        flush(np.concatenate(buffer))
    return dense


def oracle_index_arrays(
    input_file: str,
    kmer_len: int,
    flush_every: int = DEFAULT_FLUSH_EVERY,
    records: Optional[List[FastaRecord]] = None,
) -> Tuple[np.ndarray, int, List[Tuple[str, int]]]:
    """Index a FASTA: returns (dense array, num_kmers, chromosomes)."""
    if records is None:
        records = read_fasta_codes(input_file)
    chromosomes: List[Tuple[str, int]] = []
    num_kmers = 0
    chunks: List[np.ndarray] = []
    for rec in records:
        codes = oracle_canonical_codes(rec.codes, kmer_len)
        if codes.shape[0] > 0:
            chromosomes.append((rec.name, rec.seq_len))
            num_kmers += int(codes.shape[0])
            chunks.append(codes)
    dense = oracle_count_stream(chunks, kmer_len, flush_every=flush_every)
    return dense, num_kmers, chromosomes


def oracle_write_index(
    project_name: str,
    input_file: str,
    kmer_len: int,
    overwrite: bool = True,
    flush_every: int = DEFAULT_FLUSH_EVERY,
) -> KinHeader:
    """Full oracle indexing run: writes `.kin` + `.kin.json` like the indexer."""
    import os

    header = KinHeader(
        project_name,
        input_file=input_file,
        kmer_len=kmer_len,
        flush_every=flush_every,
    )
    kinfmt.remove_outputs(input_file, kmer_len, overwrite)
    dense, num_kmers, chromosomes = oracle_index_arrays(
        input_file, kmer_len, flush_every=flush_every
    )
    if num_kmers == 0:
        raise ValueError(f"{input_file}: no valid k-mers at K={kmer_len}")
    tmp = header.index_tmp_file
    kinfmt.write_kin_array(tmp, dense)
    header.num_kmers = num_kmers
    header.chromosomes = chromosomes
    header.write_metadata(tmp, stats_counts256=np.bincount(dense, minlength=256))
    os.rename(tmp, header.index_file_root)
    return header


def oracle_pair_counts(
    a: np.ndarray, b: np.ndarray, min_count: int, max_count: int
) -> Tuple[int, int, int]:
    """Valid/valid/shared cell counts of two dense arrays (tools.py:473-482)."""
    av = (a >= min_count) & (a <= max_count)
    bv = (b >= min_count) & (b <= max_count)
    return int(av.sum()), int(bv.sum()), int((av & bv).sum())
