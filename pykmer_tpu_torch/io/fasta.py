"""Vectorised FASTA decoding: bytes → per-record base-code arrays.

Alphabet (reference indexer.py:36-41): A/a→0, C/c→1, G/g→2, T/t→3; every
other byte is invalid (code 4 here; ``None`` in the reference) and poisons any
k-mer window containing it (indexer.py:144).

Line handling matches the reference parser (indexer.py:45-99): each physical
line is whitespace-stripped at both ends, blank lines are skipped, a stripped
line starting with ``>`` opens a new record (name = rest of the line), and
sequence lines are concatenated. The parse here is a single vectorised NumPy
pass over the whole buffer instead of a per-line Python loop; a C++ fast path
(io/native) can replace it transparently.

Copy of ``pykmer_tpu/io/fasta.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import gzip
import os
import sys
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

INVALID = np.uint8(4)

BASE_LUT = np.full(256, INVALID, dtype=np.uint8)
for _i, _ch in enumerate("ACGT"):
    BASE_LUT[ord(_ch)] = _i
    BASE_LUT[ord(_ch.lower())] = _i

# bytes stripped by str.strip() apart from the line delimiter itself
_WS_BYTES = (ord(" "), ord("\t"), ord("\r"), 0x0B, 0x0C)


@dataclass
class FastaRecord:
    name: str
    codes: np.ndarray  # uint8, 0..3 valid, 4 invalid

    @property
    def seq_len(self) -> int:
        return int(self.codes.shape[0])


def open_input_bytes(input_file: Optional[str]):
    """Read the (decompressed) bytes of a FASTA input.

    ``None`` reads stdin; ``.gz``/``.bgz`` are gzip-decoded (BGZF is a valid
    concatenated-gzip stream, reference indexer.py:112-115). Returns bytes,
    or a readonly uint8 ``np.memmap`` for plain files (zero-copy).
    """
    if input_file is None:
        return sys.stdin.buffer.read()
    if input_file.endswith((".gz", ".bgz")):
        try:
            from .native import gzip_decompress_native

            data = gzip_decompress_native(input_file)
            if data is not None:
                return data
        except ImportError:
            pass
        with gzip.open(input_file, "rb") as fh:
            return fh.read()
    # plain files: buffered read into a populated hugepage buffer. (An mmap
    # of the file is NOT used: this environment's file-backed page faults run
    # ~3 MB/s, vs ~30 MB/s cold / GB/s-warm for read(); and a fresh bytes
    # object would pay ~370 us/4K first-touch anonymous faults — see
    # utils/bigmem.)
    size = os.path.getsize(input_file)
    if size == 0:
        return b""
    from ..utils.bigmem import big_empty

    buf = big_empty(size)
    from .direct import read_file_into

    got = read_file_into(input_file, buf)
    if got != size:
        raise IOError(f"{input_file}: short read ({got} of {size} bytes)")
    return buf


def _stripped_ws_mask(buf: np.ndarray, ws: np.ndarray, nl: np.ndarray) -> np.ndarray:
    """Mask of whitespace bytes removed by per-line strip().

    A maximal whitespace run is stripped iff it touches a line boundary
    (start/end of buffer or a newline) on either side; interior whitespace
    stays (and later decodes as invalid, as in the reference).
    """
    stripped = np.zeros(buf.shape[0], dtype=bool)
    if not ws.any():
        return stripped
    w = ws.astype(np.int8)
    starts = np.flatnonzero(np.diff(np.concatenate(([0], w))) == 1)
    ends = np.flatnonzero(np.diff(np.concatenate((w, [0]))) == -1) + 1
    n = buf.shape[0]
    leading = (starts == 0) | nl[np.maximum(starts - 1, 0)]
    trailing = (ends == n) | nl[np.minimum(ends, n - 1)]
    sel = leading | trailing
    run_starts = starts[sel]
    run_ends = ends[sel]
    if run_starts.size:
        lens = run_ends - run_starts
        idx = np.repeat(run_starts, lens) + _ragged_arange(lens)
        stripped[idx] = True
    return stripped


def _ragged_arange(lens: np.ndarray) -> np.ndarray:
    """[0..lens[0]), [0..lens[1]), ... concatenated."""
    total = int(lens.sum())
    out = np.ones(total, dtype=np.int64)
    out[0] = 0
    cuts = np.cumsum(lens)[:-1]
    out[cuts] = -(lens[:-1] - 1)
    return np.cumsum(out)


def decode_fasta_bytes(data) -> List[FastaRecord]:
    """Parse a whole FASTA buffer (bytes or uint8 ndarray) into records."""
    if len(data) == 0:
        return []
    buf = (
        np.asarray(data, dtype=np.uint8)
        if isinstance(data, np.ndarray)
        else np.frombuffer(data, dtype=np.uint8)
    )
    n = buf.shape[0]

    nl = buf == 10
    ws = np.isin(buf, _WS_BYTES)
    stripped = _stripped_ws_mask(buf, ws, nl)

    # line starts: 0 and every byte after a newline
    line_starts = np.concatenate(([0], np.flatnonzero(nl) + 1))
    line_starts = line_starts[line_starts < n]
    # a line is a header iff its first non-stripped byte is '>'
    gt_pos = np.flatnonzero(buf == ord(">"))
    if gt_pos.size:
        # '>' belongs to the line whose start precedes it
        li = np.searchsorted(line_starts, gt_pos, side="right") - 1
        ls = line_starts[li]
        # all bytes in [ls, gt) must be stripped whitespace
        nonstrip_cum = np.concatenate(([0], np.cumsum(~stripped)))
        is_first = (nonstrip_cum[gt_pos] - nonstrip_cum[ls]) == 0
        header_gt = gt_pos[is_first]
    else:
        header_gt = gt_pos

    if header_gt.size == 0:
        return []

    # line end (newline position or EOF) for each header
    nl_pos = np.flatnonzero(nl)
    if nl_pos.size:
        he_idx = np.searchsorted(nl_pos, header_gt, side="left")
        header_end = np.where(
            he_idx < nl_pos.size, nl_pos[np.minimum(he_idx, nl_pos.size - 1)], n
        )
    else:
        header_end = np.full(header_gt.shape, n, dtype=np.int64)

    keep = ~nl & ~stripped
    keep_cum = np.concatenate(([0], np.cumsum(keep)))
    codes_all = BASE_LUT[buf[keep]]

    records: List[FastaRecord] = []
    for r in range(header_gt.size):
        name_bytes = buf[header_gt[r] + 1 : header_end[r]].tobytes()
        # reference semantics (indexer.py:56,81): the LINE is stripped, then
        # name = line[1:] — so whitespace AFTER the '>' is kept, only the
        # trailing end of the line is stripped (the native decoder agrees)
        name = name_bytes.decode(errors="replace").rstrip()
        seq_from = int(header_end[r]) + 1  # first byte after the header line
        seq_to = n
        # header line of the NEXT record starts at its line start; sequence
        # bytes end at that line's start (minus any stripped prefix handled
        # by the keep mask)
        if r + 1 < header_gt.size:
            nls = np.searchsorted(line_starts, header_gt[r + 1], side="right") - 1
            seq_to = int(line_starts[nls])
        seq_from = min(seq_from, n)
        codes = codes_all[keep_cum[seq_from] : keep_cum[seq_to]]
        records.append(FastaRecord(name=name, codes=codes))
    return records


def read_fasta_codes(input_file: Optional[str]) -> List[FastaRecord]:
    """Read + decode a FASTA file (plain, gz, bgz, or stdin).

    Uses the C++ one-pass decoder when built (io/native), falling back to the
    vectorised NumPy parse; both implement identical semantics (tested).
    """
    data = open_input_bytes(input_file)
    try:
        from .native import fasta_decode_native

        result = fasta_decode_native(data)
        if result is not None:
            codes, starts, names = result
            return [
                FastaRecord(names[r], codes[starts[r] : starts[r + 1]])
                for r in range(len(names))
            ]
    except ImportError:
        pass
    return decode_fasta_bytes(data)


def iter_fasta_codes(input_file: Optional[str]) -> Iterator[FastaRecord]:
    yield from read_fasta_codes(input_file)
