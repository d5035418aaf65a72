"""Peaks of the card and the work a job needs, for the kernels' roofline
shares.

A share is the least time the card could take over the measured kernel
time. The least time is the bytes over the memory bandwidth: the encode
and the sweep move bytes and do a few integer operations a byte, far
below any peak rate, so no rate of operations bounds them. The work is counted from the job's
own sizes, as the reference works them out, never from the program's
chunking or launches: each input byte read once, each output byte written
once.
"""

from __future__ import annotations

from typing import Optional

# NVIDIA H100 SXM5 data sheet, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
CODE_BYTES_K15 = 4  # a folded code at K <= 15 is an int32
CODE_BYTES_WIDE = 8


def code_bytes(kmer_len: int) -> int:
    return CODE_BYTES_K15 if kmer_len <= 15 else CODE_BYTES_WIDE


def least_seconds(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S


def encode_bytes(bases: int, valid_windows: int, kmer_len: int) -> int:
    """The genome's bases at 2 bits each read, one code a valid window
    written."""
    return bases // 4 + valid_windows * code_bytes(kmer_len)


def sweep_bytes(valid_windows: int, distinct_cells: int, kmer_len: int) -> int:
    """One code a valid window read; each distinct folded cell read once
    and written once (one byte each way)."""
    return valid_windows * code_bytes(kmer_len) + 2 * distinct_cells


def share(least_s: float, kernel_s: Optional[float]) -> Optional[float]:
    """100 x least / measured, or None where no kernel time was read."""
    if not kernel_s or kernel_s <= 0.0:
        return None
    return 100.0 * least_s / kernel_s
