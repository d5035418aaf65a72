"""The `.kin`'s bytes in file order from the folded plane, on the device
that holds it.

The raw readback tail on the card (``ops/readback._file_order_to_out``):
each slice of the 4^K file is unfolded on the card and reaches the host
final, so the output sha256 chases the whole file. With M = 4^K - 1 and
canon(u) = u <= rc(u), file byte p is ``folded[p]`` where p < 4^K/2 and p is
canonical, ``folded[M - p]`` where p >= 4^K/2 and M - p is not canonical, and
0 otherwise: the bytes ``readback.unfold_range`` writes, palindromes of even
K included. Alongside, the 256-bin histogram of the folded cells that the
first half reads (each folded cell once over the file).

On a CUDA tensor :func:`unfold_file` launches the hand-written kernel of
``csrc/unfold.cu``; on a CPU tensor it runs the plain torch version in this
module. Nothing falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# unfolds launched on the card in this process (one a slice of the file); a
# run resets it to 0 to show that its tail went through them (the CPU path
# does not count)
LAUNCHES = 0
PLAIN_BLOCK = 1 << 22  # file bytes a step of the plain version (bounds its temporaries)


def folded_range(kmer_len: int, a: int, b: int) -> Tuple[int, int]:
    """The folded cells [lo, hi) that file bytes [a, b) read (a < b): [a, b)
    in the first half, [4^K - b, 4^K - a) in the second, their hull where
    the range straddles the middle."""
    full = 4**kmer_len
    half = full // 2
    parts = []
    if a < half:
        parts.append((a, min(b, half)))
    if b > half:
        parts.append((full - b, full - max(a, half)))
    return min(lo for lo, _ in parts), max(hi for _, hi in parts)


def unfold_file(folded: torch.Tensor, first_cell: int, kmer_len: int, a: int, b: int,
                counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """File bytes [a, b) of the 4^K `.kin` plane as a new uint8 tensor on
    ``folded``'s device. ``folded`` (a contiguous 1-D uint8 tensor) holds
    folded cells [first_cell, first_cell + len), at least
    :func:`folded_range`'s. ``counts`` (int64[256] on the same device), if
    given, gains the histogram of the folded cells that the first-half bytes
    of [a, b) read."""
    global LAUNCHES
    full = 4**kmer_len
    if folded.dtype != torch.uint8 or folded.dim() != 1 or not folded.is_contiguous():
        raise ValueError("folded must be a contiguous 1-D uint8 tensor")
    if not 0 <= a <= b <= full:
        raise ValueError(f"file range [{a}, {b}) is not within [0, 4^{kmer_len})")
    if counts is not None and (counts.dtype != torch.int64 or counts.shape != (256,)
                               or counts.device != folded.device
                               or not counts.is_contiguous()):
        raise ValueError("counts must be a contiguous int64[256] on folded's device")
    if a < b:
        lo, hi = folded_range(kmer_len, a, b)
        if lo < first_cell or hi > first_cell + folded.shape[0]:
            raise ValueError(f"folded cells [{first_cell}, {first_cell + folded.shape[0]}) "
                             f"do not hold [{lo}, {hi}), which bytes [{a}, {b}) read")
    if folded.device.type == "cpu":
        return unfold_file_plain(folded, first_cell, kmer_len, a, b, counts)
    if folded.device.type != "cuda":
        raise ValueError(f"no unfold for device {folded.device}")
    out = torch.empty(b - a, dtype=torch.uint8, device=folded.device)
    if a == b:
        return out
    from ._build import load

    lib = load()
    stream = torch.cuda.current_stream(folded.device).cuda_stream
    with torch.cuda.device(folded.device):
        err = lib.pykmer_unfold_file(folded.data_ptr(), first_cell, out.data_ptr(), a, b - a,
                                     kmer_len, counts.data_ptr() if counts is not None else None,
                                     stream)
    if err != 0:
        raise RuntimeError(f"unfold launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def _rc(u: torch.Tensor, kmer_len: int) -> torch.Tensor:
    """Reverse complement of the K-mer codes ``u`` (int64)."""
    r = torch.zeros_like(u)
    for _ in range(kmer_len):
        r = (r << 2) | (~u & 3)
        u = u >> 2
    return r


def unfold_file_plain(folded: torch.Tensor, first_cell: int, kmer_len: int, a: int, b: int,
                      counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`unfold_file` as torch ops on any device, ``PLAIN_BLOCK`` file
    bytes a step."""
    full = 4**kmer_len
    half = full // 2
    out = torch.empty(b - a, dtype=torch.uint8, device=folded.device)
    for lo in range(a, b, PLAIN_BLOCK):
        hi = min(b, lo + PLAIN_BLOCK)
        p = torch.arange(lo, hi, dtype=torch.int64, device=folded.device)
        first = p < half
        u = torch.where(first, p, full - 1 - p)
        vals = folded[u - first_cell]
        keep = (u <= _rc(u, kmer_len)) == first
        out[lo - a : hi - a] = vals.masked_fill(~keep, 0)
        if counts is not None:
            counts += torch.bincount(vals[first].to(torch.int64), minlength=256)
    return out
