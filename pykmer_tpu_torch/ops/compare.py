"""The merge's per-block device step: counterpart of ``_make_block_step``
(``pykmer_tpu/merge/merger.py:355-379``).

A block of N samples arrives as validity bits, [N, block/8] uint8 packed
little-endian: bit i of byte j is cell 8j+i, as
``io.native.pack_valid_bits_native`` writes them. The device
unpacks them into a {0,1} int8 matrix V and adds V·Vᵀ, the block's whole
N×N shared-cell contingency with each sample's own total on the diagonal,
into an int64 accumulator that stays on the device.

On CUDA tensors the product is ``torch._int_mm`` (int8 × int8 → int32,
cuBLASLt). The JAX package runs it as ``jnp.dot`` outside any Pallas kernel,
so it is not a TPU kernel to port. ``_int_mm`` takes more than 16 rows and
sizes that are multiples of 8, so V carries zero rows up to
:func:`padded_rows`. Called on V and its transposed view as they are (a
40 × 55M block), cuBLASLt runs one tile down the whole cell axis and takes
235 ms on an H100. So each row's cells are cut into S segments, stacked as
S rows of a [rows·S, block/S] view of V (no copy), and one ``_int_mm`` of
that view with its transposed view gives every segment pair; the sum of the
S diagonal [rows, rows] blocks is V·Vᵀ. The product does S times the
multiply-adds, on tensor cores that have them to spare, and fills the card:
7.5 ms for the same block (PERF.md). V's columns are padded with zeros to a
multiple of 8·S.

On CPU tensors the plain version runs: V·Vᵀ in int32, unstacked. Both are
exact: a block's partial is at most the block size (< 2^31), and the
accumulator is int64 because a sample's total exceeds int32 at K >= 16.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

MIN_ROWS = 24  # _int_mm: more than 16 rows, and a multiple of 8
# rows of the stacked product: S is the largest power of two with
# rows·S <= this (measured on an H100: S=32 best at 40 rows, PERF.md)
MAX_STACKED_ROWS = 1280

# block steps run on a CUDA device in this process; a run resets it to 0 to
# show that its merge went through the card (CPU steps do not count)
STEPS = 0


def padded_rows(n: int) -> int:
    """Rows of V for ``n`` samples: ``n`` rounded up to 8, at least 24."""
    return max(MIN_ROWS, (n + 7) // 8 * 8)


def segments(rows: int) -> int:
    """S, the number of segments each row of V is cut into on CUDA."""
    s = 1
    while rows * s * 2 <= MAX_STACKED_ROWS:
        s *= 2
    return s


def new_workspace(n: int, block: int, device: torch.device) -> torch.Tensor:
    """A zeroed int8 V for ``n`` samples and ``block`` cells: padded_rows(n)
    rows, ``block`` rounded up to a multiple of 8·S columns."""
    rows = padded_rows(n)
    step = 8 * segments(rows)
    return torch.zeros((rows, (block + step - 1) // step * step),
                       dtype=torch.int8, device=device)


def _bit_lut(device: torch.device) -> torch.Tensor:
    """int64[256]: byte i of entry b is bit i of b. On a little-endian
    device (CUDA, x86, arm64) its int8 view is the byte's 8 cells."""
    b = torch.arange(256, dtype=torch.int64, device=device)
    sh = torch.arange(8, dtype=torch.int64, device=device)
    return (((b[:, None] >> sh) & 1) << (8 * sh)).sum(1)


def unpack_validity(bits: torch.Tensor, rows: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n, block/8] uint8 little-endian validity bits → [rows, ≥ block] int8
    of 0 and 1; rows past n and columns past the block are zero.

    ``out``, a contiguous int8 [rows, cols] tensor on the bits' device (cols
    ≥ block, a multiple of 8) that is zero outside [:n, :block], is filled
    in place and returned, so a merge allocates V once. Each byte becomes
    its 8 cells by one gather from a 256-entry table, a row at a time."""
    if bits.dtype != torch.uint8 or bits.dim() != 2 or not bits.is_contiguous():
        raise ValueError(f"bits must be a contiguous 2-D uint8 tensor, got "
                         f"{bits.dtype} {tuple(bits.shape)}")
    n, nb = bits.shape
    if rows < n:
        raise ValueError(f"rows {rows} < {n} samples")
    if out is None:
        out = torch.zeros((rows, nb * 8), dtype=torch.int8, device=bits.device)
    elif (out.dtype != torch.int8 or out.dim() != 2 or out.shape[0] != rows
          or out.shape[1] < nb * 8 or out.shape[1] % 8 or not out.is_contiguous()
          or out.device != bits.device):
        raise ValueError(f"out must be a contiguous int8 [{rows}, >= {nb * 8}] "
                         f"tensor on {bits.device}, a multiple of 8 wide; got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    lut = _bit_lut(bits.device)
    out64 = out.view(torch.int64)
    for i in range(n):
        torch.index_select(lut, 0, bits[i].to(torch.int32), out=out64[i, :nb])
    return out


def stacked_product(v: torch.Tensor, s: int,
                    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
                    ) -> torch.Tensor:
    """V·Vᵀ (int64 [rows, rows]) through one product ``mm`` of V's [rows·S,
    cols/S] segment view with its transposed view: the sum of the product's
    S diagonal [rows, rows] blocks. ``cols`` must be a multiple of S."""
    rows, cols = v.shape
    if cols % s:
        raise ValueError(f"{cols} columns do not split into {s} segments")
    w = v.view(rows * s, cols // s)
    return mm(w, w.t()).view(rows, s, rows, s).diagonal(dim1=1, dim2=3).sum(-1)


def block_contingency(acc: torch.Tensor, bits: torch.Tensor,
                      v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc += V·Vᵀ`` IN PLACE for one block, and return ``acc``.

    ``acc`` is a contiguous int64 [n, n] tensor and ``bits`` the block's
    [n, block/8] uint8 validity bits (pad bits zero), both on one device;
    ``v`` is an optional workspace from :func:`new_workspace`."""
    global STEPS
    n = bits.shape[0] if bits.dim() == 2 else -1
    if acc.dtype != torch.int64 or tuple(acc.shape) != (n, n) \
            or not acc.is_contiguous():
        raise ValueError(f"acc must be a contiguous int64 [{n}, {n}] tensor, got "
                         f"{acc.dtype} {tuple(acc.shape)}")
    if acc.device != bits.device:
        raise ValueError(f"acc on {acc.device}, bits on {bits.device}")
    if v is None:
        v = new_workspace(n, bits.shape[1] * 8, bits.device)
    rows = padded_rows(n)
    v = unpack_validity(bits, rows, v)
    if acc.device.type == "cpu":
        w = v.to(torch.int32)
        acc += (w @ w.t())[:n, :n]
    elif acc.device.type == "cuda":
        acc += stacked_product(v, segments(rows), torch._int_mm)[:n, :n]
        STEPS += 1
    else:
        raise ValueError(f"no block step for device {acc.device}")
    return acc
