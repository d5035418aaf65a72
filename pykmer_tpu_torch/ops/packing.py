"""Device half of the readback modes: packs, escape counts, the sparse token
stream and the mode choice.

Port of the device programs of ``pykmer_tpu/ops/readback.py``. Every op
takes a flat uint8 tensor (a folded plane or a slice of one, on the card or
the CPU) and is a plain torch op: the JAX package computes them in ``jnp``
outside any Pallas kernel.

- The fixed-width packs clip each cell to an escape marker (3, 7 or 15) and
  pack 4, 8/3 or 2 cells a byte. The bit layout depends only on the flat
  cell order, so a plane packs slice by slice (``ops/readback.py``), never
  whole: the 8 GiB K=17 plane would need GiBs of temporaries.
- The sparse token stream (``pack_sparse_segment``) ships one byte per
  nonzero cell of a segment: the gap to the previous nonzero and the value
  clipped to 3. The JAX package compacts with a keys-only sort because the
  TPU has no scatter; here ``torch.nonzero`` selects the positions.
- ``pick_mode`` prices each mode on the four escape counts of
  ``count_all_escapes``, as the JAX package's ``_pick_mode`` does.

The JAX package reads its sparse switches from the environment
(``PYKMER_TPU_SPARSE``, ``PYKMER_TPU_SPARSE_MIN``, ``PYKMER_TPU_SPARSE_SEG``);
here they are the module constants ``SPARSE``, ``SPARSE_MIN_CELLS`` and
``SPARSE_SEG_CELLS``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

ESCAPE4 = 15
ESCAPE3 = 7
ESCAPE2 = 3
# bits per cell of each fixed-width mode, and its escape marker
WIDTHS = {"2bit": 2, "3bit": 3, "packed": 4}
ESCAPE_OF_WIDTH = {2: ESCAPE2, 3: ESCAPE3, 4: ESCAPE4}
MODES = ("raw", "packed", "2bit", "3bit", "sparse")
# a plane whose size is not a multiple of this reads back raw (the JAX
# package's 256-lane rule)
PACK_ALIGN = 256
# below this many cells "auto" reads back raw
AUTO_MIN_CELLS = 1 << 26
# cells per reduction of count_all_escapes: bounds its bool temporaries
COUNT_SLICE_CELLS = 1 << 28

SPARSE = True  # False takes the sparse stream out of pick_mode's choice
SPARSE_MIN_CELLS = 1 << 26  # smaller planes are never priced sparse
# cells per sparse segment; at most 2^28, so that a position, and the JAX
# package's key 4 * position + value, fit int32
SPARSE_SEG_CELLS = 1 << 28
SPARSE_LONG_GAP = 83  # longer gaps go to the int32 side stream


def pack_nibbles(cells: torch.Tensor) -> torch.Tensor:
    """uint8[n] (n even) → uint8[n/2]: min(v, 15) nibbles, the even cell of
    each pair in the low bits."""
    q = torch.clamp(cells, max=ESCAPE4).view(-1, 2)
    return q[:, 0] | (q[:, 1] << 4)


def pack_2bit(cells: torch.Tensor) -> torch.Tensor:
    """uint8[n] (n % 4 == 0) → uint8[n/4]: min(v, 3) crumbs, cell i of each
    group of 4 in bits [2i, 2i+2)."""
    q = torch.clamp(cells, max=ESCAPE2).view(-1, 4)
    return q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)


def pack_3bit(cells: torch.Tensor) -> torch.Tensor:
    """uint8[n] (n % 8 == 0) → uint8[3n/8]: min(v, 7) 3-bit fields; cells
    8g..8g+7 pack into bytes 3g..3g+2 little-endian (cell 8g+i in bits
    [3i, 3i+3) of the 24-bit group)."""
    q = torch.clamp(cells, max=ESCAPE3).view(-1, 8)
    c = [q[:, i] for i in range(8)]
    b0 = c[0] | (c[1] << 3) | ((c[2] & 3) << 6)
    b1 = (c[2] >> 2) | (c[3] << 1) | (c[4] << 4) | ((c[5] & 1) << 7)
    b2 = (c[5] >> 1) | (c[6] << 2) | (c[7] << 5)
    return torch.stack([b0, b1, b2], dim=1).reshape(-1)


PACKS = {2: pack_2bit, 3: pack_3bit, 4: pack_nibbles}


def packed_len(cells: int, width: int) -> int:
    """Bytes that ``cells`` cells (a multiple of 8) pack into."""
    return cells * width // 8


def count_at_least(cells: torch.Tensor, t: int) -> torch.Tensor:
    """Cells >= ``t`` as a 0-d int64 tensor on their device. ``sum`` and
    ``count_nonzero`` would first cast every cell to int64 (8 bytes a cell:
    2 GiB for a 2^28-cell segment); here the flags are summed as uint8 in
    rows of 128, and only the row counts are cast."""
    flags = (cells >= t).view(torch.uint8)
    head = flags.shape[0] // 128 * 128
    n = flags[:head].view(-1, 128).sum(dim=1, dtype=torch.uint8).sum()
    return n + flags[head:].sum() if head < flags.shape[0] else n


def count_all_escapes(plane: torch.Tensor) -> Tuple[int, int, int, int]:
    """(cells >= 1, >= 3, >= 7, >= 15) of a flat plane: the nonzeros price
    the sparse stream, the others each fixed-width plane's escape patches.
    Reduced ``COUNT_SLICE_CELLS`` at a time on the plane's device, read back
    once."""
    counts = torch.zeros(4, dtype=torch.int64, device=plane.device)
    for lo in range(0, plane.shape[0], COUNT_SLICE_CELLS):
        s = plane[lo : lo + COUNT_SLICE_CELLS]
        counts += torch.stack([count_at_least(s, t) for t in (1, ESCAPE2, ESCAPE3, ESCAPE4)])
    n1, n3, n7, n15 = counts.tolist()
    return n1, n3, n7, n15


def gather_cells(plane: torch.Tensor, idx: np.ndarray) -> np.ndarray:
    """The plane's cells at flat indices ``idx`` (any integer dtype), as a
    host uint8 array: one ``plane[idx]`` with int64 indices (the K=17 plane
    exceeds int32 indexing)."""
    i = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(plane.device)
    return plane[i].cpu().numpy()


def sparse_viable(size: int) -> bool:
    """Whether a plane of ``size`` cells may be priced sparse: the stream is
    on, the plane is large enough, and the native token decoder is built (a
    Python decode loop would lose to the fixed-width planes)."""
    if not SPARSE or size < SPARSE_MIN_CELLS:
        return False
    try:
        from ..io.native import sparse_decode_segment_native  # noqa: F401
    except ImportError:
        return False
    return True


def pick_mode(
    plane: Optional[torch.Tensor], size: int, mode: str,
    escapes: Optional[Sequence[int]] = None,
) -> str:
    """Resolve ``mode`` to the readback of a plane of ``size`` cells: the
    JAX package's ``_pick_mode`` on the same four escape counts.

    "raw" stays raw, as does every mode where ``size`` is not a multiple of
    256 and "auto" below 2^26 cells; another explicit mode stands. "auto"
    prices the bytes each mode moves (bits per cell plus ~9 bytes per escape
    patch; for the sparse stream one byte per nonzero plus a size/64
    penalty, and only at density <= 1/8) and takes the cheapest, or raw
    where even that moves more than the raw plane (the JAX package's
    "raw2d", which on the card is the raw copy). ``escapes``: the
    ``count_all_escapes`` of ``plane``, counted here when not given."""
    if mode not in MODES and mode != "auto":
        raise ValueError(f"unknown readback mode {mode!r}")
    if mode == "raw" or (mode == "auto" and size < AUTO_MIN_CELLS) or size % PACK_ALIGN:
        return "raw"
    if mode != "auto":
        return mode
    if escapes is None:
        escapes = count_all_escapes(plane)
    n_nz, n_ge3, n_ge7, n_ge15 = (int(v) for v in escapes)
    costs = {
        "2bit": size // 4 + 9 * n_ge3,
        "3bit": 3 * size // 8 + 9 * n_ge7,
        "packed": size // 2 + 9 * n_ge15,
    }
    if n_nz <= size // 8 and sparse_viable(size):
        costs["sparse"] = n_nz + 9 * n_ge3 + size // 64
    mode = min(costs, key=costs.get)
    return "raw" if costs[mode] > size else mode


def sparse_cap(seg_cells: int) -> int:
    """Token capacity of one segment: ~20% of its cells, against the 1/8
    density gate of ``pick_mode`` (the slack absorbs skew between a plane's
    segments). A denser segment reads back through the 2-bit plane instead.
    The JAX package also rounds the cap up to its fixed fetch grain and caps
    the side and escape streams for its fixed-shape sorts; here those two
    are exact-length selections and never overflow."""
    return min(max(seg_cells // 5, 64), seg_cells)


def pack_sparse_segment(
    seg: torch.Tensor, cap: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Tuple[int, int, int]]:
    """Compact one flat uint8 segment (at most 2^28 cells) into the sparse
    wire format, on its device.

    Returns (tokens uint8, side int32, escpos int32, (n_nz, n_long, n_esc)).
    Token t < 252 stands for a cell after t // 3 zeros with value t % 3 + 1;
    t >= 252 for value t - 251 at the position that is the next entry of the
    side stream (gaps over 83). Value 3 means ">= 3": ``escpos`` lists those
    cells for the caller's gather. The first token's gap counts from the
    segment start. The arrays are the first n_nz, n_long and n_esc entries
    of the JAX function's. Where n_nz > ``cap`` nothing is compacted and
    n_long = n_esc = 0: the caller reads the 2-bit plane (the JAX package
    still compacts the first ``cap`` nonzeros). The count, ``torch.nonzero``
    and the two masks read their sizes back: four host round trips."""
    if seg.shape[0] > SPARSE_SEG_CELLS:
        raise ValueError(f"a segment holds at most {SPARSE_SEG_CELLS} cells")
    n_nz = int(count_at_least(seg, 1))
    if n_nz > cap or n_nz == 0:
        empty = torch.empty(0, dtype=torch.int32, device=seg.device)
        return torch.empty(0, dtype=torch.uint8, device=seg.device), empty, empty, (n_nz, 0, 0)
    pos64 = torch.nonzero(seg).squeeze(1)
    v = torch.clamp(seg[pos64], max=ESCAPE2).to(torch.int32)
    pos = pos64.to(torch.int32)
    gap = torch.diff(pos, prepend=pos.new_full((1,), -1)) - 1
    token = torch.where(gap <= SPARSE_LONG_GAP, 3 * gap + v - 1, 251 + v).to(torch.uint8)
    side = pos[gap > SPARSE_LONG_GAP]
    escpos = pos[v == ESCAPE2]
    return token, side, escpos, (n_nz, side.shape[0], escpos.shape[0])
