"""Plain PyTorch reference of a `.kin` index, counted one block of code
space at a time, for planes too large to count whole.

The semantics are ``reference/index.py``'s (its docstring): the same
canonical codes of the same valid windows, counts saturating at 255,
non-canonical cells 0, the same `.kin.json` fields and the same count of
wrong cells. It departs from that module only in blocking. There the counts
of all 4^K cells are one int64 array and the plane is copied whole to the
host: at K=17 that is 137 GB on the device and 17.2 GB on the host. Here
the genome's int64 canonical codes are computed once, record by record as
there, and each block of at most ``MAX_BLOCK_CELLS`` cells of the plane is
counted by ``torch.bincount`` of the codes that fall in it and saturated.
The blocks are handed on in file order: the value histogram and its sums
add up over them, the output sha256 is chained over them, and each `.kin`
compared is read block by block at the block's offset and compared on the
device.

Device memory, the tomato at K=17 (782 M windows) in blocks of 2^30 cells:
the codes (6.3 GB), a block's mask and its codes (at most 0.8 + 6.3 GB),
its int64 counts (8.6 GB) and its cells (1.1 GB), a block of a `.kin`
(1.1 GB) and the comparison's mask: under 25 GB, and 17.0 GB measured on an
H100 (`torch.cuda.max_memory_allocated`). The host holds a block at a time.
This module imports nothing of the program.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kbench.reference.index import base_table, canonical_codes

BLOCK_CELLS = 1 << 30
MAX_BLOCK_CELLS = 1 << 31
MAX_VAL = 255


def saturate_(counts: torch.Tensor) -> torch.Tensor:
    """The `.kin` cells of a block's int64 counts (overwritten): counts
    saturating at 255."""
    return counts.clamp_(max=MAX_VAL).to(torch.uint8)


def count_codes(records: Sequence[Tuple[str, np.ndarray]], kmer_len: int,
                device: torch.device) -> Tuple[torch.Tensor, List[List]]:
    """(the int64 canonical codes of every valid window, record after
    record; [name, length] of each record that yields a window)."""
    lut = base_table(device)
    parts: List[torch.Tensor] = []
    chromosomes: List[List] = []
    for name, ascii_seq in records:
        seq = lut[torch.from_numpy(ascii_seq).to(device).to(torch.int64)]
        codes = canonical_codes(seq, kmer_len)
        del seq
        if codes.numel():
            chromosomes.append([name, int(ascii_seq.shape[0])])
            parts.append(codes)
    codes = torch.cat(parts) if parts else torch.empty(0, dtype=torch.int64, device=device)
    return codes, chromosomes


def blocks(codes: torch.Tensor, kmer_len: int, block_cells: int = BLOCK_CELLS,
           cells: Callable[[torch.Tensor], torch.Tensor] = saturate_,
           ) -> Iterator[Tuple[int, torch.Tensor]]:
    """(offset, uint8 cells) of each block of the 4^K plane, in file order;
    ``cells`` turns a block's int64 counts into its cells."""
    if not 0 < block_cells <= MAX_BLOCK_CELLS:
        raise ValueError(f"a block holds 1 to {MAX_BLOCK_CELLS} cells, not {block_cells}")
    size = 4**kmer_len
    for lo in range(0, size, block_cells):
        hi = min(size, lo + block_cells)
        inside = codes[(codes >= lo) & (codes < hi)] - lo
        counts = torch.bincount(inside, minlength=hi - lo)
        del inside
        plane = cells(counts)
        del counts
        yield lo, plane


def stats(counts256: np.ndarray) -> Dict[str, object]:
    """The `.kin.json` stats of a plane from its 256-bin value counts, as
    ``reference/index.py``'s ``stats`` gives them from the plane."""
    hist = counts256[1:256]
    values = np.arange(256, dtype=np.int64)
    present = values[counts256 > 0]
    return {
        "hist": [int(x) for x in hist], "hist_sum": int(hist.sum()),
        "hist_count": int(np.count_nonzero(hist)), "hist_min": int(hist.min()),
        "hist_max": int(hist.max()), "vals_sum": int((values * counts256).sum()),
        "vals_count": int(counts256[1:].sum()),
        "vals_min": int(present.min()), "vals_max": int(present.max()),
    }


def _read_block(path: str, lo: int, n: int) -> Optional[np.ndarray]:
    try:
        return np.fromfile(path, dtype=np.uint8, count=n, offset=lo)
    except (OSError, ValueError):
        return None


def judge(records: Sequence[Tuple[str, np.ndarray]], kmer_len: int, device: torch.device,
          fasta_sha256: str, kin_paths: Sequence[str] = (), write_path: Optional[str] = None,
          block_cells: int = BLOCK_CELLS,
          cells: Callable[[torch.Tensor], torch.Tensor] = saturate_,
          ) -> Tuple[Dict[str, object], List[int], int]:
    """One pass over the plane's blocks in file order: (the `.kin.json`
    fields an index of ``records`` must hold, as ``reference/index.py``'s
    ``expected_metadata`` gives them; the cells of each file of
    ``kin_paths`` that differ from the plane, a missing or short file
    counting every cell it lacks and a long one each byte too many; the
    nonzero cells). Where ``write_path`` is given, the plane is written
    there."""
    codes, chromosomes = count_codes(records, kmer_len, device)
    n_windows = int(codes.numel())
    size = 4**kmer_len
    sizes = [os.path.getsize(p) if os.path.exists(p) else 0 for p in kin_paths]
    wrong = [max(0, s - size) for s in sizes]
    counts256 = np.zeros(256, dtype=np.int64)
    h = hashlib.sha256()
    distinct = 0
    out = open(write_path, "wb") if write_path is not None else None
    try:
        for lo, plane in blocks(codes, kmer_len, block_cells, cells):
            n = plane.numel()
            counts256 += torch.bincount(plane, minlength=256).cpu().numpy()
            distinct += int(torch.count_nonzero(plane))
            host = plane.cpu().numpy()
            h.update(memoryview(host))
            if out is not None:
                host.tofile(out)
            for i, path in enumerate(kin_paths):
                got = _read_block(path, lo, n) if sizes[i] > lo else None
                m = 0 if got is None else got.shape[0]
                if m:
                    wrong[i] += int((torch.from_numpy(got).to(device) != plane[:m]).sum())
                wrong[i] += n - m
    finally:
        if out is not None:
            out.close()
    expected = {
        "kmer_len": kmer_len, "kmer_size": size, "data_size": size,
        "num_kmers": n_windows, "chromosomes": chromosomes,
        "output_file_size": size, "output_file_cheksum": h.hexdigest(),
        "input_file_cheksum": fasta_sha256,
        **stats(counts256),
    }
    return expected, wrong, distinct
