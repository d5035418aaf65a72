"""Plain PyTorch reference of a `.kin` index: the counts, the stats and the
record list that the reference pykmer writes for a FASTA.

Semantics (sauloal/pykmer ``indexer.py`` and ``tools.py``, as SURVEY.md
sets them out): A/C/G/T in either case code 0..3, every other byte is
invalid and drops each window that holds it; a window's forward code is
``sum(base[p] * 4^(K-1-p))``, its reverse-complement code
``sum((3 - base[p]) * 4^p)``, and it counts at the smaller of the two; a
cell saturates at 255; the `.kin` holds the 4^K cells, one byte each. A
record enters the record list when it yields a window.

This module imports nothing of the program. It takes the records as the
benchmark made them and counts them with ``torch.bincount``, record by
record, on the device it is given.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

MAX_VAL = 255
INVALID = 4


def base_table(device: torch.device) -> torch.Tensor:
    lut = torch.full((256,), INVALID, dtype=torch.uint8)
    for code, base in enumerate("ACGT"):
        lut[ord(base)] = code
        lut[ord(base.lower())] = code
    return lut.to(device)


def canonical_codes(seq: torch.Tensor, kmer_len: int) -> torch.Tensor:
    """int64 canonical codes of the valid windows of one record (uint8
    base codes, 4 invalid), in order."""
    k = kmer_len
    n = seq.shape[0] - k + 1
    if n <= 0:
        return torch.empty(0, dtype=torch.int64, device=seq.device)
    bad = torch.zeros(seq.shape[0] + 1, dtype=torch.int32, device=seq.device)
    torch.cumsum((seq == INVALID).to(torch.int32), 0, out=bad[1:])
    valid = bad[k:] == bad[:n]
    base = seq.clamp(max=3).to(torch.int64)
    fwd = torch.zeros(n, dtype=torch.int64, device=seq.device)
    rev = torch.zeros(n, dtype=torch.int64, device=seq.device)
    for p in range(k):
        window_p = base[p: p + n]
        fwd.mul_(4).add_(window_p)
        rev.add_((3 - window_p) << (2 * p))
    return torch.minimum(fwd, rev)[valid]


def count_records(records: Sequence[Tuple[str, np.ndarray]], kmer_len: int,
                  device: torch.device) -> Tuple[torch.Tensor, int, List[List]]:
    """(int64 counts of the 4^K cells, unsaturated; number of valid
    windows; [name, length] of each record that yields a window)."""
    lut = base_table(device)
    counts = torch.zeros(4**kmer_len, dtype=torch.int64, device=device)
    n_windows = 0
    chromosomes: List[List] = []
    for name, ascii_seq in records:
        seq = lut[torch.from_numpy(ascii_seq).to(device).to(torch.int64)]
        codes = canonical_codes(seq, kmer_len)
        del seq
        if codes.numel():
            chromosomes.append([name, int(ascii_seq.shape[0])])
            n_windows += int(codes.numel())
            counts += torch.bincount(codes, minlength=4**kmer_len)
    return counts, n_windows, chromosomes


def saturate(counts: torch.Tensor) -> torch.Tensor:
    """The `.kin` cells: counts saturating at 255."""
    return counts.clamp(max=MAX_VAL).to(torch.uint8)


def stats(plane: torch.Tensor) -> Dict[str, object]:
    """The `.kin.json` stats of a plane: ``hist[v-1]`` cells hold v for v in
    1..255, and the sums, counts and extremes over those and all values."""
    counts = torch.bincount(plane.to(torch.int64), minlength=256).cpu().numpy()
    hist = counts[1:256]
    values = np.arange(256, dtype=np.int64)
    present = values[counts > 0]
    return {
        "hist": [int(x) for x in hist], "hist_sum": int(hist.sum()),
        "hist_count": int(np.count_nonzero(hist)), "hist_min": int(hist.min()),
        "hist_max": int(hist.max()), "vals_sum": int((values * counts).sum()),
        "vals_count": int(counts[1:].sum()),
        "vals_min": int(present.min()), "vals_max": int(present.max()),
    }


def expected_metadata(plane: torch.Tensor, n_windows: int, chromosomes: List[List],
                      kmer_len: int, fasta_sha256: str) -> Dict[str, object]:
    """The `.kin.json` fields an index of these records must hold."""
    host = plane.cpu().numpy()
    return {
        "kmer_len": kmer_len, "kmer_size": 4**kmer_len, "data_size": 4**kmer_len,
        "num_kmers": n_windows, "chromosomes": chromosomes,
        "output_file_size": 4**kmer_len,
        "output_file_cheksum": hashlib.sha256(memoryview(host)).hexdigest(),
        "input_file_cheksum": fasta_sha256,
        **stats(plane),
    }


def sha256_file(path: str, block: int = 64 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            buf = fh.read(block)
            if not buf:
                return h.hexdigest()
            h.update(buf)


def bytes_wrong(kin_path: str, plane: torch.Tensor) -> int:
    """Cells of the `.kin` at ``kin_path`` that differ from ``plane``; a
    missing or short file counts every cell it lacks."""
    try:
        got = np.fromfile(kin_path, dtype=np.uint8)
    except OSError:
        return int(plane.numel())
    n = min(got.shape[0], plane.numel())
    wrong = int((torch.from_numpy(got[:n]).to(plane.device) != plane[:n]).sum())
    return wrong + abs(int(plane.numel()) - int(got.shape[0]))


def fields_wrong(meta: Dict[str, object], expected: Dict[str, object]) -> List[str]:
    """The expected fields that ``meta`` (a `.kin.json` as loaded) lacks or
    holds otherwise."""
    return [key for key, want in expected.items() if meta.get(key) != want]
