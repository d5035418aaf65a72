"""Jaccard distance tail: `.kma` → `.dist.jaccard.*` outputs.

Reference semantics (calculate_distance.py:42-109): with the (N,N,3) matrix of
(total_A, total_B, shared),

    dist = 1 - shared / (total_A + total_B - shared)      (float64)

(the Jaccard complement: shared / (exclusive_A + shared + exclusive_B)), the
diagonal zeroed, saved uncompressed as ``{kma}.dist.jaccard.npz`` under key
``distance``.

Copy of ``pykmer_tpu/analysis/distance.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np


def read_names_file(names_file: str) -> Dict[str, str]:
    """Two-column TSV of id → display name (calculate_distance.py:21-27)."""
    assert os.path.exists(names_file)
    with open(names_file, "rt") as fh:
        rows = fh.readlines()
    cols = (r.split("\t") for r in rows)
    return {c[0].strip(): c[1].strip() for c in cols if len(c) == 2}


def get_matrix(matrix_file: str) -> np.ndarray:
    assert os.path.exists(matrix_file)
    npz = np.load(matrix_file)
    assert "matrix" in npz
    return npz["matrix"]


def _jaccard(matrix: np.ndarray, fill_diagonal: bool = True) -> np.ndarray:
    """dist = 1 - shared/(total - shared) (calculate_distance.py:82-97)."""
    shared = matrix[:, :, 2].astype(np.float64)
    total = matrix[:, :, 0:2].sum(axis=2).astype(np.float64)
    dist = 1.0 - (shared / (total - shared))
    if fill_diagonal:
        np.fill_diagonal(dist, 0.0)
    return dist


def calc_distance(
    matrix_file: str, matrix: np.ndarray, fill_diagonal: bool = True
) -> Tuple[str, np.ndarray]:
    """Jaccard distance matrix; returns (basefile, dist) and saves the npz."""
    dist = _jaccard(matrix, fill_diagonal)

    basefile = f"{matrix_file}.dist.jaccard"
    with open(f"{basefile}.npz", "wb") as fh:
        np.savez(fh, distance=dist)
    return basefile, dist


def jaccard_from_kma(matrix_file: str) -> Tuple[np.ndarray, list]:
    """(Jaccard distance matrix, sample ids) of a `.kma` — the in-memory
    form of :func:`calc_distance` without writing the npz (used by the kwip
    cross-validation comparison)."""
    dist = _jaccard(get_matrix(matrix_file))
    _, ids = sample_ids_from_kma_json(matrix_file)
    return dist, ids


def sample_ids_from_kma_json(matrix_file: str) -> Tuple[str, list]:
    """(project_name, ids) from the `.kma.json` sidecar
    (calculate_distance.py:137-146)."""
    header_file = f"{matrix_file}.json"
    with open(header_file, "rt") as fh:
        header = json.load(fh)
    ids = [d["header"]["input_file_name"] for d in header["data"]]
    return header["project_name"], ids


def load(matrix_file: str, names_file: Optional[str] = None) -> np.ndarray:
    """Full analysis tail: distances + clustering outputs
    (calculate_distance.py:237-245)."""
    from .cluster import cluster_distance

    if names_file is None:
        candidate = f"{matrix_file}.names.tsv"
        if os.path.exists(candidate):
            names_file = candidate

    matrix = get_matrix(matrix_file)
    basefile, distance = calc_distance(matrix_file, matrix, fill_diagonal=True)
    return cluster_distance(matrix_file, basefile, distance, names_file=names_file)
