"""`.kma` on-disk layout: the N×N×3 shared-kmer count matrix.

``matrix[k, l] = (k_count, l_count, shared_count)`` — valid-kmer counts of
sample k, sample l, and their intersection under the ``[min_count, max_count]``
filter. Stored as ``np.savez_compressed(..., matrix=...)`` (reference
merger.py:204-208) with a sibling ``.kma.json`` carrying per-sample lean
headers (merger.py:187-202).

The reference leaves the matrix diagonal uninitialised (merger.py:136 allocates
with ``np.ndarray``); our merge engine stores ``(total, total, total)`` there —
each sample's valid-cell total intersected with itself — which downstream
zeroes anyway (calculate_distance.py:96-97). See merge/merger.py:113-119.

Copy of ``pykmer_tpu/formats/kma.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np


def kma_path(project_name: str, min_count: int, max_count: int) -> str:
    return f"{project_name}.{min_count:03d}-{max_count:03d}.kma"


def write_kma(path: str, matrix: np.ndarray) -> None:
    assert matrix.ndim == 3 and matrix.shape[2] == 3
    assert matrix.dtype == np.uint64
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, matrix=matrix)
    os.rename(tmp, path)


def read_kma(path: str) -> np.ndarray:
    npz = np.load(path)
    if "matrix" not in npz:
        raise ValueError(f"{path}: missing 'matrix' key")
    return npz["matrix"]


def write_kma_json(
    path: str,
    project_name: str,
    min_count: int,
    max_count: int,
    data: List[Dict[str, Any]],
) -> None:
    """Write the `.kma.json` sidecar (tmp + atomic rename).

    ``data`` entries hold ``pos`` / ``index_file`` / ``description_file`` /
    ``header`` where header is the lean (no-chromosomes) `.kin.json` dict.
    """
    output = {
        "project_name": project_name,
        "min_count": min_count,
        "max_count": max_count,
        "data": data,
    }
    tmp = f"{path}.tmp"
    with open(tmp, "wt") as fh:
        json.dump(output, fh, sort_keys=True, indent=1, default=_json_default)
    os.rename(tmp, path)


def _json_default(obj: Any) -> Any:
    # Path-like and to_dict-bearing objects, as the reference's patched
    # JSONEncoder serialises them (merger.py:23-30).
    if hasattr(obj, "to_dict"):
        return obj.to_dict(lean=True)
    if hasattr(obj, "__fspath__"):
        return str(obj)
    raise TypeError(f"not JSON serialisable: {type(obj)}")
