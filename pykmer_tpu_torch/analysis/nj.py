"""Neighbour-joining tree construction (replaces skbio.tree.nj).

Classic Saitou-Nei NJ over a redundant distance matrix, emitting a newick
string in the same shape as skbio's (branch lengths ``%f``-formatted, ``", "``
separators, trailing ``;``) — the format consumed by the reference's
clustering step (calculate_distance.py:189-204).

Copy of ``pykmer_tpu/analysis/nj.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def neighbor_joining(distance: np.ndarray, ids: Sequence[str]) -> str:
    """Newick string of the NJ tree over ``distance`` (n×n, symmetric)."""
    d = np.array(distance, dtype=np.float64)
    n = d.shape[0]
    assert d.shape == (n, n)
    if n < 2:
        raise ValueError("need at least two taxa")
    labels: List[str] = [_escape(i) for i in ids]
    if n == 2:
        half = d[0, 1] / 2.0
        return f"({labels[0]}:{half:f}, {labels[1]}:{half:f});"

    # Conventions below (joined pair written "(j:Lj, i:Li)", the new node
    # prepended to the id list, terminal star written "(id1, id0, id2)")
    # reproduce skbio.tree.nj's newick output exactly on its documented
    # example — see tests/test_analysis.py.
    while d.shape[0] > 3:
        m = d.shape[0]
        row_sums = d.sum(axis=1)
        q = (m - 2) * d - row_sums[:, None] - row_sums[None, :]
        np.fill_diagonal(q, np.inf)
        i, j = np.unravel_index(np.argmin(q), q.shape)
        if i > j:
            i, j = j, i
        li = d[i, j] / 2.0 + (row_sums[i] - row_sums[j]) / (2.0 * (m - 2))
        lj = d[i, j] - li
        new_label = f"({labels[j]}:{lj:f}, {labels[i]}:{li:f})"
        new_row = (d[i, :] + d[j, :] - d[i, j]) / 2.0
        keep = [k for k in range(m) if k not in (i, j)]
        d2 = np.empty((m - 1, m - 1), dtype=np.float64)
        d2[1:, 1:] = d[np.ix_(keep, keep)]
        d2[1:, 0] = new_row[keep]
        d2[0, 1:] = new_row[keep]
        d2[0, 0] = 0.0
        labels = [new_label] + [labels[k] for k in keep]
        d = d2

    # terminal 3-taxon star: branch lengths from the three pairwise distances
    l0 = (d[0, 1] + d[0, 2] - d[1, 2]) / 2.0
    l1 = (d[0, 1] + d[1, 2] - d[0, 2]) / 2.0
    l2 = (d[0, 2] + d[1, 2] - d[0, 1]) / 2.0
    return (
        f"({labels[1]}:{l1:f}, {labels[0]}:{l0:f}, {labels[2]}:{l2:f});"
    )


def _escape(label: str) -> str:
    if any(c in label for c in "(),:;[] \t"):
        return "'" + label.replace("'", "''") + "'"
    return label
