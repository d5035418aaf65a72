"""kWIP cross-validation harness (reference kwip/calculate_distance.py).

kWIP is an independent C++ k-mer distance tool the reference uses as an
external oracle (kwip/README.md:10-31): run it over the same genomes, then
cluster its ``.dist`` TSV matrix with the same pipeline and compare trees.
This module ingests that TSV and produces the identical clustering output
set (``.mat.redundant.*``, ``.mat.condensed.*``, ``.newick``, ``.tree``,
``.png``) via our own DistanceMatrix/NJ implementations.

Copy of ``pykmer_tpu/analysis/kwip.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .cluster import cluster_distance


def read_kwip_dist(dist_file: str) -> Tuple[np.ndarray, list]:
    """Parse a kWIP `.dist` matrix (TSV, row/column sample labels)."""
    import pandas as pd

    frame = pd.read_csv(dist_file, sep="\t", index_col=0)
    ids = [str(c) for c in frame.columns]
    matrix = frame.to_numpy(dtype=np.float64)
    if matrix.shape[0] != matrix.shape[1]:
        raise ValueError(f"{dist_file}: kwip distance matrix must be square")
    # kwip matrices can carry tiny asymmetries / non-zero diagonals from
    # float formatting; normalise like the reference pipeline does implicitly
    matrix = (matrix + matrix.T) / 2.0
    np.fill_diagonal(matrix, 0.0)
    return matrix, ids


def load_kwip(dist_file: str, names_file: Optional[str] = None) -> np.ndarray:
    """Cluster a kWIP distance matrix with the standard output set."""
    matrix, ids = read_kwip_dist(dist_file)

    import json
    import os

    # reuse cluster_distance's file layout with the TSV-derived ids: write a
    # minimal sidecar so load_header can resolve them
    basefile = f"{dist_file}.dist.kwip"
    from .cluster import DistanceMatrix
    from .nj import neighbor_joining
    from .tree import parse_newick, render_ascii, render_png
    from .distance import read_names_file

    if names_file and os.path.exists(names_file):
        names = read_names_file(names_file)
        ids = [names.get(i, i) for i in ids]

    dm = DistanceMatrix(matrix, ids)
    with open(f"{basefile}.mat.redundant.np", "wb") as fh:
        np.save(fh, dm.redundant_form(), allow_pickle=False)
    with open(f"{basefile}.mat.redundant.lsmat", "wt") as fh:
        dm.write_lsmat(fh)
    with open(f"{basefile}.mat.condensed.np", "wb") as fh:
        np.save(fh, dm.condensed_form(), allow_pickle=False)
    with open(f"{basefile}.mat.condensed.txt", "wt") as fh:
        np.savetxt(fh, dm.condensed_form())
    newick = neighbor_joining(matrix, ids)
    with open(f"{basefile}.newick", "wt") as fh:
        fh.write(newick)
    tree = parse_newick(newick)
    with open(f"{basefile}.tree", "wt") as fh:
        fh.write(render_ascii(tree))
    render_png(tree, f"{basefile}.png", title=os.path.basename(dist_file),
               height_px=12 * 4 * (len(ids) + 5), width_px=12 * 2 * (len(ids) + 5),
               dpi=72)
    return dm.redundant_form()


def _normalise_sample_id(sid: str) -> str:
    """Strip tool-specific suffixes so kWIP hash names match `.kma` sample
    ids (kWIP labels samples `<input>.khmer`, our matrices use the input
    file name — reference kwip/README.md labels vs calculate_distance ids).
    """
    import os

    base = os.path.basename(str(sid))
    for suffix in (".khmer", ".ct", ".ct.gz"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    return base


def compare_with_kma(dist_file: str, kma_file: str) -> dict:
    """Agreement report between a kWIP `.dist` matrix and our `.kma`-derived
    Jaccard distances over the same samples (the reference's external-oracle
    cross-validation, kwip/README.md:180-239 — two independent k-mer
    engines should induce the same sample geometry).

    Matches samples by normalised name, then reports Pearson and Spearman
    correlation of the common condensed distances plus the fraction of
    samples whose nearest neighbour agrees. Raises if fewer than 3 samples
    match (no meaningful geometry to compare).
    """
    from .distance import jaccard_from_kma

    kw_matrix, kw_ids = read_kwip_dist(dist_file)
    ja_matrix, ja_ids = jaccard_from_kma(kma_file)

    kw_map = {_normalise_sample_id(i): n for n, i in enumerate(kw_ids)}
    ja_map = {_normalise_sample_id(i): n for n, i in enumerate(ja_ids)}
    common = sorted(set(kw_map) & set(ja_map))
    if len(common) < 3:
        raise ValueError(
            f"only {len(common)} samples match between {dist_file} "
            f"({sorted(kw_map)[:5]}...) and {kma_file} "
            f"({sorted(ja_map)[:5]}...)"
        )
    a = kw_matrix[np.ix_([kw_map[c] for c in common],
                         [kw_map[c] for c in common])]
    b = ja_matrix[np.ix_([ja_map[c] for c in common],
                         [ja_map[c] for c in common])]
    n = len(common)
    iu = np.triu_indices(n, k=1)
    x, y = a[iu], b[iu]

    def pearson(u, v):
        u = u - u.mean()
        v = v - v.mean()
        denom = float(np.sqrt((u * u).sum() * (v * v).sum()))
        return float((u * v).sum() / denom) if denom else float("nan")

    def rank(u):
        # average ranks for ties (standard Spearman; plain argsort ranks
        # would make the statistic depend on sample order when distances
        # tie, e.g. multiple pairs saturating at 1.0)
        order = np.argsort(u, kind="stable")
        su = u[order]
        starts = np.flatnonzero(
            np.concatenate([[True], su[1:] != su[:-1]])
        )
        ends = np.append(starts[1:], su.shape[0])
        mean_rank = (starts + ends - 1) / 2.0
        group_of = np.cumsum(
            np.concatenate([[False], su[1:] != su[:-1]])
        )
        r = np.empty(u.shape[0], dtype=np.float64)
        r[order] = mean_rank[group_of]
        return r

    # nearest-neighbour agreement (diagonal excluded)
    a_ex, b_ex = a.copy(), b.copy()
    np.fill_diagonal(a_ex, np.inf)
    np.fill_diagonal(b_ex, np.inf)
    a_nn = np.argmin(a_ex, axis=1)
    b_nn = np.argmin(b_ex, axis=1)
    return {
        "n_samples": n,
        "pearson": pearson(x, y),
        "spearman": pearson(rank(x), rank(y)),
        "nn_agreement": float((a_nn == b_nn).mean()),
        "samples": common,
    }
