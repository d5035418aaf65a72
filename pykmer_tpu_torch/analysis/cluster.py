"""Clustering outputs: distance-matrix serialisations + NJ tree files.

Replaces the reference's skbio/ete3 dependencies (calculate_distance.py:111-235)
with self-contained implementations producing the same file set:

    {base}.mat.redundant.np      full symmetric matrix (np.save)
    {base}.mat.redundant.lsmat   tab-separated labelled matrix (skbio lsmat)
    {base}.mat.condensed.np      condensed upper-triangle vector (np.save)
    {base}.mat.condensed.txt     np.savetxt of the condensed vector
    {base}.newick                NJ tree (skbio-style newick)
    {base}.tree                  ASCII tree art (ete3-style)
    {base}.png                   rendered tree (matplotlib; ete3 replacement)

Copy of ``pykmer_tpu/analysis/cluster.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
from scipy.spatial.distance import squareform

from .nj import neighbor_joining
from .tree import parse_newick, render_ascii, render_png


class DistanceMatrix:
    """Labelled symmetric hollow distance matrix (skbio-compatible surface)."""

    def __init__(self, data: np.ndarray, ids: Sequence[str]):
        data = np.asarray(data, dtype=np.float64)
        n = data.shape[0]
        if data.shape != (n, n):
            raise ValueError("distance matrix must be square")
        if len(ids) != n:
            raise ValueError("ids length must match matrix size")
        if len(set(ids)) != n:
            raise ValueError("ids must be unique")
        if not np.allclose(data, data.T):
            raise ValueError("distance matrix must be symmetric")
        if not np.allclose(np.diagonal(data), 0.0):
            raise ValueError("distance matrix must be hollow (zero diagonal)")
        self.data = data
        self.ids = list(ids)

    @property
    def shape(self):
        return self.data.shape

    def redundant_form(self) -> np.ndarray:
        return self.data

    def condensed_form(self) -> np.ndarray:
        return squareform(self.data, force="tovector", checks=False)

    def write_lsmat(self, fh) -> None:
        fh.write("\t" + "\t".join(self.ids) + "\n")
        for i, row_id in enumerate(self.ids):
            vals = "\t".join(str(float(v)) for v in self.data[i])
            fh.write(f"{row_id}\t{vals}\n")


def cluster_distance(
    matrix_file: str,
    basefile: str,
    distance: np.ndarray,
    names_file: Optional[str] = None,
    load_header: bool = True,
    save_matrix_redundant_tsv: bool = True,
    save_matrix_redundant_np: bool = True,
    save_matrix_condensed_tsv: bool = True,
    save_matrix_condensed_np: bool = True,
    save_tree_newick: bool = True,
    save_tree_ascii: bool = True,
    save_tree_png: bool = True,
) -> np.ndarray:
    """Write the full clustering output set; returns the redundant matrix."""
    from .distance import read_names_file, sample_ids_from_kma_json

    if load_header:
        project_name, ids = sample_ids_from_kma_json(matrix_file)
        assert len(ids) == distance.shape[0]
    else:
        project_name = str(matrix_file)
        ids = [str(i + 1) for i in range(distance.shape[0])]

    if names_file:
        names = read_names_file(names_file)
        ids = [names.get(i, i) for i in ids]

    dm = DistanceMatrix(distance, ids)
    num_samples = len(ids)

    dmr = dm.redundant_form()
    if save_matrix_redundant_np:
        with open(f"{basefile}.mat.redundant.np", "wb") as fh:
            np.save(fh, dmr, allow_pickle=False)
    if save_matrix_redundant_tsv:
        with open(f"{basefile}.mat.redundant.lsmat", "wt") as fh:
            dm.write_lsmat(fh)

    if save_matrix_condensed_np or save_matrix_condensed_tsv:
        dmc = dm.condensed_form()
        if save_matrix_condensed_np:
            with open(f"{basefile}.mat.condensed.np", "wb") as fh:
                np.save(fh, dmc, allow_pickle=False)
        if save_matrix_condensed_tsv:
            with open(f"{basefile}.mat.condensed.txt", "wt") as fh:
                np.savetxt(fh, dmc)

    if save_tree_newick or save_tree_ascii or save_tree_png:
        newick = neighbor_joining(dm.data, dm.ids)
        if save_tree_newick:
            with open(f"{basefile}.newick", "wt") as fh:
                fh.write(newick)
        if save_tree_ascii or save_tree_png:
            tree = parse_newick(newick)
            if save_tree_ascii:
                with open(f"{basefile}.tree", "wt") as fh:
                    fh.write(render_ascii(tree))
            if save_tree_png:
                # geometry mirrors the reference's ete3 TreeStyle settings
                # (calculate_distance.py:214-233)
                font_size = 12
                height = font_size * 4 * (num_samples + 5)
                width = height // 2
                render_png(
                    tree,
                    f"{basefile}.png",
                    title=str(project_name),
                    height_px=height,
                    width_px=width,
                    dpi=72,
                )
    return dmr
