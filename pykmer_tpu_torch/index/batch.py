"""Batch indexing: many FASTA inputs in one process.

Port of ``pykmer_tpu/index/batch.py`` on the port's ``create_fasta_index``.
One process indexes every input, so the kernels build and load once and the
pooled host buffers are reused. Files whose ``.kin`` (or ``.kin.bgz``)
already exists are skipped unless ``overwrite`` is set, so a batch resumes at
file granularity; with ``bgzip`` a file is done once its ``.kin.bgz`` and
``.gzi`` exist, which the index renames into place whole. A failing input is
reported and the batch goes on.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Union

import torch

from ..config import IndexConfig, resolve_chunk_windows
from ..formats import kin as kinfmt
from .. import resolve_device
from .indexer import create_fasta_index


@dataclass
class BatchResult:
    indexed: List[str] = field(default_factory=list)
    skipped: List[str] = field(default_factory=list)
    failed: List[str] = field(default_factory=list)  # "path: error" strings
    total_bp: int = 0
    elapsed_s: float = 0.0


def outputs_exist(input_file: str, kmer_len: int, bgzip: bool = False) -> bool:
    """Whether ``input_file``'s index is there: its `.kin` or `.kin.bgz`, or
    with ``bgzip`` its `.kin.bgz` and `.gzi`."""
    root = kinfmt.kin_root_path(input_file, kmer_len)
    bgz = root + "." + kinfmt.COMP_EXT
    if bgzip:
        return os.path.exists(bgz) and os.path.exists(bgz + ".gzi")
    return os.path.exists(root) or os.path.exists(bgz)


def sample_name(input_file: str) -> str:
    """Default sample name: the basename up to its first dot."""
    return os.path.basename(input_file).split(".")[0]


def index_batch(
    inputs: List[str],
    kmer_len: int,
    config: Optional[IndexConfig] = None,
    overwrite: bool = False,
    bgzip: bool = False,
    verify: bool = True,
    verbose: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> BatchResult:
    """Index every FASTA in ``inputs`` on ``device``, one after another.

    Existing outputs are skipped unless ``overwrite``; a failing input is
    reported and the batch continues (each file's tmp + rename leaves no
    partial ``.kin`` behind)."""
    device = resolve_device(device)
    config = resolve_chunk_windows(config or IndexConfig(kmer_len=kmer_len), device)
    result = BatchResult()
    t0 = time.monotonic()

    todo = []
    for path in inputs:
        if not overwrite and outputs_exist(path, kmer_len, bgzip):
            result.skipped.append(path)
            if verbose:
                print(f"skip {path} (index exists)")
            continue
        todo.append(path)

    for path in todo:
        try:
            header = create_fasta_index(
                path, sample_name(path), path, kmer_len,
                overwrite=True, config=config, verify=verify,
                verbose=verbose, device=device, bgzip=bgzip,
            )
        except Exception as exc:  # keep the batch going
            result.failed.append(f"{path}: {exc}")
            print(f"FAILED {path}: {exc}", file=sys.stderr)
            continue
        result.indexed.append(path)
        result.total_bp += sum(c[1] for c in header.chromosomes)
        if bgzip and verbose:
            bgz = header.index_file_root + "." + kinfmt.COMP_EXT
            print(f"wrote {bgz} + {bgz}.gzi")

    result.elapsed_s = time.monotonic() - t0
    if verbose:
        rate = result.total_bp / result.elapsed_s if result.elapsed_s else 0.0
        print(
            f"batch done: {len(result.indexed)} indexed, "
            f"{len(result.skipped)} skipped, {len(result.failed)} failed, "
            f"{result.total_bp:,} bp in {result.elapsed_s:.1f}s "
            f"({rate:,.0f} bp/s)"
        )
    return result
