"""Sharded N×N comparison: counterpart of ``pykmer_tpu/parallel/compare.py``.

The merge's per-block step (``ops/compare.block_contingency``) over
cell-space shards: each shard takes a contiguous slice of the block's cells,
computes that slice's N×N partial on its device, and one sum over the shards
(``psum``) adds the block's whole N×N into the int64 accumulator on mesh
device 0. Cell order inside a slice is irrelevant (the product is a sum over
cells), so the result is bit-identical to the unsharded step.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from ..ops.compare import block_contingency, new_workspace
from .collectives import psum
from .mesh import DATA_AXIS, Mesh


def _shard_row(mesh: Mesh) -> List[torch.device]:
    if mesh.shape[DATA_AXIS] != 1:
        raise ValueError("the sharded compare runs on a mesh with one data row")
    return mesh.devices[0]


def shard_bits(bits: np.ndarray, mesh: Mesh) -> List[torch.Tensor]:
    """A block's host ``[n, block/8]`` validity bits cut into the mesh's
    contiguous ``[n, block/8/S]`` byte slices, each on its shard's device."""
    devices = _shard_row(mesh)
    n, nb = bits.shape
    if nb % len(devices):
        raise ValueError(f"{nb} bytes do not split over {len(devices)} shards")
    w = nb // len(devices)
    return [torch.from_numpy(np.ascontiguousarray(bits[:, s * w : (s + 1) * w])).to(d)
            for s, d in enumerate(devices)]


def make_sharded_merge_step(mesh: Mesh, n: int) -> Callable:
    """The sharded block step for ``n`` samples:
    ``step(acc, bits) -> acc`` with ``acc`` the int64 [n, n] accumulator on
    mesh device 0 and ``bits`` the block's S per-shard validity slices
    (``[n, block/8/S]`` uint8 each, on its shard's device, little-endian as
    ``ops/compare`` takes them; see :func:`shard_bits`). Each shard adds its
    slice's V·Vᵀ into a zeroed partial on its device; the partials' psum
    adds into ``acc``."""
    devices = _shard_row(mesh)
    partials = [torch.zeros((n, n), dtype=torch.int64, device=d) for d in devices]
    workspaces = {}  # slice cells -> one zeroed V per shard, made at first use

    def step(acc: torch.Tensor, bits: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(bits) != len(devices):
            raise ValueError(f"a step takes {len(devices)} slices, got {len(bits)}")
        cells = bits[0].shape[1] * 8
        if cells not in workspaces:
            workspaces.clear()
            workspaces[cells] = [new_workspace(n, cells, d) for d in devices]
        for part, b, ws in zip(partials, bits, workspaces[cells]):
            block_contingency(part.zero_(), b, ws)
        acc += psum(partials, acc.device)
        return acc

    step.n_shards = len(devices)
    return step


def make_sharded_pair_matrix(
    mesh: Mesh, n_samples: int, cells_per_shard: int, min_count: int, max_count: int,
) -> Callable[[np.ndarray], torch.Tensor]:
    """``pair_matrix(blocks)``: ``blocks`` a host uint8 ``[N, S·cells]``
    array of counts → the ``[N, N]`` int64 matrix of cells valid in both
    samples (count within ``[min_count, max_count]``), on mesh device 0.
    Shard s takes cells ``[s·cells, (s+1)·cells)``."""
    devices = _shard_row(mesh)
    step = make_sharded_merge_step(mesh, n_samples)
    s_count = len(devices)

    def pair_matrix(blocks: np.ndarray) -> torch.Tensor:
        blocks = np.asarray(blocks).reshape(n_samples, s_count, cells_per_shard)
        valid = (blocks >= min_count) & (blocks <= max_count)
        # each shard's cells pack into whole bytes (zero pad bits = invalid)
        bits = np.packbits(valid, axis=2, bitorder="little")
        acc = torch.zeros((n_samples, n_samples), dtype=torch.int64, device=devices[0])
        return step(acc, [torch.from_numpy(np.ascontiguousarray(bits[:, s])).to(d)
                          for s, d in enumerate(devices)])

    return pair_matrix
