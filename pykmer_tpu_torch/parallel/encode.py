"""Sequence-parallel encoding with a ring halo exchange: counterpart of
``pykmer_tpu/parallel/encode.py``.

A base-code sequence lies sharded along ``shards``, ``shard_len`` bases on
each shard's device. Each shard needs the first K-1 bases of its right
neighbour to close its last windows: every shard sends its head to its left
neighbour (:func:`collectives.ppermute` around the ring), the last shard
takes K-1 invalid bases (4) in place of the wrapped-around head, so its tail
windows are sentinels, and each shard encodes its bases plus the halo with
:func:`ops.encode.canonical_codes` (the bases kernel on CUDA). The codes of
data row 0 come back, in shard order, on ``mesh.first``: unfolded, in
``code_dtype``, sentinel ``4^K``. Every data row computes the same codes, as
the JAX package's layout replicates the sequence over ``data``.

The indexers do not route through this: the host framer hands every chunk
its K-1 overlap bases inline. It is the primitive for a sequence that is
born on the devices.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from ..ops.encode import canonical_codes
from .collectives import _stack_into, move, ppermute
from .mesh import SHARD_AXIS, Mesh


def make_halo_encode(mesh: Mesh, kmer_len: int, shard_len: int) -> Callable:
    """Returns ``encode(seq)``: uint8 base codes ``[S * shard_len]`` (numpy
    or a tensor) → canonical codes ``[S * shard_len]`` on ``mesh.first``, one
    per window start, the sentinel where a window holds an invalid base or
    runs past the sequence's end."""
    n_shards = mesh.shape[SHARD_AXIS]
    halo = kmer_len - 1
    if shard_len < max(halo, 1):
        raise ValueError(f"shard_len {shard_len} is shorter than the K-1 = {halo} "
                         f"bases of the halo")
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    def encode(seq: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        seq = torch.as_tensor(seq)
        if seq.dtype != torch.uint8 or seq.shape != (n_shards * shard_len,):
            raise ValueError(f"seq must be uint8[{n_shards * shard_len}], got "
                             f"{seq.dtype} {tuple(seq.shape)}")
        rows = []
        for row in mesh.devices:
            local = [move(seq[s * shard_len : (s + 1) * shard_len], d).contiguous()
                     for s, d in enumerate(row)]
            heads = ppermute([t[:halo] for t in local], perm)
            heads[-1] = torch.full((halo,), 4, dtype=torch.uint8, device=row[-1])
            rows.append([canonical_codes(torch.cat([t, h]), kmer_len)
                         for t, h in zip(local, heads)])
        return _stack_into(rows[0], mesh.first).reshape(-1)

    return encode
