"""Count-plane exchange between torch and numpy.

The JAX package carries the folded count plane as ``uint8[R, 128]`` (or flat
when the plane does not tile by 128); the port carries it flat. A sharded
run carries it as ``[S, local]`` shards — the array the JAX package
checkpoints — which the port holds as one local plane per mesh position.
These functions move a plane across in both directions, so a test can seed
both implementations with the same non-empty plane, and a checkpoint written
by either package resumes in the other.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from .parallel.mesh import Mesh


def plane_from_numpy(
    folded: np.ndarray, device: Union[str, torch.device]
) -> torch.Tensor:
    """A flat uint8 plane on ``device`` holding a copy of ``folded``
    ([R, lanes] or flat uint8)."""
    arr = np.asarray(folded)
    if arr.dtype != np.uint8 or arr.ndim not in (1, 2):
        raise ValueError(f"folded plane must be 1-D or 2-D uint8, got {arr.dtype} {arr.shape}")
    flat = np.ascontiguousarray(arr.reshape(-1))
    return torch.from_numpy(flat.copy()).to(torch.device(device))


def plane_to_numpy(plane: torch.Tensor) -> np.ndarray:
    """A flat uint8 numpy copy of ``plane``."""
    if plane.dtype != torch.uint8:
        raise ValueError(f"plane must be uint8, got {plane.dtype}")
    return plane.detach().reshape(-1).cpu().numpy().copy()


def shards_from_numpy(shards: np.ndarray, mesh: Mesh) -> List[List[torch.Tensor]]:
    """The local planes of ``mesh`` (``[R][S]``, each replica a copy) holding
    ``shards``, a uint8 ``[S, local]`` array."""
    arr = np.asarray(shards)
    n_shards = len(mesh.devices[0])
    if arr.dtype != np.uint8 or arr.ndim != 2 or arr.shape[0] != n_shards:
        raise ValueError(f"shards must be uint8 [{n_shards}, local], got {arr.dtype} {arr.shape}")
    return [[torch.from_numpy(arr[s].copy()).to(d) for s, d in enumerate(row)]
            for row in mesh.devices]


def shards_to_numpy(planes: Sequence[Sequence[torch.Tensor]]) -> np.ndarray:
    """The uint8 ``[S, local]`` array of replica 0's local planes."""
    return np.stack([plane_to_numpy(p) for p in planes[0]])
