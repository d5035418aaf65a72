"""Folded-plane exchange between torch and numpy.

The JAX package carries the folded count plane as ``uint8[R, 128]`` (or flat
when the plane does not tile by 128); the port carries it flat. These two
functions move a plane across in both directions, so a test can seed both
implementations with the same non-empty plane.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


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
