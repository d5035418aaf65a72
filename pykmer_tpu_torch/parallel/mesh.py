"""The device grid of a sharded run: counterpart of ``pykmer_tpu/parallel/mesh.py``.

Axes, as in the JAX package:

- ``shards`` — count-space sharding: the folded count plane is split over the
  devices of a row, interleaved by the code's low bits (folded code ``w``
  lives on shard ``w % S`` at local index ``w // S``);
- ``data`` — data parallelism: the devices of a shard column hold replicas
  of one shard and split the sequence chunks; each replica applies every
  row's updates, so the replicas stay bit-identical.

One process drives the whole grid. Where the JAX package runs one program
per device under ``shard_map``, the port loops over the grid's positions and
copies between their devices explicitly (``parallel/collectives.py``).

A grid may repeat a device: ``[cpu] * n`` is the counterpart of the JAX
tests' virtual CPU mesh, and ``[cuda:0] * n`` places n logical shards on one
card, which runs every device step of an n-shard build for real (it cannot
show a race between two cards).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch

from .. import resolve_device

DATA_AXIS = "data"
SHARD_AXIS = "shards"


class Mesh:
    """An ``[n_data, n_shards]`` grid of ``torch.device``.

    ``devices[r][s]`` is the device of data row r, shard s; ``shape`` maps
    each axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        rows = [list(r) for r in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        types = {d.type for r in rows for d in r}
        if len(types) != 1:
            raise ValueError(f"a mesh holds one device type, got {sorted(types)}")
        self.devices: List[List[torch.device]] = rows
        self.shape: Dict[str, int] = {DATA_AXIS: len(rows), SHARD_AXIS: len(rows[0])}

    @property
    def first(self) -> torch.device:
        """Device 0 of the grid: the one the mesh-wide sums land on."""
        return self.devices[0][0]


def make_mesh(
    n_shards: Optional[int] = None,
    n_data: int = 1,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Mesh:
    """An ``[n_data, n_shards]`` mesh.

    ``devices`` (which may repeat a device) is taken in order, data-major.
    Without it, ``device`` chooses: on CUDA every visible card,
    ``cuda:0 … cuda:{count-1}``; on the CPU ``[cpu] * (n_shards * n_data)``.
    ``n_shards`` defaults to the devices per data row (1 on the CPU).
    Raises ``need N devices, have M`` where there are too few; never moves
    to the CPU when cards are missing."""
    if n_data < 1 or (n_shards is not None and n_shards < 1):
        raise ValueError(f"n_shards and n_data must be positive, got {n_shards}, {n_data}")
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [dev] * ((n_shards or 1) * n_data)
    # a bare 'cuda' becomes the current card, so that tensors' devices
    # compare equal to the mesh's and a same-card copy is skipped
    devices = [resolve_device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    if n_shards is None:
        n_shards = max(len(devices) // n_data, 1)
    need = n_shards * n_data
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh([devices[r * n_shards : (r + 1) * n_shards] for r in range(n_data)])
