"""The collectives of the sharded step, written out as copies between devices.

Counterparts of the ``shard_map`` collectives that
``pykmer_tpu/parallel/histogram.py`` and ``parallel/compare.py`` use. One
process holds every position's tensors, so each collective is a set of
copies:

- :func:`all_to_all` along ``shards`` (``jax.lax.all_to_all(..., tiled=True)``):
  row j of source i goes to shard j, stacked in source order;
- :func:`all_gather` along ``data`` (``jax.lax.all_gather(..., tiled=True)``);
- :func:`ppermute` (``jax.lax.ppermute``): part i goes to position j for
  each pair (i, j) of a permutation, the halo exchange of
  ``parallel/encode.py``;
- :func:`psum` and :func:`pmax` of per-position 0-d or small tensors, into
  one device.

Every cross-device copy is ordered explicitly: an event recorded on the
producer's current stream is waited on by the consumer's current stream
before the copy is queued (PyTorch's own cross-device copy adds a two-way
barrier of the same kind). A copy from a device to the same device
costs nothing in :func:`move` and one device-local copy where a collective
stacks rows into one buffer. Nothing here synchronises the host.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def move(t: torch.Tensor, dst: torch.device) -> torch.Tensor:
    """``t`` on ``dst``: ``t`` itself on its own device, else a copy made
    after the producer's work on ``t`` (an event on its stream)."""
    if t.device == dst:
        return t
    _order(t.device, dst)
    return t.to(dst, non_blocking=True)


def _order(src: torch.device, dst: torch.device) -> None:
    """Make ``dst``'s current stream wait for the work queued so far on
    ``src``'s current stream, where they are two cards."""
    if src == dst or src.type != "cuda" or dst.type != "cuda":
        return
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(src))
    torch.cuda.current_stream(dst).wait_event(ready)


def _stack_into(parts: Sequence[torch.Tensor], dst: torch.device) -> torch.Tensor:
    """``torch.stack(parts)`` built on ``dst`` (one buffer, one copy per
    part; cross-device parts ordered by :func:`_order`)."""
    out = torch.empty((len(parts), *parts[0].shape), dtype=parts[0].dtype, device=dst)
    for i, p in enumerate(parts):
        _order(p.device, dst)
        out[i].copy_(p, non_blocking=True)
    return out


def all_to_all(
    send: Sequence[torch.Tensor], devices: Sequence[torch.device]
) -> List[torch.Tensor]:
    """Exchange along ``shards``: ``send[i]`` is source i's [S, ...] tensor;
    returns, for each destination j, the [S, ...] tensor on ``devices[j]``
    whose row i is ``send[i][j]``."""
    if len(send) != len(devices) or any(t.shape[0] != len(devices) for t in send):
        raise ValueError(f"all_to_all over {len(devices)} devices needs that many "
                         f"[{len(devices)}, ...] tensors")
    return [_stack_into([t[j] for t in send], dst) for j, dst in enumerate(devices)]


def all_gather(
    parts: Sequence[torch.Tensor], devices: Sequence[torch.device]
) -> List[torch.Tensor]:
    """Gather along ``data``: ``parts[r]`` is row r's [n, ...] tensor; returns,
    for each r, the [R·n, ...] concatenation in row order on ``devices[r]``."""
    if len(parts) != len(devices):
        raise ValueError(f"all_gather over {len(devices)} devices got {len(parts)} parts")
    if len(parts) == 1:
        return [move(parts[0], devices[0])]
    return [_stack_into(parts, dst).flatten(0, 1) for dst in devices]


def ppermute(
    parts: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]
) -> List[torch.Tensor]:
    """``parts[i]`` lies on position i's device; for each ``(src, dst)`` of
    ``perm`` returns ``parts[src]`` on ``parts[dst]``'s device at index dst,
    and zeros where no pair names dst as its destination (as
    ``jax.lax.ppermute``). No source or destination may repeat."""
    n = len(parts)
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if any(not 0 <= i < n for i in srcs + dsts) \
            or len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute over {n} positions got the permutation {list(perm)}")
    out = [None] * n
    for src, dst in perm:
        out[dst] = move(parts[src], parts[dst].device)
    return [torch.zeros_like(p) if o is None else o for p, o in zip(parts, out)]


def psum(values: Sequence[torch.Tensor], dst: torch.device) -> torch.Tensor:
    """The sum of ``values`` (equal shapes, one per position) on ``dst``."""
    total = move(values[0], dst).clone()
    for v in values[1:]:
        total += move(v, dst)
    return total


def pmax(values: Sequence[torch.Tensor], dst: torch.device) -> torch.Tensor:
    """The elementwise max of ``values`` on ``dst``."""
    out = move(values[0], dst)
    for v in values[1:]:
        out = torch.maximum(out, move(v, dst))
    return out
