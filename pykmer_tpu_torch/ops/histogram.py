"""Keys-only sort and the plain saturating accumulate (torch ops).

The `.kin` array is ``min(total_count, 255)`` per canonical code, so applying
a batch as ``plane[c] = min(plane[c] + min(n_c, 255), 255)`` — n_c the
batch's count of code c — gives the same plane whatever the batching (see
``pykmer_tpu/ops/histogram.py``). :func:`saturating_accumulate_sorted` is the
plain version of the CUDA sweep kernel (``ops/sweep.py``): the CPU path and
the reference the kernel is held against on the card.
"""

from __future__ import annotations

import torch

from pykmer_tpu.config import MAX_VAL


def sort_codes_fast(codes: torch.Tensor) -> torch.Tensor:
    """Keys-only unstable sort. Every code domain here is non-negative
    (canonical/folded codes, sentinels), so signed order is the unsigned
    order the JAX package sorts in, and stability cannot change a keys-only
    result."""
    return torch.sort(codes, stable=False).values


def saturating_accumulate_sorted(
    plane: torch.Tensor, sorted_codes: torch.Tensor
) -> torch.Tensor:
    """Apply one sorted batch of codes to the flat uint8 ``plane``, IN PLACE.

    For each run of equal codes c (its head and length found with a
    neighbour compare), ``plane[c] = min(plane[c] + min(run, 255), 255)``.
    Codes outside ``[0, plane.numel())`` — sentinels, pad, the -1 band — are
    ignored. Returns ``plane``.
    """
    m = sorted_codes.shape[0]
    if m == 0:
        return plane
    is_head = torch.ones(m, dtype=torch.bool, device=sorted_codes.device)
    torch.ne(sorted_codes[1:], sorted_codes[:-1], out=is_head[1:])
    heads = torch.nonzero(is_head).reshape(-1)
    ends = torch.cat([heads[1:], heads.new_tensor([m])])
    cells = sorted_codes[heads].to(torch.int64)
    keep = (cells >= 0) & (cells < plane.shape[0])
    cells = cells[keep]
    run = (ends - heads)[keep].clamp_(max=MAX_VAL)
    new = (plane[cells].to(torch.int64) + run).clamp_(max=MAX_VAL)
    plane[cells] = new.to(torch.uint8)
    return plane
