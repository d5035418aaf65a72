"""The saturating sweep: counterpart of ``pykmer_tpu/ops/pallas_hist.py``.

:func:`accumulate_sorted` applies one sorted batch of codes to the flat uint8
count plane. On a CUDA tensor it launches the hand-written kernel
(``csrc/sweep.cu``) or raises; on a CPU tensor it runs the plain version,
:func:`pykmer_tpu_torch.ops.histogram.saturating_accumulate_sorted`. Nothing
falls back from one to the other.
"""

from __future__ import annotations

import torch

from .histogram import saturating_accumulate_sorted

# kernel launches in this process; a run resets it to 0 to show that its
# main path went through the kernel (the CPU path does not count)
LAUNCHES = 0


def accumulate_sorted(plane: torch.Tensor, sorted_codes: torch.Tensor) -> torch.Tensor:
    """Apply ``sorted_codes`` to ``plane`` IN PLACE and return ``plane``.

    ``plane`` is a contiguous flat uint8[n_cells]; ``sorted_codes`` a
    contiguous 1-D int32 or int64 tensor, sorted ascending, on the same
    device. For every cell c: ``plane[c] = min(plane[c] + min(n_c, 255),
    255)``, n_c the number of codes equal to c; codes outside
    ``[0, n_cells)`` are ignored. Sortedness is checked on the CPU only: on
    the card the check would cost a device sync per batch, and an unsorted
    batch there gives wrong counts but stays inside the plane.
    """
    global LAUNCHES
    if plane.dtype != torch.uint8 or plane.dim() != 1 or not plane.is_contiguous():
        raise ValueError(
            f"plane must be a contiguous 1-D uint8 tensor, got {plane.dtype} "
            f"{tuple(plane.shape)} contiguous={plane.is_contiguous()}"
        )
    if sorted_codes.dtype not in (torch.int32, torch.int64) \
            or sorted_codes.dim() != 1 or not sorted_codes.is_contiguous():
        raise ValueError(
            f"codes must be a contiguous 1-D int32/int64 tensor, got "
            f"{sorted_codes.dtype} {tuple(sorted_codes.shape)}"
        )
    if plane.device != sorted_codes.device:
        raise ValueError(f"plane on {plane.device}, codes on {sorted_codes.device}")
    m = sorted_codes.shape[0]
    if plane.device.type == "cpu":
        if m > 1 and bool((sorted_codes[1:] < sorted_codes[:-1]).any()):
            raise ValueError("codes are not sorted ascending")
        return saturating_accumulate_sorted(plane, sorted_codes)
    if plane.device.type != "cuda":
        raise ValueError(f"no sweep for device {plane.device}")
    if m == 0:
        return plane

    from ._build import load

    lib = load()
    fn = lib.pykmer_sweep_sorted_i32 if sorted_codes.dtype == torch.int32 \
        else lib.pykmer_sweep_sorted_i64
    with torch.cuda.device(plane.device):
        err = fn(plane.data_ptr(), plane.shape[0], sorted_codes.data_ptr(), m,
                 torch.cuda.current_stream(plane.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return plane
