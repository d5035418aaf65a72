"""Per-device defaults of the index configuration.

The configuration itself is ``pykmer_tpu.config.IndexConfig`` (JAX-free);
only :func:`resolve_chunk_windows` is device-specific, and the JAX package's
version asks jax for its backend, so the port has its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pykmer_tpu.config import IndexConfig

# window starts per device chunk: large chunks amortise per-chunk launches
# and the host→device copy on the GPU; the CPU (tests) keeps them small
CUDA_CHUNK_WINDOWS = 1 << 24
CPU_CHUNK_WINDOWS = 1 << 22


def resolve_chunk_windows(
    config: IndexConfig,
    device: torch.device,
    input_hint_bytes: Optional[int] = None,
) -> IndexConfig:
    """Replace a ``chunk_windows=None`` placeholder with the device default.

    ``input_hint_bytes`` (raw input size, when known) clamps the default down
    to the next power of two covering the input (floor 2^16), so a tiny input
    does not pad to a full-size chunk of sentinels. Explicit values are
    honoured as they are.
    """
    if config.chunk_windows is not None:
        return config
    cw = CUDA_CHUNK_WINDOWS if torch.device(device).type == "cuda" else CPU_CHUNK_WINDOWS
    if input_hint_bytes is not None and input_hint_bytes > 0:
        # window count <= base count <= raw byte count
        need = 1 << 16
        while need < input_hint_bytes and need < cw:
            need <<= 1
        cw = min(cw, need)
    return dataclasses.replace(config, chunk_windows=cw)
