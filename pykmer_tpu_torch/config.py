"""Typed configuration of the port, and its per-device defaults.

``IndexConfig``, ``MergeConfig`` and the module constants are
a copy of ``pykmer_tpu/config.py`` (held against it by
``tests/test_torch_copies.py``), without its JAX-backend
``resolve_chunk_windows``. :func:`resolve_chunk_windows` and
:func:`resolve_strategy` are device-specific: the JAX package's versions ask
jax for its backend, so the port has its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DEFAULT_FLUSH_EVERY = 100_000_000
DEFAULT_MIN_FRAG_SIZE = 500_000_000
DEFAULT_MAX_FRAG_SIZE = 1_000_000_000
DEFAULT_MIN_COUNT = 1
DEFAULT_MAX_COUNT = 255
DEFAULT_BLOCK_SIZE = 100_000_000
DEFAULT_THREADS = 4
MAX_VAL = 255  # uint8 saturation ceiling (reference tools.py:217)


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Configuration of one indexing run (FASTA → .kin)."""

    kmer_len: int
    # host→device streaming: number of window starts per device chunk.
    # ``None`` resolves per backend at run start (resolve_chunk_windows):
    # 16M windows on TPU — fewer dispatch/upload round-trips dominate there
    # (measured 9.1 s → 5.1 s ingest at 840 Mbp vs 4M windows) — and 4M
    # elsewhere (XLA CPU compile time scales with batch size).
    chunk_windows: Optional[int] = None
    # kmer codes buffered on device before a dense-array accumulate
    flush_every: int = DEFAULT_FLUSH_EVERY
    min_frag_size: int = DEFAULT_MIN_FRAG_SIZE
    max_frag_size: int = DEFAULT_MAX_FRAG_SIZE
    # device strategy: "auto" | "device" (HBM-resident dense array) | "host"
    # (host-RAM dense array for count spaces exceeding HBM, e.g. K=17 1-chip)
    accumulate: str = "auto"
    # accumulate kernel: "auto" picks the Pallas tile-sweep on TPU for large
    # count spaces (XLA scatter lowers to a serial loop there) and the XLA
    # sort+scan path elsewhere
    kernel: str = "auto"
    # final device→host fetch: "auto" uses 4-bit packed readback for large
    # arrays over slow host links; "raw"/"packed" force a path
    readback: str = "auto"

    def __post_init__(self) -> None:
        if self.kmer_len <= 0 or self.kmer_len % 2 == 0:
            raise ValueError(
                f"kmer_len must be a positive odd integer, got {self.kmer_len}"
            )
        if self.chunk_windows is not None and self.chunk_windows % 8:
            raise ValueError(
                f"chunk_windows must be a multiple of 8 (bit-packed upload "
                f"alignment), got {self.chunk_windows}"
            )


@dataclasses.dataclass(frozen=True)
class MergeConfig:
    """Configuration of one merge run (N×.kin → .kma)."""

    min_count: int = DEFAULT_MIN_COUNT
    max_count: int = DEFAULT_MAX_COUNT
    block_size: int = DEFAULT_BLOCK_SIZE
    threads: int = DEFAULT_THREADS
    # device engine: bit-pack validity masks once per sample, AND+popcount pairs
    engine: str = "auto"  # "auto" | "device" | "stream"


# window starts per device chunk: large chunks amortise per-chunk launches
# and the host→device copy on the GPU; the CPU (tests) keeps them small
CUDA_CHUNK_WINDOWS = 1 << 24
CPU_CHUNK_WINDOWS = 1 << 22


# a generous bound on step A's transient device bytes per window (the
# unpacked bases, the int64 encode temporaries, the fold, the sort's values,
# indices and scratch)
STEP_A_BYTES_PER_WINDOW = 128
# the JAX package's rule off the card: the dense plane lives on the device
# while 4^K fits in 4 GiB
HOST_DENSE_LIMIT = 4 << 30


def resolve_strategy(
    kmer_len: int,
    accumulate: str,
    device_type: str,
    free_bytes: Optional[int] = None,
    chunk_windows: int = CUDA_CHUNK_WINDOWS,
) -> str:
    """Where the count plane lives: ``"device"`` or ``"host"``.

    An explicit ``accumulate`` ("device" / "host") is honoured. For "auto" on
    CUDA the device strategy is taken when the folded plane (4^K / 2 bytes)
    plus step A's workspace fits ``free_bytes`` (the card's free memory, as
    ``torch.cuda.mem_get_info`` gives it): K=17's 8 GiB plane on an 80 GB
    card, not K=19's 128 GiB. Off the card the JAX package's rule holds:
    ``device`` iff 4^K <= 4 GiB."""
    if accumulate in ("device", "host"):
        return accumulate
    if accumulate != "auto":
        raise ValueError(f"accumulate must be auto, device or host, got {accumulate!r}")
    if device_type == "cuda":
        if free_bytes is None:
            raise ValueError("the CUDA strategy needs the card's free bytes")
        need = 4**kmer_len // 2 + STEP_A_BYTES_PER_WINDOW * chunk_windows
        return "device" if need <= free_bytes else "host"
    return "device" if 4**kmer_len <= HOST_DENSE_LIMIT else "host"


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
