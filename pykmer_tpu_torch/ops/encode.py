"""Canonical k-mer encoding as torch ops (port of ``pykmer_tpu/ops/encode.py``).

Semantics are those of the JAX package: forward code
``sum_p base[i+p] * 4^(K-1-p)``, reverse-complement code
``sum_p (3 - base[i+p]) * 4^p``, canonical = min(fwd, rev); a window holding
an invalid base (code >= 4) encodes as the sentinel ``4^K`` (``4^K / 2`` once
folded).

One formulation for every chunk and every K: :func:`canonical_codes` sums K
shifted slices of the unpacked chunk. It is bit-exact with both of the JAX
package's encoders (its slice encoder and its bit-field packed encoder for
all-valid chunks), so the port keeps no second encoder. These are plain
tensor programs, not kernels.
"""

from __future__ import annotations

import torch


def code_dtype(kmer_len: int) -> torch.dtype:
    """Smallest integer dtype holding 4^K (plus the invalid-base headroom).

    fwd sums reach ``4 * (4^K - 1) / 3`` when invalid bases (code 4) are
    present, so K=15 still fits int32 (1.43e9 < 2^31); K>=17 needs int64.
    """
    return torch.int32 if kmer_len <= 15 else torch.int64


def canonical_codes(chunk: torch.Tensor, kmer_len: int) -> torch.Tensor:
    """All window codes of a chunk.

    chunk: uint8[S + K - 1] base codes (0..3 valid, >=4 invalid).
    returns: [S] canonical codes in ``code_dtype``; invalid windows = 4^K.
    """
    k = kmer_len
    s = chunk.shape[0] - k + 1
    if s <= 0:
        raise ValueError("chunk shorter than one window")
    dt = code_dtype(k)
    x = chunk.to(dt)
    fwd = torch.zeros(s, dtype=dt, device=chunk.device)
    rev = torch.zeros(s, dtype=dt, device=chunk.device)
    bad = torch.zeros(s, dtype=torch.bool, device=chunk.device)
    for p in range(k):
        sl = x[p : p + s]
        fwd += sl * (4 ** (k - p - 1))
        rev += (3 - sl) * (4**p)
        bad |= chunk[p : p + s] >= 4
    canon = torch.minimum(fwd, rev)
    return canon.masked_fill_(bad, 4**k)


def fold_codes(codes: torch.Tensor, kmer_len: int) -> torch.Tensor:
    """Map canonical codes into the folded half-space ``min(c, M - c)``
    (M = 4^K - 1); the sentinel 4^K maps to the folded sentinel 4^K / 2."""
    m = 4**kmer_len - 1
    folded = torch.minimum(codes, m - codes)
    return folded.masked_fill_(codes > m, 4**kmer_len // 2)


def unpack_base_2bit_mask(
    bases: torch.Tensor, mask: torch.Tensor, span: int
) -> torch.Tensor:
    """Inverse of ``host.chunks.pack_base_stream``: [span] uint8 base codes
    with invalid positions restored to 4."""
    v = _unpack(mask, 1)[:span]
    return unpack_base_2bit(bases, span).masked_fill_(v == 0, 4)


def unpack_base_2bit(bases: torch.Tensor, span: int) -> torch.Tensor:
    """Mask-free variant for all-valid chunks: [span] uint8 base codes."""
    return _unpack(bases, 2)[:span]


def _unpack(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Little-endian ``width``-bit fields of a uint8 plane, one per byte."""
    shifts = torch.arange(0, 8, width, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts) & ((1 << width) - 1)).reshape(-1)
