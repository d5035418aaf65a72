"""Canonical k-mer encoding: counterpart of ``pykmer_tpu/ops/encode.py``.

Semantics are those of the JAX package: forward code
``sum_p base[i+p] * 4^(K-1-p)``, reverse-complement code
``sum_p (3 - base[i+p]) * 4^p``, canonical = min(fwd, rev); a window holding
an invalid base (code >= 4) encodes as the sentinel ``4^K`` (``4^K / 2`` once
folded).

Two entry points, each with a hand-written CUDA kernel (``csrc/encode.cu``,
every window encoded in registers from bytes staged in shared memory, the
codes written once) and a plain torch version in this module:

- :func:`canonical_codes_packed`: folded codes straight from the packed
  upload planes (the main path's step A, every chunk, masked or all-valid),
  optionally adding the number of valid windows to a counter as it writes
  them; its plain version unpacks the planes, sums K shifted slices and
  folds;
- :func:`canonical_codes`: unfolded codes of a uint8 base-code chunk (the
  halo encoder's); its plain version sums K shifted slices.

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it runs
the plain version. Nothing falls back from one to the other. Both are
bit-exact with the JAX package's encoders (its slice encoder and its
bit-field packed encoder), at every K the dtype holds (1..31).
"""

from __future__ import annotations

from typing import Optional

import torch

MAX_K = 31  # 2K bits in one 64-bit word; 4^K in int64

# kernel launches in this process: the packed entry (all, and those of its
# int64 launcher) and the bases entry; a run resets them to 0 to show that
# its main path went through the kernels (the CPU path does not count)
LAUNCHES = 0
LAUNCHES_I64 = 0
BASES_LAUNCHES = 0


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
    global BASES_LAUNCHES
    _check_plane(chunk, "chunk")
    s = _windows(chunk.shape[0], kmer_len)
    if chunk.device.type == "cpu":
        return canonical_codes_plain(chunk, kmer_len)
    from ._build import load

    lib = load()
    out = torch.empty(s, dtype=code_dtype(kmer_len), device=chunk.device)
    fn = lib.pykmer_encode_bases_i32 if out.dtype == torch.int32 \
        else lib.pykmer_encode_bases_i64
    with torch.cuda.device(chunk.device):
        err = fn(chunk.data_ptr(), chunk.shape[0], kmer_len, out.data_ptr(),
                 torch.cuda.current_stream(chunk.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"encode (bases) kernel launch failed: cudaError_t {err}")
    BASES_LAUNCHES += 1
    return out


def canonical_codes_packed(
    bases2: torch.Tensor,
    maskbits: Optional[torch.Tensor],
    span: int,
    kmer_len: int,
    count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Folded canonical codes of the ``span - K + 1`` windows of a packed
    chunk (``host.chunks.pack_base_stream``'s layout: base ``4j+i`` is bits
    ``[2i, 2i+2)`` of ``bases2[j]``, the validity of base ``8j+i`` bit i of
    ``maskbits[j]``; ``maskbits`` None for an all-valid chunk).

    returns: codes in ``code_dtype``, ``min(c, 4^K - 1 - c)`` of each
    window's canonical code c, the folded sentinel ``4^K / 2`` where any of
    the window's K validity bits is 0.

    count: None, or a 0-d int64 tensor on the planes' device that gains the
    number of valid windows (codes below ``4^K / 2``) in place; the kernel
    counts them as it writes the codes.
    """
    global LAUNCHES, LAUNCHES_I64
    m = _windows(span, kmer_len)
    _check_plane(bases2, "bases2")
    if bases2.shape[0] * 4 < span:
        raise ValueError(f"bases2 holds {bases2.shape[0] * 4} bases, span is {span}")
    if maskbits is not None:
        _check_plane(maskbits, "maskbits")
        if maskbits.device != bases2.device:
            raise ValueError(f"bases2 on {bases2.device}, maskbits on {maskbits.device}")
        if maskbits.shape[0] * 8 < span:
            raise ValueError(f"maskbits holds {maskbits.shape[0] * 8} bits, span is {span}")
    if count is not None and (count.dtype != torch.int64 or count.dim() != 0
                              or count.device != bases2.device):
        raise ValueError(f"count must be a 0-d int64 tensor on {bases2.device}, got "
                         f"{count.dtype} {tuple(count.shape)} on {count.device}")
    if bases2.device.type == "cpu":
        codes = canonical_codes_packed_plain(bases2, maskbits, span, kmer_len)
        if count is not None:
            count += (codes < 4**kmer_len // 2).sum(dtype=torch.int64)
        return codes
    from ._build import load

    lib = load()
    out = torch.empty(m, dtype=code_dtype(kmer_len), device=bases2.device)
    fn = lib.pykmer_encode_packed_i32 if out.dtype == torch.int32 \
        else lib.pykmer_encode_packed_i64
    with torch.cuda.device(bases2.device):
        err = fn(bases2.data_ptr(), bases2.shape[0],
                 None if maskbits is None else maskbits.data_ptr(),
                 0 if maskbits is None else maskbits.shape[0],
                 m, kmer_len, out.data_ptr(), None if count is None else count.data_ptr(),
                 torch.cuda.current_stream(bases2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"encode (packed) kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    LAUNCHES_I64 += out.dtype == torch.int64
    return out


def canonical_codes_plain(chunk: torch.Tensor, kmer_len: int) -> torch.Tensor:
    """:func:`canonical_codes` as torch ops on any device: the sum of K
    shifted slices of the chunk."""
    k = kmer_len
    s = _windows(chunk.shape[0], k)
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


def canonical_codes_packed_plain(
    bases2: torch.Tensor, maskbits: Optional[torch.Tensor], span: int, kmer_len: int
) -> torch.Tensor:
    """:func:`canonical_codes_packed` as torch ops on any device: unpack,
    the slice encoder, fold."""
    chunk = unpack_base_2bit(bases2, span) if maskbits is None \
        else unpack_base_2bit_mask(bases2, maskbits, span)
    return fold_codes(canonical_codes_plain(chunk, kmer_len), kmer_len)


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


def _windows(span: int, kmer_len: int) -> int:
    if not 1 <= kmer_len <= MAX_K:
        raise ValueError(f"kmer_len must be in 1..{MAX_K}, got {kmer_len}")
    if span < kmer_len:
        raise ValueError("chunk shorter than one window")
    return span - kmer_len + 1


def _check_plane(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D uint8 tensor, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no encoder for device {t.device}")

