"""ctypes bindings to the native C++ host-pipeline library.

Builds the port's own copy of the library, ``native/pykmer_native.cpp``, with
g++ and zlib at first use into ``build/native/libpykmer_native_<hash>.so`` at
the root of the checkout; the hash covers the source and the flags, so an
edit rebuilds and an unchanged tree loads the cached library. The build goes
through a temporary name and an atomic rename, under a file lock, so
concurrent processes build it once. Nothing is written into the source tree.
Every caller treats this module as optional: an ImportError here falls back
to the pure-Python/NumPy implementations with identical semantics (verified
by the test-suite, which runs both paths).

Set ``PYKMER_TPU_NO_NATIVE=1`` to disable the native path entirely.

Copy of ``pykmer_tpu/io/native.py``, held against it
by ``tests/test_torch_copies.py``; only the build differs.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "native", "pykmer_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
# the flags of pykmer_tpu/native/Makefile
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

if os.environ.get("PYKMER_TPU_NO_NATIVE"):
    raise ImportError("native library disabled via PYKMER_TPU_NO_NATIVE")


def library_path() -> str:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libpykmer_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):  # another process built it meanwhile
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE, "-lz"],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


_LIB_PATH = library_path()
if not os.path.exists(_LIB_PATH):
    try:
        _build(_LIB_PATH)
    except Exception as exc:  # pragma: no cover - toolchain missing
        raise ImportError(f"cannot build native library: {exc}") from exc

try:
    _lib = ctypes.CDLL(_LIB_PATH)
except OSError as exc:  # pragma: no cover
    raise ImportError(f"cannot load native library: {exc}") from exc

_lib.fasta_decode.restype = ctypes.c_long
_lib.fasta_decode.argtypes = [
    ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
]
_lib.bgzf_compress_block.restype = ctypes.c_int
_lib.bgzf_compress_block.argtypes = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
]
_lib.gzip_decompress.restype = ctypes.c_long
_lib.gzip_decompress.argtypes = [
    ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
]


def fasta_decode_native(
    data,
) -> Optional[Tuple[np.ndarray, np.ndarray, List[str]]]:
    """One-pass parse of bytes or uint8 ndarray: returns (codes, per-record
    code offsets, names)."""
    n = len(data)
    if n == 0:
        return np.empty(0, np.uint8), np.zeros(1, np.int64), []
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data.reshape(-1)).view(np.uint8)
    else:
        buf = np.frombuffer(data, dtype=np.uint8)
    max_recs = int(count256_native(buf)[ord(">")]) + 1
    from ..utils.bigmem import big_empty

    codes = big_empty(n)
    starts = np.empty(max_recs + 1, dtype=np.int64)
    name_off = np.empty(max_recs, dtype=np.int64)
    name_len = np.empty(max_recs, dtype=np.int64)
    n_recs = _lib.fasta_decode(
        buf.ctypes.data, n, codes.ctypes.data,
        starts.ctypes.data, name_off.ctypes.data, name_len.ctypes.data,
        max_recs,
    )
    if n_recs < 0:
        return None
    names = [
        buf[name_off[r] : name_off[r] + name_len[r]].tobytes().decode(errors="replace")
        for r in range(n_recs)
    ]
    return codes[: starts[n_recs]], starts[: n_recs + 1].copy(), names


def bgzf_compress_native(payload: bytes, level: int) -> bytes:
    out = np.empty(65536, dtype=np.uint8)
    buf = np.frombuffer(payload, dtype=np.uint8)
    size = _lib.bgzf_compress_block(
        buf.ctypes.data, len(payload), out.ctypes.data, 65536, level
    )
    if size < 0:
        raise ValueError("BGZF block compression failed")
    return out[:size].tobytes()


_lib.bgzf_compress_buffer.restype = ctypes.c_long
_lib.bgzf_compress_buffer.argtypes = [
    ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
]


def bgzf_compress_buffer_native(
    data, level: int = 6, block_size: int = 65280, threads: int = 8
):
    """Parallel whole-buffer BGZF: returns (compressed ndarray without EOF
    marker, per-block compressed sizes ndarray), or None on failure."""
    buf = (
        np.ascontiguousarray(data).view(np.uint8)
        if isinstance(data, np.ndarray)
        else np.frombuffer(data, dtype=np.uint8)
    )
    n = buf.shape[0]
    if n == 0:
        return np.empty(0, np.uint8), np.empty(0, np.int64)
    n_blocks = (n + block_size - 1) // block_size
    from ..utils.bigmem import big_empty

    out = big_empty(n_blocks * 65536)
    csizes = np.empty(n_blocks, dtype=np.int64)
    total = _lib.bgzf_compress_buffer(
        buf.ctypes.data, n, block_size, level, threads,
        out.ctypes.data, out.shape[0], csizes.ctypes.data,
    )
    if total < 0:
        return None
    return out[:total], csizes


def gzip_decompress_native(path: str, threads: int = 2):
    """Decompress a gzip/BGZF file (block-parallel for BGZF).

    Returns a uint8 ndarray (hugepage-backed — a bytes copy would pay this
    environment's slow first-touch faults twice), or None on failure."""
    import os as _os

    from ..utils.bigmem import big_empty

    fsize = _os.path.getsize(path)
    data = big_empty(max(fsize, 1))
    from .direct import read_file_into

    got_in = read_file_into(path, data[:fsize])
    if got_in != fsize:
        return None
    cap = max(fsize * 4, 1 << 20)
    for _ in range(8):
        out = big_empty(cap)
        got = _lib.gzip_decompress(data.ctypes.data, fsize,
                                   out.ctypes.data, cap, threads)
        if got == -2:
            cap *= 4
            continue
        if got < 0:
            return None
        return out[:got]
    return None


_lib.count256.restype = None
_lib.count256.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]


_lib.pack_base_nibbles.restype = None
_lib.pack_base_nibbles.argtypes = [
    ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_int
]
_lib.pack_base_2bit_mask.restype = None
_lib.pack_base_2bit_mask.argtypes = [
    ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int,
]


def pack_base_2bit_mask_native(codes: np.ndarray, threads: int = 8):
    """(2-bit bases, validity bitmap) planes of a base-code stream."""
    assert codes.dtype == np.uint8 and codes.shape[0] % 8 == 0
    codes = np.ascontiguousarray(codes.reshape(-1))
    bases = np.empty(codes.shape[0] // 4, dtype=np.uint8)
    mask = np.empty(codes.shape[0] // 8, dtype=np.uint8)
    _lib.pack_base_2bit_mask(codes.ctypes.data, codes.shape[0],
                             bases.ctypes.data, mask.ctypes.data, threads)
    return bases, mask


def pack_base_nibbles_native(codes: np.ndarray, threads: int = 8) -> np.ndarray:
    """Pack base codes (0..4) two-per-byte; odd tail padded with invalid 4."""
    assert codes.dtype == np.uint8
    codes = np.ascontiguousarray(codes.reshape(-1))
    out = np.empty((codes.shape[0] + 1) // 2, dtype=np.uint8)
    _lib.pack_base_nibbles(codes.ctypes.data, codes.shape[0],
                           out.ctypes.data, threads)
    return out


for _name in ("unpack_2bit", "unpack_3bit", "unpack_4bit"):
    _fn = getattr(_lib, _name)
    _fn.restype = None
    _fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_int]


def unpack_3bit_native(packed: np.ndarray, out: np.ndarray, threads: int = 8) -> None:
    """Expand 3-bit fields: out[8g+i] = bits [3i,3i+3) of 24-bit group g."""
    assert packed.dtype == np.uint8 and out.dtype == np.uint8
    assert packed.shape[0] % 3 == 0 and out.shape[0] == 8 * (packed.shape[0] // 3)
    _lib.unpack_3bit(packed.ctypes.data, packed.shape[0], out.ctypes.data, threads)


def unpack_2bit_native(packed: np.ndarray, out: np.ndarray, threads: int = 8) -> None:
    """Expand 2-bit crumbs to bytes: out[4j+i] = bits [2i,2i+2) of packed[j]."""
    assert packed.dtype == np.uint8 and out.dtype == np.uint8
    assert out.shape[0] == 4 * packed.shape[0]
    _lib.unpack_2bit(packed.ctypes.data, packed.shape[0], out.ctypes.data, threads)


def unpack_4bit_native(packed: np.ndarray, out: np.ndarray, threads: int = 8) -> None:
    """Expand 4-bit nibbles to bytes: out[2j+i] = bits [4i,4i+4) of packed[j]."""
    assert packed.dtype == np.uint8 and out.dtype == np.uint8
    assert out.shape[0] == 2 * packed.shape[0]
    _lib.unpack_4bit(packed.ctypes.data, packed.shape[0], out.ctypes.data, threads)


_lib.unfold_canonical.restype = None
_lib.unfold_canonical.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int
]


def unfold_canonical_native(
    folded: np.ndarray, out: np.ndarray, kmer_len: int, threads: int = 8
) -> None:
    """Expand a folded half-plane (counts at min(c, M-c)) to the full 4^K
    dense array: the canonical member of each {u, M-u} pair gets folded[u],
    the other 0."""
    assert folded.dtype == np.uint8 and out.dtype == np.uint8
    assert folded.shape[0] * 2 == out.shape[0] == 4**kmer_len
    _lib.unfold_canonical(folded.ctypes.data, out.ctypes.data, kmer_len,
                          threads)


_lib.unfold_canonical_range.restype = None
_lib.unfold_canonical_range.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_uint64, ctypes.c_uint64,
]


def unfold_canonical_range_native(
    folded_slice: np.ndarray, out: np.ndarray, kmer_len: int, lo: int
) -> None:
    """Expand folded indices [lo, lo + len(folded_slice)) into the full
    4^K output array (slice variant of unfold_canonical_native; one slice
    per caller thread — the fetch worker pool provides the parallelism)."""
    assert folded_slice.dtype == np.uint8 and out.dtype == np.uint8
    assert out.shape[0] == 4**kmer_len
    assert lo + folded_slice.shape[0] <= out.shape[0] // 2
    _lib.unfold_canonical_range(
        folded_slice.ctypes.data, out.ctypes.data, kmer_len,
        lo, folded_slice.shape[0],
    )


try:
    _lib.unfold_canonical_piece.restype = None
    _lib.unfold_canonical_piece.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
    ]
    _HAVE_PIECE_UNFOLD = True
except AttributeError:  # pragma: no cover - stale .so
    _HAVE_PIECE_UNFOLD = False


def unfold_canonical_piece_native(
    folded_piece: np.ndarray, primary: np.ndarray, mirror: np.ndarray,
    kmer_len: int, g0: int, threads: int = 4,
) -> None:
    """Expand folded cells [g0, g0+n) into the two standalone region
    buffers of the sharded multi-host writer (ops.readback.unfold_piece)."""
    if not _HAVE_PIECE_UNFOLD:  # stale .so: callers fall back to numpy
        raise ImportError("libpykmer_native.so lacks unfold_canonical_piece")
    n = folded_piece.shape[0]
    assert folded_piece.dtype == primary.dtype == mirror.dtype == np.uint8
    assert primary.shape[0] == n and mirror.shape[0] == n
    assert g0 + n <= 4**kmer_len // 2
    _lib.unfold_canonical_piece(
        folded_piece.ctypes.data, primary.ctypes.data, mirror.ctypes.data,
        kmer_len, g0, n, threads,
    )


try:
    _lib.unpack_unfold_range.restype = ctypes.c_long
    _lib.unpack_unfold_range.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_long,
    ]
    _HAVE_FUSED_UNFOLD = True
except AttributeError:  # pragma: no cover - stale .so
    _HAVE_FUSED_UNFOLD = False
try:
    _lib.unpack_unfold_range_fast.restype = ctypes.c_long
    _lib.unpack_unfold_range_fast.argtypes = \
        _lib.unpack_unfold_range.argtypes + [ctypes.c_void_p]
    _lib.build_canon_bits.restype = None
    _lib.build_canon_bits.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int
    ]
    _HAVE_FAST_UNFOLD = True
except AttributeError:  # pragma: no cover - stale .so
    _HAVE_FAST_UNFOLD = False

try:
    _lib.scan_escapes.restype = ctypes.c_long
    _lib.scan_escapes.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_long,
    ]
    _HAVE_SCAN_ESCAPES = True
except AttributeError:  # pragma: no cover - stale .so
    _HAVE_SCAN_ESCAPES = False


def scan_escapes_native(packed: np.ndarray, width: int) -> np.ndarray:
    """Local cell indices (uint32) of escape-marker fields (value 2^W - 1)
    in a bit-packed folded-plane slice — scan only, no unfold. The readback
    drain phase runs this per landed slice (~GB/s, negligible CPU next to
    the in-process transfer transport) so the batched escape gather can be
    issued before the unfold workers start."""
    packed = np.ascontiguousarray(packed.reshape(-1))
    assert packed.dtype == np.uint8
    bytes_per_group = {2: 2, 3: 3, 4: 4}[width]
    assert packed.shape[0] % bytes_per_group == 0
    n_cells = packed.shape[0] * 8 // width
    cap = n_cells // 16 + 4096
    while True:
        esc = np.empty(cap, dtype=np.uint32)
        n_esc = _lib.scan_escapes(
            packed.ctypes.data, packed.shape[0], width, esc.ctypes.data, cap
        )
        if n_esc < 0:
            raise ValueError(f"bad pack width {width}")
        if n_esc <= cap:
            return esc[:n_esc]
        cap = n_esc  # rare: saturated data; redo with the exact size


_CANON_BITS: dict = {}
_CANON_LOCK = __import__("threading").Lock()


def canon_bits_cached(kmer_len: int) -> Optional[np.ndarray]:
    """Per-process cache of the per-K canonical-selector bitmask (bit u =
    ``u <= revcomp(u)``, 4^K/16 bytes — 67 MB at K=15). Built multithreaded
    on first use; the readback fast path indexes it instead of computing a
    reverse complement per cell."""
    if not _HAVE_FAST_UNFOLD:
        return None
    with _CANON_LOCK:
        bits = _CANON_BITS.get(kmer_len)
        if bits is None:
            from ..utils.bigmem import big_empty

            half = 4**kmer_len // 2
            bits = big_empty((half + 7) // 8)
            _lib.build_canon_bits(kmer_len, bits.ctypes.data, 4)
            _CANON_BITS[kmer_len] = bits
    return bits


def unpack_unfold_native(
    packed: np.ndarray, width: int, out: np.ndarray, kmer_len: int, lo: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Fused readback tail for one bit-packed folded-plane slice: unfold into
    the full 4^K plane ``out``, return (counts int64[256], escape-marker local
    indices uint32[n]). One memory pass instead of the separate
    unpack/flatnonzero/count/unfold passes."""
    packed = np.ascontiguousarray(packed.reshape(-1))
    assert packed.dtype == np.uint8 and out.dtype == np.uint8
    # whole 8-cell groups only: the BMI2 path iterates full groups (2/3/4
    # bytes per 8 cells) and would silently drop a ragged tail that the
    # scalar path processes — reject rather than diverge by CPU
    bytes_per_group = {2: 2, 3: 3, 4: 4}[width]
    assert packed.shape[0] % bytes_per_group == 0, \
        f"packed length {packed.shape[0]} not a whole number of 8-cell groups"
    n_cells = packed.shape[0] * 8 // width
    assert lo + n_cells <= out.shape[0] // 2
    counts = np.zeros(256, dtype=np.int64)
    bits = canon_bits_cached(kmer_len) if lo % 8 == 0 else None
    cap = n_cells // 16 + 4096
    while True:
        esc = np.empty(cap, dtype=np.uint32)
        if bits is not None:
            n_esc = _lib.unpack_unfold_range_fast(
                packed.ctypes.data, packed.shape[0], width, out.ctypes.data,
                kmer_len, lo, counts.ctypes.data, esc.ctypes.data, cap,
                bits.ctypes.data,
            )
        else:
            n_esc = _lib.unpack_unfold_range(
                packed.ctypes.data, packed.shape[0], width, out.ctypes.data,
                kmer_len, lo, counts.ctypes.data, esc.ctypes.data, cap,
            )
        if n_esc < 0:
            raise ValueError(f"bad pack width {width}")
        if n_esc <= cap:
            return counts, esc[:n_esc]
        counts[:] = 0
        cap = n_esc  # rare: saturated data; redo with the exact size


try:
    _lib.sparse_decode_segment.restype = ctypes.c_long
    _lib.sparse_decode_segment.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p,
    ]
    _HAVE_SPARSE_DECODE = True
except AttributeError:  # pragma: no cover - stale .so
    _HAVE_SPARSE_DECODE = False


def sparse_decode_segment_native(
    tokens: np.ndarray, side: np.ndarray, out: np.ndarray, kmer_len: int,
    seg_base: int, seg_len: int,
) -> np.ndarray:
    """Decode one sparse readback segment (ops.readback sparse mode) into the
    full 4^K plane ``out``: memsets the segment's primary + mirror ranges and
    writes each token's value at the canonical member of its {u, M-u} pair.
    Returns the int64[256] value counts of the segment's nonzeros (value 3 =
    the ">= 3" escape marker, patched by the caller's batched gather)."""
    if not _HAVE_SPARSE_DECODE:
        raise ImportError("libpykmer_native.so lacks sparse_decode_segment")
    tokens = np.ascontiguousarray(tokens.reshape(-1))
    side = np.ascontiguousarray(side.reshape(-1))
    assert tokens.dtype == np.uint8 and side.dtype == np.int32
    assert out.dtype == np.uint8 and out.shape[0] == 4**kmer_len
    counts = np.zeros(256, dtype=np.int64)
    rc = _lib.sparse_decode_segment(
        tokens.ctypes.data, tokens.shape[0], side.ctypes.data, side.shape[0],
        out.ctypes.data, kmer_len, seg_base, seg_len, counts.ctypes.data,
    )
    if rc < 0:
        raise ValueError("malformed sparse token stream")
    return counts


try:
    _lib.sparse_decode_segment_piece.restype = ctypes.c_long
    _lib.sparse_decode_segment_piece.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_void_p,
    ]
    _HAVE_SPARSE_PIECE = True
except AttributeError:  # pragma: no cover - stale .so
    _HAVE_SPARSE_PIECE = False


def sparse_decode_segment_piece_native(
    tokens: np.ndarray, side: np.ndarray, primary: np.ndarray,
    mirror: np.ndarray, kmer_len: int, seg_base: int, seg_len: int,
) -> np.ndarray:
    """Arena-free variant of :func:`sparse_decode_segment_native`: the
    segment's unfolded primary range (file offset ``seg_base``) and mirror
    range (file offset ``4^K - seg_base - seg_len``, ascending order) land in
    the two standalone buffers. Returns the int64[256] value counts."""
    if not _HAVE_SPARSE_PIECE:
        raise ImportError("libpykmer_native.so lacks sparse_decode_segment_piece")
    tokens = np.ascontiguousarray(tokens.reshape(-1))
    side = np.ascontiguousarray(side.reshape(-1))
    assert tokens.dtype == np.uint8 and side.dtype == np.int32
    assert primary.dtype == mirror.dtype == np.uint8
    assert primary.shape[0] >= seg_len and mirror.shape[0] >= seg_len
    counts = np.zeros(256, dtype=np.int64)
    rc = _lib.sparse_decode_segment_piece(
        tokens.ctypes.data, tokens.shape[0], side.ctypes.data, side.shape[0],
        primary.ctypes.data, mirror.ctypes.data, kmer_len, seg_base, seg_len,
        counts.ctypes.data,
    )
    if rc < 0:
        raise ValueError("malformed sparse token stream")
    return counts


try:
    _lib.pack_valid_bits.restype = None
    _lib.pack_valid_bits.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
    ]
    _lib.popcount_buf.restype = ctypes.c_long
    _lib.popcount_buf.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
    ]
    _lib.popcount_and.restype = ctypes.c_long
    _lib.popcount_and.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
    ]
    _HAVE_PAIR_COUNTS = True
except AttributeError:  # pragma: no cover - stale .so
    _HAVE_PAIR_COUNTS = False


def pack_valid_bits_native(
    data: np.ndarray, lo: int, hi: int, out: Optional[np.ndarray] = None,
    threads: int = 2,
) -> np.ndarray:
    """Validity bitmap of a count block: bit i of byte j = (data[8j+i] in
    [lo, hi]) — AVX2 range-compare + movemask at memory bandwidth. The bit
    order is little-endian (movemask lanes); popcount consumers never look at
    positions, but both operands of any AND must come from this packer."""
    if not _HAVE_PAIR_COUNTS:
        raise ImportError("libpykmer_native.so lacks pack_valid_bits")
    assert data.dtype == np.uint8
    data = np.ascontiguousarray(data.reshape(-1))
    n_bytes = (data.shape[0] + 7) // 8
    if out is None:
        out = np.empty(n_bytes, dtype=np.uint8)
    assert out.dtype == np.uint8 and out.shape[0] >= n_bytes
    _lib.pack_valid_bits(data.ctypes.data, data.shape[0], lo, hi,
                         out.ctypes.data, threads)
    return out[:n_bytes]


def popcount_buf_native(bits: np.ndarray, threads: int = 2) -> int:
    if not _HAVE_PAIR_COUNTS:
        raise ImportError("libpykmer_native.so lacks popcount_buf")
    assert bits.dtype == np.uint8
    bits = np.ascontiguousarray(bits.reshape(-1))
    return int(_lib.popcount_buf(bits.ctypes.data, bits.shape[0], threads))


def popcount_and_native(a: np.ndarray, b: np.ndarray, threads: int = 2) -> int:
    if not _HAVE_PAIR_COUNTS:
        raise ImportError("libpykmer_native.so lacks popcount_and")
    assert a.dtype == np.uint8 and b.dtype == np.uint8
    a = np.ascontiguousarray(a.reshape(-1))
    b = np.ascontiguousarray(b.reshape(-1))
    assert a.shape[0] == b.shape[0]
    return int(_lib.popcount_and(a.ctypes.data, b.ctypes.data, a.shape[0],
                                 threads))


def count256_native(arr: np.ndarray) -> np.ndarray:
    assert arr.dtype == np.uint8
    arr = np.ascontiguousarray(arr.reshape(-1))
    out = np.zeros(256, dtype=np.int64)
    _lib.count256(arr.ctypes.data, arr.shape[0], out.ctypes.data)
    return out


try:
    _lib.count_byte.restype = ctypes.c_long
    _lib.count_byte.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
    ]
    _HAVE_COUNT_BYTE = True
except AttributeError:  # pragma: no cover - stale .so
    _HAVE_COUNT_BYTE = False


def _count_byte(buf: np.ndarray, value: int) -> int:
    """Occurrences of one byte value (AVX2 memory-bandwidth pass when the
    .so provides it; count256 histogram fallback)."""
    if buf.shape[0] == 0:
        return 0
    if _HAVE_COUNT_BYTE:
        return int(_lib.count_byte(buf.ctypes.data, buf.shape[0], value, 2))
    return int(count256_native(buf)[value])


_lib.fasta_decode_joined.restype = ctypes.c_long
_lib.fasta_decode_joined.argtypes = [
    ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_long, ctypes.c_void_p,
]
_lib.fasta_decode_joined_mt.restype = ctypes.c_long
_lib.fasta_decode_joined_mt.argtypes = _lib.fasta_decode_joined.argtypes + [
    ctypes.c_int, ctypes.c_void_p
]


def fasta_decode_joined_native(
    data, kmer_len: int, threads: int = 8, tail_headroom: int = 0
):
    """One-pass parse into the indexer's joined stream.

    ``data``: bytes or uint8 ndarray (e.g. a readonly mmap of the input —
    zero-copy). Returns (stream_codes, chromosomes, total_bp) where
    chromosomes lists (name, seq_len) for records with at least one valid
    k-mer window — reference indexer.py:345-351 semantics — or None on
    overflow. ``tail_headroom`` over-allocates the stream's pooled block so
    downstream framing (ops.encode.chunk_stream padding) can extend the
    buffer in place instead of copying into a fresh block.
    """
    n = len(data)
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data.reshape(-1)).view(np.uint8)
    else:
        buf = np.frombuffer(data, dtype=np.uint8) if n else np.empty(0, np.uint8)
    # '>' count via a native single-byte pass: a `buf == ord('>')` bool
    # temp at GiB scale pays this environment's slow first-touch faults
    max_recs = (_count_byte(buf, ord(">")) if n else 0) + 1
    from ..utils.bigmem import big_empty

    codes = big_empty(n + max_recs * (kmer_len - 1) + tail_headroom)
    # the MT path stages per-thread output in `codes` itself (in-place
    # compaction in the native layer): a separate malloc'd arena would pay
    # this environment's slow first-touch faults, and even a pooled second
    # arena doubles the resident footprint
    scratch = codes
    seq_len = np.empty(max_recs, dtype=np.int64)
    has_valid = np.empty(max_recs, dtype=np.uint8)
    name_off = np.empty(max_recs, dtype=np.int64)
    name_len = np.empty(max_recs, dtype=np.int64)
    out_len = np.zeros(1, dtype=np.int64)
    n_recs = _lib.fasta_decode_joined_mt(
        buf.ctypes.data if n else None, n, kmer_len, codes.ctypes.data,
        seq_len.ctypes.data, has_valid.ctypes.data,
        name_off.ctypes.data, name_len.ctypes.data,
        max_recs, out_len.ctypes.data, threads, scratch.ctypes.data,
    )
    del scratch
    if n_recs < 0:
        return None
    chromosomes = [
        (
            buf[name_off[r] : name_off[r] + name_len[r]]
            .tobytes()
            .decode(errors="replace"),
            int(seq_len[r]),
        )
        for r in range(n_recs)
        if has_valid[r]
    ]
    total_bp = int(seq_len[:n_recs].sum()) if n_recs else 0
    return codes[: out_len[0]], chromosomes, total_bp


try:
    _lib.fasta_decode_joined_packed_mt.restype = ctypes.c_long
    _lib.fasta_decode_joined_packed_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long,  # data, n, k
        ctypes.c_void_p, ctypes.c_void_p,               # bases, mask
        ctypes.c_void_p, ctypes.c_void_p,               # seq_len, has_valid
        ctypes.c_void_p, ctypes.c_void_p,               # name_off, name_len
        ctypes.c_long, ctypes.c_void_p,                 # max_recs, out_len
        ctypes.c_int, ctypes.c_void_p,                  # threads, scratch
    ]
    _HAVE_PACKED_DECODE = True
except AttributeError:  # pragma: no cover - stale .so
    _HAVE_PACKED_DECODE = False


def fasta_decode_joined_packed_native(
    data, kmer_len: int, threads: int = 2, tail_headroom: int = 0
):
    """One-pass parse straight into the device upload planes.

    Returns (bases2, maskbits, n_codes, chromosomes, total_bp) where
    ``bases2``/``maskbits`` are the bit-packed planes covering the joined
    stream (invalid separators/Ns carry mask 0), sized with enough tail
    capacity for chunk framing up to ``n_codes + tail_headroom`` window
    codes, zero-padded (= invalid) past ``n_codes``. The joined stream is
    byte-identical to :func:`fasta_decode_joined_native`'s. None on record
    overflow or when the native layer lacks the entry point."""
    if not _HAVE_PACKED_DECODE:
        return None
    n = len(data)
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data.reshape(-1)).view(np.uint8)
    else:
        buf = np.frombuffer(data, dtype=np.uint8) if n else np.empty(0, np.uint8)
    max_recs = (_count_byte(buf, ord(">")) if n else 0) + 1
    from ..utils.bigmem import big_empty

    # worst-case codes: every byte a base + per-record aligned separators
    cap = n + max_recs * (kmer_len - 1 + 8) + tail_headroom + 16
    cap8 = (cap + 7) & ~7
    scratch = big_empty(cap8)
    bases = big_empty(cap8 // 4)
    mask = big_empty(cap8 // 8)
    seq_len = np.empty(max_recs, dtype=np.int64)
    has_valid = np.empty(max_recs, dtype=np.uint8)
    name_off = np.empty(max_recs, dtype=np.int64)
    name_len = np.empty(max_recs, dtype=np.int64)
    out_len = np.zeros(1, dtype=np.int64)
    n_recs = _lib.fasta_decode_joined_packed_mt(
        buf.ctypes.data if n else None, n, kmer_len, bases.ctypes.data,
        mask.ctypes.data, seq_len.ctypes.data, has_valid.ctypes.data,
        name_off.ctypes.data, name_len.ctypes.data,
        max_recs, out_len.ctypes.data, threads, scratch.ctypes.data,
    )
    del scratch
    if n_recs < 0:
        return None
    n_codes = int(out_len[0])
    # zero (= invalid) the framing tail beyond the packed stream
    total8 = (n_codes + 7) & ~7
    bases[total8 // 4:] = 0
    mask[total8 // 8:] = 0
    chromosomes = [
        (
            buf[name_off[r] : name_off[r] + name_len[r]]
            .tobytes()
            .decode(errors="replace"),
            int(seq_len[r]),
        )
        for r in range(n_recs)
        if has_valid[r]
    ]
    total_bp = int(seq_len[:n_recs].sum()) if n_recs else 0
    return bases, mask, n_codes, chromosomes, total_bp
