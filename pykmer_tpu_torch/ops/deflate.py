"""BGZF blocks deflated on the card, with zlib level 6's bytes.

The bgzip output's compressor (``index/bgzip.write_bgzip``): a run of whole
65,280-byte blocks, on the card, becomes each block's complete BGZF member
(the 18-byte header with BSIZE, the raw DEFLATE stream, CRC32, ISIZE),
packed in block order. The stream is byte for byte what zlib 1.2.x-1.3 gives
for ``deflateInit2(6, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY)`` and one
``deflate(Z_FINISH)`` of the block, which is what htslib's ``bgzip`` and
``io/bgzf.bgzip_kin`` write.

On a CUDA tensor :func:`deflate_bgzf` launches the hand-written kernels of
``csrc/deflate.cu``; on a CPU tensor it runs the native zlib codec (the
host's deflate, :func:`host_members`). Nothing falls back from one to the
other.

The kernels compute zlib's ``deflate_slow`` in two phases, which
:func:`deflate_raw` repeats in numpy and Python for the tests:

1. Over positions, in parallel: at level 6 every position up to the last 3
   bytes enters the hash chains (``prev``), and a position's search depends
   on the parse only through the previous match length, which picks the
   chain limit (32 candidates once 8 is reached, else 128) and the length
   to beat. So each position's chain walk is taken once, recording the
   longest match of the first 32 and of the first 128 candidates
   (:func:`match_records`).
2. Within a block, serially: the lazy parse reads those records, flushes a
   DEFLATE block every 16,383 symbols and at the end, builds zlib's trees
   for it, picks stored, fixed or dynamic as zlib does, and emits the bits
   (:func:`deflate_raw`).
"""

from __future__ import annotations

import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

BLOCK = 65280  # a BGZF block's payload, bgzip's
MEMBER_MAX = 65536  # the largest member BGZF allows (BSIZE is 16 bits)
LEVEL = 6

# launches on the card in this process (one a run of blocks)
LAUNCHES = 0

# zlib's level 6: deflate_slow with these limits
GOOD_LENGTH, MAX_LAZY, NICE_LENGTH, MAX_CHAIN = 8, 16, 128, 128
MIN_MATCH, MAX_MATCH = 3, 258
WSIZE = 32768  # w_size at windowBits 15
MAX_DIST = WSIZE - (MAX_MATCH + MIN_MATCH + 1)  # w_size - MIN_LOOKAHEAD: 32,506
# zlib slides its window (by WSIZE) at the first step whose position is at
# least this: a head or chain entry of WSIZE or less becomes NIL, and a
# DEFLATE block that starts below WSIZE can no longer be stored
SLIDE_AT = WSIZE + MAX_DIST  # 65,274
TOO_FAR = 4096
SYMBOLS_PER_BLOCK = (1 << 14) - 1  # lit_bufsize - 1 at memLevel 8
HASH_MASK = (1 << 15) - 1

L_CODES, D_CODES, BL_CODES, END_BLOCK = 286, 30, 19, 256
HEAP_SIZE = 2 * L_CODES + 1
EXTRA_LBITS = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
EXTRA_DBITS = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
               11, 11, 12, 12, 13, 13]
EXTRA_BLBITS = [0] * 16 + [2, 3, 7]
BL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
BASE_LENGTH = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80,
               96, 112, 128, 160, 192, 224, 0]
BASE_DIST = [0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768,
             1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288, 16384, 24576]
STATIC_LLEN = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
HEADER = bytes([0x1F, 0x8B, 0x08, 0x04, 0, 0, 0, 0, 0, 0xFF, 6, 0, 0x42, 0x43, 2, 0])


def host_members(run: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``run``'s blocks as BGZF members by the host's zlib: (their bytes,
    each member's size). The native codec where the library is built, else
    the standard library's zlib, one block at a time."""
    try:
        from ..io.native import bgzf_compress_buffer_native
    except ImportError:
        blocks = [member(run[a: a + BLOCK].tobytes(), zlib_raw(run[a: a + BLOCK].tobytes()))
                  for a in range(0, run.shape[0], BLOCK)]
        return (np.frombuffer(b"".join(blocks), dtype=np.uint8),
                np.array([len(b) for b in blocks], dtype=np.int64))
    result = bgzf_compress_buffer_native(run, level=LEVEL, block_size=BLOCK, threads=1)
    if result is None:
        raise IOError("BGZF deflate failed")
    return result


def zlib_raw(payload: bytes) -> bytes:
    """The standard library's level-6 raw DEFLATE stream of ``payload``."""
    co = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
    return co.compress(payload) + co.flush()


def member(payload: bytes, raw: bytes) -> bytes:
    """The BGZF member of ``payload`` around its raw stream ``raw``."""
    bsize = len(HEADER) + 2 + len(raw) + 8
    return (HEADER + (bsize - 1).to_bytes(2, "little") + raw
            + zlib.crc32(payload).to_bytes(4, "little") + len(payload).to_bytes(4, "little"))


def deflate_bgzf(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The BGZF members of ``data``'s blocks (a contiguous 1-D uint8 tensor,
    blocks of 65,280 bytes, the last one shorter or whole), on ``data``'s
    device: (members, sizes). ``sizes`` (int64, a block each) gives each
    member's size; the members are packed in block order at the start of
    ``members``, which may hold more bytes after them. On a CUDA tensor the
    kernels launch on the current stream and this does not wait; on a CPU
    tensor the host's zlib runs (:func:`host_members`)."""
    global LAUNCHES
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise ValueError("data must be a contiguous 1-D uint8 tensor")
    if data.device.type == "cpu":
        out, sizes = host_members(data.numpy())
        return torch.from_numpy(np.asarray(out)), torch.from_numpy(np.asarray(sizes))
    if data.device.type != "cuda":
        raise ValueError(f"no deflate for device {data.device}: the card deflate takes CUDA "
                         "tensors, the host's zlib CPU ones")
    n = data.shape[0]
    blocks = -(-n // BLOCK)
    dev = data.device
    members = torch.empty(blocks * MEMBER_MAX, dtype=torch.uint8, device=dev)
    sizes = torch.empty(blocks, dtype=torch.int64, device=dev)
    if blocks == 0:
        return members, sizes
    records = torch.empty(blocks * BLOCK * 2, dtype=torch.int32, device=dev)
    slots = torch.empty(blocks * MEMBER_MAX, dtype=torch.uint8, device=dev)
    syms = torch.empty(blocks * (SYMBOLS_PER_BLOCK + 1), dtype=torch.int32, device=dev)
    from ._build import load

    lib = load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pykmer_deflate_bgzf(data.data_ptr(), n, records.data_ptr(), syms.data_ptr(),
                                      slots.data_ptr(), sizes.data_ptr(), members.data_ptr(),
                                      stream)
    if err != 0:
        raise RuntimeError(f"deflate launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return members, sizes


# ---- phase 1: the chain walks, over positions --------------------------------


def hash_chains(payload: np.ndarray) -> np.ndarray:
    """zlib's ``prev`` at level 6 (every position inserted): for each
    position p <= n - 3, the last q < p with the same 3-byte hash
    ``((b0 << 10) ^ (b1 << 5) ^ b2) & 0x7fff``, 0 (NIL) where there is none;
    0 for the last 2 positions, which are never inserted."""
    n = payload.shape[0]
    prev = np.zeros(n, dtype=np.int64)
    if n < MIN_MATCH:
        return prev
    b = payload.astype(np.int64)
    h = ((b[:-2] << 10) ^ (b[1:-1] << 5) ^ b[2:]) & HASH_MASK
    order = np.argsort(h, kind="stable")
    hs = h[order]
    same = np.zeros(order.shape[0], dtype=bool)
    same[1:] = hs[1:] == hs[:-1]
    prev[order[1:][same[1:]]] = order[:-1][same[1:]]
    return prev


def _match_lengths(words: np.ndarray, p: np.ndarray, c: np.ndarray, cap: np.ndarray
                   ) -> np.ndarray:
    """The common prefix of the bytes at ``p`` and ``c``, at most ``cap``;
    ``words[i]`` holds bytes i..i+7, little-endian."""
    out = np.zeros(p.shape[0], dtype=np.int64)
    live = np.arange(p.shape[0])
    at = 0
    while live.shape[0]:
        x = words[p[live] + at] ^ words[c[live] + at]
        hit = x != 0
        low = x[hit] & (~x[hit] + np.uint64(1))
        out[live[hit]] = at + (np.log2(low.astype(np.float64)).astype(np.int64) >> 3)
        live = live[~hit]
        at += 8
        out[live] = at
        live = live[at < cap[live]]
    return np.minimum(out, cap)


def match_records(payload: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Phase 1: each position's walk of its hash chain, as zlib's
    ``longest_match`` takes it with ``best_len`` 2. Returns (rec128, rec32),
    int64 ``len | dist << 9``: the longest match among the first 128 and
    among the first 32 candidates (the first to reach the longest, a walk
    stopping at the first of ``nice_length`` 128), each length at most 258
    and the bytes left. ``len`` is 2 where no candidate reaches 3, and 0
    where zlib does not search: fewer than 3 bytes left, no chain, its
    head farther than MAX_DIST, or a head of WSIZE once the window has slid
    (from SLIDE_AT on, where it would lie exactly MAX_DIST back). A walk
    continues while the candidate lies within MAX_DIST - 1, and a candidate
    is never position 0 (NIL)."""
    n = payload.shape[0]
    prev = hash_chains(payload)
    rec128 = np.zeros(n, dtype=np.int64)
    rec32 = np.zeros(n, dtype=np.int64)
    p = np.arange(n, dtype=np.int64)
    head = prev.copy()
    search = (p <= n - MIN_MATCH) & (head > 0) & (p - head <= MAX_DIST) \
        & ((p < SLIDE_AT) | (head > WSIZE))
    padded = np.zeros(n + MAX_MATCH + 16, dtype=np.uint8)
    padded[:n] = payload
    words = np.lib.stride_tricks.sliding_window_view(padded, 8)[: n + MAX_MATCH + 8]
    words = np.ascontiguousarray(words).view("<u8").reshape(-1)
    pos = p[search]
    cur = head[search]
    left = n - pos
    cap = np.minimum(MAX_MATCH, left)
    nice = np.minimum(NICE_LENGTH, left)
    limit = np.where(pos > MAX_DIST, pos - MAX_DIST, 0)
    best = np.full(pos.shape[0], 2, dtype=np.int64)
    dist = np.zeros(pos.shape[0], dtype=np.int64)
    best32 = best.copy()
    dist32 = dist.copy()
    live = np.arange(pos.shape[0])
    for k in range(1, MAX_CHAIN + 1):
        lens = _match_lengths(words, pos[live], cur[live], cap[live])
        better = lens > best[live]
        best[live[better]] = lens[better]
        dist[live[better]] = pos[live[better]] - cur[live[better]]
        done = best[live] >= nice[live]
        nxt = prev[cur[live]]
        done |= nxt <= limit[live]
        # the 32-candidate walk is this walk's prefix: it ends here too, or
        # stops at its 32nd candidate
        ends = live if k == 32 else live[done] if k < 32 else live[:0]
        best32[ends] = best[ends]
        dist32[ends] = dist[ends]
        cur[live] = nxt
        live = live[~done]
        if not live.shape[0]:
            break
    rec128[search] = best | dist << 9
    rec32[search] = best32 | dist32 << 9
    return rec128, rec32


# ---- phase 2: the lazy parse, the trees and the bits, within a block ---------


def _code_of(base: List[int], v: int) -> int:
    """The last code whose base is at most ``v``."""
    c = len(base) - 1
    while base[c] > v:
        c -= 1
    return c


def length_code(lc: int) -> int:
    """zlib's ``_length_code`` of a match length less 3 (258 takes 285's
    code 28, not 284 with 31 extra)."""
    return 28 if lc == 255 else _code_of(BASE_LENGTH[:28], lc)


def dist_code(d: int) -> int:
    """zlib's ``d_code`` of a distance less 1."""
    return _code_of(BASE_DIST, d)


def _reverse(code: int, n: int) -> int:
    return int(f"{code:0{n}b}"[::-1], 2) if n else 0


def _gen_codes(lens: List[int], max_code: int, bl_count: List[int]) -> List[int]:
    """zlib's ``gen_codes``: the canonical codes, bit-reversed."""
    next_code = [0] * 16
    code = 0
    for bits in range(1, 16):
        code = (code + bl_count[bits - 1]) << 1
        next_code[bits] = code
    codes = [0] * len(lens)
    for n in range(max_code + 1):
        if lens[n]:
            codes[n] = _reverse(next_code[lens[n]], lens[n])
            next_code[lens[n]] += 1
    return codes


STATIC_LCODE = _gen_codes(STATIC_LLEN, 287, [0] * 7 + [24, 152, 112] + [0] * 6)
STATIC_DCODE = [_reverse(n, 5) for n in range(D_CODES)]


class _Costs:
    """The running ``opt_len`` and ``static_len`` of a block, in bits."""

    def __init__(self) -> None:
        self.opt = self.static = 0


def build_tree(freq: List[int], elems: int, static_len: Optional[List[int]],
               extra: List[int], base: int, max_length: int, costs: _Costs
               ) -> Tuple[List[int], List[int], int]:
    """zlib's ``build_tree`` with ``gen_bitlen`` and ``gen_codes``: (each
    symbol's length, its code, max_code). ``freq`` (``2 * elems + 1``
    entries) gains the forced codes' 1s; ``costs`` the tree's bits. The
    heap breaks ties of frequency by depth; lengths over ``max_length`` are
    repaired as zlib does."""
    nodes = 2 * elems + 1
    heap = [0] * (HEAP_SIZE + 1)
    depth = [0] * nodes
    dad = [0] * nodes
    lens = [0] * (nodes + 1)
    heap_len, heap_max, max_code = 0, HEAP_SIZE, -1
    for n in range(elems):
        if freq[n]:
            heap_len += 1
            heap[heap_len] = max_code = n
    while heap_len < 2:
        if max_code < 2:
            max_code += 1
            node = max_code
        else:
            node = 0
        heap_len += 1
        heap[heap_len] = node
        freq[node] = 1
        costs.opt -= 1
        if static_len is not None:
            costs.static -= static_len[node]

    def smaller(a: int, b: int) -> bool:
        return freq[a] < freq[b] or (freq[a] == freq[b] and depth[a] <= depth[b])

    def down(k: int) -> None:
        v = heap[k]
        j = k << 1
        while j <= heap_len:
            if j < heap_len and smaller(heap[j + 1], heap[j]):
                j += 1
            if smaller(v, heap[j]):
                break
            heap[k] = heap[j]
            k = j
            j <<= 1
        heap[k] = v

    for k in range(heap_len // 2, 0, -1):
        down(k)
    node = elems
    while True:
        n = heap[1]
        heap[1] = heap[heap_len]
        heap_len -= 1
        down(1)
        m = heap[1]
        heap_max -= 1
        heap[heap_max] = n
        heap_max -= 1
        heap[heap_max] = m
        freq[node] = freq[n] + freq[m]
        depth[node] = max(depth[n], depth[m]) + 1
        dad[n] = dad[m] = node
        heap[1] = node
        node += 1
        down(1)
        if heap_len < 2:
            break
    heap_max -= 1
    heap[heap_max] = heap[1]

    # gen_bitlen
    bl_count = [0] * 16
    lens[heap[heap_max]] = 0
    overflow = 0
    for h in range(heap_max + 1, HEAP_SIZE):
        n = heap[h]
        bits = lens[dad[n]] + 1
        if bits > max_length:
            bits = max_length
            overflow += 1
        lens[n] = bits
        if n > max_code:
            continue
        bl_count[bits] += 1
        xbits = extra[n - base] if n >= base else 0
        costs.opt += freq[n] * (bits + xbits)
        if static_len is not None:
            costs.static += freq[n] * (static_len[n] + xbits)
    if overflow:
        while True:
            bits = max_length - 1
            while bl_count[bits] == 0:
                bits -= 1
            bl_count[bits] -= 1
            bl_count[bits + 1] += 2
            bl_count[max_length] -= 1
            overflow -= 2
            if overflow <= 0:
                break
        h = HEAP_SIZE
        for bits in range(max_length, 0, -1):
            n = bl_count[bits]
            while n:
                h -= 1
                m = heap[h]
                if m > max_code:
                    continue
                if lens[m] != bits:
                    costs.opt += (bits - lens[m]) * freq[m]
                    lens[m] = bits
                n -= 1
    leaf_lens = lens[:elems]  # 0 where a symbol is not in the tree
    return leaf_lens, _gen_codes(leaf_lens, max_code, bl_count), max_code


def _runs(lens: List[int], max_code: int):
    """zlib's ``scan_tree`` / ``send_tree`` walk of ``lens[0..max_code]``:
    each item (code, extra bits, extra value) of the lengths' encoding."""
    prevlen, nextlen, count = -1, lens[0], 0
    max_count, min_count = (138, 3) if nextlen == 0 else (7, 4)
    guarded = lens[: max_code + 1] + [0xFFFF]
    for n in range(max_code + 1):
        curlen, nextlen = nextlen, guarded[n + 1]
        count += 1
        if count < max_count and curlen == nextlen:
            continue
        if count < min_count:
            for _ in range(count):
                yield curlen, 0, 0
        elif curlen != 0:
            if curlen != prevlen:
                yield curlen, 0, 0
                count -= 1
            yield 16, 2, count - 3
        elif count <= 10:
            yield 17, 3, count - 3
        else:
            yield 18, 7, count - 11
        count, prevlen = 0, curlen
        if nextlen == 0:
            max_count, min_count = 138, 3
        elif curlen == nextlen:
            max_count, min_count = 6, 3
        else:
            max_count, min_count = 7, 4


class _Bits:
    """zlib's bit writer: values of up to 16 bits, least significant first."""

    def __init__(self) -> None:
        self.vals: List[int] = []
        self.lens: List[int] = []
        self.n = 0

    def send(self, value: int, length: int) -> None:
        if length:
            self.vals.append(value)
            self.lens.append(length)
            self.n += length

    def windup(self) -> None:
        self.send(0, -self.n % 8)

    def tobytes(self) -> bytes:
        self.windup()
        vals = np.array(self.vals, dtype=np.int64)
        lens = np.array(self.lens, dtype=np.int64)
        at = np.cumsum(lens) - lens
        bits = np.zeros(self.n, dtype=np.uint8)
        for j in range(16):
            on = lens > j
            bits[at[on] + j] = (vals[on] >> j) & 1
        return np.packbits(bits, bitorder="little").tobytes()


def _flush_block(out: _Bits, payload: np.ndarray, start: int, end: int,
                 syms: List[Tuple[int, int]], last: bool, slid: bool) -> None:
    """zlib's ``_tr_flush_block`` of the symbols ``syms`` ((dist, lc): a
    literal lc where dist is 0), which cover ``payload[start:end]``. Where
    the window has ``slid`` and the block starts below WSIZE, its bytes are
    gone from the window (``FLUSH_BLOCK`` passes no buffer) and it is not
    stored."""
    lfreq = [0] * (2 * L_CODES + 1)
    dfreq = [0] * (2 * D_CODES + 1)
    lfreq[END_BLOCK] = 1
    for dist, lc in syms:
        if dist == 0:
            lfreq[lc] += 1
        else:
            lfreq[length_code(lc) + 257] += 1
            dfreq[dist_code(dist - 1)] += 1
    costs = _Costs()
    llen, lcode, lmax = build_tree(lfreq, L_CODES, STATIC_LLEN, EXTRA_LBITS, 257, 15, costs)
    dlen, dcode, dmax = build_tree(dfreq, D_CODES, [5] * D_CODES, EXTRA_DBITS, 0, 15, costs)
    blfreq = [0] * (2 * BL_CODES + 1)
    for lens, max_code in ((llen, lmax), (dlen, dmax)):
        for code, _, _ in _runs(lens, max_code):
            blfreq[code] += 1
    bllen, blcode, _ = build_tree(blfreq, BL_CODES, None, EXTRA_BLBITS, 0, 7, costs)
    max_blindex = BL_CODES - 1
    while max_blindex >= 3 and bllen[BL_ORDER[max_blindex]] == 0:
        max_blindex -= 1
    costs.opt += 3 * (max_blindex + 1) + 5 + 5 + 4
    opt_lenb = (costs.opt + 3 + 7) >> 3
    static_lenb = (costs.static + 3 + 7) >> 3
    if static_lenb <= opt_lenb:
        opt_lenb = static_lenb
    stored_len = end - start
    if stored_len + 4 <= opt_lenb and not (slid and start < WSIZE):
        out.send(int(last), 3)
        out.windup()
        out.send(stored_len & 0xFF, 8)
        out.send(stored_len >> 8, 8)
        out.send(~stored_len & 0xFF, 8)
        out.send((~stored_len >> 8) & 0xFF, 8)
        for b in payload[start:end].tolist():
            out.send(b, 8)
        return
    if static_lenb == opt_lenb:
        out.send(2 + int(last), 3)
        ltree = (STATIC_LLEN, STATIC_LCODE)
        dtree = ([5] * D_CODES, STATIC_DCODE)
    else:
        out.send(4 + int(last), 3)
        out.send(lmax + 1 - 257, 5)
        out.send(dmax + 1 - 1, 5)
        out.send(max_blindex + 1 - 4, 4)
        for rank in range(max_blindex + 1):
            out.send(bllen[BL_ORDER[rank]], 3)
        for lens, max_code in ((llen, lmax), (dlen, dmax)):
            for code, xbits, xval in _runs(lens, max_code):
                out.send(blcode[code], bllen[code])
                out.send(xval, xbits)
        ltree = (llen, lcode)
        dtree = (dlen, dcode)
    for dist, lc in syms:
        if dist == 0:
            out.send(ltree[1][lc], ltree[0][lc])
            continue
        code = length_code(lc)
        out.send(ltree[1][code + 257], ltree[0][code + 257])
        out.send(lc - BASE_LENGTH[code], EXTRA_LBITS[code])
        code = dist_code(dist - 1)
        out.send(dtree[1][code], dtree[0][code])
        out.send(dist - 1 - BASE_DIST[code], EXTRA_DBITS[code])
    out.send(ltree[1][END_BLOCK], ltree[0][END_BLOCK])


def parse(payload: np.ndarray
          ) -> Iterator[Tuple[int, int, List[Tuple[int, int]], bool, bool]]:
    """Phase 2's lazy parse over :func:`match_records`: zlib's
    ``deflate_slow`` at level 6 on ``payload`` (at most 65,280 bytes, read
    into the window at once), ended by ``deflate(Z_FINISH)``. Yields each
    DEFLATE block as (start, end, symbols, last, slid): the symbols, (dist,
    lc) with a literal lc where dist is 0, cover ``payload[start:end]``;
    ``slid`` where the window slid before the flush, which zlib does once,
    at the first step of the parse at or past SLIDE_AT (a step's position
    is where it starts, before a match moves it on; the end is the last
    step)."""
    n = payload.shape[0]
    rec128, rec32 = match_records(payload)
    rec128, rec32 = rec128.tolist(), rec32.tolist()
    data = payload.tolist()
    syms: List[Tuple[int, int]] = []
    s, block_start = 0, 0
    match_length, match_start, available = MIN_MATCH - 1, 0, False
    while s < n:
        step = s
        prev_length, prev_match = match_length, match_start
        match_length = MIN_MATCH - 1
        rec = rec32[s] if prev_length >= GOOD_LENGTH else rec128[s]
        if rec and prev_length < MAX_LAZY and (rec & 511) > prev_length:
            match_length, match_start = rec & 511, s - (rec >> 9)
            if match_length == MIN_MATCH and s - match_start > TOO_FAR:
                match_length = MIN_MATCH - 1
        if prev_length >= MIN_MATCH and match_length <= prev_length:
            syms.append((s - 1 - prev_match, prev_length - MIN_MATCH))
            s += prev_length - 1
            available = False
            match_length = MIN_MATCH - 1
            if len(syms) == SYMBOLS_PER_BLOCK:
                yield block_start, s, syms, False, step >= SLIDE_AT
                syms, block_start = [], s
        elif available:
            syms.append((0, data[s - 1]))
            if len(syms) == SYMBOLS_PER_BLOCK:
                yield block_start, s, syms, False, step >= SLIDE_AT
                syms, block_start = [], s
            s += 1
        else:
            available = True
            s += 1
    if available:
        syms.append((0, data[s - 1]))
    yield block_start, s, syms, True, s >= SLIDE_AT


def deflate_raw(payload: np.ndarray) -> bytes:
    """The raw DEFLATE stream of ``payload`` (at most 65,280 bytes) that
    zlib level 6 writes: :func:`parse`'s blocks through
    ``_tr_flush_block``."""
    out = _Bits()
    for start, end, syms, last, slid in parse(payload):
        _flush_block(out, payload, start, end, syms, last, slid)
    return out.tobytes()
