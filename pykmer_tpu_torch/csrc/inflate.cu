// Inflate on the card: whole BGZF blocks, each an independent DEFLATE
// stream (RFC 1951) inside a gzip member (RFC 1952) with the BGZF "BC"
// extra subfield (SAMv1 §4.1), into their places in one output buffer, each
// block's CRC32 and ISIZE checked against its trailer.
//
// It replaces no TPU kernel: the JAX package inflates a `.gz` on the host
// with zlib, as the port's CPU, host-strategy, sharded and multi-host routes
// still do (host/segments.inflate_blocks, the native gzip_decompress). On
// the single-card streaming route the host's zlib pool paced the index: on
// an H100 machine's 8-core host zlib inflates 0.156 GB/s a thread, ~1 GB/s
// on six threads, where the card decode downstream takes ~3 GB/s. This
// kernel is the streaming route's inflate.
//
// Bound on the H100: a run of blocks reads its compressed bytes once and
// writes its inflated bytes once (247.5 MB in and 840 MB out for the
// plants-k15 bgzip: 0.32 ms at 3.35 TB/s), but Huffman decoding is serial
// within a stream: each symbol's length is known only once it is decoded.
// So the kernel is bound by the decode's dependent chain of a block, times
// the blocks over the warps the card holds at once.
//
// Design: one warp a BGZF block, four a CTA. All 32 lanes decode the same
// symbols in step (the same loads, broadcast; no divergence), from a 64-bit
// bit buffer refilled a 32-bit word at a time, and each Huffman code through
// a 512-entry table of (symbol, length) in the warp's shared memory; a code
// longer than 9 bits takes the canonical decode of the counts (puff's).
// Lane 0 writes each literal; the 32 lanes copy a back-reference together
// (byte i of the match from byte i mod distance of its source, so an
// overlapping match needs no order within it), and a stored block. Dynamic
// tables are counted and sorted by lane 0 and filled by all lanes. The
// inflated block stays in place in the output, and its CRC32 is taken by
// the 32 lanes over 32 contiguous pieces (a byte table in shared memory),
// combined in GF(2) as zlib's crc32_combine does. Streams are held to
// zlib's rules: over-subscribed or incomplete codes (but a single code of
// one bit), a missing end-of-block code, a repeat with nothing before it,
// too many length or distance codes, a distance too far back, the codes
// 286-287 and 30-31, a stored block whose NLEN is not ~LEN. Beyond zlib,
// the stream must end in the payload's last byte.
//
// Status a block: 0 ok, 1 bad stream, 2 ISIZE mismatch (the inflated size,
// or the trailer, differs from the offsets given), 3 CRC mismatch. A block
// that fails stops there; the others are unaffected. The kernel writes only
// inside each block's own output range.
//
// The launcher takes device pointers, sizes and the stream, launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "crc32.cuh"

namespace {

constexpr int kWarps = 4;  // BGZF blocks a CTA, one a warp
constexpr int kLutBits = 9;
constexpr int kLut = 1 << kLutBits;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kOk = 0, kBadStream = 1, kBadIsize = 2, kBadCrc = 3;

__constant__ uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                                      15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                                      67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                      2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,
                                       17,   25,   33,   49,   65,   97,    129,   193,
                                       257,  385,  513,  769,  1025, 1537,  2049,  3073,
                                       4097, 6145, 8193, 12289, 16385, 24577};
__constant__ uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                       6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
// the order in which a dynamic header gives the code-length code's lengths
__constant__ uint8_t kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                     11, 4, 12, 3, 13, 2, 14, 1, 15};
// A Huffman code: ``lut`` maps the next 9 bits of the stream to symbol |
// length << 9 (0: a longer code, or none); the rest is the canonical code.
struct Table {
  uint16_t lut[kLut];
  uint16_t count[16];  // codes of each length
  uint16_t start[16];  // the first of each length in the sorted symbols
  uint16_t first[16];  // the first code of each length
};

struct WarpSmem {
  Table lit, dist;       // dist holds the code-length code while a header is read
  uint16_t lit_sym[288]; // symbols sorted by (length, symbol)
  uint16_t dist_sym[32];
  uint8_t lens[320];
};

struct Bits {
  const uint32_t* words;
  int64_t n_words;
  uint64_t buf;  // bits not yet consumed, the next lowest; zero above cnt
  int cnt;
  int64_t next;  // the next word to load

  __device__ __forceinline__ uint32_t word(int64_t i) const {
    return i < n_words ? __ldg(words + i) : 0u;
  }
  __device__ __forceinline__ void seek(int64_t bit) {
    next = bit >> 5;
    buf = uint64_t(word(next++)) >> (bit & 31);
    cnt = 32 - int(bit & 31);
  }
  // at least ``n`` (<= 32) bits in buf
  __device__ __forceinline__ void need(int n) {
    if (cnt < n) {
      buf |= uint64_t(word(next++)) << cnt;
      cnt += 32;
    }
  }
  __device__ __forceinline__ void drop(int n) {
    buf >>= n;
    cnt -= n;
  }
  __device__ __forceinline__ uint32_t take(int n) {
    const uint32_t v = uint32_t(buf) & ((1u << n) - 1u);
    drop(n);
    return v;
  }
  __device__ __forceinline__ int64_t pos() const { return next * 32 - cnt; }
};

// the next symbol of code ``t`` (at least 15 bits in ``br``), or -1
__device__ __forceinline__ int decode(Bits& br, const Table& t, const uint16_t* sym) {
  const uint32_t bits = uint32_t(br.buf);
  const uint32_t e = t.lut[bits & (kLut - 1)];
  if (e) {
    br.drop(e >> 9);
    return int(e & 511);
  }
  int code = 0, first = 0, index = 0;
  for (int len = 1; len <= 15; len++) {
    code |= (bits >> (len - 1)) & 1;
    const int count = t.count[len];
    if (code - count < first) {
      br.drop(len);
      return sym[index + (code - first)];
    }
    index += count;
    first += count;
    first <<= 1;
    code <<= 1;
  }
  return -1;
}

// The code of ``n`` lengths, or false where zlib refuses them: over-
// subscribed, or incomplete unless it is a single one-bit code (never for
// the code-length code, ``codes``). Lane 0 counts and sorts; all lanes fill.
__device__ bool build(Table& t, uint16_t* sym, const uint8_t* lens, int n, bool codes,
                      int lane) {
  int ok = 1;
  if (lane == 0) {
    for (int l = 0; l < 16; l++) t.count[l] = 0;
    for (int s = 0; s < n; s++) t.count[lens[s]]++;
    t.count[0] = 0;
    int left = 1, max = 0;
    for (int l = 1; l < 16; l++) {
      if (t.count[l]) max = l;
      left = (left << 1) - t.count[l];
      if (left < 0) {
        ok = 0;
        break;
      }
    }
    if (ok && max != 0 && left > 0 && (codes || max != 1)) ok = 0;
    int code = 0, start = 0;
    uint16_t offs[16];
    for (int l = 1; l < 16; l++) {
      code = (code + t.count[l - 1]) << 1;
      t.first[l] = uint16_t(code);
      t.start[l] = uint16_t(start);
      offs[l] = uint16_t(start);
      start += t.count[l];
    }
    if (ok) {
      for (int s = 0; s < n; s++)
        if (lens[s]) sym[offs[lens[s]]++] = uint16_t(s);
    }
  }
  __syncwarp();
  ok = __shfl_sync(kFull, ok, 0);
  if (!ok) return false;
  for (int i = lane; i < kLut; i += 32) t.lut[i] = 0;
  __syncwarp();
  const int total = t.start[15] + t.count[15];
  for (int i = lane; i < total; i += 32) {
    const int s = sym[i], l = lens[s];
    if (l > kLutBits) break;  // sorted by length
    const uint32_t code = t.first[l] + uint32_t(i - t.start[l]);
    const uint16_t e = uint16_t(s | (l << 9));
    for (uint32_t k = __brev(code) >> (32 - l); k < uint32_t(kLut); k += 1u << l) t.lut[k] = e;
  }
  __syncwarp();
  return true;
}

__device__ void build_fixed(WarpSmem& w, int lane) {
  for (int i = lane; i < 288; i += 32) w.lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
  __syncwarp();
  build(w.lit, w.lit_sym, w.lens, 288, false, lane);
  w.lens[lane] = 5;  // 32 distance codes; 30 and 31 are refused when decoded
  __syncwarp();
  build(w.dist, w.dist_sym, w.lens, 32, false, lane);
}

// a dynamic block's header: the code-length code, then the lengths of both codes
__device__ int read_dynamic(Bits& br, WarpSmem& w, int lane) {
  br.need(14);
  const int nlen = int(br.take(5)) + 257, ndist = int(br.take(5)) + 1;
  const int ncode = int(br.take(4)) + 4;
  if (nlen > 286 || ndist > 30) return kBadStream;
  for (int i = 0; i < 19; i++) {
    br.need(3);
    const uint8_t v = i < ncode ? uint8_t(br.take(3)) : 0;
    if (lane == 0) w.lens[kClOrder[i]] = v;
  }
  __syncwarp();
  if (!build(w.dist, w.dist_sym, w.lens, 19, true, lane)) return kBadStream;
  int i = 0, prev = 0;
  while (i < nlen + ndist) {
    br.need(15 + 7);
    const int s = decode(br, w.dist, w.dist_sym);
    if (s < 0) return kBadStream;
    if (s < 16) {
      if (lane == 0) w.lens[i] = uint8_t(s);
      prev = s;
      i++;
      continue;
    }
    int rep, v = 0;
    if (s == 16) {
      if (i == 0) return kBadStream;
      v = prev;
      rep = 3 + int(br.take(2));
    } else if (s == 17) {
      rep = 3 + int(br.take(3));
    } else {
      rep = 11 + int(br.take(7));
    }
    if (i + rep > nlen + ndist) return kBadStream;
    for (int j = lane; j < rep; j += 32) w.lens[i + j] = uint8_t(v);
    prev = v;
    i += rep;
  }
  __syncwarp();
  if (w.lens[256] == 0) return kBadStream;
  if (!build(w.lit, w.lit_sym, w.lens, nlen, false, lane)) return kBadStream;
  if (!build(w.dist, w.dist_sym, w.lens + nlen, ndist, false, lane)) return kBadStream;
  return kOk;
}

// The DEFLATE payload of the block [c0, c1) of ``comp`` into ``out``,
// which holds ``isize`` bytes; the status.
__device__ int inflate_block(const uint8_t* __restrict__ comp, int64_t n_words, int64_t c0,
                             int64_t c1, uint8_t* out, int64_t isize, WarpSmem& w, int lane) {
  if (c1 - c0 < 26) return kBadStream;  // 18 bytes of header at the least, 8 of trailer
  const int xlen = __ldg(comp + c0 + 10) | (__ldg(comp + c0 + 11) << 8);
  const int64_t start = c0 + 12 + xlen, end = c1 - 8, end_bit = end * 8;
  if (start > end) return kBadStream;
  Bits br;
  br.words = reinterpret_cast<const uint32_t*>(comp);
  br.n_words = n_words;
  br.seek(start * 8);
  int64_t pos = 0;  // bytes inflated
  for (int last = 0; !last;) {
    if (br.pos() + 3 > end_bit) return kBadStream;
    br.need(3);
    last = int(br.take(1));
    const int type = int(br.take(2));
    if (type == 0) {  // stored
      br.drop(br.cnt & 7);
      br.need(32);
      const uint32_t len = br.take(16), nlen = br.take(16);
      const int64_t at = br.pos() >> 3;
      if (len != (~nlen & 0xFFFFu) || at + len > end) return kBadStream;
      if (pos + len > isize) return kBadIsize;
      for (int64_t i = lane; i < len; i += 32) out[pos + i] = __ldg(comp + at + i);
      pos += len;
      br.seek((at + len) * 8);
      continue;
    }
    if (type == 3) return kBadStream;
    if (type == 1) {
      build_fixed(w, lane);
    } else {
      const int st = read_dynamic(br, w, lane);
      if (st != kOk) return st;
    }
    for (;;) {
      br.need(15 + 5);
      int s = decode(br, w.lit, w.lit_sym);
      if (s < 256) {
        if (s < 0) return kBadStream;
        if (pos >= isize) return br.pos() > end_bit ? kBadStream : kBadIsize;
        if (lane == 0) out[pos] = uint8_t(s);
        pos++;
        continue;
      }
      if (s == 256) break;
      s -= 257;
      if (s >= 29) return kBadStream;
      const int len = kLenBase[s] + int(br.take(kLenExtra[s]));
      br.need(15 + 13);
      const int d = decode(br, w.dist, w.dist_sym);
      if (d < 0 || d >= 30) return kBadStream;
      const int dist = kDistBase[d] + int(br.take(kDistExtra[d]));
      if (dist > pos) return kBadStream;
      if (pos + len > isize) return br.pos() > end_bit ? kBadStream : kBadIsize;
      __syncwarp();  // the literals and the copies before are in place
      uint8_t* dst = out + pos;
      const uint8_t* src = dst - dist;
      if (dist >= len) {
        for (int i = lane; i < len; i += 32) dst[i] = src[i];
      } else {
        for (int i = lane; i < len; i += 32) dst[i] = src[i % dist];
      }
      pos += len;
    }
  }
  if ((br.pos() + 7) >> 3 != end) return kBadStream;
  return pos == isize ? kOk : kBadIsize;
}

__device__ __forceinline__ uint32_t le32(const uint8_t* p) {
  return uint32_t(__ldg(p)) | uint32_t(__ldg(p + 1)) << 8 | uint32_t(__ldg(p + 2)) << 16 |
         uint32_t(__ldg(p + 3)) << 24;
}

// block b spans comp[c_offs[b] - c_base, c_offs[b+1] - c_base) and inflates
// to out[u_offs[b] - u_base, u_offs[b+1] - u_base)
__global__ void __launch_bounds__(kWarps * 32)
inflate_kernel(const uint8_t* __restrict__ comp, int64_t comp_bytes,
               const int64_t* __restrict__ c_offs, const int64_t* __restrict__ u_offs,
               int64_t n_blocks, int64_t c_base, int64_t u_base, uint8_t* out,
               int64_t out_bytes, int32_t* __restrict__ status) {
  __shared__ uint32_t crc_table[256];
  __shared__ WarpSmem smem[kWarps];
  crc_table_fill(crc_table);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t b = int64_t(blockIdx.x) * kWarps + warp;
  if (b >= n_blocks) return;
  const int64_t c0 = c_offs[b] - c_base, c1 = c_offs[b + 1] - c_base;
  const int64_t u0 = u_offs[b] - u_base, isize = u_offs[b + 1] - u_offs[b];
  int st;
  if (c0 < 0 || c1 > comp_bytes || c1 < c0) {
    st = kBadStream;
  } else if (u0 < 0 || isize < 0 || u0 + isize > out_bytes) {
    st = kBadIsize;
  } else {
    st = inflate_block(comp, comp_bytes / 4, c0, c1, out + u0, isize, smem[warp], lane);
    if (st == kOk) {
      if (le32(comp + c1 - 4) != uint32_t(isize)) {
        st = kBadIsize;
      } else if (crc_warp(out + u0, isize, crc_table, lane) != le32(comp + c1 - 8)) {
        st = kBadCrc;
      }
    }
  }
  if (lane == 0) status[b] = st;
}

}  // namespace

// comp is 4-byte aligned and comp_bytes a multiple of 4, so every word the
// bit reader loads lies in it
extern "C" int pykmer_inflate_bgzf(const uint8_t* comp, int64_t comp_bytes,
                                   const int64_t* c_offs, const int64_t* u_offs,
                                   int64_t n_blocks, int64_t c_base, int64_t u_base,
                                   uint8_t* out, int64_t out_bytes, int32_t* status,
                                   cudaStream_t stream) {
  if (n_blocks <= 0) return 0;
  const int64_t grid = (n_blocks + kWarps - 1) / kWarps;
  inflate_kernel<<<unsigned(grid), kWarps * 32, 0, stream>>>(
      comp, comp_bytes, c_offs, u_offs, n_blocks, c_base, u_base, out, out_bytes, status);
  return int(cudaGetLastError());
}
