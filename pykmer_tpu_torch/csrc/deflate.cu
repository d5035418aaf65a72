// Deflate on the card: whole 65,280-byte BGZF blocks into complete BGZF
// members (SAMv1 §4.1: the 18-byte gzip header with the "BC" subfield and
// BSIZE, a raw DEFLATE stream, CRC32, ISIZE), packed in block order. The
// stream is byte for byte zlib 1.2.x-1.3's for deflateInit2(6, Z_DEFLATED,
// -15, 8, Z_DEFAULT_STRATEGY) and one deflate(Z_FINISH) of the block: what
// htslib's bgzip writes, and what the `.kin.bgz` must hold.
//
// It replaces no TPU kernel: the JAX package deflates on the host
// (pykmer_tpu/io/bgzf.py), as the port's CPU route still does (the native
// codec, ops/deflate.host_members). On an H100 machine's 8-core host zlib's
// level 6 runs ~10 MB/s a thread, and the 1 GiB `.kin` of K=15 took ~13 s.
//
// Bound: not the bytes (1 GiB in, ~0.22 GB out: 0.4 ms at 3.35 TB/s) but the
// search. zlib's level 6 walks a position's hash chain up to 128 candidates
// (32 once a match of 8 is pending), comparing bytes at each. A `.kin`'s
// bytes are small counts, so its 3-byte hashes are few and its chains long:
// the K=15 `.kin` of the plants genome takes 1.24 * 10^11 candidate visits,
// 117 a position (counted on an H100), at ~10-20 integer instructions each.
// The lazy parse and the Huffman coding after it are serial within a block
// but short beside that.
//
// Design, in two phases (ops/deflate.py repeats both in numpy and Python,
// and the CPU tests hold them to zlib):
//
// 1. match_kernel, a CTA of 1,024 threads a block, over positions. At level
//    6 zlib inserts every position but the last 2 into the chains, and a
//    search depends on the parse only through the previous match length
//    (which picks the chain limit, 128 or 32, and the length to beat). So
//    each position's walk is taken once, in parallel: all threads hash the
//    positions, warp 0 builds the block's `prev` (the last earlier position
//    of the same hash) in order, 32 positions a step through
//    __match_any_sync and a head table; then the payload (in the head
//    table's place) and `prev` sit in shared memory (196 KB) and each
//    thread walks its positions' chains, neighbouring
//    positions on a warp's lanes, recording the best match of the first 32
//    and of the first 128 candidates (len | dist << 9; 0: zlib would not
//    search there). zlib's one slide of its window inside a block depends
//    on positions alone too: from kSlideAt on, a head of kWSize is NIL.
// 2. emit_kernel, a warp a block, four a CTA. The 32 lanes run zlib's
//    deflate_slow in step on the same values (the records and bytes come
//    256 positions at a time into shared memory, loaded by all lanes); lane
//    0 keeps the symbols (in a global scratch) and their counts. At 16,383
//    symbols and at the end, lane 0 builds zlib's three trees (its heap,
//    ties broken by depth, gen_bitlen's repair of lengths over their
//    limit), picks stored, fixed or dynamic as _tr_flush_block does, and the
//    lanes emit the bits 32 symbols at a time: each lane codes one symbol,
//    a warp scan places them, and shared-memory ORs gather whole words. The
//    CRC32 is the warp's (crc32.cuh).
// 3. pack_kernel moves each member from its 64 KiB slot to its place in the
//    packed output (the sum of the sizes before it).
//
// The launcher takes device pointers, sizes and the stream, launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "crc32.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBlock = 65280;      // a BGZF block's payload
constexpr int kMemberMax = 65536;  // a member's slot
constexpr int kSymMax = 16383;     // symbols a DEFLATE block (lit_bufsize - 1)
constexpr int kMinMatch = 3, kMaxMatch = 258;
constexpr int kWSize = 32768;
constexpr int kMaxDist = kWSize - (kMaxMatch + kMinMatch + 1);  // 32,506
// zlib slides its window by kWSize at the first step of the parse at or past
// this position: a head or chain entry of kWSize or less becomes NIL, and a
// DEFLATE block that starts below kWSize can no longer be stored
constexpr int kSlideAt = kWSize + kMaxDist;  // 65,274
constexpr int kTooFar = 4096, kGood = 8, kLazy = 16, kNice = 128, kChain = 128;
constexpr int kMatchThreads = 1024;
// prev (u16 a position), then the head table (u16 a hash) that the payload replaces
constexpr int kMatchSmem = kBlock * 2 + 32768 * 2;
constexpr int kWarps = 4;  // blocks an emit CTA, one a warp
constexpr int kWin = 256;  // positions a refill of the parse's window
constexpr int kStage = 64;  // words of the bit stager
constexpr int kItems = 352;  // a DEFLATE block's header items, at most 339

constexpr int kLCodes = 286, kDCodes = 30, kBlCodes = 19, kEndBlock = 256;
constexpr int kHeap = 2 * kLCodes + 1;

// in global memory: build_tree takes them through generic pointers
__device__ const uint8_t kExtraL[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                        2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__device__ const uint8_t kExtraD[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                        6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
__device__ const uint8_t kExtraBl[19] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                         0, 0, 0, 0, 0, 0, 2, 3, 7};
__device__ const uint8_t kBlOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                         11, 4, 12, 3, 13, 2, 14, 1, 15};
__device__ const uint16_t kBaseL[29] = {0,  1,  2,  3,  4,  5,  6,  7,  8,   10,
                                        12, 14, 16, 20, 24, 28, 32, 40, 48,  56,
                                        64, 80, 96, 112, 128, 160, 192, 224, 0};
__device__ const uint16_t kBaseD[30] = {
    0,   1,   2,   3,   4,    6,    8,    12,   16,   24,   32,   48,    64,    96,    128,
    192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288, 16384, 24576};

// ---- phase 1 ----------------------------------------------------------------

// bytes x..x+3 of the 4-byte aligned shared buffer, little-endian
__device__ __forceinline__ uint32_t load4(const uint8_t* buf, int x) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf) + (x >> 2);
  return __funnelshift_r(w[0], w[1], (x & 3) * 8);
}

__global__ void __launch_bounds__(kMatchThreads)
match_kernel(const uint8_t* __restrict__ data, int64_t n_total, uint2* __restrict__ records) {
  extern __shared__ uint4 smem_raw[];
  uint16_t* prev = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* head = prev + kBlock;
  uint8_t* buf = reinterpret_cast<uint8_t*>(head);  // after the build
  const int64_t b = blockIdx.x;
  const uint8_t* src = data + b * kBlock;
  const int n = int(n_total - b * kBlock < kBlock ? n_total - b * kBlock : kBlock);
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < 32768 / 8; i += kMatchThreads) reinterpret_cast<uint4*>(head)[i] =
      make_uint4(0, 0, 0, 0);
  // each position's hash first, by every thread, in prev's place: the serial
  // build below then reads shared memory only (hashing from the global bytes
  // there, the build took a fifth of the kernel's time on the H100)
  for (int p = tid; p + kMinMatch <= n; p += kMatchThreads)
    prev[p] = uint16_t(((uint32_t(__ldg(src + p)) << 10) ^
                        (uint32_t(__ldg(src + p + 1)) << 5) ^ __ldg(src + p + 2)) & 0x7FFFu);
  __syncthreads();
  if (tid < 32) {
    // zlib's INSERT_STRING for every position <= n - 3, in order: prev[p]
    // becomes the hash's head before p enters it (0, NIL, where none)
    for (int at = 0; at + kMinMatch <= n; at += 32) {
      const int p = at + lane;
      const bool ok = p + kMinMatch <= n;
      const uint32_t h = ok ? uint32_t(prev[p]) : 0x10000u + lane;  // no peers
      const unsigned peers = __match_any_sync(kFull, h);
      const unsigned lower = peers & ((1u << lane) - 1u);
      if (ok) prev[p] = lower ? uint16_t(at + 31 - __clz(lower)) : head[h];
      __syncwarp();
      if (ok && (peers >> lane) == 1u) head[h] = uint16_t(p);  // the group's last
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += kMatchThreads) buf[i] = __ldg(src + i);
  __syncthreads();
  uint2* rec = records + b * kBlock;
  for (int p = tid; p < n; p += kMatchThreads) {
    uint32_t r128 = 0, r32 = 0;
    const int left = n - p;
    int cur = left >= kMinMatch ? prev[p] : 0;
    if (cur > 0 && p - cur <= kMaxDist && (p < kSlideAt || cur > kWSize)) {
      const int cap = left < kMaxMatch ? left : kMaxMatch;
      const int nice = left < kNice ? left : kNice;
      const int limit = p > kMaxDist ? p - kMaxDist : 0;
      const uint8_t* scan = buf + p;
      const uint32_t scan3 = load4(buf, p + 3);
      int best = kMinMatch - 1, dist = 0, k = 0;
      uint8_t scan_best = scan[best];
      for (;;) {
        const uint8_t* m = buf + cur;
        if (m[best] == scan_best && m[0] == scan[0] && m[1] == scan[1]) {
          // the third byte is equal where the first two and the hash are;
          // then 4 bytes a step, the bytes past the payload cut off by cap
          int len = 3;
          uint32_t x = load4(buf, cur + 3) ^ scan3;
          while (x == 0 && len + 4 < cap) {
            len += 4;
            x = load4(buf, cur + len) ^ load4(buf, p + len);
          }
          len += x ? (__ffs(x) - 1) >> 3 : 4;
          if (len > cap) len = cap;
          if (len > best) {
            best = len;
            dist = p - cur;
            scan_best = scan[best];
          }
        }
        if (++k == 32) r32 = uint32_t(best) | uint32_t(dist) << 9;
        if (best >= nice) break;
        const int next = prev[cur];
        if (next <= limit || k == kChain) break;
        cur = next;
      }
      r128 = uint32_t(best) | uint32_t(dist) << 9;
      if (k < 32) r32 = r128;
    }
    rec[p] = make_uint2(r128, r32);
  }
}

// ---- phase 2 ----------------------------------------------------------------

struct Tree {  // zlib's build_tree work arrays, for the largest tree
  uint16_t freq[kHeap];
  uint16_t dad[kHeap];
  uint16_t len[kHeap + 1];
  uint16_t heap[kHeap + 1];
  uint8_t depth[kHeap];
  uint16_t bl_count[16];
};

struct WarpSmem {
  uint2 win[kWin];            // the records of positions [base, base + kWin)
  uint8_t win_byte[kWin + 4];  // payload bytes [base - 1, base + kWin)
  uint32_t stage[kStage];     // bits not yet written, from the word `word`
  uint32_t items[kItems];     // header items: value | bits << 24
  uint16_t lfreq[kLCodes], dfreq[kDCodes], blfreq[kBlCodes];
  uint8_t llen[kLCodes + 2], dlen[kDCodes + 2], bllen[kBlCodes + 1];
  uint16_t lcode[kLCodes + 2], dcode[kDCodes + 2], blcode[kBlCodes + 1];
  Tree t;
  int n_items;
};

struct Static {
  uint8_t len_code[256];   // zlib's _length_code
  uint8_t dist_code[512];  // zlib's _dist_code
  uint16_t lcode[288];
  uint8_t llen[288];
  uint16_t dcode[32];
  uint8_t dlen[32];
  uint32_t crc[256];
};

__device__ __forceinline__ int d_code(const Static& st, int d) {
  return d < 256 ? st.dist_code[d] : st.dist_code[256 + (d >> 7)];
}

__device__ __forceinline__ uint32_t reverse(uint32_t code, int len) {
  return len ? __brev(code) >> (32 - len) : 0u;
}

// zlib's build_tree + gen_bitlen + gen_codes on lane 0: lengths and codes of
// symbols 0..elems-1 into len_out / code_out, from counts (elems entries;
// the copy in t gains the forced codes' 1s); returns max_code. opt and stat
// gain the bits. Out of line, as flush_block: both run a few times a block,
// from several call sites, and inlined they took this source's build from
// ~4 s to ~9 s on the H100 machine.
__device__ __noinline__ int build_tree(Tree& t, const uint16_t* counts, int elems,
                                       const uint8_t* stree_len, const uint8_t* extra, int base,
                                       int max_length, uint8_t* len_out, uint16_t* code_out,
                                       int64_t& opt, int64_t& stat) {
  int heap_len = 0, heap_max = kHeap, max_code = -1;
  for (int n = 0; n < elems; n++) {
    t.freq[n] = counts[n];
    t.depth[n] = 0;
    t.len[n] = 0;
    if (counts[n]) t.heap[++heap_len] = uint16_t(max_code = n);
  }
  while (heap_len < 2) {
    const int node = max_code < 2 ? ++max_code : 0;
    t.heap[++heap_len] = uint16_t(node);
    t.freq[node] = 1;
    t.depth[node] = 0;
    opt--;
    if (stree_len) stat -= stree_len[node];
  }
  auto smaller = [&](int a, int c) {
    return t.freq[a] < t.freq[c] || (t.freq[a] == t.freq[c] && t.depth[a] <= t.depth[c]);
  };
  auto down = [&](int k) {
    const int v = t.heap[k];
    int j = k << 1;
    while (j <= heap_len) {
      if (j < heap_len && smaller(t.heap[j + 1], t.heap[j])) j++;
      if (smaller(v, t.heap[j])) break;
      t.heap[k] = t.heap[j];
      k = j;
      j <<= 1;
    }
    t.heap[k] = uint16_t(v);
  };
  for (int k = heap_len / 2; k >= 1; k--) down(k);
  int node = elems;
  do {
    const int n = t.heap[1];
    t.heap[1] = t.heap[heap_len--];
    down(1);
    const int m = t.heap[1];
    t.heap[--heap_max] = uint16_t(n);
    t.heap[--heap_max] = uint16_t(m);
    t.freq[node] = uint16_t(t.freq[n] + t.freq[m]);
    t.depth[node] = uint8_t((t.depth[n] >= t.depth[m] ? t.depth[n] : t.depth[m]) + 1);
    t.dad[n] = t.dad[m] = uint16_t(node);
    t.heap[1] = uint16_t(node++);
    down(1);
  } while (heap_len >= 2);
  t.heap[--heap_max] = t.heap[1];

  // gen_bitlen
  for (int bits = 0; bits < 16; bits++) t.bl_count[bits] = 0;
  t.len[t.heap[heap_max]] = 0;
  int overflow = 0;
  for (int h = heap_max + 1; h < kHeap; h++) {
    const int n = t.heap[h];
    int bits = t.len[t.dad[n]] + 1;
    if (bits > max_length) {
      bits = max_length;
      overflow++;
    }
    t.len[n] = uint16_t(bits);
    if (n > max_code) continue;
    t.bl_count[bits]++;
    const int xbits = n >= base ? extra[n - base] : 0;
    opt += int64_t(t.freq[n]) * (bits + xbits);
    if (stree_len) stat += int64_t(t.freq[n]) * (stree_len[n] + xbits);
  }
  if (overflow) {
    do {
      int bits = max_length - 1;
      while (t.bl_count[bits] == 0) bits--;
      t.bl_count[bits]--;
      t.bl_count[bits + 1] += 2;
      t.bl_count[max_length]--;
      overflow -= 2;
    } while (overflow > 0);
    int h = kHeap;
    for (int bits = max_length; bits != 0; bits--) {
      int n = t.bl_count[bits];
      while (n != 0) {
        const int m = t.heap[--h];
        if (m > max_code) continue;
        if (t.len[m] != bits) {
          opt += (int64_t(bits) - t.len[m]) * t.freq[m];
          t.len[m] = uint16_t(bits);
        }
        n--;
      }
    }
  }
  // gen_codes
  uint16_t next_code[16];
  uint32_t code = 0;
  next_code[0] = 0;
  for (int bits = 1; bits < 16; bits++) {
    code = (code + t.bl_count[bits - 1]) << 1;
    next_code[bits] = uint16_t(code);
  }
  for (int n = 0; n < elems; n++) {
    const int len = n <= max_code ? t.len[n] : 0;
    len_out[n] = uint8_t(len);
    code_out[n] = len ? uint16_t(reverse(next_code[len]++, len)) : 0;
  }
  return max_code;
}

// zlib's scan_tree / send_tree over lens[0..max_code]: calls f(code, extra
// bits, extra value) for each item of the lengths' encoding
template <typename F>
__device__ void tree_runs(const uint8_t* lens, int max_code, F f) {
  int prevlen = -1, nextlen = lens[0], count = 0;
  int max_count = nextlen == 0 ? 138 : 7, min_count = nextlen == 0 ? 3 : 4;
  for (int n = 0; n <= max_code; n++) {
    const int curlen = nextlen;
    nextlen = n + 1 <= max_code ? lens[n + 1] : 0xFFFF;  // the guard
    if (++count < max_count && curlen == nextlen) continue;
    if (count < min_count) {
      do {
        f(curlen, 0, 0);
      } while (--count != 0);
    } else if (curlen != 0) {
      if (curlen != prevlen) {
        f(curlen, 0, 0);
        count--;
      }
      f(16, 2, count - 3);
    } else if (count <= 10) {
      f(17, 3, count - 3);
    } else {
      f(18, 7, count - 11);
    }
    count = 0;
    prevlen = curlen;
    if (nextlen == 0) {
      max_count = 138, min_count = 3;
    } else if (curlen == nextlen) {
      max_count = 6, min_count = 3;
    } else {
      max_count = 7, min_count = 4;
    }
  }
}

// The warp's bit writer: stage[0] is the slot's word `word`, whose low
// `bitpos` bits are written. put() appends each lane's ``nb`` (<= 57) bits
// of ``v``, lane order, least significant first, as zlib's send_bits does.
struct Writer {
  uint32_t* out;  // the member's slot, as words
  int word, bitpos;
};

__device__ void put(Writer& w, WarpSmem& s, uint64_t v, int nb, int lane) {
  int off = nb;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, off, d);
    if (lane >= d) off += t;
  }
  const int total = __shfl_sync(kFull, off, 31);
  if (total == 0) return;
  if (nb) {
    const int at = w.bitpos + off - nb, wi = at >> 5, sh = at & 31;
    const uint64_t x = v << sh;
    atomicOr(&s.stage[wi], uint32_t(x));
    if (nb + sh > 32) atomicOr(&s.stage[wi + 1], uint32_t(x >> 32));
    if (nb + sh > 64) atomicOr(&s.stage[wi + 2], uint32_t(v >> (64 - sh)));
  }
  __syncwarp();
  const int end = w.bitpos + total, full = end >> 5;
  for (int i = lane; i < full; i += 32) w.out[w.word + i] = s.stage[i];
  const uint32_t carry = s.stage[full];
  __syncwarp();
  for (int i = lane + 1; i <= full + 2 && i < kStage; i += 32) s.stage[i] = 0;
  if (lane == 0) s.stage[0] = carry;
  __syncwarp();
  w.word += full;
  w.bitpos = end & 31;
}

// bi_windup: to the next byte
__device__ void windup(Writer& w, WarpSmem& s, int lane) {
  put(w, s, 0, lane == 0 ? (8 - (w.bitpos & 7)) & 7 : 0, lane);
}

// the header items (lane 0 wrote them), 32 at a time
__device__ void put_items(Writer& w, WarpSmem& s, int lane) {
  __syncwarp();
  const int n = s.n_items;
  for (int i = 0; i < n; i += 32) {
    const uint32_t it = i + lane < n ? s.items[i + lane] : 0u;
    put(w, s, it & 0xFFFFFFu, int(it >> 24), lane);
  }
  __syncwarp();
}

__device__ __forceinline__ void item(WarpSmem& s, uint32_t v, int nb) {
  if (nb) s.items[s.n_items++] = v | uint32_t(nb) << 24;
}

// zlib's _tr_flush_block of the nsym symbols in syms, which cover
// payload[start, end); stored only where stored_ok (the block's bytes are
// still in zlib's window)
__device__ __noinline__ void flush_block(Writer& w, WarpSmem& s, const Static& st,
                                         const int32_t* syms, int nsym, const uint8_t* payload,
                                         int start, int end, bool last, bool stored_ok,
                                         int lane) {
  __syncwarp();
  int kind = 0;  // 0 stored, 1 fixed, 2 dynamic
  if (lane == 0) {
    int64_t opt = 0, stat = 0;
    s.lfreq[kEndBlock] = 1;
    const int lmax = build_tree(s.t, s.lfreq, kLCodes, st.llen, kExtraL, 257, 15, s.llen,
                                s.lcode, opt, stat);
    const int dmax = build_tree(s.t, s.dfreq, kDCodes, st.dlen, kExtraD, 0, 15, s.dlen,
                                s.dcode, opt, stat);
    for (int i = 0; i < kBlCodes; i++) s.blfreq[i] = 0;
    auto count = [&](int code, int, int) { s.blfreq[code]++; };
    tree_runs(s.llen, lmax, count);
    tree_runs(s.dlen, dmax, count);
    build_tree(s.t, s.blfreq, kBlCodes, nullptr, kExtraBl, 0, 7, s.bllen, s.blcode, opt, stat);
    int max_blindex = kBlCodes - 1;
    while (max_blindex >= 3 && s.bllen[kBlOrder[max_blindex]] == 0) max_blindex--;
    opt += 3 * (max_blindex + 1) + 5 + 5 + 4;
    int64_t opt_lenb = (opt + 3 + 7) >> 3;
    const int64_t static_lenb = (stat + 3 + 7) >> 3;
    if (static_lenb <= opt_lenb) opt_lenb = static_lenb;
    const int64_t stored_len = end - start;
    s.n_items = 0;
    if (stored_ok && stored_len + 4 <= opt_lenb) {
      kind = 0;
      item(s, last, 3);
    } else if (static_lenb == opt_lenb) {
      kind = 1;
      item(s, 2 + last, 3);
    } else {
      kind = 2;
      item(s, 4 + last, 3);
      item(s, lmax + 1 - 257, 5);
      item(s, dmax, 5);
      item(s, max_blindex + 1 - 4, 4);
      for (int r = 0; r <= max_blindex; r++) item(s, s.bllen[kBlOrder[r]], 3);
      auto send = [&](int code, int xbits, int xval) {
        item(s, s.blcode[code] | uint32_t(xval) << s.bllen[code], s.bllen[code] + xbits);
      };
      tree_runs(s.llen, lmax, send);
      tree_runs(s.dlen, dmax, send);
    }
  }
  kind = __shfl_sync(kFull, kind, 0);
  put_items(w, s, lane);
  if (kind == 0) {
    windup(w, s, lane);
    const uint32_t len = uint32_t(end - start);
    put(w, s, lane == 0 ? (len | (~len & 0xFFFFu) << 16) : 0, lane == 0 ? 32 : 0, lane);
    for (int i = start; i < end; i += 32)
      put(w, s, i + lane < end ? payload[i + lane] : 0, i + lane < end ? 8 : 0, lane);
  } else {
    const uint8_t* llen = kind == 1 ? st.llen : s.llen;
    const uint16_t* lcode = kind == 1 ? st.lcode : s.lcode;
    const uint8_t* dlen = kind == 1 ? st.dlen : s.dlen;
    const uint16_t* dcode = kind == 1 ? st.dcode : s.dcode;
    for (int i = 0; i <= nsym; i += 32) {
      uint64_t v = 0;
      int nb = 0;
      if (i + lane < nsym) {
        const uint32_t sym = uint32_t(syms[i + lane]);
        const int lc = int(sym & 0xFF), dist = int(sym >> 8);
        if (dist == 0) {
          v = lcode[lc];
          nb = llen[lc];
        } else {
          const int c = st.len_code[lc];
          v = lcode[c + 257];
          nb = llen[c + 257];
          if (kExtraL[c]) v |= uint64_t(lc - kBaseL[c]) << nb;  // 258 (code 285) has none
          nb += kExtraL[c];
          const int dc = d_code(st, dist - 1);
          v |= uint64_t(dcode[dc]) << nb;
          nb += dlen[dc];
          v |= uint64_t(dist - 1 - kBaseD[dc]) << nb;
          nb += kExtraD[dc];
        }
      } else if (i + lane == nsym) {
        v = lcode[kEndBlock];
        nb = llen[kEndBlock];
      }
      put(w, s, v, nb, lane);
    }
  }
  if (last) windup(w, s, lane);
  // init_block
  for (int i = lane; i < kLCodes; i += 32) s.lfreq[i] = 0;
  for (int i = lane; i < kDCodes; i += 32) s.dfreq[i] = 0;
  __syncwarp();
}

__device__ void refill(WarpSmem& s, const uint2* rec, const uint8_t* payload, int base, int n,
                       int lane) {
  __syncwarp();
  for (int i = lane; i < kWin; i += 32)
    if (base + i < n) s.win[i] = rec[base + i];
  for (int i = lane; i <= kWin; i += 32) {
    const int p = base - 1 + i;
    s.win_byte[i] = p >= 0 && p < n ? payload[p] : 0;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32)
emit_kernel(const uint8_t* __restrict__ data, int64_t n_total, const uint2* __restrict__ records,
            int32_t* __restrict__ sym_scratch, uint8_t* __restrict__ slots,
            int64_t* __restrict__ sizes) {
  __shared__ Static st;
  __shared__ WarpSmem smem[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  crc_table_fill(st.crc);
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    int c = 27;  // 255 (length 258) takes code 28 (285)
    while (c > 0 && kBaseL[c] > i) c--;
    st.len_code[i] = uint8_t(i == 255 ? 28 : c);
  }
  for (int i = threadIdx.x; i < 512; i += blockDim.x) {
    const int d = i < 256 ? i : (i - 256) << 7;
    int c = 29;
    while (kBaseD[c] > d) c--;
    st.dist_code[i] = uint8_t(c);
  }
  for (int i = threadIdx.x; i < 288; i += blockDim.x) {
    // the fixed code (RFC 1951 §3.2.6), bit-reversed
    const int len = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    const uint32_t code = i < 144 ? 0x30 + i : i < 256 ? 0x190 + (i - 144)
                        : i < 280 ? i - 256 : 0xC0 + (i - 280);
    st.llen[i] = uint8_t(len);
    st.lcode[i] = uint16_t(reverse(code, len));
  }
  for (int i = threadIdx.x; i < 32; i += blockDim.x) {
    st.dlen[i] = 5;
    st.dcode[i] = uint16_t(reverse(i, 5));
  }
  __syncthreads();
  const int64_t b = int64_t(blockIdx.x) * kWarps + warp;
  const int64_t n_blocks = (n_total + kBlock - 1) / kBlock;
  if (b >= n_blocks) return;
  WarpSmem& s = smem[warp];
  const uint8_t* payload = data + b * kBlock;
  const int n = int(n_total - b * kBlock < kBlock ? n_total - b * kBlock : kBlock);
  const uint2* rec = records + b * kBlock;
  int32_t* syms = sym_scratch + b * (kSymMax + 1);
  uint8_t* slot = slots + b * kMemberMax;
  for (int i = lane; i < kStage; i += 32) s.stage[i] = 0;
  for (int i = lane; i < kLCodes; i += 32) s.lfreq[i] = 0;
  for (int i = lane; i < kDCodes; i += 32) s.dfreq[i] = 0;
  __syncwarp();
  Writer w{reinterpret_cast<uint32_t*>(slot), 4, 16};  // the stream starts at byte 18

  // zlib's deflate_slow, every lane on the same values
  int strstart = 0, block_start = 0, nsym = 0, base = -kWin;
  int match_length = kMinMatch - 1, match_start = 0;
  bool available = false;
  while (strstart < n) {
    // once a step starts at kSlideAt or past it, zlib has slid its window,
    // and a block that started below kWSize is not stored
    const bool stored_ok = strstart < kSlideAt || block_start >= kWSize;
    if (strstart - base >= kWin) {
      base = strstart;
      refill(s, rec, payload, base, n, lane);
    }
    const uint2 r = s.win[strstart - base];
    const int prev_length = match_length, prev_match = match_start;
    match_length = kMinMatch - 1;
    const uint32_t rc = prev_length >= kGood ? r.y : r.x;
    if (rc != 0 && prev_length < kLazy && int(rc & 511) > prev_length) {
      match_length = int(rc & 511);
      match_start = strstart - int(rc >> 9);
      if (match_length == kMinMatch && strstart - match_start > kTooFar)
        match_length = kMinMatch - 1;
    }
    bool flush = false;
    if (prev_length >= kMinMatch && match_length <= prev_length) {
      const int dist = strstart - 1 - prev_match, lc = prev_length - kMinMatch;
      if (lane == 0) {
        syms[nsym] = lc | dist << 8;
        s.lfreq[st.len_code[lc] + 257]++;
        s.dfreq[d_code(st, dist - 1)]++;
      }
      nsym++;
      strstart += prev_length - 1;
      available = false;
      match_length = kMinMatch - 1;
      flush = nsym == kSymMax;
    } else if (available) {
      const int lit = s.win_byte[strstart - base];
      if (lane == 0) {
        syms[nsym] = lit;
        s.lfreq[lit]++;
      }
      nsym++;
      flush = nsym == kSymMax;
      if (flush) {
        flush_block(w, s, st, syms, nsym, payload, block_start, strstart, false, stored_ok,
                    lane);
        block_start = strstart;
        nsym = 0;
        flush = false;
      }
      strstart++;
    } else {
      available = true;
      strstart++;
    }
    if (flush) {
      flush_block(w, s, st, syms, nsym, payload, block_start, strstart, false, stored_ok, lane);
      block_start = strstart;
      nsym = 0;
    }
  }
  if (available) {
    const int lit = payload[strstart - 1];
    if (lane == 0) {
      syms[nsym] = lit;
      s.lfreq[lit]++;
    }
    nsym++;
  }
  flush_block(w, s, st, syms, nsym, payload, block_start, strstart, true,
              strstart < kSlideAt || block_start >= kWSize, lane);
  // the last partial word, then the header and trailer bytes around the stream
  if (lane == 0 && w.bitpos) w.out[w.word] = s.stage[0];
  const int stream_end = w.word * 4 + w.bitpos / 8;  // bytes of the slot so far
  const uint32_t crc = crc_warp(payload, n, st.crc, lane);
  __syncwarp();
  if (lane == 0) {
    const int size = stream_end + 8;
    const uint8_t header[16] = {0x1F, 0x8B, 8, 4, 0, 0, 0, 0, 0, 0xFF, 6, 0, 0x42, 0x43, 2, 0};
    for (int i = 0; i < 16; i++) slot[i] = header[i];
    slot[16] = uint8_t((size - 1) & 0xFF);
    slot[17] = uint8_t((size - 1) >> 8);
    for (int i = 0; i < 4; i++) {
      slot[stream_end + i] = uint8_t(crc >> (8 * i));
      slot[stream_end + 4 + i] = uint8_t(uint32_t(n) >> (8 * i));
    }
    sizes[b] = size;
  }
}

// member b from its slot to the sum of the sizes before it
__global__ void __launch_bounds__(256)
pack_kernel(const uint8_t* __restrict__ slots, const int64_t* __restrict__ sizes,
            int64_t n_blocks, uint8_t* __restrict__ out) {
  __shared__ int64_t part[256];
  const int64_t b = blockIdx.x;
  int64_t sum = 0;
  for (int64_t i = threadIdx.x; i < b; i += 256) sum += sizes[i];
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int d = 128; d > 0; d >>= 1) {
    if (threadIdx.x < d) part[threadIdx.x] += part[threadIdx.x + d];
    __syncthreads();
  }
  const int64_t at = part[0], size = sizes[b];
  const uint8_t* src = slots + b * kMemberMax;
  for (int64_t i = threadIdx.x; i < size; i += 256) out[at + i] = src[i];
}

}  // namespace

// data holds n bytes: blocks of 65,280, the last one shorter or whole.
// records: n uint2; syms: 16,384 int32 a block; slots: 65,536 bytes a block;
// sizes: int64 a block; out: the packed members (at most 65,536 a block).
extern "C" int pykmer_deflate_bgzf(const uint8_t* data, int64_t n, uint2* records,
                                   int32_t* syms, uint8_t* slots, int64_t* sizes,
                                   uint8_t* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  cudaError_t err = cudaFuncSetAttribute(match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMatchSmem);
  if (err != cudaSuccess) return int(err);
  match_kernel<<<unsigned(blocks), kMatchThreads, kMatchSmem, stream>>>(data, n, records);
  emit_kernel<<<unsigned((blocks + kWarps - 1) / kWarps), kWarps * 32, 0, stream>>>(
      data, n, records, syms, slots, sizes);
  pack_kernel<<<unsigned(blocks), 256, 0, stream>>>(slots, sizes, blocks, out);
  return int(cudaGetLastError());
}
