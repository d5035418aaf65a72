// FASTA decode on the card: one record-aligned segment of raw FASTA bytes to
// the packed upload planes that the encode kernel reads.
//
// The host counterpart is the native decoder of io/native.py
// (fasta_decode_joined_packed_native, native/pykmer_native.cpp:1377); the
// planes written here are bit-identical to its planes, and the record table
// to its record list. Semantics, the serial decoder's (:1083):
//
// - lines end at '\n'; each is stripped of leading and trailing space, '\t',
//   '\r', VT and FF;
// - a line whose first kept byte is '>' is a header: a new record, named by
//   the rest of the stripped line; text before the first header is dropped;
// - every other kept byte of a line goes through the A/C/G/T table (either
//   case) to codes 0..3, any other byte to the invalid code 4;
// - the records' codes are joined with K-1 invalid codes between records;
//   base p of the joined stream is bits [2(p%4), 2(p%4)+2) of bases[p/4],
//   its validity bit p%8 of mask[p/8]; an invalid code is 0 in both planes,
//   so the planes start zeroed and only valid codes set bits;
// - a record's seq_len counts its kept bytes, has_valid is set where it
//   holds a run of K valid codes.
//
// Design: 256 bytes a thread, 256 threads a block. Whether a byte is kept
// depends on its line, which may start bytes or megabytes earlier and whose
// trailing spaces are dropped only if no other byte follows before the
// '\n'. Both are carried between threads by scans:
//
// - forward: the state at a byte is 3 bits (a non-space byte of the line
//   seen; the line is a header; a header line came before the line). A
//   thread's 256 bytes map each of the 8 states at its start to one at its
//   end: a table of 8 x 3 bits, which compose. A scan of the tables gives
//   each thread its state at its start.
// - backward: whether a non-space byte follows in the line after a thread's
//   last byte. A thread maps that bit at its end to the bit at its start as
//   a | (c & bit); these compose too, scanned from the right.
//
// Passes, all on the caller's stream: (1) each thread summarises its bytes
// (the two maps), each block composes its threads'; (2) one block scans the
// block maps; (3) each thread rescans its block with the block's carries,
// decodes its bytes with the state it starts in, and counts kept bytes,
// headers and '>' bytes; (4) one block scans the counts. The caller reads
// the totals (the one wait of a segment), sizes the planes and the record
// table, and launches (5): each thread decodes its bytes again and writes
// the bits of its valid codes into the zeroed planes, a 32-bit word at a
// time (a plain store where the word's codes are all the thread's, atomicOr
// for the first and last words, which it shares with its neighbours), and
// its records' name offsets and code starts; and (6) each thread takes 32
// window starts of the validity plane and marks the record of each window
// whose K bits are all set. A record's seq_len is the distance to the next
// record's code start less the separator (the caller's subtraction), so no
// thread adds to a count that thousands of others add to.
//
// Bound on the H100 (memory): the raw bytes read twice and the planes (3/8
// of a byte a code) written once; for a 192 MiB segment 0.12 ms at 3.35 TB/s.
//
// Launchers take device pointers, sizes and the stream, launch on the
// caller's stream, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;    // bytes a thread decodes
constexpr int kThreads = 256;  // threads a block of the byte passes
constexpr int64_t kTile = (int64_t)kChunk * kThreads;  // bytes a block
constexpr int kScanThreads = 1024;  // the one block of the scans of blocks
constexpr int kMaxK = 31;

// forward state bits: kSeen, a non-space byte of the current line seen;
// kHeader, the line is a header; bit 2, a header line came before the line
constexpr uint32_t kSeen = 1;
constexpr uint32_t kHeader = 2;

__host__ __device__ constexpr uint32_t identity_map() {
  uint32_t f = 0;
  for (uint32_t s = 0; s < 8; s++) f |= s << (3 * s);
  return f;
}
constexpr uint32_t kIdentity = identity_map();
constexpr uint32_t kBackIdentity = 2;  // a = 0, c = 1: the bit passes through

__device__ __forceinline__ uint32_t apply(uint32_t f, uint32_t s) { return (f >> (3 * s)) & 7; }

// the map of ``left`` followed by ``right``
struct Forward {
  __device__ uint32_t operator()(uint32_t left, uint32_t right) const {
    uint32_t h = 0;
#pragma unroll
    for (uint32_t s = 0; s < 8; s++) h |= apply(right, apply(left, s)) << (3 * s);
    return h;
  }
};

// backward maps as bits (a, c): bit_at_start = a | (c & bit_at_end)
struct Backward {
  __device__ uint32_t operator()(uint32_t left, uint32_t right) const {
    const uint32_t a = (left & 1) | ((left >> 1) & right & 1);
    return a | (left & right & 2);
  }
};

struct Sum {
  template <typename T>
  __device__ T operator()(T left, T right) const { return left + right; }
};

// inclusive scan of one value a thread over the block in positional order
// (``reverse``: each thread gets its value combined with those to its right);
// ``op(left, right)`` combines neighbours in that order. Leaves the
// inclusive values in ``sh`` and returns the thread's.
template <typename T, typename Op>
__device__ T block_scan(T v, T* sh, Op op, bool reverse) {
  const int t = threadIdx.x, n = blockDim.x;
  sh[t] = v;
  __syncthreads();
  for (int off = 1; off < n; off <<= 1) {
    const int j = reverse ? t + off : t - off;
    const bool has = reverse ? j < n : j >= 0;
    const T y = has ? sh[j] : v;
    __syncthreads();
    if (has) {
      v = reverse ? op(v, y) : op(y, v);
      sh[t] = v;
    }
    __syncthreads();
  }
  return v;
}

// the exclusive value of the scan ``block_scan`` left in ``sh``
template <typename T>
__device__ T exclusive(const T* sh, T identity, bool reverse) {
  const int t = threadIdx.x;
  if (reverse) return t + 1 < (int)blockDim.x ? sh[t + 1] : identity;
  return t > 0 ? sh[t - 1] : identity;
}

__device__ __forceinline__ bool is_space(uint32_t c) {
  return c == ' ' || (c >= 9 && c <= 13 && c != '\n');  // \t \v \f \r
}

__device__ __forceinline__ uint32_t base_code(uint32_t c) {
  const uint32_t u = c & 0xDF;  // upper case; only 'a'..'z' move
  return u == 'A' ? 0 : u == 'C' ? 1 : u == 'G' ? 2 : u == 'T' ? 3 : 4;
}

// calls fn(byte, global index) for each byte of thread chunk ``t``: 16-byte
// loads where the chunk is whole and aligned, byte loads otherwise
template <typename Fn>
__device__ __forceinline__ void for_each_byte(const uint8_t* __restrict__ raw, int64_t n,
                                              int64_t t, Fn&& fn) {
  const int64_t base = t * kChunk;
  const int64_t len = n - base < kChunk ? n - base : kChunk;
  const uint8_t* p = raw + base;
  if (len == kChunk && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll 1
    for (int v = 0; v < kChunk / 16; v++) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + v);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 16; i++) fn((w[i / 4] >> (8 * (i % 4))) & 0xFF, base + 16 * v + i);
    }
  } else {
    for (int64_t i = 0; i < len; i++) fn((uint32_t)p[i], base + i);
  }
}

// where pass (3) and pass (5) keep what they find
struct Workspace {
  uint32_t* fwd;       // [chunks] the forward map of each thread's bytes
  uint8_t* back;       // [chunks] its backward map
  uint8_t* carry;      // [chunks] the state it starts in | next-byte bit << 3
  uint16_t* kept;      // [chunks] kept bytes
  uint16_t* headers;   // [chunks] header lines starting in it
  uint32_t* blk_fwd;   // [blocks] a block's forward map, then its start state
  uint32_t* blk_back;  // [blocks] a block's backward map, then its end bit
  unsigned long long* blk_kept;     // [blocks] sums, then exclusive offsets
  unsigned long long* blk_headers;  // [blocks]
  unsigned long long* blk_gt;       // [blocks]
};

__host__ __device__ int64_t chunks_of(int64_t n) { return (n + kChunk - 1) / kChunk; }
__host__ __device__ int64_t blocks_of(int64_t n) { return (n + kTile - 1) / kTile; }
int64_t align16(int64_t x) { return (x + 15) & ~(int64_t)15; }

Workspace carve(void* ws, int64_t n) {
  const int64_t c = chunks_of(n), b = blocks_of(n);
  uint8_t* p = static_cast<uint8_t*>(ws);
  Workspace w;
  auto take = [&](int64_t bytes) {
    uint8_t* at = p;
    p += (bytes + 15) & ~(int64_t)15;
    return at;
  };
  w.fwd = reinterpret_cast<uint32_t*>(take(4 * c));
  w.back = take(c);
  w.carry = take(c);
  w.kept = reinterpret_cast<uint16_t*>(take(2 * c));
  w.headers = reinterpret_cast<uint16_t*>(take(2 * c));
  w.blk_fwd = reinterpret_cast<uint32_t*>(take(4 * b));
  w.blk_back = reinterpret_cast<uint32_t*>(take(4 * b));
  w.blk_kept = reinterpret_cast<unsigned long long*>(take(8 * b));
  w.blk_headers = reinterpret_cast<unsigned long long*>(take(8 * b));
  w.blk_gt = reinterpret_cast<unsigned long long*>(take(8 * b));
  return w;
}

int64_t workspace_bytes(int64_t n) {
  const int64_t c = chunks_of(n), b = blocks_of(n);
  return align16(4 * c) + 2 * align16(c) + 2 * align16(2 * c) + 2 * align16(4 * b)
         + 3 * align16(8 * b);
}

// (1) each thread's maps; each block's composition of them
__global__ void __launch_bounds__(kThreads)
summarise_kernel(const uint8_t* __restrict__ raw, int64_t n, Workspace w) {
  __shared__ uint32_t sh[kThreads];
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  uint32_t fwd = kIdentity, back = kBackIdentity;
  if (t * kChunk < n) {
    // before the chunk's first '\n': the class of its first non-space byte
    // (0 none, 1 '>', 2 other); after it, the lines as they start here
    bool newline = false;
    uint32_t first = 0, seen = 0, header = 0, after = 0;
    for_each_byte(raw, n, t, [&](uint32_t c, int64_t) {
      if (c == '\n') {
        if (newline) after |= header;
        newline = true;
        seen = header = 0;
      } else if (!is_space(c)) {
        if (!newline) {
          if (first == 0) first = c == '>' ? 1 : 2;
        } else if (!seen) {
          seen = 1;
          header = c == '>';
        }
      }
    });
    fwd = 0;
    for (uint32_t s = 0; s < 8; s++) {
      const uint32_t s_seen = s & kSeen, s_header = (s & kHeader) >> 1, s_after = s >> 2;
      const uint32_t line_header = s_seen ? s_header : (first == 1);
      uint32_t out;
      if (!newline) {
        out = (s_seen | (first != 0)) | (line_header << 1) | (s_after << 2);
      } else {
        out = seen | (header << 1) | ((s_after | line_header | after) << 2);
      }
      fwd |= out << (3 * s);
    }
    back = first != 0 ? 1u : (newline ? 0u : 2u);
    w.fwd[t] = fwd;
    w.back[t] = (uint8_t)back;
  }
  const uint32_t f = block_scan(fwd, sh, Forward(), false);
  if (threadIdx.x == kThreads - 1) w.blk_fwd[blockIdx.x] = f;
  __syncthreads();
  const uint32_t b = block_scan(back, sh, Backward(), true);
  if (threadIdx.x == 0) w.blk_back[blockIdx.x] = b;
}

// (2) and (4): one block walks the blocks' values in tiles with a carry
template <typename T, typename Op>
__device__ T tile_scan(T v, T* sh, Op op, bool reverse, T& carry, T identity) {
  block_scan(v, sh, op, reverse);
  const T excl = exclusive(sh, identity, reverse);
  const T total = reverse ? sh[0] : sh[blockDim.x - 1];
  __syncthreads();
  const T mine = reverse ? op(excl, carry) : op(carry, excl);
  carry = reverse ? op(total, carry) : op(carry, total);
  return mine;
}

__global__ void __launch_bounds__(kScanThreads)
scan_maps_kernel(int64_t blocks, Workspace w) {
  __shared__ uint32_t sh[kScanThreads];
  // forward from the segment's start (no line seen, no header before)
  uint32_t carry = kIdentity;
  for (int64_t lo = 0; lo < blocks; lo += kScanThreads) {
    const int64_t i = lo + threadIdx.x;
    const uint32_t v = i < blocks ? w.blk_fwd[i] : kIdentity;
    const uint32_t before = tile_scan(v, sh, Forward(), false, carry, kIdentity);
    if (i < blocks) w.blk_fwd[i] = apply(before, 0);
  }
  // backward from the segment's end, where every line ends
  uint32_t bcarry = kBackIdentity;
  const int64_t tiles = (blocks + kScanThreads - 1) / kScanThreads;
  for (int64_t tile = tiles - 1; tile >= 0; tile--) {
    const int64_t i = tile * kScanThreads + threadIdx.x;
    const uint32_t v = i < blocks ? w.blk_back[i] : kBackIdentity;
    const uint32_t after = tile_scan(v, sh, Backward(), true, bcarry, kBackIdentity);
    if (i < blocks) w.blk_back[i] = after & 1;  // a, since the end bit is 0
  }
}

// The decode of one thread's bytes from the state it starts in. kWrite false
// counts; true writes the planes and the record table.
struct Tables {
  uint32_t* bases;  // 32-bit words of the planes
  uint32_t* mask;
  unsigned long long* name_off;
  unsigned long long* name_end;
  unsigned long long* rec_start;
};

// Write mode: the thread's codes and separators are [pos, pos_end) of the
// joined stream; a word inside that range is its alone.
template <bool kWrite>
__device__ void decode_chunk(const uint8_t* __restrict__ raw, int64_t n, int64_t t, int k,
                             uint32_t start, bool next_byte, int64_t pos, int64_t pos_end,
                             int64_t rec, const Tables& tb, uint32_t& kept,
                             uint32_t& headers, uint32_t& gt) {
  uint32_t seen = start & kSeen, header = (start & kHeader) >> 1, after = start >> 2;
  uint32_t pend = 0;  // spaces after a kept byte, kept if another follows in the line
  int64_t name_end = -1;
  const int64_t pos0 = pos;
  int64_t word_b = -1, word_m = -1;
  uint32_t acc_b = 0, acc_m = 0;
  // each word is flushed once: the positions only grow
  auto flush_bases = [&]() {
    if (acc_b) {
      if (16 * word_b >= pos0 && 16 * word_b + 16 <= pos_end) tb.bases[word_b] = acc_b;
      else atomicOr(tb.bases + word_b, acc_b);
    }
    acc_b = 0;
  };
  auto flush_mask = [&]() {
    if (acc_m) {
      if (32 * word_m >= pos0 && 32 * word_m + 32 <= pos_end) tb.mask[word_m] = acc_m;
      else atomicOr(tb.mask + word_m, acc_m);
    }
    acc_m = 0;
  };
  auto flush_name = [&]() {
    if (rec >= 0 && name_end >= 0)
      atomicMax(tb.name_end + rec, (unsigned long long)name_end);
    name_end = -1;
  };
  for_each_byte(raw, n, t, [&](uint32_t c, int64_t g) {
    gt += c == '>';
    if (c == '\n') {
      after |= header;
      seen = header = 0;
      pend = 0;
      return;
    }
    if (is_space(c)) {
      pend += seen & (header ^ 1) & after;
      return;
    }
    if (!seen) {
      seen = 1;
      header = c == '>';
      if (header) {
        headers++;
        if (kWrite) {
          flush_name();
          if (rec >= 0) pos += k - 1;  // the separator before every record but the first
          rec++;
          tb.name_off[rec] = (unsigned long long)(g + 1);
          tb.rec_start[rec] = (unsigned long long)pos;
          name_end = g + 1;
        }
        return;
      }
    } else if (header) {
      if (kWrite) name_end = g + 1;
      return;
    }
    if (!after) return;  // text before the first header
    kept += pend + 1;
    if (kWrite) {
      pos += pend;
      const uint32_t code = base_code(c);
      if (code < 4) {
        if (pos >> 4 != word_b) {
          flush_bases();
          word_b = pos >> 4;
        }
        if (pos >> 5 != word_m) {
          flush_mask();
          word_m = pos >> 5;
        }
        acc_b |= code << (2 * (pos & 15));
        acc_m |= 1u << (pos & 31);
      }
      pos++;
    }
    pend = 0;
  });
  if (next_byte) kept += pend;
  if (kWrite) {
    flush_bases();
    flush_mask();
    flush_name();
  }
}

// (3) each thread's start state and next-byte bit; the counts
__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ raw, int64_t n, int k, Workspace w) {
  __shared__ uint32_t sh[kThreads];
  __shared__ unsigned long long sh64[kThreads];
  const int64_t chunks = chunks_of(n);
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = t < chunks;
  block_scan(live ? w.fwd[t] : kIdentity, sh, Forward(), false);
  const uint32_t before = exclusive(sh, kIdentity, false);
  __syncthreads();
  block_scan(live ? (uint32_t)w.back[t] : kBackIdentity, sh, Backward(), true);
  const uint32_t right = exclusive(sh, kBackIdentity, true);
  __syncthreads();
  // the block's start state and the bit after its last byte, from pass (2)
  const uint32_t start = apply(before, w.blk_fwd[blockIdx.x]);
  const bool next_byte = (right & 1) | ((right >> 1) & w.blk_back[blockIdx.x]);
  uint32_t kept = 0, headers = 0, gt = 0;
  if (live) {
    const Tables none{};
    decode_chunk<false>(raw, n, t, k, start, next_byte, 0, 0, -1, none, kept, headers, gt);
    w.carry[t] = (uint8_t)(start | (next_byte ? 8u : 0u));
    w.kept[t] = (uint16_t)kept;
    w.headers[t] = (uint16_t)headers;
  }
  Sum sum;
  unsigned long long s = block_scan((unsigned long long)kept, sh64, sum, false);
  if (threadIdx.x == kThreads - 1) w.blk_kept[blockIdx.x] = s;
  __syncthreads();
  s = block_scan((unsigned long long)headers, sh64, sum, false);
  if (threadIdx.x == kThreads - 1) w.blk_headers[blockIdx.x] = s;
  __syncthreads();
  s = block_scan((unsigned long long)gt, sh64, sum, false);
  if (threadIdx.x == kThreads - 1) w.blk_gt[blockIdx.x] = s;
}

// (4) the blocks' offsets and the totals (kept bytes, headers, '>' bytes)
__global__ void __launch_bounds__(kScanThreads)
scan_counts_kernel(int64_t blocks, Workspace w, unsigned long long* totals) {
  __shared__ unsigned long long sh[kScanThreads];
  unsigned long long* cols[3] = {w.blk_kept, w.blk_headers, w.blk_gt};
  for (int col = 0; col < 3; col++) {
    unsigned long long carry = 0;
    for (int64_t lo = 0; lo < blocks; lo += kScanThreads) {
      const int64_t i = lo + threadIdx.x;
      const unsigned long long v = i < blocks ? cols[col][i] : 0ull;
      const unsigned long long before = tile_scan(v, sh, Sum(), false, carry, 0ull);
      if (i < blocks) cols[col][i] = before;
    }
    if (threadIdx.x == 0) totals[col] = carry;
  }
}

// (5) the planes and the record table
__global__ void __launch_bounds__(kThreads)
write_kernel(const uint8_t* __restrict__ raw, int64_t n, int k, Workspace w, Tables tb) {
  __shared__ uint32_t sh[kThreads];
  const int64_t chunks = chunks_of(n);
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = t < chunks;
  block_scan(live ? (uint32_t)w.kept[t] : 0u, sh, Sum(), false);
  const uint32_t kept_before = exclusive(sh, 0u, false);
  __syncthreads();
  block_scan(live ? (uint32_t)w.headers[t] : 0u, sh, Sum(), false);
  const uint32_t headers_before = exclusive(sh, 0u, false);
  if (!live) return;
  const int64_t kept0 = (int64_t)w.blk_kept[blockIdx.x] + kept_before;
  const int64_t h0 = (int64_t)w.blk_headers[blockIdx.x] + headers_before;
  const int64_t pos = kept0 + (int64_t)(k - 1) * (h0 > 0 ? h0 - 1 : 0);
  // its separators: one a header of its own, but for the first record's
  const int64_t mine = w.headers[t], seps = h0 == 0 && mine > 0 ? mine - 1 : mine;
  const int64_t pos_end = pos + w.kept[t] + (int64_t)(k - 1) * seps;
  const uint32_t carry = w.carry[t];
  uint32_t kept = 0, headers = 0, gt = 0;
  decode_chunk<true>(raw, n, t, k, carry & 7, (carry >> 3) & 1, pos, pos_end, h0 - 1, tb,
                     kept, headers, gt);
}

// (6) has_valid: 32 window starts a thread; a window is valid where its K
// validity bits are all set (bits past the stream are 0)
__global__ void __launch_bounds__(kThreads)
valid_kernel(const uint8_t* __restrict__ mask, int64_t mask_bytes, int64_t n_codes, int k,
             const unsigned long long* __restrict__ rec_start, int64_t n_recs,
             uint8_t* __restrict__ has_valid) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t p0 = 32 * g;
  if (p0 >= n_codes) return;
  uint64_t bits = 0;
  for (int i = 0; i < 8; i++) {
    const int64_t at = 4 * g + i;
    if (at < mask_bytes) bits |= (uint64_t)mask[at] << (8 * i);
  }
  uint64_t run = bits;
  for (int i = 1; i < k; i++) run &= bits >> i;
  uint32_t v = (uint32_t)run;
  while (v) {
    const int64_t p = p0 + __ffs(v) - 1;
    // the last record starting at or before p
    int64_t lo = 0, hi = n_recs;
    while (hi - lo > 1) {
      const int64_t mid = (lo + hi) / 2;
      if ((int64_t)rec_start[mid] <= p) lo = mid; else hi = mid;
    }
    has_valid[lo] = 1;
    if (lo + 1 >= n_recs) break;
    const int64_t next = (int64_t)rec_start[lo + 1] - p0;  // > p - p0
    if (next >= 32) break;
    v &= ~((1u << next) - 1);
  }
}

}  // namespace

// bytes of the workspace a segment of n raw bytes needs
extern "C" int64_t pykmer_fasta_workspace(int64_t n) { return workspace_bytes(n); }

// passes (1)-(4) over raw[0, n): totals[0..2] = kept bytes, headers and '>'
// bytes (totals on the card)
extern "C" int pykmer_fasta_scan(const void* raw, int64_t n, int64_t k, void* ws,
                                 void* totals, void* stream) {
  if (k < 1 || k > kMaxK || n < 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = blocks_of(n);
  if (blocks == 0) return (int)cudaMemsetAsync(totals, 0, 24, (cudaStream_t)stream);
  const cudaStream_t s = (cudaStream_t)stream;
  const Workspace w = carve(ws, n);
  summarise_kernel<<<(unsigned)blocks, kThreads, 0, s>>>((const uint8_t*)raw, n, w);
  scan_maps_kernel<<<1, kScanThreads, 0, s>>>(blocks, w);
  count_kernel<<<(unsigned)blocks, kThreads, 0, s>>>((const uint8_t*)raw, n, (int)k, w);
  scan_counts_kernel<<<1, kScanThreads, 0, s>>>(blocks, w, (unsigned long long*)totals);
  return (int)cudaGetLastError();
}

// passes (5)-(6): the zeroed planes (bases_bytes, mask_bytes long, each at
// least 4 * ceil(n_codes / 16) and 4 * ceil(n_codes / 32) bytes) and the
// record table of the n_recs records: name offsets, name ends (zeroed), code
// starts and has_valid (zeroed)
extern "C" int pykmer_fasta_write(const void* raw, int64_t n, int64_t k, void* ws,
                                  void* bases, int64_t bases_bytes, void* mask,
                                  int64_t mask_bytes, int64_t n_codes, int64_t n_recs,
                                  void* name_off, void* name_end, void* rec_start,
                                  void* has_valid, void* stream) {
  if (k < 1 || k > kMaxK || n < 0 || n_codes < 0 || n_recs < 0)
    return (int)cudaErrorInvalidValue;
  if (bases_bytes < 4 * ((n_codes + 15) / 16) || mask_bytes < 4 * ((n_codes + 31) / 32)
      || ((reinterpret_cast<uintptr_t>(bases) | reinterpret_cast<uintptr_t>(mask)) & 3))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = blocks_of(n);
  if (blocks == 0 || n_recs == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const Tables tb{(uint32_t*)bases, (uint32_t*)mask, (unsigned long long*)name_off,
                  (unsigned long long*)name_end, (unsigned long long*)rec_start};
  write_kernel<<<(unsigned)blocks, kThreads, 0, s>>>((const uint8_t*)raw, n, (int)k,
                                                     carve(ws, n), tb);
  const int64_t groups = (n_codes + 31) / 32;
  if (groups > 0)
    valid_kernel<<<(unsigned)((groups + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        (const uint8_t*)mask, mask_bytes, n_codes, (int)k,
        (const unsigned long long*)rec_start, n_recs, (uint8_t*)has_valid);
  return (int)cudaGetLastError();
}
