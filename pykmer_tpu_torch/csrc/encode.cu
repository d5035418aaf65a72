// Canonical k-mer codes of a chunk, 2048 windows a block, 16 a thread.
//
// Replaces the JAX package's encoders, which are plain jnp programs that XLA
// fuses on the TPU: pykmer_tpu/ops/encode.py::canonical_codes_packed (:154,
// the bit-field encoder of program A for all-valid chunks at K <= 15) and
// ::canonical_codes (:69, the K-slice encoder, with fold_codes on the main
// path). Two entries, each for int32 codes (K <= 15) and int64 codes
// (K = 16..31, following ops/encode.code_dtype):
//
// - packed: folded canonical codes min(c, 4^K - 1 - c), c = min(fwd, rev),
//   straight from the upload planes as host/chunks.pack_base_stream lays
//   them out: base 4j+i is bits [2i, 2i+2) of bases2[j], the validity of
//   base 8j+i is bit i of maskbits[j] (maskbits NULL: an all-valid chunk).
//   A window with any validity bit 0 gets the folded sentinel 4^K / 2.
//   With a counter (count not NULL) the kernel also adds to it the number of
//   valid windows (JAX program A's nvalid), so no second pass re-reads the
//   codes to count them.
// - bases: unfolded canonical codes from a uint8 base-code chunk (0..3
//   valid, >= 4 invalid); an invalid window gets the sentinel 4^K.
//
// Bound on the H100 (memory): the input read once and the codes written
// once. At the K=15 shape (2^24 windows) the packed entry moves 4.2 MB of
// bases, 2.1 MB of mask and 67.1 MB of int32 codes, 0.022 ms at 3.35 TB/s;
// at K=17, 134.2 MB of int64 codes, 0.042 ms; the bases entry reads a byte
// a base. To stream at that rate a window may cost only a handful of integer
// instructions: with 64-bit window arithmetic (two funnel shifts, a 64-bit
// bit reversal and pair swap, a variable 64-bit shift, 64-bit min and fold)
// the int32 codes took ~0.057 ms, 0.39 of the bound (PERF.md).
//
// Layout. Every block stages the bytes its 2048 windows cover, plus 64 bases
// of reach, in shared memory: 16-byte vector loads where a plane is 16-byte
// aligned, guarded byte loads otherwise and at the planes' ends (they are
// not padded; bytes past an end read as 0 and only reach windows that are
// not written). The planes are read as little-endian bit streams: base p
// sits at bits [2p, 2p+2), so a window's 2K bits, read as a little-endian
// word v, hold base i+p at weight 4^p, and the reverse complement is ~v &
// (4^K - 1) directly. The bases entry packs its bytes into that layout in
// registers: each thread loads 16 bases as one vector and builds their 2-bit
// word (x & 0x03030303, one multiply a 4 bytes, a byte gather) and their 16
// validity bits (__vcmpltu4, one multiply a 4 bytes); pairs of lanes join
// their validity bits into a 32-bit word with one shuffle.
//
// The 32-bit path (K <= 15: the int32 codes of both entries). A window's
// 2K <= 30 bits fit one 32-bit word. Each thread encodes groups of 4
// consecutive windows j..j+3 (j a multiple of 4): their reverse complements
// are funnel shifts of the same two staged words at offsets 2j % 32 + 2q <=
// 30. The forward codes come from a second stream, built once a block: the
// staged bases in reverse order with each 2-bit group kept (__brev and one
// pair swap a 16 bases, not a window), shifted by d = (K + 3) % 4 bases so
// that the four windows' forward codes also start at a multiple of 8 bits
// within one pair of words; a window's forward code is one funnel shift of
// that stream at group L - j - K (L its length in bases). After the shifts
// everything is uint32: complement, mask, min, fold, validity (one funnel
// shift of the mask stream a group, one AND-NOT a window) and the sentinel,
// about 17 SASS instructions a window on a masked chunk. The four codes go
// out as one 16-byte store, so a warp writes 512 contiguous bytes. The count
// is the valid flags summed a thread, a warp reduction, a block sum in
// shared memory and one 64-bit atomic add a block. 128 threads of 4 groups
// (16 windows) took 0.031-0.032 ms at the K=15 masked shape, 256 threads of
// 2 groups 0.037 ms: the per-thread set-up and the staging latency are
// shared by more windows (PERF.md).
//
// The 64-bit path (K >= 16: int64 codes) keeps the first design's window
// arithmetic, which runs at 0.7-0.8 of its byte bound: each thread encodes
// 16 windows 128 apart (every store of a warp writes neighbouring
// addresses); a window starts at an even bit offset of up to 30 within a
// staged word, two funnel shifts over three words give the 64 bits that
// hold its 2K <= 62 bits, and the forward code is the 2-bit-group reversal
// of that word shifted down by 64 - 2K. The design this file replaced
// (64-bit arithmetic at every K, byte staging, 256 threads of 8 windows, the
// bases entry repacked from shared memory by a serial loop) is kept in
// scripts/encode_variants.cu and timed against this one by
// scripts/bench_encode_variants.py.
//
// Launchers take device pointers, sizes and the stream, launch on the
// caller's stream, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 16;  // windows a thread encodes
constexpr int kWindows = kThreads * kPerThread;  // windows per block
constexpr int kGroups = kPerThread / 4;  // 32-bit path: groups of 4 consecutive windows
constexpr int kMaxK = 31;  // 2K bits in one 64-bit word, 4^K in int64
// staged words a block: its windows' 2-bit bases (16 a word) and validity
// bits (32 a word), each with 64 bases of reach for the last window, in
// whole 16-byte units
constexpr int kBaseWords = kWindows / 16 + 4;
constexpr int kMaskWords = kWindows / 32 + 4;
// the reversed stream: words [0, kRevWords] of the staged bases, reversed,
// in kRevWords + 1 words
constexpr int kRevWords = kBaseWords - 1;
// the bases entry packs a word a thread in whole warps (pairs of lanes join
// their validity bits)
constexpr int kBaseSlots = (kBaseWords + 31) / 32 * 32;
static_assert(kBaseWords % 4 == 0 && kMaskWords % 4 == 0, "16-byte units");
static_assert(16 * kRevWords >= kWindows + kMaxK + 3, "the reach of the last window");
static_assert(kBaseSlots / 2 >= kMaskWords, "every validity word written");

// 16 bytes of src (src_len bytes long) from byte g, zero past its end: one
// vector load where src is 16-byte aligned (g is a multiple of 16) and the
// unit lies inside it, guarded byte loads otherwise
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ src, int64_t g,
                                        int64_t src_len, bool aligned) {
  if (aligned && g + 16 <= src_len) return __ldg(reinterpret_cast<const uint4*>(src + g));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (g + i < src_len) w[i >> 2] |= (uint32_t)src[g + i] << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bytes [g0, g0 + 16 n) of src into the n units of dst
__device__ __forceinline__ void stage(uint4* dst, int n, const uint8_t* __restrict__ src,
                                      int64_t g0, int64_t src_len) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int t = threadIdx.x; t < n; t += kThreads)
    dst[t] = load16(src, g0 + 16 * (int64_t)t, src_len, aligned);
}

// the 2-bit bases of 4 base bytes (byte i at bits [8i, 8i+8)) at bits [2i, 2i+2)
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return ((x & 0x03030303u) * 0x01041040u) >> 24;
}

// bit i set where byte i of x is a valid base (< 4)
__device__ __forceinline__ uint32_t valid4(uint32_t x) {
  return ((__vcmpltu4(x, 0x04040404u) & 0x08040201u) * 0x01010101u) >> 24;
}

__device__ __forceinline__ uint32_t reverse_groups32(uint32_t x) {
  x = __brev(x);  // reverses the groups and the bits inside each
  return ((x & 0x55555555u) << 1) | ((x >> 1) & 0x55555555u);
}

__device__ __forceinline__ uint64_t reverse_groups(uint64_t x) {
  x = __brevll(x);
  return ((x & 0x5555555555555555ull) << 1) | ((x >> 1) & 0x5555555555555555ull);
}

// The reversed stream of the staged words wb: read as a little-endian
// stream, rw holds base L - 1 - t at group t, L = 16 kRevWords + d (word i
// is the group reversal of the 16 bases from 16 (kRevWords - 1 - i) + d;
// the last word holds bases d - 1 down to 0, then zeros).
__device__ __forceinline__ void build_reversed(uint32_t* rw, const uint32_t* wb, int d) {
  for (int i = threadIdx.x; i <= kRevWords; i += kThreads)
    rw[i] = reverse_groups32(
        __funnelshift_r(i < kRevWords ? wb[kRevWords - 1 - i] : 0u, wb[kRevWords - i], 2 * d));
}

// The 32-bit path's windows of one block (wb forward, rw reversed with
// d = (k + 3) % 4, wm validity or NULL): min(fwd, rev), folded with kFold,
// the sentinel where invalid. Thread t encodes kGroups groups of the 4
// windows j..j+3, j = 4t + 4 kThreads g; each group goes out in one 16-byte
// store (scalar stores at a ragged end). As 4 kThreads is a multiple of 32,
// every group of a thread reads its words at the same bit offsets, so the
// offsets, shift amounts and validity masks are computed once a thread and
// the groups index shared memory by constant steps. Returns the thread's
// valid windows among those written.
template <bool kFold, bool kMasked>
__device__ __forceinline__ int encode_block32(const uint32_t* wb, const uint32_t* rw,
                                              const uint32_t* wm, int64_t i0, int64_t m, int k,
                                              int32_t* __restrict__ out) {
  constexpr int kStep = 4 * kThreads;  // windows from a group to the thread's next
  static_assert(kStep % 32 == 0, "the same offsets in every group");
  const uint32_t mask2k = (1u << (2 * k)) - 1;
  const uint32_t sentinel = kFold ? 1u << (2 * k - 1) : 1u << (2 * k);
  const int j = 4 * threadIdx.x;  // the first window of the thread's first group
  // the group of rw where the forward code of window j + 3 starts: L - j - 3
  // - k with L = 16 kRevWords + d, a multiple of 4 and >= 0 for every group
  const int a = 16 * kRevWords + ((k + 3) & 3) - 3 - k - j;
  const uint32_t* pb = wb + (j >> 4);
  const uint32_t* pr = rw + (a >> 4);
  const uint32_t* pm = kMasked ? wm + (j >> 5) : nullptr;
  int rev_shift[4], fwd_shift[4];
  uint32_t want[4];  // window j + q's K validity bits, from bit q
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    rev_shift[q] = ((2 * j) & 31) + 2 * q;      // <= 30
    fwd_shift[q] = ((2 * a) & 31) + 6 - 2 * q;  // <= 30
    want[q] = ((1u << k) - 1) << q;
  }
  // a block whose windows all exist and whose output is 16-byte aligned
  const bool full = i0 + kWindows <= m && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  int32_t* po = out + i0 + j;
  int n_valid = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const uint32_t b0 = pb[g * kStep / 16], b1 = pb[g * kStep / 16 + 1];
    const uint32_t r0 = pr[-g * kStep / 16], r1 = pr[-g * kStep / 16 + 1];
    const uint32_t x = kMasked ? __funnelshift_r(pm[g * kStep / 32], pm[g * kStep / 32 + 1],
                                                 j & 31)
                               : 0xffffffffu;
    uint32_t c[4];
    bool ok[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t rev = ~__funnelshift_r(b0, b1, rev_shift[q]) & mask2k;
      const uint32_t fwd = __funnelshift_r(r0, r1, fwd_shift[q]) & mask2k;
      uint32_t code = min(fwd, rev);
      if (kFold) code = min(code, mask2k - code);
      ok[q] = !kMasked || (~x & want[q]) == 0;
      c[q] = ok[q] ? code : sentinel;
      n_valid += ok[q];
    }
    if (full) {
      *reinterpret_cast<int4*>(po + g * kStep) = make_int4(c[0], c[1], c[2], c[3]);
    } else {
      const int64_t left = m - (i0 + j + g * kStep);  // windows of this group that exist
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < left) po[g * kStep + q] = (int32_t)c[q];
        else n_valid -= ok[q];
      }
    }
  }
  return n_valid;
}

// canonical code min(fwd, rev) of the window that starts at base j of a
// block's staged little-endian 2-bit words, in 64-bit arithmetic
__device__ __forceinline__ uint64_t canonical_at(const uint32_t* wb, int j, int k,
                                                 uint64_t mask2k) {
  const int w = j >> 4, s = (2 * j) & 31;
  const uint32_t lo = __funnelshift_r(wb[w], wb[w + 1], s);
  const uint32_t hi = __funnelshift_r(wb[w + 1], wb[w + 2], s);
  const uint64_t v = (((uint64_t)hi << 32) | lo) & mask2k;
  const uint64_t rev = ~v & mask2k;
  const uint64_t fwd = reverse_groups(v) >> (64 - 2 * k);
  return fwd < rev ? fwd : rev;
}

// whether the K validity bits from base j of a block's staged bit words are set
__device__ __forceinline__ bool valid_at(const uint32_t* wm, int j, uint32_t want) {
  return (__funnelshift_r(wm[j >> 5], wm[(j >> 5) + 1], j & 31) & want) == want;
}

// The 64-bit path's windows of one block: 16 a thread, kThreads apart;
// returns the thread's valid windows among those written.
template <bool kFold>
__device__ __forceinline__ int encode_block64(const uint32_t* wb, const uint32_t* wm,
                                              int64_t i0, int64_t m, int k,
                                              int64_t* __restrict__ out) {
  const uint64_t mask2k = (1ull << (2 * k)) - 1;
  const uint32_t want = (uint32_t)((1ull << k) - 1);
  const uint64_t sentinel = kFold ? 1ull << (2 * k - 1) : 1ull << (2 * k);
  int n_valid = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int j = threadIdx.x + r * kThreads;  // the window within the block
    if (i0 + j < m) {
      uint64_t code = canonical_at(wb, j, k, mask2k);
      if (kFold) {
        const uint64_t other = mask2k - code;
        code = code < other ? code : other;
      }
      const bool ok = wm == nullptr || valid_at(wm, j, want);
      out[i0 + j] = (int64_t)(ok ? code : sentinel);
      n_valid += ok;
    }
  }
  return n_valid;
}

// adds the block's valid windows (each thread's n) to *count: a warp
// reduction, a shared-memory sum, one atomic add a block
__device__ __forceinline__ void add_count(int n, unsigned int* block_sum,
                                          unsigned long long* count) {
  n = (int)__reduce_add_sync(0xffffffffu, (unsigned)n);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(block_sum, (unsigned)n);
  __syncthreads();
  if (threadIdx.x == 0 && *block_sum) atomicAdd(count, (unsigned long long)*block_sum);
}

template <typename T, bool kMasked>
__global__ void __launch_bounds__(kThreads)
encode_packed_kernel(const uint8_t* __restrict__ bases2, int64_t n_bases_bytes,
                     const uint8_t* __restrict__ maskbits, int64_t n_mask_bytes,
                     int64_t m, int k, T* __restrict__ out, unsigned long long* count) {
  __shared__ uint4 sb[kBaseWords / 4];
  __shared__ uint4 sm[kMaskWords / 4];
  __shared__ unsigned int block_sum;
  const int64_t i0 = (int64_t)blockIdx.x * kWindows;  // a multiple of 2048
  stage(sb, kBaseWords / 4, bases2, i0 >> 2, n_bases_bytes);
  if (kMasked) stage(sm, kMaskWords / 4, maskbits, i0 >> 3, n_mask_bytes);
  if (threadIdx.x == 0) block_sum = 0;
  __syncthreads();
  const uint32_t* wb = reinterpret_cast<const uint32_t*>(sb);
  const uint32_t* wm = kMasked ? reinterpret_cast<const uint32_t*>(sm) : nullptr;
  int n_valid;
  if constexpr (sizeof(T) == 4) {
    __shared__ uint32_t rw[kRevWords + 1];
    build_reversed(rw, wb, (k + 3) & 3);
    __syncthreads();
    n_valid = encode_block32<true, kMasked>(wb, rw, wm, i0, m, k, out);
  } else {
    n_valid = encode_block64<true>(wb, wm, i0, m, k, out);
  }
  if (count != nullptr) add_count(n_valid, &block_sum, count);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
encode_bases_kernel(const uint8_t* __restrict__ chunk, int64_t n, int64_t m, int k,
                    T* __restrict__ out) {
  __shared__ uint32_t wb[kBaseWords];
  __shared__ uint32_t wm[kMaskWords];
  const int64_t i0 = (int64_t)blockIdx.x * kWindows;
  const bool aligned = (reinterpret_cast<uintptr_t>(chunk) & 15) == 0;
  for (int t = threadIdx.x; t < kBaseSlots; t += kThreads) {  // whole warps
    uint32_t bits = 0;  // validity of the thread's 16 bases
    if (t < kBaseWords) {
      const uint4 v = load16(chunk, i0 + 16 * t, n, aligned);
      const uint32_t p01 = __byte_perm(pack4(v.x), pack4(v.y), 0x0040);
      const uint32_t p23 = __byte_perm(pack4(v.z), pack4(v.w), 0x0040);
      wb[t] = __byte_perm(p01, p23, 0x5410);
      bits = valid4(v.x) | valid4(v.y) << 4 | valid4(v.z) << 8 | valid4(v.w) << 12;
    }
    const uint32_t next = __shfl_down_sync(0xffffffffu, bits, 1);
    if ((t & 1) == 0 && t / 2 < kMaskWords) wm[t / 2] = bits | next << 16;
  }
  __syncthreads();
  if constexpr (sizeof(T) == 4) {
    __shared__ uint32_t rw[kRevWords + 1];
    build_reversed(rw, wb, (k + 3) & 3);
    __syncthreads();
    encode_block32<false, true>(wb, rw, wm, i0, m, k, out);
  } else {
    encode_block64<false>(wb, wm, i0, m, k, out);
  }
}

int blocks_for(int64_t m) { return (int)((m + kWindows - 1) / kWindows); }

template <typename T>
int launch_packed(const void* bases2, int64_t n_bases_bytes, const void* maskbits,
                  int64_t n_mask_bytes, int64_t m, int k, void* out, void* count,
                  void* stream) {
  if (k < 1 || k > (sizeof(T) == 4 ? 15 : kMaxK)) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaSuccess;
  const auto kernel = maskbits != nullptr ? encode_packed_kernel<T, true>
                                          : encode_packed_kernel<T, false>;
  kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bases2, n_bases_bytes, (const uint8_t*)maskbits, n_mask_bytes,
      m, k, (T*)out, (unsigned long long*)count);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bases(const void* chunk, int64_t n, int k, void* out, void* stream) {
  if (k < 1 || k > (sizeof(T) == 4 ? 15 : kMaxK)) return (int)cudaErrorInvalidValue;
  const int64_t m = n - k + 1;
  if (m <= 0) return (int)cudaSuccess;
  encode_bases_kernel<T><<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)chunk, n, m, k, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// folded canonical codes of the m = span - k + 1 windows of a packed chunk;
// maskbits NULL for an all-valid chunk; count (an int64 on the card) NULL,
// or it gains the number of valid windows
extern "C" int pykmer_encode_packed_i32(const void* bases2, int64_t n_bases_bytes,
                                        const void* maskbits, int64_t n_mask_bytes,
                                        int64_t m, int64_t k, void* out, void* count,
                                        void* stream) {
  return launch_packed<int32_t>(bases2, n_bases_bytes, maskbits, n_mask_bytes, m,
                                (int)k, out, count, stream);
}

extern "C" int pykmer_encode_packed_i64(const void* bases2, int64_t n_bases_bytes,
                                        const void* maskbits, int64_t n_mask_bytes,
                                        int64_t m, int64_t k, void* out, void* count,
                                        void* stream) {
  return launch_packed<int64_t>(bases2, n_bases_bytes, maskbits, n_mask_bytes, m,
                                (int)k, out, count, stream);
}

// unfolded canonical codes of the n - k + 1 windows of a base-code chunk
extern "C" int pykmer_encode_bases_i32(const void* chunk, int64_t n, int64_t k,
                                       void* out, void* stream) {
  return launch_bases<int32_t>(chunk, n, (int)k, out, stream);
}

extern "C" int pykmer_encode_bases_i64(const void* chunk, int64_t n, int64_t k,
                                       void* out, void* stream) {
  return launch_bases<int64_t>(chunk, n, (int)k, out, stream);
}
