// Variants of the encode kernels, for scripts/bench_encode_variants.py.
//
// Built by the benchmark script with nvcc into its own library; the port
// never loads it. The port's kernels are pykmer_tpu_torch/csrc/encode.cu
// (a 32-bit path at K <= 15 with the valid-window count fused in, the bases
// entry packed in registers). This file keeps the design they replaced,
// unchanged but for the names of its entries (strided64_*): 2048 windows
// a block, 8 a thread 256 apart, byte staging, 64-bit window arithmetic at
// every K, and the bases entry repacked from its staged bytes by a serial
// loop over shared memory. Its original note follows.
//
// Canonical k-mer codes of a chunk, 2048 windows a block, 8 a thread.
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
// - bases: unfolded canonical codes from a uint8 base-code chunk (0..3
//   valid, >= 4 invalid); an invalid window gets the sentinel 4^K.
//
// Bound on the H100 (memory): the input read once and the codes written
// once. At the K=15 shape (2^24 windows) the packed entry moves 4.2 MB of
// bases, 2.1 MB of mask and 67.1 MB of int32 codes, 0.022 ms at 3.35 TB/s;
// at K=17, 134.2 MB of int64 codes, 0.042 ms; the bases entry reads a byte
// a base. The arithmetic (a few dozen integer operations a window) is far
// below the card's rate, so the design only has to stream: each block
// stages the bytes its 2048 windows cover, plus the halo of the last
// window, in shared memory with coalesced byte loads that are guarded at
// the tensors' ends (they are not padded), and each thread encodes 8
// windows 256 apart, so that every store of a warp writes neighbouring
// addresses. A first design with one window a thread (256 a block) waited
// on its staging loads (0.12 ms at the K=15 shape); a first bases entry
// that summed each window's K staged bytes in a loop took 0.20-0.25 ms
// (PERF.md). The bases entry therefore packs its staged bytes into the
// packed entry's layout in shared memory and extracts windows the same way.
//
// The packed entry reads the planes as little-endian bit streams: base p
// sits at bits [2p, 2p+2), so a window's 2K bits, read as a little-endian
// word w, hold base i+p at weight 4^p. The reverse complement is then
// ~w & (4^K - 1) directly, and the forward code is w with its 2-bit groups
// reversed (bit reversal, then a swap of the bits of each pair) and shifted
// down by 64 - 2K. A window starts at an even bit offset of up to 30 bits
// within a staged 32-bit word, so two funnel shifts over three words give
// the 64 bits that hold its 2K <= 62 bits at every K. Validity is K
// consecutive mask bits (one funnel shift over two words) compared with
// all-ones.
//
// Launchers take device pointers, sizes and the stream, launch on the
// caller's stream, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;  // windows a thread encodes, kThreads apart
constexpr int kWindows = kThreads * kPerThread;  // windows per block
// staged bytes a block needs: its windows' bases (2 bits each) plus three
// 32-bit words of reach for the last window; its validity bits plus two
constexpr int kBaseBytes = kWindows / 4 + 12;
constexpr int kMaskBytes = kWindows / 8 + 8;
constexpr int kMaxK = 31;  // 2K bits in one 64-bit word, 4^K in int64
// the bases entry's staged bytes: its windows plus their K-1 <= 30 halo,
// rounded up to a whole validity word
constexpr int kChunkBytes = kWindows + 32;
static_assert(kChunkBytes >= kWindows + kMaxK - 1, "the halo of the last window");

__device__ __forceinline__ uint64_t reverse_groups(uint64_t x) {
  x = __brevll(x);  // reverses the groups and the bits inside each
  return ((x & 0x5555555555555555ull) << 1) | ((x >> 1) & 0x5555555555555555ull);
}

// bytes [g0, g0 + n) of src into dst, zero past the end of src (src_len)
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* __restrict__ src,
                                      int64_t g0, int n, int64_t src_len) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int64_t g = g0 + t;
    dst[t] = g < src_len ? src[g] : 0;
  }
}

// canonical code min(fwd, rev) of the window that starts at base j of a
// block's staged little-endian 2-bit words
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
encode_packed_kernel(const uint8_t* __restrict__ bases2, int64_t n_bases_bytes,
                     const uint8_t* __restrict__ maskbits, int64_t n_mask_bytes,
                     int64_t m, int k, T* __restrict__ out) {
  __shared__ __align__(8) uint8_t sb[kBaseBytes];
  __shared__ __align__(8) uint8_t sm[kMaskBytes];
  const int64_t i0 = (int64_t)blockIdx.x * kWindows;  // a multiple of 8
  stage(sb, bases2, i0 >> 2, kBaseBytes, n_bases_bytes);
  if (maskbits != nullptr) stage(sm, maskbits, i0 >> 3, kMaskBytes, n_mask_bytes);
  __syncthreads();

  const uint32_t* wb = reinterpret_cast<const uint32_t*>(sb);
  const uint32_t* wm = reinterpret_cast<const uint32_t*>(sm);
  const uint64_t mask2k = (1ull << (2 * k)) - 1;
  const uint32_t want = (uint32_t)((1ull << k) - 1);
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int j = threadIdx.x + r * kThreads;  // the window within the block
    if (i0 + j >= m) return;
    const uint64_t canon = canonical_at(wb, j, k, mask2k);
    const uint64_t other = mask2k - canon;
    uint64_t code = canon < other ? canon : other;
    if (maskbits != nullptr && !valid_at(wm, j, want))
      code = 1ull << (2 * k - 1);  // the folded sentinel 4^K / 2
    out[i0 + j] = (T)code;
  }
}

// The bases entry packs its staged bytes into the packed entry's layout
// (16 bases a 2-bit word, 32 validity bits a word) in shared memory, then
// encodes each window as the packed entry does, unfolded.
template <typename T>
__global__ void __launch_bounds__(kThreads)
encode_bases_kernel(const uint8_t* __restrict__ chunk, int64_t n, int64_t m, int k,
                    T* __restrict__ out) {
  __shared__ uint8_t sc[kChunkBytes];
  __shared__ uint32_t wb[kChunkBytes / 16 + 2];
  __shared__ uint32_t wm[kChunkBytes / 32 + 1];
  const int64_t i0 = (int64_t)blockIdx.x * kWindows;
  stage(sc, chunk, i0, kChunkBytes, n);
  __syncthreads();
  for (int t = threadIdx.x; t < kChunkBytes / 16 + 2; t += kThreads) {
    uint32_t w = 0;
    for (int i = 0; i < 16 && 16 * t + i < kChunkBytes; ++i)
      w |= (uint32_t)(sc[16 * t + i] & 3) << (2 * i);
    wb[t] = w;
  }
  for (int t = threadIdx.x; t < kChunkBytes / 32 + 1; t += kThreads) {
    uint32_t w = 0;
    for (int i = 0; i < 32 && 32 * t + i < kChunkBytes; ++i)
      w |= (uint32_t)(sc[32 * t + i] < 4) << i;
    wm[t] = w;
  }
  __syncthreads();

  const uint64_t mask2k = (1ull << (2 * k)) - 1;
  const uint32_t want = (uint32_t)((1ull << k) - 1);
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int j = threadIdx.x + r * kThreads;
    if (i0 + j >= m) return;
    out[i0 + j] = (T)(valid_at(wm, j, want) ? canonical_at(wb, j, k, mask2k)
                                            : 1ull << (2 * k));  // the sentinel 4^K
  }
}

int blocks_for(int64_t m) { return (int)((m + kWindows - 1) / kWindows); }

template <typename T>
int launch_packed(const void* bases2, int64_t n_bases_bytes, const void* maskbits,
                  int64_t n_mask_bytes, int64_t m, int k, void* out, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  encode_packed_kernel<T><<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bases2, n_bases_bytes, (const uint8_t*)maskbits, n_mask_bytes,
      m, k, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bases(const void* chunk, int64_t n, int k, void* out, void* stream) {
  const int64_t m = n - k + 1;
  if (m <= 0) return (int)cudaSuccess;
  encode_bases_kernel<T><<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)chunk, n, m, k, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// folded canonical codes of the m = span - k + 1 windows of a packed chunk;
// maskbits NULL for an all-valid chunk
extern "C" int strided64_encode_packed_i32(const void* bases2, int64_t n_bases_bytes,
                                        const void* maskbits, int64_t n_mask_bytes,
                                        int64_t m, int64_t k, void* out, void* stream) {
  return launch_packed<int32_t>(bases2, n_bases_bytes, maskbits, n_mask_bytes, m,
                                (int)k, out, stream);
}

extern "C" int strided64_encode_packed_i64(const void* bases2, int64_t n_bases_bytes,
                                        const void* maskbits, int64_t n_mask_bytes,
                                        int64_t m, int64_t k, void* out, void* stream) {
  return launch_packed<int64_t>(bases2, n_bases_bytes, maskbits, n_mask_bytes, m,
                                (int)k, out, stream);
}

// unfolded canonical codes of the n - k + 1 windows of a base-code chunk
extern "C" int strided64_encode_bases_i32(const void* chunk, int64_t n, int64_t k,
                                       void* out, void* stream) {
  return launch_bases<int32_t>(chunk, n, (int)k, out, stream);
}

extern "C" int strided64_encode_bases_i64(const void* chunk, int64_t n, int64_t k,
                                       void* out, void* stream) {
  return launch_bases<int64_t>(chunk, n, (int)k, out, stream);
}
