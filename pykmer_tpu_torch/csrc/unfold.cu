// Unfold on the card: bytes [a, a + n) of the 4^K `.kin` plane, in file
// order, from the folded plane, and the 256-bin histogram of the folded
// cells that the file's first half reads.
//
// It replaces no TPU kernel: the JAX package unfolds on the host
// (pykmer_tpu/ops/readback.py::unfold_range), as the port's CPU, packed,
// sparse and pieces tails still do (ops/readback.unfold_range, the native
// unfold_canonical_range). That unfold writes each folded slice to two
// regions, one in each half of the file, so the second half is final only
// at the end and its sha256 was a serial remainder. Written here in file
// order, each slice of the file is final when it reaches the host, and the
// hash chases the whole file. Semantics, unfold_range's: with M = 4^K - 1
// and canon(u) = u <= rc(u) (palindromes of even K included),
//
//   p <  4^K/2: out[p] = canon(p)   ? folded[p]   : 0
//   p >= 4^K/2: out[p] = canon(M-p) ? 0 : folded[M-p]
//
// Design: a thread writes one aligned 16-byte group of the file, [16g,
// 16g + 16), in a grid-stride loop. Where the group lies whole in the range
// and in one half, and both addresses are 16-byte aligned, it is one 16-byte
// load and one 16-byte store: the folded cells u0 .. u0+15 it reads are
// aligned too (u0 = 16g in the first half, 4^K - 16 - 16g in the second,
// read in descending order and byte-reversed with __byte_perm), so a warp
// reads and writes 512 contiguous bytes either way. The canonical test runs
// in registers: rc(u) is a bit reversal (__brevll) of ~u with each base's
// two bits swapped back; one rc a group, since u0's two lowest bases are 0
// and rc(u0 + j) = rc(u0) - (rev(j) << 2(K-2)) for the group's j = 0..15.
// Any other group (ragged ends, K < 3, unaligned views) takes a byte loop.
// The histogram: each block keeps 256 shared bins (zeros tallied in a
// register, one add a thread), then adds each nonzero bin to the int64
// counts once; only first-half bytes count, so each folded cell counts once
// over the file.
//
// Bound on the H100 (memory): a 64 Mi-cell slice reads 64 MiB of folded
// cells and writes 64 MiB: 0.040 ms at 3.35 TB/s.
//
// The launcher takes device pointers, sizes and the stream, launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;  // resident blocks of 256 threads on an H100

// reverse complement of the K-mer ``u`` (2 bits a base, base 0 lowest)
__device__ __forceinline__ uint64_t rc(uint64_t u, int k) {
  uint64_t x = __brevll(~u);  // bases reversed, each base's two bits swapped
  x = ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
  return x >> (64 - 2 * k);
}

__device__ __forceinline__ void tally(uint32_t* bins, uint32_t& zeros, uint32_t c) {
  if (c) {
    atomicAdd(&bins[c], 1u);
  } else {
    zeros++;
  }
}

__device__ __forceinline__ void tally4(uint32_t* bins, uint32_t& zeros, uint32_t w) {
#pragma unroll
  for (int b = 0; b < 4; b++) tally(bins, zeros, (w >> (8 * b)) & 0xFF);
}

__device__ __forceinline__ uint32_t rev4(uint32_t w) { return __byte_perm(w, 0, 0x0123); }

// src holds folded cells [c0, ...); out receives file bytes [a, a + n)
__global__ void __launch_bounds__(kThreads)
unfold_kernel(const uint8_t* __restrict__ src, int64_t c0, uint8_t* __restrict__ out,
              int64_t a, int64_t n, int k, unsigned long long* __restrict__ counts) {
  __shared__ uint32_t bins[256];
  const bool count = counts != nullptr;
  if (count) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) bins[i] = 0;
    __syncthreads();
  }
  const int64_t full = int64_t(1) << (2 * k), half = full >> 1, m = full - 1;
  const int s = 2 * (k - 2);  // used only on whole groups, where K >= 3
  const int64_t end = a + n;
  const int64_t g_end = (end + 15) >> 4;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  uint32_t zeros = 0;
  for (int64_t g = (a >> 4) + int64_t(blockIdx.x) * blockDim.x + threadIdx.x; g < g_end;
       g += stride) {
    const int64_t p0 = g << 4;
    const bool first = p0 < half;
    bool whole = p0 >= a && p0 + 16 <= end && (p0 + 16 <= half || !first);
    const int64_t u0 = first ? p0 : full - 16 - p0;  // the group's lowest folded cell
    if (whole) {
      const uintptr_t at = reinterpret_cast<uintptr_t>(src + (u0 - c0))
          | reinterpret_cast<uintptr_t>(out + (p0 - a));
      whole = (at & 15) == 0;
    }
    if (whole) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + (u0 - c0));
      const int64_t d = int64_t(rc(uint64_t(u0), k)) - u0;
      uint32_t keep[4] = {0, 0, 0, 0};  // byte j: canon(u0 + j)
#pragma unroll
      for (int j = 0; j < 16; j++) {
        const int64_t jr = ((j & 3) << 2) | (j >> 2);
        if (int64_t(j) + (jr << s) <= d) keep[j >> 2] |= 0xFFu << (8 * (j & 3));
      }
      uint4 w;
      if (first) {
        w = make_uint4(v.x & keep[0], v.y & keep[1], v.z & keep[2], v.w & keep[3]);
        if (count) {
          tally4(bins, zeros, v.x);
          tally4(bins, zeros, v.y);
          tally4(bins, zeros, v.z);
          tally4(bins, zeros, v.w);
        }
      } else {
        // cell u0 + j lands at file byte M - u0 - j = p0 + 15 - j
        w = make_uint4(rev4(v.w & ~keep[3]), rev4(v.z & ~keep[2]), rev4(v.y & ~keep[1]),
                       rev4(v.x & ~keep[0]));
      }
      *reinterpret_cast<uint4*>(out + (p0 - a)) = w;
    } else {
      for (int j = 0; j < 16; j++) {
        const int64_t p = p0 + j;
        if (p < a || p >= end) continue;
        const bool lower = p < half;
        const int64_t u = lower ? p : m - p;
        const uint8_t c = src[u - c0];
        const bool canon = uint64_t(u) <= rc(uint64_t(u), k);
        out[p - a] = lower == canon ? c : 0;
        if (count && lower) tally(bins, zeros, c);
      }
    }
  }
  if (count) {
    if (zeros) atomicAdd(&bins[0], zeros);
    __syncthreads();
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      if (bins[i]) atomicAdd(&counts[i], (unsigned long long)bins[i]);
    }
  }
}

}  // namespace

// (src: folded cells [c0, ...), c0, out: n bytes, a, n, K, counts: int64[256]
//  or NULL, stream)
extern "C" int pykmer_unfold_file(const void* src, int64_t c0, void* out, int64_t a,
                                  int64_t n, int64_t k, void* counts, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int64_t groups = ((a + n + 15) >> 4) - (a >> 4);
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  unfold_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(src), c0, static_cast<uint8_t*>(out), a, n, (int)k,
      static_cast<unsigned long long*>(counts));
  return cudaGetLastError();
}
