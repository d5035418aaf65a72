// Saturating sweep of a sorted batch of k-mer codes into a uint8 count plane.
//
// Replaces the TPU kernel pykmer_tpu/ops/pallas_hist.py::_kernel (launched by
// accumulate_sorted_pallas). Same result: for every cell c,
//     plane[c] = min(plane[c] + min(n_c, 255), 255)
// where n_c is the number of codes equal to c in the batch; codes outside
// [0, n_cells) (sentinels, pad, the -1 band) are ignored. The plane is
// updated in place.
//
// Design. The TPU kernel sweeps the whole plane tile by tile and builds
// per-tile counts with one-hot matrix products, because the TPU scatters
// serially. A GPU scatters in parallel, so this kernel is a run-head pass
// over the sorted batch instead: one thread per sorted position (grid
// stride); the thread at the head of a run of equal codes finds the run's
// end by a galloping binary search (O(log run), so a repeat k-mer with
// millions of copies costs ~22 probes, a unique k-mer one), then does one
// read and one write of its cell. In a sorted batch each cell has exactly one
// run, so no two threads touch one cell: no atomics, and the result is exact
// and deterministic. Byte stores to distinct addresses do not interfere.
//
// Bound: memory. The batch is read sequentially once (4 or 8 bytes a code,
// plus neighbour reads that hit the same lines), and each distinct in-range
// code costs one random 32-byte-sector read-modify-write of the plane. That
// is why the design touches each cell once per batch and never sweeps the
// plane: at K=15 the plane is 2^29 cells, a batch 2^24 codes.
//
// All plane indexing is int64, so planes above 2^31 cells (K >= 17) need no
// sub-plane split. Launchers take (plane, n_cells, codes, m, stream), run on
// the caller's stream, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride beyond this

// First index j in (i, m) with codes[j] != c, given codes[i] == c and the
// batch sorted ascending (so codes[j] == c exactly for j in [i, end)).
template <typename T>
__device__ __forceinline__ int64_t run_end(const T* __restrict__ codes,
                                           int64_t i, int64_t m, T c) {
  // gallop: find step with codes[i + step] != c (or past the end)
  int64_t step = 1;
  while (i + step < m && codes[i + step] == c) step <<= 1;
  // binary search in (i + step/2, min(i + step, m)]: lo is known equal
  int64_t lo = i + (step >> 1);
  int64_t hi = i + step < m ? i + step : m;
  while (hi - lo > 1) {
    int64_t mid = lo + ((hi - lo) >> 1);
    if (codes[mid] == c) lo = mid; else hi = mid;
  }
  return hi;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sweep_sorted_kernel(uint8_t* __restrict__ plane, int64_t n_cells,
                    const T* __restrict__ codes, int64_t m) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const T c = codes[i];
    if (c < 0 || (int64_t)c >= n_cells) continue;
    if (i > 0 && codes[i - 1] == c) continue;  // not the head of its run
    const int64_t run = run_end(codes, i, m, c) - i;
    const int v = (int)plane[c] + (run < 255 ? (int)run : 255);
    plane[c] = (uint8_t)(v < 255 ? v : 255);
  }
}

template <typename T>
int launch(void* plane, int64_t n_cells, const void* codes, int64_t m,
           void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sweep_sorted_kernel<T><<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (uint8_t*)plane, n_cells, (const T*)codes, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pykmer_sweep_sorted_i32(void* plane, int64_t n_cells,
                                       const void* codes, int64_t m,
                                       void* stream) {
  return launch<int32_t>(plane, n_cells, codes, m, stream);
}

extern "C" int pykmer_sweep_sorted_i64(void* plane, int64_t n_cells,
                                       const void* codes, int64_t m,
                                       void* stream) {
  return launch<int64_t>(plane, n_cells, codes, m, stream);
}
