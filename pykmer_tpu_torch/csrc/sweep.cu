// Saturating sweep of a sorted batch of k-mer codes into a uint8 count plane.
//
// Replaces the TPU kernel pykmer_tpu/ops/pallas_hist.py::_kernel (launched by
// accumulate_sorted_pallas, pallas_call at :259). Same result: for every
// cell c,
//     plane[c] = min(plane[c] + min(n_c, 255), 255)
// where n_c is the number of codes equal to c in the batch; codes outside
// [0, n_cells) (sentinels, pad, the -1 band) are ignored. The plane is
// updated in place.
//
// Why not the TPU design. The Pallas kernel sweeps the whole plane tile by
// tile and builds per-tile counts with one-hot matrix products, because the
// TPU scatters serially. A GPU scatters in parallel, so this kernel walks the
// sorted batch instead and touches only the cells the batch holds: one read
// and one write per distinct in-range code, never a pass over the plane.
//
// Bound on the H100 (memory): the codes read once (4 or 8 bytes a code) plus,
// for each distinct 32-byte sector of the plane that the batch's in-range
// codes touch, one sector read and one written back, at 3.35 TB/s: 0.19 ms at
// the K=15 shape (2^24 int32 codes on 2^29 cells, ~9.0M sectors), 0.28 ms at
// the K=17 shape (2^24 int64 codes on 2^33 cells, ~12.7M sectors). Those
// sectors lie at random across the plane, so what the card reaches is the
// HBM's rate of random 32-byte reads and writes, not its streaming rate
// (measured by scripts/bench_sweep_variants.py on an H100 80GB HBM3 at
// 700 W, PERF.md): at the K=17 shape the heads' plane loads alone take
// 0.39 ms and their stores alone 0.87 ms (a byte store to a sector not in
// the L2 costs a sector read and a write), of the sweep's 1.04 ms; at the
// K=15 shape, where about two codes share a sector and many share a DRAM
// row, 0.17 and 0.27 of 0.31 ms.
//
// Design: a run-head pass over the sorted batch, one thread per sorted
// position (grid stride beyond 2^30 positions). The thread at the head of a
// run of equal codes finds the run's end by a galloping binary search
// (O(log run): a repeat k-mer with millions of copies costs about 40 probes that
// hit the L1 and L2, a unique k-mer one), then reads its cell and writes it
// back at once, while the sector is still in the L2. In a sorted batch each
// cell has exactly one run, so no two threads touch one cell: no atomics,
// and the result is exact and deterministic. Byte stores to distinct
// addresses do not interfere. The blocks run in launch order, so at any time
// the whole card works on one narrow rising window of the plane; every head
// keeps its load and store back to back; and 1024-thread blocks keep 2048
// threads, each with one plane access in flight, on every SM. A persistent
// grid with code tiles staged by TMA and heads found in a shared-memory
// bitmap (one contiguous range of tiles per block, or every G-th tile; 4 to
// 32 positions a thread, their loads batched or not) measured 24-45% slower
// at the K=15 shape and no faster at the K=17 shape; store and load cache
// hints and other block sizes gained nothing (scripts/sweep_variants.cu
// keeps those variants).
//
// All plane indexing is int64, so planes above 2^31 cells (K >= 17) need no
// sub-plane split; one template serves int32 and int64 codes. Launchers take
// (plane, n_cells, codes, m, stream), run on the caller's stream, do not
// synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
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
