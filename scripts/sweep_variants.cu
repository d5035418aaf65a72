// Variants of the sweep kernel, for scripts/bench_sweep_variants.py.
//
// Built by the benchmark script with nvcc into its own library; the port
// never loads it. The port's kernel is pykmer_tpu_torch/csrc/sweep.cu (a
// grid-stride run-head pass with 1024-thread blocks); this file keeps the
// designs it was measured against, each computing the same plane:
// - sweep_gridstride_256: the same run-head pass with 256-thread blocks,
//   the port's earlier kernel: one thread per sorted position, each head
//   galloping to its run's end in global memory, its load and store back to
//   back; _128 / _1024 with 128 or 1024 threads a block, _256_cs with the
//   codes loaded evict-first (ld.global.cs), _256_cg with the plane loaded
//   through the L2 only (ld.global.cg), _1024_wt / _1024_stcs with the plane
//   stored write-through (st.global.wt) or evict-first (st.global.cs);
// - sweep_tiles_<items>_<stages>[_il][_nb]: the tiled design (a persistent
//   grid of SMs times occupancy blocks of 256 threads; code tiles of 256 *
//   <items> codes staged in shared memory by 1-D TMA bulk copies with an
//   mbarrier, in a ring of <stages>; run heads flagged by a neighbour
//   compare into a shared-memory bitmap by warp ballots, each run ending at
//   the next set bit, a run past its tile galloping in global memory), each
//   block on a contiguous range of tiles or, with _il, on every G-th tile (G
//   the grid); all of a tile's plane loads issued before its stores or,
//   with _nb, each load right before its store;
// - diag_read / diag_write: the 256-thread run-head pass with only the
//   plane load of each head (summed into a dummy word) or only its store:
//   diagnostics of where the time goes, not the sweep's function.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// First index j in (i, m) with codes[j] != c, given codes[i] == c and the
// batch sorted ascending.
template <typename T>
__device__ __forceinline__ int64_t run_end(const T* __restrict__ codes,
                                           int64_t i, int64_t m, T c) {
  int64_t step = 1;
  while (i + step < m && codes[i + step] == c) step <<= 1;
  int64_t lo = i + (step >> 1);
  int64_t hi = i + step < m ? i + step : m;
  while (hi - lo > 1) {
    int64_t mid = lo + ((hi - lo) >> 1);
    if (codes[mid] == c) lo = mid; else hi = mid;
  }
  return hi;
}

template <typename T, int ITEMS, int STAGES>
struct Layout {
  static constexpr int kTile = kThreads * ITEMS;      // codes per tile
  static constexpr int kAlign = 16 / (int)sizeof(T);  // codes per 16 bytes
  static constexpr int kSlot = kTile + kAlign;        // room for a misaligned view
  static constexpr int kWords = kTile / 32;           // head-bitmap words
  static constexpr int kBitmapOff = (STAGES * 8 + 15) / 16 * 16;
  static constexpr int kSlotOff = kBitmapOff + kWords * 4;
  static constexpr int kSmem = kSlotOff + STAGES * kSlot * (int)sizeof(T);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Stage codes [lo, hi) into ``slot`` at offset ``pad`` (the codes pointer's
// misalignment in elements): the 16-byte-aligned middle by one bulk copy,
// the unaligned head and tail by plain loads before the arrive.
template <typename T>
__device__ __forceinline__ void load_tile(T* slot, int pad, const T* codes,
                                          int64_t lo, int64_t hi, uint64_t* bar) {
  constexpr int kAlign = 16 / (int)sizeof(T);
  T* tile = slot + pad;
  const int n = (int)(hi - lo);
  int head = pad == 0 ? 0 : kAlign - pad;
  if (head > n) head = n;
  const int body = (n - head) / kAlign * kAlign;
  for (int j = 0; j < head; ++j) tile[j] = codes[lo + j];
  for (int j = head + body; j < n; ++j) tile[j] = codes[lo + j];
  const uint32_t bytes = (uint32_t)body * (uint32_t)sizeof(T);
  mbar_arrive_expect_tx(bar, bytes);
  if (bytes) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(tile + head)), "l"(codes + lo + head), "r"(bytes),
           "r"(smem_u32(bar))
        : "memory");
  }
}

// The first set bit after position p in the tile's head bitmap, or
// ``words * 32`` when the run reaches the end of the tile.
__device__ __forceinline__ int next_head(const uint32_t* bitmap, int p, int words) {
  int w = p >> 5;
  const int b = p & 31;
  uint32_t bits = b == 31 ? 0u : bitmap[w] & (0xffffffffu << (b + 1));
  while (bits == 0) {
    if (++w == words) return words * 32;
    bits = bitmap[w];
  }
  return (w << 5) + __ffs(bits) - 1;
}

}  // namespace

namespace {

constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride beyond this

// MODE 0: the sweep; 1: the heads' plane loads only; 2: their stores only.
// CODES_CS: the codes loaded with the streaming hint (ld.global.cs, evict
// first) so that they leave the L2 to the plane; PLANE_CG: the plane loaded
// through the L2 only (ld.global.cg, no L1 allocation).
// STORE: 0 a plain store (write-back), 1 write-through (st.global.wt),
// 2 evict-first (st.global.cs).
template <typename T, int MODE, bool CODES_CS = false, bool PLANE_CG = false,
          int STORE = 0>
__global__ void sweep_gridstride_kernel(uint8_t* __restrict__ plane, int64_t n_cells,
                                        const T* __restrict__ codes, int64_t m,
                                        unsigned* __restrict__ sink) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned acc = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const T c = CODES_CS ? __ldcs(codes + i) : codes[i];
    if (c < 0 || (int64_t)c >= n_cells) continue;
    if (i > 0 && (CODES_CS ? __ldcs(codes + i - 1) : codes[i - 1]) == c) continue;
    const int64_t run = run_end(codes, i, m, c) - i;
    const unsigned old = PLANE_CG ? (unsigned)__ldcg(plane + c) : (unsigned)plane[c];
    if (MODE == 1) {
      acc += old + (unsigned)run;
    } else if (MODE == 2) {
      plane[c] = (uint8_t)(run < 255 ? run : 255);
    } else {
      const int v = (int)old + (run < 255 ? (int)run : 255);
      const unsigned char out = (unsigned char)(v < 255 ? v : 255);
      if (STORE == 1) __stwt(plane + c, out);
      else if (STORE == 2) __stcs(plane + c, out);
      else plane[c] = out;
    }
  }
  if (MODE == 1 && acc == 0x9e3779b9u) *sink = acc;  // keeps the loads
}

unsigned* sink_word() {
  static unsigned* word = nullptr;
  if (word == nullptr) cudaMalloc(&word, sizeof(unsigned));
  return word;
}

template <typename T, int MODE, int THREADS = kThreads, bool CODES_CS = false,
          bool PLANE_CG = false, int STORE = 0>
int launch_gridstride(void* plane, int64_t n_cells, const void* codes, int64_t m,
                      void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  int64_t blocks = (m + THREADS - 1) / THREADS;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sweep_gridstride_kernel<T, MODE, CODES_CS, PLANE_CG, STORE>
      <<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
          (uint8_t*)plane, n_cells, (const T*)codes, m, sink_word());
  return (int)cudaGetLastError();
}

// The tiled kernel, with the tile assignment (INTERLEAVE) and the load
// batching (BATCH) as parameters.
template <typename T, int ITEMS, int STAGES, bool INTERLEAVE, bool BATCH>
__global__ void __launch_bounds__(kThreads)
lab_tiles_kernel(uint8_t* __restrict__ plane, int64_t n_cells,
                 const T* __restrict__ codes, int64_t m, int64_t n_tiles) {
  using L = Layout<T, ITEMS, STAGES>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint32_t* bitmap = reinterpret_cast<uint32_t*>(smem + L::kBitmapOff);
  T* slots = reinterpret_cast<T*>(smem + L::kSlotOff);

  const int64_t b = blockIdx.x, g = gridDim.x;
  int64_t t0, step, count;
  if (INTERLEAVE) {
    t0 = b, step = g, count = (n_tiles - b + g - 1) / g;
  } else {
    const int64_t per = n_tiles / g, extra = n_tiles % g;
    t0 = b * per + (b < extra ? b : extra), step = 1, count = per + (b < extra ? 1 : 0);
  }
  const int pad = (int)(((uintptr_t)codes & 15) / sizeof(T));
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int64_t i = 0; i < count && i < STAGES; ++i) {
      const int64_t lo = (t0 + i * step) * L::kTile;
      load_tile(slots + i * L::kSlot, pad, codes, lo,
                lo + L::kTile < m ? lo + L::kTile : m, &bars[i]);
    }
  }
  __syncthreads();

  for (int64_t i = 0; i < count; ++i) {
    const int s = (int)(i % STAGES);
    const int64_t lo = (t0 + i * step) * L::kTile;
    const int64_t hi = lo + L::kTile < m ? lo + L::kTile : m;
    const int n = (int)(hi - lo);
    const T* tile = slots + s * L::kSlot + pad;
    const T prev = (tid == 0 && lo > 0) ? codes[lo - 1] : (T)0;
    mbar_wait(&bars[s], (uint32_t)((i / STAGES) & 1));

    T c[ITEMS];
    uint8_t old[ITEMS];
    uint32_t act = 0;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int p = r * kThreads + tid;
      bool head = true;
      c[r] = 0;
      old[r] = 0;
      if (p < n) {
        c[r] = tile[p];
        head = (lo + p == 0) || c[r] != (p > 0 ? tile[p - 1] : prev);
      }
      const uint32_t word = __ballot_sync(0xffffffffu, head);
      if (lane == 0) bitmap[p >> 5] = word;
      if (p < n && head && c[r] >= 0 && (int64_t)c[r] < n_cells) {
        act |= 1u << r;
        if (BATCH) old[r] = plane[(int64_t)c[r]];
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (!((act >> r) & 1u)) continue;
      const int p = r * kThreads + tid;
      const int end = next_head(bitmap, p, L::kWords);
      int64_t run;
      if (end < L::kTile) run = end - p;
      else if (hi == m) run = L::kTile - p;
      else run = run_end(codes, hi - 1, m, c[r]) - (lo + p);
      const int o = BATCH ? (int)old[r] : (int)plane[(int64_t)c[r]];
      const int v = o + (run < 255 ? (int)run : 255);
      plane[(int64_t)c[r]] = (uint8_t)(v < 255 ? v : 255);
    }
    __syncthreads();

    if (tid == 0 && i + STAGES < count) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const int64_t nlo = (t0 + (i + STAGES) * step) * L::kTile;
      load_tile(slots + s * L::kSlot, pad, codes, nlo,
                nlo + L::kTile < m ? nlo + L::kTile : m, &bars[s]);
    }
  }
}

template <typename T, int ITEMS, int STAGES, bool INTERLEAVE, bool BATCH>
int launch_lab(void* plane, int64_t n_cells, const void* codes, int64_t m, void* stream) {
  using L = Layout<T, ITEMS, STAGES>;
  if (m <= 0) return (int)cudaSuccess;
  auto kernel = lab_tiles_kernel<T, ITEMS, STAGES, INTERLEAVE, BATCH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, L::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int64_t n_tiles = (m + L::kTile - 1) / L::kTile;
  int64_t grid = (int64_t)sms * occ;
  if (grid > n_tiles) grid = n_tiles;
  kernel<<<(unsigned)grid, kThreads, L::kSmem, (cudaStream_t)stream>>>(
      (uint8_t*)plane, n_cells, (const T*)codes, m, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

#define VARIANT(NAME, ...)                                                     \
  extern "C" int NAME##_i32(void* p, int64_t n, const void* c, int64_t m,     \
                            void* s) {                                          \
    return __VA_ARGS__<int32_t>(p, n, c, m, s);                                \
  }                                                                            \
  extern "C" int NAME##_i64(void* p, int64_t n, const void* c, int64_t m,     \
                            void* s) {                                          \
    return __VA_ARGS__<int64_t>(p, n, c, m, s);                                \
  }

template <typename T> int gs_256(void* p, int64_t n, const void* c, int64_t m, void* s) {
  return launch_gridstride<T, 0>(p, n, c, m, s);
}
template <typename T> int gs_128(void* p, int64_t n, const void* c, int64_t m, void* s) {
  return launch_gridstride<T, 0, 128>(p, n, c, m, s);
}
template <typename T> int gs_1024(void* p, int64_t n, const void* c, int64_t m, void* s) {
  return launch_gridstride<T, 0, 1024>(p, n, c, m, s);
}
template <typename T> int gs_256_cs(void* p, int64_t n, const void* c, int64_t m, void* s) {
  return launch_gridstride<T, 0, kThreads, true, false>(p, n, c, m, s);
}
template <typename T> int gs_256_cg(void* p, int64_t n, const void* c, int64_t m, void* s) {
  return launch_gridstride<T, 0, kThreads, false, true>(p, n, c, m, s);
}
template <typename T> int gs_1024_wt(void* p, int64_t n, const void* c, int64_t m, void* s) {
  return launch_gridstride<T, 0, 1024, false, false, 1>(p, n, c, m, s);
}
template <typename T> int gs_1024_stcs(void* p, int64_t n, const void* c, int64_t m, void* s) {
  return launch_gridstride<T, 0, 1024, false, false, 2>(p, n, c, m, s);
}
template <typename T> int diag_read(void* p, int64_t n, const void* c, int64_t m, void* s) {
  return launch_gridstride<T, 1>(p, n, c, m, s);
}
template <typename T> int diag_write(void* p, int64_t n, const void* c, int64_t m, void* s) {
  return launch_gridstride<T, 2>(p, n, c, m, s);
}
#define LAB(ITEMS, STAGES, IL, BATCH)                                          \
  template <typename T>                                                        \
  int lab_##ITEMS##_##STAGES##_##IL##_##BATCH(void* p, int64_t n, const void* c, \
                                              int64_t m, void* s) {            \
    return launch_lab<T, ITEMS, STAGES, IL, BATCH>(p, n, c, m, s);             \
  }
LAB(4, 2, false, true)
LAB(16, 2, false, true)
LAB(16, 3, false, true)
LAB(4, 2, true, true)
LAB(16, 2, true, true)
LAB(16, 2, false, false)
LAB(4, 2, true, false)
LAB(8, 2, false, false)

VARIANT(sweep_gridstride_256, gs_256)
VARIANT(sweep_gridstride_128, gs_128)
VARIANT(sweep_gridstride_1024, gs_1024)
VARIANT(sweep_gridstride_256_cs, gs_256_cs)
VARIANT(sweep_gridstride_256_cg, gs_256_cg)
VARIANT(sweep_gridstride_1024_wt, gs_1024_wt)
VARIANT(sweep_gridstride_1024_stcs, gs_1024_stcs)
VARIANT(sweep_tiles_4_2, lab_4_2_false_true)
VARIANT(sweep_tiles_16_2, lab_16_2_false_true)
VARIANT(sweep_tiles_16_3, lab_16_3_false_true)
VARIANT(sweep_tiles_4_2_il, lab_4_2_true_true)
VARIANT(sweep_tiles_16_2_il, lab_16_2_true_true)
VARIANT(sweep_tiles_16_2_nb, lab_16_2_false_false)
VARIANT(sweep_tiles_4_2_il_nb, lab_4_2_true_false)
VARIANT(sweep_tiles_8_2_nb, lab_8_2_false_false)
VARIANT(diag_read, diag_read)
VARIANT(diag_write, diag_write)
