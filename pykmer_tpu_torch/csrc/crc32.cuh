// zlib's CRC-32 on the card, for the BGZF kernels (inflate.cu checks each
// block's CRC32, deflate.cu writes it): a warp takes a block's bytes in 32
// contiguous pieces, each lane its piece through a byte table in shared
// memory, and the pieces combine in GF(2) as zlib's crc32_combine does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kCrcLanes = 0xFFFFFFFFu;  // a whole warp

// x^(2^k) mod the CRC-32 polynomial, bit-reflected (zlib's x2n_table)
__constant__ uint32_t kX2n[32] = {
    0x40000000, 0x20000000, 0x08000000, 0x00800000, 0x00008000, 0xedb88320, 0xb1e6b092,
    0xa06a2517, 0xed627dae, 0x88d14467, 0xd7bbfe6a, 0xec447f11, 0x8e7ea170, 0x6427800e,
    0x4d47bae0, 0x09fe548f, 0x83852d0f, 0x30362f1a, 0x7b5a9cc3, 0x31fec169, 0x9fec022a,
    0x6c8dedc4, 0x15d6874d, 0x5fde7a4e, 0xbad90e37, 0x2e4e5eef, 0x4eaba214, 0xa8a472c0,
    0x429a969e, 0x148d302a, 0xc40ba6d0, 0xc4e22c3c};

// the byte table of the CRC-32 polynomial, by the block's threads
__device__ void crc_table_fill(uint32_t* table) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t c = uint32_t(i);
    for (int k = 0; k < 8; k++) c = c & 1 ? (c >> 1) ^ 0xEDB88320u : c >> 1;
    table[i] = c;
  }
}

// a(x) b(x) mod the CRC-32 polynomial, bit-reflected (zlib's multmodp)
__device__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t m = 1u << 31, p = 0;
  for (;;) {
    if (a & m) {
      p ^= b;
      if ((a & (m - 1)) == 0) break;
    }
    m >>= 1;
    b = b & 1 ? (b >> 1) ^ 0xEDB88320u : b >> 1;
  }
  return p;
}

// the CRC-32 of A then B, from those of A and B and B's length (zlib's crc32_combine)
__device__ uint32_t crc_combine(uint32_t a, uint32_t b, uint32_t len_b) {
  uint32_t p = 1u << 31;  // x^0
  for (int k = 3; len_b; len_b >>= 1, k++)
    if (len_b & 1) p = multmodp(kX2n[k & 31], p);
  return multmodp(p, a) ^ b;
}

// zlib's crc32 of out[0, n), on the warp's 32 lanes
__device__ uint32_t crc_warp(const uint8_t* out, int64_t n, const uint32_t* table, int lane) {
  __syncwarp();  // every byte of the block is in place
  const int64_t per = (n + 31) / 32;
  const int64_t a = lane * per < n ? lane * per : n, b = a + per < n ? a + per : n;
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = a; i < b; i++) c = table[(c ^ out[i]) & 0xFF] ^ (c >> 8);
  c = ~c;
  uint32_t len = uint32_t(b - a);
  for (int s = 1; s < 32; s <<= 1) {
    const uint32_t oc = __shfl_down_sync(kCrcLanes, c, s);
    const uint32_t ol = __shfl_down_sync(kCrcLanes, len, s);
    if ((lane & (2 * s - 1)) == 0) {
      c = crc_combine(c, oc, ol);
      len += ol;
    }
  }
  return __shfl_sync(kCrcLanes, c, 0);
}

}  // namespace
