// Native host-pipeline kernels for pykmer_tpu.
//
// The reference's only native component is the external htslib `bgzip`
// binary (README.md:26-28); its Python hot loops (per-base FASTA decode,
// indexer.py:45-99) are replaced here by C++ so the host side can keep TPU
// chips fed. Exposed via ctypes (see pykmer_tpu/io/native.py).
//
// Functions:
//   fasta_decode            one-pass FASTA parse: bytes -> base codes +
//                           record table (reference line semantics: per-line
//                           whitespace strip, '>' headers, blank lines
//                           skipped, non-ACGT bytes -> code 4)
//   bgzf_compress_block     one BGZF block (gzip member + BC/BSIZE subfield)
//   bgzf_decompress         multi-member gzip/BGZF inflate (threaded for
//                           BGZF, where block boundaries are explicit)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#include <zlib.h>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

inline bool is_strip_ws(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\r' || c == 0x0b || c == 0x0c;
}

struct Lut {
  uint8_t conv[256];
  Lut() {
    memset(conv, 4, sizeof(conv));
    conv[(int)'A'] = conv[(int)'a'] = 0;
    conv[(int)'C'] = conv[(int)'c'] = 1;
    conv[(int)'G'] = conv[(int)'g'] = 2;
    conv[(int)'T'] = conv[(int)'t'] = 3;
  }
};
const Lut LUT;

// Valid-run state carried across the lines of one record: `run` = current
// count of consecutive valid codes (runs span line boundaries — the decoded
// stream is the concatenation of the record's lines), `ok` set once a run
// reaches K. Fusing this into the decode replaces the separate
// whole-record `finish_rec` pass the MT decoder used to make.
struct RunState {
  long run = 0;
  uint8_t ok = 0;
};

#if defined(__x86_64__)
// AVX2 decode: uppercase via &0xDF (clears only bit 5, so c&0xDF=='A' iff
// c in {'A','a'} — exact), four compares build the code (A0 C1 G2 T3) and
// the validity lane mask; invalid bytes blend to 4. Valid-run tracking
// consumes the movemask: an all-valid block extends the run by 32; mixed
// blocks (rare — N runs) walk the 32 bits scalar.
__attribute__((target("avx2")))
inline long decode_span_avx2(const uint8_t* data, long a, long b, uint8_t* dst,
                             RunState& rs, long k) {
  const __m256i up = _mm256_set1_epi8((char)0xDF);
  const __m256i vA = _mm256_set1_epi8('A'), vC = _mm256_set1_epi8('C');
  const __m256i vG = _mm256_set1_epi8('G'), vT = _mm256_set1_epi8('T');
  const __m256i one = _mm256_set1_epi8(1), two = _mm256_set1_epi8(2);
  const __m256i three = _mm256_set1_epi8(3), four = _mm256_set1_epi8(4);
  long i = a;
  long run = rs.run;
  uint8_t ok = rs.ok;
  for (; i + 32 <= b; i += 32) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(data + i));
    __m256i u = _mm256_and_si256(v, up);
    __m256i eqA = _mm256_cmpeq_epi8(u, vA);
    __m256i eqC = _mm256_cmpeq_epi8(u, vC);
    __m256i eqG = _mm256_cmpeq_epi8(u, vG);
    __m256i eqT = _mm256_cmpeq_epi8(u, vT);
    __m256i valid = _mm256_or_si256(_mm256_or_si256(eqA, eqC),
                                    _mm256_or_si256(eqG, eqT));
    __m256i code = _mm256_or_si256(
        _mm256_or_si256(_mm256_and_si256(eqC, one),
                        _mm256_and_si256(eqG, two)),
        _mm256_and_si256(eqT, three));
    code = _mm256_blendv_epi8(four, code, valid);
    _mm256_storeu_si256((__m256i*)(dst + (i - a)), code);
    uint32_t m = (uint32_t)_mm256_movemask_epi8(valid);
    if (m == 0xFFFFFFFFu) {
      run += 32;
      if (run >= k) ok = 1;
    } else {
      for (int bit = 0; bit < 32; bit++) {
        if (m & (1u << bit)) {
          if (++run >= k) ok = 1;
        } else {
          run = 0;
        }
      }
    }
  }
  for (; i < b; i++) {
    uint8_t c = LUT.conv[data[i]];
    dst[i - a] = c;
    if (c < 4) {
      if (++run >= k) ok = 1;
    } else {
      run = 0;
    }
  }
  rs.run = run;
  rs.ok = ok;
  return b - a;
}

const bool HAVE_AVX2 = __builtin_cpu_supports("avx2");
#endif

// decode_span + fused valid-run tracking (AVX2 fast path when available)
inline long decode_span_rv(const uint8_t* data, long a, long b, uint8_t* dst,
                           RunState& rs, long k) {
#if defined(__x86_64__)
  if (HAVE_AVX2) return decode_span_avx2(data, a, b, dst, rs, k);
#endif
  for (long i = a; i < b; i++) {
    uint8_t c = LUT.conv[data[i]];
    dst[i - a] = c;
    if (c < 4) {
      if (++rs.run >= k) rs.ok = 1;
    } else {
      rs.run = 0;
    }
  }
  return b - a;
}

}  // namespace

extern "C" {

// Parse FASTA bytes. Outputs:
//   codes:           caller-allocated, capacity >= n
//   rec_codes_start: capacity max_recs+1; entry r = offset of record r's
//                    codes; entry [n_recs] = total code count
//   rec_name_off/len: capacity max_recs; name spans into `data`
// Returns number of records, or -1 if max_recs exceeded.
long fasta_decode(const uint8_t* data, long n, uint8_t* codes,
                  long* rec_codes_start, long* rec_name_off,
                  long* rec_name_len, long max_recs) {
  long n_recs = 0;
  long out = 0;
  bool in_record = false;
  long pos = 0;
  while (pos < n) {
    // line span [pos, eol)
    const uint8_t* nl =
        (const uint8_t*)memchr(data + pos, '\n', (size_t)(n - pos));
    long eol = nl ? (long)(nl - data) : n;
    long a = pos, b = eol;
    while (a < b && is_strip_ws(data[a])) a++;
    while (b > a && is_strip_ws(data[b - 1])) b--;
    if (a < b) {
      if (data[a] == '>') {
        if (n_recs >= max_recs) return -1;
        rec_name_off[n_recs] = a + 1;
        rec_name_len[n_recs] = b - (a + 1);
        rec_codes_start[n_recs] = out;
        n_recs++;
        in_record = true;
      } else if (in_record) {
        for (long i = a; i < b; i++) codes[out++] = LUT.conv[data[i]];
      }
      // sequence text before any header is discarded (reference
      // indexer.py:66-79: yield only happens once a name is set)
    }
    pos = eol + 1;
  }
  rec_codes_start[n_recs] = out;
  return n_recs;
}

// Build one BGZF block from payload (<= 65280 bytes).
// Returns total block size, or -1 on error / overflow.
int bgzf_compress_block(const uint8_t* in, int in_len, uint8_t* out,
                        int out_cap, int level) {
  if (in_len <= 0 || in_len > 65280) return -1;
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return -1;
  const int hdr = 18, ftr = 8;
  if (out_cap < 65536) {
    deflateEnd(&zs);
    return -1;
  }
  zs.next_in = (Bytef*)in;
  zs.avail_in = (uInt)in_len;
  zs.next_out = out + hdr;
  zs.avail_out = (uInt)(out_cap - hdr - ftr);
  if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
    deflateEnd(&zs);
    return -1;
  }
  int clen = (int)zs.total_out;
  deflateEnd(&zs);
  int bsize = hdr + clen + ftr;
  if (bsize > 65536) return -1;
  // gzip header with FEXTRA BC subfield
  static const uint8_t magic[12] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0,
                                    0,    0xff, 6,    0};
  memcpy(out, magic, 12);
  out[12] = 'B';
  out[13] = 'C';
  out[14] = 2;
  out[15] = 0;
  uint16_t bs16 = (uint16_t)(bsize - 1);
  memcpy(out + 16, &bs16, 2);
  uint32_t crc = (uint32_t)crc32(0L, in, (uInt)in_len);
  uint32_t isize = (uint32_t)in_len;
  memcpy(out + hdr + clen, &crc, 4);
  memcpy(out + hdr + clen + 4, &isize, 4);
  return bsize;
}

namespace {

// Scan BGZF block starts; returns count or -1 if not BGZF.
long scan_bgzf(const uint8_t* data, long n, std::vector<long>& offs,
               std::vector<long>& bsizes) {
  long pos = 0;
  while (pos + 18 <= n) {
    if (data[pos] != 0x1f || data[pos + 1] != 0x8b || !(data[pos + 3] & 4))
      return -1;
    uint16_t xlen;
    memcpy(&xlen, data + pos + 10, 2);
    long xstart = pos + 12, xend = xstart + xlen;
    if (xend > n) return -1;
    long bsize = -1;
    for (long p = xstart; p + 4 <= xend;) {
      uint8_t si1 = data[p], si2 = data[p + 1];
      uint16_t slen;
      memcpy(&slen, data + p + 2, 2);
      if (si1 == 'B' && si2 == 'C' && slen == 2) {
        uint16_t bs16;
        memcpy(&bs16, data + p + 4, 2);
        bsize = (long)bs16 + 1;
      }
      p += 4 + slen;
    }
    if (bsize < 0 || pos + bsize > n) return -1;
    offs.push_back(pos);
    bsizes.push_back(bsize);
    pos += bsize;
  }
  // a file truncated inside a block header leaves 1..17 trailing bytes:
  // treating it as valid BGZF would silently drop the tail data
  if (pos != n) return -1;
  return (long)offs.size();
}

bool inflate_block(const uint8_t* block, long bsize, uint8_t* out,
                   long out_cap, long* out_len) {
  uint16_t xlen;
  memcpy(&xlen, block + 10, 2);
  const uint8_t* cdata = block + 12 + xlen;
  long clen = bsize - 12 - xlen - 8;
  uint32_t isize;
  memcpy(&isize, block + bsize - 4, 4);
  if ((long)isize > out_cap) return false;
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = (Bytef*)cdata;
  zs.avail_in = (uInt)clen;
  zs.next_out = out;
  zs.avail_out = (uInt)out_cap;
  int rc = inflate(&zs, Z_FINISH);
  *out_len = (long)zs.total_out;
  inflateEnd(&zs);
  return rc == Z_STREAM_END && *out_len == (long)isize;
}

}  // namespace

// Decompress a gzip/BGZF buffer. Returns uncompressed size, -1 on error,
// or -2 if out_cap is too small. BGZF inputs decode block-parallel.
long gzip_decompress(const uint8_t* data, long n, uint8_t* out, long out_cap,
                     int threads) {
  std::vector<long> offs, bsizes;
  if (scan_bgzf(data, n, offs, bsizes) > 0) {
    long nb = (long)offs.size();
    std::vector<long> uofs(nb + 1, 0);
    for (long i = 0; i < nb; i++) {
      uint32_t isize;
      memcpy(&isize, data + offs[i] + bsizes[i] - 4, 4);
      uofs[i + 1] = uofs[i] + (long)isize;
    }
    if (uofs[nb] > out_cap) return -2;
    std::vector<char> ok((size_t)nb, 1);
    int nthreads = threads < 1 ? 1 : threads;
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; t++) {
      pool.emplace_back([&, t]() {
        for (long i = t; i < nb; i += nthreads) {
          long got = 0;
          if (!inflate_block(data + offs[i], bsizes[i], out + uofs[i],
                             uofs[i + 1] - uofs[i], &got))
            ok[(size_t)i] = 0;
        }
      });
    }
    for (auto& th : pool) th.join();
    for (long i = 0; i < nb; i++)
      if (!ok[(size_t)i]) return -1;
    return uofs[nb];
  }
  // generic multi-member gzip. zlib counts in 32-bit uInt, so input and
  // output are fed in <=1 GiB windows (a raw (uInt) cast of a >=4 GiB span
  // silently truncates: output lengths overcount and input bytes vanish).
  const long ZCHUNK = 1L << 30;
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 16) != Z_OK) return -1;
  long in_pos = 0;
  long total = 0;
  while (true) {
    long in_room = n - in_pos;
    if (in_room > ZCHUNK) in_room = ZCHUNK;
    long room = out_cap - total;
    if (room > ZCHUNK) room = ZCHUNK;
    zs.next_in = (Bytef*)data + in_pos;
    zs.avail_in = (uInt)in_room;
    zs.next_out = out + total;
    zs.avail_out = (uInt)room;
    int rc = inflate(&zs, Z_NO_FLUSH);
    in_pos += in_room - (long)zs.avail_in;
    total += room - (long)zs.avail_out;
    if (rc == Z_STREAM_END) {
      if (in_pos >= n) break;
      if (inflateReset2(&zs, 15 + 16) != Z_OK) {
        inflateEnd(&zs);
        return -1;
      }
      continue;
    }
    if (rc == Z_BUF_ERROR) {
      // no forward progress: either the output is genuinely full (caller
      // grows it) or the input ended mid-stream (truncated — error, NOT a
      // grow request: growing would balloon the pool for a corrupt file)
      inflateEnd(&zs);
      return total >= out_cap ? -2 : -1;
    }
    if (rc != Z_OK) {
      inflateEnd(&zs);
      return -1;
    }
    if (total >= out_cap && in_pos < n) {
      inflateEnd(&zs);
      return -2;
    }
  }
  inflateEnd(&zs);
  return total;
}

}  // extern "C"

extern "C" {

// 256-bin value histogram of a byte array (numpy's bincount casts to int64
// and copies; this is a single streaming pass).
void count256(const uint8_t* data, long n, long* out) {
  int threads = n > (16 << 20) ? 8 : 1;
  long per = (n + threads - 1) / threads;
  std::vector<std::vector<long>> partial(threads, std::vector<long>(256, 0));
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    long lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([&, t, lo, hi] {
      long* c = partial[t].data();
      for (long i = lo; i < hi; i++) c[data[i]]++;
    });
  }
  for (auto& th : pool) th.join();
  for (int i = 0; i < 256; i++) out[i] = 0;
  for (auto& p : partial)
    for (int i = 0; i < 256; i++) out[i] += p[i];
}

// Count occurrences of one byte value (the decode wrappers only need the
// '>' count to size the record tables; a full count256 histogram pass runs
// ~1 GB/s where this runs at memory bandwidth).
#if defined(__x86_64__)
__attribute__((target("avx2")))
static long count_byte_avx2(const uint8_t* data, long n, uint8_t value) {
  const __m256i needle = _mm256_set1_epi8((char)value);
  const __m256i zero = _mm256_setzero_si256();
  long total = 0;
  long i = 0;
  const long vec_end = n & ~31L;
  while (i < vec_end) {
    // inner block: <= 255 iterations so 8-bit lane counters cannot wrap
    const long block_end = std::min(vec_end, i + 255L * 32);
    __m256i acc = zero;
    for (; i < block_end; i += 32) {
      __m256i v = _mm256_loadu_si256((const __m256i*)(data + i));
      acc = _mm256_sub_epi8(acc, _mm256_cmpeq_epi8(v, needle));
    }
    __m256i sums = _mm256_sad_epu8(acc, zero);  // 4 x u64 lane sums
    total += _mm256_extract_epi64(sums, 0) + _mm256_extract_epi64(sums, 1) +
             _mm256_extract_epi64(sums, 2) + _mm256_extract_epi64(sums, 3);
  }
  for (; i < n; i++) total += (data[i] == value);
  return total;
}
#endif

long count_byte(const uint8_t* data, long n, int value, int threads) {
  uint8_t v = (uint8_t)value;
  if (threads < 1) threads = 1;
  if (n < (1 << 20)) threads = 1;
  std::vector<long> partial((size_t)threads, 0);
  std::vector<std::thread> pool;
  long per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; t++) {
    long lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([&, t, lo, hi] {
#if defined(__x86_64__)
      if (HAVE_AVX2) {
        partial[t] = count_byte_avx2(data + lo, hi - lo, v);
        return;
      }
#endif
      long c = 0;
      for (long i = lo; i < hi; i++) c += (data[i] == v);
      partial[t] = c;
    });
  }
  for (auto& th : pool) th.join();
  long total = 0;
  for (long p : partial) total += p;
  return total;
}

// Pack a base-code stream (values 0..4) into nibbles, two bases per byte
// (base 2i in the low nibble of byte i) — halves host->device upload bytes;
// the device step unpacks with one shift+mask (see ops/encode.py). n may be
// odd; the final high nibble is padded with 4 (invalid).
void pack_base_nibbles(const uint8_t* codes, long n, uint8_t* out,
                       int threads) {
  long n_bytes = (n + 1) / 2;
  if (threads < 1) threads = 1;
  long per = (n_bytes + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    long lo = t * per, hi = std::min(n_bytes, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      for (long i = lo; i < hi; i++) {
        uint8_t a = codes[2 * i];
        uint8_t b = (2 * i + 1 < n) ? codes[2 * i + 1] : 4;
        out[i] = (uint8_t)(a | (b << 4));
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Compress a whole buffer to BGZF in parallel: blocks of `block_size`
// (<= 65280) compressed by `threads` workers into a scratch grid, then
// compacted into `out` (EOF marker NOT appended — caller's job). Per-block
// compressed sizes land in block_csize[n_blocks]. Returns total output
// bytes, or -1 on error / insufficient out_cap.
long bgzf_compress_buffer(const uint8_t* data, long n, int block_size,
                          int level, int threads, uint8_t* out, long out_cap,
                          long* block_csize) {
  if (block_size <= 0 || block_size > 65280 || n < 0) return -1;
  long n_blocks = (n + block_size - 1) / block_size;
  if (n_blocks == 0) return 0;
  std::unique_ptr<uint8_t[]> scratch(new uint8_t[(size_t)n_blocks * 65536]);
  std::vector<int> sizes((size_t)n_blocks, -1);
  if (threads < 1) threads = 1;
  long per = (n_blocks + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    long lo = t * per, hi = std::min(n_blocks, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([&, lo, hi] {
      for (long b = lo; b < hi; b++) {
        long off = b * (long)block_size;
        int len = (int)std::min<long>(block_size, n - off);
        sizes[b] = bgzf_compress_block(data + off, len,
                                       scratch.get() + b * 65536, 65536,
                                       level);
      }
    });
  }
  for (auto& th : pool) th.join();
  long total = 0;
  for (long b = 0; b < n_blocks; b++) {
    if (sizes[b] < 0) return -1;
    total += sizes[b];
  }
  if (total > out_cap) return -1;
  long ofs = 0;
  for (long b = 0; b < n_blocks; b++) {
    memcpy(out + ofs, scratch.get() + b * 65536, (size_t)sizes[b]);
    block_csize[b] = sizes[b];
    ofs += sizes[b];
  }
  return total;
}

// Pack a base-code stream (0..4) into (2-bit bases, 1-bit validity bitmap):
// base 4j+i -> bits [2i,2i+2) of bases[j] (invalid codes pack as 0);
// validity of base 8j+i -> bit i of mask[j]. n % 8 == 0.
void pack_base_2bit_mask(const uint8_t* codes, long n, uint8_t* bases,
                         uint8_t* mask, int threads) {
  long n_groups = n / 8;  // one mask byte / two base bytes per group
  if (threads < 1) threads = 1;
  long per = (n_groups + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    long lo = t * per, hi = std::min(n_groups, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      for (long g = lo; g < hi; g++) {
        const uint8_t* c = codes + 8 * g;
        uint8_t m = 0, b0 = 0, b1 = 0;
        for (int i = 0; i < 4; i++) {
          uint8_t v = c[i];
          m |= (uint8_t)((v < 4) << i);
          b0 |= (uint8_t)((v & 3) << (2 * i));
        }
        for (int i = 0; i < 4; i++) {
          uint8_t v = c[4 + i];
          m |= (uint8_t)((v < 4) << (4 + i));
          b1 |= (uint8_t)((v & 3) << (2 * i));
        }
        bases[2 * g] = b0;
        bases[2 * g + 1] = b1;
        mask[g] = m;
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Expand bit-packed readback planes (see ops/readback.py) to one byte per
// cell via a 256-entry expansion LUT, threaded over chunks. The numpy
// fallback's strided stores make 4 cache-hostile passes; this is one
// sequential pass at memory bandwidth.
//   unpack_2bit: byte j -> cells 4j..4j+3, cell i in bits [2i, 2i+2)
//   unpack_4bit: byte j -> cells 2j..2j+1, cell i in bits [4i, 4i+4)
void unpack_2bit(const uint8_t* packed, long n_bytes, uint8_t* out,
                 int threads) {
  static uint32_t lut[256];
  static bool init = false;
  if (!init) {
    for (int b = 0; b < 256; b++)
      lut[b] = (uint32_t)(b & 3) | ((uint32_t)((b >> 2) & 3) << 8) |
               ((uint32_t)((b >> 4) & 3) << 16) |
               ((uint32_t)((b >> 6) & 3) << 24);
    init = true;
  }
  if (threads < 1) threads = 1;
  long per = (n_bytes + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    long lo = t * per, hi = std::min(n_bytes, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      uint32_t* dst = reinterpret_cast<uint32_t*>(out) + lo;
      for (long i = lo; i < hi; i++) dst[i - lo] = lut[packed[i]];
    });
  }
  for (auto& th : pool) th.join();
}

// unpack_3bit: 3-byte group g (little-endian 24-bit word) -> cells
// 8g..8g+7, cell i in bits [3i, 3i+3). n_bytes % 3 == 0.
void unpack_3bit(const uint8_t* packed, long n_bytes, uint8_t* out,
                 int threads) {
  long n_groups = n_bytes / 3;
  if (threads < 1) threads = 1;
  long per = (n_groups + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    long lo = t * per, hi = std::min(n_groups, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      for (long g = lo; g < hi; g++) {
        uint32_t w = (uint32_t)packed[3 * g] |
                     ((uint32_t)packed[3 * g + 1] << 8) |
                     ((uint32_t)packed[3 * g + 2] << 16);
        uint8_t* dst = out + 8 * g;
        for (int i = 0; i < 8; i++) dst[i] = (uint8_t)((w >> (3 * i)) & 7);
      }
    });
  }
  for (auto& th : pool) th.join();
}

void unpack_4bit(const uint8_t* packed, long n_bytes, uint8_t* out,
                 int threads) {
  static uint16_t lut[256];
  static bool init = false;
  if (!init) {
    for (int b = 0; b < 256; b++)
      lut[b] = (uint16_t)(b & 15) | ((uint16_t)(b >> 4) << 8);
    init = true;
  }
  if (threads < 1) threads = 1;
  long per = (n_bytes + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    long lo = t * per, hi = std::min(n_bytes, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      uint16_t* dst = reinterpret_cast<uint16_t*>(out) + lo;
      for (long i = lo; i < hi; i++) dst[i - lo] = lut[packed[i]];
    });
  }
  for (auto& th : pool) th.join();
}

// Folded-plane expansion. The device accumulates counts at
// w = min(c, M - c) with M = 4^K - 1 (complementing every base maps code c
// to M - c), so the dense plane is stored in half the space. For odd K
// exactly one of each pair {u, M - u} is canonical (u <= revcomp(u)): both
// would force u == revcomp(u), impossible for odd K. This expands the
// folded half-plane to the full 4^K array: the canonical member of the pair
// gets folded[u], the other 0.
static uint16_t RC16[65536];  // revcomp of 8 2-bit symbols
static const bool RC16_INIT = [] {
  for (uint32_t x = 0; x < 65536; x++) {
    uint32_t r = 0, v = x;
    for (int s = 0; s < 8; s++) {
      r = (r << 2) | ((~v) & 3);
      v >>= 2;
    }
    RC16[x] = (uint16_t)r;
  }
  return true;
}();

static inline uint64_t rc_code(uint64_t v, int bits) {
  uint64_t r = 0;
  int chunks = (bits + 15) / 16;
  for (int i = 0; i < chunks; i++) r = (r << 16) | RC16[(v >> (16 * i)) & 0xFFFF];
  return r >> (16 * chunks - bits);
}

void unfold_canonical(const uint8_t* folded, uint8_t* out, int k,
                      int threads) {
  (void)RC16_INIT;
  const int bits = 2 * k;
  const uint64_t half = 1ULL << (bits - 1);
  const uint64_t m = (1ULL << bits) - 1;
  if (threads < 1) threads = 1;
  uint64_t per = (half + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    uint64_t lo = t * per, hi = std::min(half, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      for (uint64_t u = lo; u < hi; u++) {
        uint8_t v = folded[u];
        bool canon = u <= rc_code(u, bits);
        out[u] = canon ? v : 0;
        out[m - u] = canon ? 0 : v;
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Slice variant for the streaming fetch→unfold pipeline: expand folded
// indices [lo, lo + n) (values given in `folded_slice`) into the FULL output
// array `out` (base pointer of the 4^K plane). Single-threaded: callers run
// one slice per fetch worker, so parallelism comes from the worker pool.
void unfold_canonical_range(const uint8_t* folded_slice, uint8_t* out, int k,
                            uint64_t lo, uint64_t n) {
  (void)RC16_INIT;
  const int bits = 2 * k;
  const uint64_t m = (1ULL << bits) - 1;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t u = lo + i;
    uint8_t v = folded_slice[i];
    bool canon = u <= rc_code(u, bits);
    out[u] = canon ? v : 0;
    out[m - u] = canon ? 0 : v;
  }
}

// Sparse token-stream decode (ops/readback.py sparse mode). One byte per
// nonzero folded cell: token t < 252 encodes (gap = t/3 zeros skipped,
// value class v = t%3 + 1, v == 3 marking ">= 3" for the escape patch);
// t >= 252 encodes v = t - 251 with the cell's absolute in-segment position
// taken from the int32 side stream (gaps > 83). The decoder memsets the
// segment's two unfolded file ranges (primary at seg_base, mirror at
// 4^K - seg_base - seg_len) and writes only the nonzeros — ~10x less memory
// traffic than the fixed-width unpack+unfold at lambda ~0.1. The canonical
// test short-circuits on the top 16 bits (rc(u)'s top 16 bits are RC16 of
// u's low 16), falling back to the full reverse complement only on ties.
// Returns side entries consumed, or -1 on a malformed stream.
extern "C" long sparse_decode_segment(const uint8_t* tokens, long n_tok,
                                      const int32_t* side, long n_side,
                                      uint8_t* out, int k, uint64_t seg_base,
                                      uint64_t seg_len, long* counts) {
  (void)RC16_INIT;
  const int bits = 2 * k;
  const uint64_t full = 1ULL << bits;
  const uint64_t m = full - 1;
  if (seg_base + seg_len > full / 2) return -1;
  memset(out + seg_base, 0, (size_t)seg_len);
  memset(out + (full - seg_base - seg_len), 0, (size_t)seg_len);
  static uint8_t GAP_LUT[252], VAL_LUT[252];
  static const bool LUT_INIT = [] {
    for (int t = 0; t < 252; t++) {
      GAP_LUT[t] = (uint8_t)(t / 3);
      VAL_LUT[t] = (uint8_t)(t % 3 + 1);
    }
    return true;
  }();
  (void)LUT_INIT;
  long c_val[4] = {0, 0, 0, 0};
  int64_t p = -1;
  long si = 0;
  for (long i = 0; i < n_tok; i++) {
    uint8_t t = tokens[i];
    uint8_t v;
    if (t >= 252) {
      if (si >= n_side || t == 255) return -1;
      v = (uint8_t)(t - 251);
      p = side[si++];
    } else {
      v = VAL_LUT[t];
      p += 1 + GAP_LUT[t];
    }
    if ((uint64_t)p >= seg_len) return -1;
    uint64_t u = seg_base + (uint64_t)p;
    bool canon;
    if (bits > 16) {
      uint64_t hi_u = u >> (bits - 16);
      uint64_t hi_rc = RC16[u & 0xFFFF];
      canon = hi_u != hi_rc ? hi_u < hi_rc : u <= rc_code(u, bits);
    } else {
      canon = u <= rc_code(u, bits);
    }
    out[canon ? u : m - u] = v;
    c_val[v]++;
  }
  counts[1] += c_val[1];
  counts[2] += c_val[2];
  counts[3] += c_val[3];
  return si;
}

// Piece variant of sparse_decode_segment for the arena-free readback: the
// segment's two unfolded file ranges land in standalone buffers — `primary`
// (file offset seg_base) and `mirror` (file offset 4^K - seg_base - seg_len,
// ascending file order) — so no 4^K host arena ever exists (17 GiB at K=17;
// MAP_POPULATE of that arena costs ~60 s on the target guest). Token/side
// semantics identical to sparse_decode_segment.
extern "C" long sparse_decode_segment_piece(
    const uint8_t* tokens, long n_tok, const int32_t* side, long n_side,
    uint8_t* primary, uint8_t* mirror, int k, uint64_t seg_base,
    uint64_t seg_len, long* counts) {
  (void)RC16_INIT;
  const int bits = 2 * k;
  const uint64_t full = 1ULL << bits;
  if (seg_base + seg_len > full / 2) return -1;
  memset(primary, 0, (size_t)seg_len);
  memset(mirror, 0, (size_t)seg_len);
  long c_val[4] = {0, 0, 0, 0};
  int64_t p = -1;
  long si = 0;
  for (long i = 0; i < n_tok; i++) {
    uint8_t t = tokens[i];
    uint8_t v;
    if (t >= 252) {
      if (si >= n_side || t == 255) return -1;
      v = (uint8_t)(t - 251);
      p = side[si++];
    } else {
      v = (uint8_t)(t % 3 + 1);
      p += 1 + t / 3;
    }
    if ((uint64_t)p >= seg_len) return -1;
    uint64_t u = seg_base + (uint64_t)p;
    bool canon;
    if (bits > 16) {
      uint64_t hi_u = u >> (bits - 16);
      uint64_t hi_rc = RC16[u & 0xFFFF];
      canon = hi_u != hi_rc ? hi_u < hi_rc : u <= rc_code(u, bits);
    } else {
      canon = u <= rc_code(u, bits);
    }
    // mirror cell of u sits at file offset full-1-u; relative to the mirror
    // buffer base (full - seg_base - seg_len) that is seg_len - 1 - p
    if (canon)
      primary[p] = v;
    else
      mirror[seg_len - 1 - (uint64_t)p] = v;
    c_val[v]++;
  }
  counts[1] += c_val[1];
  counts[2] += c_val[2];
  counts[3] += c_val[3];
  return si;
}

// Piece variant for the multi-host sharded writer: expand folded cells
// [g0, g0 + n) into TWO standalone buffers — `primary` (belongs at file
// offset g0) and `mirror` (belongs at 4^K - g0 - n) — so no host ever
// materialises the full 4^K plane (index/multihost sharded write).
void unfold_canonical_piece(const uint8_t* folded_piece, uint8_t* primary,
                            uint8_t* mirror, int k, uint64_t g0, uint64_t n,
                            int threads) {
  (void)RC16_INIT;
  const int bits = 2 * k;
  if (threads < 1) threads = 1;
  uint64_t per = (n + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    uint64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      for (uint64_t i = lo; i < hi; i++) {
        uint64_t u = g0 + i;
        uint8_t v = folded_piece[i];
        bool canon = u <= rc_code(u, bits);
        primary[i] = canon ? v : 0;
        // u's mirror lands at file offset m - u; relative to the mirror
        // buffer's base (4^K - g0 - n) that is index n - 1 - i
        mirror[n - 1 - i] = canon ? 0 : v;
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C" (template below needs C++ linkage)

// Fused readback tail: one pass over a bit-packed folded-plane slice that
// (a) unfolds each cell into the full 4^K output plane, (b) accumulates the
// 256-bin value histogram, and (c) records local indices of escape-marker
// cells (value == 2^W - 1). Replaces the separate unpack -> flatnonzero ->
// counts -> unfold passes (saves ~1.6 GB of memory traffic per GiB-scale
// readback on the 2-core host). Single-threaded per call: the fetch pipeline
// runs one slice per worker. Returns the total escape count; only the first
// `esc_cap` indices are stored (caller re-runs with a larger buffer on
// overflow — escapes are <1% in the auto-picked pack mode).
template <int W>
static long unpack_unfold_impl(const uint8_t* packed, long n_bytes,
                               uint8_t* out, int k, uint64_t lo,
                               long* counts, uint32_t* esc, long esc_cap) {
  (void)RC16_INIT;
  const int bits = 2 * k;
  const uint64_t m = (1ULL << bits) - 1;
  const uint8_t marker = (uint8_t)((1 << W) - 1);
  long n_esc = 0;
  long local_counts[256] = {0};
  uint64_t idx = 0;
  auto emit = [&](uint8_t v) {
    local_counts[v]++;
    if (v == marker) {
      if (n_esc < esc_cap) esc[n_esc] = (uint32_t)idx;
      n_esc++;  // total count even past esc_cap (caller detects overflow)
    }
    uint64_t u = lo + idx;
    bool canon = u <= rc_code(u, bits);
    out[u] = canon ? v : 0;
    out[m - u] = canon ? 0 : v;
    idx++;
  };
  if (W == 2) {
    for (long p = 0; p < n_bytes; p++) {
      uint8_t b = packed[p];
      emit(b & 3); emit((b >> 2) & 3); emit((b >> 4) & 3); emit(b >> 6);
    }
  } else if (W == 3) {
    for (long g = 0; g < n_bytes / 3; g++) {
      uint32_t w = (uint32_t)packed[3 * g] | ((uint32_t)packed[3 * g + 1] << 8) |
                   ((uint32_t)packed[3 * g + 2] << 16);
      for (int i = 0; i < 8; i++) emit((uint8_t)((w >> (3 * i)) & 7));
    }
  } else {  // W == 4
    for (long p = 0; p < n_bytes; p++) {
      uint8_t b = packed[p];
      emit(b & 15); emit(b >> 4);
    }
  }
  for (int v = 0; v < 256; v++) counts[v] += local_counts[v];
  return n_esc;
}

#if defined(__x86_64__)
#include <immintrin.h>

// BMI2 fast path: pdep expands 8 packed W-bit fields into the 8 bytes of a
// uint64 in one instruction (cell i lands in byte i — little-endian field
// order matches the pack layout for W = 2/3/4). The per-cell canonical test
// is replaced by a precomputed per-K bitmask (build_canon_bits below): bit u
// of `canon_bits` = (u <= revcomp(u)), expanded 8-at-a-time to byte select
// masks with another pdep. ~2.5 ops/cell vs ~12 for the scalar path.
template <int W>
__attribute__((target("bmi2")))
static long unpack_unfold_bmi2(const uint8_t* packed, long n_bytes,
                               uint8_t* out, int k, uint64_t lo,
                               long* counts, uint32_t* esc, long esc_cap,
                               const uint8_t* canon_bits) {
  const int bits = 2 * k;
  const uint64_t m = (1ULL << bits) - 1;
  const uint64_t dep_mask = W == 2 ? 0x0303030303030303ULL
                          : W == 3 ? 0x0707070707070707ULL
                                   : 0x0F0F0F0F0F0F0F0FULL;
  const uint64_t marker8 = W == 2 ? 0x0303030303030303ULL
                         : W == 3 ? 0x0707070707070707ULL
                                  : 0x0F0F0F0F0F0F0F0FULL;
  const long n_groups = W == 2 ? n_bytes / 2 : W == 3 ? n_bytes / 3 : n_bytes / 4;
  long n_esc = 0;
  // 4 interleaved tables break the store-forwarding dependency chain of
  // repeated same-bin increments (classic histogram trick)
  long c4[4][16] = {{0}};
  uint64_t u0 = lo;        // first cell of the current group
  uint64_t mu = m - lo;    // mirror of the first cell
  for (long g = 0; g < n_groups; g++, u0 += 8, mu -= 8) {
    uint64_t w;
    if (W == 2) {
      uint16_t h;
      memcpy(&h, packed + 2 * g, 2);
      w = h;
    } else if (W == 3) {
      uint32_t h = (uint32_t)packed[3 * g] |
                   ((uint32_t)packed[3 * g + 1] << 8) |
                   ((uint32_t)packed[3 * g + 2] << 16);
      w = h;
    } else {
      uint32_t h;
      memcpy(&h, packed + 4 * g, 4);
      w = h;
    }
    const uint64_t cells = _pdep_u64(w, dep_mask);
    // 16-bin histogram (values 0..2^W-1), 4 interleaved tables
    c4[0][cells & 15]++;
    c4[1][(cells >> 8) & 15]++;
    c4[2][(cells >> 16) & 15]++;
    c4[3][(cells >> 24) & 15]++;
    c4[0][(cells >> 32) & 15]++;
    c4[1][(cells >> 40) & 15]++;
    c4[2][(cells >> 48) & 15]++;
    c4[3][(cells >> 56) & 15]++;
    // escape-marker bytes: exact zero-byte detect on cells ^ marker (the
    // classic (z-0x01..)&~z&0x80.. variant false-positives on cross-byte
    // borrows; this per-7-bit add form has no carries between bytes)
    uint64_t z = cells ^ marker8;
    uint64_t escm = ~(((z & 0x7F7F7F7F7F7F7F7FULL) + 0x7F7F7F7F7F7F7F7FULL)
                      | z | 0x7F7F7F7F7F7F7F7FULL);
    while (escm) {
      int b = __builtin_ctzll(escm) >> 3;
      if (n_esc < esc_cap) esc[n_esc] = (uint32_t)(u0 - lo + b);
      n_esc++;
      escm &= escm - 1;
    }
    // canonical byte-select mask from 8 precomputed bits (lo % 8 == 0 is
    // asserted by the wrapper, so each group reads exactly one mask byte)
    const uint8_t cb = canon_bits[u0 >> 3];
    const uint64_t sel = _pdep_u64(cb, 0x0101010101010101ULL) * 0xFF;
    const uint64_t fwd = cells & sel;
    memcpy(out + u0, &fwd, 8);
    const uint64_t rev = __builtin_bswap64(cells & ~sel);
    memcpy(out + mu - 7, &rev, 8);
  }
  for (int v = 0; v < 16; v++)
    counts[v] += c4[0][v] + c4[1][v] + c4[2][v] + c4[3][v];
  return n_esc;
}

// bit u = (u <= revcomp_code(u)) for u in [0, 2^(2k-1)): the per-K canonical
// selector consumed by unpack_unfold_bmi2. Built once per process per K
// (multithreaded, byte-aligned split).
void build_canon_bits_impl(int k, uint8_t* bits_out, int threads) {
  (void)RC16_INIT;
  const int bits = 2 * k;
  const uint64_t half = 1ULL << (bits - 1);
  const uint64_t n_bytes = (half + 7) / 8;
  if (threads < 1) threads = 1;
  uint64_t per = (n_bytes + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    uint64_t blo = t * per, bhi = std::min(n_bytes, blo + per);
    if (blo >= bhi) break;
    pool.emplace_back([=] {
      for (uint64_t b = blo; b < bhi; b++) {
        uint8_t acc = 0;
        uint64_t base = b * 8;
        for (int i = 0; i < 8 && base + i < half; i++) {
          uint64_t u = base + i;
          if (u <= rc_code(u, bits)) acc |= (uint8_t)(1u << i);
        }
        bits_out[b] = acc;
      }
    });
  }
  for (auto& th : pool) th.join();
}
#endif  // __x86_64__

extern "C" {

long unpack_unfold_range(const uint8_t* packed, long n_bytes, int width,
                         uint8_t* out, int k, uint64_t lo, long* counts,
                         uint32_t* esc, long esc_cap) {
  if (width == 2)
    return unpack_unfold_impl<2>(packed, n_bytes, out, k, lo, counts, esc, esc_cap);
  if (width == 3)
    return unpack_unfold_impl<3>(packed, n_bytes, out, k, lo, counts, esc, esc_cap);
  if (width == 4)
    return unpack_unfold_impl<4>(packed, n_bytes, out, k, lo, counts, esc, esc_cap);
  return -1;
}

// Variant taking the precomputed canonical bitmask (build_canon_bits):
// dispatches to the BMI2 pdep fast path when the CPU supports it, else the
// scalar template. Requires lo % 8 == 0 (slice bounds are row-aligned).
long unpack_unfold_range_fast(const uint8_t* packed, long n_bytes, int width,
                              uint8_t* out, int k, uint64_t lo, long* counts,
                              uint32_t* esc, long esc_cap,
                              const uint8_t* canon_bits) {
#if defined(__x86_64__)
  if (canon_bits != nullptr && (lo % 8) == 0 &&
      __builtin_cpu_supports("bmi2")) {
    if (width == 2)
      return unpack_unfold_bmi2<2>(packed, n_bytes, out, k, lo, counts, esc,
                                   esc_cap, canon_bits);
    if (width == 3)
      return unpack_unfold_bmi2<3>(packed, n_bytes, out, k, lo, counts, esc,
                                   esc_cap, canon_bits);
    if (width == 4)
      return unpack_unfold_bmi2<4>(packed, n_bytes, out, k, lo, counts, esc,
                                   esc_cap, canon_bits);
    return -1;
  }
#endif
  return unpack_unfold_range(packed, n_bytes, width, out, k, lo, counts, esc,
                             esc_cap);
}

void build_canon_bits(int k, uint8_t* bits_out, int threads) {
#if defined(__x86_64__)
  build_canon_bits_impl(k, bits_out, threads);
#else
  (void)RC16_INIT;
  const int bits = 2 * k;
  const uint64_t half = 1ULL << (bits - 1);
  for (uint64_t b = 0; b < (half + 7) / 8; b++) {
    uint8_t acc = 0;
    for (int i = 0; i < 8 && b * 8 + i < half; i++)
      if (b * 8 + i <= rc_code(b * 8 + i, bits)) acc |= (uint8_t)(1u << i);
    bits_out[b] = acc;
  }
  (void)threads;
#endif
}

}  // extern "C"

extern "C" {

// FASTA parse directly into the indexer's separator-joined stream:
// records' codes concatenated with (K-1) invalid bases (code 4) between
// them, so no k-mer window spans two records. Also reports per-record
// sequence length and whether the record contains >= K consecutive valid
// bases (i.e. contributes at least one k-mer).
// Returns n_recs, or -1 if max_recs exceeded. Caller allocates:
//   codes:    capacity >= n + (max_recs)*(k-1)
//   *codes_len_out: final stream length
long fasta_decode_joined(const uint8_t* data, long n, long k, uint8_t* codes,
                         long* rec_seq_len, uint8_t* rec_has_valid,
                         long* rec_name_off, long* rec_name_len,
                         long max_recs, long* codes_len_out) {
  long n_recs = 0;
  long out = 0;
  long run = 0;          // current valid-base run in this record
  long pos = 0;
  while (pos < n) {
    const uint8_t* nl =
        (const uint8_t*)memchr(data + pos, '\n', (size_t)(n - pos));
    long eol = nl ? (long)(nl - data) : n;
    long a = pos, b = eol;
    while (a < b && is_strip_ws(data[a])) a++;
    while (b > a && is_strip_ws(data[b - 1])) b--;
    if (a < b) {
      if (data[a] == '>') {
        if (n_recs >= max_recs) return -1;
        if (n_recs > 0) {
          for (long s = 0; s < k - 1; s++) codes[out++] = 4;
        }
        rec_name_off[n_recs] = a + 1;
        rec_name_len[n_recs] = b - (a + 1);
        rec_seq_len[n_recs] = 0;
        rec_has_valid[n_recs] = 0;
        n_recs++;
        run = 0;
      } else if (n_recs > 0) {
        long r = n_recs - 1;
        rec_seq_len[r] += b - a;
        for (long i = a; i < b; i++) {
          uint8_t c = LUT.conv[data[i]];
          codes[out++] = c;
          if (c < 4) {
            if (++run >= k) rec_has_valid[r] = 1;
          } else {
            run = 0;
          }
        }
      }
    }
    pos = eol + 1;
  }
  *codes_len_out = out;
  return n_recs;
}

// Threaded variant of fasta_decode_joined: same outputs, bit-identical.
//   phase 1 (serial, scan-only): line starts of '>' headers (a line is a
//            header iff its first non-strippable-ws byte is '>');
//   phase 2 (parallel): each thread decodes a contiguous range of records
//            into a private buffer with the exact serial per-line semantics;
//   phase 3 (parallel): prefix-sum buffer lengths, memcpy into `codes`.
// `scratch`: caller-provided arena of >= n + max_recs*(k-1) bytes for the
// per-thread staging buffers (malloc'd memory would pay this environment's
// ~370us/4K first-touch faults; the caller pre-populates the arena instead).
long fasta_decode_joined_mt(const uint8_t* data, long n, long k,
                            uint8_t* codes, long* rec_seq_len,
                            uint8_t* rec_has_valid, long* rec_name_off,
                            long* rec_name_len, long max_recs,
                            long* codes_len_out, int threads,
                            uint8_t* scratch) {
  if (threads <= 1 || n < (1 << 20))
    return fasta_decode_joined(data, n, k, codes, rec_seq_len, rec_has_valid,
                               rec_name_off, rec_name_len, max_recs,
                               codes_len_out);

  // phase 1: header-line starts, scanned in parallel byte ranges aligned to
  // line starts (each range begins at the first line start at/after its
  // nominal boundary, so every line is scanned exactly once)
  int scan_threads = std::min<long>(threads, std::max<long>(1, n >> 22));
  std::vector<std::vector<long>> found((size_t)scan_threads);
  {
    std::vector<long> range_lo((size_t)scan_threads + 1, 0);
    long per_b = (n + scan_threads - 1) / scan_threads;
    for (int t = 1; t < scan_threads; t++) {
      long p = std::min(n, (long)t * per_b);
      const uint8_t* nl = (const uint8_t*)memchr(data + p, '\n', (size_t)(n - p));
      range_lo[t] = nl ? (long)(nl - data) + 1 : n;
    }
    range_lo[scan_threads] = n;
    std::vector<std::thread> pool;
    for (int t = 0; t < scan_threads; t++) {
      pool.emplace_back([&, t] {
        long pos = range_lo[t], hi = range_lo[t + 1];
        auto& out = found[t];
        while (pos < hi) {
          const uint8_t* nl =
              (const uint8_t*)memchr(data + pos, '\n', (size_t)(n - pos));
          long eol = nl ? (long)(nl - data) : n;
          long a = pos;
          while (a < eol && is_strip_ws(data[a])) a++;
          if (a < eol && data[a] == '>') out.push_back(pos);
          pos = eol + 1;
        }
      });
    }
    for (auto& th : pool) th.join();
  }
  std::vector<long> header_start;
  for (auto& f : found) header_start.insert(header_start.end(), f.begin(), f.end());
  long n_recs = (long)header_start.size();
  if (n_recs > max_recs) return -1;
  if (n_recs == 0) {
    *codes_len_out = 0;
    return 0;
  }

  if (threads > (int)n_recs) threads = (int)n_recs;
  long per = (n_recs + threads - 1) / threads;
  struct Buf {
    uint8_t* p = nullptr;
    long len = 0;
  };
  std::vector<Buf> bufs(threads);
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    long r0 = t * per, r1 = std::min(n_recs, r0 + per);
    if (r0 >= r1) break;
    pool.emplace_back([&, t, r0, r1] {
      long byte_lo = header_start[r0];
      long byte_hi = (r1 < n_recs) ? header_start[r1] : n;
      auto& buf = bufs[t];
      // disjoint arena region: output never exceeds the input byte span
      // plus one (k-1) separator per record in the range
      buf.p = scratch + byte_lo + (size_t)r0 * (k - 1);
      uint8_t* dst = buf.p;
      long len = 0;
      long rec = r0 - 1;  // current record index (r0's header comes first)
      long pos = byte_lo;
      RunState rs;  // fused valid-run tracking (>= k consecutive codes < 4,
                    // runs span line boundaries within one record)
      auto finish_rec = [&] {
        if (rec >= r0) rec_has_valid[rec] = rs.ok;
      };
      while (pos < byte_hi) {
        const uint8_t* nl = (const uint8_t*)memchr(data + pos, '\n',
                                                   (size_t)(byte_hi - pos));
        long eol = nl ? (long)(nl - data) : byte_hi;
        long a = pos, b = eol;
        while (a < b && is_strip_ws(data[a])) a++;
        while (b > a && is_strip_ws(data[b - 1])) b--;
        if (a < b) {
          if (data[a] == '>') {
            finish_rec();
            rec++;
            if (rec > r0) {  // separator between this thread's own records;
              memset(dst + len, 4, (size_t)(k - 1));  // the one before rec r0
              len += k - 1;                           // is the stitcher's
            }
            rec_name_off[rec] = a + 1;
            rec_name_len[rec] = b - (a + 1);
            rec_seq_len[rec] = 0;
            rs = RunState();
          } else if (rec >= r0) {
            rec_seq_len[rec] += b - a;
            len += decode_span_rv(data, a, b, dst + len, rs, k);
          }
        }
        pos = eol + 1;
      }
      finish_rec();
      buf.len = len;
    });
  }
  for (auto& th : pool) th.join();

  // stitch: sep(k-1) before every thread-chunk except the first (each
  // thread already emitted separators between its own records)
  int nbufs = (int)pool.size();
  std::vector<long> offset(nbufs + 1, 0);
  for (int t = 0; t < nbufs; t++)
    offset[t + 1] = offset[t] + bufs[t].len + (t + 1 < nbufs ? (k - 1) : 0);
  if (scratch == codes) {
    // in-place compaction: every arena region starts at or after its final
    // destination (dest offset[t] = sum of decoded lens + separators, which
    // never exceeds the input byte prefix + r0*(k-1) = arena start), so a
    // sequential increasing-t memmove never clobbers an uncopied region
    for (int t = 0; t < nbufs; t++) {
      uint8_t* dst = codes + offset[t];
      memmove(dst, bufs[t].p, (size_t)bufs[t].len);
      if (t + 1 < nbufs) memset(dst + bufs[t].len, 4, (size_t)(k - 1));
    }
  } else {
    std::vector<std::thread> pool2;
    for (int t = 0; t < nbufs; t++) {
      pool2.emplace_back([&, t] {
        uint8_t* dst = codes + offset[t];
        memcpy(dst, bufs[t].p, (size_t)bufs[t].len);
        if (t + 1 < nbufs) memset(dst + bufs[t].len, 4, (size_t)(k - 1));
      });
    }
    for (auto& th : pool2) th.join();
  }
  *codes_len_out = offset[nbufs];
  return n_recs;
}

// Fused decode -> bit-packed upload planes: same record semantics as
// fasta_decode_joined_mt, but the joined stream is emitted directly as the
// device upload format (2-bit bases, byte j bits [2i,2i+2) = base 4j+i;
// validity bitmap, byte j bit i = base 8j+i valid) — the indexer uploads
// these planes verbatim, so the separate whole-stream/per-chunk pack pass
// disappears from the dispatch window. The stream is byte-identical to
// fasta_decode_joined_mt's (it IS that stream, packed by parallel
// 8-code-aligned ranges of the compacted result). Returns n_recs or -1 on
// max_recs overflow; *codes_len_out = total codes (callers size chunk
// framing off it; planes are invalid-padded to the next byte edge).
#if defined(__x86_64__)
__attribute__((target("bmi2")))
static long pack_span_bmi2(const uint8_t* src, long n, uint8_t* bases,
                           uint8_t* mask, long code_off) {
  long i = 0;
  long b2 = code_off / 4, mb = code_off / 8;
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    memcpy(&w, src + i, 8);
    uint16_t b = (uint16_t)_pext_u64(w, 0x0303030303030303ULL);
    memcpy(bases + b2, &b, 2);
    // valid = byte < 4 = (byte & ~3) == 0: exact zero-byte detect
    uint64_t z = w & 0xFCFCFCFCFCFCFCFCULL;
    uint64_t vm = ~(((z & 0x7F7F7F7F7F7F7F7FULL) + 0x7F7F7F7F7F7F7F7FULL)
                    | z | 0x7F7F7F7F7F7F7F7FULL);
    mask[mb] = (uint8_t)_pext_u64(vm, 0x8080808080808080ULL);
    b2 += 2;
    mb += 1;
  }
  return i;
}
#endif

#if defined(__x86_64__)
// AVX2 pack: 32 codes -> 8 base-bytes + 4 mask-bytes per iteration.
// 2-bit pack via two multiply-adds (byte = c0 + 4c1 + 16c2 + 64c3; invalid
// code 4 & 3 = 0, matching the scalar "invalid packs as base 0" rule);
// validity bitmap via one compare + movemask. Requires code_off % 8 == 0.
__attribute__((target("avx2")))
static long pack_span_avx2(const uint8_t* src, long n, uint8_t* bases,
                           uint8_t* mask, long code_off) {
  long i = 0;
  long b2 = code_off / 4, mb = code_off / 8;
  const __m256i three = _mm256_set1_epi8(3);
  const __m256i four = _mm256_set1_epi8(4);
  const __m256i mul1 = _mm256_set1_epi16(0x0401);    // pairs: c0 + 4*c1
  const __m256i mul2 = _mm256_set1_epi32(0x00100001);  // quads: w0 + 16*w1
  const __m256i shuf = _mm256_setr_epi8(
      0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
      0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1);
  for (; i + 32 <= n; i += 32) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(src + i));
    __m256i q = _mm256_and_si256(v, three);
    __m256i w16 = _mm256_maddubs_epi16(q, mul1);
    __m256i w32 = _mm256_madd_epi16(w16, mul2);
    __m256i packed = _mm256_shuffle_epi8(w32, shuf);
    uint32_t blo = (uint32_t)_mm256_extract_epi32(packed, 0);
    uint32_t bhi = (uint32_t)_mm256_extract_epi32(packed, 4);
    memcpy(bases + b2, &blo, 4);
    memcpy(bases + b2 + 4, &bhi, 4);
    uint32_t vm = ~(uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, four));
    memcpy(mask + mb, &vm, 4);
    b2 += 8;
    mb += 4;
  }
  return i;
}
#endif

static inline void pack_span(const uint8_t* src, long n, uint8_t* bases,
                             uint8_t* mask, long code_off) {
  // code_off is the global code index of src[0]; caller guarantees the
  // span [code_off, code_off + n) is not shared with another thread except
  // at byte granularity boundaries it owns exclusively.
  long i = 0;
#if defined(__x86_64__)
  if (HAVE_AVX2 && (code_off % 8) == 0) {
    i = pack_span_avx2(src, n, bases, mask, code_off);
    if (i < n && __builtin_cpu_supports("bmi2"))
      i += pack_span_bmi2(src + i, n - i, bases, mask, code_off + i);
  } else if (__builtin_cpu_supports("bmi2") && (code_off % 8) == 0) {
    i = pack_span_bmi2(src, n, bases, mask, code_off);
  }
#endif
  for (; i < n; i++) {
    uint8_t c = src[i];
    long g = code_off + i;
    uint8_t v = (uint8_t)(c < 4);
    uint8_t b = (uint8_t)(c & 3 & (0 - v));  // invalid packs as base 0
    bases[g >> 2] = (uint8_t)((bases[g >> 2] & ~(3u << ((g & 3) * 2)))
                              | (b << ((g & 3) * 2)));
    mask[g >> 3] = (uint8_t)((mask[g >> 3] & ~(1u << (g & 7)))
                             | (v << (g & 7)));
  }
}

long fasta_decode_joined_packed_mt(const uint8_t* data, long n, long k,
                                   uint8_t* bases, uint8_t* mask,
                                   long* rec_seq_len, uint8_t* rec_has_valid,
                                   long* rec_name_off, long* rec_name_len,
                                   long max_recs, long* codes_len_out,
                                   int threads, uint8_t* scratch) {
  // phase 1+2: reuse the codes-stream MT decode into the scratch arena,
  // skipping its stitch (scratch != codes path would copy; we pack instead).
  // To avoid duplicating its internals, run it with codes == scratch but
  // capture the per-thread layout by re-deriving it: simplest correct
  // approach — decode into scratch via the existing function, then pack the
  // compacted stream in parallel byte-aligned ranges.
  long n_recs = fasta_decode_joined_mt(data, n, k, scratch, rec_seq_len,
                                       rec_has_valid, rec_name_off,
                                       rec_name_len, max_recs, codes_len_out,
                                       threads, scratch);
  if (n_recs <= 0) return n_recs;
  long len = *codes_len_out;
  long pad = (8 - (len & 7)) & 7;
  memset(scratch + len, 4, (size_t)pad);  // invalid tail to the byte edge
  long total = len + pad;
  if (threads < 1) threads = 1;
  long per = ((total / 8 + threads - 1) / threads) * 8;  // 8-code aligned
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    long lo = t * per, hi = std::min(total, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      pack_span(scratch + lo, hi - lo, bases, mask, lo);
    });
  }
  for (auto& th : pool) th.join();
  return n_recs;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Small-N merge host fast path (reference Header.calculate_distance,
// tools.py:439-493): per streamed block, each sample's bytes reduce to a
// 1-bit validity plane (count within [lo, hi]); pair contingencies are then
// AND+popcount passes over the bit planes. For small N this beats the device
// engine's upload round-trip (and needs no TPU at all — a cold CLI merge
// skips JAX entirely); the device MXU path still wins at large N.

#if defined(__x86_64__)
// bit i of bits[j] = (data[8j+i] in [lo, hi]); little-endian bit order
// (movemask lane order) — popcount consumers are order-agnostic, but both
// sides of every AND must come from this same packer.
__attribute__((target("avx2")))
static void pack_valid_bits_avx2(const uint8_t* data, long n, uint8_t lo_v,
                                 uint8_t hi_v, uint8_t* bits) {
  const __m256i vlo = _mm256_set1_epi8((char)lo_v);
  const __m256i vhi = _mm256_set1_epi8((char)hi_v);
  long i = 0;
  for (; i + 32 <= n; i += 32) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(data + i));
    __m256i ge = _mm256_cmpeq_epi8(_mm256_max_epu8(v, vlo), v);
    __m256i le = _mm256_cmpeq_epi8(_mm256_min_epu8(v, vhi), v);
    uint32_t m = (uint32_t)_mm256_movemask_epi8(_mm256_and_si256(ge, le));
    memcpy(bits + (i >> 3), &m, 4);
  }
  for (; i < n; i += 8) {
    uint8_t m = 0;
    for (int b = 0; b < 8 && i + b < n; b++) {
      uint8_t c = data[i + b];
      m |= (uint8_t)((c >= lo_v && c <= hi_v) << b);
    }
    bits[i >> 3] = m;
  }
}
#endif

extern "C" {

// Pack byte counts into a validity bitmap: bit i of bits[j] =
// (data[8j+i] in [lo, hi]). n need not be a multiple of 8; the final
// partial byte is zero-padded (invalid).
void pack_valid_bits(const uint8_t* data, long n, int lo_v, int hi_v,
                     uint8_t* bits, int threads) {
  uint8_t lo8 = (uint8_t)lo_v, hi8 = (uint8_t)hi_v;
  if (threads < 1) threads = 1;
  long n_bytes = (n + 7) / 8;
  long per = ((n_bytes + threads - 1) / threads + 3) & ~3L;  // 32-code align
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    long blo = t * per, bhi = std::min(n_bytes, blo + per);
    if (blo >= bhi) break;
    pool.emplace_back([=] {
      long a = blo * 8, b = std::min(n, bhi * 8);
#if defined(__x86_64__)
      if (HAVE_AVX2) {
        pack_valid_bits_avx2(data + a, b - a, lo8, hi8, bits + blo);
        return;
      }
#endif
      for (long i = a; i < b; i += 8) {
        uint8_t m = 0;
        for (int k = 0; k < 8 && i + k < b; k++) {
          uint8_t c = data[i + k];
          m |= (uint8_t)((c >= lo8 && c <= hi8) << k);
        }
        bits[i >> 3] = m;
      }
    });
  }
  for (auto& th : pool) th.join();
}

// popcount of a bit plane (n_bytes need not be word-aligned)
long popcount_buf(const uint8_t* a, long n_bytes, int threads) {
  if (threads < 1) threads = 1;
  long per = ((n_bytes + threads - 1) / threads + 7) & ~7L;
  std::vector<long> partial((size_t)threads, 0);
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    long lo = t * per, hi = std::min(n_bytes, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([&, t, lo, hi] {
      long c = 0, i = lo;
      for (; i + 8 <= hi; i += 8) {
        uint64_t w;
        memcpy(&w, a + i, 8);
        c += __builtin_popcountll(w);
      }
      for (; i < hi; i++) c += __builtin_popcount(a[i]);
      partial[t] = c;
    });
  }
  for (auto& th : pool) th.join();
  long total = 0;
  for (long p : partial) total += p;
  return total;
}

// popcount(a & b) over two equal-length bit planes
long popcount_and(const uint8_t* a, const uint8_t* b, long n_bytes,
                  int threads) {
  if (threads < 1) threads = 1;
  long per = ((n_bytes + threads - 1) / threads + 7) & ~7L;
  std::vector<long> partial((size_t)threads, 0);
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    long lo = t * per, hi = std::min(n_bytes, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([&, t, lo, hi] {
      long c = 0, i = lo;
      for (; i + 32 <= hi; i += 32) {  // 4-way unroll: ~memory bandwidth
        uint64_t w0, w1, w2, w3, x0, x1, x2, x3;
        memcpy(&w0, a + i, 8);      memcpy(&x0, b + i, 8);
        memcpy(&w1, a + i + 8, 8);  memcpy(&x1, b + i + 8, 8);
        memcpy(&w2, a + i + 16, 8); memcpy(&x2, b + i + 16, 8);
        memcpy(&w3, a + i + 24, 8); memcpy(&x3, b + i + 24, 8);
        c += __builtin_popcountll(w0 & x0) + __builtin_popcountll(w1 & x1) +
             __builtin_popcountll(w2 & x2) + __builtin_popcountll(w3 & x3);
      }
      for (; i < hi; i++) c += __builtin_popcount(a[i] & b[i]);
      partial[t] = c;
    });
  }
  for (auto& th : pool) th.join();
  long total = 0;
  for (long p : partial) total += p;
  return total;
}

}  // extern "C"

// Scan-only escape detection on a bit-packed folded-plane slice: local cell
// indices where the W-bit field equals the escape marker (2^W - 1), WITHOUT
// unfolding. The readback drain phase runs this as each packed slice lands
// (memory-bound; the group-reject mask makes escape-free groups ~5 ops) so
// the batched patch gather can be issued the moment the link drains — the
// unfold workers then chase it with write+hash instead of waiting for a
// full unfold pass to discover the escape positions.
template <int W>
static long scan_escapes_impl(const uint8_t* packed, long n_bytes,
                              uint32_t* esc, long esc_cap) {
  const long n_groups =
      W == 2 ? n_bytes / 2 : W == 3 ? n_bytes / 3 : n_bytes / 4;
  long n_esc = 0;
  for (long g = 0; g < n_groups; g++) {
    uint32_t w;
    if (W == 2) {
      uint16_t h;
      memcpy(&h, packed + 2 * g, 2);
      w = h;
    } else if (W == 3) {
      w = (uint32_t)packed[3 * g] | ((uint32_t)packed[3 * g + 1] << 8) |
          ((uint32_t)packed[3 * g + 2] << 16);
    } else {
      memcpy(&w, packed + 4 * g, 4);
    }
    // bit at each field's base position set iff ALL W bits of the field are
    // set (== marker); the AND chain cannot leak across fields because only
    // base-position bits survive the final mask
    uint32_t any;
    if (W == 2)
      any = (w & (w >> 1)) & 0x5555u;
    else if (W == 3)
      any = (w & (w >> 1) & (w >> 2)) & 0x249249u;
    else
      any = (w & (w >> 1) & (w >> 2) & (w >> 3)) & 0x11111111u;
    while (any) {
      int b = __builtin_ctz(any);
      if (n_esc < esc_cap) esc[n_esc] = (uint32_t)(8 * g + b / W);
      n_esc++;
      any &= any - 1;
    }
  }
  return n_esc;
}

extern "C" {

long scan_escapes(const uint8_t* packed, long n_bytes, int width,
                  uint32_t* esc, long esc_cap) {
  if (width == 2) return scan_escapes_impl<2>(packed, n_bytes, esc, esc_cap);
  if (width == 3) return scan_escapes_impl<3>(packed, n_bytes, esc, esc_cap);
  if (width == 4) return scan_escapes_impl<4>(packed, n_bytes, esc, esc_cap);
  return -1;
}

}  // extern "C"
