// Dense FQZ block codec on Hopper (sm_90a): the per-block encode and decode
// of the FQZ v1/v2 and v3 paths, with a plain C interface for ctypes.
//
// fq_dense_encode replaces the TPU kernel _encode_tile_kernel
// (fastqpacker_tpu/ops/pallas_kernels.py:41, pallas_call at :112) and its
// XLA twin encode_arrays_jit (fastqpacker_tpu/ops/device.py:84).
// fq_dense_decode replaces _decode_tile_kernel (pallas_kernels.py:186,
// pallas_call at :239) and decode_arrays_jit (ops/device.py:140).
//
// Layout: row-major (R, L) uint8 at the true read length L, any L >= 0:
// seq, qual and deltas (R, L), packed (R, ceil(L/4)) (the decode takes a
// wider row pitch too), N mask (R, ceil(L/8)), counts (R,) int32. Every
// tensor starts on 16 bytes (the wrapper checks).
//
// What bounds it: device-memory bytes, each once, over 3.35 TB/s. The
// encode reads 2L and writes ~1.375L bytes a row, the decode reads ~1.25L
// and writes 2L. A few integer operations a byte are far below the
// operation rate, but not so far that they may wait for the loads.
//
// The design (rows of at most kMaxTileLen bytes):
// - Tiles of whole rows: a multiple of the fewest rows r (1, 2, 4, 8 or 16,
//   by L) whose runs of every array are multiples of 16 bytes; 16 rows do
//   at any L (16L, 16 ceil(L/4), 16 ceil(L/8)). Such a tile is one
//   contiguous run of each array that starts on 16 bytes, so no pad or
//   slice pass is needed around the launch. About kTileBytes a run, sized
//   so its 16-byte units fill the lanes of a warp's passes.
// - Each warp of a persistent CTA is a worker of its own over the tiles,
//   with its own ring of shared-memory stages, one mbarrier each: its lane 0
//   moves each input run of a tile with one 1-D TMA bulk copy
//   (cp.async.bulk ... mbarrier::complete_tx) and refills a stage as soon as
//   the tile's last read of it is done, so the next tile's loads are in
//   flight while this one's outputs are made and stored. No warp waits for
//   another (no __syncthreads). One stage a warp (kEncodeStages,
//   kDecodeStages) measured faster than two or three (PERF.md): the shared
//   memory it saves holds more warps, whose own loads overlap. A ragged last
//   tile is copied in bulk up to its last multiple of 16 bytes and the rest
//   by ordinary loads: nothing is read past a tensor.
// - Work is cut into 16-byte units of the tile, not into rows, so every
//   lane is busy at any L; a unit's row and column advance by constants
//   from one pass to the next (no division in the loop).
//   Encode: a unit's deltas take the previous byte from the staged tile and
//   the offset at each row start (a byte blend). Its bases become 2-bit
//   codes and not-ACGT flags in two bit images of the tile (SIMD within a
//   word, multiplies to gather the fields); the packed and N-mask rows are
//   then 32-bit funnel shifts of those images at each row's bit offset, and
//   the N counts popcounts of the mask image.
//   Decode: the running quality sum is a plain warp scan of the unit
//   totals, carried across the passes of a tile; a row start resets it,
//   found by a ballot and a shuffle from the last lane whose unit starts a
//   row (rows lie whole in a tile). Codes become ASCII with one byte_perm
//   per four bases.
// - Outputs leave as coalesced stores straight from registers: 16 bytes a
//   lane for deltas and decoded bytes, 4 bytes a lane for packed codes and
//   the N mask. Plain stores, not bulk stores: the outputs are made in
//   registers in store order, and a bulk store would add a shared-memory
//   pass and a wait before the buffer is used again.
// - Rows longer than kMaxTileLen take the row kernels behind the same
//   entry points: one CTA per row, eight columns a thread, plain byte loads
//   and stores, the decode's running sum carried across the row's passes.
//
// The first design (one warp per row, width padded to 16 by the wrapper),
// on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, the port's first
// slice): encode 21.80 us at 37,500 x 160 (bound 6.13 us) and 53.05 us at
// 100,000 x 160 (16.36 us); decode 15.13 us (5.82 us) and 36.17 us
// (15.52 us).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>
#include <map>
#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr int kTileBytes = 1024;    // bytes of a tile's seq (or delta) run, about
constexpr int kMaxTileRows = 256;   // rows of a tile, at most
constexpr int kEncodeStages = 1;    // shared-memory stages of each warp's ring
constexpr int kDecodeStages = 1;
constexpr int kMaxWarps = 8;        // warps (workers) of a tile CTA, at most
constexpr int kCtaShared = 224 * 1024;  // dynamic shared bytes of a CTA, at most
constexpr int kMaxTileLen = 1024;   // longest row the tile kernels take
constexpr int kCtasPerSm = 16;      // tile CTAs on one SM, at most
constexpr int kMinCtasPerSm = 3;    // tile CTAs an SM must hold (caps registers)
constexpr int kUnroll = 2;          // passes of a warp at once
constexpr int kRowThreads = 256;    // threads of a row-kernel CTA
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowCtasPerSm = 8;    // row-kernel CTAs on one SM
constexpr int kPad = 16;            // slack after each staged run
constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kAcgt = 0x54474341u;  // "ACGT", little-endian

// ---------------------------------------------------------------------------
// byte arithmetic
// ---------------------------------------------------------------------------

// Four bytes holding 2-bit codes -> one packed byte, LSB-first.
// (one multiply gathers the four fields into the top byte; no two partial
// products meet, so nothing carries)
__device__ __forceinline__ uint32_t pack_codes(uint32_t w) {
  return (w * 0x01041040u) >> 24;
}

// Bit 7 of each byte -> 4-bit mask, bit k set where byte k has it.
// (one multiply gathers the four bits at bits 21-24)
__device__ __forceinline__ uint32_t byte_flags(uint32_t v) {
  return (((v >> 7) & 0x01010101u) * 0x00204081u >> 21) & 0xFu;
}

// 4-bit mask -> bytes of 0x00/0xFF, byte k = 0xFF where bit k is set.
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t n) {
  return ((n * 0x00204081u) & 0x01010101u) * 0xFFu;
}

// Case-insensitive ACGT -> codes 0-3 (every other byte -> 0), and bit 7 of
// each byte of `invalid` set where the byte is not ACGT. The code of an
// upper-case base is its bits 1-2 xor its bits 2-3 (A 0, C 1, G 2, T 3);
// the base that code names is looked up and compared.
__device__ __forceinline__ void classify(uint32_t w, uint32_t& code,
                                         uint32_t& invalid) {
  const uint32_t u = w & 0xDFDFDFDFu;
  const uint32_t c = ((u >> 1) ^ (u >> 2)) & 0x03030303u;
  const uint32_t sel = __byte_perm(c | (c >> 4), 0, 0x0020);  // nibble k = code k
  const uint32_t z = __byte_perm(kAcgt, 0, sel) ^ u;
  invalid = (((z & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | z) & 0x80808080u;
  code = c & ~((invalid >> 6) | (invalid >> 7));
}

// 16 2-bit codes (LSB-first) -> 16 ASCII bases: the codes spread into the
// nibbles of two selector words, then one byte_perm per four bases.
__device__ __forceinline__ uint4 ascii16(uint32_t cw) {
  uint32_t lo = cw & 0xFFFFu, hi = cw >> 16;
  lo = (lo | (lo << 8)) & 0x00FF00FFu;
  hi = (hi | (hi << 8)) & 0x00FF00FFu;
  lo = (lo | (lo << 4)) & 0x0F0F0F0Fu;
  hi = (hi | (hi << 4)) & 0x0F0F0F0Fu;
  lo = (lo | (lo << 2)) & 0x33333333u;
  hi = (hi | (hi << 2)) & 0x33333333u;
  return make_uint4(__byte_perm(kAcgt, 0, lo), __byte_perm(kAcgt, 0, lo >> 16),
                    __byte_perm(kAcgt, 0, hi), __byte_perm(kAcgt, 0, hi >> 16));
}

// Byte-wise inclusive prefix sum of a word's 4 bytes, mod 256 per byte.
__device__ __forceinline__ uint32_t byte_prefix(uint32_t x) {
  x = __vadd4(x, x << 8);
  return __vadd4(x, x << 16);
}

__device__ __forceinline__ uint32_t bcast(uint32_t b) {
  return (b & 0xFFu) * 0x01010101u;
}

// Bytes of a word below index n (n may be out of 0..4) -> 0xFF.
__device__ __forceinline__ uint32_t low_bytes(int n) {
  return n <= 0 ? 0u : n >= 4 ? 0xFFFFFFFFu : (1u << (8 * n)) - 1u;
}

// Eight bases (byte k of s8 at column col + k, nvalid of them in the row)
// -> two packed bytes (codes past the row are 0) and the N-mask byte of the
// columns below col + lim.
__device__ __forceinline__ void encode_octet(uint64_t s8, int nvalid, int lim,
                                             uint32_t& pk0, uint32_t& pk1,
                                             uint32_t& m8) {
  uint32_t c0, i0, c1, i1;
  classify((uint32_t)s8, c0, i0);
  classify((uint32_t)(s8 >> 32), c1, i1);
  if (nvalid < 8) {
    const uint64_t keep = (1ull << (8 * nvalid)) - 1ull;
    c0 &= (uint32_t)keep;
    c1 &= (uint32_t)(keep >> 32);
  }
  pk0 = pack_codes(c0);
  pk1 = pack_codes(c1);
  uint32_t m = byte_flags(i0) | (byte_flags(i1) << 4);
  if (lim <= 0) {
    m = 0;
  } else if (lim < 8) {
    m &= (1u << lim) - 1u;
  }
  m8 = m;
}

// Eight quality bytes and the byte before them -> their deltas.
__device__ __forceinline__ uint64_t delta8(uint64_t q8, uint32_t prev) {
  const uint32_t lo = (uint32_t)q8, hi = (uint32_t)(q8 >> 32);
  return (uint64_t)__vsub4(lo, (lo << 8) | prev) |
         ((uint64_t)__vsub4(hi, (hi << 8) | (lo >> 24)) << 32);
}


__device__ __forceinline__ uint64_t load_bytes(const uint8_t* g, int n) {
  uint64_t v = 0;
  for (int k = 0; k < n; ++k) v |= (uint64_t)g[k] << (8 * k);
  return v;
}

__device__ __forceinline__ void store_bytes(uint8_t* g, uint64_t v, int n) {
  for (int k = 0; k < n; ++k) g[k] = (uint8_t)(v >> (8 * k));
}

// A unit of 16 bytes to device memory: one 16-byte store when whole, else
// its first `valid` bytes.
__device__ __forceinline__ void store16(uint8_t* g, const uint4& v,
                                        unsigned valid) {
  if (valid >= 16) {
    *reinterpret_cast<uint4*>(g) = v;
    return;
  }
  store_bytes(g, (uint64_t)v.x | ((uint64_t)v.y << 32), min(valid, 8u));
  if (valid > 8) store_bytes(g + 8, (uint64_t)v.z | ((uint64_t)v.w << 32), valid - 8);
}

// kUnroll plain scans over a warp's lanes (their shuffles interleave) of
// each unit's delta total, the last byte of `wd` (mod 256): the inclusive
// and exclusive sums, the lanes whose unit starts a row (k0 < 16), and the
// sum at the last row start below this lane (starts[j]: the exclusive sum
// plus `before` of the last such lane below it).
__device__ __forceinline__ void warp_sums(const uint32_t (&wd)[kUnroll],
                                          uint32_t (&incl)[kUnroll],
                                          uint32_t (&excl)[kUnroll],
                                          uint32_t (&flagged)[kUnroll],
                                          uint32_t (&starts)[kUnroll],
                                          const unsigned (&k0)[kUnroll],
                                          const uint32_t (&before)[kUnroll],
                                          unsigned lane) {
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) incl[j] = wd[j] >> 24;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const uint32_t v = __shfl_up_sync(kFullMask, incl[j], off);
      if (lane >= (unsigned)off) incl[j] += v;
    }
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    excl[j] = incl[j] - (wd[j] >> 24);
    flagged[j] = __ballot_sync(kFullMask, k0[j] < 16);
    const uint32_t earlier = flagged[j] & ((1u << lane) - 1u);
    const unsigned src = earlier ? 31 - __clz(earlier) : 0;
    starts[j] = __shfl_sync(kFullMask, excl[j] + before[j], src);
  }
}

// A plain (unsegmented) scan over a CTA's threads in order, for the row
// kernels: the value before this thread after `carry`, which moves past the
// last thread. Two __syncthreads; every thread calls it.
__device__ __forceinline__ uint32_t cta_scan(uint32_t v, uint32_t& carry, uint32_t* sv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t vo = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v += vo;
  }
  if (lane == 31) sv[warp] = v;
  __syncthreads();
  uint32_t acc = carry, before = carry;
#pragma unroll
  for (int w = 0; w < kRowWarps; ++w) {
    if (w == warp) before = acc;
    acc += sv[w];
  }
  uint32_t ve = __shfl_up_sync(kFullMask, v, 1);
  if (lane == 0) ve = 0;
  __syncthreads();  // sv is free again
  carry = acc;
  return before + ve;
}

// ---------------------------------------------------------------------------
// TMA bulk copies and mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both ends on 16 bytes)
// into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Stage two runs into shared memory on `bar`: each in bulk up to its last
// multiple of 16 bytes, the rest (a ragged last tile) by ordinary loads,
// which a __syncwarp makes visible before any lane reads them.
__device__ __forceinline__ void stage_runs(uint64_t* bar, uint8_t* s0,
                                           const uint8_t* g0, unsigned n0,
                                           uint8_t* s1, const uint8_t* g1,
                                           unsigned n1) {
  const unsigned b0 = n0 & ~15u, b1 = n1 & ~15u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive_expect_tx(bar, b0 + b1);
  if (b0) bulk_load(s0, g0, b0, bar);
  if (b1) bulk_load(s1, g1, b1, bar);
  for (unsigned j = b0; j < n0; ++j) s0[j] = g0[j];
  for (unsigned j = b1; j < n1; ++j) s1[j] = g1[j];
}

__device__ __forceinline__ void init_stages(uint64_t* bars, int stages, unsigned lane) {
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// tile kernels: each warp a worker over tiles of whole rows
// ---------------------------------------------------------------------------

struct EncodeArgs {
  const uint8_t* seq;
  const uint8_t* qual;
  const int32_t* lengths;
  uint8_t* packed;
  uint8_t* nmask;
  int32_t* n_counts;
  uint8_t* delta;
  long long rows;
  int len, prow, mrow;  // L, ceil(L/4), ceil(L/8)
  int qual_offset, npos_cap;
  long long tiles;
  int tile_rows;
  int stage_in, img_codes, img_flags;  // bytes of one staged seq run and of the two images
  int warp_shared;                   // shared bytes of one warp
};

struct DecodeArgs {
  const uint8_t* packed;
  const uint8_t* delta;
  uint8_t* seq;
  uint8_t* qual;
  long long rows;
  int len, pitch, mrow;  // L, the packed row pitch, ceil(L/8)
  int qual_offset;
  long long tiles;
  int tile_rows;
  int stage_in, stage_pk;  // staged bytes of one delta run and packed run
  int warp_shared;
};

// Where a lane's first 16-byte unit (at byte 16 lane of a tile) lies, and
// how far a pass of 32 units moves it.
struct Walk {
  unsigned urow, ucol, ustep_row, ustep_col;
};

__device__ __forceinline__ Walk make_walk(unsigned L, unsigned lane) {
  Walk w{};
  if (L) {
    w.urow = 16 * lane / L;
    w.ucol = 16 * lane % L;
    w.ustep_row = 512 / L;
    w.ustep_col = 512 % L;
  }
  return w;
}

__device__ __forceinline__ void advance(unsigned& row, unsigned& col, unsigned step_row,
                                        unsigned step_col, unsigned width) {
  row += step_row;
  col += step_col;
  if (col >= width) {
    col -= width;
    ++row;
  }
}


__device__ __forceinline__ void stage_encode_tile(const EncodeArgs& a, long long t,
                                                  uint8_t* stage, uint64_t* bar) {
  const long long row0 = t * a.tile_rows;
  const unsigned n = (unsigned)min((long long)a.tile_rows, a.rows - row0) * a.len;
  const size_t at = (size_t)row0 * a.len;
  stage_runs(bar, stage, a.seq + at, n, stage + a.stage_in, a.qual + at, n);
}

// 32 bits of a bit image (bit t of the stream at bit t % 32 of word t / 32)
// from bit `pos`; the word after the last is read too (kPad covers it).
__device__ __forceinline__ uint32_t bits32(const uint32_t* img, unsigned pos) {
  return __funnelshift_r(img[pos >> 5], img[(pos >> 5) + 1], pos & 31u);
}

// A word of 4 output bytes to device memory: one 4-byte store when whole,
// else its first `valid` bytes (the ragged end of a run).
__device__ __forceinline__ void store4(uint8_t* g, uint32_t v, unsigned valid) {
  if (valid >= 4) {
    *reinterpret_cast<uint32_t*>(g) = v;
    return;
  }
  for (unsigned k = 0; k < valid; ++k) g[k] = (uint8_t)(v >> (8 * k));
}

// The bytes of a tile's packed (2 bits a column) or N-mask (1 bit) rows as a
// walk over a bit image of the tile: output byte (row, b) is the 8 bits at
// bit per (row L) + 8 b. A word of the first `valid` (1-4) of 4 output bytes
// from byte b of row `row`, `width` bytes a row; keep(row, b, n) masks the
// bits of n bytes from (row, b) that lie past the row's end (or past its
// tracked length).
template <typename Keep>
__device__ __forceinline__ uint32_t gather_word(const uint32_t* img, unsigned row, unsigned b,
                                                unsigned L, unsigned width, unsigned per,
                                                unsigned valid, Keep keep) {
  if (b + 4 <= width)  // the four bytes lie in one row
    return bits32(img, per * (row * L) + 8 * b) & keep(row, b, 4);
  if (width >= 4) {  // the first j bytes end a row, the rest start the next
    const unsigned j = width - b;
    uint32_t v = bits32(img, per * (row * L) + 8 * b) & keep(row, b, j) & low_bytes(j);
    if (valid > j) v |= (bits32(img, per * ((row + 1) * L)) & keep(row + 1, 0, 4 - j)) << (8 * j);
    return v;
  }
  uint32_t v = 0;
  for (unsigned j = 0; j < valid && j < 4; ++j) {
    v |= (bits32(img, per * (row * L) + 8 * b) & keep(row, b, 1) & 0xFFu) << (8 * j);
    if (++b == width) {
      b = 0;
      ++row;
    }
  }
  return v;
}

__global__ void __launch_bounds__(kMaxWarps * 32, kMinCtasPerSm)
dense_encode_tiles(const EncodeArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint64_t bars[kMaxWarps][kEncodeStages];
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned L = a.len, P = a.prow, M = a.mrow;
  const long long workers = (long long)gridDim.x * (blockDim.x >> 5);
  const long long first = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  const int stage_bytes = 2 * a.stage_in;
  uint8_t* mine = smem + warp * a.warp_shared;
  // bit images of the staged tile: 2-bit codes and not-ACGT flags, one bit
  // group per tile byte
  uint32_t* codes = reinterpret_cast<uint32_t*>(mine + kEncodeStages * stage_bytes);
  uint32_t* flags = reinterpret_cast<uint32_t*>(mine + kEncodeStages * stage_bytes + a.img_codes);
  uint64_t* bar = bars[warp];
  const uint32_t off4 = bcast((uint32_t)a.qual_offset);
  // the bits of a row's last packed byte that lie inside the row
  const uint32_t last_codes = (L & 3u) ? (1u << (2 * (L & 3u))) - 1u : 0xFFu;
  // a lane's first packed and mask words, and their step over a pass
  const unsigned pk_row0 = P ? 4 * lane / P : 0, pk_b0 = P ? 4 * lane % P : 0;
  const unsigned pk_step_row = P ? 128 / P : 0, pk_step_b = P ? 128 % P : 0;
  const unsigned mk_row0 = M ? 4 * lane / M : 0, mk_c0 = M ? 4 * lane % M : 0;
  const unsigned mk_step_row = M ? 128 / M : 0, mk_step_c = M ? 128 % M : 0;
  const Walk w = make_walk(L, lane);

  init_stages(bar, kEncodeStages, lane);
  if (lane == 0) {
    for (int s = 0; s < kEncodeStages; ++s) {
      const long long t = first + s * workers;
      if (t < a.tiles) stage_encode_tile(a, t, mine + s * stage_bytes, &bar[s]);
    }
  }
  __syncwarp();

  int k = 0;
  for (long long t = first; t < a.tiles; t += workers, ++k) {
    const int s = k % kEncodeStages;
    const long long row0 = t * a.tile_rows;
    const unsigned nrows = (unsigned)min((long long)a.tile_rows, a.rows - row0);
    const unsigned nbytes = nrows * L;
    const uint8_t* seq_s = mine + s * stage_bytes;
    const uint8_t* qual_s = seq_s + a.stage_in;
    mbar_wait(&bar[s], (unsigned)(k / kEncodeStages) & 1u);

    // 16 bytes a lane: the quality deltas (the previous byte, or the offset
    // at each row start) and the bases' codes and flags into the images
    uint8_t* delta_g = a.delta + (size_t)row0 * L;
    unsigned col = w.ucol;
#pragma unroll kUnroll
    for (unsigned o = lane << 4; o < nbytes; o += 512) {
      const uint4 q = *reinterpret_cast<const uint4*>(qual_s + o);
      const uint4 sq = *reinterpret_cast<const uint4*>(seq_s + o);
      const uint32_t prev = o ? qual_s[o - 1] : 0u;
      unsigned starts = 0;
      for (unsigned b = col ? L - col : 0; b < 16; b += L) starts |= 1u << b;
      uint32_t px = (q.x << 8) | prev, py = (q.y << 8) | (q.x >> 24),
               pz = (q.z << 8) | (q.y >> 24), pw = (q.w << 8) | (q.z >> 24);
      if (starts) {
        const uint32_t mx = nibble_bytes(starts & 15u), my = nibble_bytes((starts >> 4) & 15u),
                       mz = nibble_bytes((starts >> 8) & 15u), mw = nibble_bytes(starts >> 12);
        px = (px & ~mx) | (off4 & mx);
        py = (py & ~my) | (off4 & my);
        pz = (pz & ~mz) | (off4 & mz);
        pw = (pw & ~mw) | (off4 & mw);
      }
      store16(delta_g + o,
              make_uint4(__vsub4(q.x, px), __vsub4(q.y, py), __vsub4(q.z, pz),
                         __vsub4(q.w, pw)),
              nbytes - o);
      uint32_t c0, c1, c2, c3, i0, i1, i2, i3;
      classify(sq.x, c0, i0);
      classify(sq.y, c1, i1);
      classify(sq.z, c2, i2);
      classify(sq.w, c3, i3);
      codes[o >> 4] = pack_codes(c0) | (pack_codes(c1) << 8) | (pack_codes(c2) << 16) |
                      (pack_codes(c3) << 24);
      reinterpret_cast<uint16_t*>(flags)[o >> 4] =
          (uint16_t)(byte_flags(i0) | (byte_flags(i1) << 4) | (byte_flags(i2) << 8) |
                     (byte_flags(i3) << 12));
      col += w.ustep_col;
      if (col >= L) col -= L;
    }
    __syncwarp();  // stage s is read; the images are whole

    if (lane == 0 && t + kEncodeStages * workers < a.tiles)
      stage_encode_tile(a, t + kEncodeStages * workers, mine + s * stage_bytes, &bar[s]);

    // packed rows, 4 bytes a lane: the codes of the row's columns, those
    // past L cleared in its last byte
    const unsigned npk = nrows * P;
    uint8_t* packed_g = a.packed + (size_t)row0 * P;
    unsigned row = pk_row0, b = pk_b0;
    for (unsigned q = lane << 2; q < npk; q += 128) {
      const uint32_t v = gather_word(codes, row, b, L, P, 2, npk - q,
                                     [&](unsigned, unsigned bb, int n) -> uint32_t {
                                       const unsigned j = P - 1 - bb;  // the last byte's index
                                       return j < (unsigned)n ? ~(~last_codes << (8 * j))
                                                              : 0xFFFFFFFFu;
                                     });
      store4(packed_g + q, v, npk - q);
      advance(row, b, pk_step_row, pk_step_b, P);
    }

    // N-mask rows, 4 bytes a lane: the flags below the row's tracked length
    const unsigned nmk = nrows * M;
    uint8_t* mask_g = a.nmask + (size_t)row0 * M;
    row = mk_row0;
    b = mk_c0;
    for (unsigned q = lane << 2; q < nmk; q += 128) {
      const uint32_t v = gather_word(flags, row, b, L, M, 1, nmk - q,
                                     [&](unsigned r, unsigned cc, int n) -> uint32_t {
                                       const int lim =
                                           min(min(__ldg(a.lengths + row0 + r), a.npos_cap),
                                               (int)L) - 8 * (int)cc;
                                       const int bits = 8 * n;
                                       return lim <= 0 ? 0u : lim >= bits ? 0xFFFFFFFFu
                                                                          : (1u << lim) - 1u;
                                     });
      store4(mask_g + q, v, nmk - q);
      advance(row, b, mk_step_row, mk_step_c, M);
    }

    // N counts, a row a lane: the flags below its tracked length
    for (unsigned r = lane; r < nrows; r += 32) {
      const int tracked = min(min(__ldg(a.lengths + row0 + r), a.npos_cap), (int)L);
      int count = 0;
      for (int c = 0; c < tracked; c += 32) {
        const uint32_t v = bits32(flags, r * L + c);
        count += __popc(tracked - c >= 32 ? v : v & ((1u << (tracked - c)) - 1u));
      }
      a.n_counts[row0 + r] = count;
    }
    __syncwarp();  // the images are free again
  }
}

__device__ __forceinline__ void stage_decode_tile(const DecodeArgs& a, long long t,
                                                  uint8_t* stage, uint64_t* bar) {
  const long long row0 = t * a.tile_rows;
  const unsigned nrows = (unsigned)min((long long)a.tile_rows, a.rows - row0);
  stage_runs(bar, stage, a.packed + (size_t)row0 * a.pitch, nrows * a.pitch,
             stage + a.stage_pk, a.delta + (size_t)row0 * a.len, nrows * a.len);
}

// A unit of 16 bytes at (row, col) for L < 16, where several rows may start
// in it: its bases and qualities one byte at a time, the running sum `in`
// before its first byte and the offset at each row start.
__device__ __forceinline__ void small_unit(const uint8_t* pk_s, unsigned pitch,
                                           const uint4& d, unsigned row, unsigned col,
                                           unsigned L, unsigned valid, uint32_t offset,
                                           uint32_t in, uint4& seq_out, uint4& qual_out) {
  const uint32_t dw[4] = {d.x, d.y, d.z, d.w};
  uint32_t sw[4] = {0, 0, 0, 0}, qw[4] = {0, 0, 0, 0};
  uint32_t acc = in;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if ((unsigned)k < valid) {
      const uint32_t db = (dw[k >> 2] >> (8 * (k & 3))) & 0xFFu;
      acc = (col == 0 ? offset : acc) + db;
      const uint32_t code = (pk_s[row * pitch + (col >> 2)] >> (2 * (col & 3))) & 3u;
      sw[k >> 2] |= ((kAcgt >> (8 * code)) & 0xFFu) << (8 * (k & 3));
      qw[k >> 2] |= (acc & 0xFFu) << (8 * (k & 3));
      if (++col == L) {
        col = 0;
        ++row;
      }
    }
  }
  seq_out = make_uint4(sw[0], sw[1], sw[2], sw[3]);
  qual_out = make_uint4(qw[0], qw[1], qw[2], qw[3]);
}

// kShort: L < 16, where several rows may start in a unit.
template <bool kShort>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinCtasPerSm)
dense_decode_tiles(const DecodeArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint64_t bars[kMaxWarps][kDecodeStages];
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned L = a.len, pitch = a.pitch;
  const uint32_t offset = (uint32_t)a.qual_offset;
  const long long workers = (long long)gridDim.x * (blockDim.x >> 5);
  const long long first = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  const int stage_bytes = a.stage_pk + a.stage_in;
  uint8_t* mine = smem + warp * a.warp_shared;
  uint64_t* bar = bars[warp];
  const Walk w = make_walk(L, lane);

  init_stages(bar, kDecodeStages, lane);
  if (lane == 0) {
    for (int s = 0; s < kDecodeStages; ++s) {
      const long long t = first + s * workers;
      if (t < a.tiles) stage_decode_tile(a, t, mine + s * stage_bytes, &bar[s]);
    }
  }
  __syncwarp();

  int k = 0;
  for (long long t = first; t < a.tiles; t += workers, ++k) {
    const int s = k % kDecodeStages;
    const long long row0 = t * a.tile_rows;
    const unsigned nrows = (unsigned)min((long long)a.tile_rows, a.rows - row0);
    const unsigned nbytes = nrows * L;
    const uint8_t* pk_s = mine + s * stage_bytes;
    const uint32_t* pk_w = reinterpret_cast<const uint32_t*>(pk_s);
    const uint8_t* d_s = pk_s + a.stage_pk;
    uint8_t* seq_g = a.seq + (size_t)row0 * L;
    uint8_t* qual_g = a.qual + (size_t)row0 * L;
    mbar_wait(&bar[s], (unsigned)(k / kDecodeStages) & 1u);

    // passes of one 16-byte unit a lane, kUnroll passes at a time. `run` is
    // the sum of the tile's deltas before the pass, `start` that sum before
    // the first byte of the row the pass starts in (both mod 256); the
    // tile's first unit starts a row, so neither matters before it.
    uint32_t run = 0, start = 0;
    unsigned row = w.urow, col = w.ucol;
    for (unsigned base = 0; base < nbytes; base += 512 * kUnroll) {
      unsigned urow[kUnroll], ucol[kUnroll], k0[kUnroll];
      uint4 d[kUnroll], so[kUnroll], qo[kUnroll];
      uint32_t x[kUnroll], y[kUnroll], z[kUnroll], wd[kUnroll], before[kUnroll],
          excl[kUnroll], incl[kUnroll], flagged[kUnroll], starts[kUnroll], cw[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const unsigned o = base + 512 * j + (lane << 4);
        urow[j] = row;
        ucol[j] = col;
        k0[j] = 16;
        x[j] = y[j] = z[j] = wd[j] = before[j] = cw[j] = 0;
        if (o < nbytes) {
          d[j] = *reinterpret_cast<const uint4*>(d_s + o);
          // the codes of the unit's 16 columns: from `col` of its row, and
          // from k0 on the next row's first ones (L >= 16)
          if (!kShort) cw[j] = bits32(pk_w, 8 * (row * pitch) + 2 * col);
          x[j] = byte_prefix(d[j].x);
          y[j] = byte_prefix(d[j].y);
          z[j] = byte_prefix(d[j].z);
          wd[j] = byte_prefix(d[j].w);
          y[j] = __vadd4(y[j], bcast(x[j] >> 24));
          z[j] = __vadd4(z[j], bcast(y[j] >> 24));
          wd[j] = __vadd4(wd[j], bcast(z[j] >> 24));
          // k0: the last row start in the unit (the only one when L >= 16)
          const unsigned k_first = col ? L - col : 0;
          if (k_first < 16) {
            k0[j] = kShort ? k_first + (15 - k_first) / L * L : k_first;
            if (k0[j]) {
              const unsigned bb = k0[j] - 1;
              const uint32_t word = bb < 4 ? x[j] : bb < 8 ? y[j] : bb < 12 ? z[j] : wd[j];
              before[j] = (word >> (8 * (bb & 3))) & 0xFFu;
              if (!kShort) {
                const uint32_t low = (1u << (2 * k0[j])) - 1u;
                cw[j] = (cw[j] & low) | (bits32(pk_w, 8 * ((row + 1) * pitch)) << (2 * k0[j]));
              }
            }
          }
        }
        advance(row, col, w.ustep_row, w.ustep_col, L);
      }
      // the tile's last reads of stage s, but for L < 16, whose bytes read
      // their codes as they are made
      if (!kShort && base + 512 * kUnroll >= nbytes) {
        __syncwarp();
        if (lane == 0 && t + kDecodeStages * workers < a.tiles)
          stage_decode_tile(a, t + kDecodeStages * workers, mine + s * stage_bytes, &bar[s]);
      }
      // the deltas' plain running sum over the lanes, and where rows start
      warp_sums(wd, incl, excl, flagged, starts, k0, before, lane);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const unsigned o = base + 512 * j + (lane << 4);
        // the row sum before this unit: from the last row start before it,
        // in an earlier lane of this pass or in an earlier pass
        const uint32_t earlier = flagged[j] & ((1u << lane) - 1u);
        const uint32_t row_start = earlier ? run + starts[j] : start;
        const uint32_t in = offset + run + excl[j] - row_start;
        if (flagged[j])
          start = run + __shfl_sync(kFullMask, excl[j] + before[j], 31 - __clz(flagged[j]));
        run += __shfl_sync(kFullMask, incl[j], 31);
        if (o >= nbytes) continue;
        if constexpr (!kShort) {
          // bytes before k0 continue the running sum `in`; from k0 on the
          // new row's sum starts at the offset
          const uint32_t a_in = bcast(in), a_st = bcast(offset - before[j]);
          const int kk = (int)k0[j];
          const uint32_t m0 = low_bytes(kk), m1 = low_bytes(kk - 4),
                         m2 = low_bytes(kk - 8), m3 = low_bytes(kk - 12);
          qo[j] = make_uint4(__vadd4(x[j], (a_in & m0) | (a_st & ~m0)),
                             __vadd4(y[j], (a_in & m1) | (a_st & ~m1)),
                             __vadd4(z[j], (a_in & m2) | (a_st & ~m2)),
                             __vadd4(wd[j], (a_in & m3) | (a_st & ~m3)));
          so[j] = ascii16(cw[j]);
        } else {
          small_unit(pk_s, pitch, d[j], urow[j], ucol[j], L, min(16u, nbytes - o), offset,
                     in, so[j], qo[j]);
        }
        store16(seq_g + o, so[j], nbytes - o);
        store16(qual_g + o, qo[j], nbytes - o);
      }
    }
    if (kShort) {
      __syncwarp();
      if (lane == 0 && t + kDecodeStages * workers < a.tiles)
        stage_decode_tile(a, t + kDecodeStages * workers, mine + s * stage_bytes, &bar[s]);
    }
  }
}

// ---------------------------------------------------------------------------
// row kernels (rows longer than kMaxTileLen)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRowThreads)
dense_encode_rows(const EncodeArgs a) {
  __shared__ int sums[kRowWarps];
  const unsigned L = a.len, P = a.prow, M = a.mrow;
  for (long long row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const size_t at = (size_t)row * L;
    const int tracked = min(min(__ldg(a.lengths + row), a.npos_cap), (int)L);
    int count = 0;
    for (unsigned c = threadIdx.x; c < M; c += kRowThreads) {
      const unsigned col = c << 3;
      const int nvalid = (int)min(8u, L - col);
      const uint64_t s8 = load_bytes(a.seq + at + col, nvalid);
      const uint64_t q8 = load_bytes(a.qual + at + col, nvalid);
      const uint32_t prev = col ? a.qual[at + col - 1] : (uint32_t)a.qual_offset;
      uint32_t pk0, pk1, m8;
      encode_octet(s8, nvalid, tracked - (int)col, pk0, pk1, m8);
      a.packed[(size_t)row * P + 2 * c] = (uint8_t)pk0;
      if (2 * c + 1 < P) a.packed[(size_t)row * P + 2 * c + 1] = (uint8_t)pk1;
      a.nmask[(size_t)row * M + c] = (uint8_t)m8;
      count += __popc(m8);
      store_bytes(a.delta + at + col, delta8(q8, prev), nvalid);
    }
    count = __reduce_add_sync(kFullMask, count);
    if ((threadIdx.x & 31) == 0) sums[threadIdx.x >> 5] = count;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
      for (int w = 0; w < kRowWarps; ++w) total += sums[w];
      a.n_counts[row] = total;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kRowThreads)
dense_decode_rows(const DecodeArgs a) {
  __shared__ uint32_t sums[kRowWarps];
  const unsigned L = a.len, M = a.mrow;
  for (long long row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const size_t at = (size_t)row * L;
    const uint8_t* pk = a.packed + (size_t)row * a.pitch;
    uint32_t carry = (uint32_t)a.qual_offset;
    for (unsigned c0 = 0; c0 < M; c0 += kRowThreads) {
      const unsigned c = c0 + threadIdx.x, col = c << 3;
      const bool active = c < M;
      int nvalid = 0;
      uint32_t x = 0, y = 0, codes = 0;
      if (active) {
        nvalid = (int)min(8u, L - col);
        const uint64_t d8 = load_bytes(a.delta + at + col, nvalid);
        x = byte_prefix((uint32_t)d8);
        y = __vadd4(byte_prefix((uint32_t)(d8 >> 32)), bcast(x >> 24));
        codes = pk[2 * c] | (col + 4 < L ? (uint32_t)pk[2 * c + 1] << 8 : 0u);
      }
      const uint32_t in = cta_scan(y >> 24, carry, sums);
      if (!active) continue;
      const uint32_t add = bcast(in);
      const uint4 bases = ascii16(codes);
      store_bytes(a.qual + at + col,
                  (uint64_t)__vadd4(x, add) | ((uint64_t)__vadd4(y, add) << 32), nvalid);
      store_bytes(a.seq + at + col, (uint64_t)bases.x | ((uint64_t)bases.y << 32), nvalid);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline int round16(long long x) { return (int)((x + 15) & ~15ll); }

// Rows of a tile at length L (packed row pitch `pitch`; with the N mask for
// the encode): a multiple of the fewest rows r (1, 2, 4, 8 or 16) whose
// runs of every array are multiples of 16 bytes. Of the multiples whose seq
// run is at most 2 kTileBytes (r itself at least), the one whose 16-byte
// units (and, for the encode, eight-column octets) fill the most of their
// passes of 32 lanes, then the one nearest kTileBytes.
inline int tile_rows(int L, int pitch, bool mask) {
  const int M = (L + 7) / 8;
  int r = 1;
  while (r < 16 && ((r * L) % 16 || (r * pitch) % 16 || (mask && (r * M) % 16))) r *= 2;
  auto fill = [](long long n) { return n ? (double)n / (32.0 * ((n + 31) / 32)) : 1.0; };
  int best = r;
  double best_fill = -1, best_gap = 0;
  for (int T = r; T <= kMaxTileRows && (T == r || (long long)T * L <= 2ll * kTileBytes); T += r) {
    const double f = fill(((long long)T * L + 15) / 16) * (mask ? fill((long long)T * M) : 1.0);
    const double gap = std::abs((double)T * L - kTileBytes);
    if (f > best_fill + 1e-9 || (f > best_fill - 1e-9 && gap < best_gap)) {
      best = T;
      best_fill = f;
      best_gap = gap;
    }
  }
  return best;
}

// 16-byte units of a tile of T rows of L bytes.
inline long long units(int T, int L) { return ((long long)T * L + 15) / 16; }

// Shared bytes of one warp: its ring of stages and, for the encode, the bit
// images of a tile's codes (4 bytes a unit) and flags (2 bytes a unit).
inline long long encode_warp_shared(int L, int T) {
  return kEncodeStages * 2ll * round16((long long)T * L + kPad) + round16(4 * units(T, L) + kPad) +
         round16(2 * units(T, L) + kPad);
}

inline long long decode_warp_shared(int L, int pitch, int T) {
  return kDecodeStages * ((long long)round16((long long)T * pitch + kPad) +
                    round16((long long)T * L + kPad));
}

struct Geometry {
  int route;   // 0: tiles of `rows` rows, one warp each; 1: one CTA per row
  int rows;    // rows of a tile
  int warps;   // warps (workers) of a tile CTA
  int shared;  // dynamic shared bytes of a tile CTA
};

// As many warps as fit kCtaShared, at most kMaxWarps; the row kernels where
// not one fits (a packed pitch far wider than ceil(L/4)) or L is too long.
Geometry tile_geometry(int L, int T, long long warp_shared) {
  const long long w = std::min<long long>(kCtaShared / warp_shared, kMaxWarps);
  if (L > kMaxTileLen || w < 1) return {1, 1, 0, 0};
  return {0, T, (int)w, (int)(w * warp_shared)};
}

Geometry encode_geometry(int L) {
  const int T = tile_rows(L, (L + 3) / 4, true);
  return tile_geometry(L, T, encode_warp_shared(L, T));
}

Geometry decode_geometry(int L, int pitch) {
  const int T = tile_rows(L, pitch, false);
  return tile_geometry(L, T, decode_warp_shared(L, pitch, T));
}

// Raises a tile kernel's dynamic shared-memory cap once per device, under
// one lock, to kCtaShared (the most any launch takes); never set to another
// value. Also gives the device's SM count.
cudaError_t ready_launch(const void* kernel, int& sms) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> raised;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess || kernel == nullptr) return rc;
  std::lock_guard<std::mutex> lock(mu);
  if (raised.count({kernel, dev})) return cudaSuccess;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCtaShared);
  if (rc == cudaSuccess) raised.insert({kernel, dev});
  return rc;
}

// CTAs for `tiles` tiles: one warp per tile up to the CTAs that every SM
// holds at this geometry (registers, threads and shared memory; asked once
// per geometry), at most kCtasPerSm.
cudaError_t tile_grid(const void* kernel, long long tiles, const Geometry& g, int sms,
                      int& grid) {
  static std::mutex mu;
  static std::map<std::pair<const void*, std::pair<int, int>>, int> resident;
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_pair(kernel, std::make_pair(g.warps, g.shared));
    auto it = resident.find(key);
    if (it == resident.end()) {
      const cudaError_t rc =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * g.warps, g.shared);
      if (rc != cudaSuccess) return rc;
      it = resident.emplace(key, per_sm).first;
    }
    per_sm = it->second;
  }
  per_sm = per_sm < 1 ? 1 : per_sm > kCtasPerSm ? kCtasPerSm : per_sm;
  const long long need = (tiles + g.warps - 1) / g.warps;
  const long long most = (long long)sms * per_sm;
  grid = (int)(need < most ? need : most);
  return cudaSuccess;
}

inline int row_grid(long long rows, int sms) {
  const long long g = (long long)sms * kRowCtasPerSm;
  return (int)(rows < g ? rows : g);
}

}  // namespace

extern "C" {

// Returns the launch's cudaError_t (0 on success). Launches nothing for
// rows == 0; refuses a negative size.
int fq_dense_encode(const void* seq, const void* qual, const void* lengths,
                    void* packed, void* nmask, void* n_counts,
                    void* qual_delta, int rows, int len, int qual_offset,
                    int npos_cap, void* stream) {
  if (rows < 0 || len < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  EncodeArgs a{};
  a.seq = (const uint8_t*)seq;
  a.qual = (const uint8_t*)qual;
  a.lengths = (const int32_t*)lengths;
  a.packed = (uint8_t*)packed;
  a.nmask = (uint8_t*)nmask;
  a.n_counts = (int32_t*)n_counts;
  a.delta = (uint8_t*)qual_delta;
  a.rows = rows;
  a.len = len;
  a.prow = (len + 3) / 4;
  a.mrow = (len + 7) / 8;
  a.qual_offset = qual_offset & 0xFF;
  a.npos_cap = npos_cap;
  const Geometry g = encode_geometry(len);
  int sms = 0;
  cudaError_t rc;
  if (g.route == 0) {
    const int T = g.rows;
    a.tile_rows = T;
    a.tiles = ((long long)rows + T - 1) / T;
    a.stage_in = round16((long long)T * len + kPad);
    a.img_codes = round16(4 * units(T, len) + kPad);
    a.img_flags = round16(2 * units(T, len) + kPad);
    a.warp_shared = (int)encode_warp_shared(len, T);
    const void* kernel = (const void*)dense_encode_tiles;
    int grid = 0;
    rc = ready_launch(kernel, sms);
    if (rc == cudaSuccess) rc = tile_grid(kernel, a.tiles, g, sms, grid);
    if (rc != cudaSuccess) return (int)rc;
    dense_encode_tiles<<<grid, 32 * g.warps, g.shared, (cudaStream_t)stream>>>(a);
  } else {
    rc = ready_launch(nullptr, sms);
    if (rc != cudaSuccess) return (int)rc;
    dense_encode_rows<<<row_grid(rows, sms), kRowThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// pitch: bytes between two packed rows, at least ceil(len / 4).
int fq_dense_decode(const void* packed, const void* qual_delta, void* seq,
                    void* qual, int rows, int len, int pitch, int qual_offset,
                    void* stream) {
  if (rows < 0 || len < 0 || pitch < (len + 3) / 4) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  DecodeArgs a{};
  a.packed = (const uint8_t*)packed;
  a.delta = (const uint8_t*)qual_delta;
  a.seq = (uint8_t*)seq;
  a.qual = (uint8_t*)qual;
  a.rows = rows;
  a.len = len;
  a.pitch = pitch;
  a.mrow = (len + 7) / 8;
  a.qual_offset = qual_offset & 0xFF;
  const Geometry g = decode_geometry(len, pitch);
  int sms = 0;
  cudaError_t rc;
  if (g.route == 0) {
    const int T = g.rows;
    a.tile_rows = T;
    a.tiles = ((long long)rows + T - 1) / T;
    a.stage_pk = round16((long long)T * pitch + kPad);
    a.stage_in = round16((long long)T * len + kPad);
    a.warp_shared = (int)decode_warp_shared(len, pitch, T);
    const bool short_rows = len < 16;
    const void* kernel = short_rows ? (const void*)dense_decode_tiles<true>
                                    : (const void*)dense_decode_tiles<false>;
    int grid = 0;
    rc = ready_launch(kernel, sms);
    if (rc == cudaSuccess) rc = tile_grid(kernel, a.tiles, g, sms, grid);
    if (rc != cudaSuccess) return (int)rc;
    if (short_rows)
      dense_decode_tiles<true><<<grid, 32 * g.warps, g.shared, (cudaStream_t)stream>>>(a);
    else
      dense_decode_tiles<false><<<grid, 32 * g.warps, g.shared, (cudaStream_t)stream>>>(a);
  } else {
    rc = ready_launch(nullptr, sms);
    if (rc != cudaSuccess) return (int)rc;
    dense_decode_rows<<<row_grid(rows, sms), kRowThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// The launch either entry point makes at row length `len` (packed pitch
// `pitch` for the decode): out[0] the route (0 tiles, 1 one CTA per row),
// out[1] rows per tile, out[2] warps of a tile CTA, out[3] its dynamic
// shared bytes, out[4] kMaxTileLen, the longest row the tile kernels take.
// Launches nothing.
int fq_dense_geometry(int len, int pitch, int encode, void* out) {
  if (len < 0 || pitch < (len + 3) / 4) return (int)cudaErrorInvalidValue;
  const Geometry g = encode ? encode_geometry(len) : decode_geometry(len, pitch);
  int* o = (int*)out;
  o[0] = g.route;
  o[1] = g.rows;
  o[2] = g.warps;
  o[3] = g.shared;
  o[4] = kMaxTileLen;
  return 0;
}

}  // extern "C"
