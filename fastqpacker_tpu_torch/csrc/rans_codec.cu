// Interleaved-lane order-0 rANS of the FQZ v3 path on Hopper (sm_90a): the
// lockstep encode, the word compaction and the lockstep decode, with a plain
// C interface for ctypes.
//
// fq_rans_encode  replaces the XLA program _encode_kernel
//                 (fastqpacker_tpu/ops/rans.py:162),
// fq_rans_compact replaces _compact_global (ops/rans.py:218),
// fq_rans_decode  replaces _decode_kernel (ops/rans.py:291) and its twin
//                 _decode_kernel_nogather (ops/rans.py:353): both compute the
//                 same function.
//
// The coder: lane l of N codes symbols l, l+N, l+2N, ... of the stream, so a
// (steps, N) row-major matrix is the stream itself. 32-bit state from 1<<16,
// 12-bit probabilities, 16-bit renormalisation words. The encoder walks the
// rows backwards and emits at most one word per cell; the words are stored in
// ascending (step, lane) order, which is the order the forward decoder reads
// them in.
//
// What bounds them. By bytes the work is small (encode reads one byte and
// writes three per symbol, compact reads three and writes at most two, decode
// reads and writes about one), but encode and decode are chains of `steps`
// dependent state updates per lane, and decode also needs a prefix over all
// lanes between two steps. So their time is steps x (latency of one update),
// not bytes over bandwidth. The design keeps each update short: the tables
// sit in shared memory, the division is the hardware's, the state stays in
// registers, loads and stores are coalesced across lanes. The TPU
// formulation (256 compare passes for the table, float32 long division,
// flip/roll row reversal, a routing network for the compaction, roll-ladder
// scans and a monotone shift network for the word fetch) is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kProbBits = 12;
constexpr int kSlots = 1 << kProbBits;

// Inclusive prefix sum over a warp.
__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

// ---------------------------------------------------------------------------
// Encode: one thread per lane, rows walked backwards.
// ---------------------------------------------------------------------------

constexpr int kEncodeThreads = 128;

__global__ void __launch_bounds__(kEncodeThreads)
rans_encode_kernel(const uint8_t* __restrict__ data, long long n, int steps,
                   int lanes, int pad_sym,
                   const uint32_t* __restrict__ freq_cum,  // (2, 256)
                   uint16_t* __restrict__ words, uint8_t* __restrict__ flags,
                   uint32_t* __restrict__ states) {
  __shared__ uint32_t tab[256];  // freq | cum << 16
  for (int i = threadIdx.x; i < 256; i += kEncodeThreads)
    tab[i] = freq_cum[i] | (freq_cum[256 + i] << 16);
  __syncthreads();
  const int lane = blockIdx.x * kEncodeThreads + threadIdx.x;
  if (lane >= lanes) return;

  uint32_t x = kRansL;
#pragma unroll 4
  for (int t = steps - 1; t >= 0; --t) {
    const long long idx = (long long)t * lanes + lane;
    // cells past the stream's end code the pad symbol
    const uint32_t sym = idx < n ? (uint32_t)data[idx] : (uint32_t)pad_sym;
    const uint32_t e = tab[sym];
    const uint32_t f = e & 0xFFFFu;
    const uint32_t c = e >> 16;
    const bool emit = (x >> 20) >= f;  // x >= f << 20
    words[idx] = (uint16_t)x;  // read back only where the flag is set
    flags[idx] = emit ? 1 : 0;
    if (emit) x >>= 16;
    x = ((x / f) << kProbBits) + (x % f) + c;
  }
  states[lane] = x;
}

// ---------------------------------------------------------------------------
// Compact: rank = exclusive prefix of the flags in flat (step, lane) order,
// then out[rank] = word. Three passes: per-tile counts, one block's scan of
// the tile counts, per-tile scan + scatter.
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 256;
constexpr int kItems = 16;  // cells per thread
constexpr int kTile = kScanThreads * kItems;
constexpr int kTileScanThreads = 1024;

// Bit k of the result is cell base+k's flag; cells at or past m read as 0.
__device__ __forceinline__ uint32_t load_flags(const uint8_t* __restrict__ flags,
                                               long long base, long long m) {
  uint32_t mask = 0;
  if (base + kItems <= m) {
    const uint4 v = *reinterpret_cast<const uint4*>(flags + base);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b = w[k] & 0x01010101u;
      mask |= ((b & 1u) | ((b >> 7) & 2u) | ((b >> 14) & 4u) |
               ((b >> 21) & 8u)) << (4 * k);
    }
  } else {
    for (int k = 0; k < kItems; ++k)
      if (base + k < m && flags[base + k]) mask |= 1u << k;
  }
  return mask;
}

// Exclusive prefix of v over the block and the block's total. `sums` is 32
// ints of shared memory; safe to call again after the values were used.
__device__ __forceinline__ int block_exclusive(int v, int* sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int incl = warp_inclusive(v, lane);
  __syncthreads();  // the last call's readers are done with sums
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  const int ws = lane < nwarps ? sums[lane] : 0;
  const int wincl = warp_inclusive(ws, lane);
  total = __shfl_sync(kFullMask, wincl, 31);
  const int warp_off = __shfl_sync(kFullMask, wincl - ws, warp);
  return warp_off + incl - v;
}

__global__ void __launch_bounds__(kScanThreads)
rans_tile_counts_kernel(const uint8_t* __restrict__ flags, long long m,
                        int* __restrict__ tile_counts) {
  __shared__ int sums[32];
  const long long base =
      ((long long)blockIdx.x * kScanThreads + threadIdx.x) * kItems;
  int total;
  block_exclusive(__popc(load_flags(flags, base, m)), sums, total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kTileScanThreads)
rans_scan_tiles_kernel(const int* __restrict__ tile_counts, int num_tiles,
                       long long* __restrict__ tile_offsets,
                       long long* __restrict__ total_out) {
  __shared__ int sums[32];
  long long carry = 0;
  for (int t0 = 0; t0 < num_tiles; t0 += kTileScanThreads) {
    const int t = t0 + threadIdx.x;
    const int v = t < num_tiles ? tile_counts[t] : 0;
    int total;
    const int excl = block_exclusive(v, sums, total);
    if (t < num_tiles) tile_offsets[t] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) *total_out = carry;
}

__global__ void __launch_bounds__(kScanThreads)
rans_scatter_kernel(const uint16_t* __restrict__ words,
                    const uint8_t* __restrict__ flags, long long m,
                    const long long* __restrict__ tile_offsets,
                    uint16_t* __restrict__ out) {
  __shared__ int sums[32];
  const long long base =
      ((long long)blockIdx.x * kScanThreads + threadIdx.x) * kItems;
  uint32_t mask = load_flags(flags, base, m);
  int total;
  const int excl = block_exclusive(__popc(mask), sums, total);
  long long pos = tile_offsets[blockIdx.x] + excl;
  while (mask) {
    const int k = __ffs(mask) - 1;
    mask &= mask - 1;
    out[pos++] = words[base + k];
  }
}

// ---------------------------------------------------------------------------
// Decode: one block; thread i owns the K contiguous lanes [i*K, (i+1)*K).
// Per step every lane resolves its symbol from the slot table and updates
// its state; the lanes that fell below 1<<16 take consecutive words in lane
// order, so each needs the exclusive prefix of the need flags over all the
// lanes: a block scan of the per-thread counts between two steps.
// ---------------------------------------------------------------------------

constexpr int kDecodeMaxThreads = 1024;

template <int K>
__global__ void __launch_bounds__(kDecodeMaxThreads)
rans_decode_kernel(const uint16_t* __restrict__ words, long long total_words,
                   const uint32_t* __restrict__ states,
                   const uint32_t* __restrict__ slot_tab,  // (4096,)
                   int steps, int lanes, uint8_t* __restrict__ out,
                   long long* __restrict__ consumed) {
  __shared__ uint32_t tab[kSlots];  // (freq-1) | cum << 12 | sym << 24
  __shared__ int sums[2][32];
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) tab[i] = slot_tab[i];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lane0 = threadIdx.x * K;
  const bool live = lane0 < lanes;  // lanes is a multiple of K or below 32
  uint32_t x[K];
#pragma unroll
  for (int j = 0; j < K; ++j) x[j] = live ? states[lane0 + j] : kRansL;
  __syncthreads();

  long long base = 0;
  for (int t = 0; t < steps; ++t) {
    uint32_t need = 0;
    uint32_t pk[(K + 3) / 4] = {0};
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint32_t slot = x[j] & (kSlots - 1);
      const uint32_t e = tab[slot];
      const uint32_t f = (e & 0xFFFu) + 1;
      const uint32_t c = (e >> 12) & 0xFFFu;
      pk[j / 4] |= (e >> 24) << (8 * (j % 4));
      x[j] = f * (x[j] >> kProbBits) + slot - c;
      if (live && x[j] < kRansL) need |= 1u << j;
    }
    if (live) {
      uint8_t* p = out + (long long)t * lanes + lane0;
      if constexpr (K == 16) {
        *reinterpret_cast<uint4*>(p) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      } else if constexpr (K == 8) {
        *reinterpret_cast<uint2*>(p) = make_uint2(pk[0], pk[1]);
      } else if constexpr (K == 4) {
        *reinterpret_cast<uint32_t*>(p) = pk[0];
      } else {
#pragma unroll
        for (int j = 0; j < K; ++j) p[j] = (uint8_t)(pk[0] >> (8 * j));
      }
    }
    // block scan of the per-thread need counts; the partial sums are double
    // buffered so one barrier per step is enough
    const int cnt = __popc(need);
    const int incl = warp_inclusive(cnt, lane);
    int* s = sums[t & 1];
    if (lane == 31) s[warp] = incl;
    __syncthreads();
    const int ws = lane < nwarps ? s[lane] : 0;
    const int wincl = warp_inclusive(ws, lane);
    const int step_total = __shfl_sync(kFullMask, wincl, 31);
    const int warp_off = __shfl_sync(kFullMask, wincl - ws, warp);
    long long pos = base + warp_off + incl - cnt;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (need & (1u << j)) {
        // a corrupt stream can ask for more words than it carries: read
        // zeros instead, and let the consumed count tell the wrapper
        const uint32_t w = pos < total_words ? (uint32_t)words[pos] : 0u;
        x[j] = (x[j] << 16) | w;
        ++pos;
      }
    }
    base += step_total;
  }
  if (threadIdx.x == 0) *consumed = base;
}

template <int K>
int launch_decode(const void* words, long long total_words, const void* states,
                  const void* slot_tab, int steps, int lanes, void* out,
                  void* consumed, cudaStream_t stream) {
  int threads = lanes / K;
  if (threads < 32) threads = 32;
  rans_decode_kernel<K><<<1, threads, 0, stream>>>(
      (const uint16_t*)words, total_words, (const uint32_t*)states,
      (const uint32_t*)slot_tab, steps, lanes, (uint8_t*)out,
      (long long*)consumed);
  return (int)cudaGetLastError();
}

inline bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" {

// Each returns the cudaError_t of its (last) launch, 0 on success.

// data: n bytes; words, flags: steps*lanes cells; states: lanes.
int fq_rans_encode(const void* data, long long n, int steps, int lanes,
                   int pad_sym, const void* freq_cum, void* words, void* flags,
                   void* states, void* stream) {
  if (!pow2(lanes) || steps <= 0 || n <= 0 || n > (long long)steps * lanes)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((lanes + kEncodeThreads - 1) / kEncodeThreads);
  rans_encode_kernel<<<grid, kEncodeThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, n, steps, lanes, pad_sym,
      (const uint32_t*)freq_cum, (uint16_t*)words, (uint8_t*)flags,
      (uint32_t*)states);
  return (int)cudaGetLastError();
}

// words, flags, out: m cells; tile_counts (int32), tile_offsets (int64):
// ceil(m / 4096) entries of scratch; total: one int64.
int fq_rans_compact(const void* words, const void* flags, long long m,
                    void* tile_counts, void* tile_offsets, void* out,
                    void* total, void* stream) {
  if (m <= 0 || m > (1ll << 40)) return (int)cudaErrorInvalidValue;
  const int tiles = (int)((m + kTile - 1) / kTile);
  cudaStream_t s = (cudaStream_t)stream;
  rans_tile_counts_kernel<<<tiles, kScanThreads, 0, s>>>(
      (const uint8_t*)flags, m, (int*)tile_counts);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  rans_scan_tiles_kernel<<<1, kTileScanThreads, 0, s>>>(
      (const int*)tile_counts, tiles, (long long*)tile_offsets,
      (long long*)total);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  rans_scatter_kernel<<<tiles, kScanThreads, 0, s>>>(
      (const uint16_t*)words, (const uint8_t*)flags, m,
      (const long long*)tile_offsets, (uint16_t*)out);
  return (int)cudaGetLastError();
}

// words: total_words u16; states: lanes u32; slot_tab: 4096 u32; out:
// steps*lanes bytes; consumed: one int64. lanes: a power of two up to 16384.
int fq_rans_decode(const void* words, long long total_words, const void* states,
                   const void* slot_tab, int steps, int lanes, void* out,
                   void* consumed, void* stream) {
  if (!pow2(lanes) || lanes > 16 * kDecodeMaxThreads || steps <= 0 ||
      total_words < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int k = lanes <= kDecodeMaxThreads ? 1 : lanes / kDecodeMaxThreads;
  switch (k) {
    case 1:
      return launch_decode<1>(words, total_words, states, slot_tab, steps,
                              lanes, out, consumed, s);
    case 2:
      return launch_decode<2>(words, total_words, states, slot_tab, steps,
                              lanes, out, consumed, s);
    case 4:
      return launch_decode<4>(words, total_words, states, slot_tab, steps,
                              lanes, out, consumed, s);
    case 8:
      return launch_decode<8>(words, total_words, states, slot_tab, steps,
                              lanes, out, consumed, s);
    default:
      return launch_decode<16>(words, total_words, states, slot_tab, steps,
                               lanes, out, consumed, s);
  }
}

}  // extern "C"
