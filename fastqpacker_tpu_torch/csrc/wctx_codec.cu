// Wide-interleaved context-modeled rANS (FQZ v3 TAG_WCTX) on Hopper (sm_90a):
// the lockstep encode and the lockstep decode, with a plain C interface for
// ctypes.
//
// fq_wctx_encode replaces the XLA program _encode_kernel
//                (fastqpacker_tpu/ops/wctx.py:511, with _ctx_fetch :466),
// fq_wctx_decode replaces _decode_kernel (ops/wctx.py:577).
//
// The coder: lane l of N codes a contiguous, record-aligned segment of the
// stream, one symbol per step, so cell (t, l) of an (S, N) matrix is the
// t-th symbol of lane l and cells at t >= seg[l] are padding that is not
// coded. The probability of a symbol comes from the row of its context in a
// (C, npres + 1) table of cumulative 12-bit frequencies whose last column
// is the row's total: c = row[sym], f = row[sym + 1] - c. 32-bit state from
// 1 << 16, 16-bit renormalisation words, stored in ascending (step, lane)
// order, which is the order the forward decoder reads them in.
//
// What bounds them. By bytes the work is small (encode reads three bytes and
// writes three per cell, decode reads about two and writes one), but both
// are chains of S dependent state updates per lane, each with a table
// read that depends on the lane's context; decode also resolves the symbol by
// a binary search of the row and needs a prefix over all lanes between two
// steps. So their time is steps x (latency of one update). The design keeps
// the update short: the table sits in shared memory when it fits (every
// table but the 3,072-context quality model's, which is read through the
// read-only cache), the division is the hardware's, states and contexts
// stay in registers, loads and stores are coalesced across lanes. The TPU
// formulation (int8 one-hot matrix products for the row fetch, telescoping
// sums for the symbol, flip/roll row reversal, roll-ladder scans) is not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kProbBits = 12;
constexpr uint32_t kProbScale = 1u << kProbBits;

// quality-context geometry (ops/wctx.py, ops/qualctx.py)
constexpr int kQBins = 48;
constexpr int kPBuckets = 8;
constexpr int kQ2Buckets = 8;
constexpr int kPosCap = 4000;  // positions past 112 share the last bucket

// A block may use 227 KB of shared memory; keep room for the static part.
constexpr int kMaxSharedTable = 200 * 1024;

template <bool kShared>
__device__ __forceinline__ uint32_t tab_at(const uint16_t* tab, int i) {
  if constexpr (kShared) {
    return tab[i];
  } else {
    return __ldg(tab + i);
  }
}

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
// Encode: one thread per lane, rows walked backwards from seg[lane] - 1.
// ---------------------------------------------------------------------------

constexpr int kEncodeThreads = 128;

template <bool kShared>
__global__ void __launch_bounds__(kEncodeThreads)
wctx_encode_kernel(const uint8_t* __restrict__ sym,    // (S, N) present index
                   const uint16_t* __restrict__ ctx,   // (S, N) context id
                   const int* __restrict__ seg,        // (N,) symbols per lane
                   const uint16_t* __restrict__ tab_g, // (C, width)
                   int contexts, int width, int steps, int lanes,
                   uint16_t* __restrict__ words, uint8_t* __restrict__ flags,
                   uint32_t* __restrict__ states, int* __restrict__ status) {
  extern __shared__ uint16_t tab_s[];
  if constexpr (kShared) {
    const int cells = contexts * width;
    for (int i = threadIdx.x; i < cells; i += kEncodeThreads) tab_s[i] = tab_g[i];
    __syncthreads();
  }
  const uint16_t* tab = kShared ? tab_s : tab_g;
  const int lane = blockIdx.x * kEncodeThreads + threadIdx.x;
  if (lane >= lanes) return;

  int n = seg[lane];
  n = n < 0 ? 0 : (n > steps ? steps : n);
  // padding cells carry no word
  for (int t = steps - 1; t >= n; --t) {
    const long long idx = (long long)t * lanes + lane;
    words[idx] = 0;
    flags[idx] = 0;
  }
  uint32_t x = kRansL;
  bool bad = false;
#pragma unroll 4
  for (int t = n - 1; t >= 0; --t) {
    const long long idx = (long long)t * lanes + lane;
    const int s = sym[idx];
    const int c = ctx[idx];
    uint32_t cum = 0, f = 1;
    if (s < width - 1 && c < contexts) {
      const int at = c * width + s;
      cum = tab_at<kShared>(tab, at);
      f = tab_at<kShared>(tab, at + 1) - cum;
      if (f - 1u >= kProbScale) {  // zero, or a table that is not monotone
        bad = true;
        f = 1;
      }
    } else {
      bad = true;
    }
    const bool emit = (x >> 20) >= f;  // x >= f << 20
    words[idx] = (uint16_t)x;  // read back only where the flag is set
    flags[idx] = emit ? 1 : 0;
    if (emit) x >>= 16;
    x = ((x / f) << kProbBits) + (x % f) + cum;
  }
  states[lane] = x;
  if (bad) atomicOr(status, 1);
}

// ---------------------------------------------------------------------------
// Decode: one block; thread i owns the K contiguous lanes [i*K, (i+1)*K).
// Per step every live lane advances its context, finds the last column of the
// context's row that is <= the state's low 12 bits, and updates its state;
// the lanes that fell below 1 << 16 take consecutive words in lane order, so
// each needs the exclusive prefix of the need flags over all the lanes: a
// block scan of the per-thread counts between two steps.
//
// Per-lane context state in one word. Sequence model: the context in bits
// 0-15, the previous raw symbol in bits 16-23. Quality model: position + 1
// (capped) in bits 0-15, the previous raw symbol in bits 16-23, the one
// before it in bits 24-31.
// ---------------------------------------------------------------------------

constexpr int kDecodeMaxThreads = 1024;

template <int K, bool kQual, bool kShared>
__global__ void __launch_bounds__(kDecodeMaxThreads)
wctx_decode_kernel(const uint16_t* __restrict__ words, long long total_words,
                   const uint32_t* __restrict__ states,
                   const uint8_t* __restrict__ startm,  // (S, N) 0/1
                   const int* __restrict__ seg,
                   const uint16_t* __restrict__ tab_g,  // (C, width)
                   int contexts, int width,
                   const uint8_t* __restrict__ present,  // (width - 1,)
                   int order, int steps, int lanes,
                   uint8_t* __restrict__ out,  // (S, N) present index
                   long long* __restrict__ info) {
  extern __shared__ uint16_t tab_s[];
  __shared__ uint8_t pres[256];
  __shared__ int sums[2][32];
  const int npres = width - 1;
  if constexpr (kShared) {
    const int cells = contexts * width;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) tab_s[i] = tab_g[i];
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    pres[i] = i < npres ? present[i] : 0;
  const uint16_t* tab = kShared ? tab_s : tab_g;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lane0 = threadIdx.x * K;
  const bool owner = lane0 < lanes;  // lanes is a multiple of K or below 32
  const uint32_t seq_mask = (1u << (2 * order)) - 1;

  uint32_t x[K];
  uint32_t m[K];
  int n[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    x[j] = owner ? states[lane0 + j] : kRansL;
    m[j] = 0;
    int s = owner ? seg[lane0 + j] : 0;
    n[j] = s < 0 ? 0 : (s > steps ? steps : s);
  }
  __syncthreads();

  bool bad = false;
  long long base = 0;
  for (int t = 0; t < steps; ++t) {
    uint32_t need = 0;
    uint32_t pk[(K + 3) / 4] = {0};
    uint32_t st[(K + 3) / 4] = {0};
    if (owner) {
      const uint8_t* p = startm + (long long)t * lanes + lane0;
      if constexpr (K == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        st[0] = v.x;
        st[1] = v.y;
      } else if constexpr (K == 4) {
        st[0] = *reinterpret_cast<const uint32_t*>(p);
      } else {
#pragma unroll
        for (int j = 0; j < K; ++j) st[0] |= (uint32_t)p[j] << (8 * j);
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (t >= n[j]) continue;  // padding: trailing cells only
      const bool start = (st[j / 4] >> (8 * (j % 4))) & 0xFFu;
      const uint32_t prev = (m[j] >> 16) & 0xFFu;
      int c;
      if constexpr (kQual) {
        int pp = m[j] & 0xFFFFu;  // position + 1
        pp = start ? 1 : (pp < kPosCap ? pp + 1 : pp);
        const int pos = pp - 1;
        const int qbin = start ? kQBins - 1 : (prev < 46 ? (int)prev : 46);
        const int pb = (pos >> 4) < kPBuckets - 1 ? (pos >> 4) : kPBuckets - 1;
        c = pb * kQBins + qbin;
        if (order == 1) {
          const uint32_t prev2 = m[j] >> 24;
          const int q2b = pos >= 2 ? (int)((prev2 < 46 ? prev2 : 46) >> 3)
                                   : kQ2Buckets - 1;
          c = c * kQ2Buckets + q2b;
        }
        m[j] = (m[j] & 0xFFFF0000u) | (uint32_t)pp;
      } else {
        c = start ? 0 : (int)((((m[j] & 0xFFFFu) << 2) | prev) & seq_mask);
        m[j] = (m[j] & 0xFFFF0000u) | (uint32_t)c;
      }
      const int row = c * width;
      const uint32_t slot = x[j] & (kProbScale - 1);
      int lo = 0, hi = npres;  // last column with row[column] <= slot
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (tab_at<kShared>(tab, row + mid) <= slot) {
          lo = mid;
        } else {
          hi = mid;
        }
      }
      const uint32_t cum = tab_at<kShared>(tab, row + lo);
      uint32_t f = tab_at<kShared>(tab, row + lo + 1) - cum;
      if (f - 1u >= kProbScale) {  // a context the table does not hold
        bad = true;
        f = 1;
      }
      x[j] = f * (x[j] >> kProbBits) + slot - cum;
      if (x[j] < kRansL) need |= 1u << j;
      pk[j / 4] |= (uint32_t)lo << (8 * (j % 4));
      // contexts see raw symbol values, not present indices
      m[j] = (m[j] & 0xFFFFu) | ((uint32_t)pres[lo] << 16) | (prev << 24);
    }
    if (owner) {
      uint8_t* p = out + (long long)t * lanes + lane0;
      if constexpr (K == 8) {
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
  const int any_bad = __syncthreads_or(bad ? 1 : 0);
  if (threadIdx.x == 0) {
    info[0] = base;
    info[1] = any_bad;
  }
}

template <int K, bool kQual, bool kShared>
int launch_decode(const void* words, long long total_words, const void* states,
                  const void* startm, const void* seg, const void* tab,
                  int contexts, int width, const void* present, int order,
                  int steps, int lanes, void* out, void* info,
                  cudaStream_t stream) {
  int threads = lanes / K;
  if (threads < 32) threads = 32;
  const size_t shared =
      kShared ? (size_t)contexts * width * sizeof(uint16_t) : 0;
  auto kernel = wctx_decode_kernel<K, kQual, kShared>;
  if (shared > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<1, threads, shared, stream>>>(
      (const uint16_t*)words, total_words, (const uint32_t*)states,
      (const uint8_t*)startm, (const int*)seg, (const uint16_t*)tab, contexts,
      width, (const uint8_t*)present, order, steps, lanes, (uint8_t*)out,
      (long long*)info);
  return (int)cudaGetLastError();
}

template <int K>
int launch_decode_k(bool qual, bool shared, const void* words,
                    long long total_words, const void* states,
                    const void* startm, const void* seg, const void* tab,
                    int contexts, int width, const void* present, int order,
                    int steps, int lanes, void* out, void* info,
                    cudaStream_t s) {
  if (qual) {
    if (shared)
      return launch_decode<K, true, true>(words, total_words, states, startm,
                                          seg, tab, contexts, width, present,
                                          order, steps, lanes, out, info, s);
    return launch_decode<K, true, false>(words, total_words, states, startm,
                                         seg, tab, contexts, width, present,
                                         order, steps, lanes, out, info, s);
  }
  if (shared)
    return launch_decode<K, false, true>(words, total_words, states, startm,
                                         seg, tab, contexts, width, present,
                                         order, steps, lanes, out, info, s);
  return launch_decode<K, false, false>(words, total_words, states, startm,
                                        seg, tab, contexts, width, present,
                                        order, steps, lanes, out, info, s);
}

inline bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

inline bool table_ok(int contexts, int width) {
  return contexts > 0 && width >= 2 && width <= 257 &&
         (long long)contexts * width <= (1ll << 24);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch, 0 on success.

// sym (u8), ctx (u16): steps*lanes cells; seg: lanes int32; tab: contexts *
// width u16; words (u16), flags (u8): steps*lanes cells; states: lanes u32;
// status: one int32, zeroed by the caller, set to 1 when a live cell met a
// zero frequency or an index outside the table.
int fq_wctx_encode(const void* sym, const void* ctx, const void* seg,
                   const void* tab, int contexts, int width, int steps,
                   int lanes, void* words, void* flags, void* states,
                   void* status, void* stream) {
  if (!pow2(lanes) || steps <= 0 || !table_ok(contexts, width))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((lanes + kEncodeThreads - 1) / kEncodeThreads);
  const size_t bytes = (size_t)contexts * width * sizeof(uint16_t);
  cudaStream_t s = (cudaStream_t)stream;
  if (bytes <= (size_t)kMaxSharedTable) {
    auto kernel = wctx_encode_kernel<true>;
    if (bytes > 48 * 1024) {
      const cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (rc != cudaSuccess) return (int)rc;
    }
    kernel<<<grid, kEncodeThreads, bytes, s>>>(
        (const uint8_t*)sym, (const uint16_t*)ctx, (const int*)seg,
        (const uint16_t*)tab, contexts, width, steps, lanes, (uint16_t*)words,
        (uint8_t*)flags, (uint32_t*)states, (int*)status);
  } else {
    wctx_encode_kernel<false><<<grid, kEncodeThreads, 0, s>>>(
        (const uint8_t*)sym, (const uint16_t*)ctx, (const int*)seg,
        (const uint16_t*)tab, contexts, width, steps, lanes, (uint16_t*)words,
        (uint8_t*)flags, (uint32_t*)states, (int*)status);
  }
  return (int)cudaGetLastError();
}

// words: total_words u16; states: lanes u32; startm (u8 0/1): steps*lanes;
// seg: lanes int32; tab: contexts * width u16; present: width - 1 bytes;
// model 0 (sequence, order 2/4/6) or 1 (quality, order 0/1); out: steps*lanes
// bytes; info: two int64 (words consumed, 1 if a live cell met a context the
// table does not hold). lanes: a power of two up to 8192.
int fq_wctx_decode(const void* words, long long total_words, const void* states,
                   const void* startm, const void* seg, const void* tab,
                   int contexts, int width, const void* present, int model,
                   int order, int steps, int lanes, void* out, void* info,
                   void* stream) {
  if (!pow2(lanes) || lanes > 8 * kDecodeMaxThreads || steps <= 0 ||
      total_words < 0 || !table_ok(contexts, width) || model < 0 || model > 1 ||
      order < 0 || order > 6)
    return (int)cudaErrorInvalidValue;
  const bool qual = model == 1;
  const bool shared =
      (size_t)contexts * width * sizeof(uint16_t) <= (size_t)kMaxSharedTable;
  cudaStream_t s = (cudaStream_t)stream;
  const int k = lanes <= kDecodeMaxThreads ? 1 : lanes / kDecodeMaxThreads;
  switch (k) {
    case 1:
      return launch_decode_k<1>(qual, shared, words, total_words, states,
                                startm, seg, tab, contexts, width, present,
                                order, steps, lanes, out, info, s);
    case 2:
      return launch_decode_k<2>(qual, shared, words, total_words, states,
                                startm, seg, tab, contexts, width, present,
                                order, steps, lanes, out, info, s);
    case 4:
      return launch_decode_k<4>(qual, shared, words, total_words, states,
                                startm, seg, tab, contexts, width, present,
                                order, steps, lanes, out, info, s);
    default:
      return launch_decode_k<8>(qual, shared, words, total_words, states,
                                startm, seg, tab, contexts, width, present,
                                order, steps, lanes, out, info, s);
  }
}

}  // extern "C"
