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
// are chains of S dependent state updates per lane; decode also needs a
// prefix over all lanes between two steps. So their time is steps x (latency
// of one step), and the design takes every load from device memory off that
// chain and spreads the lanes over as many SMs as the chain allows:
//
// - encode: one warp per CTA (64-256 CTAs at the 2,048-8,192-lane tiers),
//   one thread per lane. The symbol and context rows are staged into shared
//   memory ahead of the backward walk, tiles of kEncodeTile steps x 32 lanes,
//   double buffered with cp.async; the table sits in shared memory when it
//   fits, else it is read through the read-only cache (its reads depend on
//   the staged data only, not on the state).
// - decode: the lanes are split over a thread block cluster of G CTAs (one
//   per SM), one lane per thread. Per step a warp counts its refills with
//   a ballot and sends the count to every CTA of the cluster with an
//   asynchronous remote store (st.async) that completes on the receiver's
//   mbarrier: there is no cluster barrier in the loop, since a release at
//   cluster scope waits for the copies in flight. Two warp reductions over
//   the cluster's warp counts give each warp its offset and the step's
//   total. The word stream is staged in a shared-memory ring that cp.async
//   keeps two steps' worst case ahead of the words consumed, the start-mask
//   rows kRowsAhead steps ahead, and a step waits only for the oldest copy
//   groups it needs, then meets the other warps of its CTA at one barrier. The symbol search
//   is a fixed-depth binary lifting over the row, in each CTA's shared memory
//   where the table fits beside the ring, else through the read-only cache.
//   fq_wctx_decode derives the cluster geometry from the lane count and the
//   table size (decode_geometry) and refuses one the card cannot schedule.
//
// The TPU formulation (int8 one-hot matrix products for the row fetch,
// telescoping sums for the symbol, flip/roll row reversal, roll-ladder scans)
// is not carried over.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <tuple>

namespace cg = cooperative_groups;

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

// A block may use 227 KB of shared memory (232,448 bytes); the static part
// of the decode kernel takes under 4 KB.
constexpr int kMaxDynamicShared = 232448 - 4096;
constexpr int kMaxSharedTable = 200 * 1024;  // encode

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copy `count` u16 from device to shared memory: 16-byte cp.async chunks
// (both ends 16-byte aligned) and plain loads for the tail. The caller
// commits and waits.
__device__ __forceinline__ void stage_u16(uint16_t* dst, const uint16_t* src,
                                          int count, int tid, int nthreads) {
  const int chunks = count / 8;
  for (int i = tid; i < chunks; i += nthreads) cp_async16(dst + 8 * i, src + 8 * i);
  for (int i = 8 * chunks + tid; i < count; i += nthreads) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// Encode: one warp per CTA, one thread per lane, rows walked backwards from
// seg[lane] - 1 through tiles staged ahead in shared memory.
// ---------------------------------------------------------------------------

constexpr int kEncodeThreads = 32;
constexpr int kEncodeTile = 64;  // steps per staged tile

struct EncodeTile {
  uint8_t sym[kEncodeTile][kEncodeThreads];
  uint16_t ctx[kEncodeTile][kEncodeThreads];
};
constexpr int kTileChunks = 6;  // 16-byte chunks per row: 2 of sym, 4 of ctx

template <bool kShared>
__global__ void __launch_bounds__(kEncodeThreads)
wctx_encode_kernel(const uint8_t* __restrict__ sym,    // (S, N) present index
                   const uint16_t* __restrict__ ctx,   // (S, N) context id
                   const int* __restrict__ seg,        // (N,) symbols per lane
                   const uint16_t* __restrict__ tab_g, // (C, width)
                   int contexts, int width, int steps, int lanes,
                   uint16_t* __restrict__ words, uint8_t* __restrict__ flags,
                   uint32_t* __restrict__ states, int* __restrict__ status) {
  extern __shared__ __align__(16) unsigned char smem_e[];
  EncodeTile* tiles = reinterpret_cast<EncodeTile*>(smem_e);
  uint16_t* tab_s = reinterpret_cast<uint16_t*>(smem_e + 2 * sizeof(EncodeTile));
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kEncodeThreads;
  const int lane = lane0 + tid;
  if constexpr (kShared) stage_u16(tab_s, tab_g, contexts * width, tid, kEncodeThreads);
  const uint16_t* tab = kShared ? tab_s : tab_g;

  int n = seg[lane];
  n = n < 0 ? 0 : (n > steps ? steps : n);
  const int nmax = __reduce_max_sync(kFullMask, n);
  // tile k holds the rows [max(0, hi - kEncodeTile), hi), hi = nmax - k * T
  auto issue = [&](int k) {
    const int hi = nmax - k * kEncodeTile;
    if (hi <= 0) return;
    const int lo = hi > kEncodeTile ? hi - kEncodeTile : 0;
    EncodeTile& tile = tiles[k & 1];
    for (int i = tid; i < (hi - lo) * kTileChunks; i += kEncodeThreads) {
      const int r = i / kTileChunks, part = i % kTileChunks;
      const long long cell = (long long)(lo + r) * lanes + lane0;
      if (part < 2) {
        cp_async16(&tile.sym[r][16 * part], sym + cell + 16 * part);
      } else {
        cp_async16(&tile.ctx[r][8 * (part - 2)], ctx + cell + 8 * (part - 2));
      }
    }
  };
  issue(0);
  cp_async_commit();

  // padding cells carry no word
  for (int t = steps - 1; t >= n; --t) {
    const long long idx = (long long)t * lanes + lane;
    words[idx] = 0;
    flags[idx] = 0;
  }
  uint32_t x = kRansL;
  bool bad = false;
  for (int k = 0; nmax - k * kEncodeTile > 0; ++k) {
    issue(k + 1);
    cp_async_commit();
    cp_async_wait<1>();  // the table and tile k have landed
    __syncwarp();
    const int hi = nmax - k * kEncodeTile;
    const int lo = hi > kEncodeTile ? hi - kEncodeTile : 0;
    const EncodeTile& tile = tiles[k & 1];
    const int top = (n < hi ? n : hi) - 1;
#pragma unroll 4
    for (int t = top; t >= lo; --t) {
      const int s = tile.sym[t - lo][tid];
      const int c = tile.ctx[t - lo][tid];
      uint32_t cum = 0, f = 1;
      if (s < width - 1 && c < contexts) {
        const int at = c * width + s;
        cum = kShared ? (uint32_t)tab[at] : (uint32_t)__ldg(tab + at);
        f = (kShared ? (uint32_t)tab[at + 1] : (uint32_t)__ldg(tab + at + 1)) - cum;
        if (f - 1u >= kProbScale) {  // zero, or a table that is not monotone
          bad = true;
          f = 1;
        }
      } else {
        bad = true;
      }
      const long long idx = (long long)t * lanes + lane;
      const bool emit = (x >> 20) >= f;  // x >= f << 20
      words[idx] = (uint16_t)x;  // read back only where the flag is set
      flags[idx] = emit ? 1 : 0;
      if (emit) x >>= 16;
      x = ((x / f) << kProbBits) + (x % f) + cum;
    }
    __syncwarp();  // tile k is read before tile k + 2 overwrites it
  }
  cp_async_wait<0>();
  states[lane] = x;
  if (bad) atomicOr(status, 1);
}

// ---------------------------------------------------------------------------
// Decode: a cluster of G CTAs; thread i of CTA r owns lane r * threads + i.
// Per step every live lane advances its context, finds the last column of
// the context's row that is <= the state's low 12 bits, and updates its
// state; the lanes that fell below 1 << 16 take consecutive words in lane
// order, at the exclusive prefix of the refill flags over all lanes of the
// cluster.
//
// Per-lane context state in one word. Sequence model: the context in bits
// 0-15, the previous raw symbol in bits 16-23. Quality model: position + 1
// (capped) in bits 0-15, the previous raw symbol in bits 16-23, the one
// before it in bits 24-31.
// ---------------------------------------------------------------------------

constexpr int kCtaThreads = 256;  // threads per CTA up to 4,096 lanes
constexpr int kDecodeMaxThreads = 512;
constexpr int kDecodeMaxWarps = kDecodeMaxThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kRowsAhead = 7;  // start-mask rows staged ahead of the step
constexpr int kStartSlots = 8;  // > kRowsAhead: a row is read before its slot is refilled
constexpr int kMaxPending = kRowsAhead - 1;  // copy groups a step may leave in flight
constexpr int kRingPerLane = 4;  // ring words per lane: 2 steps' worst case
                                 // ahead, one step in use, alignment slack

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of `p` (in this CTA's shared memory) in the shared memory of
// CTA `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// Store `v` into another CTA's shared memory and count its 4 bytes on that
// CTA's mbarrier (an asynchronous store: no fence, no cluster barrier).
__device__ __forceinline__ void st_async_u32(unsigned remote, int v, unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];\n"
      ::"r"(remote), "r"(v), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
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

// the table in each CTA's shared memory, or in device memory through the
// read-only cache
template <bool kTabShared>
__device__ __forceinline__ uint32_t row_at(const uint16_t* row, int i) {
  if constexpr (kTabShared) {
    return row[i];
  } else {
    return __ldg(row + i);
  }
}

template <bool kQual, bool kTabShared>
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
  extern __shared__ __align__(16) unsigned char smem_d[];
  // the refill counts of every warp of the cluster, per step (two slots used
  // in turn), and their arrival
  __shared__ __align__(16) int wcnt[2][kMaxCluster * kDecodeMaxWarps];
  __shared__ __align__(8) uint64_t cbar[2];
  __shared__ uint8_t pres[256];
  __shared__ uint16_t tailw[8];
  __shared__ int cbad;
  cg::cluster_group cluster = cg::this_cluster();

  const int G = gridDim.x;  // the grid is one cluster
  const int rank = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int my_lane = rank * nthreads + tid;
  const int npres = width - 1;
  const uint32_t seq_mask = (1u << (2 * order)) - 1;

  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_d);
  const long long rmask = (long long)kRingPerLane * lanes - 1;
  uint8_t* srow = smem_d + 2 * kRingPerLane * lanes;
  uint16_t* tab_s = reinterpret_cast<uint16_t*>(srow + kStartSlots * nthreads);
  const long long full_end = total_words & ~7ll;  // words staged in chunks
  const long long ahead = 2ll * lanes;
  long long filled = 0;  // words requested so far

  auto request_words = [&](long long upto) {
    const long long q1 = ((upto < full_end ? upto : full_end) + 7) >> 3;
    for (long long q = (filled >> 3) + tid; q < q1; q += nthreads)
      cp_async16(ring + ((q << 3) & rmask), words + (q << 3));
    if ((q1 << 3) > filled) filled = q1 << 3;
  };
  auto request_row = [&](int r) {
    if (r >= steps) return;
    const uint8_t* src = startm + (long long)r * lanes + rank * nthreads;
    uint8_t* dst = srow + (r % kStartSlots) * nthreads;
    for (int i = tid; i < nthreads / 16; i += nthreads) cp_async16(dst + 16 * i, src + 16 * i);
  };

  // prologue: the table, the first rows and words, the word tail
  if constexpr (kTabShared) stage_u16(tab_s, tab_g, contexts * width, tid, nthreads);
  for (int i = tid; i < 256; i += nthreads) pres[i] = i < npres ? present[i] : 0;
  // slots past the cluster's warps stay 0: the count reads take four at a time
  for (int i = tid; i < kMaxCluster * kDecodeMaxWarps; i += nthreads) {
    wcnt[0][i] = 0;
    wcnt[1][i] = 0;
  }
  if (tid < 8) {
    const long long p = full_end + tid;
    tailw[tid] = p < total_words ? words[p] : 0;
  }
  if (tid == 0) {
    cbad = 0;
    mbar_init(&cbar[0], 1);
    mbar_init(&cbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int r = 0; r < kRowsAhead; ++r) request_row(r);
  request_words(ahead);
  cp_async_commit();
  // cov[p]: the words requested by the copy groups up to the (p + 1)-th
  // newest; groups before the first step's are complete
  long long cov[kMaxPending + 1];
#pragma unroll
  for (int p = 0; p <= kMaxPending; ++p) cov[p] = filled;

  uint32_t x = states[my_lane];
  uint32_t m = 0;
  int n = seg[my_lane];
  n = n < 0 ? 0 : (n > steps ? steps : n);
  // binary lifting over the columns [0, npres): the largest power of two
  // <= npres - 1 (0 when there is one symbol)
  const int top = npres > 1 ? 1 << (31 - __clz(npres - 1)) : 0;
  cp_async_wait<0>();
  __syncthreads();
  if (G > 1) cluster_barrier();  // every CTA's cbad and cbar are set
  const int me = rank * nwarps + warp;  // this warp in the cluster
  const int cluster_warps = G * nwarps;

  bool bad = false;
  long long base = 0;
  for (int t = 0; t < steps; ++t) {
    // Stage ahead, in one group per step: start-mask row t + kRowsAhead and
    // the words up to base(t) + 2 * lanes. The group of step t - 1 covers
    // base(t - 1) + 2 * lanes >= base(t) + lanes, a step's most, so a step
    // never waits for its own group. A ring of 4 * lanes words overwrites
    // only words below base(t - 1), which every thread has read before the
    // barrier of step t - 1.
    request_row(t + kRowsAhead);
    request_words(base + ahead);
    cp_async_commit();
#pragma unroll
    for (int p = kMaxPending; p > 0; --p) cov[p] = cov[p - 1];
    cov[0] = filled;

    const bool live = t < n;  // padding: trailing cells only
    const bool start = srow[(t % kStartSlots) * nthreads + tid];
    const uint32_t prev = (m >> 16) & 0xFFu;
    int c;
    if constexpr (kQual) {
      int pp = m & 0xFFFFu;  // position + 1
      pp = start ? 1 : (pp < kPosCap ? pp + 1 : pp);
      const int pos = pp - 1;
      const int qbin = start ? kQBins - 1 : (prev < 46 ? (int)prev : 46);
      const int pb = (pos >> 4) < kPBuckets - 1 ? (pos >> 4) : kPBuckets - 1;
      c = pb * kQBins + qbin;
      if (order == 1) {
        const uint32_t prev2 = m >> 24;
        const int q2b = pos >= 2 ? (int)((prev2 < 46 ? prev2 : 46) >> 3)
                                 : kQ2Buckets - 1;
        c = c * kQ2Buckets + q2b;
      }
      if (live) m = (m & 0xFFFF0000u) | (uint32_t)pp;
    } else {
      c = start ? 0 : (int)((((m & 0xFFFFu) << 2) | prev) & seq_mask);
      if (live) m = (m & 0xFFFF0000u) | (uint32_t)c;
    }
    const uint16_t* rowp = (kTabShared ? tab_s : tab_g) + c * width;
    const uint32_t slot = x & (kProbScale - 1);
    // last column with row[column] <= slot, fixed depth
    int lo = 0;
#pragma unroll
    for (int b = 0; b < 9; ++b) {
      const int step = top >> b;
      if (step == 0) break;
      const int mid = lo + step;
      const uint32_t v = row_at<kTabShared>(rowp, mid < npres ? mid : npres - 1);
      lo = (mid < npres && v <= slot) ? mid : lo;
    }
    const uint32_t cum = row_at<kTabShared>(rowp, lo);
    uint32_t f = row_at<kTabShared>(rowp, lo + 1) - cum;
    if (f - 1u >= kProbScale) {  // a context the table does not hold
      bad |= live;
      f = 1;
    }
    const uint32_t y = f * (x >> kProbBits) + slot - cum;
    const bool need = live && y < kRansL;
    if (live) {
      x = y;
      // contexts see raw symbol values, not present indices
      m = (m & 0xFFFFu) | ((uint32_t)pres[lo] << 16) | (prev << 24);
    }
    out[(long long)t * lanes + my_lane] = live ? (uint8_t)lo : 0;

    // refill ranks: within the warp by ballot, across the cluster from the
    // warp counts, which every warp sends to every CTA of the cluster
    const unsigned nb = __ballot_sync(kFullMask, need);
    const int in_warp = __popc(nb & ((1u << lane) - 1u));
    const int slot2 = t & 1;
    if (lane < G)
      st_async_u32(cluster_addr(&wcnt[slot2][me], lane), __popc(nb),
                   cluster_addr(&cbar[slot2], lane));
    if (tid == 0) mbar_arrive_expect_tx(&cbar[slot2], 4u * cluster_warps);
    // Wait for the newest copy group older than this step's that holds this
    // step's words (up to base + lanes) and start-mask row t + 1 (in the
    // group of step t + 1 - kRowsAhead); the groups after it stay in flight.
    const long long need_end = base + lanes < full_end ? base + lanes : full_end;
    int pending = 1;
#pragma unroll
    for (int p = 2; p <= kMaxPending; ++p) pending = cov[p] >= need_end ? p : pending;
    switch (pending) {
      case 1: cp_async_wait<1>(); break;
      case 2: cp_async_wait<2>(); break;
      case 3: cp_async_wait<3>(); break;
      case 4: cp_async_wait<4>(); break;
      case 5: cp_async_wait<5>(); break;
      default: cp_async_wait<6>(); break;
    }
    __syncthreads();  // the staged words and rows are visible to all threads
    mbar_wait(&cbar[slot2], (t >> 1) & 1);
    int below = 0, all = 0;
    for (int i = 4 * lane; i < cluster_warps; i += 128) {
      const int4 v = *reinterpret_cast<const int4*>(&wcnt[slot2][i]);
      all += v.x + v.y + v.z + v.w;
      below += (i < me ? v.x : 0) + (i + 1 < me ? v.y : 0) + (i + 2 < me ? v.z : 0) +
               (i + 3 < me ? v.w : 0);
    }
    below = __reduce_add_sync(kFullMask, below);
    all = __reduce_add_sync(kFullMask, all);
    if (need) {
      // a corrupt stream can ask for more words than it carries: read zeros
      // instead, and let the consumed count tell the wrapper
      const long long pos = base + below + in_warp;
      const uint32_t w = pos < full_end ? (uint32_t)ring[pos & rmask]
                         : pos < total_words ? (uint32_t)tailw[pos - full_end]
                                             : 0u;
      x = (x << 16) | w;
    }
    base += all;
  }
  cp_async_wait<0>();
  const int any_bad = __syncthreads_or(bad ? 1 : 0);
  if (G > 1) {
    if (tid == 0 && any_bad) atomicOr(cluster.map_shared_rank(&cbad, 0), 1);
    // no CTA leaves while another may still read its shared memory
    cluster_barrier();
  } else if (tid == 0) {
    cbad = any_bad;
  }
  if (rank == 0 && tid == 0) {
    info[0] = base;
    info[1] = cbad;
  }
}

// Readies a kernel instance for `cfg` on the current device. Once per device
// and instance, under one lock: its dynamic shared memory cap is raised to
// `max_shared`, the most any launch of that instance takes, and a cluster
// kernel may take clusters past 8 CTAs; neither is ever set to another value,
// so a launch from another thread never sees a cap below its own (decode
// workers launch the sequence and quality streams, whose sizes differ, from
// several threads at once). Once per cluster geometry,
// cudaOccupancyMaxActiveClusters checks that the card can schedule it, so a
// geometry it cannot is refused with an error, never run.
cudaError_t ready_launch(const void* kernel, const cudaLaunchConfig_t& cfg,
                         int max_shared) {
  static std::mutex mu;
  static std::set<std::tuple<int, const void*>> raised;
  static std::set<std::tuple<int, const void*, unsigned, unsigned, size_t>> ok;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  if (!raised.count(std::make_tuple(dev, kernel))) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              max_shared);
    if (rc != cudaSuccess) return rc;
    if (cfg.numAttrs > 0) {  // a cluster kernel
      rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (rc != cudaSuccess) return rc;
    }
    raised.insert(std::make_tuple(dev, kernel));
  }
  if (cfg.numAttrs == 0) return cudaSuccess;
  const auto key = std::make_tuple(dev, kernel, cfg.gridDim.x, cfg.blockDim.x,
                                   cfg.dynamicSmemBytes);
  if (ok.count(key)) return cudaSuccess;
  int clusters = 0;
  rc = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (rc != cudaSuccess) return rc;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  ok.insert(key);
  return cudaSuccess;
}

inline bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

inline bool table_ok(int contexts, int width) {
  return contexts > 0 && width >= 2 && width <= 257 &&
         (long long)contexts * width <= (1ll << 24);
}

struct DecodeGeometry {
  int threads;      // per CTA, one lane each
  int cluster;      // CTAs, one cluster
  bool tab_shared;  // the table in each CTA's shared memory (else __ldg)
  long long shared; // dynamic shared bytes per CTA
};

// One lane per thread: CTAs of kCtaThreads threads in a cluster of up to
// kMaxCluster (wider CTAs past kMaxCluster * kCtaThreads lanes, one CTA up
// to kCtaThreads). Per CTA, the word ring of kRingPerLane words per lane of
// the stream, kStartSlots start-mask rows of its lanes and, where it fits,
// the table. False for a lane count the kernel does not take.
bool decode_geometry(int lanes, int contexts, int width, DecodeGeometry* g) {
  if (!pow2(lanes) || lanes < 32 || lanes > kMaxCluster * kDecodeMaxThreads ||
      !table_ok(contexts, width))
    return false;
  int threads = lanes / kMaxCluster > kCtaThreads ? lanes / kMaxCluster : kCtaThreads;
  if (threads > lanes) threads = lanes;
  g->threads = threads;
  g->cluster = lanes / threads;
  const long long fixed = 2ll * kRingPerLane * lanes + (long long)kStartSlots * threads;
  const long long tab = (long long)contexts * width * (long long)sizeof(uint16_t);
  g->tab_shared = fixed + tab <= kMaxDynamicShared;
  g->shared = fixed + (g->tab_shared ? tab : 0);
  return g->shared <= kMaxDynamicShared;
}

template <bool kQual, bool kTabShared>
int launch_decode(const void* words, long long total_words, const void* states,
                  const void* startm, const void* seg, const void* tab,
                  int contexts, int width, const void* present, int order,
                  int steps, int lanes, const DecodeGeometry& g, void* out,
                  void* info, cudaStream_t stream) {
  auto kernel = wctx_decode_kernel<kQual, kTabShared>;
  const int threads = g.threads, cluster = g.cluster;
  const size_t shared = (size_t)g.shared;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t rc = ready_launch((const void*)kernel, cfg, kMaxDynamicShared);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaLaunchKernelEx(
      &cfg, kernel, (const uint16_t*)words, total_words, (const uint32_t*)states,
      (const uint8_t*)startm, (const int*)seg, (const uint16_t*)tab, contexts,
      width, (const uint8_t*)present, order, steps, lanes, (uint8_t*)out,
      (long long*)info);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t, 0 on success.

// sym (u8), ctx (u16): steps*lanes cells; seg: lanes int32; tab: contexts *
// width u16; words (u16), flags (u8): steps*lanes cells; states: lanes u32;
// status: one int32, zeroed by the caller, set to 1 when a live cell met a
// zero frequency or an index outside the table. lanes: a power of two >= 32.
int fq_wctx_encode(const void* sym, const void* ctx, const void* seg,
                   const void* tab, int contexts, int width, int steps,
                   int lanes, void* words, void* flags, void* states,
                   void* status, void* stream) {
  if (!pow2(lanes) || lanes < kEncodeThreads || steps <= 0 ||
      !table_ok(contexts, width))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(lanes / kEncodeThreads);
  const size_t tiles = 2 * sizeof(EncodeTile);
  const size_t bytes = (size_t)contexts * width * sizeof(uint16_t);
  cudaStream_t s = (cudaStream_t)stream;
  const bool in_shared = bytes <= (size_t)kMaxSharedTable;
  const size_t shared = tiles + (in_shared ? bytes : 0);
  auto kernel = in_shared ? wctx_encode_kernel<true> : wctx_encode_kernel<false>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kEncodeThreads);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = s;
  // the cap of each instance: the tiles, and the largest table it holds
  const cudaError_t rc = ready_launch(
      (const void*)kernel, cfg, (int)(tiles + (in_shared ? kMaxSharedTable : 0)));
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<grid, kEncodeThreads, shared, s>>>(
      (const uint8_t*)sym, (const uint16_t*)ctx, (const int*)seg,
      (const uint16_t*)tab, contexts, width, steps, lanes, (uint16_t*)words,
      (uint8_t*)flags, (uint32_t*)states, (int*)status);
  return (int)cudaGetLastError();
}

// words: total_words u16; states: lanes u32; startm (u8 0/1): steps*lanes;
// seg: lanes int32; tab: contexts * width u16; present: width - 1 bytes;
// model 0 (sequence, order 2/4/6) or 1 (quality, order 0/1); out: steps*lanes
// bytes; info: two int64 (words consumed, 1 if a live cell met a context the
// table does not hold). lanes: a power of two, 32-8192; the launch geometry
// is fq_wctx_decode_geometry's.
int fq_wctx_decode(const void* words, long long total_words, const void* states,
                   const void* startm, const void* seg, const void* tab,
                   int contexts, int width, const void* present, int model,
                   int order, int steps, int lanes, void* out, void* info,
                   void* stream) {
  DecodeGeometry g;
  if (!decode_geometry(lanes, contexts, width, &g) || steps <= 0 ||
      total_words < 0 || model < 0 || model > 1 || order < 0 || order > 6)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto launch = model == 1 ? (g.tab_shared ? launch_decode<true, true>
                                           : launch_decode<true, false>)
                           : (g.tab_shared ? launch_decode<false, true>
                                           : launch_decode<false, false>);
  return launch(words, total_words, states, startm, seg, tab, contexts, width,
                present, order, steps, lanes, g, out, info, s);
}

// The launch geometry fq_wctx_decode takes for `lanes` lanes and a contexts x
// width table, into out (four int32): threads per CTA, CTAs in the cluster, 1
// if the table sits in each CTA's shared memory (0: read through the
// read-only cache), dynamic shared bytes per CTA. Returns
// cudaErrorInvalidValue for a lane count or table the kernel does not take.
int fq_wctx_decode_geometry(int lanes, int contexts, int width, void* out) {
  DecodeGeometry g;
  if (!decode_geometry(lanes, contexts, width, &g)) return (int)cudaErrorInvalidValue;
  int* o = (int*)out;
  o[0] = g.threads;
  o[1] = g.cluster;
  o[2] = g.tab_shared ? 1 : 0;
  o[3] = (int)g.shared;
  return 0;
}

}  // extern "C"
