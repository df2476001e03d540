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
// registers, loads and stores are coalesced across lanes. The decode also
// takes every load from device memory off its chain (the words are staged
// in shared memory ahead of the step) and spreads its lanes over a thread
// block cluster of up to 16 CTAs, one per SM, which exchange per-warp
// refill counts by asynchronous remote stores. The TPU
// formulation (256 compare passes for the table, float32 long division,
// flip/roll row reversal, a routing network for the compaction, roll-ladder
// scans and a monotone shift network for the word fetch) is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <tuple>

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---------------------------------------------------------------------------
// Encode: one warp per CTA, one thread per lane, rows walked backwards.
//
// Per step a lane's chain is the renormalisation test, the division of its
// state by the symbol's frequency and the recombination; everything else is
// taken off it. The symbol rows of the CTA's 32 lanes are staged into shared
// memory ahead of the walk (tiles of kEncodeTile steps, double buffered,
// 16-byte cp.async); the frequency, the cumulative count and a reciprocal
// of each symbol sit in one shared table, so x / f is a multiply-high, an
// add and two shifts (Granlund and Montgomery's round-up method, exact for
// every 32-bit dividend and every divisor 1-4096); words and flags are
// staged in shared memory per tile and written out as 16-byte stores. A
// stream narrower than a warp takes the same walk with plain loads and
// stores.
// ---------------------------------------------------------------------------

constexpr int kEncodeThreads = 32;
constexpr int kEncodeTile = 64;  // steps per staged tile

struct EncodeSym {
  uint32_t mul;   // m = floor(2^32 (2^l - f) / f) + 1, l = ceil(log2 f)
  uint32_t fcls;  // f | c << 13 | l << 25
};

// q = floor(x / f) for every x < 2^32 (Granlund and Montgomery 1994, thm 4.2;
// Hacker's Delight 10-8): t = mulhi(m, x), q = (t + ((x - t) >> min(l, 1))) >>
// max(l - 1, 0). ops/rans.py:reciprocal_divmod is the same arithmetic.
__device__ __forceinline__ uint32_t div_by(uint32_t x, uint32_t mul, uint32_t l) {
  const uint32_t t = __umulhi(mul, x);
  return (t + ((x - t) >> (l > 0 ? 1u : 0u))) >> (l > 1 ? l - 1 : 0u);
}

__global__ void __launch_bounds__(kEncodeThreads)
rans_encode_kernel(const uint8_t* __restrict__ data, long long n, int steps,
                   int lanes, int pad_sym,
                   const uint32_t* __restrict__ freq_cum,  // (2, 256)
                   uint16_t* __restrict__ words, uint8_t* __restrict__ flags,
                   uint32_t* __restrict__ states) {
  __shared__ EncodeSym tab[256];
  __shared__ __align__(16) uint8_t sym[2][kEncodeTile][kEncodeThreads];
  __shared__ __align__(16) uint16_t out_w[kEncodeTile][kEncodeThreads];
  __shared__ __align__(16) uint8_t out_f[kEncodeTile][kEncodeThreads];
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kEncodeThreads;
  const int lane = lane0 + tid;
  const int width = lanes < kEncodeThreads ? lanes : kEncodeThreads;
  const bool wide = width == kEncodeThreads;
  for (int i = tid; i < 256; i += kEncodeThreads) {
    const uint32_t f = freq_cum[i], c = freq_cum[256 + i];
    const uint32_t l = f > 1 ? 32 - __clz(f - 1) : 0;
    const uint32_t mul =
        f ? (uint32_t)((((1ull << l) - f) << 32) / f + 1) : 0u;
    tab[i] = {mul, f | (c << 13) | (l << 25)};
  }
  // tile k holds the rows [max(0, hi - T), hi), hi = steps - k * T; cells at
  // or past n code the pad symbol
  auto issue = [&](int k) {
    const int hi = steps - k * kEncodeTile;
    if (hi <= 0) return;
    const int lo = hi > kEncodeTile ? hi - kEncodeTile : 0;
    for (int i = tid; i < 2 * (hi - lo); i += kEncodeThreads) {
      const int r = i >> 1, part = i & 1;
      const long long cell = (long long)(lo + r) * lanes + lane0 + 16 * part;
      uint8_t* dst = &sym[k & 1][r][16 * part];
      if (wide && cell + 16 <= n) {
        cp_async16(dst, data + cell);
      } else {
        for (int j = 0; j < 16; ++j)
          if (16 * part + j < width)
            dst[j] = cell + j < n ? data[cell + j] : (uint8_t)pad_sym;
      }
    }
  };
  issue(0);
  cp_async_commit();

  uint32_t x = kRansL;
  for (int k = 0; steps - k * kEncodeTile > 0; ++k) {
    issue(k + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile k has landed
    __syncwarp();
    const int hi = steps - k * kEncodeTile;
    const int lo = hi > kEncodeTile ? hi - kEncodeTile : 0;
    if (tid < width) {
#pragma unroll 4
      for (int t = hi - 1; t >= lo; --t) {
        const EncodeSym e = tab[sym[k & 1][t - lo][tid]];
        const uint32_t f = e.fcls & 0x1FFFu;
        const uint32_t c = (e.fcls >> 13) & 0xFFFu;
        const bool emit = (x >> 20) >= f;  // x >= f << 20
        out_w[t - lo][tid] = (uint16_t)x;  // read back only where the flag is set
        out_f[t - lo][tid] = emit ? 1 : 0;
        if (emit) x >>= 16;
        const uint32_t q = div_by(x, e.mul, e.fcls >> 25);
        x = (q << kProbBits) + (x - q * f) + c;
      }
    }
    __syncwarp();  // the tile's outputs are staged; tile k is read
    if (wide) {  // rows of 64 bytes of words and 32 of flags, 16 bytes a store
      for (int i = tid; i < 6 * (hi - lo); i += kEncodeThreads) {
        const int r = i / 6, part = i % 6;
        const long long cell = (long long)(lo + r) * lanes + lane0;
        if (part < 4) {
          *reinterpret_cast<uint4*>(words + cell + 8 * part) =
              *reinterpret_cast<const uint4*>(&out_w[r][8 * part]);
        } else {
          *reinterpret_cast<uint4*>(flags + cell + 16 * (part - 4)) =
              *reinterpret_cast<const uint4*>(&out_f[r][16 * (part - 4)]);
        }
      }
    } else if (tid < width) {
      for (int r = 0; r < hi - lo; ++r) {
        const long long cell = (long long)(lo + r) * lanes + lane;
        words[cell] = out_w[r][tid];
        flags[cell] = out_f[r][tid];
      }
    }
    __syncwarp();  // the outputs are read before the next tile's walk
  }
  if (tid < width) states[lane] = x;
}

// ---------------------------------------------------------------------------
// Compact: a cell is kept where its flag byte is not 0; rank = exclusive
// prefix of the kept cells in flat (step, lane) order, then out[rank] =
// word. Three passes: per-tile counts, one block's scan of the tile counts,
// per-tile scan + scatter. (A single pass with decoupled look-back was
// measured against it and did not beat it at the v3 quality and the mesh
// shapes: scripts/compact_variants.py, PERF.md.)
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 256;
constexpr int kItems = 16;  // cells per thread
constexpr int kTile = kScanThreads * kItems;
constexpr int kTileScanThreads = 1024;

// Bit k (k < 4) of the result: byte k of w is not 0.
__device__ __forceinline__ uint32_t nonzero_bits(uint32_t w) {
  // the high bit of each byte, set where the byte is not 0 (no carry
  // crosses a byte), then bits 7, 15, 23, 31 gathered into bits 21-24
  const uint32_t hi = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
  return (((hi >> 7) * 0x00204081u) >> 21) & 0xFu;
}

// Bit k of the result: cell base+k is kept, its flag byte is not 0 (the
// rule of flags.bool()); cells at or past m are not.
__device__ __forceinline__ uint32_t load_flags(const uint8_t* __restrict__ flags,
                                               long long base, long long m) {
  uint32_t mask = 0;
  if (base + kItems <= m) {
    const uint4 v = *reinterpret_cast<const uint4*>(flags + base);
    mask = nonzero_bits(v.x) | nonzero_bits(v.y) << 4 | nonzero_bits(v.z) << 8 |
           nonzero_bits(v.w) << 12;
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
// Decode: a thread block cluster of G CTAs (G = 1 up to kCtaThreads lanes);
// thread i of CTA r owns the K contiguous lanes [(r * T + i) * K, + K). Per
// step every lane resolves its symbol from the slot table and updates its
// state; the lanes that fell below 1 << 16 take consecutive words in lane
// order, at the exclusive prefix of the refill flags over all lanes of the
// cluster.
//
// Within a warp the prefix comes from ballots of the bits of each thread's
// refill count. Across warps, each warp stores its count into a slot of
// every CTA's shared memory: a plain store when G = 1; otherwise an
// asynchronous remote store (st.async) that completes on the receiver's
// mbarrier, so no cluster barrier runs in the loop. Two slots and two
// mbarriers are used in turn: a warp writes step t + 2's count only after
// its wait of step t + 1, which needs every warp's t + 1 count, sent after
// that warp read step t's. Two warp reductions over the counts give each
// warp its offset and the step's total. The words are staged in a ring of
// kRingPerLane words per lane in each CTA's shared memory, which cp.async
// keeps two steps' worst case ahead of the words consumed; a step waits
// only for the oldest copy group it needs, then meets the other warps of
// its CTA at one barrier, which also publishes the counts when G = 1.
// ---------------------------------------------------------------------------

constexpr int kCtaThreads = 256;  // threads per CTA (one CTA of fewer below)
constexpr int kMaxCluster = 16;
constexpr int kMaxWarpSlots = kMaxCluster * (kCtaThreads / 32);
constexpr int kMaxLanes = 16384;
constexpr int kMaxK = kMaxLanes / (kMaxCluster * kCtaThreads);  // lanes per thread
static_assert(kMaxK >= 1 && kMaxK <= 16 && (kMaxK & (kMaxK - 1)) == 0,
              "K lanes per thread: a power of two up to 16");
constexpr int kRingPerLane = 4;  // ring words per lane: 2 steps' worst case
                                 // ahead, one step in use, alignment slack
constexpr int kMinRing = 32;     // ring words below 8 lanes: a step's words,
                                 // two ahead and a 16-byte chunk
constexpr int kMaxPending = 3;  // copy groups a step may leave in flight
constexpr int kTableBytes = kSlots * 4;


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

template <int K>
__global__ void __launch_bounds__(kCtaThreads)
rans_decode_kernel(const uint16_t* __restrict__ words, long long total_words,
                   const uint32_t* __restrict__ states,
                   const uint32_t* __restrict__ slot_tab,  // (4096,)
                   int steps, int lanes, uint8_t* __restrict__ out,
                   long long* __restrict__ consumed) {
  extern __shared__ __align__(16) unsigned char smem_d[];
  // (freq-1) | cum << 12 | sym << 24, then the word ring
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem_d);
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem_d + kTableBytes);
  // the refill counts of every warp of the cluster, per step (two slots
  // used in turn), and their arrival
  __shared__ __align__(16) int wcnt[2][kMaxWarpSlots];
  __shared__ __align__(8) uint64_t cbar[2];
  __shared__ uint16_t tailw[8];

  const int G = gridDim.x;  // the grid is one cluster
  const int rank = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int lane0 = (rank * nthreads + tid) * K;
  const bool live = lane0 < lanes;  // lanes is a multiple of K, or below 32
  const long long rmask = (kRingPerLane * lanes > kMinRing ? kRingPerLane * lanes : kMinRing) - 1;
  const long long full_end = total_words & ~7ll;  // words staged in chunks
  const long long ahead = 2ll * lanes;
  long long filled = 0;  // words requested so far

  auto request_words = [&](long long upto) {
    const long long q1 = ((upto < full_end ? upto : full_end) + 7) >> 3;
    for (long long q = (filled >> 3) + tid; q < q1; q += nthreads)
      cp_async16(ring + ((q << 3) & rmask), words + (q << 3));
    if ((q1 << 3) > filled) filled = q1 << 3;
  };

  // prologue: the table, the first words, the word tail
  for (int i = tid; i < kSlots / 4; i += nthreads) cp_async16(tab + 4 * i, slot_tab + 4 * i);
  // slots past the cluster's warps stay 0: the count reads take four at a time
  for (int i = tid; i < kMaxWarpSlots; i += nthreads) {
    wcnt[0][i] = 0;
    wcnt[1][i] = 0;
  }
  if (tid < 8) {
    const long long p = full_end + tid;
    tailw[tid] = p < total_words ? words[p] : 0;
  }
  if (tid == 0 && G > 1) {
    mbar_init(&cbar[0], 1);
    mbar_init(&cbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  request_words(ahead);
  cp_async_commit();
  // cov[p]: the words requested by the copy groups up to the (p + 1)-th
  // newest; groups before the first step's are complete
  long long cov[kMaxPending + 1];
#pragma unroll
  for (int p = 0; p <= kMaxPending; ++p) cov[p] = filled;

  uint32_t x[K];
#pragma unroll
  for (int j = 0; j < K; ++j) x[j] = live ? states[lane0 + j] : kRansL;
  cp_async_wait<0>();
  __syncthreads();
  if (G > 1) cluster_barrier();  // every CTA's mbarriers are set
  const int me = rank * nwarps + warp;  // this warp in the cluster
  const int cluster_warps = G * nwarps;
  const unsigned below_mask = (1u << lane) - 1u;

  long long base = 0;
  for (int t = 0; t < steps; ++t) {
    // Stage ahead, one group per step: the words up to base(t) + 2 *
    // lanes. The group of step t - 1 covers base(t - 1) + 2 * lanes >=
    // base(t) + lanes, a step's most, so a step never waits for its own
    // group. A ring of 4 * lanes words overwrites only words below
    // base(t - 1), which every thread has read before the barrier of step
    // t - 1.
    request_words(base + ahead);
    cp_async_commit();
#pragma unroll
    for (int p = kMaxPending; p > 0; --p) cov[p] = cov[p - 1];
    cov[0] = filled;

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
      if constexpr (K >= 4) {
#pragma unroll
        for (int q = 0; q < K / 4; ++q) reinterpret_cast<uint32_t*>(p)[q] = pk[q];
      } else if constexpr (K == 2) {
        *reinterpret_cast<uint16_t*>(p) = (uint16_t)pk[0];
      } else {
        *p = (uint8_t)pk[0];
      }
    }

    // refill ranks within the warp: ballots of the bits of each thread's
    // count (0..K)
    const int cnt = __popc(need);
    int in_warp = 0, warp_total = 0;
#pragma unroll
    for (int b = 0; (1 << b) <= K; ++b) {
      const unsigned m = __ballot_sync(kFullMask, (cnt >> b) & 1);
      in_warp += __popc(m & below_mask) << b;
      warp_total += __popc(m) << b;
    }
    const int slot2 = t & 1;
    if (G > 1) {
      if (lane < G)
        st_async_u32(cluster_addr(&wcnt[slot2][me], lane), warp_total,
                     cluster_addr(&cbar[slot2], lane));
      if (tid == 0) mbar_arrive_expect_tx(&cbar[slot2], 4u * cluster_warps);
    } else if (lane == 0) {
      wcnt[slot2][warp] = warp_total;
    }
    // Wait for the newest copy group older than this step's that holds
    // this step's words (up to base + lanes); the groups after it stay in
    // flight.
    const long long need_end = base + lanes < full_end ? base + lanes : full_end;
    int pending = 1;
#pragma unroll
    for (int p = 2; p <= kMaxPending; ++p) pending = cov[p] >= need_end ? p : pending;
    switch (pending) {
      case 1: cp_async_wait<1>(); break;
      case 2: cp_async_wait<2>(); break;
      default: cp_async_wait<3>(); break;
    }
    __syncthreads();  // the staged words (and, when G = 1, the counts)
    if (G > 1) mbar_wait(&cbar[slot2], (t >> 1) & 1);
    int below = 0, all = 0;
    for (int i = 4 * lane; i < cluster_warps; i += 128) {
      const int4 v = *reinterpret_cast<const int4*>(&wcnt[slot2][i]);
      all += v.x + v.y + v.z + v.w;
      below += (i < me ? v.x : 0) + (i + 1 < me ? v.y : 0) + (i + 2 < me ? v.z : 0) +
               (i + 3 < me ? v.w : 0);
    }
    below = __reduce_add_sync(kFullMask, below);
    all = __reduce_add_sync(kFullMask, all);
    // a corrupt stream can ask for more words than it carries: read zeros
    // instead, and let the consumed count tell the wrapper
    long long pos = base + below + in_warp;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (need & (1u << j)) {
        const uint32_t w = pos < full_end ? (uint32_t)ring[pos & rmask]
                           : pos < total_words ? (uint32_t)tailw[pos - full_end]
                                               : 0u;
        x[j] = (x[j] << 16) | w;
        ++pos;
      }
    }
    base += all;
  }
  cp_async_wait<0>();
  // no CTA leaves while another may still store into its shared memory
  if (G > 1) cluster_barrier();
  if (rank == 0 && tid == 0) *consumed = base;
}

// Readies a decode instance for `cfg` on the current device. Once per device
// and instance, under one lock: its dynamic shared memory cap is raised to
// the most any launch takes (the table and the ring of kMaxLanes lanes) and
// clusters past 8 CTAs are allowed; neither is ever set to another value, so
// launches from other threads never see a cap below their own. Once per
// geometry, cudaOccupancyMaxActiveClusters checks that the card can schedule
// the cluster, so a geometry it cannot is refused with an error, never run.
cudaError_t ready_launch(const void* kernel, const cudaLaunchConfig_t& cfg) {
  static std::mutex mu;
  static std::set<std::tuple<int, const void*>> raised;
  static std::set<std::tuple<int, const void*, unsigned, unsigned, size_t>> ok;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  if (!raised.count(std::make_tuple(dev, kernel))) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kTableBytes + 2 * kRingPerLane * kMaxLanes);
    if (rc != cudaSuccess) return rc;
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return rc;
    raised.insert(std::make_tuple(dev, kernel));
  }
  if (cfg.gridDim.x == 1) return cudaSuccess;
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

struct DecodeGeometry {
  int threads;  // per CTA
  int cluster;  // CTAs, one cluster
  int k;        // lanes per thread
  int shared;   // dynamic shared bytes per CTA: slot table and word ring
};

// The decode's launch for `lanes` lanes: one CTA of max(lanes, 32) threads
// up to kCtaThreads lanes; past that min(kMaxCluster, lanes / kCtaThreads)
// CTAs of kCtaThreads threads, K = lanes / (CTAs * kCtaThreads) lanes each.
// False for a lane count the kernel does not take.
bool decode_geometry(int lanes, DecodeGeometry* g) {
  if (!pow2(lanes) || lanes > kMaxLanes) return false;
  if (lanes <= kCtaThreads) {
    g->cluster = 1;
    g->threads = lanes < 32 ? 32 : lanes;
  } else {
    g->cluster = lanes / kCtaThreads < kMaxCluster ? lanes / kCtaThreads : kMaxCluster;
    g->threads = kCtaThreads;
  }
  g->k = lanes < 32 ? 1 : lanes / (g->cluster * g->threads);
  const int ring = kRingPerLane * lanes > kMinRing ? kRingPerLane * lanes : kMinRing;
  g->shared = kTableBytes + 2 * ring;
  return true;
}

template <int K>
int launch_decode(const void* words, long long total_words, const void* states,
                  const void* slot_tab, int steps, int lanes,
                  const DecodeGeometry& g, void* out, void* consumed,
                  cudaStream_t stream) {
  auto kernel = rans_decode_kernel<K>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)g.cluster);
  cfg.blockDim = dim3((unsigned)g.threads);
  cfg.dynamicSmemBytes = (size_t)g.shared;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = g.cluster > 1 ? 1 : 0;
  cudaError_t rc = ready_launch((const void*)kernel, cfg);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaLaunchKernelEx(&cfg, kernel, (const uint16_t*)words, total_words,
                          (const uint32_t*)states, (const uint32_t*)slot_tab,
                          steps, lanes, (uint8_t*)out, (long long*)consumed);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// launch_decode<g.k>, instantiated for K = 1, 2, 4, ... kMaxK only.
template <int K>
int launch_k(const void* words, long long total_words, const void* states,
             const void* slot_tab, int steps, int lanes, const DecodeGeometry& g,
             void* out, void* consumed, cudaStream_t stream) {
  if constexpr (K < kMaxK) {
    if (g.k > K)
      return launch_k<2 * K>(words, total_words, states, slot_tab, steps, lanes, g,
                             out, consumed, stream);
  }
  return launch_decode<K>(words, total_words, states, slot_tab, steps, lanes, g,
                          out, consumed, stream);
}

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
// steps*lanes bytes; consumed: one int64. lanes: a power of two up to 16384;
// the launch geometry is fq_rans_decode_geometry's.
int fq_rans_decode(const void* words, long long total_words, const void* states,
                   const void* slot_tab, int steps, int lanes, void* out,
                   void* consumed, void* stream) {
  DecodeGeometry g;
  if (!decode_geometry(lanes, &g) || steps <= 0 || total_words < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return launch_k<1>(words, total_words, states, slot_tab, steps, lanes, g, out,
                     consumed, s);
}

// The decode's geometry for `lanes` lanes into out (four int32): threads per
// CTA, CTAs in the cluster, lanes per thread, dynamic shared bytes per CTA.
// Returns cudaErrorInvalidValue for a lane count the kernel does not take.
int fq_rans_decode_geometry(int lanes, void* out) {
  DecodeGeometry g;
  if (!decode_geometry(lanes, &g)) return (int)cudaErrorInvalidValue;
  int* o = (int*)out;
  o[0] = g.threads;
  o[1] = g.cluster;
  o[2] = g.k;
  o[3] = g.shared;
  return 0;
}

}  // extern "C"
