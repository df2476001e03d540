// Variants of the order-0 word compaction (fq_rans_compact of
// fastqpacker_tpu_torch/csrc/rans_codec.cu), built and timed beside it by
// scripts/compact_variants.py; nothing of the package calls them. The
// function is the package's: out[rank(i)] = words[i] for every cell i whose
// flag byte is not 0, rank(i) = the kept cells before i, total = their
// count.
//
// variant 0, "single": one single-pass kernel with decoupled look-back
//   (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
//   Look-back", NVIDIA 2016). A CTA takes its tile of kTile cells from a
//   ticket counter (the last ticket wraps it to 0); its kThreads data
//   threads load kItems cells each (16-byte loads, flags and words read
//   once), count them, publish the tile's aggregate and stage the kept
//   words in shared memory at rank + offset % 8; one more warp walks the
//   look-back from the ticket on, beside the loads, on two levels (the
//   tiles of its group of 32, then group words, read in one round trip),
//   and publishes the prefix. Status words are 64-bit: the call's epoch,
//   the state and the count, loaded and stored relaxed at gpu scope (they
//   carry their payload). The run goes out as 16-byte stores, 2-byte ones
//   at its two ends.
// variant 1, "floor": the single pass without its look-back (each tile's
//   run is stored at the tile's own first cell, so the output is not the
//   compaction): the design's memory traffic alone.
// variant 2, "two_pass": reduce, then scan: one kernel counts the kept
//   cells of each tile (the flags read once), a second reads the flags again
//   with the words, each CTA adding the counts of the tiles before its own
//   from L2 (no look-back, no ticket); the output is the compaction.
// variant 3, "trace": the single pass with a timeline: per tile, the
//   globaltimer (ns) at its CTA's start, its ticket, when its count reaches
//   the look-back warp, when its prefix is out and at its last store, and
//   the SM (six u64 a tile).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;  // data threads of a CTA
constexpr int kItems = 32;     // cells per data thread
constexpr int kTile = kThreads * kItems;
constexpr int kCta = kThreads + 32;  // and the look-back warp
constexpr int kMinCtas = 5;          // CTAs an SM must hold (caps the registers)
constexpr int kGroup = 32;           // tiles per group status word
// status word: count in bits 0-40, state in 41-42, epoch in 43-63
constexpr int kCountBits = 41;
constexpr int kEpochShift = 43;
constexpr unsigned long long kCountMask = (1ull << kCountBits) - 1;
constexpr unsigned long long kStateMask = 3ull << kCountBits;
constexpr unsigned long long kAggregate = 1ull << kCountBits;
constexpr unsigned long long kPrefix = 2ull << kCountBits;
constexpr int kBarData = 1;   // among the data threads
constexpr int kBarCount = 2;  // the tile's count is out: data threads arrive

__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Bit k (k < 4): byte k of w is not 0.
__device__ __forceinline__ uint32_t nonzero_bits(uint32_t w) {
  const uint32_t hi = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
  return (((hi >> 7) * 0x00204081u) >> 21) & 0xFu;
}

// Exclusive prefix of v over the kThreads data threads and their total.
__device__ __forceinline__ int block_exclusive(int v, int* sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive(v, lane);
  bar_sync(kBarData, kThreads);  // an earlier call's readers are done with sums
  if (lane == 31) sums[warp] = incl;
  bar_sync(kBarData, kThreads);
  const int ws = lane < kThreads / 32 ? sums[lane] : 0;
  const int wincl = warp_inclusive(ws, lane);
  total = __shfl_sync(kFullMask, wincl, 31);
  return __shfl_sync(kFullMask, wincl - ws, warp) + incl - v;
}

// One data thread's cells from `base`: the mask of kept cells and the
// words in pairs (16-byte loads; plain loads at the end of the input).
__device__ __forceinline__ uint32_t load_cells(const uint16_t* __restrict__ words,
                                               const uint8_t* __restrict__ flags, long long m,
                                               long long base, uint32_t (&w)[kItems / 2]) {
  uint32_t mask = 0;
  if (base + kItems <= m) {
#pragma unroll
    for (int j = 0; j < kItems / 16; ++j) {
      const uint4 f = *reinterpret_cast<const uint4*>(flags + base + 16 * j);
      const uint4 a = *reinterpret_cast<const uint4*>(words + base + 16 * j);
      const uint4 b = *reinterpret_cast<const uint4*>(words + base + 16 * j + 8);
      mask |= (nonzero_bits(f.x) | nonzero_bits(f.y) << 4 | nonzero_bits(f.z) << 8 |
               nonzero_bits(f.w) << 12) << (16 * j);
      uint32_t* q = w + 8 * j;
      q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
      q[4] = b.x; q[5] = b.y; q[6] = b.z; q[7] = b.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if ((k & 1) == 0) w[k >> 1] = 0;
      if (base + k < m) {
        if (flags[base + k]) mask |= 1u << k;
        w[k >> 1] |= (uint32_t)words[base + k] << (16 * (k & 1));
      }
    }
  }
  return mask;
}

// The tile's kept words to out[offset, offset + count): staged at rank +
// offset % 8, then 16-byte units, 2-byte stores in the partial units at the
// two ends. Every thread of the CTA calls it; one with no cells passes 0.
__device__ __forceinline__ void store_run(uint32_t mask, const uint32_t (&w)[kItems / 2],
                                          int rank, int count, long long offset,
                                          uint16_t* stage, uint16_t* __restrict__ out) {
  const int shift = (int)(offset & 7);
  int r = shift + rank;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if ((mask >> k) & 1) stage[r++] = (uint16_t)(w[k >> 1] >> (16 * (k & 1)));
  __syncthreads();
  const int end = shift + count;
  uint16_t* dst = out + (offset - shift);
  for (int lo = 8 * (int)threadIdx.x; lo < end; lo += 8 * (int)blockDim.x) {
    if (lo >= shift && lo + 8 <= end) {
      *reinterpret_cast<uint4*>(dst + lo) = *reinterpret_cast<const uint4*>(stage + lo);
    } else {
      for (int j = lo < shift ? shift : lo; j < lo + 8 && j < end; ++j) dst[j] = stage[j];
    }
  }
}

// One look-back window: lane j < n holds the j-th nearest tile's or
// group's status word; ready once every word up to the nearest prefix (all
// n without one) is of this epoch.
struct Window {
  bool ready, found;
  long long sum;
};

__device__ __forceinline__ Window window(unsigned long long s, int n,
                                         unsigned long long epoch, int lane) {
  const unsigned lanes = n >= 32 ? kFullMask : (1u << n) - 1;
  const unsigned long long state = (s >> kEpochShift) == epoch ? s & kStateMask : 0ull;
  const unsigned prefix = __ballot_sync(kFullMask, state == kPrefix) & lanes;
  const unsigned none = __ballot_sync(kFullMask, state == 0ull) & lanes;
  const unsigned first = prefix & (0u - prefix);
  const unsigned need = first ? (first - 1) | first : lanes;
  long long v = (need >> lane) & 1 ? (long long)(s & kCountMask) : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return {!(none & need), prefix != 0, v};
}

// The kept cells before `tile` (> 0): the tiles of its group before it
// and the 32 group words before it, read together, then further groups; the
// last tile of a group publishes the group's aggregate (its own count from
// `wait_count`) once its tiles are ready without a prefix.
template <typename WaitCount>
__device__ __forceinline__ long long look_back(unsigned long long* tiles_status,
                                               unsigned long long* groups_status,
                                               long long tile, unsigned long long epoch,
                                               int lane, WaitCount wait_count) {
  const long long group = tile / kGroup;
  const int in_group = (int)(tile % kGroup);
  long long g = group - 1;
  int groups = g >= 31 ? 32 : (int)g + 1;
  Window tw{false, false, 0}, gw{false, false, 0};
  for (;;) {
    if (!tw.ready) {
      const unsigned long long s =
          lane < in_group ? ld_relaxed(tiles_status + tile - 1 - lane) : 0ull;
      const unsigned long long sg = lane < groups ? ld_relaxed(groups_status + g - lane) : 0ull;
      tw = window(s, in_group, epoch, lane);
      gw = window(sg, groups, epoch, lane);
      if (tw.ready && tw.found) return tw.sum;
      if (tw.ready && in_group == kGroup - 1) {
        const int count = wait_count();
        if (lane == 0)
          st_relaxed(groups_status + group, (epoch << kEpochShift) | kAggregate | (tw.sum + count));
      }
    } else {
      const unsigned long long sg = lane < groups ? ld_relaxed(groups_status + g - lane) : 0ull;
      gw = window(sg, groups, epoch, lane);
    }
    if (!tw.ready || !gw.ready) continue;
    if (gw.found) return tw.sum + gw.sum;
    tw.sum += gw.sum;
    g -= 32;
    groups = g >= 31 ? 32 : (int)g + 1;
    gw.ready = false;
  }
}

struct NoTimeline {
  __device__ __forceinline__ unsigned long long now() const { return 0; }
  __device__ __forceinline__ void mark(long long, int, unsigned long long = 0) const {}
};

// trace[6 tile + k]: 0 ticket, 1 count at the look-back warp, 2 prefix out,
// 3 last store, 4 SM, 5 the CTA's start (before its ticket)
struct Timeline {
  unsigned long long* trace;
  __device__ __forceinline__ unsigned long long now() const { return global_ns(); }
  __device__ __forceinline__ void mark(long long tile, int what,
                                       unsigned long long at = 0) const {
    const bool first = what == 1 || what == 2 ? threadIdx.x == kThreads : threadIdx.x == 0;
    if (!first) return;
    trace[6 * tile + what] = what == 5 ? at : global_ns();
    if (what == 0) {
      unsigned smid;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
      trace[6 * tile + 4] = smid;
    }
  }
};

template <class Timeline>
__device__ __forceinline__ void single_body(const uint16_t* __restrict__ words,
                                            const uint8_t* __restrict__ flags, long long m,
                                            unsigned* __restrict__ ticket,
                                            unsigned long long* __restrict__ status,
                                            unsigned long long epoch,
                                            uint16_t* __restrict__ out,
                                            long long* __restrict__ total,
                                            const Timeline& timeline) {
  __shared__ __align__(16) uint16_t stage[kTile + 8];
  __shared__ int sums[32];
  __shared__ unsigned tile_s;
  __shared__ int count_s;
  __shared__ long long offset_s;
  const int tid = threadIdx.x;
  const unsigned long long started = timeline.now();
  if (tid == 0) tile_s = atomicInc(ticket, gridDim.x - 1);
  __syncthreads();
  const long long tile = tile_s;
  unsigned long long* groups = status + gridDim.x;
  timeline.mark(tile, 0);
  timeline.mark(tile, 5, started);
  uint32_t w[kItems / 2];
  uint32_t mask = 0;
  int rank = 0;
  if (tid < kThreads) {  // the data threads
    mask = load_cells(words, flags, m, tile * kTile + (long long)tid * kItems, w);
    int count;
    rank = block_exclusive(__popc(mask), sums, count);
    if (tid == 0) {
      if (tile > 0) st_relaxed(status + tile, (epoch << kEpochShift) | kAggregate | count);
      count_s = count;
    }
    bar_arrive(kBarCount, kCta);
  } else {  // the look-back warp, from the ticket on
    const int lane = tid - kThreads;
    bool have_count = false;
    auto wait_count = [&] {
      if (!have_count) bar_sync(kBarCount, kCta);
      have_count = true;
      return count_s;
    };
    const long long before = tile > 0 ? look_back(status, groups, tile, epoch, lane, wait_count) : 0;
    const int count = wait_count();
    timeline.mark(tile, 1);
    if (lane == 0) {
      const unsigned long long prefix = (epoch << kEpochShift) | kPrefix | (before + count);
      st_relaxed(status + tile, prefix);
      if (tile % kGroup == kGroup - 1) st_relaxed(groups + tile / kGroup, prefix);
      offset_s = before;
      if (tile == gridDim.x - 1) *total = before + count;
    }
    timeline.mark(tile, 2);
  }
  __syncthreads();
  store_run(mask, w, rank, count_s, offset_s, stage, out);
  __syncthreads();
  timeline.mark(tile, 3);
}

__global__ void __launch_bounds__(kCta, kMinCtas)
single_kernel(const uint16_t* __restrict__ words, const uint8_t* __restrict__ flags,
              long long m, unsigned* __restrict__ ticket,
              unsigned long long* __restrict__ status, unsigned long long epoch,
              uint16_t* __restrict__ out, long long* __restrict__ total) {
  single_body(words, flags, m, ticket, status, epoch, out, total, NoTimeline{});
}

__global__ void __launch_bounds__(kCta, kMinCtas)
single_traced_kernel(const uint16_t* __restrict__ words, const uint8_t* __restrict__ flags,
                     long long m, unsigned* __restrict__ ticket,
                     unsigned long long* __restrict__ status, unsigned long long epoch,
                     uint16_t* __restrict__ out, long long* __restrict__ total,
                     unsigned long long* __restrict__ trace) {
  single_body(words, flags, m, ticket, status, epoch, out, total, Timeline{trace});
}

__global__ void __launch_bounds__(kThreads)
floor_kernel(const uint16_t* __restrict__ words, const uint8_t* __restrict__ flags,
             long long m, unsigned* __restrict__ ticket, uint16_t* __restrict__ out) {
  __shared__ __align__(16) uint16_t stage[kTile + 8];
  __shared__ int sums[32];
  __shared__ unsigned tile_s;
  if (threadIdx.x == 0) tile_s = atomicInc(ticket, gridDim.x - 1);
  __syncthreads();
  const long long tile = tile_s;
  uint32_t w[kItems / 2];
  const uint32_t mask =
      load_cells(words, flags, m, tile * kTile + (long long)threadIdx.x * kItems, w);
  int count;
  const int rank = block_exclusive(__popc(mask), sums, count);
  store_run(mask, w, rank, count, tile * kTile, stage, out);
}

__global__ void __launch_bounds__(kThreads)
counts_kernel(const uint8_t* __restrict__ flags, long long m, int* __restrict__ counts) {
  __shared__ int sums[32];
  const long long base = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  uint32_t mask = 0;
  for (int k = 0; k < kItems; k += 16) {
    if (base + k + 16 <= m) {
      const uint4 f = *reinterpret_cast<const uint4*>(flags + base + k);
      mask |= (nonzero_bits(f.x) | nonzero_bits(f.y) << 4 | nonzero_bits(f.z) << 8 |
               nonzero_bits(f.w) << 12) << k;
    } else {
      for (int j = k; j < k + 16; ++j)
        if (base + j < m && flags[base + j]) mask |= 1u << j;
    }
  }
  int count;
  block_exclusive(__popc(mask), sums, count);
  if (threadIdx.x == 0) counts[blockIdx.x] = count;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint16_t* __restrict__ words, const uint8_t* __restrict__ flags,
               long long m, const int* __restrict__ counts, uint16_t* __restrict__ out,
               long long* __restrict__ total) {
  __shared__ __align__(16) uint16_t stage[kTile + 8];
  __shared__ int sums[32];
  const int tile = blockIdx.x;
  uint32_t w[kItems / 2];
  const uint32_t mask =
      load_cells(words, flags, m, (long long)tile * kTile + (long long)threadIdx.x * kItems, w);
  int before = 0;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) before += counts[t];
  int count, all_before;
  block_exclusive(before, sums, all_before);
  const int rank = block_exclusive(__popc(mask), sums, count);
  if (threadIdx.x == 0 && tile == (int)gridDim.x - 1) *total = (long long)all_before + count;
  store_run(mask, w, rank, count, all_before, stage, out);
}

}  // namespace

extern "C" {

// Cells per tile of every variant.
int fq_compact_variant_tile(void) { return kTile; }

// variant 0 single, 1 floor, 2 two_pass, 3 trace; m < 2^31. ticket: one u32
// left at 0 by every launch; status: one u64 per tile and one per group of
// 32 tiles, 0 or of another epoch; epoch: 1 to 2^21 - 1, one per launch;
// counts: one int32 per tile; trace: six u64 per tile. Returns the last
// launch's cudaError_t.
int fq_compact_variant(int variant, const void* words, const void* flags, long long m,
                       void* ticket, void* status, int epoch, void* counts, void* out,
                       void* total, void* trace, void* stream) {
  if (m <= 0 || m >= (1ll << 31) || variant < 0 || variant > 3 || epoch < 1 ||
      epoch >= (1 << 21))
    return (int)cudaErrorInvalidValue;
  const unsigned tiles = (unsigned)((m + kTile - 1) / kTile);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* w = (const uint16_t*)words;
  const auto* f = (const uint8_t*)flags;
  auto* st = (unsigned long long*)status;
  if (variant == 0) {
    single_kernel<<<tiles, kCta, 0, s>>>(w, f, m, (unsigned*)ticket, st, epoch,
                                         (uint16_t*)out, (long long*)total);
  } else if (variant == 3) {
    single_traced_kernel<<<tiles, kCta, 0, s>>>(w, f, m, (unsigned*)ticket, st, epoch,
                                                (uint16_t*)out, (long long*)total,
                                                (unsigned long long*)trace);
  } else if (variant == 1) {
    floor_kernel<<<tiles, kThreads, 0, s>>>(w, f, m, (unsigned*)ticket, (uint16_t*)out);
  } else {
    counts_kernel<<<tiles, kThreads, 0, s>>>(f, m, (int*)counts);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    scatter_kernel<<<tiles, kThreads, 0, s>>>(w, f, m, (const int*)counts, (uint16_t*)out,
                                              (long long*)total);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
