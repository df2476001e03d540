// Variants of the order-0 byte histogram (fq_hist256 of
// fastqpacker_tpu_torch/csrc/hist256.cu), built and timed beside it by
// scripts/hist_ab.py --variants; nothing of the package calls them. The
// function is the package's: the 256 exact counts of n bytes at any
// alignment, as int64.
//
// mode 0, "parent": the package's design before its redesign, unchanged: a
//   grid sized by the work (a CTA per 1,024 threads x 4 units of 16 bytes,
//   at most 2 an SM), a 256 x u32 table per warp, a thread's run of equal
//   bytes added once, each CTA's sums to u64 partials, and the last CTA by
//   ticket adding every CTA's partials in one loop a bin.
// modes 1-14 and 18-22 share a skeleton: one wave of CTAs sized to the card
//   (by the SM count and the CTAs an SM holds), each thread looping over the stream
//   with a batch of 16-byte loads in flight while it counts the batch before;
//   each CTA adds its sums into a 256 x u64 accumulator with red.global.add;
//   the last CTA by ticket reads every bin out by atomicExch, which leaves
//   the accumulator at 0 (modes 12-14, 18-22 finish each bin by its last
//   add instead). They differ in the counting and the geometry:
// mode 1, "lane_rmw": counters private to each thread, two u16 a 32-bit
//   word, laid out [warp][bin / 2][lane] so that a lane only ever touches
//   its own bank; a byte is a load, an add and a store (no atomics);
// mode 2, "lane_atom": the same counters, a byte a shared atomicAdd whose
//   result is unused (no load-add-store chain);
// mode 3, "lane_atom_runs": mode 2 with a thread's run of equal bytes kept
//   in registers and added once;
// mode 4, "warp_runs": the parent's counting (a table a warp, runs in
//   registers, shared atomics) in the new skeleton;
// mode 5, "floor": the lane modes' skeleton with its loads and no counting
//   (each thread folds its words into one register and adds its low bit to
//   one counter): the loads' time alone; its counts are not the histogram;
// modes 6, 7, "lane_atom_x2", "lane_atom_x4": mode 2 with 2 or 4 warps
//   adding into each set of lane counters (512 or 1,024 threads on the same
//   128 KiB), the warps of one set in turn on a word, never the lanes of one
//   warp; a column flushes by atomicExch;
// modes 8-10, "col_512x2", "col_1024", "col_256x4": one set of lane
//   counters a CTA (16 KiB), every warp of the CTA adding into it (CTAs of
//   512 threads, 2 an SM; 1,024, 1 an SM; 256, 4 an SM): the zeroing and the
//   table sum read 16 KiB, not 128 KiB, and registers, not shared memory,
//   bound the warps an SM holds;
// mode 11, "col_512x2_c8": mode 8 with 8 copies of the accumulator, CTA c
//   adding into copy c % 8 (an eighth of the adds on each address), the last
//   CTA reading the 8 copies of each bin out;
// modes 12-14, "col_512x2_fin", "col_256x4_fin", "lane_atom_fin": modes 8,
//   10 and 2 with no ticket: each CTA adds its sum of a bin with its arrival
//   (1 << 48) by atomicAdd, and the CTA whose add brings a bin's arrivals to
//   gridDim.x writes the bin out and zeroes it: no fence, no last CTA;
// modes 15-17, "ring", "ring_spread", "ring8": mode 12 with a ring of loads
//   (a unit's register slot loaded again, 4 or 8 units on, before the unit
//   is counted, so the last loads wait for one unit's counting, not a
//   batch's), bins b and b + 128 in one word (row b % 128: one bit-field
//   extract a byte, not a shift and a mask each); mode 16 with each bin of
//   the accumulator on a 128-byte line of its own (16 x 256 u64);
// modes 18-20, "col_1024_fin", "col_512x2_fin_min2", "col_512x2_fin_pair":
//   mode 9 with bins finished by their last add (132 adds an address, not
//   264); mode 12 with a CTA for every 2 units a thread (not 4); mode 12
//   with two bytes of a word that share a row added by one atomic;
// modes 21, 22, "col_512x2_fin_b2", "col_512x2_fin_b1": mode 12 with
//   batches of 2 or 1 units (the last batch's counting, after its loads, is
//   shorter; fewer loads in flight). Mode 22 is the package's design.
// The lane modes flush a thread's counters into the accumulator before a
// u16 can overflow (kFlushUnits).
//
// With a stamps buffer (8 u64 a CTA), a launch records its split: the
// globaltimer (ns) at the CTA's start, after its tables are zeroed, after
// its counting, after its table sum and global adds, after its ticket, and
// at its end (the last CTA: after reading the bins out); the SM; the
// threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStampWords = 8;

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

__device__ __forceinline__ unsigned smid() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void red_add(unsigned long long* p, unsigned long long v) {
  asm volatile("red.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// ---------------------------------------------------------------------------
// mode 0: the parent
// ---------------------------------------------------------------------------

constexpr int kPThreads = 1024;
constexpr int kPWarps = kPThreads / 32;
constexpr int kPInFlight = 4;
constexpr int kPCtasPerSm = 2;

__device__ inline void p_count_word(unsigned w, unsigned& sym, unsigned& cnt, unsigned* tab) {
  if (w == sym * 0x01010101u) {
    cnt += 4;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned b = (w >> (8 * k)) & 0xffu;
    if (b == sym) {
      ++cnt;
    } else {
      if (cnt) atomicAdd(&tab[sym], cnt);
      sym = b;
      cnt = 1;
    }
  }
}

__device__ inline void p_count_unit(const uint4& v, unsigned& sym, unsigned& cnt, unsigned* tab) {
  p_count_word(v.x, sym, cnt, tab);
  p_count_word(v.y, sym, cnt, tab);
  p_count_word(v.z, sym, cnt, tab);
  p_count_word(v.w, sym, cnt, tab);
}

template <bool kSplit>
__global__ void __launch_bounds__(kPThreads, kPCtasPerSm) parent_kernel(const uint8_t* data, long long n,
                                                           long long head, long long units,
                                                           unsigned long long* partials,
                                                           unsigned* ticket, long long* out,
                                                           unsigned long long* stamps) {
  __shared__ unsigned tab[kPWarps][256];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  unsigned long long* st = stamps + (long long)blockIdx.x * kStampWords;
  if (kSplit && tid == 0) st[0] = gtime();
  unsigned* flat = &tab[0][0];
  for (int k = tid; k < kPWarps * 256; k += kPThreads) flat[k] = 0;
  __syncthreads();
  if (kSplit && tid == 0) st[1] = gtime();
  unsigned* mine = tab[tid >> 5];
  const long long gid = (long long)blockIdx.x * kPThreads + tid;
  const long long stride = (long long)gridDim.x * kPThreads;
  const uint8_t* body = data + head;
  const long long tail = n - head - 16 * units;
  if (gid < head) atomicAdd(&mine[data[gid]], 1u);
  if (gid < tail) atomicAdd(&mine[body[16 * units + gid]], 1u);

  const uint4* u4 = reinterpret_cast<const uint4*>(body);
  unsigned sym = 0, cnt = 0;
  long long u = gid;
  for (; u + (kPInFlight - 1) * stride < units; u += kPInFlight * stride) {
    uint4 v[kPInFlight];
#pragma unroll
    for (int j = 0; j < kPInFlight; ++j) v[j] = __ldg(u4 + u + j * stride);
#pragma unroll
    for (int j = 0; j < kPInFlight; ++j) p_count_unit(v[j], sym, cnt, mine);
  }
  for (; u < units; u += stride) p_count_unit(__ldg(u4 + u), sym, cnt, mine);
  if (cnt) atomicAdd(&mine[sym], cnt);
  __syncthreads();
  if (kSplit && tid == 0) st[2] = gtime();

  if (tid < 256) {
    unsigned long long s = 0;
#pragma unroll 8
    for (int w = 0; w < kPWarps; ++w) s += tab[w][tid];
    partials[(long long)blockIdx.x * 256 + tid] = s;
    __threadfence();
  }
  __syncthreads();
  if (kSplit && tid == 0) st[3] = gtime();
  if (tid == 0) s_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (kSplit && tid == 0) st[4] = gtime();
  if (s_last) {
    __threadfence();
    if (tid < 256) {
      unsigned long long s = 0;
      for (unsigned c = 0; c < gridDim.x; ++c) s += __ldcg(partials + (long long)c * 256 + tid);
      out[tid] = (long long)s;
    }
    __syncthreads();
  }
  if (kSplit && tid == 0) {
    st[5] = gtime();
    st[6] = smid();
    st[7] = kPThreads;
  }
}

int parent_ctas(long long n, int misalign, int sms) {
  if (n < 0) return 1;
  const long long head = misalign ? (16 - misalign < n ? 16 - misalign : n) : 0;
  const long long units = (n - head) / 16;
  long long g = (units + (long long)kPThreads * kPInFlight - 1) / ((long long)kPThreads * kPInFlight);
  const long long most = (long long)kPCtasPerSm * (sms > 0 ? sms : 132);
  if (g > most) g = most;
  return (int)(g < 1 ? 1 : g);
}

// ---------------------------------------------------------------------------
// modes 1-10: a wave sized to the card
// ---------------------------------------------------------------------------

constexpr int kMinUnits = 4;        // units a thread takes at least before a CTA is added
constexpr int kFlushUnits = 4000;   // units a column counts between flushes (< 65536 / 16)

enum Mode {
  kLaneRmw = 1, kLaneAtom = 2, kLaneAtomRuns = 3, kWarpRuns = 4, kFloor = 5, kLaneAtom2 = 6,
  kLaneAtom4 = 7, kCol512x2 = 8, kCol1024 = 9, kCol256x4 = 10, kCol512x2C8 = 11,
  kCol512x2Fin = 12, kCol256x4Fin = 13, kLaneAtomFin = 14, kCol1024Fin = 18,
  kCol512x2FinMin2 = 19, kCol512x2FinPair = 20, kCol512x2FinB2 = 21, kCol512x2FinB1 = 22
};

template <int kMode>
struct Geo {
  static constexpr bool kLane = kMode != kWarpRuns;
  static constexpr bool k512x2 = kMode == kCol512x2 || kMode == kCol512x2C8 ||
                                 kMode == kCol512x2Fin || kMode == kCol512x2FinMin2 ||
                                 kMode == kCol512x2FinPair || kMode == kCol512x2FinB2 ||
                                 kMode == kCol512x2FinB1;
  static constexpr int kThreads = kMode == kLaneAtom2 || k512x2 || !kLane ? 512
                                  : kMode == kLaneAtom4 || kMode == kCol1024 || kMode == kCol1024Fin
                                      ? 1024
                                      : 256;
  static constexpr int kCtasPerSm = k512x2 || !kLane                               ? 2
                                    : kMode == kCol256x4 || kMode == kCol256x4Fin ? 4
                                                                                  : 1;
  static constexpr int kMinU = kMode == kCol512x2FinMin2 ? 2 : kMinUnits;
  // two bytes of a word in one row share one atomic
  static constexpr bool kPair = kMode == kCol512x2FinPair;
  // each bin finished by the CTA whose add completes it (no ticket, no fence)
  static constexpr bool kFinish = kMode >= kCol512x2Fin;
  // copies of the accumulator the CTAs add into, by CTA (fewer adds an address)
  static constexpr int kCopies = kMode == kCol512x2C8 ? 8 : 1;
  // sets of lane counters (a column a lane: [128 words][32 lanes]) a CTA holds
  static constexpr int kSets = kMode >= kCol512x2 && kMode != kLaneAtomFin ? 1 : 8;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kShare = kLane ? kWarps / kSets : 1;  // warps adding into one set
  // 16-byte loads in flight a thread
  static constexpr int kBatch = kMode == kCol512x2FinB2   ? 2
                                : kMode == kCol512x2FinB1 ? 1
                                : kLane && kThreads * kCtasPerSm <= 256 ? 8
                                                                        : 4;
  static constexpr int kSmemWords = kLane ? kSets * 128 * 32 : kWarps * 256;
  static constexpr int kSmemBytes = kSmemWords * 4;
  static constexpr bool kRuns = kMode == kLaneAtomRuns || kMode == kWarpRuns;
  // units a thread counts between flushes: its column takes kShare threads'
  static constexpr int kFlush = kFlushUnits / kShare / kBatch * kBatch;
};


// Adds c counts of byte b to this thread's counters (lane modes: `mine` is
// the lane's column of its warp's words) or to its warp's table.
template <int kMode>
__device__ __forceinline__ void add(unsigned* mine, unsigned b, unsigned c) {
  if (kMode == kWarpRuns) {
    atomicAdd(mine + b, c);
  } else if (kMode == kLaneRmw) {
    unsigned short* p = reinterpret_cast<unsigned short*>(mine + (b >> 1) * 32) + (b & 1);
    *p = (unsigned short)(*p + c);
  } else {
    atomicAdd(mine + (b >> 1) * 32, c << ((b & 1) << 4));
  }
}

template <int kMode>
__device__ __forceinline__ void count_word(unsigned w, unsigned& sym, unsigned& cnt,
                                           unsigned* mine) {
  if (Geo<kMode>::kRuns) {
    if (w == sym * 0x01010101u) {
      cnt += 4;
      return;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned b = (w >> (8 * k)) & 0xffu;
      if (b == sym) {
        ++cnt;
      } else {
        if (cnt) add<kMode>(mine, sym, cnt);
        sym = b;
        cnt = 1;
      }
    }
  } else if (Geo<kMode>::kPair) {
#pragma unroll
    for (int k = 0; k < 4; k += 2) {
      const unsigned b0 = (w >> (8 * k)) & 0xffu, b1 = (w >> (8 * k + 8)) & 0xffu;
      const unsigned i0 = 1u << ((b0 & 1) << 4), i1 = 1u << ((b1 & 1) << 4);
      const bool one = (b0 >> 1) == (b1 >> 1);
      atomicAdd(mine + (b0 >> 1) * 32, one ? i0 + i1 : i0);
      if (!one) atomicAdd(mine + (b1 >> 1) * 32, i1);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) add<kMode>(mine, (w >> (8 * k)) & 0xffu, 1u);
  }
}

template <int kMode>
__device__ __forceinline__ void count_unit(const uint4& v, unsigned& sym, unsigned& cnt,
                                           unsigned* mine) {
  if (kMode == kFloor) {  // the words folded into `sym`, added once at the end
    sym ^= v.x ^ v.y ^ v.z ^ v.w;
    cnt = 1;
    return;
  }
  count_word<kMode>(v.x, sym, cnt, mine);
  count_word<kMode>(v.y, sym, cnt, mine);
  count_word<kMode>(v.z, sym, cnt, mine);
  count_word<kMode>(v.w, sym, cnt, mine);
}

// A lane column's counters into the accumulator, and back to 0 (taken by
// atomicExch: the column's other warps may be adding to it); the adds are
// out before the CTA's last add to any bin (the fence).
__device__ inline void flush_lane(unsigned* mine, unsigned long long* acc) {
  for (int j = 0; j < 128; ++j) {
    const unsigned w = atomicExch(mine + j * 32, 0u);
    if (w & 0xffffu) red_add(acc + 2 * j, w & 0xffffu);
    if (w >> 16) red_add(acc + 2 * j + 1, w >> 16);
  }
  __threadfence();
}

constexpr unsigned long long kArrived = 1ull << 48;  // a CTA's add, above the count
constexpr unsigned long long kCountMask = kArrived - 1;

// The CTA's sum s of bin b, with its arrival; the CTA that arrives last at
// the bin writes it out and leaves the accumulator at 0.
__device__ __forceinline__ void finish_bin(unsigned long long* acc, long long* out, int b,
                                           unsigned long long s) {
  const unsigned long long old = atomicAdd(acc + b, s + kArrived);
  if ((old >> 48) + 1 == gridDim.x) {
    out[b] = (long long)((old & kCountMask) + s);
    acc[b] = 0;
  }
}

template <int kMode, bool kSplit>
__global__ void __launch_bounds__(Geo<kMode>::kThreads, Geo<kMode>::kCtasPerSm)
    wave_kernel(const uint8_t* data, long long n, long long head, long long units,
                unsigned long long* acc, unsigned* ticket, long long* out,
                unsigned long long* stamps) {
  using G = Geo<kMode>;
  constexpr int T = G::kThreads;
  constexpr int B = G::kBatch;
  extern __shared__ __align__(16) unsigned smem[];
  __shared__ unsigned s_sum[2][256];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long* st = stamps + (long long)blockIdx.x * kStampWords;
  if (kSplit && tid == 0) st[0] = gtime();
  const long long gid = (long long)blockIdx.x * T + tid;
  const long long stride = (long long)gridDim.x * T;
  const uint8_t* body = data + head;
  const uint4* u4 = reinterpret_cast<const uint4*>(body);
  unsigned long long* my_acc = acc + (blockIdx.x % G::kCopies) * 256;
  // the first batch in flight before the tables are zeroed
  uint4 cur[B];
  long long u = gid;
#pragma unroll
  for (int j = 0; j < B; ++j)
    if (u + j * stride < units) cur[j] = __ldg(u4 + u + j * stride);
  unsigned* mine;
  if (G::kLane) {
    mine = smem + (warp % G::kSets) * 128 * 32 + lane;
    if (G::kShare == 1) {
#pragma unroll 16
      for (int j = 0; j < 128; ++j) mine[j * 32] = 0;
    } else {
      for (int k = tid; k < G::kSmemWords; k += T) smem[k] = 0;
      __syncthreads();
    }
  } else {
    for (int k = tid; k < G::kSmemWords; k += T) smem[k] = 0;
    mine = smem + warp * 256;
    __syncthreads();
  }
  if (kSplit && tid == 0) st[1] = gtime();
  const long long tail = n - head - 16 * units;
  if (gid < head) add<kMode>(mine, data[gid], 1u);
  if (gid < tail) add<kMode>(mine, body[16 * units + gid], 1u);

  unsigned sym = 0, cnt = 0;
  int since = 0;
  while (u < units) {
    const long long un = u + B * stride;
    uint4 nxt[B];
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (un + j * stride < units) nxt[j] = __ldg(u4 + un + j * stride);
    if (u + (B - 1) * stride < units) {
#pragma unroll
      for (int j = 0; j < B; ++j) count_unit<kMode>(cur[j], sym, cnt, mine);
    } else {
#pragma unroll
      for (int j = 0; j < B; ++j)
        if (u + j * stride < units) count_unit<kMode>(cur[j], sym, cnt, mine);
    }
    if (G::kLane && (since += B) >= G::kFlush) {
      if (kMode != kFloor && cnt) add<kMode>(mine, sym, cnt);
      cnt = 0;
      flush_lane(mine, my_acc);
      since = 0;
    }
#pragma unroll
    for (int j = 0; j < B; ++j) cur[j] = nxt[j];
    u = un;
  }
  if (kMode == kFloor) {
    add<kMode>(mine, 0, sym & 1u);
  } else if (cnt) {
    add<kMode>(mine, sym, cnt);
  }
  __syncthreads();
  if (kSplit && tid == 0) st[2] = gtime();

  // the CTA's sums
  if (G::kLane) {
    if (tid < 256) {  // bins 2j, 2j + 1 of every set, lanes 16h .. 16h + 15
      const int j = tid & 127, h = tid >> 7;
      unsigned lo = 0, hi = 0;
#pragma unroll
      for (int w = 0; w < G::kSets; ++w) {
        const uint4* row = reinterpret_cast<const uint4*>(smem + w * 128 * 32 + j * 32);
#pragma unroll
        for (int q = 4 * h; q < 4 * h + 4; ++q) {
          const uint4 x = row[(q + j) & 7];
          lo += (x.x & 0xffffu) + (x.y & 0xffffu) + (x.z & 0xffffu) + (x.w & 0xffffu);
          hi += (x.x >> 16) + (x.y >> 16) + (x.z >> 16) + (x.w >> 16);
        }
      }
      s_sum[h][2 * j] = lo;
      s_sum[h][2 * j + 1] = hi;
    }
    __syncthreads();
    if (tid < 256) {
      const unsigned long long s = (unsigned long long)s_sum[0][tid] + s_sum[1][tid];
      if (G::kFinish) {
        finish_bin(my_acc, out, tid, s);
      } else if (s) {
        red_add(my_acc + tid, s);
      }
    }
  } else if (tid < 256) {
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < G::kWarps; ++w) s += smem[w * 256 + tid];
    if (s) red_add(my_acc + tid, s);
  }
  if (G::kFinish) {
    if (kSplit) {
      __syncthreads();
      if (tid == 0) {
        st[3] = st[4] = st[5] = gtime();
        st[6] = smid();
        st[7] = T;
      }
    }
    return;
  }
  __threadfence();  // this CTA's adds before its ticket
  __syncthreads();
  if (kSplit && tid == 0) st[3] = gtime();
  if (tid == 0) s_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (kSplit && tid == 0) st[4] = gtime();
  if (s_last) {
    __threadfence();
    if (tid < 256) {
      unsigned long long s = 0;
#pragma unroll
      for (int c = 0; c < G::kCopies; ++c) s += atomicExch(acc + c * 256 + tid, 0ull);
      out[tid] = (long long)s;
    }
    __syncthreads();
  }
  if (kSplit && tid == 0) {
    st[5] = gtime();
    st[6] = smid();
    st[7] = T;
  }
}

template <int kMode>
int wave_ctas(long long n, int misalign, int sms) {
  using G = Geo<kMode>;
  if (n < 0) return 1;
  const long long head = misalign ? (16 - misalign < n ? 16 - misalign : n) : 0;
  const long long units = (n - head) / 16;
  long long g = (units + (long long)G::kThreads * G::kMinU - 1) / ((long long)G::kThreads * G::kMinU);
  const long long most = (long long)G::kCtasPerSm * (sms > 0 ? sms : 132);
  if (g > most) g = most;
  return (int)(g < 1 ? 1 : g);
}

template <int kMode, bool kSplit>
int wave_launch(const uint8_t* data, long long n, long long head, long long units, int ctas,
                void* acc, void* ticket, void* out, void* stamps, cudaStream_t s) {
  using G = Geo<kMode>;
  auto fn = wave_kernel<kMode, kSplit>;
  cudaError_t rc = cudaFuncSetAttribute((const void*)fn,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  fn<<<ctas, G::kThreads, G::kSmemBytes, s>>>(data, n, head, units, (unsigned long long*)acc,
                                             (unsigned*)ticket, (long long*)out,
                                             (unsigned long long*)stamps);
  return (int)cudaGetLastError();
}

template <int kMode>
int wave(bool split, const uint8_t* data, long long n, long long head, long long units, int ctas,
         void* acc, void* ticket, void* out, void* stamps, cudaStream_t s) {
  return split ? wave_launch<kMode, true>(data, n, head, units, ctas, acc, ticket, out, stamps, s)
               : wave_launch<kMode, false>(data, n, head, units, ctas, acc, ticket, out, stamps, s);
}

// ---------------------------------------------------------------------------
// modes 15-17: a ring of loads, bins b and b + 128 in one word
// ---------------------------------------------------------------------------

// kT threads, kC CTAs an SM, kB loads in flight a thread (a ring: a unit's
// slot is loaded again, kB units on, before the unit is counted), one column
// set a CTA with bins b and b + 128 in row b % 128, bins finished by their
// last add; kSpread: each bin of the accumulator on a 128-byte line of its own
template <int kT, int kC, int kB, bool kSpread>
struct Ring {
  static constexpr int kShare = kT / 32;
  static constexpr int kFlush = kFlushUnits / kShare / kB * kB;
  static constexpr int kStep = kSpread ? 16 : 1;  // u64 words between bins
};

__device__ __forceinline__ void ring_add(unsigned* col, unsigned b) {
  atomicAdd(col + (b & 127) * 32, 1u << ((b >> 7) << 4));
}

__device__ __forceinline__ void ring_count(const uint4& v, unsigned* col) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) ring_add(col, (w[i] >> (8 * k)) & 0xffu);
  }
}

template <int kT, int kC, int kB, bool kSpread, bool kSplit>
__global__ void __launch_bounds__(kT, kC)
    ring_kernel(const uint8_t* data, long long n, long long head, long long units,
                unsigned long long* acc, long long* out, unsigned long long* stamps) {
  using R = Ring<kT, kC, kB, kSpread>;
  __shared__ __align__(16) unsigned rows[128 * 32];
  __shared__ unsigned s_sum[2][256];
  const int tid = threadIdx.x;
  unsigned long long* st = stamps + (long long)blockIdx.x * kStampWords;
  if (kSplit && tid == 0) st[0] = gtime();
  const long long gid = (long long)blockIdx.x * kT + tid;
  const long long stride = (long long)gridDim.x * kT;
  const uint8_t* body = data + head;
  const uint4* u4 = reinterpret_cast<const uint4*>(body);
  uint4 v[kB];
  long long u = gid;
#pragma unroll
  for (int j = 0; j < kB; ++j)
    if (u + j * stride < units) v[j] = __ldg(u4 + u + j * stride);
  for (int k = tid; k < 128 * 32; k += kT) rows[k] = 0;
  __syncthreads();
  if (kSplit && tid == 0) st[1] = gtime();
  unsigned* col = rows + (tid & 31);
  const long long tail = n - head - 16 * units;
  if (gid < head) ring_add(col, data[gid]);
  if (gid < tail) ring_add(col, body[16 * units + gid]);
  int since = 0;
  while (u < units) {
    if (u + (2 * kB - 1) * stride < units) {  // every unit and every next load in range
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const uint4 x = v[j];
        v[j] = __ldg(u4 + u + (j + kB) * stride);
        ring_count(x, col);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const long long uj = u + j * stride;
        if (uj < units) {
          const uint4 x = v[j];
          if (uj + kB * stride < units) v[j] = __ldg(u4 + uj + kB * stride);
          ring_count(x, col);
        }
      }
    }
    if ((since += kB) >= R::kFlush) {
      for (int j = 0; j < 128; ++j) {
        const unsigned w = atomicExch(col + j * 32, 0u);
        if (w & 0xffffu) red_add(acc + j * R::kStep, w & 0xffffu);
        if (w >> 16) red_add(acc + (j + 128) * R::kStep, w >> 16);
      }
      __threadfence();
      since = 0;
    }
    u += kB * stride;
  }
  __syncthreads();
  if (kSplit && tid == 0) st[2] = gtime();
  if (tid < 256) {
    const int j = tid & 127, h = tid >> 7;
    const uint4* row = reinterpret_cast<const uint4*>(rows + j * 32);
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int q = 4 * h; q < 4 * h + 4; ++q) {
      const uint4 x = row[(q + j) & 7];
      lo += (x.x & 0xffffu) + (x.y & 0xffffu) + (x.z & 0xffffu) + (x.w & 0xffffu);
      hi += (x.x >> 16) + (x.y >> 16) + (x.z >> 16) + (x.w >> 16);
    }
    s_sum[h][j] = lo;
    s_sum[h][j + 128] = hi;
  }
  __syncthreads();
  if (tid < 256) {
    const unsigned long long s = (unsigned long long)s_sum[0][tid] + s_sum[1][tid];
    unsigned long long* a = acc + tid * R::kStep;
    const unsigned long long old = atomicAdd(a, s + kArrived);
    if ((old >> 48) + 1 == gridDim.x) {
      out[tid] = (long long)((old & kCountMask) + s);
      *a = 0;
    }
  }
  if (kSplit) {
    __syncthreads();
    if (tid == 0) {
      st[3] = st[4] = st[5] = gtime();
      st[6] = smid();
      st[7] = kT;
    }
  }
}

template <int kT, int kC, int kB, bool kSpread>
int ring_ctas(long long n, int misalign, int sms) {
  if (n < 0) return 1;
  const long long head = misalign ? (16 - misalign < n ? 16 - misalign : n) : 0;
  const long long units = (n - head) / 16;
  long long g = (units + (long long)kT * kMinUnits - 1) / ((long long)kT * kMinUnits);
  const long long most = (long long)kC * (sms > 0 ? sms : 132);
  if (g > most) g = most;
  return (int)(g < 1 ? 1 : g);
}

template <int kT, int kC, int kB, bool kSpread>
int ring(bool split, const uint8_t* data, long long n, long long head, long long units, int ctas,
         void* acc, void* out, void* stamps, cudaStream_t s) {
  auto a = (unsigned long long*)acc;
  auto o = (long long*)out;
  auto t = (unsigned long long*)stamps;
  if (split)
    ring_kernel<kT, kC, kB, kSpread, true><<<ctas, kT, 0, s>>>(data, n, head, units, a, o, t);
  else
    ring_kernel<kT, kC, kB, kSpread, false><<<ctas, kT, 0, s>>>(data, n, head, units, a, o, t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fq_hist_variant_stamp_words() { return kStampWords; }

// CTAs of a launch of `mode` over n bytes whose first byte lies at
// `misalign` past a 16-byte boundary.
int fq_hist_variant_ctas(int mode, long long n, int misalign, int sms) {
  switch (mode) {
    case 0: return parent_ctas(n, misalign, sms);
    case kLaneRmw: return wave_ctas<kLaneRmw>(n, misalign, sms);
    case kLaneAtom: return wave_ctas<kLaneAtom>(n, misalign, sms);
    case kLaneAtomRuns: return wave_ctas<kLaneAtomRuns>(n, misalign, sms);
    case kWarpRuns: return wave_ctas<kWarpRuns>(n, misalign, sms);
    case kFloor: return wave_ctas<kFloor>(n, misalign, sms);
    case kLaneAtom2: return wave_ctas<kLaneAtom2>(n, misalign, sms);
    case kLaneAtom4: return wave_ctas<kLaneAtom4>(n, misalign, sms);
    case kCol512x2: return wave_ctas<kCol512x2>(n, misalign, sms);
    case kCol1024: return wave_ctas<kCol1024>(n, misalign, sms);
    case kCol256x4: return wave_ctas<kCol256x4>(n, misalign, sms);
    case kCol512x2C8: return wave_ctas<kCol512x2C8>(n, misalign, sms);
    case kCol512x2Fin: return wave_ctas<kCol512x2Fin>(n, misalign, sms);
    case kCol256x4Fin: return wave_ctas<kCol256x4Fin>(n, misalign, sms);
    case kLaneAtomFin: return wave_ctas<kLaneAtomFin>(n, misalign, sms);
    case kCol1024Fin: return wave_ctas<kCol1024Fin>(n, misalign, sms);
    case kCol512x2FinMin2: return wave_ctas<kCol512x2FinMin2>(n, misalign, sms);
    case kCol512x2FinPair: return wave_ctas<kCol512x2FinPair>(n, misalign, sms);
    case kCol512x2FinB2: return wave_ctas<kCol512x2FinB2>(n, misalign, sms);
    case kCol512x2FinB1: return wave_ctas<kCol512x2FinB1>(n, misalign, sms);
    case 15: return ring_ctas<512, 2, 4, false>(n, misalign, sms);
    case 16: return ring_ctas<512, 2, 4, true>(n, misalign, sms);
    case 17: return ring_ctas<512, 2, 8, false>(n, misalign, sms);
  }
  return -1;
}

// mode: 0-22 (above); data: n bytes (null when n is 0); ctas:
// fq_hist_variant_ctas; acc: 16 x 256 u64 left at 0 by every launch (modes 1-17);
// partials: ctas * 256 u64 (mode 0); ticket: a u32 left at 0 by every
// launch; out: 256 int64; stamps: ctas * 8 u64, or null for no split.
int fq_hist_variant(int mode, const void* data, long long n, int ctas, void* acc, void* partials,
                    void* ticket, void* out, void* stamps, void* stream) {
  if (n < 0 || ctas < 1 || (n > 0 && data == nullptr) || (uintptr_t)out % 8)
    return (int)cudaErrorInvalidValue;
  const int mis = (int)((uintptr_t)data % 16);
  const long long head = mis ? (16 - mis < n ? 16 - mis : n) : 0;
  const long long units = (n - head) / 16;
  const uint8_t* d = (const uint8_t*)data;
  cudaStream_t s = (cudaStream_t)stream;
  const bool split = stamps != nullptr;
  switch (mode) {
    case 0:
      if (split)
        parent_kernel<true><<<ctas, kPThreads, 0, s>>>(d, n, head, units,
                                                       (unsigned long long*)partials,
                                                       (unsigned*)ticket, (long long*)out,
                                                       (unsigned long long*)stamps);
      else
        parent_kernel<false><<<ctas, kPThreads, 0, s>>>(d, n, head, units,
                                                        (unsigned long long*)partials,
                                                        (unsigned*)ticket, (long long*)out,
                                                        (unsigned long long*)stamps);
      return (int)cudaGetLastError();
    case kLaneRmw: return wave<kLaneRmw>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kLaneAtom: return wave<kLaneAtom>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kLaneAtomRuns:
      return wave<kLaneAtomRuns>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kWarpRuns: return wave<kWarpRuns>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kFloor: return wave<kFloor>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kLaneAtom2:
      return wave<kLaneAtom2>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kLaneAtom4:
      return wave<kLaneAtom4>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kCol512x2:
      return wave<kCol512x2>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kCol1024:
      return wave<kCol1024>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kCol256x4:
      return wave<kCol256x4>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kCol512x2C8:
      return wave<kCol512x2C8>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kCol512x2Fin:
      return wave<kCol512x2Fin>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kCol256x4Fin:
      return wave<kCol256x4Fin>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kLaneAtomFin:
      return wave<kLaneAtomFin>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kCol1024Fin:
      return wave<kCol1024Fin>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kCol512x2FinMin2:
      return wave<kCol512x2FinMin2>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kCol512x2FinPair:
      return wave<kCol512x2FinPair>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kCol512x2FinB2:
      return wave<kCol512x2FinB2>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case kCol512x2FinB1:
      return wave<kCol512x2FinB1>(split, d, n, head, units, ctas, acc, ticket, out, stamps, s);
    case 15: return ring<512, 2, 4, false>(split, d, n, head, units, ctas, acc, out, stamps, s);
    case 16: return ring<512, 2, 4, true>(split, d, n, head, units, ctas, acc, out, stamps, s);
    case 17: return ring<512, 2, 8, false>(split, d, n, head, units, ctas, acc, out, stamps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
