// The order-0 byte histogram of the v3 and mesh paths on Hopper (sm_90a),
// with a plain C interface for ctypes.
//
// fq_hist256 replaces fastqpacker_tpu/runtime/fqruntime.cpp:493 fq_hist256:
// the 256 exact counts of a byte stream, which the v3 size estimate and
// every order-0 rANS table are built from. The plain PyTorch version is
// ops/rans.py hist256_plain (a bincount of a CPU tensor).
//
// The streams it counts are views of one device buffer (the six streams of
// a block that fq_streams_build wrote) at any byte offset, 16 KiB to 15 MB
// each. Bytes bound it: every input byte is read once. A launch:
// - one wave of CTAs sized to the card: kCtasPerSm an SM, fewer for a
//   stream too short to give each thread kMinUnits units. Each thread walks
//   the stream's 16-byte units at the grid's stride, the next unit's load in
//   flight while it counts the one before (one unit at a time: after the
//   last loads land, a thread has one unit left to count, not a batch); 32
//   warps an SM keep the loads in flight. The bytes before the first 16-byte
//   boundary and after the last whole unit (at most 15 each) go one a thread
//   to the grid's first threads;
// - one set of counters a CTA in shared memory, a column a lane: bins 2j and
//   2j + 1 as the two u16 of word [j][lane], so the 32 lanes of a warp
//   always add to 32 banks and never to one word, whatever the bytes;
//   every warp of the CTA adds into the same columns, one warp's atomics
//   after another's. A byte is one shared atomicAdd whose result is unused.
//   (Runs of equal bytes kept in registers cost more in branches than the
//   atomics they save.) Before a u16 could overflow (kFlushUnits units into
//   a column), a thread moves its column into the accumulator below;
// - each CTA sums its columns (a thread a row and half the lanes) and adds
//   each bin's sum with its arrival (1 << 48) into a 256 x u64 accumulator
//   in device memory; the CTA whose add brings a bin's arrivals to the
//   grid's size writes the bin out and zeroes it, so the next launch on the
//   stream finds the accumulator at 0. One device operation a call: no
//   memset, no per-call partials, no ticket, no loop over CTAs.
//
// fq_hist256_split runs the same kernel with a timeline (kStampWords u64 a
// CTA) for scripts/hist_ab.py --split; the package never calls it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kCtasPerSm = 2;
constexpr int kMinUnits = 4;       // units a thread takes at least before a CTA is added
constexpr int kFlushUnits = 4000;  // units a column counts between flushes (16 x 4000 < 65536)
constexpr int kRows = 128;         // words of a column: bins 2j and 2j + 1 in row j
// units a thread counts between flushes: its column takes every warp's
constexpr int kFlush = kFlushUnits / (kThreads / 32);
constexpr unsigned long long kArrived = 1ull << 48;  // a CTA's add to a bin, above its count
constexpr unsigned long long kCountMask = kArrived - 1;
// the timeline of fq_hist256_split, per CTA: the globaltimer (ns) at the
// CTA's start, after its counters are zeroed, after its counting, after its
// adds (and the bins it finished written out); the SM; the threads
constexpr int kStampWords = 6;

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

__device__ __forceinline__ void red_add(unsigned long long* p, unsigned long long v) {
  asm volatile("red.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// One more of byte b in the lane's column (`col`: its word of row 0).
__device__ __forceinline__ void add(unsigned* col, unsigned b) {
  atomicAdd(col + (b >> 1) * 32, 1u << ((b & 1) << 4));
}

__device__ __forceinline__ void count_unit(const uint4& v, unsigned* col) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) add(col, (w[i] >> (8 * k)) & 0xffu);
  }
}

// data: n bytes; head: the bytes before the first 16-byte boundary (<= n);
// units: the whole 16-byte units after them; acc: 256 u64 left at 0 by every
// launch on the stream; out: 256 int64; stamps: gridDim.x * kStampWords u64
// (kSplit only).
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    hist256_kernel(const uint8_t* data, long long n, long long head, long long units,
                   unsigned long long* acc, long long* out, unsigned long long* stamps) {
  __shared__ __align__(16) unsigned rows[kRows * 32];  // [b / 2][lane]
  __shared__ unsigned s_sum[2][256];
  const int tid = threadIdx.x;
  unsigned long long* st = stamps + (long long)blockIdx.x * kStampWords;
  if (kSplit && tid == 0) st[0] = gtime();
  const long long gid = (long long)blockIdx.x * kThreads + tid;
  const long long stride = (long long)gridDim.x * kThreads;
  const uint8_t* body = data + head;
  const uint4* u4 = reinterpret_cast<const uint4*>(body);
  // the first unit in flight while the counters are zeroed
  long long u = gid;
  uint4 cur;
  if (u < units) cur = __ldg(u4 + u);
  for (int k = tid; k < kRows * 32; k += kThreads) rows[k] = 0;
  __syncthreads();
  if (kSplit && tid == 0) st[1] = gtime();
  unsigned* col = rows + (tid & 31);
  const long long tail = n - head - 16 * units;
  if (gid < head) add(col, data[gid]);
  if (gid < tail) add(col, body[16 * units + gid]);

  int since = 0;  // units counted since the last flush
  while (u < units) {
    const long long next = u + stride;
    uint4 nxt;
    if (next < units) nxt = __ldg(u4 + next);
    count_unit(cur, col);
    if (++since == kFlush) {
      // the column into the accumulator (by atomicExch: other warps add to
      // it), out before this CTA's last add to any bin (the fence)
      for (int j = 0; j < kRows; ++j) {
        const unsigned w = atomicExch(col + j * 32, 0u);
        if (w & 0xffffu) red_add(acc + 2 * j, w & 0xffffu);
        if (w >> 16) red_add(acc + 2 * j + 1, w >> 16);
      }
      __threadfence();
      since = 0;
    }
    cur = nxt;
    u = next;
  }
  __syncthreads();
  if (kSplit && tid == 0) st[2] = gtime();

  // the CTA's sums: thread (h, j) adds bins 2j and 2j + 1 over lanes
  // 16h .. 16h + 15, row j's 16-byte pieces from piece j % 8 on, so a warp's
  // loads spread over every bank
  if (tid < 256) {
    const int j = tid & (kRows - 1), h = tid >> 7;
    const uint4* row = reinterpret_cast<const uint4*>(rows + j * 32);
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int q = 4 * h; q < 4 * h + 4; ++q) {
      const uint4 x = row[(q + j) & 7];
      lo += (x.x & 0xffffu) + (x.y & 0xffffu) + (x.z & 0xffffu) + (x.w & 0xffffu);
      hi += (x.x >> 16) + (x.y >> 16) + (x.z >> 16) + (x.w >> 16);
    }
    s_sum[h][2 * j] = lo;
    s_sum[h][2 * j + 1] = hi;
  }
  __syncthreads();
  if (tid < 256) {
    // the bin's sum with this CTA's arrival; the last to arrive writes it out
    const unsigned long long s = (unsigned long long)s_sum[0][tid] + s_sum[1][tid];
    const unsigned long long old = atomicAdd(acc + tid, s + kArrived);
    if ((old >> 48) + 1 == gridDim.x) {
      out[tid] = (long long)((old & kCountMask) + s);
      acc[tid] = 0;
    }
  }
  if (kSplit) {
    __syncthreads();
    if (tid == 0) {
      st[3] = gtime();
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      st[4] = sm;
      st[5] = kThreads;
    }
  }
}

template <bool kSplit>
int launch(const void* data, long long n, int ctas, void* acc, void* out, void* stamps,
           void* stream) {
  if (n < 0 || ctas < 1 || (n > 0 && data == nullptr) || (uintptr_t)acc % 8 ||
      (uintptr_t)out % 8 || (kSplit && stamps == nullptr))
    return (int)cudaErrorInvalidValue;
  const int mis = (int)((uintptr_t)data % 16);
  const long long head = mis ? (16 - mis < n ? 16 - mis : n) : 0;
  const long long units = (n - head) / 16;
  hist256_kernel<kSplit><<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, n, head, units, (unsigned long long*)acc, (long long*)out,
      (unsigned long long*)stamps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// CTAs of a launch over n bytes whose first byte lies at `misalign` past a
// 16-byte boundary, on a card of `sms` SMs: kCtasPerSm an SM at most.
int fq_hist256_ctas(long long n, int misalign, int sms) {
  if (n < 0) return 1;
  const long long head = misalign ? (16 - misalign < n ? 16 - misalign : n) : 0;
  const long long units = (n - head) / 16;
  long long g = (units + (long long)kThreads * kMinUnits - 1) / ((long long)kThreads * kMinUnits);
  const long long most = (long long)kCtasPerSm * (sms > 0 ? sms : 132);
  if (g > most) g = most;
  return (int)(g < 1 ? 1 : g);
}

// data: n bytes at any alignment (null when n is 0); ctas: fq_hist256_ctas
// for this n and alignment; acc: 256 u64 left at 0 by every launch on the
// stream (zeroed once when made); out: 256 int64, every slot written. One
// launch.
int fq_hist256(const void* data, long long n, int ctas, void* acc, void* out, void* stream) {
  return launch<false>(data, n, ctas, acc, out, nullptr, stream);
}

// fq_hist256 with its timeline: stamps, ctas * kStampWords u64.
int fq_hist256_split(const void* data, long long n, int ctas, void* acc, void* out, void* stamps,
                     void* stream) {
  return launch<true>(data, n, ctas, acc, out, stamps, stream);
}

}  // extern "C"
