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
// each. A launch:
// - the bytes before the first 16-byte boundary and after the last whole
//   16-byte unit (at most 15 each) are counted one a thread by the grid's
//   first threads; the units between are read as 16-byte loads, several in
//   flight a thread, striding over the grid;
// - each warp counts into a table of its own (256 u32 in shared memory), so
//   warps never contend; within a warp a thread keeps a run of equal bytes in
//   registers and adds it to the table when the byte changes. Quality
//   deltas are a few symbols and nearly all one: a thread then adds once per
//   run, not once per byte, and lanes rarely add to one slot at the same
//   time. A whole 4-byte word of the run's byte adds 4 at once;
// - each CTA sums its warps' tables into 256 u64 partials; the last CTA to
//   finish (a ticket counter that wraps back to 0, so the next launch on the
//   stream finds it at 0) adds every CTA's partials into the 256 int64
//   counts. One device operation a call: no memset before it.
// Bytes bound it: every input byte is read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 4;  // 16-byte loads a thread issues before counting them
constexpr int kCtasPerSm = 2;

// Adds the 4 bytes of w to the thread's run (sym, cnt); a run that ends
// goes into the warp's table.
__device__ inline void count_word(unsigned w, unsigned& sym, unsigned& cnt, unsigned* tab) {
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

__device__ inline void count_unit(const uint4& v, unsigned& sym, unsigned& cnt, unsigned* tab) {
  count_word(v.x, sym, cnt, tab);
  count_word(v.y, sym, cnt, tab);
  count_word(v.z, sym, cnt, tab);
  count_word(v.w, sym, cnt, tab);
}

// data: n bytes; head: the bytes before the first 16-byte boundary (<= n);
// units: the whole 16-byte units after them. partials: gridDim.x * 256 u64;
// ticket: a u32 left at 0 by every launch; out: 256 int64.
__global__ void __launch_bounds__(kThreads) hist256_kernel(const uint8_t* data, long long n,
                                                           long long head, long long units,
                                                           unsigned long long* partials,
                                                           unsigned* ticket, long long* out) {
  __shared__ unsigned tab[kWarps][256];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  unsigned* flat = &tab[0][0];
  for (int k = tid; k < kWarps * 256; k += kThreads) flat[k] = 0;
  __syncthreads();
  unsigned* mine = tab[tid >> 5];
  const long long gid = (long long)blockIdx.x * kThreads + tid;
  const long long stride = (long long)gridDim.x * kThreads;
  const uint8_t* body = data + head;
  const long long tail = n - head - 16 * units;
  if (gid < head) atomicAdd(&mine[data[gid]], 1u);
  if (gid < tail) atomicAdd(&mine[body[16 * units + gid]], 1u);

  const uint4* u4 = reinterpret_cast<const uint4*>(body);
  unsigned sym = 0, cnt = 0;
  long long u = gid;
  for (; u + (kInFlight - 1) * stride < units; u += kInFlight * stride) {
    uint4 v[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) v[j] = __ldg(u4 + u + j * stride);
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) count_unit(v[j], sym, cnt, mine);
  }
  for (; u < units; u += stride) count_unit(__ldg(u4 + u), sym, cnt, mine);
  if (cnt) atomicAdd(&mine[sym], cnt);
  __syncthreads();

  if (tid < 256) {
    unsigned long long s = 0;
#pragma unroll 8
    for (int w = 0; w < kWarps; ++w) s += tab[w][tid];
    partials[(long long)blockIdx.x * 256 + tid] = s;
    __threadfence();  // this CTA's partials before its ticket
  }
  __syncthreads();
  if (tid == 0) s_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last CTA: every CTA's partials, read past L1
  if (tid < 256) {
    unsigned long long s = 0;
    for (unsigned c = 0; c < gridDim.x; ++c) s += __ldcg(partials + (long long)c * 256 + tid);
    out[tid] = (long long)s;
  }
}

}  // namespace

extern "C" {

// CTAs of a launch over n bytes whose first byte lies at `misalign` past a
// 16-byte boundary (the partials the wrapper allocates: 256 u64 each).
int fq_hist256_ctas(long long n, int misalign, int sms) {
  if (n < 0) return 1;
  const long long head = misalign ? (16 - misalign < n ? 16 - misalign : n) : 0;
  const long long units = (n - head) / 16;
  long long g = (units + (long long)kThreads * kInFlight - 1) / ((long long)kThreads * kInFlight);
  const long long most = (long long)kCtasPerSm * (sms > 0 ? sms : 132);
  if (g > most) g = most;
  return (int)(g < 1 ? 1 : g);
}

// data: n bytes at any alignment (null when n is 0); ctas: fq_hist256_ctas
// for this n and alignment; partials: ctas * 256 u64; ticket: a u32 left at
// 0 by every launch on the stream; out: 256 int64, every slot written. One
// launch.
int fq_hist256(const void* data, long long n, int ctas, void* partials, void* ticket, void* out,
               void* stream) {
  if (n < 0 || ctas < 1 || (n > 0 && data == nullptr) || (uintptr_t)partials % 16 ||
      (uintptr_t)out % 8)
    return (int)cudaErrorInvalidValue;
  const int mis = (int)((uintptr_t)data % 16);
  const long long head = mis ? (16 - mis < n ? 16 - mis : n) : 0;
  const long long units = (n - head) / 16;
  hist256_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, n, head, units, (unsigned long long*)partials, (unsigned*)ticket,
      (long long*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
