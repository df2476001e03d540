// The context-model passes on Hopper (sm_90a), with a plain C interface for
// ctypes: the qctx and sctx prepare passes and the wctx lane matrices, both
// ways.
//
// They replace host functions that the JAX package runs around its device
// programs:
// - fq_qctx_prepare:  fastqpacker_tpu/runtime/fqruntime.cpp:1629
//                     fq_qctx_prepare (the per-record integration of the
//                     quality deltas and the (3072, 256) max-model histogram);
// - fq_sctx_prepare:  fqruntime.cpp:2092 fq_sctx_prepare (packed rows to one
//                     base a byte and the (4^6, 4) histogram);
// - fq_wctx_layout:   the lane matrices of fastqpacker_tpu/ops/wctx.py
//                     (start_matrix :178, to_matrix :157, context_matrix :218,
//                     the present-symbol map), numpy on the host there;
// - fq_wctx_unlayout: its from_matrix (:170) and present map, then
//                     fastqpacker_tpu/ops/seqctx.py:103 pack_stream or the
//                     quality delta transform (pipeline/native.py:348
//                     _raw_to_delta).
// The plain PyTorch versions are fastqpacker_tpu_torch/ops/ctxprep.py; each
// entry here computes the same bytes.
//
// What bounds them. Each reads and writes every symbol once or a few times
// and computes little per symbol: bytes bound all four (a 100,000 x 151 block
// moves 15-60 MB). The host walks a stream symbol by symbol; here:
// - the prepare passes give one warp to a record and walk it 32 symbols a
//   step. The integration mod 256 is a warp scan carried from step to step;
//   the previous one, two or six symbols come from the neighbouring lanes by
//   shuffles, and from the carry for the first lanes of a step. Quality data
//   puts most symbols on a few hundred of the 786,432 qctx bins, so a warp
//   first groups its equal bins (__match_any_sync) and adds each group's
//   count with one atomic. The sctx histogram (16,384 bins, 64 KB) is private
//   to each CTA in shared memory and added to the global one at the end;
// - the lane passes give a thread to a lane and a tile of 64 steps: it finds
//   its record by a binary search among the lane's records, then walks the
//   tile carrying the in-record position and the previous symbols. Cells of
//   one step lie side by side along the lanes, so the matrix stores of a warp
//   are contiguous. The packed output is written by bytes: a thread writes
//   each byte whose first base lies in its tile, reading past the tile's end
//   to finish it, so no byte has two writers.
// A launch does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpThreads = 256;       // threads per CTA of the qctx prepare
constexpr int kSctxThreads = 1024;      // threads per CTA of the sctx prepare
constexpr int kLaneThreads = 256;       // lanes per CTA of the lane passes
constexpr long long kSteps = 64;        // steps per tile of the lane passes

// qctx context geometry (ops/qualctx.py)
constexpr int kQbins = 48;
constexpr int kPbuckets = 8;
constexpr int kQ2b = 8;
constexpr int kQctxBins = kQbins * kPbuckets * kQ2b * 256;  // 786,432
// sctx: order 6
constexpr int kSctxOrder = 6;
constexpr unsigned kSctxMask = (1u << (2 * kSctxOrder)) - 1;
constexpr int kSctxBins = (1 << (2 * kSctxOrder)) * 4;  // 16,384

// fq_wctx_unlayout's modes (ops/ctxprep.py UNLAYOUT_*)
enum { kFlat = 0, kPacked = 1, kDelta = 2 };

__device__ inline int qctx_ctx2(long long p, int prev, int prev2) {
  const int qbin = p == 0 ? kQbins - 1 : min(prev, 46);
  const int pb = (int)min(p >> 4, (long long)(kPbuckets - 1));
  const int q2b = p < 2 ? kQ2b - 1 : (min(prev2, 46) >> 3);
  return (pb * kQbins + qbin) * kQ2b + q2b;
}

// Adds one to bin for each live lane of the warp: lanes with equal bins are
// grouped and their leader adds the group's count. Every lane of the warp
// calls it.
__device__ inline void add_grouped(unsigned* hist, int bin, bool live) {
  const unsigned live_mask = __ballot_sync(kFull, live);
  if (!live) return;
  const unsigned peers = __match_any_sync(live_mask, bin);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(hist + bin, (unsigned)__popc(peers));
}

// One warp a record: integrate, write raw, add the max-model bins.
__global__ void __launch_bounds__(kWarpThreads) qctx_prepare_kernel(
    const uint8_t* __restrict__ delta, long long n, const long long* __restrict__ bounds,
    long long nrec, uint8_t* __restrict__ raw, unsigned* __restrict__ hist) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kWarpThreads / 32);
  for (long long r = ((long long)blockIdx.x * kWarpThreads + threadIdx.x) >> 5; r < nrec;
       r += warps) {
    const long long start = bounds[r];
    const long long len = min(bounds[r + 1], n) - start;
    int carry = 0, prev_c = 0, prev2_c = 0;
    for (long long base = 0; base < len; base += 32) {
      const long long p = base + lane;
      const bool live = p < len;
      int v = live ? delta[start + p] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += y;
      }
      const int q = (carry + v) & 255;
      if (live) raw[start + p] = (uint8_t)q;
      int prev = __shfl_up_sync(kFull, q, 1);
      int prev2 = __shfl_up_sync(kFull, q, 2);
      if (lane == 0) {
        prev = prev_c;
        prev2 = prev2_c;
      } else if (lane == 1) {
        prev2 = prev_c;
      }
      add_grouped(hist, qctx_ctx2(p, prev, prev2) * 256 + q, live);
      carry = __shfl_sync(kFull, q, 31);  // a step that is not full is the last
      prev2_c = __shfl_sync(kFull, q, 30);
      prev_c = carry;
    }
  }
}

// One warp a record: unpack, write the bases, add the order-6 bins to the
// CTA's histogram in shared memory; then add that to the global one.
__global__ void __launch_bounds__(kSctxThreads) sctx_prepare_kernel(
    const uint8_t* __restrict__ packed, long long packed_n, const long long* __restrict__ bounds,
    const long long* __restrict__ pbounds, long long nrec, uint8_t* __restrict__ bases,
    unsigned* __restrict__ hist) {
  extern __shared__ unsigned sh[];
  for (int i = threadIdx.x; i < kSctxBins; i += kSctxThreads) sh[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kSctxThreads / 32);
  for (long long r = ((long long)blockIdx.x * kSctxThreads + threadIdx.x) >> 5; r < nrec;
       r += warps) {
    const long long start = bounds[r];
    const long long len = bounds[r + 1] - start;
    const long long ps = pbounds[r];
    unsigned carry = 0;  // the context after the previous step's last base
    for (long long base = 0; base < len; base += 32) {
      const long long p = base + lane;
      const long long at = ps + (p >> 2);
      const bool live = p < len && at < packed_n;
      const int s = live ? (packed[at] >> ((p & 3) * 2)) & 3 : 0;
      if (live) bases[start + p] = (uint8_t)s;
      unsigned ctx = 0;
#pragma unroll
      for (int k = 1; k <= kSctxOrder; ++k) {
        unsigned v = (unsigned)__shfl_up_sync(kFull, s, k);
        if (lane < k) v = (carry >> (2 * (k - lane - 1))) & 3;
        ctx |= v << (2 * (k - 1));
      }
      add_grouped(sh, (int)(ctx * 4 + s), live);
      carry = __shfl_sync(kFull, ((ctx << 2) | s) & kSctxMask, 31);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSctxBins; i += kSctxThreads) {
    const unsigned v = sh[i];
    if (v) atomicAdd(hist + i, v);
  }
}

// The last record r in [lo, hi) with bounds[r] <= j (bounds[lo] <= j).
__device__ inline long long find_record(const long long* __restrict__ bounds, long long lo,
                                        long long hi, long long j) {
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (bounds[mid] <= j) lo = mid;
    else hi = mid;
  }
  return lo;
}

// A thread a lane and a tile of kSteps steps. Encode (syms set): the
// present-index symbol and context of each cell; decode: its start flag.
__global__ void __launch_bounds__(kLaneThreads) wctx_layout_kernel(
    const uint8_t* __restrict__ syms, const long long* __restrict__ bounds,
    const long long* __restrict__ lanes_tab, int lanes, int steps, int model, int order,
    const uint8_t* __restrict__ idx_map, int pad_sym, uint8_t* __restrict__ sym_out,
    int16_t* __restrict__ ctx_out, uint8_t* __restrict__ start_out) {
  const int l = blockIdx.y * kLaneThreads + threadIdx.x;
  if (l >= lanes) return;
  const long long* sb = lanes_tab;
  const long long* rb = lanes_tab + lanes + 1;
  const bool enc = syms != nullptr;
  const long long t0 = (long long)blockIdx.x * kSteps;
  const long long t1 = min(t0 + kSteps, (long long)steps);
  const long long lo = sb[l];
  const long long seg = sb[l + 1] - lo;
  const long long tdata = min(t1, seg);
  const unsigned mask = (1u << (2 * order)) - 1;
  long long t = t0;
  if (t < tdata) {
    long long j = lo + t;
    long long r = find_record(bounds, rb[l], rb[l + 1], j);
    long long next = bounds[r + 1];
    long long p = t == 0 ? 0 : j - bounds[r];
    unsigned ctx = 0;  // model 0: the previous `order` bases, latest lowest
    int prev = 0, prev2 = 0;
    if (enc && p > 0) {
      if (model == 0) {
        for (int i = order; i >= 1; --i) ctx = (ctx << 2) | (p >= i ? syms[j - i] : 0u);
      } else {
        prev = syms[j - 1];
        prev2 = p >= 2 ? syms[j - 2] : 0;
      }
    }
    for (; t < tdata; ++t, ++j, ++p) {
      if (j == next) {  // the next record begins
        while (bounds[r + 1] <= j) ++r;
        next = bounds[r + 1];
        p = 0;
      }
      const long long cell = t * lanes + l;
      if (!enc) {
        start_out[cell] = p == 0;
        continue;
      }
      if (p == 0) {
        ctx = 0;
        prev = prev2 = 0;
      }
      const int s = syms[j];
      int c;
      if (model == 0) {
        c = (int)ctx;
        ctx = ((ctx << 2) | (unsigned)s) & mask;
      } else {
        const int qbin = p == 0 ? kQbins - 1 : min(prev, 46);
        c = (int)min(p >> 4, (long long)(kPbuckets - 1)) * kQbins + qbin;
        if (order == 1) c = c * kQ2b + (p < 2 ? kQ2b - 1 : (min(prev2, 46) >> 3));
        prev2 = prev;
        prev = s;
      }
      sym_out[cell] = idx_map[s];
      ctx_out[cell] = (int16_t)c;
    }
  }
  // padding: a record start of its own, the pad symbol, the start context
  const uint8_t pad_idx = enc ? idx_map[pad_sym] : 0;
  const int16_t pad_ctx = model == 0 ? 0 : (order == 1 ? (kQbins - 1) * kQ2b + kQ2b - 1 : kQbins - 1);
  for (; t < t1; ++t) {
    const long long cell = t * lanes + l;
    if (enc) {
      sym_out[cell] = pad_idx;
      ctx_out[cell] = pad_ctx;
    } else {
      start_out[cell] = 1;
    }
  }
}

// A thread a lane and a tile of kSteps steps: the data cells of the decoded
// matrix back in record order, as symbols, packed rows or quality deltas.
__global__ void __launch_bounds__(kLaneThreads) wctx_unlayout_kernel(
    const uint8_t* __restrict__ mat, const long long* __restrict__ bounds,
    const long long* __restrict__ pbounds, const long long* __restrict__ lanes_tab, int lanes,
    int steps, const uint8_t* __restrict__ present, int npres, int mode,
    uint8_t* __restrict__ dst, int* __restrict__ fault) {
  const int l = blockIdx.y * kLaneThreads + threadIdx.x;
  if (l >= lanes) return;
  const long long* sb = lanes_tab;
  const long long* rb = lanes_tab + lanes + 1;
  const long long t0 = (long long)blockIdx.x * kSteps;
  const long long t1 = min(t0 + kSteps, (long long)steps);
  const long long lo = sb[l];
  const long long seg = sb[l + 1] - lo;
  const long long tdata = min(t1, seg);
  if (t0 >= tdata) return;
  long long t = t0, j = lo + t0;
  long long r = find_record(bounds, rb[l], rb[l + 1], j);
  long long next = bounds[r + 1];
  long long p = j - bounds[r];
  bool bad = false;
  auto sym_at = [&](long long tt) -> int {
    int i = mat[tt * lanes + l];
    if (i >= npres) {
      bad = true;
      i = npres - 1;
    }
    return present[i];
  };
  auto step = [&]() {
    ++t;
    ++j;
    ++p;
    if (t < seg && j == next) {
      while (bounds[r + 1] <= j) ++r;
      next = bounds[r + 1];
      p = 0;
    }
  };
  if (mode == kFlat) {
    for (; t < tdata; step()) dst[j] = (uint8_t)sym_at(t);
  } else if (mode == kDelta) {
    int last = p > 0 ? present[min((int)mat[(t - 1) * lanes + l], npres - 1)] : 0;
    for (; t < tdata; step()) {
      const int s = sym_at(t);
      dst[j] = (uint8_t)(p == 0 ? s : s - last);
      last = s;
    }
  } else {
    while (t < tdata && (p & 3)) step();  // a byte begun in the tile before
    while (t < tdata) {
      const long long at = pbounds[r] + (p >> 2);
      unsigned byte = 0;
      do {
        byte |= ((unsigned)sym_at(t) << (2 * (p & 3))) & 255u;
        step();
      } while (t < seg && (p & 3));
      dst[at] = (uint8_t)byte;
    }
  }
  if (bad) atomicOr(fault, 1);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 132;
  return sms > 0 ? sms : 132;
}

// Raises the sctx kernel's dynamic shared memory cap once per device.
cudaError_t ready_sctx() {
  static std::mutex mu;
  static std::set<int> raised;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  if (raised.count(dev)) return cudaSuccess;
  rc = cudaFuncSetAttribute((const void*)sctx_prepare_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * kSctxBins);
  if (rc == cudaSuccess) raised.insert(dev);
  return rc;
}

dim3 lane_grid(int lanes, int steps) {
  return dim3((unsigned)((steps + kSteps - 1) / kSteps),
              (unsigned)((lanes + kLaneThreads - 1) / kLaneThreads));
}

}  // namespace

extern "C" {

// delta: n bytes; bounds: nrec + 1 int64 record starts (bounds[nrec] = n).
// raw: n bytes; hist: (3072, 256) uint32, zeroed here.
int fq_qctx_prepare(const void* delta, long long n, const void* bounds, long long nrec, void* raw,
                    void* hist, void* stream) {
  if (n < 0 || nrec < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(hist, 0, sizeof(unsigned) * (size_t)kQctxBins, s);
  if (rc != cudaSuccess) return (int)rc;
  if (nrec && n) {
    const long long want = (nrec + kWarpThreads / 32 - 1) / (kWarpThreads / 32);
    const long long most = 8LL * sm_count();
    const unsigned grid = (unsigned)(want < most ? want : most);
    qctx_prepare_kernel<<<grid, kWarpThreads, 0, s>>>(
        (const uint8_t*)delta, n, (const long long*)bounds, nrec, (uint8_t*)raw, (unsigned*)hist);
  }
  return (int)cudaGetLastError();
}

// packed: packed_n bytes; bounds: (2, nrec + 1) int64, the records' first
// base and first packed byte. bases: bounds[0][nrec] bytes; hist: (4096, 4)
// uint32, zeroed here.
int fq_sctx_prepare(const void* packed, long long packed_n, const void* bounds, long long nrec,
                    void* bases, void* hist, void* stream) {
  if (packed_n < 0 || nrec < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(hist, 0, sizeof(unsigned) * (size_t)kSctxBins, s);
  if (rc != cudaSuccess) return (int)rc;
  if (nrec) {
    rc = ready_sctx();
    if (rc != cudaSuccess) return (int)rc;
    const long long want = (nrec + kSctxThreads / 32 - 1) / (kSctxThreads / 32);
    const long long most = sm_count();
    const unsigned grid = (unsigned)(want < most ? want : most);
    const long long* b = (const long long*)bounds;
    sctx_prepare_kernel<<<grid, kSctxThreads, 4 * kSctxBins, s>>>(
        (const uint8_t*)packed, packed_n, b, b + nrec + 1, nrec, (uint8_t*)bases,
        (unsigned*)hist);
  }
  return (int)cudaGetLastError();
}

// The (steps, lanes) matrices of one wctx stream. bounds: nrec + 1 int64
// record starts; lanes_tab: (2, lanes + 1) int64, each lane's first symbol
// and first record. Encode (syms: the flat symbols): sym_out (present index,
// idx_map[pad_sym] on padding) and ctx_out; decode (syms null): start_out.
int fq_wctx_layout(const void* syms, const void* bounds, const void* lanes_tab, int lanes,
                   int steps, int model, int order, const void* idx_map, int pad_sym,
                   void* sym_out, void* ctx_out, void* start_out, void* stream) {
  if (lanes <= 0 || steps <= 0 || order < 0 || order > kSctxOrder || pad_sym < 0 || pad_sym > 255)
    return (int)cudaErrorInvalidValue;
  wctx_layout_kernel<<<lane_grid(lanes, steps), kLaneThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)syms, (const long long*)bounds, (const long long*)lanes_tab, lanes, steps,
      model, order, (const uint8_t*)idx_map, pad_sym, (uint8_t*)sym_out, (int16_t*)ctx_out,
      (uint8_t*)start_out);
  return (int)cudaGetLastError();
}

// The decoded (steps, lanes) present-index matrix in record order. bounds:
// (1 or, for the packed mode, 2, nrec + 1) int64 as in fq_sctx_prepare;
// dst: the flat symbols or the quality deltas (n bytes) or the packed rows;
// fault: one int32, set to 1 (not cleared) where a data cell's index is
// >= npres.
int fq_wctx_unlayout(const void* mat, const void* bounds, long long nrec, const void* lanes_tab,
                     int lanes, int steps, const void* present, int npres, int mode, void* dst,
                     void* fault, void* stream) {
  if (lanes <= 0 || steps <= 0 || npres <= 0 || npres > 256 || mode < kFlat || mode > kDelta)
    return (int)cudaErrorInvalidValue;
  const long long* b = (const long long*)bounds;
  wctx_unlayout_kernel<<<lane_grid(lanes, steps), kLaneThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mat, b, mode == kPacked ? b + nrec + 1 : nullptr,
      (const long long*)lanes_tab, lanes, steps, (const uint8_t*)present, npres, mode,
      (uint8_t*)dst, (int*)fault);
  return (int)cudaGetLastError();
}

}  // extern "C"
