// One thread's dependent step on the card, for the context coders' step
// prediction (scripts/ctx_step_probe.py builds and runs it; the package never
// calls it). Each mode runs `steps` dependent steps in one thread and writes
// its clock64 and %globaltimer deltas (out[0], out[1]) and a result that keeps
// the chain alive (out[2]):
//   0: p = table[p] through shared memory (a 4096-entry u32 cycle);
//   1: p = table[p] through the L1 (`ld.global.ca`, a cycle of `n` u32 words);
//   2: the same through the L2 only (`ld.global.cg`);
//   4: the same through the read-only path (`__ldg`, `ld.global.nc`), which the
//      coders' table reads take;
//   3: one encode step of the context coders on one state: the renorm compare
//      and shift, floor(x / f) by multiply-high with the reciprocal, the
//      remainder and the cum (csrc/ctxcoder.cu encode_kernel's phase B), f, m,
//      s and cum cycling through 8 register entries;
//   6: the qctx decode's dense step (csrc/ctxcoder.cu qctx_dense_kernel's
//      critical path), one warp: the row offset from the previous symbol's
//      count (one IMAD), each lane's 32-bit load of two u16 cums from the row
//      in shared memory, two compares against the slot, two ballots, two
//      popcounts and their sum, the slot from an LCG off the chain;
//   7: the sctx decode's branch-free step (sctx_dense_kernel's critical
//      path), one warp: a 16-byte row load {c1, c2, c3, c4}, three compares,
//      the next context by selects and one add, a record start every 151
//      steps;
//   8-10: mode 6's search otherwise: 8 one `__reduce_add_sync` of each lane's
//      two compares; 9 two u16 loads a lane (columns lane and lane + 32) and
//      two ballots; 10 those loads and one `__reduce_add_sync`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

__device__ __forceinline__ uint32_t ld_ca(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.ca.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ld_nc(const uint32_t* p) { return __ldg(p); }

__device__ __forceinline__ uint32_t ld_cg(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.cg.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__global__ void probe(const uint32_t* table, long long n, int mode, long long steps,
                      const uint32_t* params, unsigned long long* out) {
  __shared__ uint32_t sh[4096];
  if (mode == 0) {
    for (int i = threadIdx.x; i < 4096; i += blockDim.x) sh[i] = table[i];
    __syncthreads();
  }
  if (threadIdx.x) return;
  uint32_t p = 0;
  uint32_t x = 1u << 16;
  uint32_t f[8], m[8], s[8], c[8];
  for (int i = 0; i < 8; ++i) {
    f[i] = params[4 * i];
    m[i] = params[4 * i + 1];
    s[i] = params[4 * i + 2];
    c[i] = params[4 * i + 3];
  }
  // warm the caches on the chain's own path
  if (mode == 1 || mode == 2 || mode == 4)
    for (long long i = 0; i < n; ++i)
      p = mode == 1 ? ld_ca(table + p) : mode == 2 ? ld_cg(table + p) : ld_nc(table + p);
  const unsigned long long c0 = clock64(), t0 = gtime();
  if (mode == 0) {
    for (long long i = 0; i < steps; ++i) p = sh[p];
  } else if (mode == 1) {
    for (long long i = 0; i < steps; ++i) p = ld_ca(table + p);
  } else if (mode == 2) {
    for (long long i = 0; i < steps; ++i) p = ld_cg(table + p);
  } else if (mode == 4) {
    for (long long i = 0; i < steps; ++i) p = ld_nc(table + p);
  } else {
    for (long long i = 0; i < steps; i += 8) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if ((x >> 20) >= f[b]) x >>= 16;
        const uint32_t q = (uint32_t)(((unsigned long long)x + __umulhi(x, m[b])) >> s[b]);
        x = (q << 12) + (x - q * f[b]) + c[b];
      }
    }
    p = x;
  }
  const unsigned long long c1 = clock64(), t1 = gtime();
  out[0] = c1 - c0;
  out[1] = t1 - t0;
  out[2] = p;
}

// Modes 6 and 7: `rows` (u32 words) copied into dynamic shared memory; 32
// lanes run the chain, lane 0 writes the times.
__global__ void probe_dense(const uint32_t* rows, long long nwords, int mode, long long steps,
                            const uint32_t* params, unsigned long long* out) {
  extern __shared__ uint32_t sh[];
  for (long long i = threadIdx.x; i < nwords; i += blockDim.x) sh[i] = rows[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // params: row bytes (W2), lanes holding cums, the qb-group stride (7 W2),
  // the pb-group stride, the sctx context mask (x16)
  const uint32_t w2 = params[0], nl = params[1], mstride = params[2], pbstride = params[3],
                 mask16 = params[4];
  const bool active = lane < (int)nl;
  const char* base = reinterpret_cast<const char*>(sh);
  uint32_t cnt = 1, x = 12345u, ctx16 = 0, sink = 0, left = 151;
  const unsigned long long c0 = clock64(), t0 = gtime();
  if (mode >= 8) {  // variants of mode 6's search: 8 one REDUX.SUM of the lanes' counts;
                    // 9 / 10 two u16 loads a lane (columns lane and lane + 32), ballots / REDUX
    const uint32_t ncols = nl * 2;
    const bool act0 = lane < (int)ncols, act1 = lane + 32 < (int)ncols;
    for (long long i = 0; i < steps; i += 8) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        x = x * 1664525u + 1013904223u;
        const uint32_t sl1 = (x >> 20) + 1, key = sl1 << 16;
        if (mode == 8) {
          const uint32_t c = ((uint32_t)((i + b) >> 4) & 7) * pbstride + 4 * lane - mstride;
          const uint32_t v = *reinterpret_cast<const uint32_t*>(base + cnt * mstride + c);
          cnt = __reduce_add_sync(0xFFFFFFFFu, (uint32_t)(active && (v << 16) < key) +
                                                    (uint32_t)(active && v < key));
        } else {
          const uint32_t c = ((uint32_t)((i + b) >> 4) & 7) * pbstride + 2 * lane - mstride;
          const char* r = base + cnt * mstride + c;
          const uint32_t v0 = *reinterpret_cast<const uint16_t*>(r);
          const uint32_t v1 = *reinterpret_cast<const uint16_t*>(r + 64);
          const bool p0 = act0 && v0 < sl1, p1 = act1 && v1 < sl1;
          cnt = mode == 9 ? __popc(__ballot_sync(0xFFFFFFFFu, p0)) +
                                __popc(__ballot_sync(0xFFFFFFFFu, p1))
                          : __reduce_add_sync(0xFFFFFFFFu, (uint32_t)p0 + (uint32_t)p1);
        }
      }
    }
    sink = cnt + w2;
  } else if (mode == 6) {
    for (long long i = 0; i < steps; i += 8) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        x = x * 1664525u + 1013904223u;
        const uint32_t key = ((x >> 20) + 1) << 16;
        const uint32_t c = ((uint32_t)((i + b) >> 4) & 7) * pbstride + 4 * lane - mstride;
        const uint32_t v = *reinterpret_cast<const uint32_t*>(base + cnt * mstride + c);
        const uint32_t b0 = __ballot_sync(0xFFFFFFFFu, active && (v << 16) < key);
        const uint32_t b1 = __ballot_sync(0xFFFFFFFFu, active && v < key);
        cnt = __popc(b0) + __popc(b1);
      }
    }
    sink = cnt + w2;
  } else {
    for (long long i = 0; i < steps; i += 8) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        x = x * 1664525u + 1013904223u;
        const uint32_t sl = x >> 20;
        const bool start = --left == 0;
        left = start ? 151u : left;
        const uint32_t m = start ? 0u : mask16;
        const uint32_t pre = (ctx16 << 2) & m, k = m & 16;
        const uint4 row = *reinterpret_cast<const uint4*>(base + ctx16);
        const uint32_t r1 = row.x <= sl ? pre + k : pre;
        const uint32_t r2 = row.y <= sl ? k : 0u;
        const uint32_t r3 = row.z <= sl ? k : 0u;
        ctx16 = r1 + r2 + r3;
      }
    }
    sink = ctx16;
  }
  const unsigned long long c1 = clock64(), t1 = gtime();
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = t1 - t0;
    out[2] = sink;
  }
}

}  // namespace

extern "C" int ctx_step_probe(const void* table, long long n, int mode, long long steps,
                              const void* params, void* out, void* stream) {
  if (mode >= 6) {  // 6-10: probe_dense
    const int bytes = (int)(n * 4);
    cudaError_t rc =
        cudaFuncSetAttribute(probe_dense, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return (int)rc;
    probe_dense<<<1, 32, bytes, (cudaStream_t)stream>>>(
        (const uint32_t*)table, n, mode, steps, (const uint32_t*)params, (unsigned long long*)out);
    return (int)cudaGetLastError();
  }
  probe<<<1, mode == 0 ? 256 : 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, n, mode, steps, (const uint32_t*)params, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
