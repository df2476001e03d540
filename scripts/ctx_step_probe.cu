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
//      s and cum cycling through 8 register entries.

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

}  // namespace

extern "C" int ctx_step_probe(const void* table, long long n, int mode, long long steps,
                              const void* params, void* out, void* stream) {
  probe<<<1, mode == 0 ? 256 : 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, n, mode, steps, (const uint32_t*)params, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
