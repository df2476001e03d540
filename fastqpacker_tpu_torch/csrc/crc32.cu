// Chunk-parallel CRC32 (IEEE 802.3, reflected polynomial 0xEDB88320, the
// value zlib.crc32 gives) on Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// fq_crc32_chunks replaces the XLA program _crc_lanes_kernel
// (fastqpacker_tpu/ops/crc32.py:87) and the host-side GF(2) combine loop
// around it (crc32_device, ops/crc32.py:116-160).
//
// The math (ops/crc32.py says it at length): the stream is cut into chunks
// of kChunk bytes, zero-filled up to a whole number of spans of kThreads
// chunks; each chunk's raw CRC (state 0, no final XOR) is independent, and
// raw CRCs combine linearly, raw(A||B) = shift(raw(A), |B|) ^ raw(B), where
// shift multiplies by x^(8|B|) mod P. Every chunk is whole, so the combine
// is a binary tree whose level l shifts by the constant kChunk * 2^l bytes,
// a product by x^(8 kChunk 2^l) mod P given as its 32-entry basis (computed
// once on the host). Two constants of the stream's length, also from the
// host, take the zero fill out again (a product by x^-8t) and turn the raw
// CRC into zlib's.
//
// What bounds it. By bytes it reads each byte once and writes 4 bytes; the
// work is one table lookup per byte. The design keeps both off the critical
// path of any one thread:
// - a CTA stages one span (kThreads x kChunk bytes) into shared memory with
//   coalesced 16-byte cp.async, rows skewed by 16 bytes so a quarter warp's
//   16-byte reads of its rows hit distinct banks;
// - each thread walks its chunk 16 bytes at a time with slice-by-16 tables
//   in shared memory (16 independent lookups, one level of dependence);
// - a warp combines its 32 chunks in 5 shuffle levels, warp 0 the CTA's
//   warps in 2 more, each level one GF(2) product by a constant: 32
//   independent selects from its basis, not 32 dependent shift steps;
// - a CTA loops over spans (a grid of a few CTAs per SM), writes one partial
//   per span, and the last CTA to finish (a ticket counter that wraps back
//   to 0, so it needs no reset) combines the partials and writes the result:
//   one launch per CRC, with no output zeroed beforehand.
// The TPU formulation (bitwise 8-step update, (K, N) transposed layout,
// masked lanes, host Python combine) is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kPoly = 0xEDB88320u;
constexpr int kThreads = 128;              // chunks per span, one per thread
constexpr int kChunk = 256;                // bytes per chunk, a multiple of 16
constexpr int kSpan = kThreads * kChunk;   // bytes per span
constexpr int kRow = kChunk + 16;          // staged row stride (bank skew)
constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 4;
constexpr int kLevels = 30;  // shifts by kChunk * 2^l bytes, l < 30 (n < 2^38)
constexpr int kShared = 16 * 256 * 4 + kThreads * kRow;  // tables + one span

static_assert(kChunk % 16 == 0 && kWarps >= 1 && kWarps <= 32 &&
              (kWarps & (kWarps - 1)) == 0, "geometry");

constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }
constexpr int kLogThreads = log2i(kThreads);

// A product by a constant a(x) mod P(x) is linear in the other factor b, so
// it is the XOR of a's basis m[k] = a * x^k over the bits k of b: 32
// independent selects, no chain of 32 dependent steps.
struct Consts {
  uint32_t shift[kLevels][32];  // basis of x^(8 kChunk 2^l) mod P
  uint32_t unshift[32];         // basis of x^(-8 (zero-filled bytes)) mod P
  uint32_t fin_xor;             // shift(0xFFFFFFFF, n) ^ 0xFFFFFFFF
};
static_assert(sizeof(Consts) <= 4096, "a kernel parameter of at most 4 KiB");

// a(x) * b(x) mod P(x) in the reflected representation (bit 31 is x^0), on
// the host.
uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (a & (0x80000000u >> i)) p ^= b;
    b = (b >> 1) ^ (kPoly & (0u - (b & 1u)));
  }
  return p;
}

__device__ __forceinline__ uint32_t mul_basis(const uint32_t (&m)[32], uint32_t b) {
  uint32_t p[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 32; ++k) p[k & 3] ^= m[k] & (0u - ((b >> k) & 1u));
  return p[0] ^ p[1] ^ p[2] ^ p[3];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ uint32_t lookup4(const uint32_t* t, int k, uint32_t w) {
  // bytes 0..3 of w through the tables k, k - 1, k - 2, k - 3
  return t[k * 256 + (w & 0xFF)] ^ t[(k - 1) * 256 + ((w >> 8) & 0xFF)] ^
         t[(k - 2) * 256 + ((w >> 16) & 0xFF)] ^ t[(k - 3) * 256 + (w >> 24)];
}

// Raw CRC update by 16 bytes: t[k * 256 + b] is the CRC of byte b followed
// by k zero bytes.
__device__ __forceinline__ uint32_t step16(const uint32_t* t, uint32_t crc, uint4 v) {
  return lookup4(t, 15, v.x ^ crc) ^ lookup4(t, 11, v.y) ^ lookup4(t, 7, v.z) ^
         lookup4(t, 3, v.w);
}

// The value of lanes [i, i + 2^levels) at lane i (i a multiple of 2^levels)
// for values held in order from the start of the stream: at level l the
// earlier half is shifted past the later one (level first + l).
__device__ __forceinline__ uint32_t tree_forward(uint32_t v, const Consts& c,
                                                 int first, int levels) {
  for (int l = 0; l < levels; ++l) {
    const uint32_t later = __shfl_down_sync(kFullMask, v, 1 << l);
    v = mul_basis(c.shift[first + l], v) ^ later;
  }
  return v;
}

// As tree_forward for values held in order from the END of the stream
// (lane i + 1 holds the earlier value).
__device__ __forceinline__ uint32_t tree_backward(uint32_t v, const Consts& c,
                                                  int first, int levels) {
  for (int l = 0; l < levels; ++l) {
    const uint32_t earlier = __shfl_down_sync(kFullMask, v, 1 << l);
    v ^= mul_basis(c.shift[first + l], earlier);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
crc32_kernel(const uint8_t* __restrict__ data, long long n, long long spans,
             int log_per_thread, uint32_t* __restrict__ partials,
             unsigned* __restrict__ ticket, uint32_t* __restrict__ out,
             const __grid_constant__ Consts c) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint8_t* stage = smem + 16 * 256 * 4;
  __shared__ uint32_t warp_part[kWarps];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  auto stage_span = [&](long long g) {
    const long long base = g * kSpan;
    for (int p = tid; p < kSpan / 16; p += kThreads) {
      const long long off = base + 16ll * p;
      uint8_t* dst = stage + (p / (kChunk / 16)) * kRow + 16 * (p % (kChunk / 16));
      if (off + 16 <= n) {
        cp_async16(dst, data + off);
      } else {  // the piece holding the end, and the zero fill after it
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (off + k < n) w[k >> 2] |= (uint32_t)data[off + k] << (8 * (k & 3));
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // the first span's copies fly while the tables are built
  stage_span(blockIdx.x);
  for (int b = tid; b < 256; b += kThreads) {
    uint32_t v = (uint32_t)b;
#pragma unroll
    for (int k = 0; k < 8; ++k) v = (v >> 1) ^ (kPoly & (0u - (v & 1u)));
    tab[b] = v;
  }
  __syncthreads();
  for (int b = tid; b < 256; b += kThreads) {
    uint32_t v = tab[b];
    for (int k = 1; k < 16; ++k) {
      v = (v >> 8) ^ tab[v & 0xFF];
      tab[k * 256 + b] = v;
    }
  }
  for (long long g = blockIdx.x; g < spans; g += gridDim.x) {
    const long long base = g * kSpan;
    if (g != blockIdx.x) stage_span(g);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // the span (and, the first time, the tables) landed

    uint32_t crc = 0;
    if (base + (long long)tid * kChunk < n) {  // a chunk wholly past the end is 0
      const uint8_t* row = stage + tid * kRow;
#pragma unroll 4
      for (int k = 0; k < kChunk; k += 16)
        crc = step16(tab, crc, *reinterpret_cast<const uint4*>(row + k));
    }
    crc = tree_forward(crc, c, 0, 5);
    if (lane == 0) warp_part[warp] = crc;
    __syncthreads();  // warp values written; the span is read
    if (warp == 0) {
      uint32_t v = lane < kWarps ? warp_part[lane] : 0u;
      v = tree_forward(v, c, 5, kLogThreads - 5);
      if (lane == 0) partials[g] = v;
    }
  }

  // The last CTA to finish combines the partials.
  if (tid == 0) {
    __threadfence();  // this CTA's partials before its ticket
    is_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // thread i holds the spans e = i * R ... i * R + R - 1 counted from the end
  // (R = 2^log_per_thread), combined backwards from the earliest
  const long long per = 1ll << log_per_thread;
  uint32_t v = 0;
  for (long long k0 = per - 1; k0 >= 0; k0 -= 8) {  // 8 loads in flight at once
    uint32_t x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long e = tid * per + k0 - j;
      x[j] = k0 - j >= 0 && e < spans ? __ldcg(partials + (spans - 1 - e)) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (k0 - j >= 0) v = mul_basis(c.shift[kLogThreads], v) ^ x[j];  // one span
  }
  const int first = kLogThreads + log_per_thread;
  v = tree_backward(v, c, first, 5);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_part[lane] : 0u;
    v = tree_backward(v, c, first + 5, kLogThreads - 5);
    if (lane == 0) out[0] = mul_basis(c.unshift, v) ^ c.fin_xor;
  }
}

uint32_t pow_modp(uint32_t a, unsigned long long e) {
  uint32_t p = 0x80000000u;  // x^0
  while (e) {
    if (e & 1) p = multmodp(a, p);
    a = multmodp(a, a);
    e >>= 1;
  }
  return p;
}

// m[k] = a * x^k mod P, the basis mul_basis takes.
void basis(uint32_t a, uint32_t (&m)[32]) {
  for (int k = 0; k < 32; ++k) m[k] = multmodp(a, 1u << k);
}

// Raises the kernel's dynamic shared memory cap once per device, under one
// lock, to its one size; never set to another value.
cudaError_t ready_launch(const void* kernel) {
  static std::mutex mu;
  static std::set<int> raised;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  if (raised.count(dev)) return cudaSuccess;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kShared);
  if (rc == cudaSuccess) raised.insert(dev);
  return rc;
}

}  // namespace

extern "C" {

// data: n >= 1 bytes, 16-byte aligned; partials: ceil(n / span_bytes) u32
// of scratch; ticket: one u32 that is 0 before the first launch on a stream
// and that every launch leaves at 0 (launches that share it must not run at
// once: one per CUDA stream); out: one u32, written. Returns the launch's
// cudaError_t (0 on success).
int fq_crc32_chunks(const void* data, long long n, void* partials, void* ticket,
                    void* out, void* stream) {
  if (n <= 0 || n > (1ll << 50)) return (int)cudaErrorInvalidValue;
  static const Consts fixed = [] {
    Consts k{};
    uint32_t q = pow_modp(0x00800000u, kChunk);  // x^(8 kChunk)
    for (int l = 0; l < kLevels; ++l, q = multmodp(q, q)) basis(q, k.shift[l]);
    return k;
  }();
  const long long spans = (n + kSpan - 1) / kSpan;
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  const long long grid = spans < (long long)sms * kCtasPerSm ? spans : (long long)sms * kCtasPerSm;
  int log_per_thread = 0;
  while ((long long)kThreads << log_per_thread < spans) ++log_per_thread;
  if (kLogThreads + log_per_thread + kLogThreads > kLevels)
    return (int)cudaErrorInvalidValue;
  Consts c = fixed;
  // x^-1 = (P(x) - 1) / x: reflected, the polynomial shifted up by one
  const uint32_t xinv = (kPoly << 1) | 1u;
  basis(pow_modp(xinv, 8ull * (unsigned long long)(spans * kSpan - n)), c.unshift);
  c.fin_xor = multmodp(pow_modp(0x00800000u, (unsigned long long)n), 0xFFFFFFFFu) ^
              0xFFFFFFFFu;
  rc = ready_launch((const void*)crc32_kernel);
  if (rc != cudaSuccess) return (int)rc;
  crc32_kernel<<<(unsigned)grid, kThreads, kShared, (cudaStream_t)stream>>>(
      (const uint8_t*)data, n, spans, log_per_thread, (uint32_t*)partials,
      (unsigned*)ticket, (uint32_t*)out, c);
  return (int)cudaGetLastError();
}

// Bytes of one span (the partials the wrapper allocates: one per span).
int fq_crc32_span_bytes(void) { return kSpan; }

}  // extern "C"
