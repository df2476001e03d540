// Chunk-parallel CRC32 (IEEE 802.3, reflected polynomial 0xEDB88320, the
// value zlib.crc32 gives) on Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// fq_crc32_chunks replaces the XLA program _crc_lanes_kernel
// (fastqpacker_tpu/ops/crc32.py:87) and the host-side GF(2) combine loop
// around it (crc32_device, ops/crc32.py:116-160).
//
// A CRC is serial per byte, so the stream is cut into contiguous chunks of
// `chunk` bytes (the last may be short) and every thread computes one
// chunk's CRC with a 256-entry table in shared memory. The chunk CRCs are
// joined on the device: the CRC of A||B is shift(crc(A), len(B)) ^ crc(B),
// where shift multiplies by x^(8*len(B)) modulo the CRC polynomial, so the
// stream's CRC is the XOR over chunks of shift(crc_i, bytes after chunk i).
// Each thread shifts its own CRC (square-and-multiply, at most 2 x 40
// carry-less 32-step products), a warp XOR-reduces by shuffles, and one
// atomicXor per warp lands the result in `out` (which the caller zeroes).
//
// Bound by bytes in principle (each byte read once, 4 bytes written), but as
// written by the dependent table lookups of one chunk: chunk x (shared-memory
// latency). The TPU formulation (bitwise 8-step update, (K, N) transposed
// layout, masked lanes, host Python combine) is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kPoly = 0xEDB88320u;
constexpr int kThreads = 128;

// a(x) * b(x) mod P(x) in the reflected representation (bit 31 is x^0).
__device__ __forceinline__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll 8
  for (int i = 0; i < 32; ++i) {
    if (a & (0x80000000u >> i)) p ^= b;
    b = (b >> 1) ^ ((b & 1u) ? kPoly : 0u);
  }
  return p;
}

// x^(8 * nbytes) mod P(x).
__device__ __forceinline__ uint32_t x8n_modp(long long nbytes) {
  uint32_t p = 0x80000000u;  // x^0
  uint32_t q = 0x00800000u;  // x^8
  while (nbytes) {
    if (nbytes & 1) p = multmodp(q, p);
    q = multmodp(q, q);
    nbytes >>= 1;
  }
  return p;
}

__device__ __forceinline__ uint32_t crc_word(const uint32_t* table,
                                             uint32_t crc, uint32_t w) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    crc = table[(crc ^ (w >> (8 * k))) & 0xFFu] ^ (crc >> 8);
  }
  return crc;
}

__global__ void __launch_bounds__(kThreads)
crc32_chunks_kernel(const uint8_t* __restrict__ data, long long n, int chunk,
                    long long nchunks, uint32_t* __restrict__ out) {
  __shared__ uint32_t table[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    uint32_t c = (uint32_t)i;
#pragma unroll
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1u) ? kPoly : 0u);
    table[i] = c;
  }
  __syncthreads();

  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  uint32_t part = 0;
  if (i < nchunks) {
    const long long start = i * chunk;
    const long long rest = n - start;
    const int len = rest < chunk ? (int)rest : chunk;
    const uint8_t* p = data + start;
    uint32_t crc = 0xFFFFFFFFu;
    int k = 0;
    // chunk is a multiple of 16 and data is 16-byte aligned, so every
    // chunk starts aligned
    for (; k + 16 <= len; k += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + k);
      crc = crc_word(table, crc, v.x);
      crc = crc_word(table, crc, v.y);
      crc = crc_word(table, crc, v.z);
      crc = crc_word(table, crc, v.w);
    }
    for (; k < len; ++k) crc = table[(crc ^ p[k]) & 0xFFu] ^ (crc >> 8);
    crc ^= 0xFFFFFFFFu;
    const long long after = rest - len;
    part = after ? multmodp(x8n_modp(after), crc) : crc;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part ^= __shfl_xor_sync(kFullMask, part, off);
  if ((threadIdx.x & 31) == 0 && part) atomicXor(out, part);
}

}  // namespace

extern "C" {

// data: n >= 1 bytes, 16-byte aligned; chunk: a positive multiple of 16;
// out: one u32 that the caller has set to 0. Returns the launch's
// cudaError_t (0 on success).
int fq_crc32_chunks(const void* data, long long n, int chunk, void* out,
                    void* stream) {
  if (n <= 0 || chunk <= 0 || chunk % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long nchunks = (n + chunk - 1) / chunk;
  const long long grid = (nchunks + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  crc32_chunks_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, n, chunk, nchunks, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
