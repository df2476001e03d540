// Dense FQZ block codec on Hopper (sm_90a): the per-block encode and decode
// of the fqz-v2-zstd path, with a plain C interface for ctypes.
//
// fq_dense_encode replaces the TPU kernel _encode_tile_kernel
// (fastqpacker_tpu/ops/pallas_kernels.py:41, pallas_call at :112) and its
// XLA twin encode_arrays_jit (fastqpacker_tpu/ops/device.py:84).
// fq_dense_decode replaces _decode_tile_kernel (pallas_kernels.py:186,
// pallas_call at :239) and decode_arrays_jit (ops/device.py:140).
//
// Both are bound by device-memory bytes: a few integer operations per byte
// against 3.35 TB/s. Encode reads 2*R*L bytes (seq, qual) and writes
// 1.375*R*L (packed R*L/4, N mask R*L/8, quality deltas R*L); decode reads
// 1.25*R*L (packed, deltas) and writes 2*R*L (ASCII bases, qualities).
// The design answers that by touching every byte once: one warp per record
// row, 16-byte coalesced loads and stores per thread, and no intermediate
// in device memory. The per-row sequential dependency (the quality delta's
// previous byte, the decode's running sum) is carried in registers with warp
// shuffles across a row's 16-byte chunks. The TPU kernel's u32-lane
// packing, lane rolls, Hillis-Steele roll ladder and host nibble pairing
// are not needed here.
//
// Layout: row-major (rows, width) uint8 with width a multiple of 16 (the
// wrapper pads), so packed rows are width/4 bytes and mask rows width/8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;  // one record row per warp
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxTracked = 65536;  // u16 N positions (sequence.go:11)
constexpr uint32_t kAcgt = 0x54474341u;  // "ACGT", little-endian

// Four bytes holding 2-bit codes -> one packed byte, LSB-first.
__device__ __forceinline__ uint32_t pack_codes(uint32_t w) {
  return (w & 0x3u) | ((w >> 6) & 0xCu) | ((w >> 12) & 0x30u) |
         ((w >> 18) & 0xC0u);
}

// Bytes of 0x00/0xFF -> 4-bit mask, bit k set where byte k is 0xFF.
__device__ __forceinline__ uint32_t byte_flags(uint32_t v) {
  return ((v >> 7) & 1u) | ((v >> 14) & 2u) | ((v >> 21) & 4u) |
         ((v >> 28) & 8u);
}

// Case-insensitive ACGT -> codes 0-3 (every other byte -> 0), and a
// per-byte 0xFF flag where the byte is not ACGT.
__device__ __forceinline__ void classify(uint32_t w, uint32_t& code,
                                         uint32_t& invalid) {
  const uint32_t u = w & 0xDFDFDFDFu;
  const uint32_t a = __vcmpeq4(u, 0x41414141u);
  const uint32_t c = __vcmpeq4(u, 0x43434343u);
  const uint32_t g = __vcmpeq4(u, 0x47474747u);
  const uint32_t t = __vcmpeq4(u, 0x54545454u);
  code = (c & 0x01010101u) | (g & 0x02020202u) | (t & 0x03030303u);
  invalid = ~(a | c | g | t);
}

// One packed byte (4 codes) -> 4 ASCII bases.
__device__ __forceinline__ uint32_t codes_to_ascii(uint32_t b) {
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t code = (b >> (2 * k)) & 3u;
    out |= ((kAcgt >> (8 * code)) & 0xFFu) << (8 * k);
  }
  return out;
}

// Byte-wise inclusive prefix sum of a word's 4 bytes, mod 256 per byte.
__device__ __forceinline__ uint32_t byte_prefix(uint32_t x) {
  x = __vadd4(x, x << 8);
  return __vadd4(x, x << 16);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dense_encode_kernel(const uint8_t* __restrict__ seq,
                    const uint8_t* __restrict__ qual,
                    const int32_t* __restrict__ lengths,
                    uint8_t* __restrict__ packed,
                    uint8_t* __restrict__ nmask,
                    int32_t* __restrict__ n_counts,
                    uint8_t* __restrict__ qual_delta, int rows, int width,
                    int qual_offset) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together

  const int chunks = width >> 4;
  const size_t base = (size_t)row * width;
  const uint4* seq_row = reinterpret_cast<const uint4*>(seq + base);
  const uint4* qual_row = reinterpret_cast<const uint4*>(qual + base);
  uint4* delta_row = reinterpret_cast<uint4*>(qual_delta + base);
  uint32_t* packed_row =
      reinterpret_cast<uint32_t*>(packed + (size_t)row * (width >> 2));
  uint16_t* mask_row =
      reinterpret_cast<uint16_t*>(nmask + (size_t)row * (width >> 3));
  const int tracked = min(lengths[row], kMaxTracked);

  // Position 0's "previous" byte is the offset, so its delta is q - offset.
  uint32_t carry = (uint32_t)qual_offset & 0xFFu;
  int count = 0;
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < chunks;
    uint4 s = make_uint4(0, 0, 0, 0);
    uint4 q = make_uint4(0, 0, 0, 0);
    if (active) {
      s = seq_row[c];
      q = qual_row[c];
    }
    // previous quality byte of this chunk: the last byte of the chunk one
    // lane down, or of the previous iteration's last chunk for lane 0
    const uint32_t up = __shfl_up_sync(kFullMask, q.w >> 24, 1);
    const uint32_t prev = lane == 0 ? carry : up;
    carry = __shfl_sync(kFullMask, q.w >> 24, 31);
    if (active) {
      uint4 d;
      d.x = __vsub4(q.x, (q.x << 8) | prev);
      d.y = __vsub4(q.y, (q.y << 8) | (q.x >> 24));
      d.z = __vsub4(q.z, (q.z << 8) | (q.y >> 24));
      d.w = __vsub4(q.w, (q.w << 8) | (q.z >> 24));
      delta_row[c] = d;

      uint32_t cx, cy, cz, cw, ix, iy, iz, iw;
      classify(s.x, cx, ix);
      classify(s.y, cy, iy);
      classify(s.z, cz, iz);
      classify(s.w, cw, iw);
      packed_row[c] = pack_codes(cx) | (pack_codes(cy) << 8) |
                      (pack_codes(cz) << 16) | (pack_codes(cw) << 24);
      uint32_t m = byte_flags(ix) | (byte_flags(iy) << 4) |
                   (byte_flags(iz) << 8) | (byte_flags(iw) << 12);
      const int lim = tracked - c * 16;  // positions < min(len, cap) count
      if (lim <= 0) {
        m = 0;
      } else if (lim < 16) {
        m &= (1u << lim) - 1u;
      }
      mask_row[c] = (uint16_t)m;
      count += __popc(m);
    }
  }
  count = __reduce_add_sync(kFullMask, count);
  if (lane == 0) n_counts[row] = count;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dense_decode_kernel(const uint8_t* __restrict__ packed,
                    const uint8_t* __restrict__ qual_delta,
                    uint8_t* __restrict__ seq, uint8_t* __restrict__ qual,
                    int rows, int width, int qual_offset) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;

  const int chunks = width >> 4;
  const size_t base = (size_t)row * width;
  const uint32_t* packed_row =
      reinterpret_cast<const uint32_t*>(packed + (size_t)row * (width >> 2));
  const uint4* delta_row = reinterpret_cast<const uint4*>(qual_delta + base);
  uint4* seq_row = reinterpret_cast<uint4*>(seq + base);
  uint4* qual_row = reinterpret_cast<uint4*>(qual + base);

  // running sum of every earlier chunk's deltas, plus the offset (mod 256)
  uint32_t carry = (uint32_t)qual_offset;
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < chunks;
    uint4 d = make_uint4(0, 0, 0, 0);
    uint32_t p = 0;
    if (active) {
      d = delta_row[c];
      p = packed_row[c];
    }
    // inclusive prefix of the chunk's 16 bytes, byte-wise mod 256
    const uint32_t x = byte_prefix(d.x);
    const uint32_t y = __vadd4(byte_prefix(d.y), (x >> 24) * 0x01010101u);
    const uint32_t z = __vadd4(byte_prefix(d.z), (y >> 24) * 0x01010101u);
    const uint32_t w = __vadd4(byte_prefix(d.w), (z >> 24) * 0x01010101u);
    const uint32_t total = w >> 24;
    // warp inclusive scan of the chunk totals
    uint32_t incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t v = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += v;
    }
    const uint32_t add = ((carry + incl - total) & 0xFFu) * 0x01010101u;
    carry += __shfl_sync(kFullMask, incl, 31);
    if (active) {
      qual_row[c] = make_uint4(__vadd4(x, add), __vadd4(y, add),
                               __vadd4(z, add), __vadd4(w, add));
      seq_row[c] = make_uint4(codes_to_ascii(p & 0xFFu),
                              codes_to_ascii((p >> 8) & 0xFFu),
                              codes_to_ascii((p >> 16) & 0xFFu),
                              codes_to_ascii(p >> 24));
    }
  }
}

inline unsigned grid_for(int rows) {
  return (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// Returns the launch's cudaError_t (0 on success). Launches nothing for
// rows <= 0; refuses a width that is not a multiple of 16.
int fq_dense_encode(const void* seq, const void* qual, const void* lengths,
                    void* packed, void* nmask, void* n_counts,
                    void* qual_delta, int rows, int width, int qual_offset,
                    void* stream) {
  if (width < 0 || width % 16 != 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  dense_encode_kernel<<<grid_for(rows), kWarpsPerBlock * 32, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)seq, (const uint8_t*)qual, (const int32_t*)lengths,
      (uint8_t*)packed, (uint8_t*)nmask, (int32_t*)n_counts,
      (uint8_t*)qual_delta, rows, width, qual_offset);
  return (int)cudaGetLastError();
}

int fq_dense_decode(const void* packed, const void* qual_delta, void* seq,
                    void* qual, int rows, int width, int qual_offset,
                    void* stream) {
  if (width < 0 || width % 16 != 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  dense_decode_kernel<<<grid_for(rows), kWarpsPerBlock * 32, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const uint8_t*)qual_delta, (uint8_t*)seq,
      (uint8_t*)qual, rows, width, qual_offset);
  return (int)cudaGetLastError();
}

}  // extern "C"
