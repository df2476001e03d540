// The C++ runtime's block stages on Hopper (sm_90a), with a plain C
// interface for ctypes: record scan, row gather, v1/v2 stream build and
// FASTQ assembly.
//
// They replace the host functions of fastqpacker_tpu/runtime/fqruntime.cpp
// that the JAX package's device paths run around their device programs:
// - fq_records_scan:   :206 fq_scan_records_ex (+ its qmin_io);
// - fq_rows_gather:    :527 fq_gather_rows;
// - fq_streams_build:  :980 fq_build_streams, :565 fq_build_len16,
//                      :602 fq_build_npos (and :836 fq_build_npos32);
// - fq_fastq_assemble: :1153 fq_decode_block_full, :663 fq_assemble,
//                      :581 fq_parse_len16, :633 / :863 fq_parse_npos(32).
// The plain PyTorch versions are fastqpacker_tpu_torch/ops/records.py; each
// entry here computes the same values by the same algorithm.
//
// What bounds them. Each moves every byte of its inputs and outputs once or
// twice and computes almost nothing per byte, so bytes bound all four (a
// block's text is 12.8-34 MB). The runtime walks a block record by record on
// one thread; the chains that make that walk sequential are resolved here in
// parallel:
// - the record scan counts newlines per 32 KiB tile (16-byte loads, a SIMD
//   byte compare), scans the tile counts in one CTA, writes each newline's
//   position at its global line index, then lets warps stride over the
//   records for their line bounds, checks, quality minima and ambiguous
//   bases, with the block's sums gathered per CTA; the first bad line wins by
//   an atomic minimum of its index;
// - the gathers and the stream build give one warp to each row or record,
//   at offsets from exclusive scans over the records (one CTA of 1,024
//   threads per scanned field);
// - the length-prefixed chains of the decoder (s_(i+1) = s_i + 2 + len(s_i)
//   over the header and plus payloads, s_(i+1) = s_i + 1 + count(s_i) over
//   the N positions) are resolved by pointer doubling: the successor of every
//   position, squared log2(R) times, while each record applies the squares
//   its index has bits for; one launch a round serves all three chains. A
//   step that leaves the stream lands on an absorbing node, so truncation is
//   one comparison of s_R. A stream whose records all have the same length
//   (the usual fixed-width header) is recognised first by one check per
//   record, and then the rounds return at once.
// A launch does not synchronise and allocates nothing: each entry takes a
// scratch buffer whose size a *_scratch query gives.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;             // threads per CTA (8 warps)
constexpr int kWarps = kThreads / 32;
constexpr long long kTile = 32768;        // text bytes per CTA of the newline passes
constexpr int kScanThreads = 1024;        // threads of the one-CTA prefix scans
constexpr int kScanVals = 8;              // values per thread per tile of a prefix scan
constexpr long long kNone = 0x7fffffffffffffffLL;
constexpr long long kV2NposLimit = 1LL << 16;
constexpr int kEmptyQmin = 256;

// fq_records_scan's info slots (ops/records.py SCAN_*)
enum {
  kCount = 0, kConsumed, kError, kErrorLine, kLines, kSeqSum, kSeqMax,
  kPackedSum, kHdrSum, kHdrMax, kPlusSum, kPlusMax, kAmbig, kOverflowRow,
  kInfoSlots = 16
};
// fq_fastq_assemble's fault bits (ops/records.py ASSEMBLE_FAULTS)
enum {
  kFaultLen = 1, kFaultSeq = 2, kFaultQual = 4, kFaultNposTrunc = 8,
  kFaultNposInvalid = 16, kFaultHdr = 32, kFaultPlus = 64
};

inline long long align256(long long b) { return (b + 255) & ~255LL; }

__device__ inline long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ inline int warp_min(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ inline long long warp_min_ll(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Inclusive prefix of v over the 32 lanes of a warp.
__device__ inline long long warp_incl(long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Exclusive prefix of v over the CTA (blockDim.x a multiple of 32, at most
// 1,024 threads); *total gets the CTA's sum. sh: 33 shared slots. Every
// thread must call it.
__device__ long long block_excl(long long v, long long* total, long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const long long incl = warp_incl(v);
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long w = lane < nw ? sh[lane] : 0;
    const long long wi = warp_incl(w);
    if (lane < nw) sh[lane] = wi - w;
    if (lane == 31) sh[32] = wi;
  }
  __syncthreads();
  const long long res = sh[warp] + incl - v;
  *total = sh[32];
  __syncthreads();  // sh is reused by the next call
  return res;
}

// Exclusive prefix sums of F fields of r values, one CTA per field: field f
// is a[f * (r + 1) + 0 .. r), its sum is written at a[f * (r + 1) + r].
__global__ void __launch_bounds__(kScanThreads) scan_fields_kernel(long long* a, long long r) {
  __shared__ long long sh[33];
  long long* base = a + (long long)blockIdx.x * (r + 1);
  long long carry = 0;
  constexpr long long kStep = (long long)kScanThreads * kScanVals;
  for (long long tile = 0; tile < r; tile += kStep) {
    long long v[kScanVals];
    long long s = 0;
    const long long lo = tile + (long long)threadIdx.x * kScanVals;
#pragma unroll
    for (int k = 0; k < kScanVals; ++k) {
      v[k] = lo + k < r ? base[lo + k] : 0;
      s += v[k];
    }
    long long total;
    long long run = carry + block_excl(s, &total, sh);
#pragma unroll
    for (int k = 0; k < kScanVals; ++k) {
      if (lo + k < r) base[lo + k] = run;
      run += v[k];
    }
    carry += total;
  }
  if (threadIdx.x == 0) base[r] = carry;
}

inline cudaError_t scan_fields(long long* a, int fields, long long r, cudaStream_t s) {
  scan_fields_kernel<<<fields, kScanThreads, 0, s>>>(a, r);
  return cudaGetLastError();
}

inline unsigned grid_for(long long items, int per_cta) {
  const long long g = (items + per_cta - 1) / per_cta;
  return (unsigned)(g < 1 ? 1 : g);
}

// ---------------------------------------------------------------------------
// 1. record scan
// ---------------------------------------------------------------------------

__device__ inline int newlines16(const uint4& q) {
  const unsigned nl = 0x0a0a0a0au;
  return (__popc(__vcmpeq4(q.x, nl)) + __popc(__vcmpeq4(q.y, nl)) +
          __popc(__vcmpeq4(q.z, nl)) + __popc(__vcmpeq4(q.w, nl))) >> 3;
}

// Newlines of each kTile-byte tile of the text: counts[t]. The text is
// 16-byte aligned, so every 16-byte unit of a tile is too.
__global__ void __launch_bounds__(kThreads) count_newlines_kernel(
    const uint8_t* __restrict__ text, long long n, long long* __restrict__ counts) {
  __shared__ long long sh[33];
  const long long lo = (long long)blockIdx.x * kTile;
  const long long hi = min(lo + kTile, n);
  long long c = 0;
  for (long long i = lo + 16LL * threadIdx.x; i < hi; i += 16LL * kThreads) {
    if (i + 16 <= hi) {
      c += newlines16(*reinterpret_cast<const uint4*>(text + i));
    } else {
      for (long long j = i; j < hi; ++j) c += text[j] == '\n';
    }
  }
  long long total;
  block_excl(c, &total, sh);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// Positions of the newlines, at their line index (tile prefix + rank in
// the tile), for the first `cap` lines.
__global__ void __launch_bounds__(kThreads) write_newlines_kernel(
    const uint8_t* __restrict__ text, long long n, const long long* __restrict__ prefix,
    long long* __restrict__ nl, long long cap) {
  __shared__ long long sh[33];
  const long long lo = (long long)blockIdx.x * kTile;
  const long long hi = min(lo + kTile, n);
  long long carry = prefix[blockIdx.x];
  if (carry >= cap) return;  // uniform over the CTA
  for (long long chunk = lo; chunk < hi; chunk += 16LL * kThreads) {
    const long long i = chunk + 16LL * threadIdx.x;
    uint8_t b[16];
    int c = 0;
    if (i + 16 <= hi) {
      const uint4 q = *reinterpret_cast<const uint4*>(text + i);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 16; ++k) b[k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) b[k] = i + k < hi ? text[i + k] : 0;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) c += b[k] == '\n';
    long long total;
    long long at = carry + block_excl(c, &total, sh);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (b[k] == '\n') {
        if (at < cap) nl[at] = i + k;
        ++at;
      }
    }
    carry += total;
  }
}

__global__ void init_scan_kernel(long long* info) {
  const int t = threadIdx.x;
  if (t < kInfoSlots) info[t] = (t == kErrorLine || t == kOverflowRow) ? kNone : 0;
}

__device__ inline bool ambiguous(uint8_t b) {
  const uint8_t u = b & 0xDF;
  return !(u == 'A' || u == 'C' || u == 'G' || u == 'T');
}

// Warps stride over the records: line bounds, checks, offsets, quality
// minimum, ambiguous bases; the block's sums are gathered per CTA in shared
// memory and added to info once per CTA (one global atomic per CTA and sum,
// not one per record: same-address atomics from every record serialise).
__global__ void __launch_bounds__(kThreads) records_kernel(
    const uint8_t* __restrict__ text, const long long* __restrict__ nl,
    const long long* __restrict__ total_lines, long long cap, long long max_records,
    long long* __restrict__ offsets, int16_t* __restrict__ qmin, long long* info) {
  __shared__ long long sums[8];  // seq, packed, hdr, plus, ambiguous; maxima: seq, hdr, plus
  __shared__ long long first_bad, first_far;
  if (threadIdx.x < 8) sums[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    first_bad = kNone;
    first_far = kNone;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long lines = min(*total_lines, cap);
  const long long nrec = min(max_records, (lines + 3) / 4);
  const long long warps = (long long)gridDim.x * kWarps;
  long long seq = 0, packed = 0, hdr = 0, plus = 0, ambig = 0, seq_max = 0, hdr_max = 0,
            plus_max = 0, bad_line = kNone, far_row = kNone;
  for (long long rec = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5; rec < nrec;
       rec += warps) {
    const int have = (int)min(4LL, lines - rec * 4);
    long long start[4] = {0, 0, 0, 0}, len[4] = {0, 0, 0, 0};
    for (int li = 0; li < have; ++li) {
      const long long line = rec * 4 + li;
      const long long end = nl[line];
      const long long st = line ? nl[line - 1] + 1 : 0;
      long long l = end - st;
      if (l > 0 && text[end - 1] == '\r') --l;
      start[li] = st;
      len[li] = l;
    }
    if (lane == 0) {
      long long bad = kNone;
      if (len[0] == 0 || text[start[0]] != '@') bad = rec * 4;
      else if (have > 2 && (len[2] == 0 || text[start[2]] != '+')) bad = rec * 4 + 2;
      else if (have == 4 && len[1] != len[3]) bad = rec * 4 + 3;
      bad_line = min(bad_line, bad);
    }
    if (have < 4) continue;
    if (lane < 8) {
      const int f = lane >> 1;
      const long long strip = (f == 0 || f == 2) ? 1 : 0;
      offsets[rec * 8 + lane] = (lane & 1) ? len[f] - strip : start[f] + strip;
    }
    // quality minimum
    int m = kEmptyQmin;
    for (long long j = lane; j < len[3]; j += 32) m = min(m, (int)text[start[3] + j]);
    m = warp_min(m);
    // ambiguous bases, and the first one past the u16 positions
    long long amb = 0, far = kNone;
    for (long long j = lane; j < len[1]; j += 32) {
      if (ambiguous(text[start[1] + j])) {
        ++amb;
        if (j >= kV2NposLimit) far = min(far, j);
      }
    }
    amb = warp_sum(amb);
    far = warp_min_ll(far);
    if (lane == 0) {
      qmin[rec] = (int16_t)m;
      const long long hl = max(len[0] - 1, 0LL), pl = max(len[2] - 1, 0LL);
      seq += len[1];
      packed += (len[1] + 3) >> 2;
      hdr += hl;
      plus += pl;
      ambig += amb;
      seq_max = max(seq_max, len[1]);
      hdr_max = max(hdr_max, hl);
      plus_max = max(plus_max, pl);
      if (far != kNone) far_row = min(far_row, rec);
    }
  }
  if (lane == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(sums + 0), (unsigned long long)seq);
    atomicAdd(reinterpret_cast<unsigned long long*>(sums + 1), (unsigned long long)packed);
    atomicAdd(reinterpret_cast<unsigned long long*>(sums + 2), (unsigned long long)hdr);
    atomicAdd(reinterpret_cast<unsigned long long*>(sums + 3), (unsigned long long)plus);
    atomicAdd(reinterpret_cast<unsigned long long*>(sums + 4), (unsigned long long)ambig);
    atomicMax(sums + 5, seq_max);
    atomicMax(sums + 6, hdr_max);
    atomicMax(sums + 7, plus_max);
    atomicMin(&first_bad, bad_line);
    atomicMin(&first_far, far_row);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int slot[8] = {kSeqSum, kPackedSum, kHdrSum, kPlusSum, kAmbig, kSeqMax, kHdrMax,
                         kPlusMax};
    for (int k = 0; k < 5; ++k)
      if (sums[k])
        atomicAdd(reinterpret_cast<unsigned long long*>(info + slot[k]),
                  (unsigned long long)sums[k]);
    for (int k = 5; k < 8; ++k)
      if (sums[k]) atomicMax(info + slot[k], sums[k]);
    if (first_bad != kNone) atomicMin(info + kErrorLine, first_bad);
    if (first_far != kNone) atomicMin(info + kOverflowRow, first_far);
  }
}

__global__ void finish_scan_kernel(const long long* __restrict__ nl,
                                   const long long* __restrict__ total_lines, long long cap,
                                   long long* info) {
  const long long lines = min(*total_lines, cap);
  const long long count = lines / 4;
  info[kLines] = lines;
  info[kCount] = count;
  info[kConsumed] = count ? nl[4 * count - 1] + 1 : 0;
  const long long e = info[kErrorLine];
  info[kError] = e == kNone ? 0 : (e % 4 == 0 ? 1 : (e % 4 == 2 ? 2 : 3));
}

inline long long scan_tiles(long long n) { return (n + kTile - 1) / kTile; }

// The records kernel's grid: a warp per record up to a few CTAs per SM,
// beyond that the warps stride.
inline unsigned records_grid(long long max_records) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (max_records + kWarps - 1) / kWarps;
  const long long most = 8LL * sms;
  return (unsigned)(want < 1 ? 1 : (want < most ? want : most));
}

// ---------------------------------------------------------------------------
// 2. row gather
// ---------------------------------------------------------------------------

__global__ void copy_strided_kernel(const long long* __restrict__ src, long long stride,
                                    long long r, long long* __restrict__ dst) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < r) dst[i] = src[i * stride];
}

// One warp per output row.
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const uint8_t* __restrict__ data, long long data_n, const long long* __restrict__ starts,
    long long ss, const long long* __restrict__ lens, long long ls, long long r,
    long long rows, long long width, uint8_t fill, uint8_t* __restrict__ out) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  long long st = 0, l = 0;
  if (row < r) {
    st = starts[row * ss];
    l = min(max(lens[row * ls], 0LL), width);
  }
  uint8_t* dst = out + row * width;
  if ((width & 3) == 0) {
    const uint32_t f4 = 0x01010101u * fill;
    for (long long w = lane; 4 * w < width; w += 32) {
      const long long j = 4 * w;
      uint32_t v = f4;
      if (j < l) {
        v = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const long long src = st + j + k;
          const uint32_t b = (j + k < l && src >= 0 && src < data_n) ? data[src] : fill;
          v |= b << (8 * k);
        }
      }
      *reinterpret_cast<uint32_t*>(dst + j) = v;
    }
  } else {
    for (long long j = lane; j < width; j += 32) {
      const long long src = st + j;
      dst[j] = (j < l && src >= 0 && src < data_n) ? data[src] : fill;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. v1/v2 stream build
// ---------------------------------------------------------------------------

// Per record: packed bytes, quality bytes, u16 + header, u16 + plus, and
// 1 + N count (in npos units), as fields 0-4 of f (stride n + 1).
__global__ void stream_fields_kernel(const long long* __restrict__ offsets,
                                     const int32_t* __restrict__ n_counts, long long n,
                                     long long* __restrict__ f) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long* o = offsets + i * 8;
  const long long s = n + 1;
  f[i] = (o[3] + 3) >> 2;
  f[s + i] = o[3];
  f[2 * s + i] = 2 + o[1];
  f[3 * s + i] = 2 + o[5];
  f[4 * s + i] = 1 + (long long)n_counts[i];
}

__device__ inline void put_le(uint8_t* out, long long at, long long end, unsigned long long v,
                              int unit) {
  for (int k = 0; k < unit; ++k)
    if (at + k < end) out[at + k] = (uint8_t)(v >> (8 * k));
}

struct Regions {
  long long base[6];  // byte offset of each stream in the buffer
  long long end;      // the buffer's size
};

// One warp per record: its bytes of each of the six streams.
__global__ void __launch_bounds__(kThreads) write_streams_kernel(
    const uint8_t* __restrict__ text, const long long* __restrict__ offsets, long long n,
    const uint8_t* __restrict__ packed, long long pp, const uint8_t* __restrict__ qual_delta,
    long long qp, const uint8_t* __restrict__ nmask, long long np,
    const int32_t* __restrict__ n_counts, int unit, const long long* __restrict__ f,
    Regions g, uint8_t* __restrict__ out) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const long long s = n + 1;
  const long long* o = offsets + i * 8;
  const long long len = o[3];
  const long long plen = (len + 3) >> 2;
  // sequence and quality
  {
    const long long at = g.base[0] + f[i];
    for (long long j = lane; j < plen; j += 32)
      if (at + j < g.end) out[at + j] = packed[i * pp + j];
  }
  {
    const long long at = g.base[1] + f[s + i];
    for (long long j = lane; j < len; j += 32)
      if (at + j < g.end) out[at + j] = qual_delta[i * qp + j];
  }
  // headers and plus payloads: u16 length, bytes
  for (int which = 0; which < 2; ++which) {
    const long long src = o[which ? 4 : 0], l = o[which ? 5 : 1];
    const long long at = g.base[which ? 3 : 2] + f[(which ? 3 : 2) * s + i];
    if (lane == 0) put_le(out, at, g.end, (unsigned long long)l, 2);
    for (long long j = lane; j < l; j += 32)
      if (at + 2 + j < g.end) out[at + 2 + j] = text[src + j];
  }
  // N positions: the count, then the set bits of the row's mask in order
  {
    const long long cnt = n_counts[i];
    const long long at = g.base[4] + (long long)unit * f[4 * s + i];
    if (lane == 0) put_le(out, at, g.end, (unsigned long long)cnt, unit);
    if (cnt) {
      const long long nbytes = (len + 7) >> 3;
      long long carry = 0;
      for (long long b0 = 0; b0 < nbytes && carry < cnt; b0 += 32) {
        const long long bi = b0 + lane;
        const unsigned bits = bi < nbytes ? nmask[i * np + bi] : 0u;
        const long long c = __popc(bits);
        const long long incl = warp_incl(c);
        long long rank = carry + incl - c;
        for (unsigned rest = bits; rest; rest &= rest - 1) {
          const long long pos = bi * 8 + (__ffs(rest) - 1);
          if (rank < cnt) put_le(out, at + (long long)unit * (1 + rank), g.end,
                                 (unsigned long long)pos, unit);
          ++rank;
        }
        carry += __shfl_sync(kFull, incl, 31);
      }
    }
  }
  // length: u32
  if (lane == 0) put_le(out, g.base[5] + 4 * i, g.end, (unsigned long long)len, 4);
}

__global__ void finish_streams_kernel(const long long* __restrict__ f, long long n, int unit,
                                      long long* info) {
  const long long s = n + 1;
  info[0] = (long long)unit * f[4 * s + n];
  info[1] = f[n];
}

// ---------------------------------------------------------------------------
// 4. FASTQ assembly
// ---------------------------------------------------------------------------

// A length-prefixed chain: node p (a byte for the u16-prefixed payload
// streams, unit 1 and prefix width w 2; a u16 or u32 unit of the npos
// stream, w 1) holds value(p), the next node is p + w + value(p). Nodes
// run 0 .. n; n + 1 absorbs every step that leaves the stream.
struct Chain {
  const uint8_t* data;
  long long n;      // nodes of the stream
  int unit;         // bytes per node
  int w;            // prefix width in nodes
  long long* ja;    // successor tables, n + 2 each (ping-pong)
  long long* jb;
  long long* cur;   // s_0 .. s_r
  long long* stride;  // s_i = i * stride when every record has one length, else 0
};

__device__ inline long long chain_value(const Chain& c, long long p) {
  if (p < 0 || p + c.w > c.n) return 0;
  if (c.unit == 1) return (long long)c.data[p] | ((long long)c.data[p + 1] << 8);
  const uint8_t* q = c.data + p * c.unit;
  unsigned long long v = 0;
  for (int k = 0; k < c.unit; ++k) v |= (unsigned long long)q[k] << (8 * k);
  return (long long)v;
}

__device__ inline long long chain_next(const Chain& c, long long p) {
  if (p + c.w > c.n) return c.n + 1;
  const long long q = p + c.w + chain_value(c, p);
  return q <= c.n ? q : c.n + 1;
}

__device__ inline long long chain_node(const Chain& c, long long i) {
  const long long st = *c.stride;
  return st ? i * st : c.cur[i];
}

// The three chains of a block (headers, plus payloads, N positions), one
// per blockIdx.y in the kernels below; an inactive chain (no plus stream)
// is skipped, a uniform one is done after its check.
struct Chains {
  Chain c[3];
  long long uniform[3];  // candidate stride from the stream's size, 0 if none
  int active[3];
};

__global__ void chains_init_kernel(Chains cs, long long r) {
  const int y = blockIdx.y;
  if (!cs.active[y]) return;
  const Chain& c = cs.c[y];
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t == 0) *c.stride = cs.uniform[y];
  if (t <= c.n + 1) c.ja[t] = chain_next(c, t);
  if (t <= r) c.cur[t] = 0;
}

// Clears a chain's stride when a record's prefix differs from the uniform
// value.
__global__ void chains_uniform_kernel(Chains cs, long long r) {
  const int y = blockIdx.y;
  const long long stride = cs.uniform[y];
  if (!cs.active[y] || !stride) return;
  const Chain& c = cs.c[y];
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < r;
       i += (long long)gridDim.x * kThreads)
    if (chain_value(c, i * stride) != stride - c.w) *c.stride = 0;
}

// One doubling round k of every chain: records whose index has bit k take
// the 2^k-step table; the table is squared into the other buffer (ja at
// even rounds, jb at odd ones).
__global__ void chains_level_kernel(Chains cs, long long r, int k) {
  const int y = blockIdx.y;
  if (!cs.active[y]) return;
  const Chain& c = cs.c[y];
  if (*c.stride) return;
  const long long* src = (k & 1) ? c.jb : c.ja;
  long long* dst = (k & 1) ? c.ja : c.jb;
  const long long items = c.n + 2 > r + 1 ? c.n + 2 : r + 1;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < items;
       t += (long long)gridDim.x * kThreads) {
    if (t <= c.n + 1) dst[t] = src[src[t]];
    if (t <= r && ((t >> k) & 1)) c.cur[t] = src[c.cur[t]];
  }
}

inline long long uniform_stride(long long n, int w, long long r, long long vmax) {
  if (r <= 0 || n < (long long)w * r || (n - (long long)w * r) % r) return 0;
  const long long u = (n - (long long)w * r) / r;
  return u <= vmax ? u + w : 0;
}

inline int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Resolve the active chains: s_0 .. s_r of each in cur (or its stride).
cudaError_t resolve_chains(Chains& cs, long long r, const long long* vmax, cudaStream_t s) {
  long long items = r + 1;
  for (int y = 0; y < 3; ++y) {
    cs.uniform[y] = cs.active[y] ? uniform_stride(cs.c[y].n, cs.c[y].w, r, vmax[y]) : 0;
    if (cs.active[y] && cs.c[y].n + 2 > items) items = cs.c[y].n + 2;
  }
  chains_init_kernel<<<dim3(grid_for(items, kThreads), 3), kThreads, 0, s>>>(cs, r);
  const long long most = 4LL * sm_count();
  const long long want = (items + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(want < most ? want : most);
  chains_uniform_kernel<<<dim3(grid, 3), kThreads, 0, s>>>(cs, r);
  int k = 0;
  for (; (r >> k) > 0; ++k)
    chains_level_kernel<<<dim3(grid, 3), kThreads, 0, s>>>(cs, r, k);
  // the last round squared into the other buffer; s_i is in cur either way
  return cudaGetLastError();
}

// Per record: its text bytes, packed bytes and length, fields 0-2 of f
// (stride r + 1).
__global__ void assemble_fields_kernel(Chain h, Chain p, int has_plus,
                                       const long long* __restrict__ lengths, long long r,
                                       long long* __restrict__ f) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= r) return;
  const long long hl = chain_value(h, chain_node(h, i));
  const long long pl = has_plus ? chain_value(p, chain_node(p, i)) : 0;
  const long long len = lengths[i];
  f[i] = 6 + hl + pl + 2 * len;
  f[(r + 1) + i] = (len + 3) >> 2;
  f[2 * (r + 1) + i] = len;
}

__global__ void assemble_flags_kernel(Chain h, Chain p, int has_plus, Chain np, int odd_npos,
                                      const long long* __restrict__ f, long long r,
                                      long long len_n, long long seq_n, long long qual_n,
                                      long long* info) {
  const long long s = r + 1;
  long long flags = 0;
  if (len_n < 4 * r) flags |= kFaultLen;
  if (f[s + r] > seq_n) flags |= kFaultSeq;
  if (f[2 * s + r] > qual_n) flags |= kFaultQual;
  if (odd_npos || chain_node(np, r) == np.n + 1) flags |= kFaultNposTrunc;
  if (chain_node(h, r) == h.n + 1) flags |= kFaultHdr;
  if (has_plus && chain_node(p, r) == p.n + 1) flags |= kFaultPlus;
  info[0] = f[r];
  info[1] = flags;
}

// One warp per record: '@' header '\n' bases '\n' '+' plus '\n' qualities
// '\n', then 'N' at each of its recorded positions. Nothing is written when
// a stream is truncated (the text is not used then).
__global__ void __launch_bounds__(kThreads) assemble_write_kernel(
    const uint8_t* __restrict__ seq_rows, const uint8_t* __restrict__ qual_rows, long long pitch,
    const long long* __restrict__ lengths, long long r, Chain h, Chain p, int has_plus, Chain np,
    const long long* __restrict__ f, uint8_t* __restrict__ out, long long cap, long long* info) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= r) return;
  if (info[1] & ~(long long)kFaultNposInvalid) return;
  const long long o = f[i];
  const long long hs = chain_node(h, i), hl = chain_value(h, hs);
  const long long ps = has_plus ? chain_node(p, i) : 0;
  const long long pl = has_plus ? chain_value(p, ps) : 0;
  const long long len = lengths[i];
  const long long seq_at = o + 2 + hl;
  const long long plus_at = seq_at + len + 1;
  const long long qual_at = plus_at + pl + 2;
  if (qual_at + len + 1 > cap) return;
  if (lane == 0) {
    out[o] = '@';
    out[seq_at - 1] = '\n';
    out[plus_at - 1] = '\n';
    out[plus_at] = '+';
    out[qual_at - 1] = '\n';
    out[qual_at + len] = '\n';
  }
  for (long long j = lane; j < hl; j += 32) out[o + 1 + j] = h.data[hs + 2 + j];
  for (long long j = lane; j < pl; j += 32) out[plus_at + 1 + j] = p.data[ps + 2 + j];
  const uint8_t* sr = seq_rows + i * pitch;
  const uint8_t* qr = qual_rows + i * pitch;
  for (long long j = lane; j < len; j += 32) {
    out[seq_at + j] = sr[j];
    out[qual_at + j] = qr[j];
  }
  __syncwarp();
  const long long ns = chain_node(np, i);
  const long long cnt = chain_value(np, ns);
  bool bad = false;
  for (long long k = lane; k < cnt; k += 32) {
    const long long pos = chain_value(np, ns + 1 + k);
    if (pos >= len) bad = true;
    else out[seq_at + pos] = 'N';
  }
  if (__any_sync(kFull, bad) && lane == 0)
    atomicOr(reinterpret_cast<unsigned long long*>(info + 1), (unsigned long long)kFaultNposInvalid);
}

struct AssembleScratch {
  long long chain_nodes[3];
  long long bytes;
};

inline AssembleScratch assemble_layout(long long r, long long hdr_n, long long plus_n,
                                       long long npos_units) {
  AssembleScratch a;
  a.chain_nodes[0] = hdr_n;
  a.chain_nodes[1] = plus_n;
  a.chain_nodes[2] = npos_units;
  long long b = 0;
  for (int c = 0; c < 3; ++c)
    b += align256(8 * (a.chain_nodes[c] + 2)) * 2 + align256(8 * (r + 1)) + 256;
  b += align256(8 * 3 * (r + 1));
  a.bytes = b;
  return a;
}

}  // namespace

extern "C" {

// Bytes of scratch fq_records_scan needs for n bytes of text and
// max_records records.
int fq_records_scan_scratch(long long n, long long max_records, long long* out) {
  if (n < 0 || max_records < 0) return (int)cudaErrorInvalidValue;
  *out = align256(8 * (scan_tiles(n) + 1)) + align256(8 * (4 * max_records + 1));
  return 0;
}

// text: n bytes, 16-byte aligned. offsets: (max_records, 8) int64; qmin:
// (max_records,) int16; info: 16 int64 (ops/records.py SCAN_*); rows past
// the count are not written.
int fq_records_scan(const void* text, long long n, long long max_records, void* scratch,
                    void* offsets, void* qmin, void* info, void* stream) {
  if (n < 0 || max_records <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* t = (const uint8_t*)text;
  const long long tiles = scan_tiles(n);
  long long* counts = (long long*)scratch;
  long long* nl = (long long*)((char*)scratch + align256(8 * (tiles + 1)));
  const long long cap = 4 * max_records;
  long long* inf = (long long*)info;
  init_scan_kernel<<<1, 32, 0, s>>>(inf);
  if (tiles) count_newlines_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(t, n, counts);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  if (!tiles) {
    cudaMemsetAsync(counts, 0, 8, s);
  } else {
    rc = scan_fields(counts, 1, tiles, s);
    if (rc != cudaSuccess) return (int)rc;
    write_newlines_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(t, n, counts, nl, cap);
  }
  records_kernel<<<records_grid(max_records), kThreads, 0, s>>>(
      t, nl, counts + tiles, cap, max_records, (long long*)offsets, (int16_t*)qmin, inf);
  finish_scan_kernel<<<1, 1, 0, s>>>(nl, counts + tiles, cap, inf);
  return (int)cudaGetLastError();
}

// Bytes of scratch fq_rows_gather needs for r rows (used only when starts
// is null).
int fq_rows_gather_scratch(long long r, long long* out) {
  if (r < 0) return (int)cudaErrorInvalidValue;
  *out = align256(8 * (r + 1));
  return 0;
}

// out: (rows, width) uint8. Row i < r is data[starts[i*ss] ..][: lens[i*ls]]
// cut at width, then fill; rows past r are fill, and so is every byte past
// data_n. starts == null: the runs lie back to back from 0 (an exclusive
// scan of lens into the scratch).
int fq_rows_gather(const void* data, long long data_n, const void* starts, long long ss,
                   const void* lens, long long ls, long long r, long long rows, long long width,
                   int fill, void* scratch, void* out, void* stream) {
  if (r < 0 || rows < r || width < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* st = (const long long*)starts;
  if (!st) {
    long long* a = (long long*)scratch;
    copy_strided_kernel<<<grid_for(r, kThreads), kThreads, 0, s>>>((const long long*)lens, ls, r, a);
    cudaError_t rc = scan_fields(a, 1, r, s);
    if (rc != cudaSuccess) return (int)rc;
    st = a;
    ss = 1;
  }
  if (rows && width)
    gather_kernel<<<grid_for(rows, kWarps), kThreads, 0, s>>>(
        (const uint8_t*)data, data_n, st, ss, (const long long*)lens, ls, r, rows, width,
        (uint8_t)fill, (uint8_t*)out);
  return (int)cudaGetLastError();
}

int fq_streams_build_scratch(long long n, long long* out) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  *out = align256(8 * 5 * (n + 1));
  return 0;
}

// The six raw streams of n records (offsets (n, 8) from the scan) into out,
// back to back at the byte sizes s_seq .. s_len; packed / qual_delta / nmask
// rows at their pitches, n_counts per record; wide: u32 N positions.
// info: 2 int64, the npos and seq bytes written.
int fq_streams_build(const void* text, const void* offsets, long long n, const void* packed,
                     long long pp, const void* qual_delta, long long qp, const void* nmask,
                     long long np, const void* n_counts, int wide, long long s_seq,
                     long long s_qual, long long s_hdr, long long s_plus, long long s_npos,
                     long long s_len, void* scratch, void* out, void* info, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long* f = (long long*)scratch;
  stream_fields_kernel<<<grid_for(n, kThreads), kThreads, 0, s>>>(
      (const long long*)offsets, (const int32_t*)n_counts, n, f);
  cudaError_t rc = scan_fields(f, 5, n, s);
  if (rc != cudaSuccess) return (int)rc;
  Regions g;
  const long long sizes[6] = {s_seq, s_qual, s_hdr, s_plus, s_npos, s_len};
  long long b = 0;
  for (int k = 0; k < 6; ++k) {
    g.base[k] = b;
    b += sizes[k];
  }
  g.end = b;
  const int unit = wide ? 4 : 2;
  write_streams_kernel<<<grid_for(n, kWarps), kThreads, 0, s>>>(
      (const uint8_t*)text, (const long long*)offsets, n, (const uint8_t*)packed, pp,
      (const uint8_t*)qual_delta, qp, (const uint8_t*)nmask, np, (const int32_t*)n_counts, unit,
      f, g, (uint8_t*)out);
  finish_streams_kernel<<<1, 1, 0, s>>>(f, n, unit, (long long*)info);
  return (int)cudaGetLastError();
}

int fq_fastq_assemble_scratch(long long r, long long hdr_n, long long plus_n, long long npos_n,
                              int wide, long long* out) {
  if (r < 0 || hdr_n < 0 || plus_n < 0 || npos_n < 0) return (int)cudaErrorInvalidValue;
  *out = assemble_layout(r, hdr_n, plus_n, npos_n / (wide ? 4 : 2)).bytes;
  return 0;
}

// seq_rows / qual_rows: (r, pitch) ASCII rows of the dense decode; lengths:
// r int64; the header, plus (has_plus 0: bare '+', v1) and npos streams;
// len_n, seq_n, qual_n: the sizes of the lengths, sequence and quality
// streams. out: cap bytes; info: 2 int64, the text's bytes and the fault
// flags.
int fq_fastq_assemble(const void* seq_rows, const void* qual_rows, long long pitch,
                      const void* lengths, long long r, const void* hdr, long long hdr_n,
                      const void* plus, long long plus_n, int has_plus, const void* npos,
                      long long npos_n, int wide, long long len_n, long long seq_n,
                      long long qual_n, void* scratch, void* out, long long cap, void* info,
                      void* stream) {
  if (r <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int unit = wide ? 4 : 2;
  const AssembleScratch a = assemble_layout(r, hdr_n, has_plus ? plus_n : 0, npos_n / unit);
  char* at = (char*)scratch;
  Chains cs;
  Chain* ch = cs.c;
  const uint8_t* data[3] = {(const uint8_t*)hdr, (const uint8_t*)plus, (const uint8_t*)npos};
  for (int c = 0; c < 3; ++c) {
    ch[c].data = data[c];
    ch[c].n = a.chain_nodes[c];
    ch[c].unit = c == 2 ? unit : 1;
    ch[c].w = c == 2 ? 1 : 2;
    const long long tb = align256(8 * (ch[c].n + 2));
    ch[c].ja = (long long*)at;
    ch[c].jb = (long long*)(at + tb);
    ch[c].cur = (long long*)(at + 2 * tb);
    ch[c].stride = (long long*)(at + 2 * tb + align256(8 * (r + 1)));
    at += 2 * tb + align256(8 * (r + 1)) + 256;
  }
  long long* f = (long long*)at;
  const long long vmax[3] = {0xFFFF, 0xFFFF, wide ? 0xFFFFFFFFLL : 0xFFFF};
  cs.active[0] = 1;
  cs.active[1] = has_plus;
  cs.active[2] = 1;
  cudaError_t rc = resolve_chains(cs, r, vmax, s);
  if (rc != cudaSuccess) return (int)rc;
  // without a plus stream (v1) its chain is never resolved and never read
  const long long* len = (const long long*)lengths;
  assemble_fields_kernel<<<grid_for(r, kThreads), kThreads, 0, s>>>(ch[0], ch[1], has_plus, len,
                                                                    r, f);
  rc = scan_fields(f, 3, r, s);
  if (rc != cudaSuccess) return (int)rc;
  long long* inf = (long long*)info;
  assemble_flags_kernel<<<1, 1, 0, s>>>(ch[0], ch[1], has_plus, ch[2],
                                        !wide && (npos_n & 1), f, r, len_n, seq_n, qual_n, inf);
  assemble_write_kernel<<<grid_for(r, kWarps), kThreads, 0, s>>>(
      (const uint8_t*)seq_rows, (const uint8_t*)qual_rows, pitch, len, r, ch[0], ch[1], has_plus,
      ch[2], f, (uint8_t*)out, cap, inf);
  return (int)cudaGetLastError();
}

}  // extern "C"
