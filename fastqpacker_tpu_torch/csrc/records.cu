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
// The plain PyTorch versions are fastqpacker_tpu_torch/ops/records.py and
// are the specification of the values: each entry here computes the same
// bytes, the scan, the gathers and the stream build by the same algorithm,
// the assembly's length-prefixed chains by another one (below).
//
// What bounds them. Each moves every byte of its inputs and outputs once or
// twice and computes almost nothing per byte, so bytes bound all four (a
// block's text is 12.8-34 MB). The runtime walks a block record by record on
// one thread; here:
// - the record scan counts newlines per 32 KiB tile (16-byte loads, a SIMD
//   byte compare), scans the tile counts in one CTA, writes each newline's
//   position at its global line index, then lets warps stride over the
//   records for their line bounds, checks, quality minima and ambiguous
//   bases, with the block's sums gathered per CTA; the first bad line wins by
//   an atomic minimum of its index;
// - the stream build gives one warp to each record, at offsets from
//   exclusive scans over the records (one CTA of 1,024 threads per field);
// - the row gather is one launch: a CTA per tile of rows writes the tile's
//   rows x width output bytes, which are contiguous, in 16-byte units (8-
//   or 4-byte ones where the width asks), each read as aligned words of the
//   source realigned by funnel shifts; runs back to back from 0 (the decode)
//   get their starts from the tile's scan of the lengths and a decoupled
//   look-back over the tiles before it (Merrill & Garland); one launch can
//   gather a second matrix of (length + 3) / 4 bytes a row from a second
//   source (the decode's packed bases beside its qualities);
// - the assembly is three launches. The length-prefixed chains of the
//   decoder (s_(i+1) = s_i + 2 + len(s_i) over the header and plus payloads,
//   s_(i+1) = s_i + 1 + count(s_i) over the N positions) are first checked
//   for one record length throughout (the usual fixed-width header), beside
//   the block's length sums. A chain that is not uniform is cut into tiles
//   of its stream, a CTA each. In a header or plus stream whose lengths are
//   below 256 and whose payloads hold no 0 byte (read names), a record
//   starts exactly where the byte after is 0: each tile checks its
//   candidates (each one's successor is the next, nothing 0 between), and a
//   look-back over the tiles ranks them, so such a chain is resolved in one
//   pass. Past the first tile that fails, and for the N positions, each
//   tile resolves, for every node, the last node its walk reaches inside the
//   tile and the steps to it (pointer jumping in shared memory); the tiles
//   then hand each other the chain's entry node and record index in order,
//   and each marks the nodes its entry reaches by synchronous doubling and
//   ranks them with a scan into s_i. A step that leaves the stream lands on
//   an absorbing node n + 1, as in the plain version's pointer doubling, so
//   truncation is one comparison of s_r. The write gives a CTA to each tile
//   of records: the tile's rows and payloads staged in shared memory by
//   cp.async, the text offsets in closed form (the chain nodes and the
//   length sums), then the tile's text built in a shared-memory window by a
//   warp per record ('@', header, bases, '+', plus, qualities, N patched)
//   and stored in aligned 16-byte units. Nothing is written when a stream is
//   truncated.
// A launch does not synchronise and allocates nothing: each entry takes the
// scratch its wrapper sized, and the gather and the assembly a ticket word
// and status words that persist across launches on one stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <set>

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

// The SM count of the current device, queried once per device.
int sm_count() {
  static std::mutex mu;
  static std::map<int, int> sms;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  std::lock_guard<std::mutex> lock(mu);
  auto it = sms.find(dev);
  if (it != sms.end()) return it->second;
  int n = 132;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  sms[dev] = n;
  return n;
}

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
// tickets and status words (the row gather and the assembly)
// ---------------------------------------------------------------------------

// A launch whose tiles wait on each other takes each CTA's tile from a
// ticket counter (atomicInc, so the last ticket wraps it back to 0 for the
// next launch on the stream): a tile waits only on tiles of earlier tickets,
// which are running or done. Tile j owns kStatusWords u64 of a status buffer
// that is zeroed once and never cleared: a flag, the launch's epoch << 2 |
// state, then kSums aggregate sums and kSums inclusive sums (a chain tile:
// its entry). The sums are stored before the flag is released; a reader
// acquires the flag, then reads the sums it names. A flag of another epoch
// is not ready.
constexpr int kStatusWords = 8;
constexpr int kSums = 3;
constexpr unsigned long long kAggregate = 1, kInclusive = 2;

__device__ inline unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ inline unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ inline void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ inline void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The CTA's tile, from the ticket counter. Every thread must call it.
__device__ inline long long take_ticket(unsigned* ticket) {
  __shared__ unsigned s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicInc(ticket, gridDim.x - 1);
  __syncthreads();
  return (long long)s_ticket;
}

// Tile `tile`'s sums v[0 .. N) as its aggregate or inclusive state. One
// thread.
template <int N>
__device__ inline void publish(unsigned long long* status, long long tile,
                               unsigned long long epoch, unsigned long long state,
                               const long long (&v)[N]) {
  unsigned long long* st = status + tile * kStatusWords;
  const int off = state == kInclusive ? 1 + kSums : 1;
#pragma unroll
  for (int k = 0; k < N; ++k) st_relaxed(st + off + k, (unsigned long long)v[k]);
  st_release(st, (epoch << 2) | state);
}

__device__ inline long long warp_max(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The sums of the tiles before `tile` (> 0), by one whole warp: windows of
// the 32 nearest tiles, combined down to the nearest inclusive one. Slot
// kMax (if any) combines by maximum, the others by sum.
template <int N, int kMax = -1>
__device__ void look_back(const unsigned long long* status, long long tile,
                          unsigned long long epoch, long long (&pre)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < N; ++k) pre[k] = 0;
  for (long long end = tile; end > 0; end -= 32) {
    const long long j = end - 1 - lane;
    const unsigned valid = __ballot_sync(kFull, j >= 0);
    unsigned long long state = 0;
    unsigned need, incl;
    for (;;) {
      if (j >= 0) {
        const unsigned long long f = ld_acquire(status + j * kStatusWords);
        state = (f >> 2) == epoch ? (f & 3) : 0;
      }
      incl = __ballot_sync(kFull, state == kInclusive) & valid;
      const unsigned first = incl & (0u - incl);
      need = first ? (first | (first - 1)) : valid;
      if (!(__ballot_sync(kFull, state == 0) & need)) break;
    }
    const bool mine = (need >> lane) & 1;
    const unsigned long long* sums =
        status + (mine ? j : 0) * kStatusWords + (state == kInclusive ? 1 + kSums : 1);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const long long x = mine ? (long long)ld_relaxed(sums + k) : 0;
      pre[k] = k == kMax ? max(pre[k], warp_max(x)) : pre[k] + warp_sum(x);
    }
    if (incl & need) break;
  }
}

// The exclusive prefix over the tiles of a launch: tile's own values v, the
// combined values of the tiles before it into pre (the same in every
// thread). Every thread must call it; warp 0 does the look-back.
template <int N, int kMax = -1>
__device__ void tile_prefix(unsigned long long* status, long long tile, unsigned long long epoch,
                            const long long (&v)[N], long long (&pre)[N]) {
  __shared__ long long s_pre[kSums];
  if (threadIdx.x < 32) {
    long long p[N];
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = 0;
    if (tile > 0) {
      if (threadIdx.x == 0) publish(status, tile, epoch, kAggregate, v);
      __syncwarp();
      look_back<N, kMax>(status, tile, epoch, p);
    }
    if (threadIdx.x == 0) {
      long long inc[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        inc[k] = k == kMax ? max(p[k], v[k]) : p[k] + v[k];
        s_pre[k] = p[k];
      }
      publish(status, tile, epoch, kInclusive, inc);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) pre[k] = s_pre[k];
  __syncthreads();  // s_pre is reused by the next call
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
  const int sms = sm_count();
  const long long want = (max_records + kWarps - 1) / kWarps;
  const long long most = 8LL * sms;
  return (unsigned)(want < 1 ? 1 : (want < most ? want : most));
}

// ---------------------------------------------------------------------------
// 2. row gather
// ---------------------------------------------------------------------------

constexpr int kGatherThreads = 256;
constexpr int kGatherMaxRows = 256;  // rows per tile at most (one a thread in its scan)

struct GatherOut {
  const uint8_t* data;  // the source (any byte offset)
  long long data_n;     // its bytes
  long long width;      // bytes a row
  uint8_t* out;         // (rows, width), 16-byte aligned
};

struct GatherArgs {
  GatherOut m[2];  // m[1]: the pair's second matrix, (length + 3) / 4 bytes a row
  int pair;
  const long long* starts;  // null: the runs lie back to back from 0
  long long ss;
  const long long* lens;
  long long ls, r, rows;
  int tile_rows;
  uint8_t fill;
  unsigned* ticket;
  unsigned long long* status;
  unsigned long long epoch;
};

template <int V>
__device__ inline void load_words(const uint8_t* p, uint32_t* w) {
  if constexpr (V == 16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else if constexpr (V == 8) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = q.x; w[1] = q.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// The V bytes at p (V = 4, 8 or 16, any alignment) as V / 4 words: read as
// aligned V-byte words, two where p straddles one, and realigned by funnel
// shifts. The first `need` bytes (1 .. V) must be readable; only a word that
// holds one of them is loaded, so no load leaves their aligned words. Bytes
// past `need` are unspecified.
template <int V>
__device__ inline void load_unaligned(const uint8_t* p, int need, uint32_t (&o)[V / 4]) {
  constexpr int W = V / 4;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int off = (int)(a & (V - 1));
  const uint8_t* base = reinterpret_cast<const uint8_t*>(a - off);
  uint32_t w[2 * W];
  load_words<V>(base, w);
  if (off + need > V) {
    load_words<V>(base + V, w + W);
  } else {
#pragma unroll
    for (int k = W; k < 2 * W; ++k) w[k] = 0;
  }
  const int q = off >> 2;
  if constexpr (W >= 4) {
    if (q & 2) {
#pragma unroll
      for (int k = 0; k + 2 < 2 * W; ++k) w[k] = w[k + 2];
    }
  }
  if constexpr (W >= 2) {
    if (q & 1) {
#pragma unroll
      for (int k = 0; k + 1 < 2 * W; ++k) w[k] = w[k + 1];
    }
  }
  const unsigned s = 8u * (unsigned)(off & 3);
#pragma unroll
  for (int k = 0; k < W; ++k) o[k] = __funnelshift_r(w[k], w[k + 1], s);
}

// One V-byte unit (V = 4, 8 or 16) of an output row, at dst (V-byte
// aligned): the source bytes src .. src + nv (nv may be <= 0 or > V), then
// fill; a source byte outside [0, data_n) is fill.
template <int V>
__device__ inline void gather_unit(const uint8_t* __restrict__ data, long long data_n,
                                   long long src, long long nv, uint8_t fill,
                                   uint8_t* __restrict__ dst) {
  constexpr int W = V / 4;
  const uint32_t fill4 = 0x01010101u * fill;
  uint32_t o[W];
  const int n = nv <= 0 ? 0 : (nv < V ? (int)nv : V);
  if (n > 0 && src >= 0 && src + n <= data_n) {
    load_unaligned<V>(data + src, n, o);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int c = n - 4 * k;
      const uint32_t m = c >= 4 ? kFull : (c <= 0 ? 0u : (kFull >> (32 - 8 * c)));
      o[k] = (o[k] & m) | (fill4 & ~m);
    }
  } else {  // all fill, or at an edge of the source: a byte at a time
#pragma unroll
    for (int k = 0; k < W; ++k) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const long long j = 4 * k + b, at = src + j;
        const uint32_t x = (j < n && at >= 0 && at < data_n) ? data[at] : fill;
        v |= x << (8 * b);
      }
      o[k] = v;
    }
  }
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  } else if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = o[0];
  }
}

// The tile's rows of one matrix (contiguous in the output), V bytes a unit,
// a unit a thread in turn: row q reads g.data from st[q], len[q] bytes.
template <int V>
__device__ void gather_tile(const GatherOut& g, const long long* st, const long long* len,
                            long long row0, int nrows, uint8_t fill) {
  const unsigned per_row = (unsigned)(g.width / V);
  const unsigned units = (unsigned)nrows * per_row;
  uint8_t* out = g.out + row0 * g.width;
  for (unsigned u = threadIdx.x; u < units; u += blockDim.x) {
    const unsigned q = u / per_row;
    const long long col = (long long)(u - q * per_row) * V;
    uint8_t* dst = out + (long long)q * g.width + col;
    if constexpr (V == 1) {
      const long long at = st[q] + col;
      *dst = (col < len[q] && at >= 0 && at < g.data_n) ? g.data[at] : fill;
    } else {
      gather_unit<V>(g.data, g.data_n, st[q] + col, len[q] - col, fill, dst);
    }
  }
}

__device__ void gather_matrix(const GatherOut& g, const long long* st, const long long* len,
                              long long row0, int nrows, uint8_t fill) {
  if (g.width % 16 == 0) gather_tile<16>(g, st, len, row0, nrows, fill);
  else if (g.width % 8 == 0) gather_tile<8>(g, st, len, row0, nrows, fill);
  else if (g.width % 4 == 0) gather_tile<4>(g, st, len, row0, nrows, fill);
  else gather_tile<1>(g, st, len, row0, nrows, fill);
}

// One tile of a.tile_rows rows per CTA. Each row's start comes from starts,
// or (back to back) from the tile's scan of the raw lengths and the
// look-back over the tiles before it; its length is clamped to the width.
__global__ void __launch_bounds__(kGatherThreads) gather_kernel(GatherArgs a) {
  __shared__ long long s_st[2][kGatherMaxRows];
  __shared__ long long s_len[2][kGatherMaxRows];
  __shared__ long long sh[33];
  const bool chained = a.starts == nullptr;
  const long long tile = chained ? take_ticket(a.ticket) : (long long)blockIdx.x;
  const long long row0 = tile * a.tile_rows;
  const long long left = a.rows - row0;
  const int nrows = (int)(left < a.tile_rows ? left : a.tile_rows);
  const int t = threadIdx.x;
  const long long row = row0 + t;
  const bool have = t < nrows && row < a.r;
  const long long raw = have ? a.lens[row * a.ls] : 0;
  const long long raw2 = have && a.pair ? (raw + 3) >> 2 : 0;
  long long st0, st1 = 0;
  if (chained) {
    long long v[2];
    const long long ex0 = block_excl(raw, &v[0], sh);
    const long long ex1 = block_excl(raw2, &v[1], sh);
    long long pre[2];
    tile_prefix(a.status, tile, a.epoch, v, pre);
    st0 = pre[0] + ex0;
    st1 = pre[1] + ex1;
  } else {
    st0 = have ? a.starts[row * a.ss] : 0;
  }
  if (t < nrows) {
    s_st[0][t] = st0;
    s_len[0][t] = raw < 0 ? 0 : (raw < a.m[0].width ? raw : a.m[0].width);
    s_st[1][t] = st1;
    s_len[1][t] = raw2 < 0 ? 0 : (raw2 < a.m[1].width ? raw2 : a.m[1].width);
  }
  __syncthreads();
  if (a.m[0].width) gather_matrix(a.m[0], s_st[0], s_len[0], row0, nrows, a.fill);
  if (a.pair && a.m[1].width) gather_matrix(a.m[1], s_st[1], s_len[1], row0, nrows, a.fill);
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

constexpr int kCheckThreads = 256;
constexpr int kChainThreads = 1024;
constexpr int kChainMinTile = 1024;      // nodes per tile of the chain kernel, a power of two
constexpr int kChainMaxTile = 16384;
constexpr int kWriteThreads = 256;
constexpr int kWriteMaxRecords = 64;     // records per tile of the write kernel at most
constexpr int kSlotWords = 4;            // per check CTA: uniform bits, length sum, packed sum
constexpr long long kNodeLimit = (1LL << 31) - 2;  // nodes of a stream, records of a block

// A length-prefixed chain: node p (a byte for the u16-prefixed payload
// streams, unit 1 and prefix width w 2; a u16 or u32 unit of the npos
// stream, w 1) holds value(p), the next node is p + w + value(p). Nodes
// run 0 .. n; n + 1 absorbs every step that leaves the stream.
struct Chain {
  const uint8_t* data;
  long long n;       // nodes of the stream
  long long stride;  // s_i = i * stride if every record has this length (checked), 0: no candidate
  int unit;          // bytes per node
  int w;             // prefix width in nodes
  int active;
  int tile;          // nodes per tile of the chain kernel
  int tiles;         // n / tile + 1
  int first;         // the chain kernel's first tile of this chain
  int* cur;          // s_0 .. s_r when the chain is not uniform
};

struct Assemble {
  Chain c[3];  // headers, plus payloads (inactive without a plus stream: v1), N positions
  const uint8_t* seq_rows;
  const uint8_t* qual_rows;
  long long pitch;
  const long long* lengths;
  long long r, len_n, seq_n, qual_n;
  int has_plus, odd_npos;
  int checks;         // CTAs of the check kernel
  long long* slots;   // their results, kSlotWords each
  int tile_records;   // records per tile of the write kernel
  int stage_rows;     // the write kernel stages each tile's rows in shared memory
  uint8_t* out;
  long long cap;
  long long* info;
  unsigned* ticket;
  unsigned long long* status;
  unsigned long long epoch;  // the chain kernel's
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

__device__ inline Chain pick_chain(const Assemble& a, int y) {
  return y == 0 ? a.c[0] : (y == 1 ? a.c[1] : a.c[2]);
}

// What the check kernel found: bit y set when chain y is uniform; the sums
// of the lengths and of the packed bytes. Every thread must call it.
struct Checked {
  int uniform;
  long long len_sum, packed_sum;
};

__device__ Checked read_checks(const Assemble& a) {
  __shared__ Checked s_checked;
  if (threadIdx.x < 32) {
    int bits = 7;
    long long sl = 0, sp = 0;
    for (int j = threadIdx.x; j < a.checks; j += 32) {
      const long long* s = a.slots + (long long)j * kSlotWords;
      bits &= (int)s[0];
      sl += s[1];
      sp += s[2];
    }
    bits = (int)__reduce_and_sync(kFull, (unsigned)bits);
    sl = warp_sum(sl);
    sp = warp_sum(sp);
    if (threadIdx.x == 0) s_checked = {bits, sl, sp};
  }
  __syncthreads();
  return s_checked;
}

// s_i of chain c: i * stride when uniform, else from the chain kernel.
__device__ inline long long chain_node(const Chain& c, bool uniform, long long i) {
  return uniform ? i * c.stride : (long long)c.cur[i];
}

// The records of each check CTA: a contiguous chunk.
__device__ inline long long check_chunk(const Assemble& a) {
  return (a.r + a.checks - 1) / a.checks;
}

// Every record: each uniform candidate checked at i * stride, the lengths
// summed; one slot per CTA, which takes a chunk of records. CTA 0 clears
// info.
__global__ void __launch_bounds__(kCheckThreads) assemble_check_kernel(Assemble a) {
  __shared__ long long sh[33];
  int bits = 0;
  for (int y = 0; y < 3; ++y)
    if (a.c[y].active && a.c[y].stride) bits |= 1 << y;
  long long sl = 0, sp = 0;
  const long long chunk = check_chunk(a), end = min(a.r, (blockIdx.x + 1LL) * chunk);
  for (long long i = blockIdx.x * chunk + threadIdx.x; i < end; i += kCheckThreads) {
    for (int y = 0; y < 3; ++y) {
      if ((bits >> y) & 1) {
        const Chain& c = a.c[y];
        if (chain_value(c, i * c.stride) != c.stride - c.w) bits &= ~(1 << y);
      }
    }
    const long long len = a.lengths[i];
    sl += len;
    sp += (len + 3) >> 2;
  }
  int all = 0;
  for (int y = 0; y < 3; ++y) all |= __syncthreads_and((bits >> y) & 1) << y;
  long long tsl, tsp;
  block_excl(sl, &tsl, sh);
  block_excl(sp, &tsp, sh);
  if (threadIdx.x == 0) {
    long long* s = a.slots + (long long)blockIdx.x * kSlotWords;
    s[0] = all;
    s[1] = tsl;
    s[2] = tsp;
    s[3] = 0;
    if (blockIdx.x == 0) {
      a.info[0] = 0;
      a.info[1] = 0;
    }
  }
}

// Shared-memory words of the chain kernel's slow path: node k of a tile
// holds the node its walk has reached (kJump bits), whether that is the last
// one inside the tile (kLast) and, while the exits are resolved, the steps
// taken (upper 16 bits). The marking rounds use two u16 tables of the same
// bits.
constexpr uint32_t kJump = 0x7fff, kLast = 0x8000;
constexpr int kHandoff = kStatusWords - 1;  // the status word a tile hands its successor

// Node k's first step inside its tile: its successor, or itself when the
// successor lies past the tile (or k past the stream).
__device__ inline uint32_t first_step(const Chain& c, long long base, int tile, int k) {
  const long long node = base + k;
  if (node > c.n) return (uint32_t)k | kLast;
  const long long q = chain_next(c, node);
  if (q <= c.n && q < base + tile) return (uint32_t)(q - base);
  return (uint32_t)k | kLast;
}

// A u16-prefixed payload stream (w 2) whose lengths are below 256 and
// whose payloads hold no 0 byte (printable read names) has a record start at
// exactly the nodes p with data[p + 1] == 0: the candidates.
__device__ inline bool candidate(const Chain& c, long long p) {
  return p + 2 <= c.n && c.data[p + 1] == 0;
}

// Candidate p's successor (at most 257 nodes on, its high byte being 0),
// with *bad set unless it is the next candidate (no 0 byte from p + 2
// through it, its own high byte 0) or the end of the stream.
__device__ inline long long verified_next(const Chain& c, long long p, int* bad) {
  const long long q = chain_next(c, p);
  if (q > c.n) {
    *bad = 1;
    return q;
  }
  const long long last = q < c.n ? q : c.n - 1;
  for (long long x = p + 2; x <= last; ++x)
    if (c.data[x] == 0) *bad = 1;
  if (q < c.n && !candidate(c, q)) *bad = 1;
  return q;
}

__device__ long long block_max(long long v, long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0;
    w = warp_max(w);
    if (lane == 0) sh[32] = w;
  }
  __syncthreads();
  const long long res = sh[32];
  __syncthreads();
  return res;
}

// s_i = node for i = index ..: the tile's chain nodes in order (each thread
// owns `per` consecutive nodes, marked in `mark`), ranked by a scan; nodes
// past record r are not written.
__device__ void emit_marked(const Chain& c, const uint8_t* mark, long long base, int per,
                            long long index, long long r, long long* sh) {
  const int tid = threadIdx.x;
  int count = 0;
  for (int q = 0; q < per; ++q) count += mark[tid * per + q];
  long long total;
  long long at = index + block_excl(count, &total, sh);
  for (int q = 0; q < per; ++q) {
    if (mark[tid * per + q]) {
      if (at <= r) c.cur[at] = (int)(base + tid * per + q);
      ++at;
    }
  }
}

// One tile of a chain that is not uniform, a CTA each, tiles in ticket
// order (every tile of the N positions, then of the headers, then of the
// plus payloads).
//
// Fast path (the header and plus streams): the tile's candidates and their
// check; a look-back over the tiles of the chain gives the failed tiles
// before it, the candidates before it (its first candidate's record index)
// and the successor of the last candidate before it. While no tile up to
// this one has failed, the candidates are the chain's nodes: ranked, they
// are s_(index + rank).
//
// Slow path (the N positions, and every tile from the first that fails):
// 1. each node's last node inside the tile and the steps to it (pointer
//    jumping in place: any mix of old and new words is a valid pair);
// 2. the tile's entry, the first chain node at or past its start, and that
//    node's record index: from the look-back for the first failed tile,
//    else handed over by the tile before (tile 0: node 0, record 0), in one
//    status word the reader clears; the exit (the successor of the entry's
//    last node) and its index go to the next tile at once;
// 3. the nodes the entry reaches, marked by synchronous doubling (after
//    round j the marks hold the entry's first 2^(j+1) successors), ranked
//    by a scan.
// An exit to the end of the stream or the absorbing node fills the rest of
// s up to r.
__global__ void __launch_bounds__(kChainThreads) chain_kernel(Assemble a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long sh[33];
  __shared__ long long s_entry, s_index, s_exit, s_next;
  __shared__ int s_emit;
  const long long g = take_ticket(a.ticket);
  const Checked ck = read_checks(a);
  int y = 0;
  while (y < 2 && !(a.c[y].active && g >= a.c[y].first && g < a.c[y].first + a.c[y].tiles)) ++y;
  const Chain c = pick_chain(a, y);
  if ((ck.uniform >> y) & 1) return;
  const int tile = c.tile, per = tile / kChainThreads;
  const long long t = g - c.first;
  const long long base = t * tile;
  const int tid = threadIdx.x;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint8_t* mark = smem + 4 * tile;
  unsigned long long* status = a.status + (long long)c.first * kStatusWords;
  bool handed = t > 0;  // the entry comes from the tile before
  if (tid == 0) {
    s_entry = 0;
    s_index = 0;
  }

  if (c.w == 2) {  // fast path
    int bad = 0, count = 0;
    long long last_exit = 0;
    for (int q = 0; q < per; ++q) {
      const long long p = base + tid * per + q;
      const bool is = candidate(c, p);
      mark[tid * per + q] = is;
      if (is) {
        ++count;
        last_exit = verified_next(c, p, &bad);
      }
    }
    if (t == 0 && tid == 0 && !candidate(c, 0)) bad = 1;
    const long long failed = __syncthreads_or(bad);
    long long total;
    block_excl(count, &total, sh);
    const long long exit_max = block_max(last_exit, sh);
    long long v[3] = {failed, total, exit_max}, pre[3];
    tile_prefix<3, 2>(status, t, a.epoch, v, pre);
    if (!pre[0] && !failed) {
      emit_marked(c, mark, base, per, pre[1], a.r, sh);
      // the last candidate reaches the end of the stream: s continues
      // with n, then the absorbing node
      if (total && exit_max == c.n)
        for (long long i = pre[1] + total + tid; i <= a.r; i += kChainThreads)
          c.cur[i] = (int)(i == pre[1] + total ? c.n : c.n + 1);
      return;
    }
    if (!pre[0]) {  // the first failed tile: its entry from the look-back
      handed = false;
      if (tid == 0 && t > 0) {
        s_entry = pre[2];
        s_index = pre[1];
      }
    }
    __syncthreads();
  }

  // slow path: 1. exits
  for (int k = tid; k < tile; k += kChainThreads) {
    const uint32_t s = first_step(c, base, tile, k);
    tab[k] = s | ((s & kLast) ? 0u : 1u << 16);
  }
  __syncthreads();
  for (;;) {
    int changed = 0;
    for (int k = tid; k < tile; k += kChainThreads) {
      const uint32_t v = tab[k];
      if (!(v & kLast)) {
        const uint32_t u = tab[v & kJump];
        tab[k] = (u & (kJump | kLast)) | (((v >> 16) + (u >> 16)) << 16);
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  // 2. entry and exit
  if (tid == 0) {
    long long e = s_entry, i = s_index;
    if (handed) {
      unsigned long long* w = status + t * kStatusWords + kHandoff;
      unsigned long long v;
      while ((v = ld_relaxed(w)) == 0) {
      }
      st_relaxed(w, 0);
      e = (long long)(v & 0xffffffffu) - 1;
      i = (long long)(v >> 32);
    }
    long long x = e, nx = i;
    int emit = 0;
    if (e <= c.n && e >= base && e < base + tile) {  // a node of this tile
      const uint32_t v = tab[e - base];
      x = chain_next(c, base + (v & kJump));
      nx = i + (long long)(v >> 16) + 1;
      if (nx > a.r + 1) nx = a.r + 1;
      emit = i <= a.r;
    }
    if (t + 1 < c.tiles)
      st_relaxed(status + (t + 1) * kStatusWords + kHandoff,
                 (unsigned long long)(x + 1) | ((unsigned long long)nx << 32));
    s_entry = e;
    s_index = i;
    s_exit = x;
    s_next = nx;
    s_emit = emit;
  }
  __syncthreads();
  if (!s_emit) return;

  // 3. the entry's nodes, marked and ranked
  uint16_t* ja = reinterpret_cast<uint16_t*>(smem);
  uint16_t* jb = ja + tile;
  const int ke = (int)(s_entry - base);
  for (int k = tid; k < tile; k += kChainThreads) {
    ja[k] = (uint16_t)first_step(c, base, tile, k);
    mark[k] = k == ke;
  }
  __syncthreads();
  for (int round = 0;; ++round) {
    const uint16_t* src = (round & 1) ? jb : ja;
    uint16_t* dst = (round & 1) ? ja : jb;
    int done = 0;
    for (int k = tid; k < tile; k += kChainThreads) {
      const uint16_t v = src[k];
      if (k == ke) done = v & kLast;
      if (mark[k]) mark[v & kJump] = 1;
      dst[k] = (v & kLast) ? v : src[v & kJump];
    }
    // the entry reached its last node within 2^round steps: the marks now
    // cover 2^(round + 1) of them
    if (__syncthreads_or(done)) break;
  }
  emit_marked(c, mark, base, per, s_index, a.r, sh);
  if (s_exit >= c.n)  // n, then the absorbing node (or the absorbing node)
    for (long long i = s_next + tid; i <= a.r; i += kChainThreads)
      c.cur[i] = (int)(i == s_next && s_exit == c.n ? c.n : c.n + 1);
}

// The block's fault flags but an invalid N position, from the check and
// chain kernels (the same in every thread).
__device__ long long assemble_flags(const Assemble& a, const Checked& ck) {
  long long flags = 0;
  if (a.len_n < 4 * a.r) flags |= kFaultLen;
  if (ck.packed_sum > a.seq_n) flags |= kFaultSeq;
  if (ck.len_sum > a.qual_n) flags |= kFaultQual;
  const Chain& h = a.c[0];
  const Chain& p = a.c[1];
  const Chain& np = a.c[2];
  if (a.odd_npos || chain_node(np, (ck.uniform >> 2) & 1, a.r) == np.n + 1)
    flags |= kFaultNposTrunc;
  if (chain_node(h, ck.uniform & 1, a.r) == h.n + 1) flags |= kFaultHdr;
  if (a.has_plus && chain_node(p, (ck.uniform >> 1) & 1, a.r) == p.n + 1) flags |= kFaultPlus;
  return flags;
}

// A record of the write kernel's tile: where its text starts, its read's
// length, its header and plus payload lengths, and where its four copied
// pieces come from (header payload, bases, plus payload, qualities): the
// tile's staged copies in shared memory, or the streams and rows themselves
// where they did not fit.
struct TextRecord {
  long long off, len;
  const uint8_t* src[4];
  int hl, pl;
};

// Bytes [at, at + n) of the text from src, those inside the window [w0, w1)
// into stage; lanes of a warp take every 32nd byte.
__device__ inline void put_run(uint8_t* stage, long long w0, long long w1, long long at,
                               long long n, const uint8_t* src, int lane) {
  const int lo = (int)((at > w0 ? at : w0) - w0);
  const int hi = (int)((at + n < w1 ? at + n : w1) - w0);
  const uint8_t* s = src + (w0 - at);  // byte q of the window comes from s[q]
#pragma unroll 4
  for (int q = lo + lane; q < hi; q += 32) stage[q] = s[q];
}

__device__ inline void put_byte(uint8_t* stage, long long w0, long long w1, long long at,
                                uint8_t b, int lane) {
  if (lane == 0 && at >= w0 && at < w1) stage[at - w0] = b;
}

// Starts copying [src, src + n) into dst (16-byte aligned, n + 32 bytes of
// room) by cp.async, whole aligned 16-byte chunks; returns where byte 0 of
// the span lands in dst. Every thread of the CTA calls it.
__device__ inline const uint8_t* stage_span(uint8_t* dst, const uint8_t* src, long long n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int off = (int)(a & 15);
  const uint8_t* base = reinterpret_cast<const uint8_t*>(a - off);
  const long long chunks = (off + n + 15) >> 4;
  for (long long k = threadIdx.x; k < chunks; k += blockDim.x) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 16 * k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(base + 16 * k)
                 : "memory");
  }
  return dst + off;
}

// Dynamic shared memory of the write kernel: the tile's rows when they fit
// (stage_rows), a header and a plus span of up to kSpanStage bytes each, and
// the text window.
constexpr int kSpanStage = 4096;
constexpr int kRowStage = 16384;  // both rows of a tile at most
constexpr int kWindow = 16384;    // text bytes the write kernel builds at a time

// One tile of a.tile_records records per CTA:
// 1. each record's text bytes (6 + header + plus + 2 * length), header and
//    plus payload; the tile's bases and qualities rows and its header and
//    plus payloads (each contiguous in its source) start to arrive in
//    shared memory by cp.async;
// 2. the text offsets: the tile's first from the chain nodes and the length
//    sums, the others from a scan of the sizes (the text's bytes are added
//    up in info[0], the flags or-ed into info[1]);
// 3. when no stream is truncated, the tile's text window by window: a warp
//    per record puts its pieces into the window and 'N' at each recorded
//    position (a position past the read sets kFaultNposInvalid), then the
//    CTA stores the window in aligned 16-byte units (single bytes at the
//    tile's two ends). When only the header or plus stream is truncated,
//    the N positions are checked and nothing is written.
__global__ void __launch_bounds__(kWriteThreads) write_kernel(Assemble a) {
  extern __shared__ __align__(16) uint8_t wsm[];
  __shared__ TextRecord s_rec[kWriteMaxRecords];
  __shared__ long long s_ns[kWriteMaxRecords];
  __shared__ int s_cnt[kWriteMaxRecords];
  __shared__ long long sh[33];
  __shared__ int s_bad;
  const Checked ck = read_checks(a);
  const long long flags = assemble_flags(a, ck);
  // the decoder checks the N positions before it walks the header and plus
  // streams: whenever the streams before them are whole
  const bool npos_whole = !(flags & (kFaultLen | kFaultSeq | kFaultQual | kFaultNposTrunc));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i0 = (long long)blockIdx.x * a.tile_records;
  const long long left = a.r - i0;
  const int count = (int)(left < a.tile_records ? left : a.tile_records);
  const Chain& h = a.c[0];
  const Chain& p = a.c[1];
  const Chain& np = a.c[2];
  long long size = 0, hs = 0, ps = 0;
  TextRecord f = {};
  if (tid < count) {
    const long long i = i0 + tid;
    hs = chain_node(h, ck.uniform & 1, i) + 2;
    f.hl = (int)chain_value(h, hs - 2);
    if (a.has_plus) {
      ps = chain_node(p, (ck.uniform >> 1) & 1, i) + 2;
      f.pl = (int)chain_value(p, ps - 2);
    }
    f.len = a.lengths[i];
    size = 6 + f.hl + f.pl + 2 * f.len;
    const long long ns = chain_node(np, (ck.uniform >> 2) & 1, i);
    s_ns[tid] = ns;
    s_cnt[tid] = npos_whole ? (int)chain_value(np, ns) : 0;
    s_rec[tid] = f;
    s_rec[tid].src[0] = h.data + hs;
    s_rec[tid].src[2] = a.has_plus ? p.data + ps : nullptr;
  }
  if (tid == 0) s_bad = 0;
  __syncthreads();
  // 1. stage the tile's pieces (without faults: the spans are whole)
  const bool write = !flags;
  const uint8_t* span_lo[2];
  long long span_n[2];
  for (int w = 0; w < 2; ++w) {  // header and plus payloads
    span_lo[w] = s_rec[0].src[2 * w];
    span_n[w] = s_rec[count - 1].src[2 * w] + (w ? s_rec[count - 1].pl : s_rec[count - 1].hl)
                - span_lo[w];
  }
  __syncthreads();
  const long long region = ((long long)a.tile_records * a.pitch + 15) / 16 * 16 + 32;
  uint8_t* spans = wsm + (a.stage_rows ? 2 * region : 0);
  const uint8_t *seq0 = a.seq_rows + i0 * a.pitch, *qual0 = a.qual_rows + i0 * a.pitch;
  if (write && a.stage_rows) {
    seq0 = stage_span(wsm, seq0, (long long)count * a.pitch);
    qual0 = stage_span(wsm + region, qual0, (long long)count * a.pitch);
  }
  for (int w = 0; w < 2 && write; ++w) {
    if (!span_lo[w] || span_n[w] > kSpanStage) continue;
    const uint8_t* at = stage_span(spans + w * (kSpanStage + 32), span_lo[w], span_n[w]);
    if (tid < count) s_rec[tid].src[2 * w] = at + (s_rec[tid].src[2 * w] - span_lo[w]);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  if (tid < count) {
    s_rec[tid].src[1] = seq0 + (long long)tid * a.pitch;
    s_rec[tid].src[3] = qual0 + (long long)tid * a.pitch;
  }
  // 2. offsets: the text before the tile is 6 i0 + (s_i0 - 2 i0) of the
  // header chain + the same of the plus chain + twice the lengths before i0
  // (the check CTAs' sums of the chunks before, and the rest of i0's
  // chunk); whole streams only, so that the payloads before i0 are the
  // nodes before s_i0. The text's bytes are summed over the tiles.
  long long total;
  const long long ex = block_excl(size, &total, sh);
  if (tid == 0) atomicAdd(reinterpret_cast<unsigned long long*>(a.info), (unsigned long long)total);
  long long before = 0;
  if (write) {
    const long long chunk = check_chunk(a), c0 = i0 / chunk;
    long long lens = 0;
    for (long long j = tid; j < c0; j += kWriteThreads) lens += a.slots[j * kSlotWords + 1];
    for (long long i = c0 * chunk + tid; i < i0; i += kWriteThreads) lens += a.lengths[i];
    long long all;
    block_excl(lens, &all, sh);
    before = 6 * i0 + (chain_node(h, ck.uniform & 1, i0) - 2 * i0) + 2 * all;
    if (a.has_plus) before += chain_node(p, (ck.uniform >> 1) & 1, i0) - 2 * i0;
  }
  if (tid < count) s_rec[tid].off = before + ex;
  if (tid == 0 && blockIdx.x == 0 && flags)
    atomicOr(reinterpret_cast<unsigned long long*>(a.info + 1), (unsigned long long)flags);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  if (!npos_whole) return;
  // 3. the text, window by window: a warp per record puts its pieces into
  // the window and patches its N positions there, then the window goes out
  // in 16-byte stores
  if (!write) {  // a header or plus stream is truncated: the N positions only
    for (int k = warp; k < count; k += kWriteThreads / 32) {
      bool bad = false;
      for (long long q = lane; q < s_cnt[k]; q += 32)
        bad |= chain_value(np, s_ns[k] + 1 + q) >= s_rec[k].len;
      if (__any_sync(kFull, bad) && lane == 0) s_bad = 1;
    }
    __syncthreads();
    if (tid == 0 && s_bad)
      atomicOr(reinterpret_cast<unsigned long long*>(a.info + 1),
               (unsigned long long)kFaultNposInvalid);
    return;
  }
  const long long A = before, B = before + total < a.cap ? before + total : a.cap;
  uint8_t* text = spans + 2 * (kSpanStage + 32);
  for (long long w0 = A & ~15LL; w0 < B; w0 += kWindow) {
    const long long w1 = w0 + kWindow < B ? w0 + kWindow : B;
    for (int k = warp; k < count; k += kWriteThreads / 32) {
      const TextRecord& r0 = s_rec[k];
      const long long o = r0.off, len = r0.len;
      if (o >= w1 || o + 6 + r0.hl + r0.pl + 2 * len <= w0) continue;
      const long long seq_at = o + 2 + r0.hl, plus_at = seq_at + len + 1,
                      qual_at = plus_at + r0.pl + 2;
      {
        put_byte(text, w0, w1, o, '@', lane);
        put_run(text, w0, w1, o + 1, r0.hl, r0.src[0], lane);
        put_byte(text, w0, w1, seq_at - 1, '\n', lane);
        put_run(text, w0, w1, seq_at, len, r0.src[1], lane);
        put_byte(text, w0, w1, plus_at - 1, '\n', lane);
        put_byte(text, w0, w1, plus_at, '+', lane);
        put_run(text, w0, w1, plus_at + 1, r0.pl, r0.src[2], lane);
        put_byte(text, w0, w1, qual_at - 1, '\n', lane);
        put_run(text, w0, w1, qual_at, len, r0.src[3], lane);
        put_byte(text, w0, w1, qual_at + len, '\n', lane);
        __syncwarp();
      }
      // N at each recorded position inside the read; a position past the
      // read is a fault
      bool bad = false;
      for (long long q = lane; q < s_cnt[k]; q += 32) {
        const long long pos = chain_value(np, s_ns[k] + 1 + q);
        if (pos >= len) bad = true;
        else if (seq_at + pos >= w0 && seq_at + pos < w1) text[seq_at + pos - w0] = 'N';
      }
      if (__any_sync(kFull, bad) && lane == 0) s_bad = 1;
    }
    __syncthreads();
    const long long lo = A > w0 ? A : w0;
    for (long long u = w0 + 16LL * tid; u < w1; u += 16LL * kWriteThreads) {
      if (u >= lo && u + 16 <= w1) {
        *reinterpret_cast<uint4*>(a.out + u) = *reinterpret_cast<const uint4*>(text + (u - w0));
      } else {
        for (long long b = u; b < u + 16 && b < w1; ++b)
          if (b >= lo) a.out[b] = text[b - w0];
      }
    }
    __syncthreads();
  }
  if (tid == 0 && s_bad)
    atomicOr(reinterpret_cast<unsigned long long*>(a.info + 1),
             (unsigned long long)kFaultNposInvalid);
}

// Raises the write kernel's dynamic shared memory cap once per device.
cudaError_t ready_write() {
  static std::mutex mu;
  static std::set<int> raised;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  if (raised.count(dev)) return cudaSuccess;
  rc = cudaFuncSetAttribute((const void*)write_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kRowStage + 64 + 2 * (kSpanStage + 32) + kWindow);
  if (rc == cudaSuccess) raised.insert(dev);
  return rc;
}

inline long long uniform_stride(long long n, int w, long long r, long long vmax) {
  if (r <= 0 || n < (long long)w * r || (n - (long long)w * r) % r) return 0;
  const long long u = (n - (long long)w * r) / r;
  return u <= vmax ? u + w : 0;
}

// Raises the chain kernel's dynamic shared memory cap once per device.
cudaError_t ready_chain() {
  static std::mutex mu;
  static std::set<int> raised;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  if (raised.count(dev)) return cudaSuccess;
  rc = cudaFuncSetAttribute((const void*)chain_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, 5 * kChainMaxTile);
  if (rc == cudaSuccess) raised.insert(dev);
  return rc;
}

}  // namespace

extern "C" {

// text: n bytes, 16-byte aligned. scratch: the bytes ops/records.py
// records_scan_scratch gives. offsets: (max_records, 8) int64; qmin:
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

// out: (rows, width) uint8, 16-byte aligned. Row i < r is data[starts[i*ss]
// ..][: lens[i*ls]] cut at width, then fill; rows past r are fill, and so is
// every byte outside [0, data_n). starts == null: the runs lie back to back
// from 0 (the scan of the raw lengths), and out2 (rows, width2), if not
// null, gets the runs of (lens + 3) >> 2 bytes back to back in data2 the
// same way. One launch of ceil(rows / tile_rows) CTAs (none for no rows or
// no bytes); ticket: one u32, 0 before the first launch on a stream and left
// at 0 by every launch; status: kStatusWords u64 per tile, zeroed once;
// epoch: a number this stream's launches have not used (>= 1).
int fq_rows_gather(const void* data, long long data_n, const void* starts, long long ss,
                   const void* lens, long long ls, long long r, long long rows, long long width,
                   int fill, const void* data2, long long data2_n, long long width2, void* out2,
                   int tile_rows, void* ticket, void* status, long long epoch, void* out,
                   void* stream) {
  const bool pair = out2 != nullptr;
  if (r < 0 || rows < r || width < 0 || width2 < 0 || tile_rows < 1 ||
      tile_rows > kGatherMaxRows || (pair && starts) || epoch < 1 ||
      ((uintptr_t)out | (uintptr_t)out2) % 16)
    return (int)cudaErrorInvalidValue;
  if (!rows || (!width && !(pair && width2))) return 0;
  GatherArgs a;
  a.m[0] = {(const uint8_t*)data, data_n, width, (uint8_t*)out};
  a.m[1] = {(const uint8_t*)data2, pair ? data2_n : 0, pair ? width2 : 0, (uint8_t*)out2};
  a.pair = pair;
  a.starts = (const long long*)starts;
  a.ss = ss;
  a.lens = (const long long*)lens;
  a.ls = ls;
  a.r = r;
  a.rows = rows;
  a.tile_rows = tile_rows;
  a.fill = (uint8_t)fill;
  a.ticket = (unsigned*)ticket;
  a.status = (unsigned long long*)status;
  a.epoch = (unsigned long long)epoch;
  gather_kernel<<<grid_for(rows, tile_rows), kGatherThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The six raw streams of n records (offsets (n, 8) from the scan) into out,
// back to back at the byte sizes s_seq .. s_len; packed / qual_delta / nmask
// rows at their pitches, n_counts per record; wide: u32 N positions.
// scratch: the bytes ops/records.py streams_build_scratch gives. info: 2
// int64, the npos and seq bytes written.
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

// seq_rows / qual_rows: (r, pitch) ASCII rows of the dense decode; lengths:
// r int64; the header, plus (has_plus 0: bare '+', v1) and npos streams,
// each with the nodes per tile of its chain (a power of two, 1,024 to
// 16,384); len_n, seq_n, qual_n: the sizes of the lengths, sequence and
// quality streams. checks: CTAs of the check kernel; tile_records: records
// per CTA of the write kernel. scratch: the bytes ops/records.py
// assemble_scratch gives; ticket, status, epoch: as fq_rows_gather's. out:
// cap bytes, 16-byte aligned; info: 2 int64, the text's bytes and the fault
// flags. Three launches.
int fq_fastq_assemble(const void* seq_rows, const void* qual_rows, long long pitch,
                      const void* lengths, long long r, const void* hdr, long long hdr_n,
                      int hdr_tile, const void* plus, long long plus_n, int has_plus,
                      int plus_tile, const void* npos, long long npos_n, int wide, int npos_tile,
                      long long len_n, long long seq_n, long long qual_n, int checks,
                      int tile_records, void* scratch, void* out, long long cap, void* info,
                      void* ticket, void* status, long long epoch, void* stream) {
  const int unit = wide ? 4 : 2;
  const long long nodes[3] = {hdr_n, has_plus ? plus_n : 0, npos_n / unit};
  const int tiles_of[3] = {hdr_tile, plus_tile, npos_tile};
  if (r <= 0 || r > kNodeLimit || checks < 1 || tile_records < 1 ||
      tile_records > kWriteMaxRecords || epoch < 1 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Assemble a;
  const uint8_t* data[3] = {(const uint8_t*)hdr, (const uint8_t*)plus, (const uint8_t*)npos};
  const long long vmax[3] = {0xFFFF, 0xFFFF, wide ? 0xFFFFFFFFLL : 0xFFFF};
  a.slots = (long long*)scratch;
  char* at = (char*)scratch + align256(8LL * kSlotWords * checks);
  int first = 0, max_tile = kChainMinTile;
  // the N positions' tiles take the first tickets: that chain is resolved
  // tile after tile, beside the header and plus tiles
  for (int y : {2, 0, 1}) {
    Chain& c = a.c[y];
    const int tile = tiles_of[y];
    c.data = data[y];
    c.n = nodes[y];
    c.unit = y == 2 ? unit : 1;
    c.w = y == 2 ? 1 : 2;
    c.active = y != 1 || has_plus;
    if (c.active && (c.n < 0 || c.n > kNodeLimit || tile < kChainMinTile ||
                     tile > kChainMaxTile || (tile & (tile - 1))))
      return (int)cudaErrorInvalidValue;
    c.stride = c.active ? uniform_stride(c.n, c.w, r, vmax[y]) : 0;
    c.tile = tile;
    c.tiles = c.active ? (int)(c.n / tile + 1) : 0;
    c.first = first;
    first += c.tiles;
    if (c.active && tile > max_tile) max_tile = tile;
  }
  for (int y = 0; y < 3; ++y) {
    a.c[y].cur = (int*)at;
    at += align256(4 * (r + 1));
  }
  a.seq_rows = (const uint8_t*)seq_rows;
  a.qual_rows = (const uint8_t*)qual_rows;
  a.pitch = pitch;
  a.lengths = (const long long*)lengths;
  a.r = r;
  a.len_n = len_n;
  a.seq_n = seq_n;
  a.qual_n = qual_n;
  a.has_plus = has_plus;
  a.odd_npos = !wide && (npos_n & 1);
  a.checks = checks;
  a.tile_records = tile_records;
  a.stage_rows = 2LL * tile_records * pitch <= kRowStage;
  a.out = (uint8_t*)out;
  a.cap = cap;
  a.info = (long long*)info;
  a.ticket = (unsigned*)ticket;
  a.status = (unsigned long long*)status;
  a.epoch = (unsigned long long)epoch;
  cudaError_t rc = ready_chain();
  if (rc == cudaSuccess) rc = ready_write();
  if (rc != cudaSuccess) return (int)rc;
  const long long region = ((long long)tile_records * pitch + 15) / 16 * 16 + 32;
  const int write_shared =
      (int)((a.stage_rows ? 2 * region : 0) + 2 * (kSpanStage + 32) + kWindow);
  assemble_check_kernel<<<checks, kCheckThreads, 0, s>>>(a);
  chain_kernel<<<first, kChainThreads, 5 * max_tile, s>>>(a);
  write_kernel<<<grid_for(r, tile_records), kWriteThreads, write_shared, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
