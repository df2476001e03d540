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
// one thread; here nothing runs on one thread or one CTA alone: where a
// stage needs a prefix over the whole block, its CTAs take their tiles by
// ticket and get the tiles before them by a decoupled look-back (Merrill &
// Garland), and where it needs the block's sums, the last CTA to finish
// combines every CTA's partials.
// - The record scan is two launches and reads the text twice. The newline
//   pass counts and places the newlines in one read: persistent CTAs take
//   32 KiB tiles by ticket, each held in registers (a lane 8 coalesced
//   16-byte units, exact SWAR byte compares) while the CTA's next tile
//   arrives in shared memory by cp.async; the newlines are ranked by warp
//   scans, the tile's line index comes from a look-back by the whole CTA
//   over the tiles before it (tile_prefix_cta: up to 256 tiles' words a
//   round, down to the nearest tile whose inclusive sum is out), and each
//   newline's position is written at its line index (the first
//   4 * max_records); the last tile writes the text's line count. The records pass gives a group of 4 lanes to each record, eight
//   records a warp at once: lanes load the record's line bounds (the next
//   round's while this one is processed), the bytes each check needs and
//   16-byte aligned units of the bases and qualities, masked to the line at
//   its two end units only, for the quality minimum and the ambiguous bases.
//   Its grid is what the card holds at once; each CTA writes its partial
//   sums, and the last one (a ticket counter) writes every info slot. Bytes
//   bound it: the text from device memory, then again (mostly from L2) for
//   the lines; the run is latency-bound (dependent loads per record).
// - The stream build is one launch: a CTA per tile of up to 128 records
//   forms each record's five field sizes in registers and their exclusive
//   prefix in the CTA, publishes the tile's sums, and builds its six ranges
//   in a shared-memory window while the tiles before it publish theirs: a
//   group of 8 lanes per record copies the record's pieces (head bytes,
//   aligned 16-byte units and tail bytes of its packed row, quality row and
//   header and plus payloads, each read as aligned words realigned by funnel
//   shifts, two jobs a lane loaded before any is stored; partial words or-ed
//   into the zeroed window by shared atomics), its computed fields and its
//   N positions (the mask's set bits ranked by a scan over the group). Then
//   a look-back by the whole CTA places the tile in the buffer, and the CTA
//   stores the window in aligned 16-byte units (bytes where a range starts
//   or ends inside a unit). The tile that takes the last ticket writes info.
// - the row gather is one launch: a CTA per tile of rows writes the tile's
//   rows x width output bytes, which are contiguous, in 16-byte units (8-
//   or 4-byte ones where the width asks), each read as aligned words of the
//   source realigned by funnel shifts; runs back to back from 0 (the decode)
//   get their starts from the tile's scan of the lengths and a decoupled
//   look-back over the tiles before it; one launch can gather a second
//   matrix of (length + 3) / 4 bytes a row from a second source (the
//   decode's packed bases beside its qualities);
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
// scratch its wrapper sized, and a ticket word and status words that
// persist across launches on one stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <set>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;             // threads per CTA of the scan (8 warps)
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;                 // 16-byte units per lane of the newline pass
constexpr long long kTile = 32768;        // text bytes per CTA of the newline pass
constexpr int kScanCtasPerSm = 8;         // the records pass's grid at most, per SM
constexpr int kRecordsMinCtas = 1;        // the records pass's CTAs per SM to fit registers for
constexpr int kGroup = 4;                 // lanes per record of the records pass
constexpr int kRecordsPerWarp = 32 / kGroup;
static_assert(kGroup >= 4 && kGroup <= 8 && 32 % kGroup == 0,
              "a lane per line, a group per record");
constexpr int kPass = 8;                  // 16-byte units a lane loads at once in the records pass
constexpr long long kNone = 0x7fffffffffffffffLL;
constexpr long long kV2NposLimit = 1LL << 16;
constexpr int kEmptyQmin = 256;

static_assert(kTile == 16LL * kUnits * kThreads, "a lane holds kUnits units of its tile");

// fq_records_scan's info slots (ops/records.py SCAN_*)
enum {
  kCount = 0, kConsumed, kError, kErrorLine, kLines, kSeqSum, kSeqMax,
  kPackedSum, kHdrSum, kHdrMax, kPlusSum, kPlusMax, kAmbig, kOverflowRow,
  kInfoSlots = 16
};
// the records pass's partials per CTA: five sums, three maxima, two minima
enum {
  kPartSeq = 0, kPartPacked, kPartHdr, kPartPlus, kPartAmbig, kPartSeqMax, kPartHdrMax,
  kPartPlusMax, kPartBad, kPartFar
};
constexpr int kParts = 10;
static_assert(kPartFar + 1 == kParts, "kParts partials per CTA");
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

__device__ inline long long warp_min_ll(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ inline long long warp_max(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Inclusive prefix of v over the 32 lanes of a warp.
template <typename T>
__device__ inline T warp_incl(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Exclusive prefixes of N values over the CTA (blockDim.x a multiple of 32,
// at most 1,024 threads), each in ex[k]; total[k] gets the CTA's sums. sh:
// 33 * N shared slots. Every thread must call it.
template <int N>
__device__ void block_excl_n(const long long (&v)[N], long long (&ex)[N], long long (&total)[N],
                             long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  long long incl[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    incl[k] = warp_incl(v[k]);
    if (lane == 31) sh[33 * k + warp] = incl[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const long long w = lane < nw ? sh[33 * k + lane] : 0;
      const long long wi = warp_incl(w);
      if (lane < nw) sh[33 * k + lane] = wi - w;
      if (lane == 31) sh[33 * k + 32] = wi;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ex[k] = sh[33 * k + warp] + incl[k] - v[k];
    total[k] = sh[33 * k + 32];
  }
  __syncthreads();  // sh is reused by the next call
}

// Exclusive prefix of v over the CTA; *total gets the CTA's sum. sh: 33
// shared slots. Every thread must call it.
__device__ inline long long block_excl(long long v, long long* total, long long* sh) {
  const long long in[1] = {v};
  long long ex[1], tot[1];
  block_excl_n<1>(in, ex, tot, sh);
  *total = tot[0];
  return ex[0];
}

inline unsigned grid_for(long long items, int per_cta) {
  const long long g = (items + per_cta - 1) / per_cta;
  return (unsigned)(g < 1 ? 1 : g);
}

// ---------------------------------------------------------------------------
// tickets and status words (the newline pass, the row gather, the stream
// build and the assembly)
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
constexpr int kStatusWords = 16;
constexpr int kSums = 5;
constexpr unsigned long long kAggregate = 1, kInclusive = 2;
static_assert(2 + 2 * kSums <= kStatusWords, "flag, sums and the hand-off word fit a tile's words");

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

// The CTA's tile, from the ticket counter, which goes back to 0 after the
// ticket `last` (a launch takes last + 1 tickets in all). Every thread must
// call it.
__device__ inline long long take_ticket(unsigned* ticket, unsigned last) {
  __shared__ unsigned s_ticket;
  __syncthreads();  // s_ticket of the CTA's previous ticket has been read
  if (threadIdx.x == 0) s_ticket = atomicInc(ticket, last);
  __syncthreads();
  return (long long)s_ticket;
}

// A ticket per CTA.
__device__ inline long long take_ticket(unsigned* ticket) {
  return take_ticket(ticket, gridDim.x - 1);
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
  static_assert(N <= kSums, "a tile publishes at most kSums sums");
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

// The exclusive prefix over the tiles of a launch, as tile_prefix, but the
// whole CTA looks back, a tile a thread: each round reads blockDim.x tiles
// at once (each thread waits for its tile's aggregate, which every tile
// publishes before it looks back) and combines them down to the nearest
// inclusive one, so a tile far from the nearest inclusive tile waits
// tile / blockDim.x round trips, not tile / 32. Sums only. sh: 33 * N
// shared slots; `published`: the tile's aggregate is out already. Every
// thread must call it.
template <int N>
__device__ void tile_prefix_cta(unsigned long long* status, long long tile,
                                unsigned long long epoch, const long long (&v)[N],
                                long long (&pre)[N], long long* sh, bool published = false) {
  static_assert(N <= kSums, "a tile publishes at most kSums sums");
  __shared__ int s_near;
#pragma unroll
  for (int k = 0; k < N; ++k) pre[k] = 0;
  if (tile > 0) {
    if (threadIdx.x == 0 && !published) publish(status, tile, epoch, kAggregate, v);
    for (long long end = tile; end > 0; end -= blockDim.x) {
      const long long j = end - 1 - threadIdx.x;
      unsigned long long state = 0;
      if (j >= 0) {
        do {
          const unsigned long long f = ld_acquire(status + j * kStatusWords);
          state = (f >> 2) == epoch ? (f & 3) : 0;
        } while (!state);
      }
      if (threadIdx.x == 0) s_near = blockDim.x;
      __syncthreads();
      if (state == kInclusive) atomicMin(&s_near, (int)threadIdx.x);
      __syncthreads();
      const int near = s_near;
      long long x[N], ex[N], tot[N];
      const bool mine = j >= 0 && (int)threadIdx.x <= near;
      const unsigned long long* sums =
          status + (mine ? j : 0) * kStatusWords + (state == kInclusive ? 1 + kSums : 1);
#pragma unroll
      for (int k = 0; k < N; ++k) x[k] = mine ? (long long)ld_relaxed(sums + k) : 0;
      block_excl_n<N>(x, ex, tot, sh);
#pragma unroll
      for (int k = 0; k < N; ++k) pre[k] += tot[k];
      if (near < (int)blockDim.x) break;  // uniform: the nearest inclusive tile is in
    }
  }
  if (threadIdx.x == 0) {
    long long inc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) inc[k] = pre[k] + v[k];
    publish(status, tile, epoch, kInclusive, inc);
  }
}

// ---------------------------------------------------------------------------
// 1. record scan
// ---------------------------------------------------------------------------

struct ScanArgs {
  const uint8_t* text;  // 16-byte aligned
  long long n;
  long long cap;        // 4 * max_records: lines looked at
  long long* total;     // the text's newlines (the newline pass's last tile)
  long long* nl;        // each newline's position at its line index, the first cap
  long long tiles;      // the newline pass's tiles
  long long* parts;     // kParts x gridDim.x partials of the records pass
  long long* offsets;
  int16_t* qmin;
  long long* info;
  unsigned* ticket;
  unsigned long long* status;
  unsigned long long epoch;
};

// 0x80 in each byte of w equal to the byte of cc (replicated), 0 elsewhere:
// exact, no carry crosses a byte.
__device__ inline uint32_t eq_bytes(uint32_t w, uint32_t cc) {
  const uint32_t y = w ^ cc;
  return ~(((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y | 0x7F7F7F7Fu);
}

constexpr uint32_t kNewlines = 0x0a0a0a0au;

// Bit b set where byte b of the 16-byte unit q is a newline.
__device__ inline unsigned mask16(const uint4& q) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)  // the 0x80 bits of a word to bits 0-3
    m |= (((eq_bytes(w[k], kNewlines) >> 7) * 0x00204081u) >> 21 & 0xfu) << (4 * k);
  return m;
}

static_assert(kUnits == 8, "pick8 picks a lane's unit");
__device__ inline int pick8(const int (&v)[8], int i) {
  return i < 4 ? (i < 2 ? (i == 0 ? v[0] : v[1]) : (i == 2 ? v[2] : v[3]))
               : (i < 6 ? (i == 4 ? v[4] : v[5]) : (i == 6 ? v[6] : v[7]));
}

__device__ inline int newlines16(const uint4& q) {
  return __popc(eq_bytes(q.x, kNewlines)) + __popc(eq_bytes(q.y, kNewlines)) +
         __popc(eq_bytes(q.z, kNewlines)) + __popc(eq_bytes(q.w, kNewlines));
}

// The 16 bytes at i (16-byte aligned) of the text, 0 past its end.
__device__ inline uint4 text_unit(const uint8_t* __restrict__ text, long long n, long long i) {
  if (i + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(text + i));
  uint32_t w[4] = {0, 0, 0, 0};
  for (int b = 0; b < 16 && i + b < n; ++b) w[b >> 2] |= (uint32_t)text[i + b] << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

// The newline pass. Persistent CTAs take kTile-byte tiles of the text by
// ticket (a.tiles in all); warp w holds the tile's w-th 4 KiB in registers,
// lane l its units k * 32 + l (k < kUnits), so each load instruction of a
// warp reads 512 contiguous bytes. While a CTA counts its tile, looks back
// and writes its newlines, the next tile it took arrives in shared memory
// by cp.async. A newline's line index is the tile's (the sum of every tile
// before it, by a look-back of the whole CTA), its warp's, the units before its unit (warp sums)
// and the lanes before it in its unit row (warp scan). Only the first cap
// lines are written; the last tile writes the text's line count.
__global__ void __launch_bounds__(kThreads) newlines_kernel(ScanArgs a) {
  __shared__ __align__(16) uint4 s_next[kTile / 16];
  __shared__ long long s_warp[kWarps];
  __shared__ long long sh[33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned last = (unsigned)(a.tiles + gridDim.x - 1);
  const long long lead = (long long)warp * (kTile / kWarps) + 16LL * lane;
  long long tile = take_ticket(a.ticket, last);
  uint4 q[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) q[k] = text_unit(a.text, a.n, tile * kTile + lead + 512LL * k);
  while (tile < a.tiles) {
    const long long next = take_ticket(a.ticket, last);
    if (next < a.tiles) {
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const long long i = next * kTile + lead + 512LL * k;
        if (i + 16 <= a.n) cp_async16(&s_next[(lead + 512LL * k) >> 4], a.text + i);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    const long long base = tile * kTile + (long long)warp * (kTile / kWarps);
    int ex[kUnits], run = 0;
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int c = newlines16(q[k]);
      const int incl = warp_incl(c);
      ex[k] = run + incl - c;
      run += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) s_warp[warp] = run;
    __syncthreads();
    long long before = 0, sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? s_warp[w] : 0;
      sum += s_warp[w];
    }
    const long long v[1] = {sum};
    long long p[1];
    tile_prefix_cta<1>(a.status, tile, a.epoch, v, p, sh);
    const long long pre = p[0];
    if (threadIdx.x == 0 && tile == a.tiles - 1) *a.total = pre + sum;
    if (pre < a.cap) {  // uniform over the CTA
      // the lane's newlines, unit by unit, from a 16-bit mask of each unit
      unsigned long long m[2] = {0, 0};
#pragma unroll
      for (int k = 0; k < kUnits; ++k)
        m[k >> 2] |= (unsigned long long)mask16(q[k]) << (16 * (k & 3));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        for (unsigned long long rest = m[h]; rest; rest &= rest - 1) {
          const int bit = __ffsll(rest) - 1, k = 4 * h + (bit >> 4);
          const unsigned unit_bits = (unsigned)(m[h] >> (bit & ~15)) & 0xffffu;
          const long long at =
              pre + before + pick8(ex, k) + __popc(unit_bits & ((1u << (bit & 15)) - 1));
          if (at < a.cap) a.nl[at] = base + 16LL * (k * 32 + lane) + (bit & 15);
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    if (next < a.tiles) {
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const long long i = next * kTile + lead + 512LL * k;
        q[k] = i + 16 <= a.n ? s_next[(lead + 512LL * k) >> 4] : text_unit(a.text, a.n, i);
      }
    }
    tile = next;
  }
}

// 0xff in each byte of word k (bytes 4k .. 4k + 3) of a 16-byte unit that
// lies in [b, e) (0 <= b, e <= 16), 0 elsewhere.
__device__ inline uint32_t word_mask(int b, int e, int k) {
  const int lo = min(max(b - 4 * k, 0), 4), hi = min(max(e - 4 * k, 0), 4);
  const uint32_t below_hi = hi >= 4 ? kFull : (1u << (8 * hi)) - 1;
  const uint32_t below_lo = lo >= 4 ? kFull : (1u << (8 * lo)) - 1;
  return below_hi & ~below_lo;
}

// 0x80 in each byte of w that is not an ACGT base (either case).
__device__ inline uint32_t ambiguous4(uint32_t w) {
  const uint32_t u = w & 0xDFDFDFDFu;
  return ~(eq_bytes(u, 0x41414141u) | eq_bytes(u, 0x43434343u) | eq_bytes(u, 0x47474747u) |
           eq_bytes(u, 0x54545454u)) & 0x80808080u;
}

// A record's line bounds, two values a lane: lane k < 4 of its group the
// end of line 4 rec + k - 1 (-1 before the text and past `lines`), lane 0
// also that of line 4 rec + 3.
struct Bounds {
  long long x, y;
};

__device__ inline Bounds record_bounds(const ScanArgs& a, long long rec, long long lines,
                                       int sub) {
  const long long line = 4 * rec - 1 + sub;
  Bounds b;
  b.x = sub < 4 && line >= 0 && line < lines ? a.nl[line] : -1;
  b.y = sub == 0 && 4 * rec + 3 < lines ? a.nl[4 * rec + 3] : -1;
  return b;
}

__device__ inline long long pick4(const long long (&v)[4], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : (i == 2 ? v[2] : v[3]));
}

// The address of unit u of a record's bases (u < us) or qualities: 16-byte
// aligned units that cover each line.
__device__ inline long long unit_at(long long u, long long us, long long st1, long long st3) {
  return u < us ? ((st1 >> 4) + u) << 4 : ((st3 >> 4) + u - us) << 4;
}

// The sum, the maximum or the minimum of v over the kGroup lanes of a group
// (every lane of the warp calls it; v is the same in all lanes after).
__device__ inline long long group_sum(long long v) {
#pragma unroll
  for (int o = kGroup / 2; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ inline unsigned group_min(unsigned v) {
#pragma unroll
  for (int o = kGroup / 2; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ inline unsigned group_or(unsigned v) {
#pragma unroll
  for (int o = kGroup / 2; o; o >>= 1) v |= __shfl_xor_sync(kFull, v, o);
  return v;
}

// A group of kGroup lanes per record (kRecordsPerWarp records a warp at
// once), striding over the records; the warp's lanes all run every step (a
// group past the records idles), so shuffles, ballots and reductions need
// no divergent masks. Line bounds come from the newline positions (loaded a
// round ahead), then one round of loads a record: lane li < 4 of the group
// line li's last byte (a '\r'?) and first byte, and every lane up to kPass
// 16-byte units of the bases and qualities
// (each line with its '\r', masked to the line's length at its two end units
// only); the checks, offsets, quality minimum and ambiguous bases (exact
// SWAR byte compares). The groups' sums are combined per CTA into parts, and
// the last CTA to finish writes every info slot.
__global__ void __launch_bounds__(kThreads, kRecordsMinCtas) records_kernel(ScanArgs a) {
  __shared__ long long s_part[kWarps][kParts];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % kGroup, grp = lane / kGroup;
  const long long lines = min(*a.total, a.cap);
  const long long nrec = (lines + 3) / 4;
  const long long stride = (long long)gridDim.x * kWarps * kRecordsPerWarp;
  long long p[kParts];
#pragma unroll
  for (int k = 0; k < kParts; ++k) p[k] = k >= kPartBad ? kNone : 0;
  long long first = ((long long)blockIdx.x * kWarps + warp) * kRecordsPerWarp;  // the warp's
  Bounds next = {-1, -1};
  if (first + grp < nrec) next = record_bounds(a, first + grp, lines, sub);
  for (; first < nrec; first += stride) {
    const long long rec = first + grp;
    const Bounds cur = next;
    if (first + stride + grp < nrec) next = record_bounds(a, first + stride + grp, lines, sub);
    const int have = rec < nrec ? (int)min(4LL, lines - rec * 4) : 0;
    long long st[4], en[4];
#pragma unroll
    for (int li = 0; li < 4; ++li) {
      st[li] = __shfl_sync(kFull, cur.x, li, kGroup) + 1;
      en[li] = li < 3 ? __shfl_sync(kFull, cur.x, li + 1, kGroup)
                      : __shfl_sync(kFull, cur.y, 0, kGroup);
    }
    // lane li < 4 of the group: line li's last byte (a '\r'?) and first byte
    const int li = sub & 3;
    const long long my_st = pick4(st, li), my_en = pick4(en, li);
    int last = 0, head = 0;
    if (sub < 4 && li < have && my_en > my_st) {
      last = a.text[my_en - 1];
      head = a.text[my_st];
    }
    const long long us = have == 4 && en[1] > st[1] ? ((en[1] + 15) >> 4) - (st[1] >> 4) : 0;
    const long long uq = have == 4 && en[3] > st[3] ? ((en[3] + 15) >> 4) - (st[3] >> 4) : 0;
    const long long units = us + uq;
    uint4 q[kPass];
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      const long long u = sub + (long long)kGroup * j;
      const uint4* at = reinterpret_cast<const uint4*>(a.text + unit_at(u, us, st[1], st[3]));
      q[j] = u < units ? __ldg(at) : make_uint4(0, 0, 0, 0);
    }
    const unsigned cr = (__ballot_sync(kFull, sub < 4 && last == '\r') >> (kGroup * grp)) & 15;
    const int first0 = __shfl_sync(kFull, head, 0, kGroup);
    const int first2 = __shfl_sync(kFull, head, 2, kGroup);
    long long len[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) len[k] = k < have ? en[k] - st[k] - ((cr >> k) & 1) : 0;
    if (have) {
      long long bad = kNone;
      if (len[0] == 0 || first0 != '@') bad = rec * 4;
      else if (have > 2 && (len[2] == 0 || first2 != '+')) bad = rec * 4 + 2;
      else if (have == 4 && len[1] != len[3]) bad = rec * 4 + 3;
      p[kPartBad] = min(p[kPartBad], bad);
    }
    if (have == 4) {
#pragma unroll
      for (int c = sub; c < 8; c += kGroup) {
        const int f = c >> 1;
        const long long strip = (f == 0 || f == 2) ? 1 : 0;
        a.offsets[rec * 8 + c] = (c & 1) ? pick4(len, f) - strip : pick4(st, f) + strip;
      }
    }
    // quality minimum (bytes off the line read as 0xff) and ambiguous bases;
    // a record of more than kGroup * kPass units loops, the warp with it
    uint32_t mn4 = kFull;
    unsigned amb = 0, far = 0;
    const long long most = __reduce_max_sync(kFull, (unsigned)min(units, 0x7fffffffLL));
    for (long long u0 = 0; u0 < most; u0 += (long long)kGroup * kPass) {
      if (u0) {
#pragma unroll
        for (int j = 0; j < kPass; ++j) {
          const long long u = u0 + sub + (long long)kGroup * j;
          if (u < units)
            q[j] = __ldg(reinterpret_cast<const uint4*>(a.text + unit_at(u, us, st[1], st[3])));
        }
      }
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        const long long u = u0 + sub + (long long)kGroup * j;
        if (u >= units) continue;
        const long long a0 = unit_at(u, us, st[1], st[3]);
        const bool seq = u < us;
        const long long lo = seq ? st[1] : st[3], hi = lo + (seq ? len[1] : len[3]);
        const uint32_t w[4] = {q[j].x, q[j].y, q[j].z, q[j].w};
        uint32_t m[4] = {kFull, kFull, kFull, kFull};
        if (a0 < lo || a0 + 16 > hi) {  // the line's first or last unit
          const int b = (int)max(min(lo - a0, 16LL), 0LL), e = (int)max(min(hi - a0, 16LL), 0LL);
#pragma unroll
          for (int k = 0; k < 4; ++k) m[k] = word_mask(b, e, k);
        }
        if (seq) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t hit = ambiguous4(w[k]) & m[k];
            amb += __popc(hit);
            if (len[1] > kV2NposLimit && a0 + 4 * k + 4 > lo + kV2NposLimit) {
              const int b = (int)max(min(lo + kV2NposLimit - a0, 16LL), 0LL);
              far |= hit & word_mask(b, 16, k);
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) mn4 = __vminu4(mn4, w[k] | ~m[k]);
        }
      }
    }
    unsigned mn = min(min(mn4 & 0xff, (mn4 >> 8) & 0xff), min((mn4 >> 16) & 0xff, mn4 >> 24));
    mn = group_min(mn);
    const long long ambs = group_sum(amb);
    far = group_or(far);
    if (have == 4) {
      if (sub == 0) a.qmin[rec] = (int16_t)(len[3] ? (int)mn : kEmptyQmin);
      const long long hl = max(len[0] - 1, 0LL), pl = max(len[2] - 1, 0LL);
      p[kPartSeq] += len[1];
      p[kPartPacked] += (len[1] + 3) >> 2;
      p[kPartHdr] += hl;
      p[kPartPlus] += pl;
      p[kPartAmbig] += ambs;
      p[kPartSeqMax] = max(p[kPartSeqMax], len[1]);
      p[kPartHdrMax] = max(p[kPartHdrMax], hl);
      p[kPartPlusMax] = max(p[kPartPlusMax], pl);
      if (far) p[kPartFar] = min(p[kPartFar], rec);
    }
  }
  // the groups' partials (the same in every lane of a group) into the
  // warp's, the CTA's, then parts
  if (sub)
#pragma unroll
    for (int k = 0; k < kParts; ++k) p[k] = k >= kPartBad ? kNone : 0;
#pragma unroll
  for (int k = 0; k < kParts; ++k)
    p[k] = k < kPartSeqMax ? warp_sum(p[k]) : (k < kPartBad ? warp_max(p[k]) : warp_min_ll(p[k]));
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < kParts; ++k) s_part[warp][k] = p[k];
  __syncthreads();
  const int t = threadIdx.x;
  if (t < kParts) {
    long long x = s_part[0][t];
    for (int w = 1; w < kWarps; ++w) {
      const long long y = s_part[w][t];
      x = t < kPartSeqMax ? x + y : (t < kPartBad ? max(x, y) : min(x, y));
    }
    a.parts[(long long)t * gridDim.x + blockIdx.x] = x;
  }
  __threadfence();  // this CTA's parts before its ticket
  __syncthreads();
  if (t == 0) s_last = atomicInc(a.ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last CTA: every CTA's parts, combined
#pragma unroll
  for (int k = 0; k < kParts; ++k) p[k] = k >= kPartBad ? kNone : 0;
  for (long long j = t; j < gridDim.x; j += kThreads) {
#pragma unroll
    for (int k = 0; k < kParts; ++k) {
      const long long y = __ldcg(a.parts + (long long)k * gridDim.x + j);
      p[k] = k < kPartSeqMax ? p[k] + y : (k < kPartBad ? max(p[k], y) : min(p[k], y));
    }
  }
#pragma unroll
  for (int k = 0; k < kParts; ++k)
    p[k] = k < kPartSeqMax ? warp_sum(p[k]) : (k < kPartBad ? warp_max(p[k]) : warp_min_ll(p[k]));
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < kParts; ++k) s_part[warp][k] = p[k];
  __syncthreads();
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < kParts; ++k) {
      long long x = s_part[0][k];
      for (int w = 1; w < kWarps; ++w) {
        const long long y = s_part[w][k];
        x = k < kPartSeqMax ? x + y : (k < kPartBad ? max(x, y) : min(x, y));
      }
      p[k] = x;
    }
    const long long count = lines / 4, e = p[kPartBad];
    long long* info = a.info;
    info[kCount] = count;
    info[kConsumed] = count ? a.nl[4 * count - 1] + 1 : 0;
    info[kError] = e == kNone ? 0 : (e % 4 == 0 ? 1 : (e % 4 == 2 ? 2 : 3));
    info[kErrorLine] = e;
    info[kLines] = lines;
    info[kSeqSum] = p[kPartSeq];
    info[kSeqMax] = p[kPartSeqMax];
    info[kPackedSum] = p[kPartPacked];
    info[kHdrSum] = p[kPartHdr];
    info[kHdrMax] = p[kPartHdrMax];
    info[kPlusSum] = p[kPartPlus];
    info[kPlusMax] = p[kPartPlusMax];
    info[kAmbig] = p[kPartAmbig];
    info[kOverflowRow] = p[kPartFar];
    for (int k = kOverflowRow + 1; k < kInfoSlots; ++k) info[k] = 0;
  }
}

inline long long scan_tiles(long long n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }

// CTAs of `threads` threads of `kernel` that the current device holds at
// once (at most kScanCtasPerSm an SM), queried once per device and kernel.
long long resident_ctas(const void* kernel, int threads) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, int> per_sm;
  int dev = 0, occ = 1;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    std::lock_guard<std::mutex> lock(mu);
    auto it = per_sm.find({dev, kernel});
    if (it != per_sm.end()) {
      occ = it->second;
    } else if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, 0) ==
                   cudaSuccess && occ > 0) {
      per_sm[{dev, kernel}] = occ;
    } else {
      occ = 1;
    }
  }
  return (long long)(occ < kScanCtasPerSm ? occ : kScanCtasPerSm) * sm_count();
}

// The records pass's grid: kWarps * kRecordsPerWarp records a CTA at once,
// at most what the card holds at once (the CTAs then stride), at most
// `most` CTAs (the parts' room).
unsigned records_grid(long long max_records, long long most) {
  const long long per_cta = (long long)kWarps * kRecordsPerWarp;
  long long g = (max_records + per_cta - 1) / per_cta;
  const long long resident = resident_ctas((const void*)records_kernel, kThreads);
  g = g < resident ? g : resident;
  g = g < most ? g : most;
  return (unsigned)(g < 1 ? 1 : g);
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

constexpr int kStreamThreads = 256;
constexpr int kStreamMaxRecords = 128;  // records per tile of the stream build at most
constexpr int kStreamGroup = 8;         // lanes per record of the stream build
constexpr int kStreamBatch = 2;         // jobs a lane loads before it stores them
constexpr int kStreamWindow = 40960;    // dynamic shared bytes: the tile's six ranges
constexpr int kStreamMinCtas = 3;       // the stream build's CTAs per SM to fit registers for

struct StreamArgs {
  const uint8_t* text;
  const long long* offsets;  // (n, 8)
  long long n;
  const uint8_t* packed;
  long long pp;
  const uint8_t* qual;
  long long qp;
  const uint8_t* nmask;
  long long np;
  const int32_t* n_counts;
  int unit;                  // bytes per N position: 2, or 4 (wide)
  int tile_records;
  long long base[6];         // byte offset of each stream in the buffer
  long long end;             // the buffer's size
  uint8_t* out;              // 16-byte aligned
  long long* info;
  unsigned* ticket;
  unsigned long long* status;
  unsigned long long epoch;
};

// A tile's records in shared memory: where each record's bytes of each
// stream start (in the tile's range when the tile is staged in the window,
// else in the buffer), where its header and plus payloads lie in the text,
// its read length, payload lengths and N count; the six ranges.
struct StreamTile {
  long long at[6][kStreamMaxRecords];
  long long hdr[kStreamMaxRecords], plus[kStreamMaxRecords], len[kStreamMaxRecords];
  int hl[kStreamMaxRecords], pl[kStreamMaxRecords], cnt[kStreamMaxRecords];
  long long lo[6];     // where each stream's range of the tile starts in the buffer
  long long hi[6];     // its size: the limit of the records' offsets in the tile
  long long shift[6];  // where the range starts in the window
  long long used;      // the window's bytes in use
  int staged;          // the six ranges fit the window
};

// Where a record's bytes of stream k go: the tile's shared-memory window
// (kStaged; zeroed first, so a job's partial words are or-ed in by shared
// atomics and the bytes of other jobs in them stay), or the buffer itself
// (byte stores). Bytes past the range (the buffer) are dropped.
// The n bytes o (1 <= n <= 16, byte 0 at x) of stream k.
template <bool kStaged>
__device__ inline void sink_job(const StreamTile& t, uint8_t* win, uint8_t* out, long long end,
                                int k, long long x, int n, const uint32_t (&o)[4]) {
  const long long hi = kStaged ? t.hi[k] : end;
  if (x + n > hi) n = (int)(hi - x);
  if (n <= 0) return;
  if (!kStaged) {
    if (n == 16 && !(x & 15)) {
      *reinterpret_cast<uint4*>(out + x) = make_uint4(o[0], o[1], o[2], o[3]);
      return;
    }
#pragma unroll
    for (int q = 0; q < 16; ++q)
      if (q < n) out[x + q] = (uint8_t)(o[q >> 2] >> (8 * (q & 3)));
    return;
  }
  const long long wo = x + t.shift[k];
  if (n == 16 && !(wo & 15)) {
    *reinterpret_cast<uint4*>(win + wo) = make_uint4(o[0], o[1], o[2], o[3]);
    return;
  }
  // the bytes moved to their place in five aligned words, each or-ed in
  const unsigned sh = 8u * (unsigned)(wo & 3);
  const uint32_t w[5] = {o[0] << sh, __funnelshift_l(o[0], o[1], sh),
                         __funnelshift_l(o[1], o[2], sh), __funnelshift_l(o[2], o[3], sh),
                         __funnelshift_l(o[3], 0u, sh)};
  uint32_t* dst = reinterpret_cast<uint32_t*>(win + (wo & ~3LL));
  const int b = (int)(wo & 3), e = b + n;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const uint32_t m = word_mask(b, e, i);
    if (m) atomicOr(dst + i, w[i] & m);
  }
}

// The `unit`-byte little-endian v at x of stream k.
template <bool kStaged>
__device__ inline void sink_le(const StreamTile& t, uint8_t* win, uint8_t* out, long long end,
                               int k, long long x, unsigned long long v, int unit) {
  const uint32_t o[4] = {(uint32_t)v, (uint32_t)(v >> 32), 0, 0};
  sink_job<kStaged>(t, win, out, end, k, x, unit, o);
}

// A piece of a record: n bytes from src to the buffer at d. Its jobs are the
// bytes before its first aligned 16-byte unit (the head), each aligned unit
// inside it, and the bytes after its last one (the tail); a piece inside
// one unit is one job.
struct Piece {
  const uint8_t* src;
  long long d, n;
};

__device__ inline long long piece_jobs(const Piece& p) {
  if (p.n <= 0) return 0;
  const long long a = (p.d + 15) & ~15LL, e = (p.d + p.n) & ~15LL;
  return (a > p.d) + (e > a ? (e - a) >> 4 : 0) + ((e > a ? e : a) < p.d + p.n);
}

// Job i of piece p (branch-free): the buffer bytes [*x, *x + *k), *k = 16 at
// an aligned *x for a unit; *src the source of byte *x.
__device__ inline void piece_job(const Piece& p, long long i, long long* x, int* k,
                                 const uint8_t** src) {
  const long long a = (p.d + 15) & ~15LL, e = (p.d + p.n) & ~15LL, end = p.d + p.n;
  const long long h = a > p.d ? 1 : 0;
  const bool head = h && i == 0;
  const long long u = i - h, units = e > a ? (e - a) >> 4 : 0;
  const long long tail = e > a ? e : a;
  *x = head ? p.d : (u < units ? a + 16 * u : tail);
  *k = (int)(head ? (a < end ? a : end) - p.d : (u < units ? 16 : end - tail));
  *src = p.src + (*x - p.d);
}

// Piece w of four, field by field (no copy of the four to local memory).
__device__ inline Piece pick_piece(int w, const Piece& p0, const Piece& p1, const Piece& p2,
                                   const Piece& p3) {
  Piece p;
  p.src = w == 0 ? p0.src : (w == 1 ? p1.src : (w == 2 ? p2.src : p3.src));
  p.d = w == 0 ? p0.d : (w == 1 ? p1.d : (w == 2 ? p2.d : p3.d));
  p.n = w == 0 ? p0.n : (w == 1 ? p1.n : (w == 2 ? p2.n : p3.n));
  return p;
}

// The aligned 16-byte word of src and the next where the k bytes from src
// reach it (else the same word again); *off: src's offset in the first.
__device__ inline void load_job(const uint8_t* src, int k, int* off, uint4* lo, uint4* hi) {
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  *off = (int)(sa & 15);
  const uint4* base = reinterpret_cast<const uint4*>(sa - *off);
  *lo = __ldg(base);
  *hi = __ldg(base + (*off + k > 16 ? 1 : 0));
}

// The 16 bytes from byte off of the 32 bytes (lo, hi), as four words.
__device__ inline void realign16(const uint4& lo, const uint4& hi, int off, uint32_t (&o)[4]) {
  uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  if (off & 8) {
#pragma unroll
    for (int k = 0; k + 2 < 8; ++k) w[k] = w[k + 2];
  }
  if (off & 4) {
#pragma unroll
    for (int k = 0; k + 1 < 8; ++k) w[k] = w[k + 1];
  }
  const unsigned s = 8u * (unsigned)(off & 3);
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = __funnelshift_r(w[k], w[k + 1], s);
}

// The tile's records by groups of kStreamGroup lanes: their pieces, computed
// fields and N positions, into the window (kStaged) or the buffer.
template <bool kStaged>
__device__ void stream_records(const StreamArgs& a, const StreamTile& t, long long i0, int count,
                               uint8_t* win) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int sub = lane % kStreamGroup, grp = lane / kStreamGroup;
  constexpr int kPerWarp = 32 / kStreamGroup;
  constexpr int kGroups = kStreamThreads / kStreamGroup;
  const long long u = a.unit;
  // every lane of a warp runs each step (a group past the tile idles), so
  // the shuffles need no divergent masks
  for (int r0 = (tid >> 5) * kPerWarp; r0 < count; r0 += kGroups) {
    const int r = r0 + grp;
    const bool on = r < count;
    const int rr = on ? r : 0;
    const long long len = on ? t.len[rr] : 0, rec = i0 + rr;
    const Piece p0 = {a.packed + rec * a.pp, t.at[0][rr], (len + 3) >> 2};
    const Piece p1 = {a.qual + rec * a.qp, t.at[1][rr], len};
    const Piece p2 = {a.text + t.hdr[rr], t.at[2][rr] + 2, on ? t.hl[rr] : 0};
    const Piece p3 = {a.text + t.plus[rr], t.at[3][rr] + 2, on ? t.pl[rr] : 0};
    const long long f1 = piece_jobs(p0), f2 = f1 + piece_jobs(p1), f3 = f2 + piece_jobs(p2);
    const long long jobs = f3 + piece_jobs(p3);
    for (long long j0 = 0; j0 < jobs; j0 += (long long)kStreamGroup * kStreamBatch) {
      // every slot's two aligned source words are loaded before any is used
      uint4 lo[kStreamBatch], hi[kStreamBatch];
      long long x[kStreamBatch];
      int k[kStreamBatch], off[kStreamBatch], w[kStreamBatch];
#pragma unroll
      for (int b = 0; b < kStreamBatch; ++b) {
        const long long j = j0 + sub + (long long)kStreamGroup * b;
        w[b] = (j >= f1) + (j >= f2) + (j >= f3);
        const Piece pw = pick_piece(w[b], p0, p1, p2, p3);
        const long long before = w[b] == 0 ? 0 : (w[b] == 1 ? f1 : (w[b] == 2 ? f2 : f3));
        const uint8_t* src;
        piece_job(pw, j - before, &x[b], &k[b], &src);
        if (j >= jobs) {  // past the jobs: the offsets, a word it ignores
          k[b] = 0;
          src = reinterpret_cast<const uint8_t*>(a.offsets);
        }
        load_job(src, k[b], &off[b], &lo[b], &hi[b]);
      }
#pragma unroll
      for (int b = 0; b < kStreamBatch; ++b) {
        if (!k[b]) continue;
        uint32_t o[4];
        realign16(lo[b], hi[b], off[b], o);
        sink_job<kStaged>(t, win, a.out, a.end, w[b], x[b], k[b], o);
      }
    }
    // the computed fields, a lane each
    const long long cnt = on ? t.cnt[rr] : 0;
    if (on) {
      if (sub < 4) {
        const int k = 2 + sub;
        const unsigned long long v =
            sub == 0 ? t.hl[rr] : (sub == 1 ? t.pl[rr] : (sub == 2 ? cnt : len));
        const int width = sub == 2 ? a.unit : (sub == 3 ? 4 : 2);
        sink_le<kStaged>(t, win, a.out, a.end, k, t.at[k][rr], v, width);
      }
    }
    // N positions: four mask bytes a lane, ranked over the group
    const long long nbytes = cnt ? (len + 7) >> 3 : 0, at4 = t.at[4][rr];
    const uint8_t* mask = a.nmask + rec * a.np;
    long long carry = 0;
    const long long most = __reduce_max_sync(kFull, (unsigned)min(nbytes, 0x7fffffffLL));
    for (long long b0 = 0; b0 < most; b0 += 4LL * kStreamGroup) {
      const long long bi = b0 + 4LL * sub;
      uint32_t bits = 0;
      if (carry < cnt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t m = mask[bi + q < nbytes ? bi + q : nbytes - 1];
          bits |= (bi + q < nbytes ? m : 0u) << (8 * q);
        }
      }
      const int c = __popc(bits);
      int incl = c;
#pragma unroll
      for (int o = 1; o < kStreamGroup; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o, kStreamGroup);
        if (sub >= o) incl += y;
      }
      long long rank = carry + incl - c;
      for (uint32_t rest = bits; rest && rank < cnt; rest &= rest - 1, ++rank)
        sink_le<kStaged>(t, win, a.out, a.end, 4, at4 + u * (1 + rank),
                         (unsigned long long)(bi * 8 + __ffs(rest) - 1), a.unit);
      carry += __shfl_sync(kFull, incl, kStreamGroup - 1, kStreamGroup);
    }
  }
}

// One tile of a.tile_records records per CTA, tiles by ticket:
// 1. each record's bytes of the packed, quality, header and plus streams
//    and its N positions (in units), their exclusive prefix over the CTA
//    (where each record's bytes start in the tile's ranges) and sums (the
//    tile's aggregate, published at once);
// 2. a group of kStreamGroup lanes per record writes the record's pieces
//    (packed row, quality row, header and plus payloads: head bytes, aligned
//    16-byte units, tail bytes, each read as aligned words realigned by
//    funnel shifts, kStreamBatch jobs a lane loaded before any is stored),
//    its computed fields (u16 header and plus lengths, the N count, the u32
//    length), then its N positions (the set bits of its mask, ranked by a
//    scan over the group), into a shared-memory window that holds the
//    tile's six ranges, each from an aligned offset;
// 3. the look-back over the tiles before (by the whole CTA): where the
//    ranges start in the buffer; the CTA stores the window in aligned
//    16-byte units (two aligned window words realigned a unit), byte stores
//    where a range starts or ends inside a unit (the tile beside owns the
//    unit's other bytes).
// A tile whose ranges do not fit the window looks back first and writes the
// buffer in 2 directly (two records that share a unit each store their own
// bytes of it). The tile of the last ticket writes info.
__global__ void __launch_bounds__(kStreamThreads, kStreamMinCtas) streams_kernel(StreamArgs a) {
  extern __shared__ __align__(16) uint8_t win[];
  __shared__ StreamTile t;
  __shared__ long long sh[33 * 5];
  const long long tile = take_ticket(a.ticket);
  const long long i0 = tile * a.tile_records;
  const int count = (int)min((long long)a.tile_records, a.n - i0);
  const int tid = threadIdx.x;
  long long v[5] = {0, 0, 0, 0, 0};
  if (tid < count) {
    const long long* o = a.offsets + (i0 + tid) * 8;
    const long long len = o[3];
    const int hl = (int)o[1], pl = (int)o[5], cnt = a.n_counts[i0 + tid];
    t.hdr[tid] = o[0];
    t.plus[tid] = o[4];
    t.len[tid] = len;
    t.hl[tid] = hl;
    t.pl[tid] = pl;
    t.cnt[tid] = cnt;
    v[0] = (len + 3) >> 2;
    v[1] = len;
    v[2] = 2 + (long long)hl;
    v[3] = 2 + (long long)pl;
    v[4] = 1 + (long long)cnt;
  }
  long long ex[5], tot[5], pre[5];
  block_excl_n<5>(v, ex, tot, sh);
  const long long mult[5] = {1, 1, 1, 1, a.unit};
  if (tid == 0) {
    // the window: each stream's range of the tile from an aligned offset, in
    // order, 16 bytes to spare for the realigned reads of the stores
    long long used = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const long long size = k < 5 ? tot[k] * mult[k] : 4LL * count;
      t.shift[k] = used;
      t.hi[k] = size;
      used += (size + 15) & ~15LL;
    }
    t.used = used;
    t.staged = used + 16 <= kStreamWindow;
    if (t.staged && tile > 0) publish(a.status, tile, a.epoch, kAggregate, tot);
  }
  __syncthreads();
  if (t.staged) {
    // 2. the records into the window at their offsets in the tile, while
    // the tiles before publish; then the tile's place in the buffer
    if (tid < count) {
#pragma unroll
      for (int k = 0; k < 5; ++k) t.at[k][tid] = ex[k] * mult[k];
      t.at[5][tid] = 4LL * tid;
    }
    for (long long x = 16LL * tid; x < t.used; x += 16LL * kStreamThreads)
      *reinterpret_cast<uint4*>(win + x) = make_uint4(0, 0, 0, 0);
    __syncthreads();
    stream_records<true>(a, t, i0, count, win);
    tile_prefix_cta<5>(a.status, tile, a.epoch, tot, pre, sh, true);
  } else {
    tile_prefix_cta<5>(a.status, tile, a.epoch, tot, pre, sh);
    if (tid < count) {
#pragma unroll
      for (int k = 0; k < 5; ++k) t.at[k][tid] = a.base[k] + (pre[k] + ex[k]) * mult[k];
      t.at[5][tid] = a.base[5] + 4 * (i0 + tid);
    }
    __syncthreads();
    stream_records<false>(a, t, i0, count, win);
  }
  if (tid == 0) {
    if (tile == (long long)gridDim.x - 1) {
      a.info[0] = a.unit * (pre[4] + tot[4]);
      a.info[1] = pre[0] + tot[0];
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) t.lo[k] = a.base[k] + pre[k] * mult[k];
    t.lo[5] = a.base[5] + 4 * i0;
  }
  if (!t.staged) return;
  // 3. the window's ranges into the buffer: aligned 16-byte units, each read
  // as two aligned window words realigned by funnel shifts; bytes at the ends
  __syncthreads();
  for (int k = 0; k < 6; ++k) {
    const long long lo = t.lo[k];
    const long long hi = min(lo + t.hi[k], a.end);
    const long long shift = t.shift[k] - lo;  // window byte of buffer byte x: x + shift
    for (long long u = (lo & ~15LL) + 16LL * tid; u < hi; u += 16LL * kStreamThreads) {
      if (u >= lo && u + 16 <= hi) {
        const long long w = u + shift;
        const uint4* q = reinterpret_cast<const uint4*>(win + (w & ~15LL));
        uint32_t o[4];
        realign16(q[0], q[1], (int)(w & 15), o);
        *reinterpret_cast<uint4*>(a.out + u) = make_uint4(o[0], o[1], o[2], o[3]);
      } else {
        for (long long b = u > lo ? u : lo; b < u + 16 && b < hi; ++b) a.out[b] = win[b + shift];
      }
    }
  }
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

// Raises a kernel's dynamic shared memory cap to `bytes` once per device.
cudaError_t raise_shared(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<int, const void*>> raised;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  if (raised.count({dev, kernel})) return cudaSuccess;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess) raised.insert({dev, kernel});
  return rc;
}

// Raises the write kernel's dynamic shared memory cap once per device.
cudaError_t ready_write() {
  return raise_shared((const void*)write_kernel,
                      kRowStage + 64 + 2 * (kSpanStage + 32) + kWindow);
}

inline long long uniform_stride(long long n, int w, long long r, long long vmax) {
  if (r <= 0 || n < (long long)w * r || (n - (long long)w * r) % r) return 0;
  const long long u = (n - (long long)w * r) / r;
  return u <= vmax ? u + w : 0;
}

// Raises the chain kernel's dynamic shared memory cap once per device.
cudaError_t ready_chain() { return raise_shared((const void*)chain_kernel, 5 * kChainMaxTile); }

}  // namespace

extern "C" {

// text: n bytes, 16-byte aligned. scratch: the bytes ops/records.py
// records_scan_scratch gives for max_records and ctas (the records pass's
// CTAs at most). offsets: (max_records, 8) int64; qmin: (max_records,)
// int16; info: 16 int64 (ops/records.py SCAN_*), every slot written; rows
// past the count are not written. ticket, status, epoch: as
// fq_rows_gather's, status words for ceil(n / 32 KiB) tiles. Two launches.
int fq_records_scan(const void* text, long long n, long long max_records, int ctas,
                    void* scratch, void* ticket, void* status, long long epoch, void* offsets,
                    void* qmin, void* info, void* stream) {
  if (n < 0 || max_records <= 0 || ctas < 1 || epoch < 1 || (uintptr_t)text % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  ScanArgs a;
  a.text = (const uint8_t*)text;
  a.n = n;
  a.cap = 4 * max_records;
  a.total = (long long*)scratch;
  a.parts = (long long*)((char*)scratch + 256);
  a.nl = (long long*)((char*)scratch + 256 + align256(8LL * kParts * ctas));
  a.offsets = (long long*)offsets;
  a.qmin = (int16_t*)qmin;
  a.info = (long long*)info;
  a.ticket = (unsigned*)ticket;
  a.status = (unsigned long long*)status;
  a.epoch = (unsigned long long)epoch;
  a.tiles = scan_tiles(n);
  const long long resident = resident_ctas((const void*)newlines_kernel, kThreads);
  newlines_kernel<<<(unsigned)(a.tiles < resident ? a.tiles : resident), kThreads, 0, s>>>(a);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  records_kernel<<<records_grid(max_records, ctas), kThreads, 0, s>>>(a);
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

// The six raw streams of n records (offsets (n, 8) from the scan) into out
// (16-byte aligned), back to back at the byte sizes s_seq .. s_len; packed /
// qual_delta / nmask rows at their pitches, n_counts per record; wide: u32
// N positions. tile_records: records per CTA (at most 128; ops/records.py
// stream_tile_records); ticket, status, epoch: as fq_rows_gather's (status
// words for ceil(n / tile_records) tiles). info: 2 int64, the npos and seq
// bytes written. One launch.
int fq_streams_build(const void* text, const void* offsets, long long n, const void* packed,
                     long long pp, const void* qual_delta, long long qp, const void* nmask,
                     long long np, const void* n_counts, int wide, long long s_seq,
                     long long s_qual, long long s_hdr, long long s_plus, long long s_npos,
                     long long s_len, int tile_records, void* ticket, void* status,
                     long long epoch, void* out, void* info, void* stream) {
  if (n <= 0 || tile_records < 1 || tile_records > kStreamMaxRecords || epoch < 1 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  StreamArgs a;
  a.text = (const uint8_t*)text;
  a.offsets = (const long long*)offsets;
  a.n = n;
  a.packed = (const uint8_t*)packed;
  a.pp = pp;
  a.qual = (const uint8_t*)qual_delta;
  a.qp = qp;
  a.nmask = (const uint8_t*)nmask;
  a.np = np;
  a.n_counts = (const int32_t*)n_counts;
  a.unit = wide ? 4 : 2;
  a.tile_records = tile_records;
  const long long sizes[6] = {s_seq, s_qual, s_hdr, s_plus, s_npos, s_len};
  long long b = 0;
  for (int k = 0; k < 6; ++k) {
    a.base[k] = b;
    b += sizes[k];
  }
  a.end = b;
  a.out = (uint8_t*)out;
  a.info = (long long*)info;
  a.ticket = (unsigned*)ticket;
  a.status = (unsigned long long*)status;
  a.epoch = (unsigned long long)epoch;
  const cudaError_t rc = raise_shared((const void*)streams_kernel, kStreamWindow);
  if (rc != cudaSuccess) return (int)rc;
  streams_kernel<<<grid_for(n, tile_records), kStreamThreads, kStreamWindow,
                   (cudaStream_t)stream>>>(a);
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
