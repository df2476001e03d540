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
// - the qctx prepare is a tiled segmented scan. Persistent CTAs (three an SM)
//   take 8 KiB tiles of the delta stream by ticket, a thread per 16
//   consecutive bytes loaded as one 16-byte unit; the next tile's ticket is
//   taken at the top of a tile, and its unit and bounds are in flight while
//   the CTA works on this one. The tile's record starts come from a window
//   of bounds, one a thread, around the record at the mean length's guess
//   (a warp's search and rounds of bounds where it misses), into a bitmap;
//   the integration mod 256 is a segmented scan over the CTA (a start
//   resets the carry), and the carry into the tile, the raw value of the
//   byte before it, is a re-read of the record's prefix where it is short
//   (<= kReread bytes) or comes from a decoupled look-back over the tiles
//   before it (the ticket, status words and epochs of records.cu): a tile
//   that holds a record start publishes its last raw value at once, a tile
//   inside a long read its sum first. Each symbol's position comes from the
//   same scan (the tile's last start) or from the window. The histogram's
//   786,432 bins do not fit in shared memory: each CTA counts in a table of
//   8,192 (key, count) slots in shared memory (open addressing). A thread
//   computes its 16 keys in registers and adds each run of equal keys where
//   it ends (5.9-7.6 runs in 16 symbols of quality walks): one shared
//   atomic at the key's home slot or the slot after it, an empty home slot
//   claimed inline, a key found in neither passed to an out-of-line probe
//   (past eight slots, to a global atomic). Few registers (no arrays of keys)
//   let three CTAs share an SM, whose warps hide each other's latencies; a
//   warp's __match_any_sync grouping cost more than it saved (the lanes of a
//   warp hold symbols 16 bytes apart, whose keys differ). Each CTA adds its used
//   slots to the histogram once, at the end of its life. A count cannot pass
//   2^31 - 1: a block has fewer symbols (the wrapper refuses more). The
//   histogram is zeroed by a memset before the kernel (two device operations
//   a call): a zeroing inside the launch would need every CTA resident at once;
// - the sctx prepare tiles the flat base stream: persistent CTAs (one an SM)
//   take 16,384-base tiles in turn, a thread per 16 consecutive bases. Base
//   j of record r is 2-bit slot j + 4 * pbounds[r] - bounds[r] of the packed
//   stream, so a base's six previous ones are the six slots before it: a
//   thread reads its first base's context itself (no carry between threads,
//   no scan of values, no look-back). The tile's record starts and their
//   shifts come from a window of bounds, one a thread, as the qctx prepare's;
//   the record of each thread's first base from a max-scan of the starts.
//   A thread reads three words of the packed stream and funnel-shifts its 16
//   bases' slots into one 32-bit value (a record start splices in its own
//   record's slots) and its first base's context into 12 bits (reversed),
//   writes the bases as one 16-byte store and adds each key to the CTA's
//   direct histogram (16,384 bins, 64 KB of shared memory: no hashing, no
//   probe, no __match_any_sync: a warp's lanes hold bases 16 apart, whose
//   keys differ), added to the global one once, at the end (~0.3 us on an
//   H100). A memset and the kernel: two device operations a call;
// - the layout mirrors the unlayout's tiles: a CTA takes 256 steps x 64
//   lanes. Each lane's symbols in the tile (and 8 before it: the context
//   reaches 6 back) are one contiguous run of the flat stream, loaded as
//   aligned 16-byte units into lane rows in shared memory while every thread
//   (a lane and 64 steps) finds its own steps' record starts: no thread
//   waits on another's search. After one barrier a thread walks its cells
//   (the position from its start bits, the context carried) and stores each
//   cell's present index and context itself; a warp's 32 lanes write 32 B
//   and 64 B a step, whole sectors. The decoder's start matrix comes from the
//   start bits alone, with no symbol load and no barrier. One kernel a
//   (model, order), one launch a call;
// - the unlayout is a tile-staged transpose. A CTA takes 256 steps x 64 lanes
//   of the decoded matrix (and 4 steps either side: the delta's previous
//   symbol, the packed bytes' last bases), loads them as rows of 4-byte
//   words, transposes each 4 x 4 block in registers (byte permutes) and
//   stores it lane-major in shared memory (an odd number of words a row, so
//   the stores spread over the banks), each index mapped through the
//   present symbols on the way and a data cell's index >= npres flagged.
//   Each lane's cells in the tile are one contiguous run of the output, so
//   the CTA writes every run as aligned 16-byte units, bytes only at a run's
//   two ends: the units of the 64 runs are numbered by a prefix over the
//   lanes, a thread per unit, each read from its lane's row as aligned words
//   realigned by funnel shifts. The delta subtracts the previous symbol four
//   bytes at a time (__vsub4) except at the record starts, which a thread per
//   lane finds among the lane's records (a guess, a binary search, then the
//   records that follow) and marks in a bitmap; packed rows are built in
//   shared memory first, a byte by the run that holds its first base (the
//   bytes' positions ranked by popcounts of a byte-start mask), then stored
//   the same way. A CTA with a fault writes an epoch-tagged word; the last
//   CTA (a ticket) writes the flag, so a call is one device operation.
// A launch does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// the qctx prepare (ops/ctxprep.py QCTX_TILE)
constexpr int kQThreads = 512;          // threads per CTA, 16 delta bytes each
constexpr int kQWarps = kQThreads / 32;
constexpr long long kQTile = 16LL * kQThreads;  // delta bytes per tile
constexpr int kQCtasPerSm = 3;          // persistent CTAs per SM (<= 42 registers a thread)
constexpr int kSlotBits = 13;
constexpr int kSlots = 1 << kSlotBits;  // (key, count) slots of a CTA's table
constexpr int kProbes = 8;              // slots a key tries before its global atomic
constexpr long long kReread = 1024;     // a record prefix before a tile re-read in place of a look-back
constexpr unsigned kEmpty = 0xffffffffu;
constexpr int kQTableBytes = 8 * kSlots;  // a qctx CTA's dynamic shared memory: keys, counts

// the unlayout (ops/ctxprep.py UNLAYOUT_TILE_STEPS / _LANES)
constexpr int kUThreads = 256;
constexpr int kUSteps = 256;            // steps per tile
constexpr int kULanes = 64;             // lanes per tile
constexpr int kUHead = 4;               // steps staged before the tile (the delta's previous symbol)
constexpr int kURows = kUSteps + 8;     // steps staged: 4 before, the tile, 4 after (packed bytes)
constexpr int kUPitch = kURows + 4;     // bytes a lane row of the staged tile: an odd number of words
constexpr int kUStartWords = (kUSteps + 4 + 31) / 32;  // record-start bits a lane: t0 .. t1 + 3
constexpr int kUPackedPitch = kUSteps + 4;  // a lane's packed bytes: one a step at most (records of 1 base)
constexpr int kUGuard = 64;             // shared bytes either side of the rows (a run's end units)
constexpr int kUAhead = 6;              // bounds a lane loads with its first record's guess
constexpr int kUBlocks = (kURows / 4) * (kULanes / 4);  // 4 x 4 blocks of the staged tile
constexpr int kUPer = (kUBlocks + kUThreads - 1) / kUThreads;
static_assert(kUPitch % 8 == 4 && kUPackedPitch % 4 == 0 && kURows % 4 == 0,
              "word-aligned rows, an odd number of words a staged row");
static_assert(kUSteps % 32 == 0 && kUThreads == 4 * kULanes, "four threads a lane's packed bytes");

// Status words of a launch whose tiles wait on each other, as records.cu's
// (ops/records.py STATUS_WORDS): tile j owns kStatusWords u64, a flag
// (the launch's epoch << 2 | state), then kSums aggregate and kSums inclusive
// sums. The unlayout tags word 0 with state kFaulted, a state no look-back
// reads, when one of its CTAs saw a fault.
constexpr int kStatusWords = 16;
constexpr int kSums = 5;
constexpr unsigned long long kAggregate = 1, kInclusive = 2, kFaulted = 3;

// qctx context geometry (ops/qualctx.py)
constexpr int kQbins = 48;
constexpr int kPbuckets = 8;
constexpr int kQ2b = 8;
constexpr int kQctxBins = kQbins * kPbuckets * kQ2b * 256;  // 786,432
// sctx: order 6
constexpr int kSctxOrder = 6;
constexpr unsigned kSctxMask = (1u << (2 * kSctxOrder)) - 1;
constexpr int kSctxBins = (1 << (2 * kSctxOrder)) * 4;  // 16,384

// the sctx prepare (ops/ctxprep.py SCTX_TILE)
constexpr int kSThreads = 1024;         // threads per CTA, 16 bases each; one CTA an SM (its table)
constexpr int kSWarps = kSThreads / 32;
constexpr long long kSTile = 16LL * kSThreads;  // bases per tile
constexpr int kSBits = (int)(kSTile / 32);      // record-start bits a tile
constexpr int kSSmem = 4 * kSctxBins + 2 * 2 * (int)kSTile;  // dynamic: the histogram, two tiles' shifts
static_assert(3 * kSTile < 65536, "a start's shift past the tile's first record fits 16 bits");

// the layout (ops/ctxprep.py LAYOUT_TILE_STEPS / _LANES)
constexpr int kLThreads = 256;
constexpr int kLSteps = 256;            // steps per tile
constexpr int kLLanes = 64;             // lanes per tile
constexpr int kLPart = kLSteps * kLLanes / kLThreads;  // steps a thread walks
constexpr int kLHead = 8;               // symbols staged before the tile (the context reaches 6 back)
constexpr int kLUnits = (kLHead + kLSteps + 15) / 16 + 1;  // 16-byte units of a staged lane row
constexpr int kLPitch = 16 * kLUnits + 4;  // bytes a staged lane row: an odd number of words
constexpr int kLPer = (kLLanes * kLUnits + kLThreads - 1) / kLThreads;  // units a thread loads
constexpr int kLPosCap = (kPbuckets - 1) * 16;  // positions past it give the same contexts
constexpr int kLSmem = kLLanes * kLPitch;  // the encode's dynamic shared memory: the staged lane rows
static_assert(kLThreads == 256 && kLPart <= 64 && kLPart % 16 == 0 && kLPitch % 8 == 4 &&
                  kLHead >= 8,
              "a byte of the index map a thread, a thread's start bits in 64, odd-word rows, "
              "the 8 symbols before a thread's first step staged");

// fq_wctx_unlayout's modes (ops/ctxprep.py UNLAYOUT_*)
enum { kFlat = 0, kPacked = 1, kDelta = 2 };

__device__ inline int qctx_ctx2(int p, int prev, int prev2) {
  const int qbin = p == 0 ? kQbins - 1 : min(prev, 46);
  const int pb = min(p >> 4, kPbuckets - 1);
  const int q2b = p < 2 ? kQ2b - 1 : (min(prev2, 46) >> 3);
  return (pb * kQbins + qbin) * kQ2b + q2b;
}

// ---------------------------------------------------------------------------
// tickets and status words (as records.cu)
// ---------------------------------------------------------------------------

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
// ticket `last`. Every thread must call it.
__device__ inline long long take_ticket(unsigned* ticket, unsigned last) {
  __shared__ unsigned s_ticket;
  __syncthreads();  // s_ticket of the CTA's previous ticket has been read
  if (threadIdx.x == 0) s_ticket = atomicInc(ticket, last);
  __syncthreads();
  return (long long)s_ticket;
}

// Tile `tile`'s sum v as its aggregate or inclusive state. One thread.
__device__ inline void publish(unsigned long long* status, long long tile,
                               unsigned long long epoch, unsigned long long state, long long v) {
  unsigned long long* st = status + tile * kStatusWords;
  st_relaxed(st + (state == kInclusive ? 1 + kSums : 1), (unsigned long long)v);
  st_release(st, (epoch << 2) | state);
}

__device__ inline long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The sum of the tiles before `tile` (> 0) down to the nearest inclusive
// one, by one whole warp: windows of the 32 nearest tiles.
__device__ long long look_back(const unsigned long long* status, long long tile,
                               unsigned long long epoch) {
  const int lane = threadIdx.x & 31;
  long long pre = 0;
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
    const unsigned long long* sum =
        status + (mine ? j : 0) * kStatusWords + (state == kInclusive ? 1 + kSums : 1);
    pre += warp_sum(mine ? (long long)ld_relaxed(sum) : 0);
    if (incl & need) break;
  }
  return pre;
}

// ---------------------------------------------------------------------------
// the qctx prepare
// ---------------------------------------------------------------------------

struct QctxArgs {
  const uint8_t* delta;  // 16-byte aligned
  long long n;
  const long long* bounds;  // nrec + 1 record starts, bounds[nrec] = n
  long long nrec;
  uint8_t* raw;
  unsigned* hist;  // zeroed before the launch
  long long tiles;
  unsigned* ticket;
  unsigned long long* status;
  unsigned long long epoch;
};

// The 16 bytes at i (16-byte aligned) of the stream, 0 past its end.
__device__ inline uint4 unit_at(const uint8_t* __restrict__ p, long long n, long long i) {
  if (i + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(p + i));
  uint32_t w[4] = {0, 0, 0, 0};
  for (int b = 0; b < 16 && i + b < n; ++b) w[b >> 2] |= (uint32_t)p[i + b] << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The last record r < hi with bounds[r] <= j (bounds[0] = 0 <= j < bounds[hi]
// = n), by one whole warp: a window of 32 records around the record at the
// mean length's guess (one round for reads of one length), then 32-way rounds.
__device__ long long warp_find_record(const long long* __restrict__ bounds, long long hi,
                                      long long n, long long j) {
  const int lane = threadIdx.x & 31;
  long long lo = 0;
  {
    long long g = (long long)((double)j / (double)n * (double)hi) - 15;
    g = max(0LL, min(g, hi - 32));
    const long long pos = g + lane;
    const bool le = pos >= 0 && pos < hi && bounds[pos] <= j;
    const unsigned b = __ballot_sync(kFull, le);
    const unsigned in = __ballot_sync(kFull, pos >= 0 && pos < hi);
    const int k = __popc(b);  // monotone: lanes 0 .. k - 1
    if (k > 0) lo = g + k - 1;
    if (k < __popc(in)) hi = g + k;  // the first lane past j bounds it
  }
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) / 32;
    const long long pos = lo + (lane + 1) * step;
    const bool le = pos < hi && bounds[pos] <= j;
    const int k = __popc(__ballot_sync(kFull, le));
    lo += k * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

// Adds c to key's count in the CTA's table from slot h on (its home slot,
// which did not hold it, nor the next): a probe of the slots, claiming an
// empty one, and past kProbes the global histogram. Out of line: the run ends
// of a thread's 16 symbols call it from one unrolled loop, and inlined there
// the loop outgrows the instruction cache.
__device__ __noinline__ void table_probe(unsigned* keys, unsigned* counts, unsigned* hist,
                                         unsigned key, unsigned c, unsigned h) {
#pragma unroll 1
  for (int k = 0; k < kProbes; ++k, h = (h + 1) & (kSlots - 1)) {
    unsigned cur = ((volatile unsigned*)keys)[h];
    if (cur == kEmpty) cur = atomicCAS(keys + h, kEmpty, key);
    if (cur == kEmpty || cur == key) {
      atomicAdd(counts + h, c);
      return;
    }
  }
  atomicAdd(hist + key, c);
}

__device__ inline unsigned home_slot(unsigned key) { return (key * 2654435761u) >> (32 - kSlotBits); }

// Adds c to key's count: at its home slot h or the slot after it (held /
// after: what they held when read), claiming an empty home slot, else by the
// out-of-line probe.
__device__ inline void add_counted(unsigned* keys, unsigned* counts, unsigned* hist, unsigned key,
                                   unsigned c, unsigned h, unsigned held, unsigned after) {
  unsigned at = h;
  if (held != key) {
    if (after == key) {
      at = (h + 1) & (kSlots - 1);
    } else if (held != kEmpty) {
      at = kSlots;
    } else {
      const unsigned old = atomicCAS(keys + h, kEmpty, key);
      if (old != kEmpty && old != key) at = kSlots;
    }
  }
  if (at < kSlots) atomicAdd(counts + at, c);
  else table_probe(keys, counts, hist, key, c, h);
}

// The segmented scan's operator on (bit 8: a record starts in the span,
// bits 9-21: the span's last start in the tile, bits 0-7: the sum mod 256
// since it, or of the whole span).
__device__ inline unsigned seg_op(unsigned a, unsigned b) {
  return (b & 0x100u) ? b : ((a & ~0xffu) | ((a + b) & 0xffu));
}

__device__ inline unsigned warp_seg_incl(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = seg_op(y, v);
  }
  return v;
}

// The first of the kQThreads bounds a qctx CTA loads for the tile at ts:
// around the record at the mean length's guess.
__device__ inline long long window_first(const QctxArgs& a, long long ts) {
  return max(0LL, min((long long)((double)ts / (double)a.n * (double)a.nrec) - 128, a.nrec - 1));
}

__device__ inline long long window_bound(const QctxArgs& a, long long ts) {
  const long long r = window_first(a, ts) + threadIdx.x;
  return r <= a.nrec ? a.bounds[r] : a.n;
}

// Persistent CTAs, a tile of kQTile delta bytes per ticket, a thread per 16
// consecutive bytes: the tile's record starts, the integration by a
// segmented CTA scan, raw, and the max-model keys of the thread's symbols,
// each run of equal keys one add to the CTA's table. The next tile's unit
// and bounds are in flight while the CTA works on this one.
__global__ void __launch_bounds__(kQThreads, kQCtasPerSm) qctx_prepare_kernel(QctxArgs a) {
  extern __shared__ unsigned q_table[];       // kSlots keys, then their counts
  unsigned* s_key = q_table;
  unsigned* s_cnt = q_table + kSlots;
  __shared__ unsigned s_starts[2][kQTile / 32];  // record starts of this tile and the next
  __shared__ unsigned s_warp[kQWarps];
  __shared__ unsigned s_dlast[kQWarps];      // each warp's last delta byte
  __shared__ long long s_first;              // start of the record holding the tile's first byte
  __shared__ long long s_after;              // the record after it
  __shared__ int s_carry;                    // raw value of the byte before the tile
  __shared__ int s_reach;                    // the window reaches past the tile
  __shared__ unsigned s_next;                // the CTA's next tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kSlots; i += kQThreads) {
    s_key[i] = kEmpty;
    s_cnt[i] = 0;
  }
  for (int i = threadIdx.x; i < kQTile / 16; i += kQThreads) s_starts[i & 1][i >> 1] = 0;
  const unsigned last = (unsigned)(a.tiles + gridDim.x - 1);
  int par = 0;
  long long tile = take_ticket(a.ticket, last);
  uint4 q = unit_at(a.delta, tile < a.tiles ? a.n : 0, tile * kQTile + 16LL * threadIdx.x);
  long long bw = tile < a.tiles ? window_bound(a, tile * kQTile) : 0;
  while (tile < a.tiles) {
    // the next ticket: taken now, read after the scan's first barrier
    unsigned ticket = 0;
    if (threadIdx.x == 0) ticket = atomicInc(a.ticket, last);
    const long long ts = tile * kQTile;
    const long long te = min(ts + kQTile, a.n);
    const long long j0 = ts + 16LL * threadIdx.x;
    unsigned* s_start = s_starts[par];  // zeroed during the tile before
    const unsigned dprev = threadIdx.x == 0 && ts > 0 ? a.delta[ts - 1] : 0;
    // the tile's first record and its starts from the window of bounds;
    // where it misses, a warp's search and rounds of the bounds after it
    const long long rw = window_first(a, ts) + threadIdx.x;
    if (threadIdx.x == kQThreads - 1) s_reach = rw >= a.nrec || bw >= te;
    // a bound in [ts, te) is a record start (the tile ends before n)
    if (rw <= a.nrec && bw >= ts && bw < te) atomicOr(&s_start[(bw - ts) >> 5], 1u << ((bw - ts) & 31));
    const int below = __syncthreads_count(rw <= a.nrec && bw <= ts);
    const bool covered = below >= 1 && s_reach;
    // every thread is past the tile before: the next tile's bitmap is free
    for (int i = threadIdx.x; i < kQTile / 32; i += kQThreads) s_starts[par ^ 1][i] = 0;
    if (covered) {
      if (threadIdx.x == below - 1) s_first = bw;  // read after the scan's barrier
    } else {
      if (warp == 0) {
        const long long r = warp_find_record(a.bounds, a.nrec, a.n, ts);
        if (lane == 0) {
          s_first = a.bounds[r];
          s_after = r + 1;
        }
      }
      __syncthreads();
      if (threadIdx.x == 0 && s_first == ts) atomicOr(&s_start[0], 1u);
      // the starts after it: bounds are > ts, the tile holds those < te
      for (long long r = s_after + threadIdx.x;; r += kQThreads) {
        const long long b = r <= a.nrec ? a.bounds[r] : a.n;
        if (b < te) atomicOr(&s_start[(b - ts) >> 5], 1u << ((b - ts) & 31));
        if (!__syncthreads_or(threadIdx.x == kQThreads - 1 && b < te)) break;
      }
    }
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    const unsigned fl = (s_start[threadIdx.x >> 1] >> (16 * (threadIdx.x & 1))) & 0xffffu;
    unsigned sum = 0;
    int ls = -1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if ((fl >> i) & 1) {
        sum = 0;
        ls = i;
      }
      sum += (w[i >> 2] >> (8 * (i & 3))) & 0xffu;
    }
    const unsigned v = ls >= 0 ? (0x100u | ((unsigned)(16 * threadIdx.x + ls) << 9) | (sum & 0xffu))
                               : (sum & 0xffu);
    const unsigned inc = warp_seg_incl(v);
    if (lane == 31) {
      s_warp[warp] = inc;
      s_dlast[warp] = w[3] >> 24;
    }
    if (threadIdx.x == 0) s_next = ticket;
    __syncthreads();
    const long long first = s_first;  // written before the barrier above
    // the next tile's unit and bounds are in flight while this one is worked on
    const long long next = s_next;
    const uint4 qn = unit_at(a.delta, next < a.tiles ? a.n : 0, next * kQTile + 16LL * threadIdx.x);
    const long long bwn = next < a.tiles ? window_bound(a, next * kQTile) : 0;
    if (warp == 0) {
      // a short prefix of the record before the tile, loaded first: the
      // carry where the tile begins inside a record
      const bool inside = !(s_start[0] & 1u);  // tile > 0: tile 0 begins with a record
      long long c = 0;
      if (inside && ts - first <= kReread)
        for (long long j = first + lane; j < ts; j += 32) c += a.delta[j];
      const unsigned x = warp_seg_incl(lane < kQWarps ? s_warp[lane] : 0u);
      if (lane < kQWarps) s_warp[lane] = x;
      const unsigned total = __shfl_sync(kFull, x, kQWarps - 1);
      const bool has = total & 0x100u;
      // a tile with a record start publishes its last raw value before it
      // waits on anything, so no chain of look-backs forms
      if (has && lane == 0) publish(a.status, tile, a.epoch, kInclusive, total & 0xffu);
      if (inside && has && ts - first <= kReread) {
        c = warp_sum(c);
      } else if (inside) {
        if (!has && lane == 0) publish(a.status, tile, a.epoch, kAggregate, total & 0xffu);
        __syncwarp();
        c = look_back(a.status, tile, a.epoch);
        if (!has && lane == 0) publish(a.status, tile, a.epoch, kInclusive, (c + total) & 0xffu);
      }
      if (lane == 0) s_carry = (int)(c & 0xff);
    }
    __syncthreads();
    unsigned ex = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) ex = 0;
    if (warp > 0) ex = seg_op(s_warp[warp - 1], ex);
    // raw value and position of the byte before the thread's first
    unsigned rm1;
    int p;  // < 2^31: a block has fewer symbols
    if (ex & 0x100u) {
      rm1 = ex & 0xffu;
      p = 16 * (int)threadIdx.x - 1 - (int)(ex >> 9);
    } else {
      rm1 = ((unsigned)s_carry + ex) & 0xffu;
      p = (int)(ts - first) + 16 * (int)threadIdx.x - 1;
    }
    unsigned dm1 = __shfl_up_sync(kFull, w[3] >> 24, 1);
    if (lane == 0) dm1 = warp > 0 ? s_dlast[warp - 1] : dprev;
    unsigned rm2 = (rm1 - dm1) & 0xffu;  // read only where p >= 2
    // raw and the keys; a run of equal keys is added where it ends
    const int live = (int)max(0LL, min(16LL, te - j0));
    uint32_t out[4] = {0, 0, 0, 0};
    unsigned run_key = kEmpty, run = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const unsigned d = (w[i >> 2] >> (8 * (i & 3))) & 0xffu;
      unsigned r;
      if ((fl >> i) & 1) {
        r = d;
        p = 0;
      } else {
        r = (rm1 + d) & 0xffu;
        ++p;
      }
      out[i >> 2] |= r << (8 * (i & 3));
      const unsigned key = (unsigned)qctx_ctx2(p, (int)rm1, (int)rm2) * 256u + r;
      if (i < live) {
        if (key != run_key) {
          if (run) {
            const unsigned h = home_slot(run_key);
            add_counted(s_key, s_cnt, a.hist, run_key, run, h, s_key[h], s_key[(h + 1) & (kSlots - 1)]);
          }
          run_key = key;
          run = 0;
        }
        ++run;
      }
      rm2 = rm1;
      rm1 = r;
    }
    if (j0 + 16 <= a.n) {
      *reinterpret_cast<uint4*>(a.raw + j0) = make_uint4(out[0], out[1], out[2], out[3]);
    } else {
      for (int i = 0; i < 16 && j0 + i < a.n; ++i) a.raw[j0 + i] = (uint8_t)(out[i >> 2] >> (8 * (i & 3)));
    }
    if (run) {
      const unsigned h = home_slot(run_key);
      add_counted(s_key, s_cnt, a.hist, run_key, run, h, s_key[h], s_key[(h + 1) & (kSlots - 1)]);
    }
    tile = next;
    q = qn;
    bw = bwn;
    par ^= 1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSlots; i += kQThreads) {
    const unsigned k = s_key[i];
    if (k != kEmpty) atomicAdd(a.hist + k, s_cnt[i]);
  }
}

// ---------------------------------------------------------------------------
// the sctx prepare
// ---------------------------------------------------------------------------

struct SctxArgs {
  const uint8_t* packed;  // 4-byte aligned
  long long packed_n;
  const long long* bounds;   // nrec + 1 record starts, bounds[nrec] = n
  const long long* pbounds;  // nrec + 1 first packed bytes
  long long nrec;
  uint8_t* bases;  // 16-byte aligned
  unsigned* hist;  // zeroed before the launch
};

// The packed stream's 32-bit word w (16 bases), 0 outside it.
__device__ inline uint32_t packed_word(const SctxArgs& a, long long w) {
  const long long i = 4 * w;
  if (i >= 0 && i + 4 <= a.packed_n) return __ldg(reinterpret_cast<const uint32_t*>(a.packed) + w);
  uint32_t v = 0;
  for (int b = 0; b < 4; ++b)
    if (i + b >= 0 && i + b < a.packed_n) v |= (uint32_t)a.packed[i + b] << (8 * b);
  return v;
}

// The first of the kSThreads records an sctx CTA loads for the tile at ts:
// around the record at the mean length's guess.
__device__ inline long long sctx_window_first(const SctxArgs& a, long long n, long long ts) {
  return max(0LL, min((long long)((double)ts / (double)n * (double)a.nrec) - kSThreads / 8,
                      a.nrec - 1));
}

// Marks a record start at base b of the tile [ts, te) and its shift D = 4 *
// pbounds - bounds (base j of the record is 2-bit slot j + D of the packed
// stream), kept as its low 16 bits: D grows by at most 3 a record, so a
// start's D less the tile's first record's is below 3 * kSTile.
__device__ inline void sctx_mark(unsigned* bits, uint16_t* shift, long long ts, long long te,
                                 long long b, long long pb) {
  if (b < ts || b >= te) return;
  const int q = (int)(b - ts);
  shift[q] = (uint16_t)(4 * pb - b);
  atomicOr(&bits[q >> 5], 1u << (q & 31));
}

// Persistent CTAs, tiles of kSTile bases in turn, a thread per 16
// consecutive bases. The tile's record starts (and each start's packed
// shift) come from a window of bounds, the record of a thread's first base
// from a max-scan of the starts; the thread reads its bases' 2-bit slots
// and its first base's six previous ones as three words of the packed
// stream, writes the bases as one 16-byte store and adds each key (ctx * 4
// + base) to the CTA's histogram of 16,384 bins in shared memory, which is
// added to the global one once, at the end.
__global__ void __launch_bounds__(kSThreads, 1) sctx_prepare_kernel(SctxArgs a) {
  extern __shared__ unsigned s_mem[];
  unsigned* s_hist = s_mem;                 // kSctxBins counts
  uint16_t* s_shifts = reinterpret_cast<uint16_t*>(s_mem + kSctxBins);  // by offset, two tiles
  __shared__ unsigned s_starts[2][kSBits];  // record starts of this tile and the next
  __shared__ int s_wlast[kSWarps];          // each warp's last start, -1 if none
  __shared__ long long s_first;             // start of the record holding the tile's first base
  __shared__ long long s_fshift;            // its shift
  __shared__ long long s_after;             // the record after it (the window's misses)
  __shared__ int s_reach;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kSctxBins; i += kSThreads) s_hist[i] = 0;
  for (int i = threadIdx.x; i < 2 * kSBits; i += kSThreads) s_starts[i & 1][i >> 1] = 0;
  const long long n = a.bounds[a.nrec];
  const long long tiles = (n + kSTile - 1) / kSTile;
  int par = 0;
  long long tile = blockIdx.x;
  long long rw = sctx_window_first(a, n, tile * kSTile) + threadIdx.x;
  long long bw = 0, pw = 0;
  if (tile < tiles) {
    bw = rw <= a.nrec ? a.bounds[rw] : n;
    pw = rw <= a.nrec ? a.pbounds[rw] : 0;
  }
  for (; tile < tiles; tile += gridDim.x) {
    const long long ts = tile * kSTile;
    const long long te = min(ts + kSTile, n);
    unsigned* bits = s_starts[par];  // zeroed during the tile before
    uint16_t* s_shift = s_shifts + par * kSTile;  // the tile before may still read the other
    if (threadIdx.x == kSThreads - 1) s_reach = rw >= a.nrec || bw >= te;
    if (rw <= a.nrec) sctx_mark(bits, s_shift, ts, te, bw, pw);
    const int below = __syncthreads_count(rw <= a.nrec && bw <= ts);
    const bool covered = below >= 1 && s_reach;
    for (int i = threadIdx.x; i < kSBits; i += kSThreads) s_starts[par ^ 1][i] = 0;
    if (covered) {
      if (threadIdx.x == below - 1) {  // read after the scan's barrier
        s_first = bw;
        s_fshift = 4 * pw - bw;
      }
    } else {
      if (warp == 0) {
        const long long r = warp_find_record(a.bounds, a.nrec, n, ts);
        if (lane == 0) {
          s_first = a.bounds[r];
          s_fshift = 4 * a.pbounds[r] - s_first;
          s_after = r + 1;
        }
      }
      __syncthreads();
      // the starts after it: bounds are > ts, the tile holds those < te
      for (long long r = s_after + threadIdx.x;; r += kSThreads) {
        const long long b = r <= a.nrec ? a.bounds[r] : n;
        if (b < te) sctx_mark(bits, s_shift, ts, te, b, a.pbounds[r]);
        if (!__syncthreads_or(threadIdx.x == kSThreads - 1 && b < te)) break;
      }
    }
    // the last start at or before each thread's bases: a max-scan
    const int o0 = 16 * threadIdx.x;
    const unsigned fl = (bits[threadIdx.x >> 1] >> (16 * (threadIdx.x & 1))) & 0xffffu;
    int inc = fl ? o0 + 31 - __clz(fl) : -1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc = max(inc, y);
    }
    if (lane == 31) s_wlast[warp] = inc;
    __syncthreads();
    // the next tile's window is in flight while this one is worked on
    const long long next = tile + gridDim.x;
    if (next < tiles) {
      rw = sctx_window_first(a, n, next * kSTile) + threadIdx.x;
      bw = rw <= a.nrec ? a.bounds[rw] : n;
      pw = rw <= a.nrec ? a.pbounds[rw] : 0;
    }
    int ls = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) ls = -1;
    for (int w = warp - 1; ls < 0 && w >= 0; --w) ls = s_wlast[w];
    const long long j0 = ts + o0;
    const long long fshift = s_fshift;
    long long shift, p;  // the first base's packed shift and position in its record
    if (ls >= 0) {
      shift = fshift + (uint16_t)(s_shift[ls] - (uint16_t)fshift);
      p = o0 - ls;
    } else {
      shift = fshift;
      p = j0 - s_first;
    }
    const int live = (int)max(0LL, min(16LL, te - j0));
    // the packed stream from six slots before the first base: three words,
    // slot x at bit 2 * (x - 16 * wb)
    const long long x0 = j0 + shift;
    const long long wb = (x0 - 6) >> 4;
    const uint32_t w0 = live ? packed_word(a, wb) : 0u;
    const uint32_t w1 = live ? packed_word(a, wb + 1) : 0u;
    const uint32_t w2 = live ? packed_word(a, wb + 2) : 0u;
    // 16 slots from slot 16 * wb + d (d >= 0): from the words, or past them
    // (a run of short records) from the stream
    auto slots16 = [&](long long d) -> uint32_t {
      if (d < 16) return __funnelshift_r(w0, w1, 2 * (int)d);
      if (d < 32) return __funnelshift_r(w1, w2, 2 * (int)(d - 16));
      const long long x = 16 * wb + d;
      return __funnelshift_r(packed_word(a, x >> 4), packed_word(a, (x >> 4) + 1),
                             2 * (int)(x & 15));
    };
    // the slots before 4 * packed_n hold bases; a row past them is not counted
    const long long lim = 4 * a.packed_n - 16 * wb;
    auto lows = [](long long k) -> unsigned {  // bases 0 .. k - 1 of the thread's 16
      return k >= 16 ? 0xffffu : k <= 0 ? 0u : (1u << k) - 1;
    };
    const int d0 = (int)(x0 - 16 * wb);  // 6 .. 21
    uint32_t v = slots16(d0);             // base i at bits 2i
    unsigned in = lows(lim - d0);
    // a record start at base i: bases i on from its record's slots
    for (unsigned rest = fl; rest; rest &= rest - 1) {
      const int i = __ffs(rest) - 1;
      const long long d = j0 + fshift + (uint16_t)(s_shift[o0 + i] - (uint16_t)fshift) - 16 * wb;
      const uint32_t keep = (1u << (2 * i)) - 1;
      v = (v & keep) | (slots16(d) & ~keep);
      in = (in & lows(i)) | (lows(lim - d) & ~lows(i));
    }
    in &= lows(live);
    uint32_t m = in;  // each bit of `in` twice: the bases' bits
    m = (m | (m << 8)) & 0x00ff00ffu;
    m = (m | (m << 4)) & 0x0f0f0f0fu;
    m = (m | (m << 2)) & 0x33333333u;
    m = (m | (m << 1)) & 0x55555555u;
    v &= m | (m << 1);
    // the first base's context: the six slots before it, the latest lowest
    uint32_t ctx = __brev(slots16(d0 - 6) & 0xfffu) >> 20;  // slot order reversed
    ctx = ((ctx >> 1) & 0x555u) | ((ctx & 0x555u) << 1);      // each base's two bits back
    if (p < kSctxOrder) ctx &= (1u << (2 * p)) - 1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if ((fl >> i) & 1) ctx = 0;
      const uint32_t key = (ctx << 2) | ((v >> (2 * i)) & 3u);
      if ((in >> i) & 1) atomicAdd(s_hist + key, 1u);
      ctx = key & kSctxMask;
    }
    uint32_t out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // a base a byte
      const uint32_t b = (v >> (8 * k)) & 0xffu;
      out[k] = (b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303u;
    }
    if (live == 16) {
      *reinterpret_cast<uint4*>(a.bases + j0) = make_uint4(out[0], out[1], out[2], out[3]);
    } else {
      for (int i = 0; i < live; ++i) a.bases[j0 + i] = (uint8_t)(out[i >> 2] >> (8 * (i & 3)));
    }
    par ^= 1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSctxBins; i += kSThreads) {
    const unsigned v = s_hist[i];
    if (v) atomicAdd(a.hist + i, v);
  }
}

// ---------------------------------------------------------------------------
// a lane's records in a tile (the layout and the unlayout)
// ---------------------------------------------------------------------------

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

// The record starts of a lane's symbols [j0, lim) (the lane's records rb0
// .. rb1 - 1 begin at sb, and j0 < lim <= its end): mark(q) where a record
// begins at j0 + q; *p0 is j0's position in its record and, with pbounds,
// *pstart the record's first packed byte. The record at the lane's mean
// length's guess and the bounds after it are loaded at once: one round trip
// for reads of one length.
template <typename Mark>
__device__ void lane_records(const long long* __restrict__ bounds,
                                  const long long* __restrict__ pbounds, long long rb0,
                                  long long rb1, long long sb, long long seg, long long j0,
                                  long long lim, Mark mark, long long* p0, long long* pstart) {
  const long long g = rb0 + min((j0 - sb) * (rb1 - rb0) / seg, rb1 - rb0 - 1);
  long long nb[kUAhead];
#pragma unroll
  for (int k = 0; k < kUAhead; ++k) nb[k] = g + k <= rb1 ? bounds[g + k] : lim;
  const long long pg = pbounds ? pbounds[g] : 0;
  long long r0 = g;
  if (nb[0] > j0) r0 = find_record(bounds, rb0, g, j0);
  else if (nb[1] <= j0) r0 = find_record(bounds, g + 1, rb1, j0);
  *p0 = j0 - (r0 == g ? nb[0] : bounds[r0]);
  if (pbounds) *pstart = r0 == g ? pg : pbounds[r0];
  if (*p0 == 0) mark(0);
  // the records after it: the bounds loaded with the guess, then four at a time
  long long r = r0;
  if (r0 == g) {
#pragma unroll
    for (int k = 1; k < kUAhead; ++k) {
      if (nb[k] < lim) mark((int)(nb[k] - j0));
    }
    r = nb[kUAhead - 1] < lim ? g + kUAhead - 1 : rb1;
  }
  for (; r < rb1; r += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) nb[k] = r + 1 + k <= rb1 ? bounds[r + 1 + k] : lim;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (nb[k] < lim) mark((int)(nb[k] - j0));
    }
    if (nb[3] >= lim) break;
  }
}

// ---------------------------------------------------------------------------
// staged rows (the layout and the unlayout)
// ---------------------------------------------------------------------------

// 16 bytes of a shared row from byte offset o (any alignment), as 4 words.
__device__ inline void row16(const uint8_t* row, int o, uint32_t (&v)[4]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (o >> 2);
  const int sh = 8 * (o & 3);
  uint32_t x[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) x[k] = w[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = __funnelshift_r(x[k], x[k + 1], sh);
}

// Bits o .. o + 15 of a lane's record-start bitmap (0 before bit 0).
__device__ inline unsigned start_bits16(const unsigned* words, int o) {
  const int wi = o >> 5;
  const unsigned long long lo = wi >= 0 ? words[wi] : 0u;
  const unsigned long long hi = wi + 1 >= 0 && wi + 1 < kUStartWords ? words[wi + 1] : 0u;
  return (unsigned)(((hi << 32) | lo) >> (o & 31)) & 0xffffu;
}

// 0xff in byte k where bit k of the nibble is set.
__device__ inline uint32_t byte_mask(unsigned nib) {
  return ((nib * 0x00204081u) & 0x01010101u) * 0xffu;
}

// ---------------------------------------------------------------------------
// the layout
// ---------------------------------------------------------------------------

struct LayoutArgs {
  const uint8_t* syms;  // the encode's flat symbols (16-byte aligned), null on decode
  const long long* bounds;     // nrec + 1 record starts
  const long long* lanes_tab;  // (2, lanes + 1): each lane's first symbol and first record
  int lanes, steps;
  const uint8_t* idx_map;
  int pad_sym;
  uint8_t* sym_out;  // encode: (steps, lanes) present indices
  int16_t* ctx_out;  // encode: (steps, lanes) contexts
  uint8_t* start_out;  // decode: (steps, lanes) start flags
};

// The context of a cell at position p in its record, before its symbol:
// model 0, the record's previous `kOrder` bases (ctx, carried); model 1,
// the position bucket and the previous quality bins.
template <int kModel, int kOrder>
__device__ inline int layout_ctx(unsigned ctx, int p, int prev, int prev2) {
  if (kModel == 0) return (int)ctx;
  const int c = min(p >> 4, kPbuckets - 1) * kQbins + (p == 0 ? kQbins - 1 : min(prev, 46));
  return kOrder == 1 ? c * kQ2b + (p < 2 ? kQ2b - 1 : (min(prev2, 46) >> 3)) : c;
}

// A tile of kLSteps steps x kLLanes lanes of the lane matrices, a thread per
// lane and kLPart steps. Every thread finds its own steps' record starts (the
// lane's records around the mean length's guess): no thread waits on
// another's search. The decoder's start matrix (kEnc false) comes from the
// start bits alone. For the encoder, each lane's symbols in the tile (and
// kLHead before it: the context reaches 6 back) are one contiguous run of
// the flat stream, staged lane-major in shared memory as aligned 16-byte
// units (a warp's loads on one or two runs) while the searches run; after
// one barrier a thread walks its cells (the position from its start bits,
// the context carried). Each thread stores its cells itself: a warp's 32
// lanes write 32 B of indices or flags and 64 B of contexts a step, whole
// sectors. (Staging the cells step-major in shared memory for 16-byte
// stores took 49.4-51.8 us against 35.2-46.8 for the encode at 100,000 x
// 151 on an H100, and 14.5-14.8 against 13.8-14.0 for the start matrix.)
template <int kModel, int kOrder, bool kEnc>
__global__ void __launch_bounds__(kLThreads, 4) wctx_layout_kernel(LayoutArgs a) {
  extern __shared__ __align__(16) uint8_t s_rows[];  // the encode's staged lane rows
  __shared__ uint8_t s_idx[256];
  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * kLSteps;
  const int nsteps = (int)min((long long)kLSteps, a.steps - t0);
  const int l0 = blockIdx.y * kLLanes;
  const int nl = min(kLLanes, a.lanes - l0);
  const int i = tid % kLLanes, part = tid / kLLanes;
  const int tp = part * kLPart;  // the thread's first step, from t0
  const int end = min(tp + kLPart, nsteps);
  const bool active = i < nl && tp < end;
  const long long cell0 = (t0 + tp) * a.lanes + l0 + i;  // the thread's first cell
  // the thread's steps: their record starts (bit t - tp) and the first one's position
  long long sb = 0, p0 = 0;
  int data_end = 0;  // the lane's steps from t0 that hold data
  unsigned long long bits = 0;
  auto find_starts = [&]() {
    if (!active) return;
    const int l = l0 + i;
    sb = a.lanes_tab[l];
    const long long seg = a.lanes_tab[l + 1] - sb;
    data_end = (int)max(0LL, min(seg - t0, (long long)nsteps));
    if (tp < data_end)
      lane_records(a.bounds, nullptr, a.lanes_tab[a.lanes + 1 + l], a.lanes_tab[a.lanes + 2 + l],
                   sb, seg, sb + t0 + tp, sb + t0 + min(end, data_end),
                   [&bits](int q) { bits |= 1ull << q; }, &p0, nullptr);
  };
  if (!kEnc) {
    find_starts();
    if (!active) return;
    uint8_t* out = a.start_out + cell0;
    for (int t = tp; t < end; ++t)  // every pad cell is a start
      out[(long long)(t - tp) * a.lanes] = t >= data_end || ((bits >> (t - tp)) & 1u) ? 1 : 0;
    return;
  }
  // 1. the staged rows' loads, all in flight at once: unit c of lane e /
  // kLUnits at row byte 16 * c, unit 0 the one holding the lane's step t0 - kLHead
  s_idx[tid] = a.idx_map[tid];
  const long long n = a.lanes_tab[a.lanes];  // the symbols: the last lane's end
  uint4 u[kLPer];
#pragma unroll
  for (int k = 0; k < kLPer; ++k) {
    const int e = tid + k * kLThreads;
    const int li = e / kLUnits, c = e % kLUnits;
    u[k] = make_uint4(0, 0, 0, 0);
    if (li < nl) {
      const long long lsb = a.lanes_tab[l0 + li];
      const long long lo = max(lsb + t0 - kLHead, lsb);
      const long long hi = min(lsb + t0 + nsteps, a.lanes_tab[l0 + li + 1]);
      const long long at = 16 * (((lsb + t0 - kLHead) >> 4) + c);
      if (at + 16 > lo && at < hi) u[k] = unit_at(a.syms, n, at);
    }
  }
  find_starts();
#pragma unroll
  for (int k = 0; k < kLPer; ++k) {
    const int e = tid + k * kLThreads;
    if (e < kLLanes * kLUnits) {  // rows of an odd number of words: four word stores
      uint32_t* w = reinterpret_cast<uint32_t*>(s_rows + (e / kLUnits) * kLPitch) + 4 * (e % kLUnits);
      w[0] = u[k].x;
      w[1] = u[k].y;
      w[2] = u[k].z;
      w[3] = u[k].w;
    }
  }
  __syncthreads();
  if (!active) return;
  // 2. the cells
  const uint8_t* row = s_rows + i * kLPitch;
  const int off = (int)((sb + t0 - kLHead) & 15) + kLHead + tp;  // row byte of the first step
  int p = (int)min(p0, (long long)kLPosCap);
  uint32_t h[4];
  row16(row, off - 8, h);  // the 8 symbols before the first step
  unsigned ctx = 0;
  int prev = 0, prev2 = 0;
  if (kModel == 0) {
#pragma unroll
    for (int k = 1; k <= kOrder; ++k)
      if (p >= k) ctx |= ((h[(8 - k) >> 2] >> (8 * ((8 - k) & 3))) & 0xffu) << (2 * (k - 1));
  } else {
    if (p >= 1) prev = (int)(h[1] >> 24);
    if (p >= 2) prev2 = (int)((h[1] >> 16) & 0xffu);
  }
  constexpr unsigned mask = kModel == 0 ? (1u << (2 * kOrder)) - 1 : 0u;
  const uint8_t pad_idx = s_idx[a.pad_sym];
  const int16_t pad_ctx = kModel == 0 ? 0 : (kOrder == 1 ? (kQbins - 1) * kQ2b + kQ2b - 1 : kQbins - 1);
  uint8_t* sym_out = a.sym_out + cell0;
  int16_t* ctx_out = a.ctx_out + cell0;
  for (int c = 0; c < end - tp; c += 16) {
    uint32_t v[4];
    row16(row, off + c, v);
    const unsigned sbits = (unsigned)(bits >> c) & 0xffffu;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int t = c + k;  // from tp
      if (t >= end - tp) break;
      const long long at = (long long)t * a.lanes;
      if (tp + t >= data_end) {
        sym_out[at] = pad_idx;
        ctx_out[at] = pad_ctx;
        continue;
      }
      if ((sbits >> k) & 1u) {
        p = 0;
        ctx = 0;
        prev = prev2 = 0;
      }
      const int s = (int)((v[k >> 2] >> (8 * (k & 3))) & 0xffu);
      sym_out[at] = s_idx[s];
      ctx_out[at] = (int16_t)layout_ctx<kModel, kOrder>(ctx, p, prev, prev2);
      if (kModel == 0) {
        ctx = ((ctx << 2) | (unsigned)s) & mask;
      } else {
        prev2 = prev;
        prev = s;
      }
      p = min(p + 1, kLPosCap);
    }
  }
}

// ---------------------------------------------------------------------------
// the unlayout
// ---------------------------------------------------------------------------

struct UnlayoutArgs {
  const uint8_t* mat;        // (steps, lanes) present indices
  const long long* bounds;   // nrec + 1 record starts
  const long long* pbounds;  // the packed mode: each record's first packed byte
  const long long* lanes_tab;
  int lanes, steps;
  const uint8_t* present;
  int npres, mode;
  uint8_t* dst;
  int* fault;
  unsigned* ticket;
  unsigned long long* status;
  unsigned long long epoch;
};

// Four bytes of row t at lanes l .. l + 3 of the matrix (0 outside it).
__device__ inline uint32_t mat_word(const UnlayoutArgs& a, long long t, int l) {
  if (t < 0 || t >= a.steps || l >= a.lanes) return 0;
  const uint8_t* p = a.mat + t * a.lanes + l;
  if ((a.lanes & 3) == 0) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t v = 0;
  for (int c = 0; c < 4 && l + c < a.lanes; ++c) v |= (uint32_t)p[c] << (8 * c);
  return v;
}

// A tile of kUSteps steps x kULanes lanes of the decoded matrix back in
// record order: staged, transposed and mapped in shared memory, then each
// lane's run stored as aligned 16-byte units.
__global__ void __launch_bounds__(kUThreads) wctx_unlayout_kernel(UnlayoutArgs a) {
  __shared__ __align__(16) uint8_t s_rows[2 * kUGuard + kULanes * kUPitch];
  __shared__ __align__(16) uint8_t s_packed[2 * kUGuard + kULanes * kUPackedPitch];
  __shared__ unsigned s_starts[kULanes][kUStartWords];
  __shared__ long long s_dst[kULanes];  // the run's first output byte
  __shared__ long long s_p0[kULanes];   // the position of the tile's first step in its record
  __shared__ int s_len[kULanes];        // the run's output bytes
  __shared__ int s_run[kULanes];        // the run's steps
  __shared__ int s_lim[kULanes];        // staged rows below it hold data
  __shared__ int s_units[kULanes + 1];
  __shared__ int s_edge[2 * kULanes];     // the runs' end units, stored by bytes
  __shared__ int s_nedge;
  __shared__ uint8_t s_present[256];
  __shared__ int s_bad;
  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * kUSteps;
  const long long t1 = min(t0 + kUSteps, (long long)a.steps);
  const int l0 = blockIdx.y * kULanes;
  // 1. the staged rows' loads, all in flight at once: thread tid takes the
  // 4 x 4 blocks tid, tid + kUThreads, ... (16 blocks across the lanes)
  uint32_t w[kUPer][4];
#pragma unroll
  for (int k = 0; k < kUPer; ++k) {
    const int b = tid + k * kUThreads;
    const long long t = t0 - kUHead + 4 * (b >> 4);
#pragma unroll
    for (int r = 0; r < 4; ++r) w[k][r] = b < kUBlocks ? mat_word(a, t + r, l0 + 4 * (b & 15)) : 0u;
  }
  // 2. the lanes: their runs and record starts
  for (int i = tid; i < 256; i += kUThreads) s_present[i] = a.present[min(i, a.npres - 1)];
  if (tid == 0) {
    s_bad = 0;
    s_nedge = 0;
  }
  if (tid < kULanes) {
    const int l = l0 + tid;
    long long sb = 0, seg = 0, rb0 = 0, rb1 = 0;
    if (l < a.lanes) {
      sb = a.lanes_tab[l];
      seg = a.lanes_tab[l + 1] - sb;
      rb0 = a.lanes_tab[a.lanes + 1 + l];
      rb1 = a.lanes_tab[a.lanes + 2 + l];
    }
    const long long run = max(min(t1, seg) - t0, 0LL);
    s_lim[tid] = (int)max(min(seg - t0 + kUHead, (long long)kURows), 0LL);
    s_run[tid] = (int)run;
    s_len[tid] = (int)run;
    s_dst[tid] = sb + t0;
    unsigned* bits = s_starts[tid];
#pragma unroll
    for (int k = 0; k < kUStartWords; ++k) bits[k] = 0;
    if (a.mode != kFlat && run > 0) {
      long long p0 = 0, ps = 0;
      lane_records(a.bounds, a.mode == kPacked ? a.pbounds : nullptr, rb0, rb1, sb, seg, sb + t0,
                   sb + min(t1 + 4, seg), [bits](int q) { bits[q >> 5] |= 1u << (q & 31); },
                   &p0, &ps);
      s_p0[tid] = p0;
      // the first packed byte whose first base lies in the run
      if (a.mode == kPacked) s_dst[tid] = ps + (p0 + 3) / 4;
    }
  }
  // 3. transpose the blocks into lane rows, the indices mapped through the
  // present symbols; a data cell's index >= npres is a fault
  bool bad = false;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kUPer; ++k) {
    const int b = tid + k * kUThreads;
    if (b >= kUBlocks) continue;
    const int g = b >> 4, h = b & 15;
    const uint32_t lo01 = __byte_perm(w[k][0], w[k][1], 0x5140);
    const uint32_t hi01 = __byte_perm(w[k][0], w[k][1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[k][2], w[k][3], 0x5140);
    const uint32_t hi23 = __byte_perm(w[k][2], w[k][3], 0x7362);
    const uint32_t lw[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                            __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * h + c;
      const int lim = s_lim[i];
      uint32_t m = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int idx = (lw[c] >> (8 * r)) & 0xff;
        const int qq = 4 * g + r;
        bad |= qq < lim && t0 - kUHead + qq >= 0 && idx >= a.npres;
        m |= (uint32_t)s_present[idx] << (8 * r);
      }
      reinterpret_cast<uint32_t*>(s_rows + kUGuard + i * kUPitch)[g] = m;
    }
  }
  if (bad) s_bad = 1;
  __syncthreads();
  // 4. packed rows: the bytes whose first base lies in the run, four
  // threads a lane, two words of 32 steps each
  if (a.mode == kPacked) {
    const int i = tid >> 2, part = tid & 3;
    const int run = s_run[i];
    const long long p0 = s_p0[i];
    const unsigned* st = s_starts[i];
    const uint8_t* row = s_rows + kUGuard + i * kUPitch + kUHead;
    unsigned mask[2] = {0, 0};
    int cnt = 0;
    if (run > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int wd = 2 * part + h, base = 32 * wd;
        if (base >= run) continue;
        // the last start before the word, or the record's own start
        long long ls = -p0;
        for (int k = wd - 1; k >= 0; --k) {
          if (st[k]) {
            ls = 32 * k + 31 - __clz(st[k]);
            break;
          }
        }
        unsigned m = 0;
        int from = 0;
        for (unsigned rest = st[wd];; rest &= rest - 1) {
          const int to = rest ? __ffs(rest) - 1 : 32;
          const unsigned span = (to == 32 ? 0xffffffffu : (1u << to) - 1) & ~((1u << from) - 1);
          m |= (0x11111111u << ((ls - base) & 3)) & span;
          if (!rest) break;
          ls = base + to;
          from = to;
        }
        if (run - base < 32) m &= (1u << (run - base)) - 1;
        mask[h] = m;
        cnt += __popc(m);
      }
    }
    int x = cnt;
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o, 4);
      if (part >= o) x += y;
    }
    int rank = x - cnt;
    const int lane_end = s_lim[i] - kUHead;  // steps of the lane from t0
    uint8_t* out = s_packed + kUGuard + i * kUPackedPitch;
    // the start bits of the thread's 64 steps and the 32 after them
    const unsigned long long st_lo = st[2 * part] | (unsigned long long)st[2 * part + 1] << 32;
    const unsigned long long st_hi = st[2 * part + 2];
    const uint32_t* row32 = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      for (unsigned rest = mask[h]; rest; rest &= rest - 1) {
        const int q = 32 * (2 * part + h) + __ffs(rest) - 1;
        // live bases: up to the next record start, the lane's end, four
        const int rel = q + 1 - 64 * part;  // 1 .. 64
        const unsigned long long after = rel < 64 ? (st_lo >> rel) | (st_hi << (64 - rel)) : st_hi;
        const int live = min(__ffs(((unsigned)after & 7u) | 8u), lane_end - q);
        const uint32_t b4 = __funnelshift_r(row32[q >> 2], row32[(q >> 2) + 1], 8 * (q & 3));
        unsigned byte = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < live) byte |= ((b4 >> (8 * k)) << (2 * k)) & 0xffu;
        out[rank++] = (uint8_t)byte;
      }
    }
    if (part == 3) s_len[i] = x;
  }
  // 5. the runs' 16-byte units, numbered over the lanes
  __syncthreads();
  if (tid < 32) {
    int u[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = 2 * tid + k;
      const long long d = s_dst[i];
      const int len = s_len[i];
      u[k] = len > 0 ? (int)(((d + len - 1) >> 4) - (d >> 4) + 1) : 0;
    }
    int x = u[0] + u[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (tid >= o) x += y;
    }
    s_units[2 * tid] = x - u[0] - u[1];
    s_units[2 * tid + 1] = x - u[1];
    if (tid == 31) s_units[kULanes] = x;
  }
  __syncthreads();
  // a unit's bytes: the lane's run read as aligned words, realigned; the
  // deltas subtract the previous symbol except at a record's start
  auto unit = [&](int k, int& i, long long& x0, int& o, uint32_t (&v)[4]) {
    int lo = 0, hi = kULanes;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_units[mid] <= k) lo = mid;
      else hi = mid;
    }
    i = lo;
    const long long d = s_dst[i];
    x0 = ((d >> 4) + (k - s_units[i])) << 4;
    o = (int)(x0 - d);  // the unit's first byte in the run (> -16)
    if (a.mode == kPacked) {
      row16(s_packed + kUGuard + i * kUPackedPitch, o, v);
      return;
    }
    const uint8_t* row = s_rows + kUGuard + i * kUPitch + kUHead;
    row16(row, o, v);
    if (a.mode == kDelta) {
      uint32_t pv[4];
      row16(row, o - 1, pv);
      const unsigned sbits = start_bits16(s_starts[i], o);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t m = byte_mask((sbits >> (4 * c)) & 15u);
        v[c] = (v[c] & m) | (__vsub4(v[c], pv[c]) & ~m);
      }
    }
  };
  // whole units as 16-byte stores; the runs' end units after them, by bytes
  const int units = s_units[kULanes];
  for (int k = tid; k < units; k += kUThreads) {
    int i, o;
    long long x0;
    uint32_t v[4];
    unit(k, i, x0, o, v);
    if (o >= 0 && o + 16 <= s_len[i])
      *reinterpret_cast<uint4*>(a.dst + x0) = make_uint4(v[0], v[1], v[2], v[3]);
    else
      s_edge[atomicAdd(&s_nedge, 1)] = k;
  }
  __syncthreads();
  for (int e = tid; e < s_nedge; e += kUThreads) {
    int i, o;
    long long x0;
    uint32_t v[4];
    unit(s_edge[e], i, x0, o, v);
    const int len = s_len[i];
    for (int b = max(0, -o); b < 16 && o + b < len; ++b)
      a.dst[x0 + b] = (uint8_t)(v[b >> 2] >> (8 * (b & 3)));
  }
  // 6. the fault flag: the last CTA writes it
  if (tid == 0) {
    const unsigned long long tag = (a.epoch << 2) | kFaulted;
    if (s_bad) st_relaxed(a.status, tag);
    __threadfence();
    const unsigned ctas = gridDim.x * gridDim.y;
    if (atomicInc(a.ticket, ctas - 1) == ctas - 1) {
      __threadfence();
      *a.fault = ld_relaxed(a.status) == tag ? 1 : 0;
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 132;
  return sms > 0 ? sms : 132;
}

// Raises a kernel's dynamic shared memory cap to `bytes`, once per device.
cudaError_t raise_smem(const void* fn, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> raised;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  if (raised.count({fn, dev})) return cudaSuccess;
  rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess) raised.insert({fn, dev});
  return rc;
}

// Launches the layout kernel of one (model, order) or the start matrix's.
template <int kModel, int kOrder, bool kEnc>
int launch_layout(const LayoutArgs& a, cudaStream_t s) {
  constexpr int smem = kEnc ? kLSmem : 0;
  cudaError_t rc = raise_smem((const void*)wctx_layout_kernel<kModel, kOrder, kEnc>, smem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)((a.steps + kLSteps - 1) / kLSteps),
                  (unsigned)((a.lanes + kLLanes - 1) / kLLanes));
  wctx_layout_kernel<kModel, kOrder, kEnc><<<grid, kLThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// delta: n bytes (16-byte aligned, n < 2^31); bounds: nrec + 1 int64 record
// starts (bounds[nrec] = n). raw: n bytes (16-byte aligned); hist: (3072, 256)
// uint32, zeroed here. ticket: a u32 left at 0 by every launch; status:
// kStatusWords u64 per tile of kQTile bytes, zeroed once; epoch: a number the
// stream's launches have not used (>= 1).
int fq_qctx_prepare(const void* delta, long long n, const void* bounds, long long nrec, void* raw,
                    void* hist, void* ticket, void* status, long long epoch, void* stream) {
  if (n < 0 || n >= (1LL << 31) || nrec < 0 || epoch < 1 || (uintptr_t)delta % 16 ||
      (uintptr_t)raw % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(hist, 0, sizeof(unsigned) * (size_t)kQctxBins, s);
  if (rc != cudaSuccess) return (int)rc;
  if (nrec && n) {
    QctxArgs a;
    a.delta = (const uint8_t*)delta;
    a.n = n;
    a.bounds = (const long long*)bounds;
    a.nrec = nrec;
    a.raw = (uint8_t*)raw;
    a.hist = (unsigned*)hist;
    a.tiles = (n + kQTile - 1) / kQTile;
    a.ticket = (unsigned*)ticket;
    a.status = (unsigned long long*)status;
    a.epoch = (unsigned long long)epoch;
    rc = raise_smem((const void*)qctx_prepare_kernel, kQTableBytes);
    if (rc != cudaSuccess) return (int)rc;
    const long long most = (long long)kQCtasPerSm * sm_count();
    const unsigned grid = (unsigned)(a.tiles < most ? a.tiles : most);
    qctx_prepare_kernel<<<grid, kQThreads, kQTableBytes, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// packed: packed_n bytes (4-byte aligned); bounds: (2, nrec + 1) int64, the
// records' first base and first packed byte. bases: bounds[0][nrec] bytes
// (16-byte aligned); hist: (4096, 4) uint32, zeroed here.
int fq_sctx_prepare(const void* packed, long long packed_n, const void* bounds, long long nrec,
                    void* bases, void* hist, void* stream) {
  if (packed_n < 0 || nrec < 0 || (uintptr_t)packed % 4 || (uintptr_t)bases % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(hist, 0, sizeof(unsigned) * (size_t)kSctxBins, s);
  if (rc != cudaSuccess) return (int)rc;
  if (nrec) {
    rc = raise_smem((const void*)sctx_prepare_kernel, kSSmem);
    if (rc != cudaSuccess) return (int)rc;
    const long long* b = (const long long*)bounds;
    SctxArgs a;
    a.packed = (const uint8_t*)packed;
    a.packed_n = packed_n;
    a.bounds = b;
    a.pbounds = b + nrec + 1;
    a.nrec = nrec;
    a.bases = (uint8_t*)bases;
    a.hist = (unsigned*)hist;
    // the bases (read on the card) are at most four a packed byte
    const long long want = (4 * packed_n + kSTile - 1) / kSTile;
    const long long most = sm_count();
    const unsigned grid = (unsigned)(want < 1 ? 1 : want < most ? want : most);
    sctx_prepare_kernel<<<grid, kSThreads, kSSmem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// The (steps, lanes) matrices of one wctx stream. bounds: nrec + 1 int64
// record starts; lanes_tab: (2, lanes + 1) int64, each lane's first symbol
// and first record. Encode (syms: the flat symbols, 16-byte aligned):
// sym_out (present index, idx_map[pad_sym] on padding) and ctx_out; decode
// (syms null): start_out. (model, order): (0, 2), (0, 4), (0, 6), (1, 0)
// or (1, 1).
int fq_wctx_layout(const void* syms, const void* bounds, const void* lanes_tab, int lanes,
                   int steps, int model, int order, const void* idx_map, int pad_sym,
                   void* sym_out, void* ctx_out, void* start_out, void* stream) {
  if (lanes <= 0 || steps <= 0 || pad_sym < 0 || pad_sym > 255 || (uintptr_t)syms % 16)
    return (int)cudaErrorInvalidValue;
  LayoutArgs a;
  a.syms = (const uint8_t*)syms;
  a.bounds = (const long long*)bounds;
  a.lanes_tab = (const long long*)lanes_tab;
  a.lanes = lanes;
  a.steps = steps;
  a.idx_map = (const uint8_t*)idx_map;
  a.pad_sym = pad_sym;
  a.sym_out = (uint8_t*)sym_out;
  a.ctx_out = (int16_t*)ctx_out;
  a.start_out = (uint8_t*)start_out;
  cudaStream_t s = (cudaStream_t)stream;
  if (!syms) return launch_layout<0, 0, false>(a, s);
  switch (model * 8 + order) {
    case 2: return launch_layout<0, 2, true>(a, s);
    case 4: return launch_layout<0, 4, true>(a, s);
    case 6: return launch_layout<0, 6, true>(a, s);
    case 8: return launch_layout<1, 0, true>(a, s);
    case 9: return launch_layout<1, 1, true>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The decoded (steps, lanes) present-index matrix in record order. bounds:
// (1 or, for the packed mode, 2, nrec + 1) int64 as in fq_sctx_prepare;
// dst: the flat symbols or the quality deltas (n bytes) or the packed rows,
// 16-byte aligned; fault: one int32, written 1 where a data cell's index is
// >= npres, else 0. ticket, status, epoch: as fq_qctx_prepare's (the first
// status word is used).
int fq_wctx_unlayout(const void* mat, const void* bounds, long long nrec, const void* lanes_tab,
                     int lanes, int steps, const void* present, int npres, int mode, void* dst,
                     void* fault, void* ticket, void* status, long long epoch, void* stream) {
  if (lanes <= 0 || steps <= 0 || npres <= 0 || npres > 256 || mode < kFlat || mode > kDelta ||
      epoch < 1 || (uintptr_t)dst % 16)
    return (int)cudaErrorInvalidValue;
  const long long* b = (const long long*)bounds;
  UnlayoutArgs a;
  a.mat = (const uint8_t*)mat;
  a.bounds = b;
  a.pbounds = mode == kPacked ? b + nrec + 1 : nullptr;
  a.lanes_tab = (const long long*)lanes_tab;
  a.lanes = lanes;
  a.steps = steps;
  a.present = (const uint8_t*)present;
  a.npres = npres;
  a.mode = mode;
  a.dst = (uint8_t*)dst;
  a.fault = (int*)fault;
  a.ticket = (unsigned*)ticket;
  a.status = (unsigned long long*)status;
  a.epoch = (unsigned long long)epoch;
  const dim3 grid((unsigned)((steps + kUSteps - 1) / kUSteps),
                  (unsigned)((lanes + kULanes - 1) / kULanes));
  wctx_unlayout_kernel<<<grid, kUThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
