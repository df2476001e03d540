// The v3 header tokenizer on Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// fq_tok_encode and fq_tok_decode replace fastqpacker_tpu/runtime/
// fqruntime.cpp:1355 fq_tok_encode and :1445 fq_tok_decode. The plain
// versions are the pure-Python ops/tokenize.py encode_plain / decode_plain,
// and they are the specification: the same tokenized bytes, the same
// header stream back, and for a stream the plain version refuses, the same
// fault (the first in stream order), which the wrapper names with the
// plain version's string.
//
// Bytes bound both (a few MB in and out a block); what held the first
// design was latency: a chain handed from tile to tile in series, and
// ceil(log2(count)) + 1 launches of pointer jumping. This design:
//
// chain_kernel: the nodes of a chain whose next node follows from the
// node's own bytes: the record starts of a u16-length-prefixed header
// stream (s + 2 + len(s)), or the op starts of a tokenized stream (an op
// byte, then a varint, then a literal's bytes). Tiles of 8,192 bytes,
// staged in shared memory by 16-byte loads, a CTA each in ticket order. A
// thread per 16-byte segment maps where the chain from each of its bytes
// leaves the segment (with the nodes and OP_ENDs on the way), and two
// doublings map where it leaves each 64-byte block; the chain enters a
// tile at one of its first kWindow bytes unless a long op crosses its
// start, so a thread per window byte walks the block maps out of the tile,
// and those exits are the tile's aggregate. A tile composes the aggregates
// of the tiles before it (decoupled look-back) down to the nearest that
// knows its own entry; an entry past a tile's window (a literal longer
// than kWindow across the boundary) waits for that tile's own result
// instead. The entry's walk noted where it entered each block, so each
// thread finds where it enters its segment and lists the segment's nodes,
// ranked by a CTA scan; each OP_END gives its record's successor its first
// op.
//
// fq_tok_encode: CTAs of 256 records in ticket order (one wave at 100,000
// records), a thread a record. The record starts come from the block's
// header lengths (the record scan had them on the card: an exclusive sum
// of 2 + len by a CTA scan and a look-back), or from chain_kernel for a
// bare stream. Each CTA stages the stream bytes of its records and their
// predecessor record in shared memory with 16-byte loads, splits each
// header and its predecessor's into digit and non-digit runs in step and
// picks MATCH / DELTA / DELTA_PAD / LIT exactly as the plain version does;
// the op bytes are sized, placed by a CTA scan and a second look-back,
// built in shared memory and stored as aligned 16-byte units after
// varint(len(stream)). A tile too large for the staging reads and writes
// device memory directly.
//
// fq_tok_decode, two calls with the fault and the output size read back
// between them (the output is sized from the decoded lengths, never from
// the declared total):
// 1. chain_kernel lists the ops (the leading varint is read on the card);
//    resolve_kernel takes tiles of 128 records in ticket order. Token
//    (r, i) has token (r - 1, i) as its predecessor, so each column of a
//    tile is a chain down its records, and the ops compose associatively:
//    a LIT is a constant, a MATCH the identity, a DELTA / DELTA_PAD adds
//    its delta (128-bit: a 10-byte varint carries 2^70) and renders the
//    width of the digits (DELTA) or keeps the predecessor's (DELTA_PAD). A
//    CTA stages its ops' bytes and their parsed ops column-major in shared
//    memory (24 columns at a time; wider records loop over chunks of
//    columns). A warp takes a column: each lane composes 4 records, a
//    shuffle tree the lanes, and the column of the last record is the
//    tile's aggregate. Its carry comes from a look-back over the tiles
//    before, 32 a round, their aggregates composed down to a constant or a
//    tile that published its last record's tokens (a tile whose column is
//    MATCHes from a token its predecessor has is skipped unread); the
//    lanes' records then resolve from an exclusive scan of their
//    functions, each op checked against its predecessor's token in the
//    plain decoder's order (the first fault in stream order wins: a
//    minimum of position * 16 + code; "header exceeds 65535 bytes" at the
//    record's OP_END, the truncation at n when the chain has fewer than
//    count records). The tile publishes its last record's tokens as soon
//    as its columns resolve, then writes each token's state and offset in
//    its record (a thread an op) and places the records' output by a CTA
//    scan and a look-back. Every token before the first fault has its true
//    value (its column runs through earlier tokens only); ops of records
//    past count are never looked at.
// 2. write_kernel: a CTA per tile of records renders its output into
//    16 KiB windows of shared memory (literal bytes, or digits zero-padded
//    to the width; each record's u16 length) and stores them as aligned
//    16-byte units.
// Four device operations a call at any count: two kernels, the read-back,
// the write.
//
// Ticket words and status words persist per CUDA stream (the wrapper's):
// every launch leaves the ticket at 0 and takes an epoch of its own, so the
// status words are never cleared. A tile's word 15 is records.cu's hand-off
// word (0 between launches); nothing here writes it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// op bytes of the tokenized stream (ops/tokenize.py)
constexpr uint8_t kOpEnd = 0, kOpMatch = 1, kOpDelta = 2, kOpPad = 3, kOpLit = 4;
constexpr int kMaxDigits = 18;

// fault codes, in the order the plain decoder checks them within one op
// (ops/tokenize.py TOK_FAULTS; the wrapper names them)
enum {
  kFaultNone = 0,
  kFaultVarint = 1,      // truncated varint in tokenized header data
  kFaultTrunc = 2,       // truncated tokenized header data
  kFaultMatch = 3,       // header token match without predecessor
  kFaultDeltaPred = 4,   // header token delta without numeric predecessor
  kFaultNegative = 5,    // negative header token value
  kFaultWider = 6,       // header token wider than its field
  kFaultUnknown = 7,     // unknown header token op: {op}
  kFaultLong = 8,        // header exceeds 65535 bytes
};
constexpr long long kNoFault = 0x7fffffffffffffffLL;

// info slots (ops/tokenize.py TOK_INFO_*)
enum {
  kInfoNodes = 0,     // chain nodes below n
  kInfoExit = 1,      // the node after the chain's last (n or n + 1)
  kInfoEnds = 2,      // decode: OP_END ops on the chain
  kInfoFault = 3,     // encode: fault code; decode: min(position * 16 + code)
  kInfoSize = 4,      // output bytes
  kInfoMismatch = 5,  // decode: the output size differs from the declared total
  kInfoTotalLo = 6,   // decode: the declared total (the leading varint)
  kInfoTotalHi = 7,
  kInfoSlots = 8
};
// encode faults (kEncLengths: the header lengths disagree with the stream)
enum { kEncTruncated = 1, kEncTrailing = 2, kEncLengths = 3 };

// a tile's status words (ops/records.py STATUS_WORDS): two flags (epoch << 2
// | state), each with an aggregate and an inclusive slot
constexpr int kStatusWords = 16;
constexpr int kFlagA = 0, kAggA = 1, kInclA = 6;  // the chain's inclusive: kInclA .. + 2
constexpr int kFlagB = 11, kAggB = 12, kInclB = 13;
constexpr int kClean = 12;  // the resolve's columns 0-63 whose aggregate is the identity
constexpr unsigned long long kAggregate = 1, kInclusive = 2;

constexpr int kChainThreads = 512;
constexpr int kChainTile = 8192;   // bytes per tile of the chain kernel (two CTAs an SM)
constexpr int kSeg = kChainTile / kChainThreads;  // bytes a thread parses: a segment
constexpr int kWindow = 64;        // candidate entries a chain tile publishes
constexpr int kComposeTiles = 32;  // aggregates composed per round of a look-back
static_assert(kSeg == 16, "a segment's map entry holds up to 16 nodes");

constexpr int kEncRecords = 256;   // records (threads) per CTA of the encode: one wave
constexpr int kEncIn = 28672;      // stream bytes an encode CTA stages
constexpr int kEncOut = 16384;     // op bytes it builds in shared memory

constexpr int kTokRecords = 128;   // records per CTA of the resolve and the write
constexpr int kTokCols = 24;       // columns staged at a time
constexpr int kTokThreads = 192;   // a warp a column at a time
constexpr int kTokRows = kTokRecords / 32;  // records a lane composes
constexpr int kTokStage = 12288;   // stream bytes a resolve CTA stages (its records' ops)
constexpr int kWriteWindow = 16384;  // output bytes a write CTA renders at a time
constexpr int kWriteThreads = 128;  // six CTAs an SM: the write in one wave
static_assert(kTokRecords <= kTokThreads && kTokRecords <= kWriteThreads, "a thread per record");

typedef unsigned __int128 u128;
typedef __int128 i128;

// ---------------------------------------------------------------------------
// warp and CTA scans, tickets, status words (as csrc/records.cu)
// ---------------------------------------------------------------------------

__device__ inline long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ inline long long warp_incl(long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Exclusive prefix of v over the CTA; *total gets the CTA's sum. sh: 33
// shared slots. Every thread must call it.
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
  const long long ex = sh[warp] + incl - v;
  *total = sh[32];
  __syncthreads();  // sh is reused by the next call
  return ex;
}

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

// The CTA's tile from the ticket counter (atomicInc: the launch's last
// ticket wraps it back to 0). Every thread must call it.
__device__ inline long long take_ticket(unsigned* ticket) {
  __shared__ unsigned s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicInc(ticket, gridDim.x - 1);
  __syncthreads();
  const long long t = s_ticket;
  __syncthreads();
  return t;
}

__device__ inline unsigned long long flag_of(unsigned long long epoch, unsigned long long state) {
  return (epoch << 2) | state;
}

__device__ inline unsigned long long state_of(unsigned long long f, unsigned long long epoch) {
  return (f >> 2) == epoch ? (f & 3) : 0;
}

// The exclusive prefix over the tiles of a launch of the tile's sum v (the
// same in every thread), the value behind `flag`: the tile publishes v as
// its aggregate, then the whole CTA looks back, a tile a thread (each round
// reads blockDim.x tiles at once, each thread waiting for its tile's
// aggregate, and sums them down to the nearest inclusive one, so a tile far
// from the nearest inclusive tile waits tile / blockDim.x round trips), and
// publishes its inclusive sum. Every thread must call it.
__device__ long long tile_prefix(unsigned long long* status, long long tile,
                                 unsigned long long epoch, long long v, int flag, int agg,
                                 int incl) {
  __shared__ long long sh[33];
  __shared__ int s_near;
  unsigned long long* st = status + tile * kStatusWords;
  long long pre = 0;
  if (tile > 0) {
    if (threadIdx.x == 0) {
      st_relaxed(st + agg, (unsigned long long)v);
      st_release(st + flag, flag_of(epoch, kAggregate));
    }
    for (long long end = tile; end > 0; end -= blockDim.x) {
      const long long j = end - 1 - threadIdx.x;
      unsigned long long state = 0;
      if (j >= 0) {
        do {
          state = state_of(ld_acquire(status + j * kStatusWords + flag), epoch);
        } while (!state);
      }
      if (threadIdx.x == 0) s_near = blockDim.x;
      __syncthreads();
      if (state == kInclusive) atomicMin(&s_near, (int)threadIdx.x);
      __syncthreads();
      const int near = s_near;
      const bool mine = j >= 0 && (int)threadIdx.x <= near;
      const long long x =
          mine ? (long long)ld_relaxed(status + j * kStatusWords +
                                       (state == kInclusive ? incl : agg))
               : 0;
      long long total;
      block_excl(x, &total, sh);
      pre += total;
      if (near < (int)blockDim.x) break;  // uniform: the nearest inclusive tile is in
    }
  }
  if (threadIdx.x == 0) {
    st_relaxed(st + incl, (unsigned long long)(pre + v));
    st_release(st + flag, flag_of(epoch, kInclusive));
  }
  return pre;
}

// The nearest tile before `tile` (> 0) whose `flag` is inclusive, once the
// tiles between are at least aggregate; by one whole warp.
__device__ long long nearest_inclusive(const unsigned long long* status, long long tile,
                                       unsigned long long epoch, int flag) {
  const int lane = threadIdx.x & 31;
  for (long long end = tile;; end -= 32) {
    const long long j = end - 1 - lane;
    const unsigned valid = __ballot_sync(kFull, j >= 0);
    unsigned long long state = 0;
    unsigned need, inc;
    for (;;) {
      if (j >= 0) state = state_of(ld_acquire(status + j * kStatusWords + flag), epoch);
      inc = __ballot_sync(kFull, state == kInclusive) & valid;
      const unsigned first = inc & (0u - inc);
      need = first ? (first | (first - 1)) : valid;
      if (!(__ballot_sync(kFull, state == 0) & need)) break;
    }
    if (inc) return end - __ffs(inc);  // tile 0 is always inclusive in the end
  }
}

// Bytes [lo, hi) of out (16-byte aligned at index 0) from buf, which holds
// out[b ..] (b a multiple of 16, buf 16-byte aligned): whole aligned units
// as 16-byte stores, the partial units at either end a byte at a time.
__device__ void store_range(uint8_t* out, long long lo, long long hi, const uint8_t* buf,
                            long long b) {
  for (long long u = (lo & ~15LL) + 16LL * threadIdx.x; u < hi; u += 16LL * blockDim.x) {
    if (u >= lo && u + 16 <= hi) {
      *reinterpret_cast<uint4*>(out + u) = *reinterpret_cast<const uint4*>(buf + (u - b));
    } else {
      const long long e = u + 16 < hi ? u + 16 : hi;
      for (long long p = u > lo ? u : lo; p < e; ++p) out[p] = buf[p - b];
    }
  }
}

// Copies data[lo, hi) into shared memory at buf (16-byte aligned, hi - lo +
// 15 bytes) and returns d with d[p] == data[p] for lo <= p < hi: aligned
// 16-byte loads, the bytes of the partial units at either end one at a
// time. Every thread must call it; it ends with a barrier.
__device__ const uint8_t* stage_bytes(const uint8_t* data, long long lo, long long hi,
                                      uint8_t* buf) {
  const long long head = (long long)((uintptr_t)(data + lo) & 15);
  const long long ab = lo - head;  // data + ab is 16-byte aligned
  for (long long u = ab + 16LL * threadIdx.x; u < hi; u += 16LL * blockDim.x) {
    if (u >= lo && u + 16 <= hi) {
      *reinterpret_cast<uint4*>(buf + (u - ab)) = __ldg(reinterpret_cast<const uint4*>(data + u));
    } else {
      const long long e = u + 16 < hi ? u + 16 : hi;
      for (long long p = u > lo ? u : lo; p < e; ++p) buf[p - ab] = data[p];
    }
  }
  __syncthreads();
  return buf - ab;
}

// ---------------------------------------------------------------------------
// the two chains
// ---------------------------------------------------------------------------

__device__ inline bool is_digit(uint8_t b) { return b >= '0' && b <= '9'; }

// A varint at p of the n-byte data, as the plain decoder reads it: up to 10
// bytes (shifts 0 .. 63), each a 7-bit group. Returns false when the data
// ends first or a 10th byte continues; else *q is the byte after it and *v
// its value (up to 2^70 - 1).
__device__ inline bool read_varint(const uint8_t* data, long long n, long long p, long long* q,
                                   u128* v) {
  u128 x = 0;
  for (int k = 0; k < 10; ++k) {
    if (p + k >= n) return false;
    const uint8_t b = data[p + k];
    x |= (u128)(b & 0x7f) << (7 * k);
    if (!(b & 0x80)) {
      *q = p + k + 1;
      *v = x;
      return true;
    }
  }
  return false;
}

struct ChainArgs {
  const uint8_t* data;
  long long n;      // nodes 0 .. n - 1 are bytes; n the end; n + 1 absorbs
  int ops;          // 0: u16-prefixed records from byte 0; 1: ops after varint(total)
  long long count;  // ops: records whose first op recstart gives
  int tiles;
  int* list;        // the chain's nodes below n, in order
  long long cap;    // entries of list (nodes past it are not written)
  int* recstart;    // ops: count + 2 entries, record r's first op
  unsigned long long* maps;  // tiles * kWindow: each tile's aggregate
  long long* info;  // kInfoNodes, kInfoExit, kInfoEnds (ops: kInfoFault, kInfoTotal*)
  unsigned* ticket;
  unsigned long long* status;
  unsigned long long epoch;
};

// The node after p (< n): n + 1 when its record, varint or literal leaves
// the stream, or its op is unknown.
// d[p]: the stream's byte p (staged in shared memory around the tile).
__device__ inline long long chain_next(const ChainArgs& a, const uint8_t* d, long long p) {
  const long long n = a.n;
  if (!a.ops) {
    if (p + 2 > n) return n + 1;
    const long long q = p + 2 + ((long long)d[p] | ((long long)d[p + 1] << 8));
    return q <= n ? q : n + 1;
  }
  const uint8_t op = d[p];
  if (op == kOpEnd || op == kOpMatch) return p + 1;
  if (op != kOpDelta && op != kOpPad && op != kOpLit) return n + 1;
  long long q;
  u128 v;
  if (!read_varint(d, n, p + 1, &q, &v)) return n + 1;
  if (op != kOpLit) return q;
  return v > (u128)(n - q) ? n + 1 : q + (long long)v;
}

__device__ inline bool is_end(const ChainArgs& a, const uint8_t* d, long long p) {
  return a.ops && d[p] == kOpEnd;
}

// A segment's map: for each of its kSeg bytes p, where the chain from p
// leaves the segment (its first node at or past the segment's end, or n,
// or n + 1), relative to the segment's start (bits 0-21; kFar: too far,
// walk the segment again), and the nodes (bits 22-26) and OP_ENDs (bits
// 27-31) from p to there. Built right to left: a node's successor inside
// the segment has its word already.
constexpr uint32_t kFar = 0x3fffff;

// A block's map: for each byte p, where the chain from p leaves its block
// of kBlock bytes, relative to the block's start (bits 0-17; kBlockFar:
// walk the segment maps instead), and the nodes (18-24) and OP_ENDs
// (25-31) on the way. Built from the segment maps by doubling: a byte in
// the first half of a block of 2 segments (then 4) takes on from where its
// segment's exit lands in the second half.
constexpr int kBlock = 4 * kSeg;
constexpr int kBlocks = kChainTile / kBlock;
constexpr uint32_t kBlockFar = 0x3ffff;

struct ChainSmem {
  uint32_t map[kChainTile];           // the segments' maps
  uint32_t block[kChainTile];         // the blocks' maps
  uint8_t in[kBlocks][kWindow];       // where candidate c's walk enters each block
  unsigned long long maps[kComposeTiles * kWindow];  // the aggregates a round composes
  __align__(16) uint8_t bytes[kChainTile + 48];  // the tile and the 16 bytes after it
};
constexpr int kChainSmem = (int)sizeof(ChainSmem);
constexpr uint8_t kNoEntry = 0xff;

__device__ inline uint32_t seg_word(long long exit, long long sb, int nodes, int ends) {
  const long long rel = exit - sb;
  return (uint32_t)(rel < kFar ? rel : kFar) | ((uint32_t)nodes << 22) | ((uint32_t)ends << 27);
}

// The walk of the chain from tile byte k (relative to the tile) over the
// segment maps until it reaches tile byte `until` or the stream's end:
// adds its nodes and OP_ENDs, returns where it stops.
__device__ __forceinline__ int walk_segments(const ChainArgs& a, const uint8_t* d,
                                             const uint32_t* map, long long base, int k,
                                             int until, int* nd, int* en) {
  while (k < until && base + k < a.n) {
    const uint32_t w = map[k];
    const int sb = k & ~(kSeg - 1);
    if ((w & kFar) == kFar) {  // a literal too long for the word: its segment again
      long long y = base + k;
      const long long se = base + sb + kSeg;
      while (y < se && y < a.n) {
        ++*nd;
        *en += is_end(a, d, y);
        y = chain_next(a, d, y);
      }
      k = (int)(y - base);
      continue;
    }
    k = sb + (int)(w & kFar);
    *nd += (w >> 22) & 31;
    *en += w >> 27;
  }
  return k;
}

// The walk of the chain from node x (base <= x < n, inside the tile) out of
// the tile over the block maps: adds the nodes and OP_ENDs on the way,
// returns the exit. With rec, notes in rec[b * kWindow] the offset at which
// it enters each block b.
__device__ __forceinline__ long long walk(const ChainArgs& a, const uint8_t* d,
                                          const ChainSmem& m, long long base, long long x,
                                          long long* nodes, long long* ends, uint8_t* rec) {
  // positions relative to the tile (below 2^31: n is)
  const int end = (int)((base + kChainTile < a.n ? base + kChainTile : a.n) - base);
  int k = (int)(x - base), nd = 0, en = 0;
  while (k < end) {
    const int b = k / kBlock, bb = b * kBlock;
    if (rec) rec[b * kWindow] = (uint8_t)(k - bb);
    const uint32_t w = m.block[k];
    if ((w & kBlockFar) == kBlockFar) {  // too far or too many: the segments instead
      const int until = bb + kBlock < end ? bb + kBlock : end;
      k = walk_segments(a, d, m.map, base, k, until, &nd, &en);
      continue;
    }
    k = bb + (int)(w & kBlockFar);
    nd += (w >> 18) & 127;
    en += w >> 25;
  }
  *nodes += nd;
  *ends += en;
  return base + k;
}

// One tile of the chain, a CTA each, tiles in ticket order:
// 1. a thread per segment of kSeg bytes builds the segment's map, then the
//    block maps; the chain from each of the tile's first kWindow bytes
//    walks out of the tile over the block maps (a thread each, noting
//    where it enters each block): the exits, nodes and OP_ENDs are the
//    tile's aggregate;
// 2. the chain's entry, its index and the OP_ENDs before it from tile 0's
//    start or the nearest tile before that published them, through the
//    aggregates of the tiles between (an entry past a tile's window, where
//    a long op crossed into it, waits for that tile's own result); the
//    tile's exit published as its inclusive value; the last tile writes
//    info;
// 3. each thread walks its segment from where the entry's walk entered it
//    (from its block's entry over the segment maps): its nodes, ranked by a
//    CTA scan, go to the list, each OP_END's
//    successor starts a record.
__global__ void __launch_bounds__(kChainThreads, 2) chain_kernel(ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  ChainSmem& m = *reinterpret_cast<ChainSmem*>(smem);
  __shared__ long long sh[33];
  __shared__ long long s_x, s_nodes, s_ends, s_entry, s_index, s_endbase, s_next;
  __shared__ int s_row;
  const long long t = take_ticket(a.ticket);
  const long long base = t * kChainTile;
  const int tid = threadIdx.x;
  // the tile's bytes and the 16 after it (an op's varint past the tile's end)
  const long long hi = base + kChainTile + 16 < a.n ? base + kChainTile + 16 : a.n;
  const uint8_t* d = stage_bytes(a.data, base, hi, m.bytes);

  // 1. the segments' maps, the window's walks
  const long long sb = base + (long long)tid * kSeg, se = sb + kSeg;
  // each byte's next node first (independent: they overlap), then the
  // segment's words right to left
  int next[kSeg];
  unsigned endmask = 0;
#pragma unroll
  for (int o = 0; o < kSeg; ++o) {
    const long long p = sb + o;
    next[o] = p < a.n ? (int)(chain_next(a, d, p) - sb) : 0;
    endmask |= (unsigned)(p < a.n && is_end(a, d, p)) << o;
  }
#pragma unroll
  for (int o = kSeg - 1; o >= 0; --o) {
    const long long p = sb + o;
    if (p >= a.n) {
      m.map[tid * kSeg + o] = 0;
      continue;
    }
    const long long q = sb + next[o];
    int nodes = 1, ends = (endmask >> o) & 1;
    long long exit = q;
    if (q < se && q < a.n) {
      const uint32_t w = m.map[q - base];
      if ((w & kFar) == kFar) {
        exit = sb + kFar;  // too far for the word: kept so
      } else {
        exit = sb + (w & kFar);
        nodes += (w >> 22) & 31;
        ends += w >> 27;
      }
    }
    m.map[tid * kSeg + o] = seg_word(exit, sb, nodes, ends);
  }
  for (int q = tid; q < kWindow * kBlocks; q += kChainThreads) (&m.in[0][0])[q] = kNoEntry;
  __syncthreads();
  // the block maps: the segment words in the block format, then two
  // doublings (a byte of a block's first half reads a second-half byte,
  // which that round leaves as it is)
  const int nrel = (int)((a.n < base + kChainTile ? a.n : base + kChainTile) - base);  // the tile's bytes
  for (int k = tid; k < kChainTile; k += kChainThreads) {
    const uint32_t w = m.map[k];
    const int rel = (k & ~(kSeg - 1)) - (k & ~(kBlock - 1)) + (int)(w & kFar);
    m.block[k] = (w & kFar) == kFar || rel >= (int)kBlockFar
                     ? kBlockFar
                     : (uint32_t)rel | (((w >> 22) & 31) << 18) | ((w >> 27) << 25);
  }
  __syncthreads();
  for (int span = 2 * kSeg; span <= kBlock; span *= 2) {
    for (int q = tid; q < kChainTile / 2; q += kChainThreads) {
      const int k = (q / (span / 2)) * span + q % (span / 2);  // a first-half byte
      const uint32_t w = m.block[k];
      if ((w & kBlockFar) == kBlockFar) continue;
      const int bb = k & ~(kBlock - 1);
      const int x = bb + (int)(w & kBlockFar);
      const int half_end = (k & ~(span - 1)) + span;
      if (x >= half_end || x >= nrel) continue;  // it leaves this span already
      const uint32_t w2 = m.block[x];
      if ((w2 & kBlockFar) == kBlockFar) {
        m.block[k] = kBlockFar;
        continue;
      }
      const uint32_t nd = ((w >> 18) & 127) + ((w2 >> 18) & 127);
      const uint32_t en = (w >> 25) + (w2 >> 25);
      m.block[k] = (w2 & kBlockFar) | (nd << 18) | (en << 25);
    }
    __syncthreads();
  }
  unsigned long long* st = a.status + t * kStatusWords;
  if (tid < kWindow) {
    unsigned long long w = (unsigned long long)(a.n + 1);
    if (base + tid < a.n) {
      long long nodes = 0, ends = 0;
      const long long x = walk(a, d, m, base, base + tid, &nodes, &ends, &m.in[0][tid]);
      w = (unsigned long long)x | ((unsigned long long)nodes << 32) |
          ((unsigned long long)ends << 48);
    }
    a.maps[t * kWindow + tid] = w;
  }
  __threadfence();
  __syncthreads();

  // 2. the entry, the inclusive value
  if (t == 0) {
    if (tid == 0) {
      long long start = 0;
      if (a.ops) {
        long long q;
        u128 total;
        start = read_varint(a.data, a.n, 0, &q, &total) ? q : a.n + 1;
        a.recstart[0] = 0;
      }
      s_x = start;
      s_nodes = 0;
      s_ends = 0;
    }
  } else {
    if (tid == 0) st_release(st + kFlagA, flag_of(a.epoch, kAggregate));
    if (tid < 32) {
      const long long j0 = nearest_inclusive(a.status, t, a.epoch, kFlagA);
      if (tid == 0) {
        const unsigned long long* sj = a.status + j0 * kStatusWords;
        ld_acquire(sj + kFlagA);
        s_x = (long long)ld_relaxed(sj + kInclA);
        s_nodes = (long long)ld_relaxed(sj + kInclA + 1);
        s_ends = (long long)ld_relaxed(sj + kInclA + 2);
        s_next = j0 + 1;
      }
    }
    __syncthreads();
    // compose the aggregates of the tiles s_next .. t - 1, kComposeTiles at
    // a time staged in shared memory
    for (long long j = s_next; j < t; j = s_next) {
      const long long top = j + kComposeTiles < t ? j + kComposeTiles : t;
      // (published before the flags this CTA acquired: read past the L1)
      const ulonglong2* src = reinterpret_cast<const ulonglong2*>(a.maps + j * kWindow);
      for (long long q = tid; q < (top - j) * kWindow / 2; q += kChainThreads)
        reinterpret_cast<ulonglong2*>(m.maps)[q] = __ldcg(src + q);
      __syncthreads();
      if (tid == 0) {
        long long x = s_x, nodes = s_nodes, ends = s_ends, next = top;
        for (long long jj = j; jj < top; ++jj) {
          const long long b = jj * kChainTile;
          if (x >= a.n || x >= b + kChainTile) continue;  // no node of the chain there
          if (x - b >= kWindow) {
            // a long op crossed into tile jj: its own result, when it is there
            const unsigned long long* sj = a.status + jj * kStatusWords;
            while (state_of(ld_acquire(sj + kFlagA), a.epoch) != kInclusive) {
            }
            x = (long long)ld_relaxed(sj + kInclA);
            nodes = (long long)ld_relaxed(sj + kInclA + 1);
            ends = (long long)ld_relaxed(sj + kInclA + 2);
            next = jj + 1;
            break;
          }
          const unsigned long long w = m.maps[(jj - j) * kWindow + (x - b)];
          x = (long long)(w & 0xffffffffull);
          nodes += (long long)((w >> 32) & 0xffff);
          ends += (long long)(w >> 48);
        }
        s_x = x;
        s_nodes = nodes;
        s_ends = ends;
        s_next = next;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  if (tid == 0) {
    long long x = s_x, nodes = s_nodes, ends = s_ends, entry = -1;
    s_index = nodes;
    s_endbase = ends;
    s_row = 0;
    if (x < a.n && x >= base && x < base + kChainTile) {
      entry = x;
      if (x - base < kWindow) {  // its walk is the window's
        s_row = (int)(x - base);
        const unsigned long long w = a.maps[t * kWindow + s_row];
        x = (long long)(w & 0xffffffffull);
        nodes += (long long)((w >> 32) & 0xffff);
        ends += (long long)(w >> 48);
      } else {  // a long op crossed into the tile: walk from the entry
        for (int b = 0; b < kBlocks; ++b) m.in[b][0] = kNoEntry;
        x = walk(a, d, m, base, x, &nodes, &ends, &m.in[0][0]);
      }
    }
    st_relaxed(st + kInclA, (unsigned long long)x);
    st_relaxed(st + kInclA + 1, (unsigned long long)nodes);
    st_relaxed(st + kInclA + 2, (unsigned long long)ends);
    st_release(st + kFlagA, flag_of(a.epoch, kInclusive));
    if (t == a.tiles - 1) {
      a.info[kInfoNodes] = nodes;
      a.info[kInfoExit] = x;
      a.info[kInfoEnds] = ends;
      if (a.ops) {
        // the declared total; the varint's fault first, else the truncation
        // when the chain ends before count records (the resolve lowers it to
        // an op's fault)
        long long q;
        u128 total = 0;
        const bool ok = read_varint(a.data, a.n, 0, &q, &total);
        a.info[kInfoTotalLo] = (long long)(unsigned long long)total;
        a.info[kInfoTotalHi] = (long long)(unsigned long long)(total >> 64);
        a.info[kInfoFault] = !ok ? kFaultVarint
                                 : ends < a.count ? a.n * 16 + kFaultTrunc : kNoFault;
        if (ends < a.count) a.recstart[ends + 1] = (int)(nodes + 1);  // the partial record
      }
    }
    s_entry = entry;
  }
  __syncthreads();
  if (s_entry < 0) return;

  // 3. each segment's nodes from where the entry's walk entered it, ranked
  // the entry's walk noted where it entered this segment's block: from
  // there, over the segment maps, to this segment (or past it)
  int o = kNoEntry;
  {
    const int bo = m.in[tid * kSeg / kBlock][s_row];
    const int k0 = tid * kSeg, bb = k0 & ~(kBlock - 1);
    if (bo != kNoEntry && bb + bo < k0 + kSeg) {
      int nd = 0, en = 0;
      const int k = bb + bo >= k0 ? bb + bo : walk_segments(a, d, m.map, base, bb + bo, k0, &nd, &en);
      if (k >= k0 && k < k0 + kSeg) o = k - k0;
    }
  }
  int count = 0, ends = 0;
  if (o != kNoEntry) {
    for (long long x = sb + o; x < se && x < a.n; x = chain_next(a, d, x)) {
      ++count;
      ends += is_end(a, d, x);
    }
  }
  long long total;
  long long at = s_index + block_excl(count, &total, sh);
  long long er = s_endbase + block_excl(ends, &total, sh);
  if (o != kNoEntry) {
    for (long long x = sb + o; x < se && x < a.n; x = chain_next(a, d, x)) {
      if (at < a.cap) a.list[at] = (int)x;
      if (is_end(a, d, x)) {
        if (er + 1 <= a.count) a.recstart[er + 1] = (int)(at + 1);
        ++er;
      }
      ++at;
    }
  }
}

// ---------------------------------------------------------------------------
// encode
// ---------------------------------------------------------------------------

__device__ inline int varint_len(unsigned long long v) {
  int k = 1;
  while (v >= 0x80) {
    v >>= 7;
    ++k;
  }
  return k;
}

__device__ inline long long put_varint(uint8_t* out, long long o, unsigned long long v) {
  while (v >= 0x80) {
    out[o++] = (uint8_t)((v & 0x7f) | 0x80);
    v >>= 7;
  }
  out[o++] = (uint8_t)v;
  return o;
}

// The end of the maximal digit or non-digit run that starts at a.
__device__ inline long long run_end(const uint8_t* h, long long a, long long len) {
  const bool d = is_digit(h[a]);
  long long b = a + 1;
  while (b < len && is_digit(h[b]) == d) ++b;
  return b;
}

__device__ inline unsigned long long parse_digits(const uint8_t* p, long long len) {
  unsigned long long v = 0;
  for (long long k = 0; k < len; ++k) v = v * 10 + (p[k] - '0');
  return v;
}

// Record r's ops: its header h (hl bytes) against its predecessor's g (gl
// bytes; gl < 0: none). Writes them at out + o when out is not null;
// returns the bytes they take.
__device__ long long encode_record(const uint8_t* h, long long hl, const uint8_t* g, long long gl,
                                   uint8_t* out, long long o) {
  const long long o0 = o;
  long long a = 0, pa = 0;
  while (a < hl) {
    const long long b = run_end(h, a, hl);
    const bool pok = gl >= 0 && pa < gl;
    const long long pb = pok ? run_end(g, pa, gl) : pa;
    const long long tl = b - a, pl = pb - pa;
    bool same = pok && tl == pl;
    for (long long k = 0; same && k < tl; ++k) same = h[a + k] == g[pa + k];
    if (same) {
      if (out) out[o] = kOpMatch;
      o += 1;
    } else if (pok && is_digit(h[a]) && tl <= kMaxDigits && is_digit(g[pa]) &&
               pl <= kMaxDigits && (tl == 1 || h[a] != '0' || tl == pl)) {
      // an all-digit token is str(value) exactly when it has no leading
      // zero; else it is str(value) zero-padded to its width, which a
      // DELTA_PAD gives when the predecessor has that width
      const long long d = (long long)parse_digits(h + a, tl) - (long long)parse_digits(g + pa, pl);
      const unsigned long long zz = ((unsigned long long)d << 1) ^ (unsigned long long)(d >> 63);
      const bool plain = tl == 1 || h[a] != '0';
      if (out) {
        out[o] = plain ? kOpDelta : kOpPad;
        put_varint(out, o + 1, zz);
      }
      o += 1 + varint_len(zz);
    } else {
      if (out) {
        out[o] = kOpLit;
        const long long q = put_varint(out, o + 1, (unsigned long long)tl);
        for (long long k = 0; k < tl; ++k) out[q + k] = h[a + k];
      }
      o += 1 + varint_len((unsigned long long)tl) + tl;
    }
    a = b;
    pa = pb;
  }
  if (out) out[o] = kOpEnd;
  return o + 1 - o0;
}

struct EncodeArgs {
  const uint8_t* data;
  long long n;
  long long count;
  const long long* lens;  // the header lengths (count, lstride apart), or null:
  long long lstride;
  const int* starts;      // the chain's record starts and
  const long long* info;  // its info
  int vlen;               // bytes of varint(n)
  uint8_t* out;
  long long* out_info;    // kInfoFault, kInfoSize
  unsigned* ticket;
  unsigned long long* status;
  unsigned long long epoch;
};

// A thread per record, CTAs of kEncRecords records in ticket order: the
// record starts (the lengths' exclusive sum: a CTA scan and a look-back, or
// the chain's), the tile's stream bytes staged, the record's ops sized,
// placed by a CTA scan and a second look-back, built in shared memory and
// stored. A bare stream whose chain is not `count` records that end at n
// writes nothing but its fault.
__global__ void __launch_bounds__(kEncRecords) encode_kernel(EncodeArgs a) {
  __shared__ long long sh[33];
  __shared__ __align__(16) uint8_t sin[kEncIn];
  __shared__ __align__(16) uint8_t sout[kEncOut];
  __shared__ long long s_lo, s_hi;
  const long long t = take_ticket(a.ticket);
  const bool last_tile = t == gridDim.x - 1;
  if (!a.lens) {
    const long long nodes = a.info[kInfoNodes], end_node = a.info[kInfoExit];
    if (nodes != a.count || end_node != a.n) {  // uniform over the launch
      if (last_tile && threadIdx.x == 0) {
        a.out_info[kInfoFault] = nodes > a.count ? kEncTrailing : kEncTruncated;
        a.out_info[kInfoSize] = 0;
      }
      return;
    }
  }
  const long long r0 = t * kEncRecords;
  const long long r = r0 + threadIdx.x;
  const long long r1 = r0 + kEncRecords < a.count ? r0 + kEncRecords : a.count;
  const bool live = r < a.count;
  long long s = 0, hl = 0, ps = 0, gl = -1;
  bool lengths_ok = true;
  if (a.lens) {
    hl = live ? a.lens[r * a.lstride] : 0;
    long long sum;
    const long long ex = block_excl(live ? 2 + hl : 0, &sum, sh);
    // a length that no record can have puts every later start past n
    const bool wild = __syncthreads_or(live && (hl < 0 || hl > 0xffff));
    const long long pre =
        tile_prefix(a.status, t, a.epoch, sum + (wild ? 1LL << 40 : 0), kFlagA, kAggA, kInclA);
    s = pre + ex;
    if (live && r > 0) {
      gl = a.lens[(r - 1) * a.lstride];
      ps = s - 2 - gl;
    }
    // any fault puts the last tile's records past n or its sum off n
    if (last_tile) lengths_ok = !wild && pre + sum == a.n;
    if (live && (hl < 0 || hl > 0xffff || s + 2 + hl > a.n)) lengths_ok = false;
    lengths_ok = __syncthreads_and(lengths_ok);
    if (!lengths_ok) {
      // the lengths are not this stream's: the tile writes nothing
      if (last_tile && threadIdx.x == 0) {
        a.out_info[kInfoFault] = kEncLengths;
        a.out_info[kInfoSize] = 0;
      }
      tile_prefix(a.status, t, a.epoch, 0, kFlagB, kAggB, kInclB);  // the next tile's look-back
      return;
    }
  } else if (live) {
    s = a.starts[r];
    hl = (long long)a.data[s] | ((long long)a.data[s + 1] << 8);
    if (r > 0) {
      ps = a.starts[r - 1];
      gl = (long long)a.data[ps] | ((long long)a.data[ps + 1] << 8);
    }
  }
  // the stream bytes of the tile's records and their predecessor
  if (threadIdx.x == 0) s_lo = r > 0 ? ps : s;
  if (live && r == r1 - 1) s_hi = s + 2 + hl;
  __syncthreads();
  const long long lo = s_lo, hi = s_hi;
  // src[p]: stream byte p, staged when the tile's bytes fit
  const uint8_t* src = hi - lo + 15 <= kEncIn ? stage_bytes(a.data, lo, hi, sin) : a.data;
  const uint8_t* h = src + s + 2;
  const uint8_t* g = gl >= 0 ? src + ps + 2 : nullptr;
  const long long size = live ? encode_record(h, hl, g, gl, nullptr, 0) : 0;
  long long total;
  const long long ex = block_excl(size, &total, sh);
  const long long pre = tile_prefix(a.status, t, a.epoch, total, kFlagB, kAggB, kInclB);
  const long long o0 = a.vlen + pre;  // the tile's first op byte
  const long long ob = o0 & ~15LL;
  if (o0 + total - ob <= kEncOut) {
    if (live) encode_record(h, hl, g, gl, sout, o0 - ob + ex);
    __syncthreads();
    store_range(a.out, o0, o0 + total, sout, ob);
  } else if (live) {
    encode_record(h, hl, g, gl, a.out, o0 + ex);
  }
  if (t == 0 && threadIdx.x == 0) put_varint(a.out, 0, (unsigned long long)a.n);
  if (last_tile && threadIdx.x == 0) {
    a.out_info[kInfoFault] = 0;
    a.out_info[kInfoSize] = o0 + total;
  }
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

// A resolved token: kNum, the digits of v zero-padded to width (a numeric
// literal too: its bytes are exactly that); kLit, width bytes of the
// stream from v (a literal that is not numeric); kNone, no token (a record
// with fewer); kJunk, a token whose op faulted (anything).
enum { kNone = 0, kJunk = 1, kLit = 2, kNum = 3, kEnd = 4 };

struct Val {
  u128 v;
  int width;
  int kind;
};

__device__ inline Val mkval(u128 v, int width, int kind) {
  Val x;
  x.v = v;
  x.width = width;
  x.kind = kind;
  return x;
}

__device__ inline bool numeric(const Val& x) { return x.kind == kNum && x.width <= kMaxDigits; }

// A column's function from its predecessor token to its token: a constant
// (kConst: c), the identity (kIdent: no records), or a chain of MATCH /
// DELTA / DELTA_PAD ops: add d; the width of the value's digits after
// adding dr (kRender) or the predecessor's width; with no delta on the way
// (no kHasOp) the predecessor itself. The ops have no predecessor token
// when there is none (kNone): then the value is junk (the op faults).
enum { kConst = 1, kIdent = 2, kHasOp = 4, kRender = 8 };

struct Fn {
  u128 d, dr;
  Val c;
  int flags;
};

__device__ inline Fn constant(const Val& c) {
  Fn f;
  f.d = f.dr = 0;
  f.c = c;
  f.flags = kConst;
  return f;
}

__device__ inline Fn identity() {
  Fn f = constant(mkval(0, 0, kNone));
  f.flags = kIdent;
  return f;
}

// v / 10 in place, returning the remainder (32-bit limbs: no 128-bit divide).
__device__ inline unsigned divmod10(u128& v) {
  unsigned long long rem = 0;
  u128 q = 0;
  for (int k = 3; k >= 0; --k) {
    const unsigned long long cur = (rem << 32) | (unsigned long long)(unsigned)(v >> (32 * k));
    q |= (u128)(cur / 10) << (32 * k);
    rem = cur % 10;
  }
  v = q;
  return (unsigned)rem;
}

// The digits of v (>= 0) as str() writes them.
__device__ inline int ndigits(u128 v) {
  if (!(v >> 64)) {
    const unsigned long long x = (unsigned long long)v;
    int k = 1;
    unsigned long long p = 10;
    while (k < 20 && x >= p) {
      ++k;
      p *= 10;
    }
    return k;
  }
  int k = 0;
  do {
    divmod10(v);
    ++k;
  } while (v);
  return k;
}

__device__ inline Val apply(const Fn& f, const Val& x) {
  if (f.flags & kConst) return f.c;
  if (f.flags & kIdent) return x;
  const Val junk = mkval(0, 0, kJunk);
  if (!(f.flags & kHasOp)) return x.kind == kNone ? junk : x;
  if (!numeric(x)) return junk;
  const u128 v = x.v + f.d;
  if ((i128)v < 0) return junk;
  int w = x.width;
  if (f.flags & kRender) {
    const u128 r = x.v + f.dr;
    if ((i128)r < 0) return junk;
    w = ndigits(r);
  }
  return mkval(v, w, kNum);
}

// g after f.
__device__ inline Fn compose(const Fn& g, const Fn& f) {
  if (g.flags & (kConst)) return g;
  if (g.flags & kIdent) return f;
  if (f.flags & kIdent) return g;
  if (f.flags & kConst) return constant(apply(g, f.c));
  if (!(g.flags & kHasOp)) return f;  // a MATCH keeps f (whose predecessor exists)
  if (!(f.flags & kHasOp)) return g;
  Fn o;
  o.c = f.c;
  o.d = f.d + g.d;
  if (g.flags & kRender) {
    o.dr = f.d + g.dr;
    o.flags = kHasOp | kRender;
  } else {
    o.dr = f.dr;
    o.flags = kHasOp | (f.flags & kRender);
  }
  return o;
}

// A staged op (a slot of the resolve's shared memory): its code (bits 0-2),
// whether its varint and literal are whole (kOk), whether a literal leaves
// the stream (kLeaves), whether a literal is numeric (kDigits); and 16 bytes:
// a delta (signed), or a literal's value (bits 0-63), first byte (64-95) and
// length (96-127). A resolved token takes its slot back: its kind as the
// code, its value (or first byte) in bits 0-71, its width in 72-102 and
// its offset in its record in 103-127.
enum { kSlotNone = 0, kSlotMatch = 1, kSlotDelta = 2, kSlotPad = 3, kSlotLit = 4,
       kSlotUnknown = 5 };
constexpr uint8_t kOk = 8, kLeaves = 16, kDigits = 32;
constexpr u128 kMask72 = (((u128)1) << 72) - 1;   // a resolved token's value,
constexpr u128 kMask103 = (((u128)1) << 103) - 1;  // its width (31 bits), its offset (25)

__device__ inline uint8_t stage_op(const uint8_t* data, long long n, long long p, u128* v) {
  const uint8_t op = data[p];
  *v = 0;
  if (op == kOpMatch) return kSlotMatch | kOk;
  if (op != kOpDelta && op != kOpPad && op != kOpLit) return kSlotUnknown;
  const uint8_t code = op == kOpLit ? kSlotLit : op == kOpDelta ? kSlotDelta : kSlotPad;
  long long q;
  u128 x;
  if (!read_varint(data, n, p + 1, &q, &x)) return code;
  if (op != kOpLit) {
    // (x >> 1) ^ -(x & 1)
    const i128 half = (i128)(x >> 1);
    *v = (u128)((x & 1) ? -half - 1 : half);
    return code | kOk;
  }
  if (x > (u128)(n - q)) return code | kLeaves;
  const long long len = (long long)x;
  bool num = len > 0 && len <= kMaxDigits;
  for (long long k = 0; num && k < len; ++k) num = is_digit(data[q + k]);
  const unsigned long long val = num ? parse_digits(data + q, len) : 0;
  *v = (u128)val | ((u128)(unsigned)q << 64) | ((u128)(unsigned)len << 96);
  return code | kOk | (num ? kDigits : 0);
}

// The function of a staged op on its own (no carry yet).
__device__ inline Fn element(uint8_t code, u128 v) {
  const Val junk = mkval(0, 0, kJunk);
  switch (code & 7) {
    case kSlotNone:
      return constant(mkval(0, 0, kNone));
    case kSlotMatch: {
      Fn f = constant(junk);
      f.flags = 0;
      return f;
    }
    case kSlotDelta:
    case kSlotPad: {
      if (!(code & kOk)) return constant(junk);
      Fn f = constant(junk);
      f.d = f.dr = v;
      f.flags = kHasOp | ((code & 7) == kSlotDelta ? kRender : 0);
      return f;
    }
    case kSlotLit: {
      if (!(code & kOk)) return constant(junk);
      const int len = (int)(unsigned)(v >> 96);
      if (code & kDigits) return constant(mkval((unsigned long long)v, len, kNum));
      return constant(mkval((unsigned)(v >> 64), len, kLit));
    }
    default:
      return constant(junk);
  }
}

// The fault of a staged op against its predecessor token p (kNone: there is
// none), in the plain decoder's order, and its resolved token.
__device__ inline int check(uint8_t code, u128 v, const Val& p, Val* res) {
  const Val junk = mkval(0, 0, kJunk);
  *res = junk;
  switch (code & 7) {
    case kSlotUnknown:
      return kFaultUnknown;
    case kSlotLit:
      if (!(code & kOk)) return (code & kLeaves) ? kFaultTrunc : kFaultVarint;
      *res = element(code, v).c;
      return kFaultNone;
    case kSlotMatch:
      if (p.kind == kNone) return kFaultMatch;
      *res = p;
      return kFaultNone;
    default: {  // DELTA, DELTA_PAD
      if (!numeric(p)) return kFaultDeltaPred;
      if (!(code & kOk)) return kFaultVarint;
      const u128 x = p.v + v;
      if ((i128)x < 0) return kFaultNegative;
      const int w = ndigits(x);
      if ((code & 7) == kSlotPad && w > p.width) return kFaultWider;
      *res = mkval(x, (code & 7) == kSlotPad ? p.width : w, kNum);
      return kFaultNone;
    }
  }
}

// A token's state in device memory, 16 bytes: its value (or a literal's
// first byte) in lo, bits 64-71 of it in meta (bits 20-27) with its width
// (0-16: a width past 65535 bytes makes its header fault anyway) and kind
// (17-19); its offset in its record's output (after the u16 length; bits
// 0-23 of off, which a header that faults may saturate) and its record
// within its tile (24-31). Each tile's last record's tokens are also the
// inclusive values of its columns.
struct __align__(16) Fin {
  unsigned long long lo;
  unsigned meta, off;
};
static_assert(kTokRecords <= 256, "a tile's record fits 8 bits");

__device__ inline Fin mkfin(const u128& v, int width, int kind, long long off, int row) {
  Fin f;
  f.lo = (unsigned long long)v;
  f.meta = (unsigned)(width < 0x1ffff ? width : 0x1ffff) | ((unsigned)kind << 17) |
           ((unsigned)(v >> 64) & 0xff) << 20;
  f.off = (unsigned)(off < 0xffffff ? off : 0xffffff) | ((unsigned)row << 24);
  return f;
}

__device__ inline int fin_width(const Fin& f) { return (int)(f.meta & 0x1ffff); }
__device__ inline int fin_kind(const Fin& f) { return (int)((f.meta >> 17) & 7); }
__device__ inline u128 fin_value(const Fin& f) {
  return (u128)f.lo | ((u128)((f.meta >> 20) & 0xff) << 64);
}

// A column's aggregate: the function from the token before a tile to its
// last record's token.
struct __align__(16) Agg {
  unsigned long long dlo, dhi, rlo, rhi, clo, chi;
  int cwidth, ckind, flags, pad;
};

// A tile's last record's token or aggregate, written by another CTA before
// the flag this one acquired: read past the L1.
__device__ inline Val fin_val(const Fin* f) {
  const ulonglong2 w = __ldcg(reinterpret_cast<const ulonglong2*>(f));
  Fin g;
  g.lo = w.x;
  g.meta = (unsigned)w.y;
  g.off = (unsigned)(w.y >> 32);
  return mkval(fin_value(g), fin_width(g), fin_kind(g));
}

__device__ inline Fn agg_fn(const Agg* g) {
  const ulonglong2* w = reinterpret_cast<const ulonglong2*>(g);
  const ulonglong2 d = __ldcg(w), r = __ldcg(w + 1), c = __ldcg(w + 2), x = __ldcg(w + 3);
  Fn f;
  f.d = ((u128)d.y << 64) | d.x;
  f.dr = ((u128)r.y << 64) | r.x;
  f.c = mkval(((u128)c.y << 64) | c.x, (int)(unsigned)x.x, (int)(unsigned)(x.x >> 32));
  f.flags = (int)(unsigned)x.y;
  return f;
}

__device__ inline void put_agg(Agg* g, const Fn& f) {
  g->dlo = (unsigned long long)f.d;
  g->dhi = (unsigned long long)(f.d >> 64);
  g->rlo = (unsigned long long)f.dr;
  g->rhi = (unsigned long long)(f.dr >> 64);
  g->clo = (unsigned long long)f.c.v;
  g->chi = (unsigned long long)(f.c.v >> 64);
  g->cwidth = f.c.width;
  g->ckind = f.c.kind;
  g->flags = f.flags;
  g->pad = 0;
}

struct DecodeArgs {
  const uint8_t* data;
  long long n;
  long long count;
  const int* ops;       // op positions (the chain's list)
  const int* recstart;  // count + 2: each record's first op
  Fin* fin;             // a state per op
  Agg* agg;             // an aggregate per op (the tiles' last records')
  long long* rbase;     // count + 1: each record's first output byte
  long long* info;      // the chain's, then the fault, size and mismatch
  uint8_t* out;
  unsigned* ticket;
  unsigned long long* status;
  unsigned long long epoch;
};

// Records with a token state: count, or the chain's records and the partial
// one after them when it ends first.
__device__ inline long long records_of(const DecodeArgs& a) {
  const long long ends = a.info[kInfoEnds];
  return ends < a.count ? ends + 1 : a.count;
}

__device__ inline long long tokens_of(const DecodeArgs& a, long long r) {
  return (long long)a.recstart[r + 1] - 1 - a.recstart[r];
}

// The resolve's shared memory.
struct ResolveSmem {
  u128 val[kTokCols * kTokRecords];     // column-major: a column's records in a row
  long long recbytes[kTokRecords];
  int rs[kTokRecords + 1];              // recstart of the tile's records
  uint8_t code[kTokCols * kTokRecords];
  __align__(16) uint8_t bytes[kTokStage + 16];  // the stream bytes of the tile's ops
};

__device__ inline u128 shfl_down(u128 v, int off) {
  const unsigned long long lo = __shfl_down_sync(kFull, (unsigned long long)v, off);
  const unsigned long long hi = __shfl_down_sync(kFull, (unsigned long long)(v >> 64), off);
  return ((u128)hi << 64) | lo;
}

__device__ inline Fn shfl_down(const Fn& f, int off) {
  Fn o;
  o.d = shfl_down(f.d, off);
  o.dr = shfl_down(f.dr, off);
  o.c.v = shfl_down(f.c.v, off);
  o.c.width = __shfl_down_sync(kFull, f.c.width, off);
  o.c.kind = __shfl_down_sync(kFull, f.c.kind, off);
  o.flags = __shfl_down_sync(kFull, f.flags, off);
  return o;
}

__device__ inline u128 shfl_up(u128 v, int off) {
  const unsigned long long lo = __shfl_up_sync(kFull, (unsigned long long)v, off);
  const unsigned long long hi = __shfl_up_sync(kFull, (unsigned long long)(v >> 64), off);
  return ((u128)hi << 64) | lo;
}

__device__ inline Fn shfl_up(const Fn& f, int off) {
  Fn o;
  o.d = shfl_up(f.d, off);
  o.dr = shfl_up(f.dr, off);
  o.c.v = shfl_up(f.c.v, off);
  o.c.width = __shfl_up_sync(kFull, f.c.width, off);
  o.c.kind = __shfl_up_sync(kFull, f.c.kind, off);
  o.flags = __shfl_up_sync(kFull, f.flags, off);
  return o;
}

// Tile j's word for column i of its last record, as a look-back sees it:
// its resolved token (inclusive), or its aggregate, constant when its first
// record has no token i before it; a constant none when that last record
// has no token i (a tile after it breaks the column anyway).
__device__ Fn tile_column(const DecodeArgs& a, long long j, long long i, bool inclusive) {
  const long long last = (j + 1) * kTokRecords - 1;
  const long long k = a.recstart[last] + i;
  if (k >= (long long)a.recstart[last + 1] - 1) return constant(mkval(0, 0, kNone));
  if (inclusive) return constant(fin_val(a.fin + k));
  Fn g = agg_fn(a.agg + k);
  if (!(g.flags & kConst) && (j == 0 || i >= tokens_of(a, j * kTokRecords - 1)))
    g = constant(apply(g, mkval(0, 0, kNone)));
  return g;
}

// The token before tile t (> 0) in column i, which the record before the
// tile has, by one whole warp: windows of the 32 tiles before, a lane each
// (tile_column), composed newest first by a shuffle tree, down to a
// constant. Tiles that pass column i on unchanged (their clean word) are
// skipped unread.
__device__ Val column_carry(const DecodeArgs& a, long long t, long long i) {
  const int lane = threadIdx.x & 31;
  Fn p = identity();
  for (long long end = t;; end -= 32) {
    const long long j = end - 1 - lane;
    const unsigned valid = __ballot_sync(kFull, j >= 0);
    unsigned long long state = 0;
    unsigned need;
    for (;;) {
      if (j >= 0) state = state_of(ld_acquire(a.status + j * kStatusWords + kFlagB), a.epoch);
      const unsigned inc = __ballot_sync(kFull, state == kInclusive) & valid;
      const unsigned first = inc & (0u - inc);
      need = first ? (first | (first - 1)) : valid;
      if (!(__ballot_sync(kFull, state == 0) & need)) break;
    }
    bool clean = true;
    if ((need >> lane) & 1) {
      clean = state == kAggregate && i < 64 &&
              ((ld_relaxed(a.status + j * kStatusWords + kClean) >> i) & 1);
    }
    if (__all_sync(kFull, clean)) continue;
    Fn g = identity();
    if (((need >> lane) & 1) && !clean) g = tile_column(a, j, i, state == kInclusive);
    for (int off = 1; off < 32; off <<= 1) {
      const Fn h = shfl_down(g, off);
      if (lane + off < 32) g = compose(g, h);
    }
    // lane 0 holds the window's function: the newest tile's after the older
    p = compose(p, g);
    const int done = __shfl_sync(kFull, p.flags & kConst, 0);
    if (done) {
      Val c = p.c;
      c.v = ((u128)__shfl_sync(kFull, (unsigned long long)(c.v >> 64), 0) << 64) |
            __shfl_sync(kFull, (unsigned long long)c.v, 0);
      c.width = __shfl_sync(kFull, c.width, 0);
      c.kind = __shfl_sync(kFull, c.kind, 0);
      return c;
    }
  }
}

__device__ inline int slot(int c, int row) { return c * kTokRecords + row; }

// The last of the tile's records whose first op is at or before op k: a
// branchless binary search of their first ops (independent searches
// overlap).
__device__ __forceinline__ int record_of(const int* rs, int rows, long long k) {
  int lo = 0;
#pragma unroll
  for (int step = kTokRecords / 2; step; step >>= 1)
    if (lo + step < rows && rs[lo + step] <= k) lo += step;
  return lo;
}

// Stage columns c0 .. c0 + kTokCols of the tile's records (d: the stream
// bytes of its ops): a thread per slot, the op positions loaded kStagePer
// at a time.
constexpr int kStagePer = 8;

__device__ void stage_columns(const DecodeArgs& a, ResolveSmem& s, const uint8_t* d, int rows,
                              long long c0) {
  for (int q0 = threadIdx.x; q0 < kTokCols * kTokRecords; q0 += blockDim.x * kStagePer) {
    int pos[kStagePer];
#pragma unroll
    for (int q = 0; q < kStagePer; ++q) {
      const int at = q0 + q * blockDim.x, c = at / kTokRecords, row = at % kTokRecords;
      pos[q] = -1;
      if (at < kTokCols * kTokRecords && row < rows &&
          c0 + c < (long long)s.rs[row + 1] - 1 - s.rs[row])
        pos[q] = a.ops[s.rs[row] + c0 + c];
    }
#pragma unroll
    for (int q = 0; q < kStagePer; ++q) {
      const int at = q0 + q * blockDim.x;  // slot(c, row)
      if (at >= kTokCols * kTokRecords) break;
      u128 v = 0;
      const uint8_t code = pos[q] >= 0 ? stage_op(d, a.n, pos[q], &v) : kSlotNone;
      s.code[at] = code;
      s.val[at] = v;
    }
  }
}

// Lane l's function of staged column c: its records l * kTokRows ..
// (below rows) composed, oldest first.
__device__ inline Fn lane_fn(const ResolveSmem& s, int c, int rows) {
  const int lane = threadIdx.x & 31;
  Fn f = identity();
  for (int q = 0; q < kTokRows; ++q) {
    const int row = lane * kTokRows + q;
    if (row >= rows) break;
    f = compose(element(s.code[slot(c, row)], s.val[slot(c, row)]), f);
  }
  return f;
}

// Tiles of kTokRecords records, a CTA each in ticket order: stage, compose
// and publish the aggregates of the last record's columns; look back for
// each column's carry; resolve and check every token, write its state and
// its offset in its record; each record's OP_END (its length checked), its
// output placed by a CTA scan and a look-back. The tile of the last record
// writes the output size and whether it differs from the declared total.
__global__ void __launch_bounds__(kTokThreads, 3) resolve_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  ResolveSmem& s = *reinterpret_cast<ResolveSmem*>(smem);
  __shared__ long long sh[33];
  __shared__ unsigned long long s_fault, s_clean;
  __shared__ long long s_maxtok;
  const long long t = take_ticket(a.ticket);
  const long long nrec = records_of(a);
  const long long r0 = t * kTokRecords;
  if (r0 >= nrec && !(t == 0 && nrec == 0)) return;
  const int rows = (int)(nrec - r0 < kTokRecords ? nrec - r0 : kTokRecords);
  const int tid = threadIdx.x;
  unsigned long long* st = a.status + t * kStatusWords;
  if (tid == 0) {
    s_fault = (unsigned long long)kNoFault;
    s_clean = 0;
    s_maxtok = 0;
  }
  for (int row = tid; row <= rows; row += blockDim.x) s.rs[row] = a.recstart[r0 + row];
  __syncthreads();
  long long mt = 0;
  for (int row = tid; row < rows; row += blockDim.x) {
    const long long k = (long long)s.rs[row + 1] - 1 - s.rs[row];
    mt = k > mt ? k : mt;
    s.recbytes[row] = 2;
  }
  if (mt) atomicMax((unsigned long long*)&s_maxtok, (unsigned long long)mt);
  __syncthreads();
  const long long maxtok = s_maxtok;
  // the stream bytes of the tile's ops: from its first op to the next
  // tile's (or the end)
  const uint8_t* d = a.data;
  if (rows) {
    const long long lo = a.ops[s.rs[0]];
    const long long hi = s.rs[rows] < a.info[kInfoNodes] ? a.ops[s.rs[rows]] : a.n;
    if (hi - lo + 15 <= kTokStage) d = stage_bytes(a.data, lo, hi, s.bytes);
  }
  const long long last_tokens = rows ? (long long)s.rs[rows] - 1 - s.rs[rows - 1] : 0;
  const long long prev_tokens = r0 > 0 && rows ? tokens_of(a, r0 - 1) : 0;

  // 1. the aggregates of the last record's columns, a warp a column: each
  // lane composes its records, a shuffle tree the lanes (newer after older)
  const int lane = tid & 31, warp = tid >> 5;
  for (long long c0 = 0; c0 < maxtok; c0 += kTokCols) {
    stage_columns(a, s, d, rows, c0);
    __syncthreads();
    for (int c = warp; c < kTokCols && c0 + c < last_tokens; c += kTokThreads / 32) {
      Fn f = lane_fn(s, c, rows);
      // MATCHes and lanes past the records only: no tree (the usual column)
      const unsigned match = __ballot_sync(kFull, f.flags == 0);
      if (__all_sync(kFull, f.flags == 0 || f.flags == kIdent)) {
        if (match) f.flags = 0;
      } else {
        for (int off = 1; off < 32; off <<= 1) {
          const Fn h = shfl_down(f, off);
          if (lane + off < 32) f = compose(h, f);
        }
      }
      if (lane == 0) {
        const long long i = c0 + c;
        put_agg(a.agg + s.rs[rows - 1] + i, f);
        // a column of MATCHes down from an existing predecessor token: the
        // tile passes its carry on unchanged, and a look-back skips it
        if (i < 64 && f.flags == 0 && i < prev_tokens && t > 0) atomicOr(&s_clean, 1ull << i);
      }
    }
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  // tile 0's too: its first record has no predecessor, so its aggregate
  // applied to none is its last record's tokens
  if (tid == 0) {
    st_relaxed(st + kClean, s_clean);
    st_release(st + kFlagB, flag_of(a.epoch, kAggregate));
  }

  // 2. the carries, every token resolved and checked, its state written: a
  // warp a column, each lane's records from the token before them (the
  // carry through an exclusive scan of the lanes' functions)
  for (long long c0 = 0; c0 < maxtok; c0 += kTokCols) {
    if (maxtok > kTokCols) {  // the staged columns are another chunk's
      stage_columns(a, s, d, rows, c0);
      __syncthreads();
    }
    for (int c = warp; c < kTokCols && c0 + c < maxtok; c += kTokThreads / 32) {
      const long long i = c0 + c;
      const Val carry = i < prev_tokens ? column_carry(a, t, i) : mkval(0, 0, kNone);
      const Fn f = lane_fn(s, c, rows);
      Fn before = identity();  // the lanes before this one, newer after older
      const unsigned match = __ballot_sync(kFull, f.flags == 0);
      if (__all_sync(kFull, f.flags == 0 || f.flags == kIdent)) {
        // MATCHes and lanes past the records only: no scan
        if (match & ((1u << lane) - 1)) before.flags = 0;
      } else {
        Fn x = f;
        for (int off = 1; off < 32; off <<= 1) {
          const Fn y = shfl_up(x, off);
          if (lane >= off) x = compose(x, y);
        }
        before = shfl_up(x, 1);
        if (!lane) before = identity();
      }
      Val p = apply(before, carry);
      unsigned long long key = (unsigned long long)kNoFault;
      for (int q = 0; q < kTokRows; ++q) {
        const int row = lane * kTokRows + q;
        if (row >= rows) break;
        const int at = slot(c, row);
        const uint8_t code = s.code[at];
        Val res = mkval(0, 0, kNone);
        if ((code & 7) != kSlotNone) {
          const int fault = check(code, s.val[at], p, &res);
          if (fault != kFaultNone && key == (unsigned long long)kNoFault) {
            const long long pos = a.ops[s.rs[row] + i];
            key = (unsigned long long)(pos * 16 + fault);
          }
        }
        s.code[at] = (uint8_t)res.kind;
        s.val[at] = (res.v & kMask72) | ((u128)(unsigned)res.width << 72);
        p = res;
        if (row == rows - 1 && i < last_tokens) {
          // the last record's token, the tile's inclusive value in this
          // column (its offset follows with the record's states)
          a.fin[s.rs[row] + i] = mkfin(res.v, res.width, res.kind, 0, row);
        }
      }
      // a lane's faults lie in one column, records in order: its first is its least
      if (key != (unsigned long long)kNoFault) atomicMin(&s_fault, key);
    }
    if (c0 + kTokCols >= maxtok) {
      // the last chunk: every column of the last record is out, so later
      // tiles look back no further than this one
      __threadfence();
      __syncthreads();
      if (tid == 0) st_release(st + kFlagB, flag_of(a.epoch, kInclusive));
    }
    __syncthreads();
    // each token's offset in its record (a thread a record), then the states
    // in op order (a thread an op: coalesced stores)
    for (int row = tid; row < rows; row += blockDim.x) {
      const long long ntok = (long long)s.rs[row + 1] - 1 - s.rs[row];
      long long off = s.recbytes[row];
      for (int c = 0; c < kTokCols && c0 + c < ntok; ++c) {
        const int at = slot(c, row);
        const u128 v = s.val[at];
        const long long o = off < (1 << 25) - 1 ? off : (1 << 25) - 1;
        s.val[at] = (v & kMask103) | ((u128)o << 103);
        const uint8_t kind = s.code[at];
        off += (kind == kNum || kind == kLit) ? (long long)((unsigned)(v >> 72) & 0x7fffffff) : 0;
      }
      s.recbytes[row] = off;
    }
    __syncthreads();
    for (long long kb = s.rs[0] + tid; kb < s.rs[rows]; kb += (long long)blockDim.x * kStagePer) {
      int row[kStagePer];  // the searches overlap
#pragma unroll
      for (int q = 0; q < kStagePer; ++q) row[q] = record_of(s.rs, rows, kb + (long long)q * blockDim.x);
#pragma unroll
      for (int q = 0; q < kStagePer; ++q) {
        const long long k = kb + (long long)q * blockDim.x;
        const int lo = row[q];
        const long long c = k - s.rs[lo] - c0;
        if (k >= s.rs[rows] || c < 0 || c >= kTokCols ||
            c0 + c >= (long long)s.rs[lo + 1] - 1 - s.rs[lo])
          continue;
        const int at = slot((int)c, lo);
        const u128 v = s.val[at];
        a.fin[k] = mkfin(v & kMask72, (int)((unsigned)(v >> 72) & 0x7fffffff), s.code[at],
                         (long long)(unsigned)(v >> 103), lo);
      }
    }
    __syncthreads();
  }
  if (maxtok == 0) {  // no column: nothing to wait for
    __syncthreads();
    if (tid == 0) st_release(st + kFlagB, flag_of(a.epoch, kInclusive));
  }

  // 3. each record's OP_END and output bytes, placed
  long long bytes = 0;
  if (tid < rows) {
    const long long r = r0 + tid;
    const bool partial = r == a.info[kInfoEnds];  // < count: the chain ended in it
    if (!partial) {
      const long long kend = s.rs[tid + 1] - 1;
      const long long hl = s.recbytes[tid] - 2;
      if (hl > 0xffff) {
        const unsigned long long key = (unsigned long long)a.ops[kend] * 16 + kFaultLong;
        atomicMin(&s_fault, key);
      }
      a.fin[kend] = mkfin(0, 0, kEnd, s.recbytes[tid], tid);
      bytes = s.recbytes[tid];
    }
  }
  long long total;
  const long long ex = block_excl(bytes, &total, sh);
  const long long pre = tile_prefix(a.status, t, a.epoch, total, kFlagA, kAggA, kInclA);
  if (tid < rows) a.rbase[r0 + tid] = pre + ex;
  if (tid == 0) {
    if (s_fault != (unsigned long long)kNoFault)
      atomicMin((unsigned long long*)&a.info[kInfoFault], s_fault);
    if (r0 + rows == nrec) {
      const long long size = pre + total;
      a.rbase[nrec] = size;
      a.info[kInfoSize] = size;
      const u128 declared = ((u128)(unsigned long long)a.info[kInfoTotalHi] << 64) |
                            (unsigned long long)a.info[kInfoTotalLo];
      a.info[kInfoMismatch] = declared != (u128)size;
    }
  }
}

// The bytes [lo, hi) of a token in the window buf (out[b ..]), the token
// taking [s, s + width): a literal's bytes, or the digits of its value
// zero-padded.
__device__ inline void render(const DecodeArgs& a, const Fin& f, long long s, long long lo,
                              long long hi, uint8_t* buf, long long b) {
  const long long e = s + fin_width(f);
  const long long x = s > lo ? s : lo, y = e < hi ? e : hi;
  if (x >= y) return;
  if (fin_kind(f) == kLit) {
    const uint8_t* src = a.data + (long long)f.lo - s;
    for (long long p = x; p < y; ++p) buf[p - b] = src[p];
    return;
  }
  // the digits right to left (a 64-bit divide once the value fits)
  u128 v = fin_value(f);
  for (long long p = e - 1; p >= x; --p) {
    unsigned d;
    if (v >> 64) {
      d = divmod10(v);
    } else {
      const unsigned long long w = (unsigned long long)v;
      d = (unsigned)(w % 10);
      v = w / 10;
    }
    if (p < y) buf[p - b] = (uint8_t)('0' + d);
  }
}

// A CTA per tile of kTokRecords records: the tile's output (each record's
// u16 length, then its tokens) rendered into windows of kWriteWindow bytes
// of shared memory from the tile's first 16-byte unit, and stored from
// there. The
// records' first output bytes are staged; a thread takes kWritePer tokens a
// round, their states loaded together.
constexpr int kWritePer = 4;

__global__ void __launch_bounds__(kWriteThreads, 6) write_kernel(DecodeArgs a) {
  __shared__ __align__(16) uint8_t buf[kWriteWindow];
  __shared__ long long rb[kTokRecords + 1];
  __shared__ unsigned long long s_next;
  __shared__ long long s_cursor;
  const long long nrec = records_of(a);
  const long long r0 = (long long)blockIdx.x * kTokRecords;
  if (r0 >= nrec) return;
  const int rows = (int)(nrec - r0 < kTokRecords ? nrec - r0 : kTokRecords);
  const int tid = threadIdx.x;
  for (int row = tid; row <= rows; row += blockDim.x) rb[row] = a.rbase[r0 + row];
  if (tid == 0) s_cursor = a.recstart[r0];
  __syncthreads();
  const long long A = rb[0], B = rb[rows];
  const long long kB = a.recstart[r0 + rows];
  // windows from the tile's first 16-byte unit: one window for most tiles
  for (long long w0 = A & ~15LL; w0 < B; w0 += kWriteWindow) {
    const long long lo = A > w0 ? A : w0;
    const long long wend = w0 + kWriteWindow;
    const long long hi = B < wend ? B : wend;
    if (tid == 0) s_next = (unsigned long long)kB;
    if (tid < rows) {  // the record's u16 length
      const long long s = rb[tid], hl = rb[tid + 1] - s - 2;
      if (s >= lo && s < hi) buf[s - w0] = (uint8_t)(hl & 0xff);
      if (s + 1 >= lo && s + 1 < hi) buf[s + 1 - w0] = (uint8_t)(hl >> 8);
    }
    __syncthreads();
    // the tokens from the first that reaches this window, until one reaches
    // the next (those after it lie past this one)
    const long long step = (long long)blockDim.x * kWritePer;
    for (long long k0 = s_cursor;; k0 += step) {
      Fin f[kWritePer];
#pragma unroll
      for (int q = 0; q < kWritePer; ++q) {
        const long long k = k0 + tid + (long long)q * blockDim.x;
        if (k < kB) f[q] = a.fin[k];
      }
      bool next = false;
#pragma unroll
      for (int q = 0; q < kWritePer; ++q) {
        const long long k = k0 + tid + (long long)q * blockDim.x;
        if (k >= kB) break;
        const long long s = rb[f[q].off >> 24] + (f[q].off & 0xffffff);
        const int kind = fin_kind(f[q]);
        const long long e = kind == kNum || kind == kLit ? s + fin_width(f[q]) : s;
        if (e > s) render(a, f[q], s, lo, hi, buf, w0);
        if (e > wend || s >= wend) {
          atomicMin(&s_next, (unsigned long long)k);
          next = true;
        }
      }
      if (__syncthreads_or(next || k0 + step >= kB)) break;
    }
    store_range(a.out, lo, hi, buf, w0);
    if (tid == 0) s_cursor = (long long)s_next;
    __syncthreads();
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 132;
  return sms > 0 ? sms : 132;
}

// Raises the dynamic shared memory caps of the chain and resolve kernels,
// once per device.
cudaError_t ready_kernels() {
  static std::mutex mu;
  static std::set<int> raised;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  if (raised.count(dev)) return cudaSuccess;
  rc = cudaFuncSetAttribute((const void*)chain_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, kChainSmem);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute((const void*)resolve_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(ResolveSmem));
  if (rc == cudaSuccess) raised.insert(dev);
  return rc;
}

inline unsigned tiles_of(long long items, int per) {
  const long long g = (items + per - 1) / per;
  return (unsigned)(g < 1 ? 1 : g);
}

cudaError_t launch_chain(const uint8_t* data, long long n, int ops, long long count, int* list,
                         long long cap, int* recstart, unsigned long long* maps, long long* info,
                         unsigned* ticket, unsigned long long* status, unsigned long long epoch,
                         cudaStream_t s) {
  cudaError_t rc = ready_kernels();
  if (rc != cudaSuccess) return rc;
  ChainArgs a;
  a.data = data;
  a.n = n;
  a.ops = ops;
  a.count = count;
  a.tiles = (int)tiles_of(n, kChainTile);
  a.list = list;
  a.cap = cap;
  a.recstart = recstart;
  a.maps = maps;
  a.info = info;
  a.ticket = ticket;
  a.status = status;
  a.epoch = epoch;
  chain_kernel<<<a.tiles, kChainThreads, kChainSmem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tiles (status words' owners) the launches of one call take at most, for n
// stream bytes and count records: the wrapper sizes the status words.
int fq_tok_tiles(long long n, long long count) {
  const long long a = (n + kChainTile - 1) / kChainTile;
  const long long b = (count + kEncRecords - 1) / kEncRecords;
  const long long c = (count + kTokRecords - 1) / kTokRecords;
  long long m = a > b ? a : b;
  m = m > c ? m : c;
  return (int)(m < 1 ? 1 : m);
}

// Map words (u64) of a chain over n bytes: kWindow a tile.
int fq_tok_map_words(long long n) { return (int)tiles_of(n, kChainTile) * kWindow; }

// data: a u16-length-prefixed header stream of n bytes (any alignment, 1 <=
// n < 2^31 - 1), count >= 1 records, 2 * count <= n. lens: null, or the
// count header lengths (int64, lstride apart: the record scan's column);
// then one launch, else the chain and the encode: starts, count + 1 int32,
// chain_info, 8 int64, maps, fq_tok_map_words(n) u64 (scratch). out: the
// plain version's encode_bound bytes, 16-byte aligned; info: 8 int64
// (kInfoFault: 0, 1 truncated, 2 trailing, 3 lengths not the stream's;
// kInfoSize: the output bytes). ticket, status: the stream's, status words
// for fq_tok_tiles tiles; epoch: two unused epochs from it on.
int fq_tok_encode(const void* data, long long n, long long count, const void* lens,
                  long long lstride, void* starts, void* chain_info, void* maps, void* out,
                  void* info, void* ticket, void* status, long long epoch, void* stream) {
  if (n < 1 || n >= (1LL << 31) - 1 || count < 1 || count > n || epoch < 1 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!lens) {
    cudaError_t rc = launch_chain((const uint8_t*)data, n, 0, count, (int*)starts, count + 1,
                                  nullptr, (unsigned long long*)maps, (long long*)chain_info,
                                  (unsigned*)ticket, (unsigned long long*)status,
                                  (unsigned long long)epoch, s);
    if (rc != cudaSuccess) return (int)rc;
  }
  EncodeArgs a;
  a.data = (const uint8_t*)data;
  a.n = n;
  a.count = count;
  a.lens = (const long long*)lens;
  a.lstride = lstride;
  a.starts = (const int*)starts;
  a.info = (const long long*)chain_info;
  int vlen = 1;
  for (unsigned long long v = (unsigned long long)n; v >= 0x80; v >>= 7) ++vlen;
  a.vlen = vlen;
  a.out = (uint8_t*)out;
  a.out_info = (long long*)info;
  a.ticket = (unsigned*)ticket;
  a.status = (unsigned long long*)status;
  a.epoch = (unsigned long long)epoch + 1;
  encode_kernel<<<tiles_of(count, kEncRecords), kEncRecords, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Bytes of a token's state and of an aggregate, for the wrapper's scratch.
int fq_tok_state_bytes() { return (int)sizeof(Fin); }
int fq_tok_agg_bytes() { return (int)sizeof(Agg); }

// The first call of a decode. data: the tokenized stream (n bytes, any
// alignment, 1 <= n < 2^31 - 1), its varint(total) first; count >= 0, at
// most n. Scratch: ops, n int32; recstart, count + 2 int32; maps,
// fq_tok_map_words(n) u64; fin, n states; agg, n aggregates; rbase, count +
// 1 int64 (the second call reads ops .. rbase again). info: 8 int64
// (kInfoFault: the least position * 16 + code, or 2^63 - 1; kInfoSize: the
// output bytes; kInfoMismatch: 1 when they differ from the declared total).
// ticket, status: the stream's (fq_tok_tiles tiles); epoch: two unused
// epochs from it on. Two launches: the op chain, the resolve.
int fq_tok_decode(const void* data, long long n, long long count, void* ops, void* recstart,
                  void* maps, void* fin, void* agg, void* rbase, void* info, void* ticket,
                  void* status, long long epoch, void* stream) {
  if (n < 1 || n >= (1LL << 31) - 1 || count < 0 || count > n || epoch < 1 ||
      (uintptr_t)fin % 16 || (uintptr_t)agg % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = launch_chain((const uint8_t*)data, n, 1, count, (int*)ops, n, (int*)recstart,
                                (unsigned long long*)maps, (long long*)info, (unsigned*)ticket,
                                (unsigned long long*)status, (unsigned long long)epoch, s);
  if (rc != cudaSuccess) return (int)rc;
  DecodeArgs a;
  a.data = (const uint8_t*)data;
  a.n = n;
  a.count = count;
  a.ops = (const int*)ops;
  a.recstart = (const int*)recstart;
  a.fin = (Fin*)fin;
  a.agg = (Agg*)agg;
  a.rbase = (long long*)rbase;
  a.info = (long long*)info;
  a.out = nullptr;
  a.ticket = (unsigned*)ticket;
  a.status = (unsigned long long*)status;
  a.epoch = (unsigned long long)epoch + 1;
  resolve_kernel<<<tiles_of(count, kTokRecords), kTokThreads, sizeof(ResolveSmem), s>>>(a);
  return (int)cudaGetLastError();
}

// The second call, after a first that found no fault and a size of at
// least one byte: the arguments of the first and out (16-byte aligned,
// info[kInfoSize] bytes). One launch.
int fq_tok_decode_write(const void* data, long long n, long long count, void* ops, void* recstart,
                        void* maps, void* fin, void* agg, void* rbase, void* info, void* out,
                        void* stream) {
  if (n < 1 || count < 1 || (uintptr_t)out % 16) return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.data = (const uint8_t*)data;
  a.n = n;
  a.count = count;
  a.ops = (const int*)ops;
  a.recstart = (const int*)recstart;
  a.fin = (Fin*)fin;
  a.agg = (Agg*)agg;
  a.rbase = (long long*)rbase;
  a.info = (long long*)info;
  a.out = (uint8_t*)out;
  a.ticket = nullptr;
  a.status = nullptr;
  a.epoch = 0;
  (void)maps;
  write_kernel<<<tiles_of(count, kTokRecords), kWriteThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
