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
// Both walk a chain whose next node follows from the node's own bytes: the
// record starts of a u16-length-prefixed header stream (s + 2 + len(s)), and
// the op starts of a tokenized stream (an op byte, then a varint, then a
// literal's bytes). chain_kernel resolves such a chain in tiles of the
// stream, a CTA each, in ticket order: each node's last node inside the
// tile and the steps to it by pointer jumping in shared memory; the tiles
// hand each other the chain's entry node and its index in order (an
// epoch-tagged status word, which the reader clears: records.cu's chains
// find it at 0); each tile marks the nodes its entry reaches by
// synchronous doubling and writes them, ranked by a CTA scan, into a list.
// A step that leaves the stream (a truncated record, varint or literal, an
// unknown op) lands on the absorbing node n + 1; the end of the stream is
// node n.
//
// fq_tok_encode: the record starts, then a thread per record (CTAs of 256
// records in ticket order) splits its header and its predecessor's into
// digit and non-digit runs in step and picks MATCH / DELTA / DELTA_PAD /
// LIT for each token exactly as the plain version does; the record's op
// bytes are sized, placed by a CTA scan and a decoupled look-back over the
// tiles before it, and written after varint(len(stream)). Two launches.
//
// fq_tok_decode, in two calls with the sizes read back between them:
// 1. the op starts (chain_kernel); the ops ranked and their records counted
//    by the OP_END bytes before them (a CTA scan and a look-back); token
//    (r, i) of record r has token (r - 1, i) as its predecessor, an O(1)
//    index once the record starts are known. Each token's value is resolved
//    back to its literal by pointer jumping over those predecessors, a
//    launch a round (ceil(log2(count)) + 1 rounds), each step composing the
//    transforms of the ops on the way: a sum of deltas in 128-bit integers
//    (a 10-byte varint carries up to 2^70) and the width rule (DELTA: the
//    width of the value's digits; DELTA_PAD: the predecessor's width; MATCH:
//    the predecessor). Then each op checks what the plain decoder checks,
//    against its predecessor's resolved token, and the first fault in stream
//    order wins (a minimum of op position * 16 + code; "header exceeds 65535
//    bytes" at the record's OP_END, the size mismatch last). Tokens past a
//    fault may resolve to anything: every token before the first fault has
//    its true value, since its chain runs through earlier tokens only. The
//    output bytes of every op are placed by a scan; ops of records past
//    `count` are never looked at.
// 2. with no fault and the output sized from the decoded lengths (never from
//    the declared total), a thread per op writes its token (a literal's
//    bytes or the value's digits, zero-padded) and each record's first op
//    its u16 length.
// Ticket words and status words persist per CUDA stream (the wrapper's):
// every launch leaves the ticket at 0 and takes an epoch of its own, so the
// status words are never cleared (but the chain's hand-off word, by its
// reader).

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
  kFaultMismatch = 9,    // tokenized header size mismatch (set by the wrapper)
  kFaultInternal = 15,   // a token left unresolved (never on a sound launch)
};
constexpr long long kNoFault = 0x7fffffffffffffffLL;

// info slots (ops/tokenize.py TOK_INFO_*)
enum {
  kInfoNodes = 0,   // chain nodes below n
  kInfoExit = 1,    // the node after the chain's last (n or n + 1)
  kInfoEnds = 2,    // decode: OP_END ops on the chain
  kInfoFault = 3,   // encode: fault code; decode: min(position * 16 + code)
  kInfoSize = 4,    // output bytes
  kInfoSlots = 8
};
// encode faults
enum { kEncTruncated = 1, kEncTrailing = 2 };

constexpr int kStatusWords = 16;  // per tile (ops/records.py STATUS_WORDS)
constexpr int kSums = 5;
constexpr unsigned long long kAggregate = 1, kInclusive = 2;
constexpr int kHandFlag = kStatusWords - 1;  // the chain's hand-off: epoch
constexpr int kHandNode = kStatusWords - 2;  //   the entry node
constexpr int kHandIndex = kStatusWords - 3; //   its index in the list

constexpr int kChainThreads = 1024;
constexpr int kChainTile = 16384;  // nodes per tile of the chain kernel
constexpr int kChainPer = kChainTile / kChainThreads;
constexpr int kEncRecords = 256;   // records per CTA of the encode
constexpr int kOpsTile = 1024;     // ops per CTA of the op and size passes
constexpr int kResolveThreads = 256;

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

__device__ inline void publish(unsigned long long* status, long long tile,
                               unsigned long long epoch, unsigned long long state, long long v) {
  unsigned long long* st = status + tile * kStatusWords;
  st_relaxed(st + (state == kInclusive ? 1 + kSums : 1), (unsigned long long)v);
  st_release(st, (epoch << 2) | state);
}

// The sum of the tiles before `tile` (> 0), by one whole warp: windows of
// the 32 nearest tiles, combined down to the nearest inclusive one.
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
    const unsigned long long* sums =
        status + (mine ? j : 0) * kStatusWords + (state == kInclusive ? 1 + kSums : 1);
    pre += warp_sum(mine ? (long long)ld_relaxed(sums) : 0);
    if (incl & need) break;
  }
  return pre;
}

// The exclusive prefix over the tiles of a launch of the tile's sum v (the
// same in every thread). Every thread must call it; warp 0 looks back.
__device__ long long tile_prefix(unsigned long long* status, long long tile,
                                 unsigned long long epoch, long long v) {
  __shared__ long long s_pre;
  if (threadIdx.x < 32) {
    long long p = 0;
    if (tile > 0) {
      if (threadIdx.x == 0) publish(status, tile, epoch, kAggregate, v);
      __syncwarp();
      p = look_back(status, tile, epoch);
    }
    if (threadIdx.x == 0) {
      s_pre = p;
      publish(status, tile, epoch, kInclusive, p + v);
    }
  }
  __syncthreads();
  const long long pre = s_pre;
  __syncthreads();
  return pre;
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
  long long start;  // the chain's first node (< n)
  int ops;          // 0: u16-prefixed records, 1: tokenized ops
  int tiles;
  int* list;        // the chain's nodes below n, in order
  long long cap;    // entries of list (nodes past it are not written)
  long long* info;  // kInfoNodes, kInfoExit (by the last tile)
  unsigned* ticket;
  unsigned long long* status;
  unsigned long long epoch;
};

// The node after p (< n): n + 1 when its record, varint or literal leaves
// the stream, or its op is unknown.
__device__ inline long long chain_next(const ChainArgs& a, long long p) {
  const long long n = a.n;
  if (!a.ops) {
    if (p + 2 > n) return n + 1;
    const long long q = p + 2 + ((long long)a.data[p] | ((long long)a.data[p + 1] << 8));
    return q <= n ? q : n + 1;
  }
  const uint8_t op = a.data[p];
  if (op == kOpEnd || op == kOpMatch) return p + 1;
  if (op != kOpDelta && op != kOpPad && op != kOpLit) return n + 1;
  long long q;
  u128 v;
  if (!read_varint(a.data, n, p + 1, &q, &v)) return n + 1;
  if (op != kOpLit) return q;
  return v > (u128)(n - q) ? n + 1 : q + (long long)v;
}

// Shared-memory words of a tile: node k's jump (kJump bits), whether that is
// its last node inside the tile (kLast), and while the exits are resolved
// the steps to it (upper 16 bits).
constexpr uint32_t kJump = 0x7fff, kLast = 0x8000;
static_assert(kChainTile <= 32768, "a node of the tile fits kJump");

__device__ inline uint32_t first_step(const ChainArgs& a, long long base, int k) {
  const long long node = base + k;
  if (node >= a.n) return (uint32_t)k | kLast;
  const long long q = chain_next(a, node);
  if (q < a.n && q < base + kChainTile) return (uint32_t)(q - base);
  return (uint32_t)k | kLast;
}

// One tile of the chain, a CTA each, tiles in ticket order.
// 1. each node's last node inside the tile and the steps to it (pointer
//    jumping in place: any mix of old and new words is a valid pair);
// 2. the tile's entry (the first chain node at or past its start) and its
//    index, handed over by the tile before (tile 0: the start, index 0); the
//    exit (the successor of the entry's last node) and its index go to the
//    next tile at once; the last tile writes them to info;
// 3. the nodes the entry reaches, marked by synchronous doubling (after
//    round j the marks hold the entry's first 2^(j+1) nodes), ranked by a
//    CTA scan into the list.
__global__ void __launch_bounds__(kChainThreads) chain_kernel(ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long sh[33];
  __shared__ long long s_entry, s_index;
  __shared__ int s_emit;
  const long long t = take_ticket(a.ticket);
  const long long base = t * kChainTile;
  const int tid = threadIdx.x;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint8_t* mark = smem + 4 * kChainTile;

  // 1. exits
  for (int k = tid; k < kChainTile; k += kChainThreads) {
    const uint32_t s = first_step(a, base, k);
    tab[k] = s | ((s & kLast) ? 0u : 1u << 16);
  }
  __syncthreads();
  for (;;) {
    int changed = 0;
    for (int k = tid; k < kChainTile; k += kChainThreads) {
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
    long long e = a.start, i = 0;
    unsigned long long* st = a.status + t * kStatusWords;
    if (t > 0) {
      while (ld_acquire(st + kHandFlag) != a.epoch) {
      }
      e = (long long)ld_relaxed(st + kHandNode);
      i = (long long)ld_relaxed(st + kHandIndex);
      st_relaxed(st + kHandFlag, 0);  // the hand-off word is 0 between launches
    }
    long long x = e, nx = i;
    int emit = 0;
    if (e < a.n && e >= base && e < base + kChainTile) {  // a node of this tile
      const uint32_t v = tab[e - base];
      x = chain_next(a, base + (v & kJump));
      nx = i + (long long)(v >> 16) + 1;
      emit = 1;
    }
    if (t + 1 < a.tiles) {
      unsigned long long* nxt = a.status + (t + 1) * kStatusWords;
      st_relaxed(nxt + kHandNode, (unsigned long long)x);
      st_relaxed(nxt + kHandIndex, (unsigned long long)nx);
      st_release(nxt + kHandFlag, a.epoch);
    } else {
      a.info[kInfoNodes] = nx;
      a.info[kInfoExit] = x;
    }
    s_entry = e;
    s_index = i;
    s_emit = emit;
  }
  __syncthreads();
  if (!s_emit) return;

  // 3. the entry's nodes, marked and ranked
  uint16_t* ja = reinterpret_cast<uint16_t*>(smem);
  uint16_t* jb = ja + kChainTile;
  const int ke = (int)(s_entry - base);
  __syncthreads();  // tab is read no more
  for (int k = tid; k < kChainTile; k += kChainThreads) {
    ja[k] = (uint16_t)first_step(a, base, k);
    mark[k] = k == ke;
  }
  __syncthreads();
  for (int round = 0;; ++round) {
    const uint16_t* src = (round & 1) ? jb : ja;
    uint16_t* dst = (round & 1) ? ja : jb;
    int done = 0;
    for (int k = tid; k < kChainTile; k += kChainThreads) {
      const uint16_t v = src[k];
      if (k == ke) done = v & kLast;
      if (mark[k]) mark[v & kJump] = 1;
      dst[k] = (v & kLast) ? v : src[v & kJump];
    }
    if (__syncthreads_or(done)) break;
  }
  int count = 0;
  for (int q = 0; q < kChainPer; ++q) count += mark[tid * kChainPer + q];
  long long total;
  long long at = s_index + block_excl(count, &total, sh);
  for (int q = 0; q < kChainPer; ++q) {
    if (mark[tid * kChainPer + q]) {
      if (at < a.cap) a.list[at] = (int)(base + tid * kChainPer + q);
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
  const int* starts;  // the chain's record starts (count of them when sound)
  const long long* info;  // the chain's
  int vlen;               // bytes of varint(n)
  uint8_t* out;
  long long* out_info;    // kInfoFault, kInfoSize
  unsigned* ticket;
  unsigned long long* status;
  unsigned long long epoch;
};

// A thread per record, CTAs of kEncRecords records in ticket order: the
// record's ops sized, placed by a CTA scan and a look-back, then written.
// A stream whose chain is not `count` records that end at n writes nothing
// but its fault.
__global__ void __launch_bounds__(kEncRecords) encode_kernel(EncodeArgs a) {
  __shared__ long long sh[33];
  const long long t = take_ticket(a.ticket);
  const long long nodes = a.info[kInfoNodes], end_node = a.info[kInfoExit];
  if (nodes != a.count || end_node != a.n) {  // uniform over the launch
    if (t == 0 && threadIdx.x == 0) {
      a.out_info[kInfoFault] = nodes > a.count ? kEncTrailing : kEncTruncated;
      a.out_info[kInfoSize] = 0;
    }
    return;
  }
  const long long r = t * kEncRecords + threadIdx.x;
  const uint8_t* h = nullptr;
  const uint8_t* g = nullptr;
  long long hl = 0, gl = -1, size = 0;
  if (r < a.count) {
    const long long s = a.starts[r];
    hl = (long long)a.data[s] | ((long long)a.data[s + 1] << 8);
    h = a.data + s + 2;
    if (r > 0) {
      const long long ps = a.starts[r - 1];
      gl = (long long)a.data[ps] | ((long long)a.data[ps + 1] << 8);
      g = a.data + ps + 2;
    }
    size = encode_record(h, hl, g, gl, nullptr, 0);
  }
  long long total;
  const long long ex = block_excl(size, &total, sh);
  const long long pre = tile_prefix(a.status, t, a.epoch, total);
  if (r < a.count) encode_record(h, hl, g, gl, a.out, a.vlen + pre + ex);
  if (t == 0 && threadIdx.x == 0) {
    put_varint(a.out, 0, (unsigned long long)a.n);
    a.out_info[kInfoFault] = 0;
  }
  if (t == gridDim.x - 1 && threadIdx.x == 0) a.out_info[kInfoSize] = a.vlen + pre + total;
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

// A token's state while its chain is resolved. Done: its token (a literal
// op's bytes, or the digits of val zero-padded to width). Not done: the
// transform that turns the state of token ptr into its own: add d; the
// width of the value's digits after adding dr (render) or the width of
// token ptr (keep); the identity when no delta is on the way.
struct Tok {
  int ptr;
  unsigned flags;
  int width;     // done
  int src;       // done, a literal: its op
  unsigned long long a_lo, a_hi;  // done: val; else d
  unsigned long long b_lo, b_hi;  // not done, render: dr
};
constexpr unsigned kDone = 1, kHasOp = 2, kRender = 4, kRendered = 8, kNumeric = 16;

__device__ inline u128 mk(unsigned long long lo, unsigned long long hi) {
  return ((u128)hi << 64) | lo;
}
__device__ inline void split(u128 v, unsigned long long& lo, unsigned long long& hi) {
  lo = (unsigned long long)v;
  hi = (unsigned long long)(v >> 64);
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
    unsigned long long x = (unsigned long long)v;
    int k = 1;
    while (x >= 10) {
      x /= 10;
      ++k;
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

// What an op is: its byte, and for a DELTA / DELTA_PAD its signed delta
// (unzigzag), for a LIT its bytes' first position and length. ok is false
// when its varint or literal leaves the stream.
struct Op {
  uint8_t code;
  bool ok;
  i128 dz;
  long long lit, len;
};

__device__ inline Op parse_op(const uint8_t* data, long long n, long long p) {
  Op o;
  o.code = data[p];
  o.ok = true;
  o.dz = 0;
  o.lit = 0;
  o.len = 0;
  if (o.code == kOpDelta || o.code == kOpPad || o.code == kOpLit) {
    long long q;
    u128 v;
    if (!read_varint(data, n, p + 1, &q, &v)) {
      o.ok = false;
      return o;
    }
    if (o.code == kOpLit) {
      o.lit = q;
      if (v > (u128)(n - q)) {
        o.ok = false;
        o.len = -1;  // the literal leaves the stream (the varint was whole)
      } else {
        o.len = (long long)v;
      }
    } else {
      // (v >> 1) ^ -(v & 1)
      const i128 half = (i128)(v >> 1);
      o.dz = (v & 1) ? -half - 1 : half;
    }
  }
  return o;
}

struct DecodeArgs {
  const uint8_t* data;
  long long n;
  long long count;
  const int* ops;      // op positions (the chain's list)
  long long opcap;     // its entries (the grids cover them)
  int* rec;            // each op's record: OP_END ops before it
  int* recstart;       // count + 2: each record's first op
  Tok* tok[2];         // token states, double-buffered
  long long* place;    // each op's output position (its exclusive scan)
  long long* info;
  uint8_t* out;
  unsigned* ticket;
  unsigned long long* status;
  unsigned long long epoch;
};

// Ops ranked by the OP_END bytes before them: each op's record, each
// record's first op. Tile 0 also clears the fault slot.
__global__ void __launch_bounds__(kOpsTile) ops_kernel(DecodeArgs a) {
  __shared__ long long sh[33];
  const long long t = take_ticket(a.ticket);
  const long long k = t * kOpsTile + threadIdx.x;
  const long long nodes = a.info[kInfoNodes];
  const bool live = k < nodes;
  const long long is_end = live && a.data[a.ops[k]] == kOpEnd;
  long long total;
  const long long ex = block_excl(is_end, &total, sh);
  const long long pre = tile_prefix(a.status, t, a.epoch, total);
  const long long r = pre + ex;
  if (live) {
    a.rec[k] = (int)(r < a.count ? r : a.count);
    if (is_end && r + 1 <= a.count) a.recstart[r + 1] = (int)(k + 1);
  }
  if (t == 0 && threadIdx.x == 0) {
    a.recstart[0] = 0;
    a.info[kInfoFault] = kNoFault;
  }
  if (t == gridDim.x - 1 && threadIdx.x == 0) a.info[kInfoEnds] = pre + total;
}

// Record r's tokens: ops recstart[r] .. recstart[r + 1] - 2 (its OP_END
// last); a record the chain does not end has no successor start.
__device__ inline long long tokens_of(const DecodeArgs& a, long long r) {
  return (long long)a.recstart[r + 1] - 1 - a.recstart[r];
}

// The initial state of op k's token (ops of records past count, and
// OP_END ops, are left as they are).
__global__ void __launch_bounds__(kResolveThreads) init_kernel(DecodeArgs a) {
  const long long nodes = a.info[kInfoNodes];
  const long long ends = a.info[kInfoEnds];
  for (long long k = blockIdx.x * (long long)kResolveThreads + threadIdx.x; k < nodes;
       k += (long long)gridDim.x * kResolveThreads) {
    const long long r = a.rec[k];
    if (r >= a.count) continue;
    const long long p = a.ops[k];
    const Op o = parse_op(a.data, a.n, p);
    if (o.code == kOpEnd) continue;
    const long long i = k - a.recstart[r];
    long long pred = -1;
    if (r > 0 && r - 1 < ends && i < tokens_of(a, r - 1)) pred = a.recstart[r - 1] + i;
    Tok s;
    s.ptr = -1;
    s.flags = kDone | kRendered;  // a token with a fault: anything
    s.width = 1;
    s.src = -1;
    s.a_lo = s.a_hi = s.b_lo = s.b_hi = 0;
    if (o.code == kOpLit && o.ok) {
      s.flags = kDone;
      s.width = (int)(o.len < 0x7fffffff ? o.len : 0x7fffffff);
      s.src = (int)k;
      bool num = o.len > 0 && o.len <= kMaxDigits;
      for (long long q = 0; num && q < o.len; ++q) num = is_digit(a.data[o.lit + q]);
      if (num) {
        s.flags |= kNumeric;
        s.a_lo = parse_digits(a.data + o.lit, o.len);
      }
    } else if (pred >= 0 && o.ok && (o.code == kOpMatch || o.code == kOpDelta ||
                                     o.code == kOpPad)) {
      s.ptr = (int)pred;
      s.flags = 0;
      if (o.code != kOpMatch) {
        s.flags = kHasOp | (o.code == kOpDelta ? kRender : 0);
        split((u128)o.dz, s.a_lo, s.a_hi);
        s.b_lo = s.a_lo;
        s.b_hi = s.a_hi;
      }
    }
    a.tok[0][k] = s;
  }
}

// The state of a done token q after the transform of s.
__device__ inline Tok apply(const Tok& s, const Tok& q) {
  if (!(s.flags & kHasOp)) return q;
  Tok o;
  o.ptr = -1;
  o.src = -1;
  o.b_lo = o.b_hi = 0;
  const u128 qv = mk(q.a_lo, q.a_hi);
  split(qv + mk(s.a_lo, s.a_hi), o.a_lo, o.a_hi);
  int w = q.width;
  if (s.flags & kRender) {
    const u128 v = qv + mk(s.b_lo, s.b_hi);
    w = (i128)v < 0 ? 1 : ndigits(v);
  }
  o.width = w;
  o.flags = kDone | kRendered | (w <= kMaxDigits ? kNumeric : 0);
  return o;
}

// The transform of q (toward q.ptr) followed by that of s.
__device__ inline Tok compose(const Tok& s, const Tok& q) {
  Tok o = s;
  o.ptr = q.ptr;
  if (!(s.flags & kHasOp)) {
    o.flags = q.flags;
    o.a_lo = q.a_lo;
    o.a_hi = q.a_hi;
    o.b_lo = q.b_lo;
    o.b_hi = q.b_hi;
    return o;
  }
  if (!(q.flags & kHasOp)) return o;
  split(mk(q.a_lo, q.a_hi) + mk(s.a_lo, s.a_hi), o.a_lo, o.a_hi);
  if (s.flags & kRender) {
    split(mk(q.a_lo, q.a_hi) + mk(s.b_lo, s.b_hi), o.b_lo, o.b_hi);
    o.flags = kHasOp | kRender;
  } else {
    o.b_lo = q.b_lo;
    o.b_hi = q.b_hi;
    o.flags = kHasOp | (q.flags & kRender);
  }
  return o;
}

// One round of pointer jumping: tok[src] -> tok[1 - src].
__global__ void __launch_bounds__(kResolveThreads) resolve_kernel(DecodeArgs a, int src) {
  const long long nodes = a.info[kInfoNodes];
  const Tok* in = a.tok[src];
  Tok* outp = a.tok[1 - src];
  for (long long k = blockIdx.x * (long long)kResolveThreads + threadIdx.x; k < nodes;
       k += (long long)gridDim.x * kResolveThreads) {
    if (a.rec[k] >= a.count || a.data[a.ops[k]] == kOpEnd) continue;
    const Tok s = in[k];
    if (s.flags & kDone) {
      outp[k] = s;
      continue;
    }
    const Tok q = in[s.ptr];
    outp[k] = (q.flags & kDone) ? apply(s, q) : compose(s, q);
  }
}

// Op k's token bytes (its resolved state s).
__device__ inline long long token_len(const Tok& s) { return s.width; }

// The fault of op k (of a record below count) against its predecessor's
// resolved token, as the plain decoder checks it: kFaultNone or a code.
__device__ inline int op_fault(const DecodeArgs& a, const Tok* fin, long long k, long long r,
                               const Op& o, long long ends) {
  if (o.code == kOpEnd) return kFaultNone;
  if (o.code != kOpMatch && o.code != kOpDelta && o.code != kOpPad && o.code != kOpLit)
    return kFaultUnknown;
  if (o.code == kOpLit) return o.ok ? kFaultNone : (o.len < 0 ? kFaultTrunc : kFaultVarint);
  const long long i = k - a.recstart[r];
  const bool has = r > 0 && r - 1 < ends && i < tokens_of(a, r - 1);
  if (o.code == kOpMatch) return has ? kFaultNone : kFaultMatch;
  if (!has) return kFaultDeltaPred;
  const Tok& p = fin[a.recstart[r - 1] + i];
  if (!(p.flags & kNumeric)) return kFaultDeltaPred;
  if (!o.ok) return kFaultVarint;
  const i128 v = (i128)mk(p.a_lo, p.a_hi) + o.dz;
  if (v < 0) return kFaultNegative;
  if (o.code == kOpPad && ndigits((u128)v) > p.width) return kFaultWider;
  return kFaultNone;
}

// Each op's output bytes (its token; 2 more for a record's first op, the
// u16 length before its tokens), checked: the first fault's position and
// code go to info by a minimum; "header exceeds 65535 bytes" at the
// record's OP_END, "truncated tokenized header data" at n when the chain
// has fewer than count records. The bytes placed by a CTA scan and a
// look-back; the last tile writes the output size.
__global__ void __launch_bounds__(kOpsTile) size_kernel(DecodeArgs a, int fin_buf) {
  __shared__ long long sh[33];
  const Tok* fin = a.tok[fin_buf];
  const long long t = take_ticket(a.ticket);
  const long long k = t * kOpsTile + threadIdx.x;
  const long long nodes = a.info[kInfoNodes], ends = a.info[kInfoEnds];
  long long bytes = 0;
  long long key = kNoFault;
  if (k < nodes && a.rec[k] < a.count) {
    const long long r = a.rec[k];
    const long long p = a.ops[k];
    const Op o = parse_op(a.data, a.n, p);
    if (k == a.recstart[r]) bytes = 2;
    int code = op_fault(a, fin, k, r, o, ends);
    if (o.code == kOpEnd) {
      long long hl = 0;
      for (long long j = a.recstart[r]; j < k && hl <= 0xffff; ++j) hl += token_len(fin[j]);
      if (hl > 0xffff) code = kFaultLong;
    } else {
      if (!(fin[k].flags & kDone)) code = kFaultInternal;
      bytes += token_len(fin[k]);
    }
    if (code != kFaultNone) key = p * 16 + code;
  }
  if (key != kNoFault) atomicMin((unsigned long long*)&a.info[kInfoFault],
                                 (unsigned long long)key);
  long long total;
  const long long ex = block_excl(bytes, &total, sh);
  const long long pre = tile_prefix(a.status, t, a.epoch, total);
  if (k < a.opcap) a.place[k] = pre + ex;
  if (t == gridDim.x - 1 && threadIdx.x == 0) {
    a.info[kInfoSize] = pre + total;
    if (ends < a.count)
      atomicMin((unsigned long long*)&a.info[kInfoFault],
                (unsigned long long)(a.n * 16 + kFaultTrunc));
  }
}

// A thread per op of the first count records: its token's bytes at its
// place (after the u16 length for a record's first op), which that op
// writes (the record's token bytes: its OP_END's place less its own).
__global__ void __launch_bounds__(kResolveThreads) write_kernel(DecodeArgs a, int fin_buf) {
  const Tok* fin = a.tok[fin_buf];
  const long long nodes = a.info[kInfoNodes];
  for (long long k = blockIdx.x * (long long)kResolveThreads + threadIdx.x; k < nodes;
       k += (long long)gridDim.x * kResolveThreads) {
    const long long r = a.rec[k];
    if (r >= a.count) continue;
    long long o = a.place[k];
    if (k == a.recstart[r]) {
      const long long end = a.recstart[r + 1] - 1;
      const long long hl = end == k ? 0 : a.place[end] - o - 2;
      a.out[o] = (uint8_t)(hl & 0xff);
      a.out[o + 1] = (uint8_t)(hl >> 8);
      o += 2;
    }
    if (a.data[a.ops[k]] == kOpEnd) continue;
    const Tok& s = fin[k];
    if (!(s.flags & kRendered)) {
      const Op lit = parse_op(a.data, a.n, a.ops[s.src]);
      for (long long q = 0; q < lit.len; ++q) a.out[o + q] = a.data[lit.lit + q];
      continue;
    }
    u128 v = mk(s.a_lo, s.a_hi);
    for (long long q = s.width - 1; q >= 0; --q) a.out[o + q] = (uint8_t)('0' + divmod10(v));
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 132;
  return sms > 0 ? sms : 132;
}

// Raises the chain kernel's dynamic shared memory cap, once per device.
cudaError_t ready_chain() {
  static std::mutex mu;
  static std::set<int> raised;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  if (raised.count(dev)) return cudaSuccess;
  rc = cudaFuncSetAttribute((const void*)chain_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, 5 * kChainTile);
  if (rc == cudaSuccess) raised.insert(dev);
  return rc;
}

inline unsigned tiles_of(long long items, int per) {
  const long long g = (items + per - 1) / per;
  return (unsigned)(g < 1 ? 1 : g);
}

cudaError_t launch_chain(const uint8_t* data, long long n, long long start, int ops, int* list,
                         long long cap, long long* info, unsigned* ticket,
                         unsigned long long* status, unsigned long long epoch, cudaStream_t s) {
  cudaError_t rc = ready_chain();
  if (rc != cudaSuccess) return rc;
  ChainArgs a;
  a.data = data;
  a.n = n;
  a.start = start;
  a.ops = ops;
  a.tiles = (int)tiles_of(n, kChainTile);
  a.list = list;
  a.cap = cap;
  a.info = info;
  a.ticket = ticket;
  a.status = status;
  a.epoch = epoch;
  chain_kernel<<<a.tiles, kChainThreads, 5 * kChainTile, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tiles (status words' owners) the launches of one call take at most, for n
// stream bytes and count records: the wrapper sizes the status words.
int fq_tok_tiles(long long n, long long count) {
  const long long a = (n + kChainTile - 1) / kChainTile;
  const long long b = (count + kEncRecords - 1) / kEncRecords;
  const long long c = (n + kOpsTile - 1) / kOpsTile;
  long long m = a > b ? a : b;
  m = m > c ? m : c;
  return (int)(m < 1 ? 1 : m);
}

// data: a u16-length-prefixed header stream of n bytes (any alignment, 1 <=
// n < 2^31 - 1), count >= 1 records; starts: count + 1 int32 (scratch); out:
// the plain version's encode_bound bytes; info: 8 int64 (kInfoFault: 0, or
// 1 truncated, 2 trailing; kInfoSize: the output bytes); chain_info: 8
// int64 (scratch). ticket, status: the stream's, status words for
// fq_tok_tiles tiles; epoch: two unused epochs from it on. Two launches.
int fq_tok_encode(const void* data, long long n, long long count, void* starts, void* chain_info,
                  void* out, void* info, void* ticket, void* status, long long epoch,
                  void* stream) {
  if (n < 1 || n >= (1LL << 31) - 1 || count < 1 || count > n || epoch < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = launch_chain((const uint8_t*)data, n, 0, 0, (int*)starts, count + 1,
                                (long long*)chain_info, (unsigned*)ticket,
                                (unsigned long long*)status, (unsigned long long)epoch, s);
  if (rc != cudaSuccess) return (int)rc;
  EncodeArgs a;
  a.data = (const uint8_t*)data;
  a.n = n;
  a.count = count;
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

// Rounds of pointer jumping that resolve every token of count records.
int fq_tok_rounds(long long count) {
  int r = 1;
  while ((1LL << (r - 1)) < count) ++r;
  return r;
}

// The first call of a decode. data: the tokenized stream (n bytes, 16-byte
// aligned, n < 2^31 - 1); start: the byte after varint(total) (< n); count
// >= 1. Scratch: ops and rec: n - start int32 each; recstart: count + 2
// int32; tok0, tok1: n - start Tok (48 bytes) each; place: n - start int64.
// info: 8 int64 (kInfoNodes, kInfoExit, kInfoEnds; kInfoFault: the least
// position * 16 + code, or 2^63 - 1; kInfoSize: the output bytes). ticket,
// status: the stream's (fq_tok_tiles tiles); epoch: three unused epochs
// from it on. Launches the chain, the op ranks, the token states, the
// rounds and the sizes.
int fq_tok_decode(const void* data, long long n, long long start, long long count, void* ops,
                  void* rec, void* recstart, void* tok0, void* tok1, void* place, void* info,
                  void* ticket, void* status, long long epoch, void* stream) {
  if (n < 1 || n >= (1LL << 31) - 1 || start < 0 || start >= n || count < 1 || epoch < 1 ||
      (uintptr_t)tok0 % 16 || (uintptr_t)tok1 % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long cap = n - start;
  cudaError_t rc = launch_chain((const uint8_t*)data, n, start, 1, (int*)ops, cap,
                                (long long*)info, (unsigned*)ticket,
                                (unsigned long long*)status, (unsigned long long)epoch, s);
  if (rc != cudaSuccess) return (int)rc;
  DecodeArgs a;
  a.data = (const uint8_t*)data;
  a.n = n;
  a.count = count;
  a.ops = (const int*)ops;
  a.opcap = cap;
  a.rec = (int*)rec;
  a.recstart = (int*)recstart;
  a.tok[0] = (Tok*)tok0;
  a.tok[1] = (Tok*)tok1;
  a.place = nullptr;
  a.info = (long long*)info;
  a.out = nullptr;
  a.ticket = (unsigned*)ticket;
  a.status = (unsigned long long*)status;
  a.epoch = (unsigned long long)epoch + 1;
  const unsigned tiles = tiles_of(cap, kOpsTile);
  ops_kernel<<<tiles, kOpsTile, 0, s>>>(a);
  const unsigned most = (unsigned)(8 * sm_count());
  const unsigned grid = tiles_of(cap, kResolveThreads) < most ? tiles_of(cap, kResolveThreads)
                                                              : most;
  init_kernel<<<grid, kResolveThreads, 0, s>>>(a);
  const int rounds = fq_tok_rounds(count);
  for (int j = 0; j < rounds; ++j) resolve_kernel<<<grid, kResolveThreads, 0, s>>>(a, j & 1);
  a.place = (long long*)place;
  a.epoch = (unsigned long long)epoch + 2;
  size_kernel<<<tiles, kOpsTile, 0, s>>>(a, rounds & 1);
  return (int)cudaGetLastError();
}

// The second call, after a first that found no fault: the arguments of the
// first and out, info[kInfoSize] bytes. One launch.
int fq_tok_decode_write(const void* data, long long n, long long start, long long count,
                        void* ops, void* rec, void* recstart, void* tok0, void* tok1, void* place,
                        void* info, void* out, void* stream) {
  if (n < 1 || start < 0 || start >= n || count < 1) return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.data = (const uint8_t*)data;
  a.n = n;
  a.count = count;
  a.ops = (const int*)ops;
  a.opcap = n - start;
  a.rec = (int*)rec;
  a.recstart = (int*)recstart;
  a.tok[0] = (Tok*)tok0;
  a.tok[1] = (Tok*)tok1;
  a.place = (long long*)place;
  a.info = (long long*)info;
  a.out = (uint8_t*)out;
  a.ticket = nullptr;
  a.status = nullptr;
  a.epoch = 0;
  const unsigned most = (unsigned)(8 * sm_count());
  const unsigned g = tiles_of(n - start, kResolveThreads);
  write_kernel<<<g < most ? g : most, kResolveThreads, 0, (cudaStream_t)stream>>>(
      a, fq_tok_rounds(count) & 1);
  return (int)cudaGetLastError();
}

// sizeof(Tok), for the wrapper's scratch.
int fq_tok_state_bytes() { return (int)sizeof(Tok); }

}  // extern "C"
