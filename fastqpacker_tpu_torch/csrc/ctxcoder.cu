// The v3 context coders (TAG_QCTX qualities, TAG_SCTX bases) on Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// fq_qctx_encode, fq_qctx_decode, fq_sctx_encode and fq_sctx_decode replace
// fastqpacker_tpu/runtime/fqruntime.cpp:1654 fq_qctx_encode, :1855
// fq_qctx_decode, :2116 fq_sctx_encode and :2343 fq_sctx_decode (the JAX
// package's C++ runtime; its numpy/Python references are the walks of
// ops/qualctx.py and ops/seqctx.py). The plain PyTorch versions are
// ops/qualctx.py qctx_encode_plain / qctx_decode_plain and ops/seqctx.py
// sctx_encode_plain / sctx_decode_plain (the port's Python walks).
//
// The wire fixes the parallelism: a stream is 4 record-aligned chunks
// (ops/ctxcoder.py chunk_bounds_arrays, on the host), each coded by 4 interleaved
// 32-bit rANS states (symbol t of a chunk belongs to state t % 4) that share
// one word pointer, 12-bit tables, 16-bit renorm words.
//
// Encode: 16 independent chains, one CTA each (chunk = blockIdx / 4, state =
// blockIdx % 4). A symbol's context and table entry do not depend on the
// state, so thread 0 walks its symbols backward in batches of kBatch, a
// software pipeline: the symbols' loads of batch n + 2 (each symbol and those
// its context reads), then batch n + 1's contexts (in-record positions from
// the record starts it walks back through) and table entries (one u64 each:
// f << 16 | cum and, above, the exact reciprocal of f, made on the host),
// then batch n's state updates, which are ALU only: the renorm compare and
// shift, a 32-bit multiply-high, an add and a shift for floor(x / f)
// (fqruntime.cpp:1659-1672's reciprocal division, exact for x < 2^32,
// f <= 4096), the remainder and the cum. Each
// symbol writes its word (0 where none) and a flag in flat symbol order, so
// fq_rans_compact (csrc/rans_codec.cu) gathers the payload's word runs:
// chunks in order, each chunk's words in the decoder's (forward) order. A
// chain counts its words, or writes -1 as its count where a present symbol
// has f = 0 (every chain writes its count, so nothing is zeroed first).
//
// Decode: one chain a chunk (the 4 states share the word pointer, and a
// context needs the previous symbol of its record), one CTA each: a chain
// warp that reads only registers and shared memory, fed tiles of renorm
// words and record starts by the CTA's other warps (the tiled decodes below).
// sctx: the context rows {c1, c2, c3, c4} (16 bytes, 64 KiB at order 6); a
// base is one 16-byte row load, 3 compares and selects. qctx, where the
// table's present symbols (0 added) and the sentinel fit a warp's 64 columns
// and the rows fit the shared memory (the host's ops/qualctx.py dense_layout
// decides by the table's size alone): rows of the present symbols' cums, a
// row per context, searched by two ballots. Else the L2 route: the slot
// table (contexts x 4096 symbols, 1.5 MiB at model 0, 12 MiB at model 1) built
// on the card by a first launch (a CTA a context) and read, with the f << 16
// | cum rows, through the L1 by one thread a chunk (the kernel asks for no
// shared memory, so the L1 takes the SM's whole 256 KiB), the next symbol's
// slot loaded as soon as this symbol is known and the chunk's next 8 words
// held in registers. The qctx output is the delta stream (the symbol less its
// record predecessor), as the C++ twin writes it; the sctx output the wire's
// packed rows (4 bases a byte, LSB first, a fresh byte at each record, zero
// pad bits).
//
// Faults: a chain stops at its first and writes (code, symbol index) to its
// chunk's two info words (code 0: none; 1: a slot of a symbol with no
// frequency, checked for qctx only with `checks`; 2: a renorm past the
// chunk's words; 3: words left over at the chunk's end, qctx only with
// `checks`). The wrapper raises the lowest chunk's, as the references decode
// chunk 0 to its end before chunk 1.
//
// Bounds: a serial chain per chunk or state, so neither bytes nor operations
// bound these kernels; latency does (ops/qualctx.py's docstring and PERF.md
// give the measured step). Scratch and status are per call (the wrapper's
// tensors), so launches on several CUDA streams never share them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunks = 4;
constexpr int kStates = 4;
constexpr int kChains = kChunks * kStates;
constexpr uint32_t kL = 1u << 16;      // rANS lower bound
constexpr uint32_t kScale = 1u << 12;  // 12-bit probabilities
constexpr int kQBins = 48;             // prev-quality bins, 47 the record-start sentinel
constexpr int kPBuckets = 8;
constexpr int kQ2B = 8;                // model 1: prev2 buckets, 7 the sentinel
constexpr int kMaxF = 4096;
constexpr int kBatch = 8;              // symbols of a chain whose entries load together
constexpr int kTableThreads = 256;     // a CTA a context of the qctx slot table

enum Kind { kQctx0 = 0, kQctx1 = 1, kSctx = 2 };

// Host-side plans, passed by value. Encode: record and symbol bounds of the
// chunks. Decode adds each chunk's first word and word count, the 16 states
// and (sctx) each chunk's first packed byte.
struct EncodePlan {
  long long rb[kChunks + 1];
  long long sb[kChunks + 1];
};

struct DecodePlan {
  long long rb[kChunks + 1];
  long long sb[kChunks + 1];
  long long wstart[kChunks];
  long long wcount[kChunks];
  unsigned states[kChains];
  long long pstart[kChunks + 1];
};

// The layout of the host plan (int64 words) the wrappers pass: ops/ctxcoder.py
// coder_plan, whose PLAN_* are these offsets.
constexpr int kPlanRb = 0, kPlanSb = 5, kPlanWstart = 10, kPlanWcount = 14, kPlanStates = 18,
              kPlanPstart = 34, kPlanWords = 39;

__device__ __forceinline__ int ceil_log2(uint32_t f) { return 32 - __clz(f - 1); }

// floor(x / f) for x < 2^32, 1 <= f <= 4096: m = ceil(2^(32+s) / f) - 2^32
// with s = ceil_log2(f), and (x * (2^32 + m)) >> (32 + s) ==
// (x + umulhi(x, m)) >> s.
__device__ __forceinline__ uint32_t div_f(uint32_t x, uint32_t m, int s) {
  return (uint32_t)(((unsigned long long)x + __umulhi(x, m)) >> s);
}

__device__ __forceinline__ int qctx_context(int model, long long p, int prev, int prev2) {
  const int pb = p >> 4 < kPBuckets - 1 ? (int)(p >> 4) : kPBuckets - 1;
  const int qbin = p == 0 ? kQBins - 1 : (prev < 46 ? prev : 46);
  const int c = pb * kQBins + qbin;
  if (!model) return c;
  const int q2b = p < 2 ? kQ2B - 1 : (prev2 < 46 ? prev2 : 46) >> 3;
  return c * kQ2B + q2b;
}

// Symbols a context reads beside its own: the 6 bases before it (sctx), the
// 2 qualities before it (qctx).
template <int K>
struct Look {
  static constexpr int n = K == kSctx ? 7 : 3;
};

// Stage 1 of a batch (a chain's kBatch symbols from its symbol j backward in
// steps of 4): every symbol load its contexts need, issued together, the
// indices clamped into the stream (a load a context does not read is masked
// in stage 2).
template <int K>
__device__ __forceinline__ void batch_symbols(const uint8_t* __restrict__ sym, long long j,
                                              long long lo, uint32_t (&w)[kBatch][Look<K>::n]) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const long long jb = j - 4 * b < lo ? lo : j - 4 * b;
#pragma unroll
    for (int i = 0; i < Look<K>::n; ++i) w[b][i] = __ldg(sym + (jb - i < 0 ? 0 : jb - i));
  }
}

// Stage 2: each symbol's in-record position (r, rs walk the record starts
// back, the start before rs loaded ahead in rsp), its context from the stage-1
// symbols and its table entry (m << 32 | f << 16 | cum), whose load is issued
// here and used a batch later.
template <int K>
__device__ __forceinline__ void batch_entries(const long long* __restrict__ starts,
                                              const unsigned long long* __restrict__ tab,
                                              int order, long long j, long long lo, long long& r,
                                              long long& rs, long long& rsp,
                                              const uint32_t (&w)[kBatch][Look<K>::n],
                                              unsigned long long (&ent)[kBatch]) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const long long jb = j - 4 * b;
    unsigned long long e = 1ull << 16;  // past the chain's first symbol: f = 1, unused
    if (jb >= lo) {
      while (jb < rs) {
        --r;
        rs = rsp;
        rsp = r > 0 ? __ldg(starts + r - 1) : 0;
      }
      const long long p = jb - rs;
      if (K == kSctx) {
        uint32_t c = 0;
#pragma unroll
        for (int i = 1; i < Look<K>::n; ++i)
          if (i <= order && i <= p) c |= w[b][i] << (2 * (i - 1));
        e = __ldg(tab + c * 4 + w[b][0]);
      } else {
        const int prev = p > 0 ? (int)w[b][1] : 0;
        const int prev2 = p > 1 ? (int)w[b][2] : 0;
        e = __ldg(tab + qctx_context(K, p, prev, prev2) * 256 + w[b][0]);
      }
    }
    ent[b] = e;
  }
}

// One (chunk, state) chain of the backward encode, a software pipeline over
// batches: batch n's state updates run while batch n + 1's table entries and
// batch n + 2's symbols are in flight, so no step waits on a load.
template <int K>
__global__ void __launch_bounds__(32) encode_kernel(
    const uint8_t* __restrict__ sym, const long long* __restrict__ starts, EncodePlan plan,
    const unsigned long long* __restrict__ tab, int order, uint16_t* __restrict__ words,
    uint8_t* __restrict__ flags, uint32_t* __restrict__ states, long long* __restrict__ counts) {
  if (threadIdx.x) return;
  const int k = blockIdx.x / kStates, si = blockIdx.x % kStates;
  const long long lo = plan.sb[k], hi = plan.sb[k + 1];
  uint32_t x = kL;
  long long emitted = 0;
  if (hi - lo > si) {
    long long j = lo + si + (((hi - lo - 1 - si) >> 2) << 2);  // the chain's last symbol
    long long r = plan.rb[k + 1] - 1;
    long long rs = __ldg(starts + r);
    long long rsp = r > 0 ? __ldg(starts + r - 1) : 0;
    uint32_t w[kBatch][Look<K>::n];
    unsigned long long ent[kBatch], next[kBatch];
    batch_symbols<K>(sym, j, lo, w);
    batch_entries<K>(starts, tab, order, j, lo, r, rs, rsp, w, ent);
    constexpr long long kSpan = 4 * kBatch;
    if (j - kSpan >= lo) batch_symbols<K>(sym, j - kSpan, lo, w);
    while (j >= lo) {
      const long long jn = j - kSpan;
      if (jn >= lo) {
        batch_entries<K>(starts, tab, order, jn, lo, r, rs, rsp, w, next);
        if (jn - kSpan >= lo) batch_symbols<K>(sym, jn - kSpan, lo, w);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const long long jb = j - 4 * b;
        if (jb < lo) break;
        const uint32_t fc = (uint32_t)ent[b];
        const uint32_t f = fc >> 16;
        if (f == 0 || f > kMaxF) {  // a present symbol with no frequency
          states[blockIdx.x] = 0;
          counts[blockIdx.x] = -1;
          return;
        }
        const bool emit = (x >> 20) >= f;
        words[jb] = emit ? (uint16_t)(x & 0xFFFF) : (uint16_t)0;
        flags[jb] = emit;
        emitted += emit;
        if (emit) x >>= 16;
        const uint32_t q = div_f(x, (uint32_t)(ent[b] >> 32), ceil_log2(f));
        x = (q << 12) + (x - q * f) + (fc & 0xFFFF);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) ent[b] = next[b];
      j = jn;
    }
  }
  states[blockIdx.x] = x;
  counts[blockIdx.x] = emitted;
}

// The qctx slot table: row c holds symbol s at slots [cum, cum + f), each
// slot's symbol the first whose inclusive cum exceeds it (a binary search of
// the row's 256 sums in shared memory, a thread every 256th slot, so a warp
// stores 32 neighbouring bytes). Rows whose frequencies sum to 0 stay 0 (the
// plain version's rows).
__global__ void __launch_bounds__(kTableThreads) qctx_slots_kernel(
    const uint32_t* __restrict__ fcum, uint8_t* __restrict__ slot) {
  __shared__ uint32_t incl[256];
  const int c = blockIdx.x;
  const uint32_t e = fcum[c * 256 + threadIdx.x];
  incl[threadIdx.x] = (e & 0xFFFF) + (e >> 16);
  __syncthreads();
  uint8_t* row = slot + (size_t)c * kScale;
  for (uint32_t sl = threadIdx.x; sl < kScale; sl += kTableThreads) {
    int lo = 0, hi = 256;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (incl[mid] > sl)
        hi = mid;
      else
        lo = mid + 1;
    }
    row[sl] = lo < 256 ? (uint8_t)lo : 0;
  }
}

// A chunk's next kWordsAhead renorm words, loaded ahead of their use: a
// renorm takes the first and loads the one kWordsAhead on (0 past the run's
// end), so a step never waits on a word's load.
constexpr int kWordsAhead = 8;

struct WordQueue {
  uint32_t q[kWordsAhead];

  __device__ __forceinline__ void fill(const uint16_t* __restrict__ words, long long wi,
                                       long long wend) {
#pragma unroll
    for (int i = 0; i < kWordsAhead; ++i) q[i] = wi + i < wend ? __ldg(words + wi + i) : 0u;
  }

  // the word at wi - 1, after the caller's ++wi
  __device__ __forceinline__ uint32_t take(const uint16_t* __restrict__ words, long long wi,
                                           long long wend) {
    const uint32_t w = q[0];
#pragma unroll
    for (int i = 0; i + 1 < kWordsAhead; ++i) q[i] = q[i + 1];
    const long long at = wi + kWordsAhead - 1;
    q[kWordsAhead - 1] = at < wend ? __ldg(words + at) : 0u;
    return w;
  }
};

__device__ __forceinline__ void put_fault(long long* info, int k, int code, long long j) {
  info[2 * k] = code;
  info[2 * k + 1] = j;
}

// The L2 route (a table of more symbols than the dense rows take): one chunk's
// forward qctx decode, straight to the delta stream. The next symbol's slot is
// loaded as soon as this symbol is known: its context needs
// only this symbol (and the one before), and its state is the next of the 4,
// which this step does not touch. So a step's critical path is one slot load
// and the context's arithmetic; this symbol's f << 16 | cum row entry, the
// state update and the renorm overlap the next slot's load.
__global__ void __launch_bounds__(32) qctx_decode_kernel(
    const uint16_t* __restrict__ words, const long long* __restrict__ starts, DecodePlan plan,
    const uint8_t* __restrict__ slot, const uint32_t* __restrict__ fcum, int model, int checks,
    uint8_t* __restrict__ out, long long* __restrict__ info) {
  if (threadIdx.x) return;
  const int k = blockIdx.x;
  uint32_t x0 = plan.states[4 * k], x1 = plan.states[4 * k + 1], x2 = plan.states[4 * k + 2],
           x3 = plan.states[4 * k + 3];
  long long wi = plan.wstart[k];
  const long long wend = wi + plan.wcount[k];
  WordQueue wq;
  wq.fill(words, wi, wend);
  long long j = plan.sb[k];
  const int c_start = qctx_context(model, 0, 0, 0);  // a record's first symbol
  int c = c_start;
  uint32_t s = __ldg(slot + (size_t)c * kScale + (x0 & (kScale - 1)));
  long long rs = __ldg(starts + plan.rb[k]);
  for (long long r = plan.rb[k]; r < plan.rb[k + 1]; ++r) {
    const long long re = __ldg(starts + r + 1);
    const long long len = re - rs;
    int prev = 0;
    for (long long p = 0; p < len; ++p, ++j) {
      const uint32_t sl = x0 & (kScale - 1);
      const uint32_t e = __ldg(fcum + c * 256 + s);
      // the next symbol: of this record, or the first of the next record
      // (always a valid slot; past the chunk's end it goes unused)
      const int cn = p + 1 < len ? qctx_context(model, p + 1, (int)s, prev) : c_start;
      const uint32_t sn = __ldg(slot + (size_t)cn * kScale + (x1 & (kScale - 1)));
      const uint32_t f = e >> 16;
      if (!f && checks) {
        put_fault(info, k, 1, j);
        return;
      }
      uint32_t x = f * (x0 >> 12) + sl - (e & 0xFFFF);
      if (x < kL) {
        if (wi >= wend) {
          put_fault(info, k, 2, j);
          return;
        }
        x = (x << 16) | wq.take(words, ++wi, wend);
      }
      x0 = x1;
      x1 = x2;
      x2 = x3;
      x3 = x;
      out[j] = (uint8_t)(s - (p ? (uint32_t)prev : 0u));
      prev = (int)s;
      c = cn;
      s = sn;
    }
    rs = re;
  }
  put_fault(info, k, checks && wi != wend ? 3 : 0, j);
}

// ---------------------------------------------------------------------------
// The tiled decodes: fq_sctx_decode and fq_qctx_decode's shared-memory route
// ---------------------------------------------------------------------------
//
// A CTA a chunk, kTileThreads threads. Warp 0 is the chain: it runs the
// chunk's steps tile by tile (kSctxTile symbols, or the qctx layout's tile)
// and reads only registers and shared memory. Warps 1-3 are the helpers:
// while the chain runs tile n they drain tile n - 1's output to global memory
// with 16-byte stores, then stage tile n + 1's per-symbol context inputs
// (each symbol's in-record position, from a search of the record starts)
// and the renorm words the chain can reach next into a ring of 2 x tile u16:
// a step renorms at most once, so tile n reads words [ws(n), ws(n) + tile)
// of the chunk and tile n + 1 starts by ws(n) + tile. The two meet at a CTA
// barrier after each tile. The chain's step has no branch on a loaded value
// and no register rotation: the 4 states stay in 4 registers (the loop is
// unrolled by 4), the renorm is a select, the next context is arithmetic on
// this symbol. A fault is seen at the end of its tile (the least f of the
// tile, or a word pointer past the chunk's words, which the ring pads with
// zeros); the chain then runs the tile again from its saved state, checking
// each step, and stops at the first fault with the (code, symbol index) the
// references give.

constexpr int kTileThreads = 128;  // warp 0 the chain, warps 1-3 the helpers
constexpr int kHelpers = kTileThreads - 32;
constexpr int kGroup = 16;         // symbols a helper stages from one record search
constexpr int kHead = 512;         // shared bytes before the word ring: TileCtl, small tables
constexpr int kSctxTile = 4096;
constexpr int kSctxRows = kHead + 4 * kSctxTile;  // the sctx context rows' shared offset
constexpr int kMetaPad = 16;       // entries past a tile in each per-symbol buffer
constexpr int kMaxDense = 64;      // qctx dense columns: the symbols and the sentinel
constexpr int kQ2Tab = 64, kSymTab = 336, kDenseSym = 416;  // qctx header tables (bytes)
constexpr uint32_t kAbsent = 8192;  // an absent row's columns after its first
constexpr unsigned kFull = 0xFFFFFFFFu;

struct TileCtl {
  uint32_t ws;        // the first word (of the chunk) of the tile the chain runs next
  uint32_t stop;      // the chain met a fault: every warp leaves after the barrier
  uint32_t carry[2];  // by tile parity: qctx a drained tile's last symbol, sctx a byte's bases
  long long b0[2];    // sctx: each staged tile's first byte
  long long blast;    // sctx: the byte of the last staged symbol
  uint32_t open0;     // sctx: the tile being staged starts a byte
};

// The chains' critical loads and address arithmetic, on 32-bit shared
// addresses, so that no add of the shared window's base and no reassociation
// lands between a symbol and the next row's load. (Only the rows and the qctx
// q2 table go through these: they do not change after the prologue.)
__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t row_u32(uint32_t a) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint32_t row_u16(uint32_t a) {
  unsigned short v;
  asm("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint4 row_u128(uint32_t a) {
  uint4 v;
  asm("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "r"(a));
  return v;
}

__device__ __forceinline__ uint32_t mad_u32(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kHelpers) : "memory");
}

// The record of symbol j: the last r of [rlo, rhi) whose start is <= j (a
// zero-length record shares its start with the next one and loses to it).
__device__ __forceinline__ long long find_record(const long long* __restrict__ starts,
                                                 long long rlo, long long rhi, long long j) {
  long long lo = rlo, hi = rhi - 1;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (__ldg(starts + mid) <= j)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Each in-record position of the symbols [j0, j1): fn(i, p, len) for i = j -
// j0, groups of kGroup symbols a helper (h), one record search a group.
template <typename Fn>
__device__ __forceinline__ void for_positions(const long long* __restrict__ starts, long long rlo,
                                              long long rhi, long long j0, long long j1, int h,
                                              Fn&& fn) {
  for (long long jg = j0 + (long long)h * kGroup; jg < j1; jg += (long long)kHelpers * kGroup) {
    long long r = find_record(starts, rlo, rhi, jg);
    long long rs = __ldg(starts + r), rn = __ldg(starts + r + 1);
    const long long je = jg + kGroup < j1 ? jg + kGroup : j1;
    for (long long j = jg; j < je; ++j) {
      while (rn <= j) {
        ++r;
        rs = rn;
        rn = __ldg(starts + r + 1);
      }
      fn((int)(j - j0), j - rs, rn - rs);
    }
  }
}

// ring[w & rmask] = word w of the chunk (0 from wcount on) for w in [a, b),
// by aligned 16-byte loads (words is 16-byte aligned).
__device__ __forceinline__ void stage_words(uint16_t* ring, uint32_t rmask,
                                            const uint16_t* __restrict__ words, long long wstart,
                                            long long wcount, long long a, long long b, int h) {
  const long long lo = wstart + a, hi = wstart + b, end = wstart + wcount;
  for (long long q = (lo >> 3) + h; (q << 3) < hi; q += kHelpers) {
    const long long s0 = q << 3;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (s0 < end) v = __ldg(reinterpret_cast<const uint4*>(words) + q);
    const uint32_t e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long w = s0 + i;
      if (w >= lo && w < hi)
        ring[(uint32_t)(w - wstart) & rmask] =
            w < end ? (uint16_t)(e[i >> 1] >> (16 * (i & 1))) : (uint16_t)0;
    }
  }
}

// Bytes [a, b) of out from val(i) (i = byte - a), aligned 16-byte stores
// where a 16-byte unit lies inside, byte stores at the edges (a helper h).
template <typename Val>
__device__ __forceinline__ void store_bytes(uint8_t* __restrict__ out, long long a, long long b,
                                            int h, Val&& val) {
  for (long long q = (a >> 4) + h; (q << 4) < b; q += kHelpers) {
    const long long s0 = q << 4;
    if (s0 >= a && s0 + 16 <= b) {
      uint32_t wv[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = (int)(s0 - a) + 4 * t;
        wv[t] = val(i) | val(i + 1) << 8 | val(i + 2) << 16 | val(i + 3) << 24;
      }
      *reinterpret_cast<uint4*>(out + s0) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    } else {
      for (long long e = s0 > a ? s0 : a; e < s0 + 16 && e < b; ++e) out[e] = (uint8_t)val((int)(e - a));
    }
  }
}

// The qctx dense route's layout: rows of u16 cums, a row per (pb, qb', q2'),
// pb the in-record position bucket, qb' the previous symbol's dense index (n:
// the record start), q2' the bucket of the one before (model 1; 6: none).
// Its host twin is ops/ctxcoder.py qctx_dense_layout.
struct DenseGeom {
  int w, k, w2, rows, rowsoff, ms, mm, mg, ob, total;
};

__host__ __device__ __forceinline__ DenseGeom dense_geom(int n, int model, int tile) {
  DenseGeom g;
  g.w = (n + 2) & ~1;  // the n symbols and the sentinel column, even
  g.k = model ? 7 : 1;
  g.w2 = 2 * g.w;
  g.rows = kPBuckets * (n + 1) * g.k;
  g.rowsoff = kHead + 4 * tile;
  const int span = tile + kMetaPad;
  g.ms = g.rowsoff + ((g.rows * g.w2 + 128 + 15) & ~15);  // 128: a lane's reach past a row
  g.mm = g.ms + 4 * 2 * span;
  g.mg = g.mm + 4 * 2 * span;
  g.ob = g.mg + 4 * 2 * span;
  g.total = g.ob + 2 * span;
  return g;
}

struct DenseAlphabet {
  uint32_t sym[kMaxDense / 4];  // the present symbols in order, 0 first, 4 a word
  int n;
};

// One chunk's qctx decode on the dense route. A row's column c < n holds the
// cum of symbol sym[c] in the row's context, the columns after 4096; an
// absent context's row is {0, 8192, ...}, which gives symbol 0 with f = cum
// = 0 (the slot table's 0). Lane i of the chain warp loads columns 2i and
// 2i + 1 as one u32; the count of columns <= the slot over both ballots is
// the symbol's dense index + 1 (cnt). A symbol's row offset is S + cnt_prev *
// M + Q, S and M staged a symbol (M = 0 at a record start), Q the bucket of
// the symbol before the previous (q2tab[cnt * G], G staged: 0 where p < 2).
__global__ void __launch_bounds__(kTileThreads, 1) qctx_dense_decode_kernel(
    const uint16_t* __restrict__ words, const long long* __restrict__ starts, DecodePlan plan,
    const uint32_t* __restrict__ fcum, DenseAlphabet al, int model, int tile, int checks,
    uint8_t* __restrict__ out, long long* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char sm[];
  const DenseGeom g = dense_geom(al.n, model, tile);
  TileCtl& ctl = *reinterpret_cast<TileCtl*>(sm);
  uint32_t* q2tab = reinterpret_cast<uint32_t*>(sm + kQ2Tab);
  uint8_t* symtab = sm + kSymTab;
  uint16_t* ring = reinterpret_cast<uint16_t*>(sm + kHead);
  uint16_t* rows = reinterpret_cast<uint16_t*>(sm + g.rowsoff);
  uint32_t* ms = reinterpret_cast<uint32_t*>(sm + g.ms);
  uint32_t* mm = reinterpret_cast<uint32_t*>(sm + g.mm);
  uint32_t* mg = reinterpret_cast<uint32_t*>(sm + g.mg);
  uint8_t* ob = sm + g.ob;
  const int k = blockIdx.x, tid = threadIdx.x, lane = tid & 31, h = tid - 32;
  const int n = al.n, span = tile + kMetaPad;
  const long long lo = plan.sb[k], hi = plan.sb[k + 1], rlo = plan.rb[k], rhi = plan.rb[k + 1];
  const long long wstart = plan.wstart[k], wcount = plan.wcount[k];
  const int ntiles = (int)((hi - lo + tile - 1) / tile);
  const uint32_t rmask = 2 * tile - 1;

  // the alphabet (a word a thread: no dynamic index into the parameter),
  // then the tables: q2tab[cnt] the q2 bucket's row bytes, symtab[cnt] the
  // symbol
  uint8_t* dsym = sm + kDenseSym;
  if (tid < kMaxDense / 4) {
    uint32_t v = 0;
#pragma unroll
    for (int t = 0; t < kMaxDense / 4; ++t) v = tid == t ? al.sym[t] : v;
    reinterpret_cast<uint32_t*>(dsym)[tid] = v;
  }
  if (tid == 0) {
    ctl.ws = 0;
    ctl.stop = 0;
  }
  __syncthreads();
  for (int c = tid; c <= n; c += kTileThreads) {
    const int s = c ? dsym[c - 1] : 0;
    q2tab[c] = c ? (uint32_t)(((s < 46 ? s : 46) >> 3) * g.w2) : 0u;
    symtab[c] = (uint8_t)s;
  }
  for (int i = tid; i < 2 * span; i += kTileThreads) mg[i] = 0;  // the pads: G = 0
  const int cells = g.rows * g.w;
#pragma unroll 4
  for (int e = tid; e < cells; e += kTileThreads) {
    const int row = e / g.w, col = e - row * g.w;
    const int q2 = row % g.k, t = row / g.k, qb = t % (n + 1), pb = t / (n + 1);
    const int prev = qb == n ? kQBins - 1 : (dsym[qb] < 46 ? dsym[qb] : 46);
    const int c = model ? (pb * kQBins + prev) * kQ2B + (q2 == 6 ? kQ2B - 1 : q2)
                        : pb * kQBins + prev;
    const uint32_t last = __ldg(fcum + c * 256 + 255);
    const uint32_t cum = col < n ? __ldg(fcum + c * 256 + dsym[col]) & 0xFFFFu : kScale;
    rows[e] = (uint16_t)((last >> 16) + (last & 0xFFFF) ? cum : (col ? kAbsent : 0u));
  }
  // tile 0's inputs and words [0, tile)
  const int K = g.k, W2 = g.w2;
  const uint32_t rows_at = shared_addr(sm) + g.rowsoff, q2_at = shared_addr(q2tab);
  auto stage = [&](int tn) {
    const long long j0 = lo + (long long)tn * tile;
    const long long j1 = j0 + tile < hi ? j0 + tile : hi;
    const int base = (tn & 1) * span;
    for_positions(starts, rlo, rhi, j0, j1, h, [&](int i, long long p, long long) {
      const int pb = p >> 4 < kPBuckets - 1 ? (int)(p >> 4) : kPBuckets - 1;
      const bool st = p == 0;
      const uint32_t sr =
          (uint32_t)((pb * (n + 1) + (st ? n : 0)) * K + (K == 7 && p < 2 ? 6 : 0)) * W2 +
          rows_at;
      const uint32_t m = st ? 0u : (uint32_t)(K * W2);
      ms[base + i] = sr - m;
      mm[base + i] = m;
      mg[base + i] = K == 7 && p >= 2 ? 4u : 0u;
    });
  };
  if (h >= 0 && ntiles) {
    stage(0);
    stage_words(ring, rmask, words, wstart, wcount, 0, tile, h);
  }
  __syncthreads();

  // the chain's state
  uint32_t x0 = plan.states[4 * k], x1 = plan.states[4 * k + 1], x2 = plan.states[4 * k + 2],
           x3 = plan.states[4 * k + 3];
  uint32_t wb = 0, c1 = 0, c2 = 0;  // words taken; the last two symbols' cnt
  const bool act = lane < g.w / 2;
  for (int tn = 0; tn <= ntiles; ++tn) {
    if (tid < 32) {
      if (tn < ntiles) {
        const int base = (tn & 1) * span;
        const uint4* S4 = reinterpret_cast<const uint4*>(ms + base);
        const uint4* M4 = reinterpret_cast<const uint4*>(mm + base);
        const uint4* G4 = reinterpret_cast<const uint4*>(mg + base);
        uint32_t* O4 = reinterpret_cast<uint32_t*>(ob + base);
        const int cnt_sym = (int)((hi - lo) - (long long)tn * tile < tile
                                      ? (hi - lo) - (long long)tn * tile : tile);
        const uint32_t sx0 = x0, sx1 = x1, sx2 = x2, sx3 = x3, swb = wb, sc1 = c1, sc2 = c2;
        uint32_t fmin = kFull, offl = 0, offu = 0;  // this symbol's row: a lane's word, its start
        struct Meta4 {
          uint4 s, m, g;
        };
        auto meta = [&](int gi) { return Meta4{S4[gi], M4[gi], G4[gi]}; };
        auto first = [&](const Meta4& a) {
          const uint32_t b = a.s.x + row_u32(mad_u32(c2, a.g.x, q2_at));
          offu = mad_u32(c1, a.m.x, b);
          offl = mad_u32(c1, a.m.x, b + 4 * lane);
        };
        // one step of state x -> its count and fault code were it checked; sn1, mn1,
        // gn1 the next symbol's S, M and G
        auto step = [&](uint32_t& x, uint32_t sn1, uint32_t mn, uint32_t gn1,
                        uint32_t& cnt) -> int {
          // the next symbol's row start less its qb' term: S and the q2 bucket of this
          // symbol's predecessor (G = 0 where the next symbol's p < 2)
          const uint32_t bn = sn1 + row_u32(mad_u32(c1, gn1, q2_at));
          const uint32_t bnl = bn + 4 * lane;
          const uint32_t key = ((x & (kScale - 1)) + 1) << 16;
          const uint32_t v = row_u32(offl);
          const uint32_t b0 = __ballot_sync(kFull, act && (v << 16) < key);
          const uint32_t b1 = __ballot_sync(kFull, act && v < key);
          cnt = __popc(b0) + __popc(b1);
          const uint32_t cum = row_u16(offu + 2 * cnt - 2);
          const uint32_t f = (row_u16(offu + 2 * cnt) - cum) & 0x1FFFu;
          fmin = f < fmin ? f : fmin;
          const uint32_t xn = f * (x >> 12) + (x & (kScale - 1)) - cum;
          const uint32_t w = ring[wb & rmask];
          const bool need = xn < kL;
          const int code = checks && !f ? 1 : need && wb >= wcount ? 2 : 0;
          x = need ? (xn << 16) | w : xn;
          wb += need;
          c2 = c1;
          c1 = cnt;
          offu = mad_u32(cnt, mn, bn);
          offl = mad_u32(cnt, mn, bnl);
          return code;
        };
        // the 4 steps of a group whose meta is a, the next group's b
        auto group = [&](const Meta4& a, const Meta4& b, int gi) {
          uint32_t k0, k1, k2, k3;
          step(x0, a.s.y, a.m.y, a.g.y, k0);
          step(x1, a.s.z, a.m.z, a.g.z, k1);
          step(x2, a.s.w, a.m.w, a.g.w, k2);
          step(x3, b.s.x, b.m.x, b.g.x, k3);
          O4[gi] = k0 | k1 << 8 | k2 << 16 | k3 << 24;
        };
        Meta4 ma = meta(0), mb;
        first(ma);
        int i = 0;
#pragma unroll 1
        for (; i + 8 <= cnt_sym; i += 8) {  // two groups, their meta in turns (no copies)
          mb = meta(i / 4 + 1);
          group(ma, mb, i / 4);
          ma = meta(i / 4 + 2);
          group(mb, ma, i / 4 + 1);
        }
        if (i + 4 <= cnt_sym) {
          mb = meta(i / 4 + 1);
          group(ma, mb, i / 4);
          ma = mb;
          i += 4;
        }
        if (i < cnt_sym) {
          uint32_t k0, k1 = 0, k2 = 0;
          step(x0, ma.s.y, ma.m.y, ma.g.y, k0);
          if (i + 1 < cnt_sym) step(x1, ma.s.z, ma.m.z, ma.g.z, k1);
          if (i + 2 < cnt_sym) step(x2, ma.s.w, ma.m.w, ma.g.w, k2);
          O4[i / 4] = k0 | k1 << 8 | k2 << 16;
        }
        if ((checks && fmin == 0) || wb > wcount) {  // a fault in this tile: find the first
          x0 = sx0, x1 = sx1, x2 = sx2, x3 = sx3, wb = swb, c1 = sc1, c2 = sc2;
          first(meta(0));
          int code = 0;
          for (i = 0; i < cnt_sym && !code; ++i) {
            const Meta4 a = meta(i / 4), b = meta(i / 4 + 1);
            uint32_t kx;
            switch (i & 3) {
              case 0: code = step(x0, a.s.y, a.m.y, a.g.y, kx); break;
              case 1: code = step(x1, a.s.z, a.m.z, a.g.z, kx); break;
              case 2: code = step(x2, a.s.w, a.m.w, a.g.w, kx); break;
              default: code = step(x3, b.s.x, b.m.x, b.g.x, kx);
            }
          }
          if (lane == 0) {
            put_fault(info, k, code, lo + (long long)tn * tile + i - 1);
            ctl.stop = 1;
          }
        } else if (lane == 0) {
          ctl.ws = wb;
        }
      }
    } else {
      if (tn >= 1) {  // drain tile tn - 1: the deltas
        const int tm = tn - 1, base = (tm & 1) * span;
        const long long j0 = lo + (long long)tm * tile;
        const long long j1 = j0 + tile < hi ? j0 + tile : hi;
        const uint8_t* O = ob + base;
        const uint32_t* M = mm + base;
        const uint32_t prev0 = tm ? ctl.carry[(tm - 1) & 1] : 0u;
        store_bytes(out, j0, j1, h, [&](int i) -> uint32_t {
          const uint32_t s = symtab[O[i]];
          const uint32_t pv = i ? symtab[O[i - 1]] : prev0;
          return (s - (M[i] ? pv : 0u)) & 0xFFu;
        });
        if (h == 0) ctl.carry[tm & 1] = symtab[O[j1 - j0 - 1]];
      }
      helpers_sync();
      if (tn + 1 < ntiles) {
        stage(tn + 1);
        const long long ws = ctl.ws;
        stage_words(ring, rmask, words, wstart, wcount, ws + tile, ws + 2 * tile, h);
      }
    }
    __syncthreads();
    if (ctl.stop) return;
  }
  if (tid == 0) put_fault(info, k, checks && wb != wcount ? 3 : 0, hi);
}

// One chunk's sctx decode, straight to the packed rows. The context rows are
// {c1, c2, c3, c4} (u32 cums, c4 the row's sum), 16 bytes each at
// kSctxRows: s = (sl >= c1) + (sl >= c2) + (sl >= c3), cum = c_s, f = c_(s+1)
// - c_s, and the next context (x16, its row's offset) from the compares by
// selects and one add. The chain writes each base; the helpers pack 4 bases a
// byte (LSB first, a fresh byte at each record, zero pad bits) in shared
// memory by the staged byte index of each base, the byte a tile shares with
// the next carried over.
__global__ void __launch_bounds__(kTileThreads, 1) sctx_decode_kernel(
    const uint16_t* __restrict__ words, const long long* __restrict__ starts, DecodePlan plan,
    const uint16_t* __restrict__ freq, int order, uint8_t* __restrict__ out,
    long long* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char sm[];
  constexpr int T = kSctxTile, span = T + kMetaPad;
  const int nctx = 1 << (2 * order);
  TileCtl& ctl = *reinterpret_cast<TileCtl*>(sm);
  uint16_t* ring = reinterpret_cast<uint16_t*>(sm + kHead);
  uint4* rows = reinterpret_cast<uint4*>(sm + kSctxRows);
  uint16_t* cm = reinterpret_cast<uint16_t*>(sm + kSctxRows + 16 * nctx);
  uint16_t* dm = cm + 2 * span;
  uint8_t* ob = reinterpret_cast<uint8_t*>(dm + 2 * span);
  uint32_t* sbw = reinterpret_cast<uint32_t*>(ob + 2 * span);
  uint32_t* gcnt = sbw + T / 4 + 4;
  const int k = blockIdx.x, tid = threadIdx.x, h = tid - 32;
  const long long lo = plan.sb[k], hi = plan.sb[k + 1], rlo = plan.rb[k], rhi = plan.rb[k + 1];
  const long long wstart = plan.wstart[k], wcount = plan.wcount[k];
  const int ntiles = (int)((hi - lo + T - 1) / T);
  const uint32_t mask16 = (uint32_t)(nctx - 1) << 4;

  if (tid == 0) {
    ctl.ws = 0;
    ctl.stop = 0;
  }
  for (int c = tid; c < nctx; c += kTileThreads) {
    const uint32_t f0 = freq[4 * c], f1 = freq[4 * c + 1], f2 = freq[4 * c + 2],
                   f3 = freq[4 * c + 3];
    rows[c] = make_uint4(f0, f0 + f1, f0 + f1 + f2, f0 + f1 + f2 + f3);
  }
  for (int i = tid; i < 2 * kMetaPad; i += kTileThreads)  // the pads: no record start
    cm[(i / kMetaPad) * span + T + i % kMetaPad] = (uint16_t)mask16;
  // stage tile tn: each base's context mask (0 at a record start) and its
  // byte (the index from the tile's first byte) and 2-bit slot
  auto stage = [&](int tn) {
    const long long j0 = lo + (long long)tn * T;
    const long long j1 = j0 + T < hi ? j0 + T : hi;
    const int base = (tn & 1) * span, cnt_sym = (int)(j1 - j0);
    const int groups = (cnt_sym + kGroup - 1) / kGroup;
    for_positions(starts, rlo, rhi, j0, j1, h, [&](int i, long long p, long long) {
      cm[base + i] = p ? (uint16_t)mask16 : (uint16_t)0;
      dm[base + i] = (uint16_t)(p & 3);
    });
    helpers_sync();
    // the bytes each group opens, and their prefix over the groups
    for (int gi = h; gi < groups; gi += kHelpers) {
      uint32_t o = 0;
      for (int i = gi * kGroup; i < cnt_sym && i < (gi + 1) * kGroup; ++i) o += !(dm[base + i] & 3);
      gcnt[gi] = o;
    }
    helpers_sync();
    if (h < 32) {  // one warp: the exclusive scan of up to 256 group counts
      uint32_t v[T / kGroup / 32], sum = 0;
#pragma unroll
      for (int t = 0; t < T / kGroup / 32; ++t) {
        const int gi = h * (T / kGroup / 32) + t;
        v[t] = gi < groups ? gcnt[gi] : 0u;
        sum += v[t];
      }
      uint32_t incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, incl, d);
        if (h >= d) incl += y;
      }
      uint32_t run = incl - sum;
#pragma unroll
      for (int t = 0; t < T / kGroup / 32; ++t) {
        const int gi = h * (T / kGroup / 32) + t;
        if (gi < groups) gcnt[gi] = run;
        run += v[t];
      }
      if (h == 0) ctl.open0 = !(dm[base] & 3);
    }
    helpers_sync();
    const uint32_t open0 = ctl.open0;
    for (int gi = h; gi < groups; gi += kHelpers) {
      uint32_t run = gcnt[gi];
      for (int i = gi * kGroup; i < cnt_sym && i < (gi + 1) * kGroup; ++i) {
        const uint32_t slot = dm[base + i] & 3;
        run += !slot;
        dm[base + i] = (uint16_t)((run - open0) << 2 | slot);
      }
    }
    helpers_sync();
    if (h == 0) {
      const long long b0 = tn ? ctl.blast + open0 : plan.pstart[k];
      ctl.b0[tn & 1] = b0;
      ctl.blast = b0 + (dm[base + cnt_sym - 1] >> 2);
    }
  };
  if (h >= 0 && ntiles) {
    stage(0);
    stage_words(ring, 2 * T - 1, words, wstart, wcount, 0, T, h);
  }
  __syncthreads();

  uint32_t x0 = plan.states[4 * k], x1 = plan.states[4 * k + 1], x2 = plan.states[4 * k + 2],
           x3 = plan.states[4 * k + 3];
  const uint32_t rows_at = shared_addr(sm) + kSctxRows;
  uint32_t wb = 0, at = rows_at;  // words taken; this base's row (its shared address)
  for (int tn = 0; tn <= ntiles; ++tn) {
    if (tid < 32) {
      if (tn < ntiles) {
        const int base = (tn & 1) * span;
        const uint2* C4 = reinterpret_cast<const uint2*>(cm + base);
        uint32_t* O4 = reinterpret_cast<uint32_t*>(ob + base);
        const int cnt_sym = (int)((hi - lo) - (long long)tn * T < T ? (hi - lo) - (long long)tn * T
                                                                     : T);
        if (!cm[base]) at = rows_at;  // the tile starts a record (the tile before took none)
        const uint32_t sx0 = x0, sx1 = x1, sx2 = x2, sx3 = x3, swb = wb, sat = at;
        uint32_t fmin = kFull;
        // one step of state x -> its base and fault code were it checked; m the next
        // base's context mask (0 at a record start)
        auto step = [&](uint32_t& x, uint32_t m, uint32_t& s) -> int {
          // the next base's row less its base's term, while this row loads
          const uint32_t kk = m & 16u;
          const uint32_t pre = (((at - rows_at) << 2) & m) + rows_at, prek = pre + kk;
          const uint32_t sl = x & (kScale - 1);
          const uint4 row = row_u128(at);
          uint32_t cum, cn;
          asm("{\n\t.reg .pred p1, p2, p3;\n\t.reg .b32 r1, r2, r3;\n\t"
              "setp.le.u32 p1, %4, %8;\n\tsetp.le.u32 p2, %5, %8;\n\tsetp.le.u32 p3, %6, %8;\n\t"
              "selp.b32 r1, %9, %10, p1;\n\tselp.b32 r2, %11, 0, p2;\n\t"
              "selp.b32 r3, %11, 0, p3;\n\tadd.u32 r1, r1, r2;\n\tadd.u32 %0, r1, r3;\n\t"
              "selp.b32 %1, 1, 0, p1;\n\tselp.b32 %1, 2, %1, p2;\n\tselp.b32 %1, 3, %1, p3;\n\t"
              "selp.b32 %2, %4, 0, p1;\n\tselp.b32 %2, %5, %2, p2;\n\tselp.b32 %2, %6, %2, p3;\n\t"
              "selp.b32 %3, %5, %4, p1;\n\tselp.b32 %3, %6, %3, p2;\n\tselp.b32 %3, %7, %3, p3;\n\t}"
              : "=&r"(at), "=&r"(s), "=&r"(cum), "=&r"(cn)
              : "r"(row.x), "r"(row.y), "r"(row.z), "r"(row.w), "r"(sl), "r"(prek), "r"(pre),
                "r"(kk));
          const uint32_t f = cn - cum;
          fmin = f < fmin ? f : fmin;
          const uint32_t xn = f * (x >> 12) + sl - cum;
          const uint32_t w = ring[wb & (2 * T - 1)];
          const bool need = xn < kL;
          const int code = !f ? 1 : need && wb >= wcount ? 2 : 0;
          x = need ? (xn << 16) | w : xn;
          wb += need;
          return code;
        };
        // the 4 steps of a group whose masks are a, the next group's b
        auto group = [&](uint2 a, uint2 b, int gi) {
          uint32_t s0, s1, s2, s3;
          step(x0, a.x >> 16, s0);
          step(x1, a.y & 0xFFFF, s1);
          step(x2, a.y >> 16, s2);
          step(x3, b.x & 0xFFFF, s3);
          O4[gi] = s0 | s1 << 8 | s2 << 16 | s3 << 24;
        };
        int i = 0;
        uint2 ca = C4[0], cb;
#pragma unroll 1
        for (; i + 8 <= cnt_sym; i += 8) {  // two groups, their masks in turns
          cb = C4[i / 4 + 1];
          group(ca, cb, i / 4);
          ca = C4[i / 4 + 2];
          group(cb, ca, i / 4 + 1);
        }
        if (i + 4 <= cnt_sym) {
          cb = C4[i / 4 + 1];
          group(ca, cb, i / 4);
          ca = cb;
          i += 4;
        }
        if (i < cnt_sym) {
          uint32_t s0, s1 = 0, s2 = 0;
          step(x0, ca.x >> 16, s0);
          if (i + 1 < cnt_sym) step(x1, ca.y & 0xFFFF, s1);
          if (i + 2 < cnt_sym) step(x2, ca.y >> 16, s2);
          O4[i / 4] = s0 | s1 << 8 | s2 << 16;
        }
        if (fmin == 0 || wb > wcount) {  // a fault in this tile: find the first
          x0 = sx0, x1 = sx1, x2 = sx2, x3 = sx3, wb = swb, at = sat;
          int code = 0;
          for (i = 0; i < cnt_sym && !code; ++i) {
            const uint2 a = C4[i / 4], b = C4[i / 4 + 1];
            uint32_t sx;
            switch (i & 3) {
              case 0: code = step(x0, a.x >> 16, sx); break;
              case 1: code = step(x1, a.y & 0xFFFF, sx); break;
              case 2: code = step(x2, a.y >> 16, sx); break;
              default: code = step(x3, b.x & 0xFFFF, sx);
            }
          }
          if ((tid & 31) == 0) {
            put_fault(info, k, code, lo + (long long)tn * T + i - 1);
            ctl.stop = 1;
          }
        } else if ((tid & 31) == 0) {
          ctl.ws = wb;
        }
      }
    } else {
      if (tn >= 1) {  // drain tile tn - 1: pack its bases
        const int tm = tn - 1, base = (tm & 1) * span;
        const long long j0 = lo + (long long)tm * T;
        const int cnt_sym = (int)((j0 + T < hi ? j0 + T : hi) - j0);
        const uint8_t* O = ob + base;
        const uint16_t* D = dm + base;
        const int rel_last = D[cnt_sym - 1] >> 2;
        for (int i = h; i <= rel_last / 4; i += kHelpers) sbw[i] = 0;
        helpers_sync();
        for (int i = h; i < cnt_sym; i += kHelpers) {
          const uint32_t d = D[i];
          atomicOr(sbw + (d >> 4), (uint32_t)O[i] << (8 * ((d >> 2) & 3) + 2 * (d & 3)));
        }
        helpers_sync();
        const uint8_t* sb = reinterpret_cast<const uint8_t*>(sbw);
        // the tile's first byte may hold bases of the tile before; its last
        // byte may go on into the next tile, which writes it
        const uint32_t first = (D[0] & 3) ? ctl.carry[(tm - 1) & 1] : 0u;
        const bool open_end = tm + 1 < ntiles && (dm[((tm + 1) & 1) * span] & 3);
        const long long b0 = ctl.b0[tm & 1];
        store_bytes(out, b0, b0 + rel_last + 1 - open_end, h,
                    [&](int e) -> uint32_t { return sb[e] | (e ? 0u : first); });
        if (open_end && h == 0) ctl.carry[tm & 1] = sb[rel_last] | (rel_last ? 0u : first);
      }
      helpers_sync();
      if (tn + 1 < ntiles) {
        stage(tn + 1);
        const long long ws = ctl.ws;
        stage_words(ring, 2 * T - 1, words, wstart, wcount, ws + T, ws + 2 * T, h);
      }
    }
    __syncthreads();
    if (ctl.stop) return;
  }
  if (tid == 0) put_fault(info, k, wb != wcount ? 3 : 0, hi);
}

// The sctx decode's shared bytes: the header, the ring, the rows, cm and dm
// (u16) and the bases (u8) of two tiles, the packed bytes and the group counts.
int sctx_shared_bytes(int order) {
  const int span = kSctxTile + kMetaPad;
  return kSctxRows + 16 * (1 << (2 * order)) + 10 * span + 4 * (kSctxTile / 4 + 4) +
         4 * (kSctxTile / kGroup);
}

EncodePlan encode_plan(const long long* h) {
  EncodePlan p;
  for (int i = 0; i <= kChunks; ++i) {
    p.rb[i] = h[kPlanRb + i];
    p.sb[i] = h[kPlanSb + i];
  }
  return p;
}

DecodePlan decode_plan(const long long* h) {
  DecodePlan p;
  for (int i = 0; i <= kChunks; ++i) {
    p.rb[i] = h[kPlanRb + i];
    p.sb[i] = h[kPlanSb + i];
    p.pstart[i] = h[kPlanPstart + i];
  }
  for (int i = 0; i < kChunks; ++i) {
    p.wstart[i] = h[kPlanWstart + i];
    p.wcount[i] = h[kPlanWcount + i];
  }
  for (int i = 0; i < kChains; ++i) p.states[i] = (unsigned)h[kPlanStates + i];
  return p;
}

}  // namespace

extern "C" {

// sym: n symbols (raw qualities, or bases 0-3); starts: nrec + 1 int64
// record starts on the card; plan: host int64 (rb[5], sb[5] first); tab:
// (contexts, 256 or 4) u64 m << 32 | f << 16 | cum (m: the reciprocal of f,
// ops/ctxcoder.py encode_table); words (u16), flags (u8): n each;
// states (u32) and counts (int64, -1 at a fault): 16 each. One launch.
int fq_qctx_encode(const void* sym, const void* starts, const void* plan, const void* tab,
                   int model, void* words, void* flags, void* states, void* counts,
                   void* stream) {
  const EncodePlan p = encode_plan(static_cast<const long long*>(plan));
  auto* fn = model ? encode_kernel<kQctx1> : encode_kernel<kQctx0>;
  fn<<<kChains, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sym, (const long long*)starts, p, (const unsigned long long*)tab, 0,
      (uint16_t*)words, (uint8_t*)flags, (uint32_t*)states, (long long*)counts);
  return (int)cudaGetLastError();
}

int fq_sctx_encode(const void* sym, const void* starts, const void* plan, const void* tab,
                   int order, void* words, void* flags, void* states, void* counts,
                   void* stream) {
  const EncodePlan p = encode_plan(static_cast<const long long*>(plan));
  encode_kernel<kSctx><<<kChains, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)sym, (const long long*)starts, p, (const unsigned long long*)tab, order,
      (uint16_t*)words, (uint8_t*)flags, (uint32_t*)states, (long long*)counts);
  return (int)cudaGetLastError();
}

// words: the payload's u16 words (all chunks, 16-byte aligned); starts: nrec
// + 1 int64 on the card; plan: host int64 (DecodePlan); fcum: (contexts, 256)
// u32 f << 16 | cum; alphabet: host u8, nsyms symbols (0 first) with every
// symbol that has a frequency, or nsyms 0 for the L2 route; tile: the dense
// route's tile (ops/ctxcoder.py qctx_dense_layout); slot: contexts x 4096
// bytes of scratch (the L2 route's); out: n delta bytes; info: 4 x 2 int64
// (fault code, symbol index). The dense route is one launch, the L2 route two
// (the slot table, the walk).
int fq_qctx_decode(const void* words, const void* starts, const void* plan, const void* fcum,
                   int contexts, int model, int checks, const void* alphabet, int nsyms,
                   int tile, void* slot, void* out, void* info, void* stream) {
  const DecodePlan p = decode_plan(static_cast<const long long*>(plan));
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc;
  if (nsyms > 0) {
    if (nsyms > kMaxDense - 1 || tile < 4 || (tile & (tile - 1))) return (int)cudaErrorInvalidValue;
    DenseAlphabet al = {};
    al.n = nsyms;
    for (int i = 0; i < nsyms; ++i)
      al.sym[i / 4] |= (uint32_t)static_cast<const uint8_t*>(alphabet)[i] << (8 * (i % 4));
    const int shared = dense_geom(nsyms, model, tile).total;
    rc = cudaFuncSetAttribute(qctx_dense_decode_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (rc != cudaSuccess) return (int)rc;
    qctx_dense_decode_kernel<<<kChunks, kTileThreads, shared, s>>>(
        (const uint16_t*)words, (const long long*)starts, p, (const uint32_t*)fcum, al, model,
        tile, checks, (uint8_t*)out, (long long*)info);
    return (int)cudaGetLastError();
  }
  // no shared memory: the L1 takes the SM's whole 256 KiB (a hint, per device)
  rc = cudaFuncSetAttribute(qctx_decode_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (rc != cudaSuccess) return (int)rc;
  qctx_slots_kernel<<<contexts, kTableThreads, 0, s>>>((const uint32_t*)fcum, (uint8_t*)slot);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  qctx_decode_kernel<<<kChunks, 32, 0, s>>>((const uint16_t*)words, (const long long*)starts, p,
                                            (const uint8_t*)slot, (const uint32_t*)fcum, model,
                                            checks, (uint8_t*)out, (long long*)info);
  return (int)cudaGetLastError();
}

// The dense route's shared bytes at (nsyms, model, tile): the layout the
// host's ops/ctxcoder.py qctx_dense_layout computes.
int fq_qctx_dense_bytes(int nsyms, int model, int tile) {
  return dense_geom(nsyms, model, tile).total;
}

// freq: (4^order, 4) u16 on the card; out: the packed rows; the rest as
// fq_qctx_decode. One launch.
int fq_sctx_decode(const void* words, const void* starts, const void* plan, const void* freq,
                   int order, void* out, void* info, void* stream) {
  const DecodePlan p = decode_plan(static_cast<const long long*>(plan));
  const int shared = sctx_shared_bytes(order);
  cudaError_t rc = cudaFuncSetAttribute(sctx_decode_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (rc != cudaSuccess) return (int)rc;
  sctx_decode_kernel<<<kChunks, kTileThreads, shared, (cudaStream_t)stream>>>(
      (const uint16_t*)words, (const long long*)starts, p, (const uint16_t*)freq, order,
      (uint8_t*)out, (long long*)info);
  return (int)cudaGetLastError();
}

}  // extern "C"
