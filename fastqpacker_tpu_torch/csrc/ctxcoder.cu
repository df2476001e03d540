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
// context needs the previous symbol of its record), one CTA each, thread 0
// walking forward. sctx: the chunk's CTA first writes the context rows of
// fqruntime.cpp:2359-2371 ({0, c1, c2, c3, f0..f3}, 16 bytes, 64 KiB at
// order 6) into shared memory; a symbol is one 16-byte shared load, 3
// compares and the state update, and the output is the wire's packed rows (4
// bases a byte, LSB first, a fresh byte at each record, zero pad bits)
// written directly. qctx: the slot table (contexts x 4096 symbols, 1.5 MiB
// at model 0, 12 MiB at model 1) is built on the card by a first launch (a
// CTA a context) and read, with the f << 16 | cum rows, through the L1 (the
// kernel asks for no shared memory, so the L1 takes the SM's whole 256 KiB);
// a step's critical path is one slot load: the next symbol's slot is loaded
// as soon as this symbol is known (its context needs only this symbol, its
// state is the next of the 4). The output is the delta stream (the symbol less its record
// predecessor), as the C++ twin writes it. Both decodes hold the chunk's next
// 8 words in registers, each loaded 8 renorms ahead of its use and never past
// the chunk's words (the bound holds on binned qualities, which emit far
// fewer words than symbols).
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
constexpr int kSctxThreads = 256;      // fill the context rows; thread 0 walks
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

// One chunk's forward qctx decode, straight to the delta stream. The next
// symbol's slot is loaded as soon as this symbol is known: its context needs
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

// One chunk's forward sctx decode, straight to the packed rows.
__global__ void __launch_bounds__(kSctxThreads) sctx_decode_kernel(
    const uint16_t* __restrict__ words, const long long* __restrict__ starts, DecodePlan plan,
    const uint16_t* __restrict__ freq, int order, uint8_t* __restrict__ out,
    long long* __restrict__ info) {
  extern __shared__ uint4 rows[];  // {0 | c1 << 16, c2 | c3 << 16, f0 | f1 << 16, f2 | f3 << 16}
  const int nctx = 1 << (2 * order);
  for (int c = threadIdx.x; c < nctx; c += blockDim.x) {
    const uint32_t f0 = freq[4 * c], f1 = freq[4 * c + 1], f2 = freq[4 * c + 2],
                   f3 = freq[4 * c + 3];
    const uint32_t c1 = f0, c2 = (f0 + f1) & 0xFFFF, c3 = (f0 + f1 + f2) & 0xFFFF;
    rows[c] = make_uint4(c1 << 16, c2 | (c3 << 16), f0 | (f1 << 16), f2 | (f3 << 16));
  }
  __syncthreads();
  if (threadIdx.x) return;
  const int k = blockIdx.x;
  const uint32_t mask = (uint32_t)nctx - 1;
  uint32_t x0 = plan.states[4 * k], x1 = plan.states[4 * k + 1], x2 = plan.states[4 * k + 2],
           x3 = plan.states[4 * k + 3];
  long long wi = plan.wstart[k];
  const long long wend = wi + plan.wcount[k];
  WordQueue wq;
  wq.fill(words, wi, wend);
  long long j = plan.sb[k];
  long long po = plan.pstart[k];
  long long rs = __ldg(starts + plan.rb[k]);
  for (long long r = plan.rb[k]; r < plan.rb[k + 1]; ++r) {
    const long long re = __ldg(starts + r + 1);
    const long long len = re - rs;
    uint32_t ctx = 0, acc = 0;
    for (long long p = 0; p < len; ++p, ++j) {
      const uint32_t sl = x0 & (kScale - 1);
      const uint4 row = rows[ctx];
      const uint32_t s = (sl >= (row.x >> 16)) + (sl >= (row.y & 0xFFFF)) + (sl >= (row.y >> 16));
      const uint32_t half = (s & 1) * 16;
      const uint32_t f = ((s < 2 ? row.z : row.w) >> half) & 0xFFFF;
      const uint32_t cum = ((s < 2 ? row.x : row.y) >> half) & 0xFFFF;
      if (!f) {
        put_fault(info, k, 1, j);
        return;
      }
      uint32_t x = f * (x0 >> 12) + sl - cum;
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
      ctx = ((ctx << 2) | s) & mask;
      acc |= s << (2 * (p & 3));
      if ((p & 3) == 3) {
        out[po + (p >> 2)] = (uint8_t)acc;
        acc = 0;
      }
    }
    if (len & 3) out[po + (len >> 2)] = (uint8_t)acc;
    po += (len + 3) >> 2;
    rs = re;
  }
  put_fault(info, k, wi != wend ? 3 : 0, j);
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

// words: the payload's u16 words (all chunks); starts: nrec + 1 int64 on the
// card; plan: host int64 (DecodePlan); fcum: (contexts, 256) u32 f << 16 |
// cum; slot: contexts x 4096 bytes of scratch; out: n delta bytes; info: 4 x
// 2 int64 (fault code, symbol index). Two launches: the slot table, the walk.
int fq_qctx_decode(const void* words, const void* starts, const void* plan, const void* fcum,
                   int contexts, int model, int checks, void* slot, void* out, void* info,
                   void* stream) {
  const DecodePlan p = decode_plan(static_cast<const long long*>(plan));
  cudaStream_t s = (cudaStream_t)stream;
  // no shared memory: the L1 takes the SM's whole 256 KiB (a hint, per device)
  cudaError_t rc =
      cudaFuncSetAttribute(qctx_decode_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (rc != cudaSuccess) return (int)rc;
  qctx_slots_kernel<<<contexts, kTableThreads, 0, s>>>((const uint32_t*)fcum, (uint8_t*)slot);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  qctx_decode_kernel<<<kChunks, 32, 0, s>>>((const uint16_t*)words, (const long long*)starts, p,
                                            (const uint8_t*)slot, (const uint32_t*)fcum, model,
                                            checks, (uint8_t*)out, (long long*)info);
  return (int)cudaGetLastError();
}

// freq: (4^order, 4) u16 on the card; out: the packed rows; the rest as
// fq_qctx_decode. One launch (order 6: 64 KiB of dynamic shared memory).
int fq_sctx_decode(const void* words, const void* starts, const void* plan, const void* freq,
                   int order, void* out, void* info, void* stream) {
  const DecodePlan p = decode_plan(static_cast<const long long*>(plan));
  const int shared = (1 << (2 * order)) * 16;
  cudaError_t rc = cudaFuncSetAttribute(sctx_decode_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (rc != cudaSuccess) return (int)rc;
  sctx_decode_kernel<<<kChunks, kSctxThreads, shared, (cudaStream_t)stream>>>(
      (const uint16_t*)words, (const long long*)starts, p, (const uint16_t*)freq, order,
      (uint8_t*)out, (long long*)info);
  return (int)cudaGetLastError();
}

}  // extern "C"
