"""Order-1 context-modeled quality coder (FQZ v3 ``TAG_QCTX``).

The reference entropy-codes delta-transformed qualities with zstd
(quality.go:81-118 + compress.go:523-528) — an order-0 treatment. Real
quality strings have strong order-1 structure (the next value clusters
around the previous one, and error rates drift along the read), which a
static per-block context model captures while staying block-parallel:
this is the ROADMAP path toward FQSqueezer-class ratios.

Model (two-pass, static tables — no adaptive state, so blocks remain
independently decodable and the coder parallelizes):

- Symbols are the *integrated* quality values (the v3 qual stream is
  per-record delta-coded; the codec integrates on the fly).
- Context of symbol at in-record position ``p``:
  ``ctx = min(p >> 4, 7) * 48 + qbin`` where ``qbin = min(prev, 46)``
  for ``p > 0`` and the record-start sentinel ``47`` otherwise —
  384 contexts.
- Per-context histograms are normalized to 12-bit rANS tables with the
  same largest-remainder algorithm as the order-0 coder
  (:func:`..ops.rans.normalize_freqs`), serialized sparsely (symbol, freq
  pairs) and zstd-compressed.
- The symbol walk is split into :data:`NUM_CHUNKS` record-aligned,
  size-balanced chunks, each coded by an independent 32-bit rANS state
  (16-bit renorm words, backward encode / forward decode) — the
  intra-block parallelism knob for both host threads and ILP.

The port's copy of ``fastqpacker_tpu/ops/qualctx.py``. Its passes run on a
device, the CUDA card unless the caller names the CPU: the prepare pass
(integration and the max-model histogram, ``fq_qctx_prepare``,
:mod:`.ctxprep`), the encode (``fq_qctx_encode``: the 16 (chunk, state)
chains walked backward, a word and a flag per symbol, then
``fq_rans_compact``) and the decode (``fq_qctx_decode``: a chain a chunk,
straight to the delta stream: rows of the table's present symbols in shared
memory, searched by a warp's ballots, where they fit (:func:`dense_layout`),
else the slot table through the L2), all in ``csrc/ctxcoder.cu``; tables, payload
and faults stay host code. The plan and the host steps around a launch,
which both coders share, are :mod:`.ctxcoder`. On the CPU the walks below
are the plain versions (per-symbol Python loops, ~1.4 us a symbol). The
wire allows no more than 16 chains to encode and 4 to decode. Every size
estimate keeps that module's float arithmetic, so the picks are the same.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from . import rans
from .ctxcoder import (
    NUM_CHUNKS, NUM_STATES, PLAN_RB, PLAN_SB, chain_outputs, chunk_bounds_arrays, coder_plan,
    decode_chunks, entry_table, launch_encode, raise_fault, read_chunk_heads, split_encode_table,
    split_entry_table,
)
from .ctxprep import Symbols, record_bounds
from .device import resolve_device, to_device

NUM_QBINS = 48  # prev-quality bins; 47 doubles as the record-start sentinel
NUM_PBUCKETS = 8
NUM_Q2B = 8  # prev2 buckets (model 1): min(prev2,46)>>3 in 0-5, sentinel 7
NUM_CTX = NUM_PBUCKETS * NUM_QBINS  # 384 (model 0)
NUM_CTX2 = NUM_CTX * NUM_Q2B  # 3072 (model 1); ctx0 = ctx1 // NUM_Q2B
MODELS = (0, 1)  # order-1 and order-2 context models
# NUM_CHUNKS record-aligned chunks of NUM_STATES interleaved rANS states each
# (:mod:`.ctxcoder`; the states break the serial x-update dependency chain)
PROB_BITS = rans.PROB_BITS
PROB_SCALE = rans.PROB_SCALE
RANS_L = rans.RANS_L


class QctxError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Contexts and chunk bounds (vectorized)
# ---------------------------------------------------------------------------


def contexts(
    raw: np.ndarray, lengths: np.ndarray, model: int = 0
) -> np.ndarray:
    """Per-symbol context ids (vectorized); ``model`` 0 = order-1,
    1 = order-2 (adds the bucketed second-previous value)."""
    n = len(raw)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    lengths = lengths.astype(np.int64)
    starts = np.zeros(len(lengths), dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    pos = np.arange(n, dtype=np.int64)
    base = np.zeros(n, dtype=np.int64)
    nz = lengths > 0
    base[starts[nz]] = 1
    seg = np.cumsum(base) - 1
    p = pos - starts[nz][seg]  # in-record position
    qbin = np.empty(n, dtype=np.int64)
    qbin[0:] = NUM_QBINS - 1  # sentinel
    prev_mask = p > 0
    qbin[prev_mask] = np.minimum(raw[np.flatnonzero(prev_mask) - 1], 46)
    pbucket = np.minimum(p >> 4, NUM_PBUCKETS - 1)
    ctx = pbucket * NUM_QBINS + qbin
    if model == 0:
        return ctx.astype(np.int32)
    q2b = np.full(n, NUM_Q2B - 1, dtype=np.int64)  # sentinel at p < 2
    m2 = p > 1
    q2b[m2] = np.minimum(raw[np.flatnonzero(m2) - 2], 46) >> 3
    return (ctx * NUM_Q2B + q2b).astype(np.int32)


def chunk_bounds(lengths: np.ndarray, num_chunks: int = NUM_CHUNKS):
    """Record-aligned chunk boundaries balanced by symbol count.

    Returns (record_bounds, symbol_bounds), each of len num_chunks+1.
    Deterministic integer arithmetic — the C++ decoder recomputes this.
    """
    rb, sb = chunk_bounds_arrays(lengths, num_chunks)
    return rb.tolist(), sb.tolist()


def hist_for_model(hist2: np.ndarray, model: int) -> np.ndarray:
    """The model's histogram from the max-model (order-2) histogram:
    ctx0 = ctx1 // NUM_Q2B, so model 0 is a marginalization."""
    if model == 1:
        return hist2
    return hist2.reshape(NUM_CTX, NUM_Q2B, 256).sum(axis=1)


def normalize_tables(hist: np.ndarray) -> np.ndarray:
    """Per-context 12-bit frequency tables (same shape as ``hist``,
    uint16; all zeros for unused contexts)."""
    freq = np.zeros(hist.shape, dtype=np.uint16)
    used = hist.sum(axis=1) > 0
    for c in np.flatnonzero(used):
        freq[c] = rans.normalize_freqs(hist[c].copy())
    return freq


def estimate_size(hist: np.ndarray, freq: np.ndarray | None = None) -> int:
    """Exact coded-bits estimate + table/state overhead (pre-encode).

    ``hist`` is the model's own histogram (384 or 3072 contexts).
    """
    if freq is None:
        freq = normalize_tables(hist)
    nz = hist > 0
    f = freq.astype(np.float64)
    bits = float(
        np.sum(hist[nz] * (PROB_BITS - np.log2(np.maximum(f[nz], 1))))
    )
    table_syms = int(nz.sum())
    # serialized tables compress well; approximate post-zstd at 60%
    table_bytes = int((hist.shape[0] * 2 + table_syms * 3) * 0.6)
    overhead = 8 + 4 + table_bytes + NUM_CHUNKS * (4 * NUM_STATES + 4)
    return int(bits / 8) + overhead


def sample_estimate(
    delta: np.ndarray, lengths: np.ndarray, max_syms: int = 1 << 17,
    device=None,
) -> int | None:
    """Optimistic projected qctx size from a record-aligned prefix —
    the pre-gate twin of seqctx.sample_estimate: the full model
    histogram costs a pass over the whole stream; on quality data with
    no order-1/2 structure that pass is waste. The probe must itself be
    cheap (~1-2 ms: it runs on every large quality stream, win or
    lose), so it projects from the MODEL-0 contexts of a 128k-symbol
    prefix only — model 1 refines model 0, so an extra 7% optimism
    factor stands in for its possible edge plus sampling under-count.
    Optimistic is the safe direction for a skip-gate. Returns None when
    the stream is within 2x of the sample budget (just run the real
    estimate). The prefix goes through :func:`prepare` on ``device``
    (default: the CUDA card) and model 0 is the marginal of its
    histogram."""
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    if total <= 2 * max_syms:
        return None
    csum = np.cumsum(lengths)
    nrec_s = max(1, int(np.searchsorted(csum, max_syms, side="right")))
    lens_s = lengths[:nrec_s]
    nb = int(lens_s.sum())
    if nb == 0:
        return None
    delta_s = np.ascontiguousarray(delta[:nb]).astype(np.uint8)
    hist = hist_for_model(prepare(delta_s, lens_s, device)[1], 0)
    nz = hist > 0
    freq = normalize_tables(hist)
    f = freq.astype(np.float64)
    bits = float(
        np.sum(hist[nz] * (PROB_BITS - np.log2(np.maximum(f[nz], 1))))
    )
    table_syms = int(nz.sum())
    table_bytes = int((NUM_CTX * 2 + table_syms * 3) * 0.6)
    return int(bits / nb * total / 8 * 0.93) + 12 + table_bytes


def pick_model(hist2: np.ndarray) -> tuple[int, int]:
    """-> (model, estimated size): the order with the smaller estimate
    (payload bits + its own table overhead), from one max-model
    histogram."""
    best, best_sz = 0, None
    for m in MODELS:
        sz = estimate_size(hist_for_model(hist2, m))
        if best_sz is None or sz < best_sz:
            best, best_sz = m, sz
    return best, best_sz


# ---------------------------------------------------------------------------
# Table (de)serialization
# ---------------------------------------------------------------------------


def serialize_tables(freq: np.ndarray) -> bytes:
    """Sparse per-context table blob: u16 nsyms, then (u8 sym, u16 freq)*."""
    out = bytearray()
    for c in range(freq.shape[0]):
        syms = np.flatnonzero(freq[c])
        out += struct.pack("<H", len(syms))
        for s in syms:
            out += struct.pack("<BH", int(s), int(freq[c, s]))
    return bytes(out)


def deserialize_tables(blob: bytes, num_ctx: int = NUM_CTX) -> np.ndarray:
    freq = np.zeros((num_ctx, 256), dtype=np.uint16)
    off = 0
    view = memoryview(blob)
    for c in range(num_ctx):
        if off + 2 > len(blob):
            raise QctxError("truncated qctx table blob")
        (nsyms,) = struct.unpack_from("<H", view, off)
        off += 2
        if nsyms > 256 or off + 3 * nsyms > len(blob):
            raise QctxError("truncated qctx table blob")
        for _ in range(nsyms):
            s, f = struct.unpack_from("<BH", view, off)
            off += 3
            freq[c, s] = f
        if nsyms and int(freq[c].astype(np.int64).sum()) != PROB_SCALE:
            raise QctxError("invalid qctx frequency table")
    if off != len(blob):
        raise QctxError("trailing qctx table bytes")
    return freq


# ---------------------------------------------------------------------------
# rANS walks (per-symbol Python loops): the kernels' plain versions
# ---------------------------------------------------------------------------

QCTX_FAULTS = {
    1: "qctx slot of a symbol with no frequency",
    2: "truncated qctx words",
    3: "trailing qctx words",
}


def _encode_chunk(
    raw: np.ndarray, ctx: np.ndarray, lo: int, hi: int,
    freq: np.ndarray, cum: np.ndarray, words: np.ndarray, flags: np.ndarray,
) -> list[int] | None:
    """Backward-encode symbols [lo, hi) over NUM_STATES interleaved
    states (symbol at chunk-local index t belongs to state t % 4); each
    word and its flag go to its symbol's index in ``words`` / ``flags``
    (flat order is the decoder's). -> the final states, or None where a
    present symbol has no frequency."""
    xs = [RANS_L] * NUM_STATES
    for j in range(hi - 1, lo - 1, -1):
        si = (j - lo) & (NUM_STATES - 1)
        x = xs[si]
        c = int(ctx[j])
        s = int(raw[j])
        f = int(freq[c, s])
        if f == 0:
            return None
        cm = int(cum[c, s])
        if x >= (f << 20):
            words[j] = x & 0xFFFF
            flags[j] = 1
            x >>= 16
        xs[si] = ((x // f) << PROB_BITS) + (x % f) + cm
    return xs


def qctx_encode_plain(raw: torch.Tensor, starts: torch.Tensor, plan: torch.Tensor,
                      tab: torch.Tensor, model: int) -> tuple:
    """The plain version of ``fq_qctx_encode`` (CPU tensors): the (n,) raw
    qualities of records starting at ``starts`` ((nrec + 1,) int64), the
    host ``plan`` (:func:`.ctxcoder.coder_plan`), ``tab`` the (contexts, 256)
    int64 entries (:func:`.ctxcoder.encode_table`) -> see
    :func:`.ctxcoder.chain_outputs`. Chunks after a faulting one are not
    walked."""
    r = raw.numpy()
    ctx = contexts(r, np.diff(starts.numpy()), model)
    freq, cum = split_encode_table(tab)
    return chain_outputs(r.size, plan, lambda k, lo, hi, w, f: _encode_chunk(
        r, ctx, lo, hi, freq, cum, w, f))


def _decode_chunk(
    out_raw: np.ndarray, lengths: np.ndarray, rec_lo: int, rec_hi: int,
    sym_lo: int, state, words: np.ndarray,
    freq: np.ndarray, cum: np.ndarray, slot_sym: np.ndarray,
    model: int = 0,
    zero_freq_fails: bool = False,
) -> tuple[int, int, int]:
    """Forward-decode records [rec_lo, rec_hi) into out_raw[sym_lo:] ->
    (words read, fault code of :data:`QCTX_FAULTS` or 0, symbol index of
    the fault or of the chunk's end)."""
    # Python ints: numpy scalars would turn the slot compares into
    # np.bool_ (whose + is logical OR in numpy 2) and wrap at 32 bits
    xs = [int(v) for v in state]
    wi = 0
    j = sym_lo
    for r in range(rec_lo, rec_hi):
        prev = 0
        prev2 = 0
        for p in range(int(lengths[r])):
            si = (j - sym_lo) & (NUM_STATES - 1)
            x = xs[si]
            if p == 0:
                qbin = NUM_QBINS - 1
            else:
                qbin = min(prev, 46)
            c = min(p >> 4, NUM_PBUCKETS - 1) * NUM_QBINS + qbin
            if model == 1:
                q2b = NUM_Q2B - 1 if p < 2 else min(prev2, 46) >> 3
                c = c * NUM_Q2B + q2b
            slot = x & (PROB_SCALE - 1)
            s = int(slot_sym[c, slot])
            f = int(freq[c, s])
            if f == 0 and zero_freq_fails:
                return wi, 1, j
            cm = int(cum[c, s])
            x = f * (x >> PROB_BITS) + slot - cm
            if x < RANS_L:
                if wi >= len(words):
                    return wi, 2, j
                x = (x << 16) | int(words[wi])
                wi += 1
            xs[si] = x
            out_raw[j] = s
            prev2 = prev
            prev = s
            j += 1
    return wi, 0, j


def _slot_syms(freq: np.ndarray) -> np.ndarray:
    """(num_ctx, PROB_SCALE) slot -> symbol tables."""
    out = np.zeros((freq.shape[0], PROB_SCALE), dtype=np.uint8)
    for c in range(freq.shape[0]):
        f = freq[c].astype(np.int64)
        if f.sum():
            out[c] = np.repeat(np.arange(256, dtype=np.uint8), f)
    return out


# ---------------------------------------------------------------------------
# the decode's shared-memory route (csrc/ctxcoder.cu qctx_dense_decode_kernel)
# ---------------------------------------------------------------------------

# The card's dense route holds a row of u16 cums per (pb, qb', q2') in shared
# memory: pb the in-record position bucket, qb' the previous symbol's dense
# index (its index among the present symbols, 0 always among them; n the
# record start), q2' the bucket min(prev2, 46) >> 3 of the symbol before it
# (model 1; 6 at p < 2). The kernel's constants (kHead, kMetaPad, kMaxDense):
DENSE_HEAD = 512
DENSE_META_PAD = 16
DENSE_MAX_COLUMNS = 64  # the present symbols and the sentinel column: a warp's 2 x 32
DENSE_TILES = (4096, 2048, 1024, 512, 256)  # the largest that fits is taken
SHARED_OPTIN = 227 * 1024  # sm_90's dynamic shared memory a block may ask for
DENSE_ABSENT = 8192  # an absent context's row: {0, 8192, ...}
DENSE_Q2_NONE = 6


class DenseLayout(NamedTuple):
    """The dense route's geometry for a table's present symbols."""

    symbols: np.ndarray  # uint8, ascending, 0 first
    width: int  # u16 columns a row: the symbols and the sentinel, even
    q2rows: int  # rows a (pb, qb') group: 7 (model 1) or 1
    tile: int  # symbols a tile
    shared: int  # dynamic shared bytes of a CTA (fq_qctx_dense_bytes)

    @property
    def rows(self) -> int:
        return NUM_PBUCKETS * (len(self.symbols) + 1) * self.q2rows


def table_alphabet(freq: np.ndarray) -> np.ndarray:
    """The symbols with a frequency in any context of ``freq``, ascending
    (uint8): what the card's dense route is sized by."""
    return np.flatnonzero(np.asarray(freq).any(axis=0)).astype(np.uint8)


def dense_shared_bytes(nsyms: int, model: int, tile: int) -> int:
    """``csrc/ctxcoder.cu dense_geom(...).total``: the header, the word ring
    (2 x tile u16), the rows (and a lane's 128-byte reach past the last),
    then S, M and G (u32 each) and the symbols' counts (u8) of two tiles
    and their pads."""
    width = (nsyms + 2) & ~1
    rows = NUM_PBUCKETS * (nsyms + 1) * (7 if model else 1)
    span = tile + DENSE_META_PAD
    return DENSE_HEAD + 4 * tile + ((rows * 2 * width + 128 + 15) & ~15) + 26 * span


def dense_layout(alphabet, model: int) -> DenseLayout | None:
    """The dense route's layout for a table whose present symbols are
    ``alphabet`` (symbol 0 is added: an absent context decodes to it), or
    None where the columns exceed a warp's 64 or no tile fits the shared
    memory: the decode then takes the L2 route (the slot table). Depends on
    the table's size alone."""
    syms = np.union1d(np.asarray(alphabet, np.int64), [0]).astype(np.uint8)
    n = len(syms)
    if n + 1 > DENSE_MAX_COLUMNS:
        return None
    for tile in DENSE_TILES:
        shared = dense_shared_bytes(n, model, tile)
        if shared <= SHARED_OPTIN:
            return DenseLayout(syms, (n + 2) & ~1, 7 if model else 1, tile, shared)
    return None


def dense_row_context(layout: DenseLayout, row: int, model: int) -> int:
    """The context of the table that dense row ``row`` copies."""
    n = len(layout.symbols)
    q2, t = row % layout.q2rows, row // layout.q2rows
    qb, pb = t % (n + 1), t // (n + 1)
    prev = NUM_QBINS - 1 if qb == n else min(int(layout.symbols[qb]), 46)
    c = pb * NUM_QBINS + prev
    if model:
        c = c * NUM_Q2B + (NUM_Q2B - 1 if q2 == DENSE_Q2_NONE else q2)
    return c


def dense_rows(freq: np.ndarray, model: int, layout: DenseLayout) -> np.ndarray:
    """(rows, width) uint16: the rows the kernel builds in each CTA's shared
    memory from the table's entries: column c < n the cum of symbol
    ``symbols[c]`` in the row's context, the columns after 4096; a context
    with no frequency {0, 8192, ...}."""
    n = len(layout.symbols)
    f = np.asarray(freq, np.int64)
    cum = np.zeros_like(f)
    np.cumsum(f[:, :-1], axis=1, out=cum[:, 1:])
    ctx = np.array([dense_row_context(layout, r, model) for r in range(layout.rows)])
    out = np.full((layout.rows, layout.width), PROB_SCALE, np.uint16)
    out[:, :n] = cum[ctx][:, layout.symbols]
    absent = f[ctx].sum(axis=1) == 0
    out[absent] = DENSE_ABSENT
    out[absent, 0] = 0
    return out


def dense_lookup(row: np.ndarray, slot: int) -> tuple[int, int, int]:
    """A dense row's search at ``slot``, as the kernel's two ballots do it ->
    (cnt: the dense index + 1, f, cum)."""
    cnt = int((row.astype(np.int64) <= slot).sum())
    cum = int(row[cnt - 1])
    return cnt, (int(row[cnt]) - cum) & 0x1FFF, cum


def qctx_decode_plain(words: torch.Tensor, starts: torch.Tensor, plan: torch.Tensor,
                      tab: torch.Tensor, model: int, checks: bool) -> tuple:
    """The plain version of ``fq_qctx_decode`` (CPU tensors): the payload's
    (W,) int16 words, record ``starts``, the host ``plan`` with the chunks'
    word counts and states, ``tab`` the (contexts, 256) int32 entries;
    ``checks``: the whole-file decoder's checks (a slot of a symbol with no
    frequency, words left over) -> (delta uint8 (n,), info int64 (4, 2); see
    :func:`.ctxcoder.decode_chunks`)."""
    p = plan.numpy()
    lengths = np.diff(starts.numpy())
    freq, cum = split_entry_table(tab)
    slot_sym = _slot_syms(freq)
    raw = np.zeros(int(p[PLAN_SB + NUM_CHUNKS]), np.uint8)
    info = decode_chunks(plan, words, lambda k, state, w: _decode_chunk(
        raw, lengths, int(p[PLAN_RB + k]), int(p[PLAN_RB + k + 1]), int(p[PLAN_SB + k]),
        state, w, freq, cum, slot_sym, model, checks), checks)
    delta = np.frombuffer(deintegrate(raw, lengths), np.uint8).copy()
    return torch.from_numpy(delta), info


def prepare(delta: np.ndarray, lengths: np.ndarray, device=None):
    """-> (raw symbols, (NUM_CTX2, 256) max-model histogram). Both
    models' tables derive from this one histogram
    (:func:`hist_for_model`). The pass runs on ``device`` (default: the
    CUDA card; ``fq_qctx_prepare``, :func:`.ctxprep.qctx_prepare`) and the
    raw symbols stay there (:class:`.ctxprep.Symbols`)."""
    if int(lengths.sum()) != len(delta):
        raise QctxError("qual stream length does not match record lengths")
    from . import ctxprep

    return ctxprep.qctx_prepare(resolve_device(device), delta, lengths)


def _assemble_payload(total, blob, states, word_runs, model) -> bytes:
    out = bytearray()
    out += struct.pack("<IBB2x", total, NUM_CHUNKS, model)
    out += struct.pack("<I", len(blob))
    out += blob
    for xs, words in zip(states, word_runs):
        xs = np.asarray(xs).reshape(NUM_STATES)
        out += xs.astype("<u4").tobytes()
        out += struct.pack("<I", len(words))
    for words in word_runs:
        out += np.asarray(words).astype("<u2").tobytes()
    return bytes(out)


def encode_prepared(
    raw: Symbols,
    lengths: np.ndarray,
    hist2: np.ndarray,
) -> bytes:
    """Encode from a :func:`prepare` result (lets callers reuse the
    histogram they computed for the size estimate); picks the context
    model with the smaller estimated size. ``raw``: the prepared symbols,
    coded where they lie (``fq_qctx_encode`` and ``fq_rans_compact`` on a
    card, the walks below on the CPU)."""
    from . import cuda_kernels

    lengths = np.asarray(lengths, np.int64)
    model, _ = pick_model(hist2)
    hist = hist_for_model(hist2, model)
    freq = normalize_tables(hist)
    pending = launch_encode(cuda_kernels.qctx_encode, raw, lengths, freq, model,
                            QctxError("invalid qctx frequency table"))

    from ..entropy import zstd as zstd_entropy

    # the table blob is made on the host while the card codes
    blob = zstd_entropy.get_codec().compress(serialize_tables(freq))
    states, word_runs = pending.result()
    return _assemble_payload(int(lengths.sum()), blob, states, word_runs, model)


def encode(delta: bytes | np.ndarray, lengths: np.ndarray, device=None) -> bytes:
    """delta qual stream + record lengths -> qctx payload (the prepare
    pass and the coder on ``device``, default: the CUDA card)."""
    d = (
        np.frombuffer(delta, np.uint8)
        if isinstance(delta, (bytes, bytearray))
        else delta
    )
    lengths = np.asarray(lengths, dtype=np.int64)
    raw, hist = prepare(d, lengths, device)
    return encode_prepared(raw, lengths, hist)


# The JAX package's whole-file decoder takes a table blob of at most this
# many bytes, and only from a frame that declares its size.
RUNTIME_BLOB_MAX = 1 << 23


def decode(
    payload: bytes, lengths: np.ndarray, runtime_checks: bool = False, device=None,
) -> bytes:
    """qctx payload + record lengths -> delta qual stream, decoded on
    ``device`` (default: the CUDA card; ``fq_qctx_decode``), the payload
    parsed and its tables read on the host.

    ``runtime_checks``: also refuse what the JAX package's whole-file
    decoder refuses and its per-block decoders pass on to the block CRC
    (``fq_qctx_decode`` in its runtime): a table blob whose frame does not
    declare a size of at most :data:`RUNTIME_BLOB_MAX`, a slot of a
    symbol with no frequency, and words left over at the end of a chunk."""
    from . import cuda_kernels

    dev = resolve_device(device)
    lengths = np.asarray(lengths, dtype=np.int64)
    buf = memoryview(payload)
    if len(buf) < 12:
        raise QctxError("truncated qctx stream")
    total, nchunks, model = struct.unpack_from("<IBB2x", buf, 0)
    (blob_size,) = struct.unpack_from("<I", buf, 8)
    off = 12
    if int(lengths.sum()) != total:
        raise QctxError("qctx total does not match record lengths")
    if (
        nchunks != NUM_CHUNKS
        or model not in MODELS
        or len(buf) < off + blob_size
    ):
        raise QctxError("truncated qctx stream")

    from ..entropy import zstd as zstd_entropy

    if runtime_checks:
        declared = zstd_entropy.frame_content_size(bytes(buf[off : off + blob_size]))
        if declared is None or declared > RUNTIME_BLOB_MAX:
            raise QctxError("qctx table blob size not declared or too large")
    try:
        blob = zstd_entropy.get_codec().decompress(
            bytes(buf[off : off + blob_size])
        )
    except zstd_entropy.ZstdError as e:
        raise QctxError(f"corrupt qctx table blob: {e}") from None
    freq = deserialize_tables(blob, NUM_CTX2 if model == 1 else NUM_CTX)
    off += blob_size

    states, counts, off = read_chunk_heads(buf, off, nchunks, QctxError("truncated qctx stream"))
    if len(buf) < off + 2 * sum(counts):
        raise QctxError("truncated qctx words")
    words = np.frombuffer(buf[off : off + 2 * sum(counts)], "<u2")
    delta, info = cuda_kernels.qctx_decode(
        to_device(dev, words.view(np.int16)), to_device(dev, record_bounds(lengths)),
        coder_plan(lengths, counts, states), to_device(dev, entry_table(freq).view(np.int32)),
        model, runtime_checks, table_alphabet(freq))
    raise_fault(info, QCTX_FAULTS, QctxError)
    return delta.cpu().numpy().tobytes()


def deintegrate(raw: np.ndarray, lengths: np.ndarray) -> bytes:
    """Inverse of the prepare pass's per-record integration (vectorized)."""
    n = len(raw)
    if n == 0:
        return b""
    lengths = lengths.astype(np.int64)
    starts = np.zeros(len(lengths), dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    delta = np.empty(n, dtype=np.int64)
    r64 = raw.astype(np.int64)
    delta[0] = r64[0]
    delta[1:] = r64[1:] - r64[:-1]
    nz = lengths > 0
    delta[starts[nz]] = r64[starts[nz]]
    return (delta % 256).astype(np.uint8).tobytes()
