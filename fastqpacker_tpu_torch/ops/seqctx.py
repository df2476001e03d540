"""Order-k context-modeled sequence coder (FQZ v3 ``TAG_SCTX``).

The reference codes bases as a 2-bit pack + zstd (sequence.go:58-137 +
compress.go:523-528) — a hard floor of 2 bits/base on match-free data.
Real DNA is not memoryless: conditioning each base on its k predecessors
(k = 2/4/6) reaches ~1.8-1.95 bits/base on genomic reads, which the
2-bit pack cannot see. Like :mod:`.qualctx`, this is
a static two-pass per-block model, so blocks stay independently
decodable and the coder parallelizes.

Model:

- Symbols are the unpacked 2-bit base codes of the v3 seq stream
  (A=0, C=1, G=2, T=3; N already folded to A with positions in the npos
  stream, sequence.go:44-51).
- Context of the base at in-record position ``p`` is the previous
  ``k`` bases packed little-endian (most recent base in the low bits);
  positions with fewer than ``k`` predecessors use 0 for the missing
  ones. ``4**k`` contexts.
- One order-6 histogram pass serves every candidate order: lower-order
  tables are marginalizations (sum over the high context bits), so the
  encoder picks the order with the smallest *estimated* coded size
  (payload bits + its own table overhead) before running the coder.
- Per-context 12-bit rANS tables over the 4-symbol alphabet, serialized
  dense (u16 per entry) and zstd-compressed. A 4-symbol alphabet means
  decode needs no slot tables: 3 compares against the cumulative
  boundaries resolve the symbol.
- The walk splits into :data:`NUM_CHUNKS` record-aligned chunks with
  independent rANS states (:func:`.ctxcoder.chunk_bounds_arrays`), 32-bit
  states, 16-bit renorm words — identical conventions to ops/rans.py.

The decoder re-packs bases into the wire's packed-row layout
(4 bases/byte LSB-first, each record starting a fresh byte, zero
padding bits) byte-identically — the block CRC32 is computed over the
packed stream, so padding must reproduce exactly.

The port's copy of ``fastqpacker_tpu/ops/seqctx.py``. Its passes run on a
device, the CUDA card unless the caller names the CPU: the prepare pass
(unpack and the order-6 histogram, ``fq_sctx_prepare``, :mod:`.ctxprep`), the
encode (``fq_sctx_encode`` + ``fq_rans_compact``, as :mod:`.qualctx`'s) and
the decode (``fq_sctx_decode``: a chain a chunk over the context rows in
shared memory, straight to the packed rows), all in ``csrc/ctxcoder.cu``, with
:mod:`.ctxcoder`'s plan and launch steps; tables, payload and faults stay host
code. On the CPU the walks below are the plain versions (per-symbol Python
loops). Every size estimate keeps that module's
float arithmetic, so the picks are the same.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import rans
from .ctxcoder import (
    NUM_CHUNKS, NUM_STATES, PLAN_RB, PLAN_SB, chain_outputs, coder_plan, decode_chunks,
    launch_encode, raise_fault, read_chunk_heads, split_encode_table,
)
from .ctxprep import Symbols, record_bounds
from .device import resolve_device, to_device

MAX_ORDER = 6
ORDERS = (2, 4, 6)
DECODE_TILE = 4096  # bases a tile of the card's decode (csrc/ctxcoder.cu kSctxTile)
PROB_BITS = rans.PROB_BITS
PROB_SCALE = rans.PROB_SCALE
RANS_L = rans.RANS_L

HEADER_FMT = "<IBB2x"  # total_bases, order, nchunks


class SctxError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Packed stream <-> flat base symbols (numpy reference)
# ---------------------------------------------------------------------------


def _starts_of(lengths: np.ndarray) -> np.ndarray:
    starts = np.zeros(len(lengths), dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    return starts


def packed_row_lengths(lengths: np.ndarray) -> np.ndarray:
    return (lengths.astype(np.int64) + 3) >> 2


def unpack_stream(packed: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenated packed rows -> flat 2-bit symbols (one per base)."""
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint8)
    plens = packed_row_lengths(lengths)
    if int(plens.sum()) != len(packed):
        raise SctxError("packed sequence data does not match lengths")
    pstarts = _starts_of(plens)
    starts = _starts_of(lengths)
    nz = lengths > 0
    marker = np.zeros(total, dtype=np.int64)
    marker[starts[nz]] = 1
    seg = np.cumsum(marker) - 1
    p = np.arange(total, dtype=np.int64) - starts[nz][seg]
    byte_idx = pstarts[nz][seg] + (p >> 2)
    shift = (p & 3) * 2
    return ((packed[byte_idx] >> shift) & 3).astype(np.uint8)


def pack_stream(bases: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Inverse of :func:`unpack_stream`, zero padding bits."""
    lengths = lengths.astype(np.int64)
    plens = packed_row_lengths(lengths)
    out = np.zeros(int(plens.sum()), dtype=np.uint8)
    total = int(lengths.sum())
    if total == 0:
        return out
    pstarts = _starts_of(plens)
    starts = _starts_of(lengths)
    nz = lengths > 0
    marker = np.zeros(total, dtype=np.int64)
    marker[starts[nz]] = 1
    seg = np.cumsum(marker) - 1
    p = np.arange(total, dtype=np.int64) - starts[nz][seg]
    byte_idx = pstarts[nz][seg] + (p >> 2)
    shift = ((p & 3) * 2).astype(np.uint8)
    np.bitwise_or.at(out, byte_idx, bases.astype(np.uint8) << shift)
    return out


# ---------------------------------------------------------------------------
# Contexts, histogram, order pick
# ---------------------------------------------------------------------------


def contexts(
    bases: np.ndarray, lengths: np.ndarray, order: int
) -> np.ndarray:
    """Per-symbol context ids for the given order (vectorized)."""
    n = len(bases)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    lengths = lengths.astype(np.int64)
    starts = _starts_of(lengths)
    nz = lengths > 0
    marker = np.zeros(n, dtype=np.int64)
    marker[starts[nz]] = 1
    seg = np.cumsum(marker) - 1
    p = np.arange(n, dtype=np.int64) - starts[nz][seg]
    ctx = np.zeros(n, dtype=np.int64)
    b64 = bases.astype(np.int64)
    for i in range(1, order + 1):
        prev = np.zeros(n, dtype=np.int64)
        prev[i:] = b64[:-i]
        prev[p < i] = 0
        ctx |= prev << (2 * (i - 1))
    return ctx.astype(np.int32)


def marginalize(hist: np.ndarray, order: int) -> np.ndarray:
    """Reduce a max-order histogram to a lower order by summing over the
    high (oldest-predecessor) context bits."""
    nctx = 4**order
    return hist.reshape(-1, nctx, 4).sum(axis=0)


def normalize_tables(hist: np.ndarray) -> np.ndarray:
    """Vectorized per-context normalization to PROB_SCALE over 4 symbols.

    Present symbols get freq >= 1; the residual settles on each
    context's largest bucket (it is >= PROB_SCALE/4, so never underflows).
    """
    totals = hist.sum(axis=1, keepdims=True)
    used = totals[:, 0] > 0
    freq = np.zeros(hist.shape, dtype=np.int64)
    safe = np.maximum(totals, 1)
    freq[used] = (hist[used] * PROB_SCALE) // safe[used]
    bump = (hist > 0) & (freq == 0)
    freq[bump] = 1
    diff = PROB_SCALE - freq.sum(axis=1)
    top = np.argmax(freq, axis=1)
    rows = np.flatnonzero(used)
    freq[rows, top[rows]] += diff[rows]
    return freq.astype(np.uint16)


def _table_overhead(order: int, freq: np.ndarray) -> int:
    """Approximate serialized+zstd table size for the estimate."""
    used = int((freq.sum(axis=1) > 0).sum())
    # dense u16 blob compresses to roughly 40% (mostly zero rows drop out)
    return (
        12 + 4 + int((used * 8 + 4**order // 8) * 0.5)
        + NUM_CHUNKS * (4 * NUM_STATES + 4)
    )


def estimate_size(hist6: np.ndarray, order: int) -> int:
    """Estimated payload bytes at ``order`` from the max-order histogram."""
    hist = marginalize(hist6, order) if order < MAX_ORDER else hist6
    freq = normalize_tables(hist)
    nzm = hist > 0
    f = freq.astype(np.float64)
    bits = float(
        np.sum(hist[nzm] * (PROB_BITS - np.log2(np.maximum(f[nzm], 1))))
    )
    return int(bits / 8) + _table_overhead(order, freq)


def sample_estimate(
    packed: np.ndarray, lengths: np.ndarray, max_bases: int = 1 << 20,
    device=None,
) -> int | None:
    """Optimistic projected sctx size from a record-aligned prefix.

    A cheap pre-gate for the pick: the full histogram pass costs
    ~1 op/base over the whole stream; on data with no order-k structure
    (uncorrelated DNA) that pass is pure waste. Runs the normal prepare
    on up to ``max_bases`` leading records and
    projects each candidate order's per-base rate over the stream,
    taking the minimum. The projection is *optimistic* (sampled tables
    under-count used contexts, so overhead is under-estimated), which is
    the safe direction for a skip-gate. Returns None when the stream is
    within 2x of the sample budget (just run the real estimate). The
    prefix's prepare runs on ``device`` (default: the CUDA card).
    """
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    if total <= 2 * max_bases:
        return None
    csum = np.cumsum(lengths)
    nrec_s = max(1, int(np.searchsorted(csum, max_bases, side="right")))
    lens_s = lengths[:nrec_s]
    nb = int(lens_s.sum())
    if nb == 0:
        return None
    plen_s = int(packed_row_lengths(lens_s).sum())
    _, hist6_s = prepare(np.ascontiguousarray(packed[:plen_s]), lens_s, device)
    best = None
    for k in ORDERS:
        hist = marginalize(hist6_s, k) if k < MAX_ORDER else hist6_s
        freq = normalize_tables(hist)
        nzm = hist > 0
        f = freq.astype(np.float64)
        bits = float(
            np.sum(hist[nzm] * (PROB_BITS - np.log2(np.maximum(f[nzm], 1))))
        )
        proj = int(bits / nb * total / 8) + _table_overhead(k, freq)
        if best is None or proj < best:
            best = proj
    return best


def pick_order(hist6: np.ndarray) -> tuple[int, int]:
    """-> (best order, its estimated size)."""
    best, best_sz = ORDERS[0], None
    for k in ORDERS:
        sz = estimate_size(hist6, k)
        if best_sz is None or sz < best_sz:
            best, best_sz = k, sz
    return best, best_sz


# ---------------------------------------------------------------------------
# Table (de)serialization — dense, zstd-compressed by the caller
# ---------------------------------------------------------------------------


def serialize_tables(freq: np.ndarray) -> bytes:
    return np.ascontiguousarray(freq.astype("<u2")).tobytes()


def deserialize_tables(blob: bytes, order: int) -> np.ndarray:
    nctx = 4**order
    if len(blob) != nctx * 4 * 2:
        raise SctxError("truncated sctx table blob")
    freq = (
        np.frombuffer(blob, "<u2").astype(np.uint16).reshape(nctx, 4)
    )
    sums = freq.astype(np.int64).sum(axis=1)
    if not np.all((sums == 0) | (sums == PROB_SCALE)):
        raise SctxError("invalid sctx frequency table")
    return freq


# ---------------------------------------------------------------------------
# rANS walks (per-symbol Python loops): the kernels' plain versions
# ---------------------------------------------------------------------------

SCTX_FAULTS = {
    1: "corrupted sctx sequence data",
    2: "truncated sctx words",
    3: "trailing sctx words",
}


def _encode_chunk(
    bases: np.ndarray, lengths: np.ndarray, rec_lo: int, rec_hi: int,
    sym_lo: int, sym_hi: int, order: int,
    freq: np.ndarray, cum: np.ndarray, words: np.ndarray, flags: np.ndarray,
) -> list[int] | None:
    """Backward-encode records [rec_lo, rec_hi) (symbols [sym_lo, sym_hi));
    each word and its flag go to its symbol's index -> the final states, or
    None where a present symbol has no frequency."""
    xs = [RANS_L] * NUM_STATES
    j = sym_hi
    for r in range(rec_hi - 1, rec_lo - 1, -1):
        L = int(lengths[r])
        for p in range(L - 1, -1, -1):
            j -= 1
            si = (j - sym_lo) & (NUM_STATES - 1)
            x = xs[si]
            ctx = 0
            for i in range(1, order + 1):
                if p - i >= 0:
                    ctx |= int(bases[j - i]) << (2 * (i - 1))
            s = int(bases[j])
            f = int(freq[ctx, s])
            if f == 0:
                return None
            cm = int(cum[ctx, s])
            if x >= (f << 20):
                words[j] = x & 0xFFFF
                flags[j] = 1
                x >>= 16
            xs[si] = ((x // f) << PROB_BITS) + (x % f) + cm
    assert j == sym_lo
    return xs


def sctx_encode_plain(bases: torch.Tensor, starts: torch.Tensor, plan: torch.Tensor,
                      tab: torch.Tensor, order: int) -> tuple:
    """The plain version of ``fq_sctx_encode`` (CPU tensors): the (n,) bases
    of records starting at ``starts``, the host ``plan``
    (:func:`.ctxcoder.coder_plan`), ``tab`` the (4**order, 4) int64 entries
    (:func:`.ctxcoder.encode_table`) -> see :func:`.ctxcoder.chain_outputs`."""
    b = bases.numpy()
    lengths = np.diff(starts.numpy())
    freq, cum = split_encode_table(tab)
    rb = plan.numpy()[PLAN_RB : PLAN_RB + 5]
    return chain_outputs(b.size, plan, lambda k, lo, hi, w, f: _encode_chunk(
        b, lengths, int(rb[k]), int(rb[k + 1]), lo, hi, order, freq, cum, w, f))


def _decode_chunk(
    out: np.ndarray, lengths: np.ndarray, rec_lo: int, rec_hi: int,
    sym_lo: int, state, words: np.ndarray, order: int,
    freq: np.ndarray, cum: np.ndarray,
) -> tuple[int, int, int]:
    """Forward-decode records [rec_lo, rec_hi) into out[sym_lo:] -> (words
    read, fault code of :data:`SCTX_FAULTS` or 0, symbol index of the fault
    or of the chunk's end)."""
    # Python ints: numpy scalars would turn the slot compares into
    # np.bool_ (whose + is logical OR in numpy 2) and wrap at 32 bits
    xs = [int(v) for v in state]
    wi = 0
    j = sym_lo
    for r in range(rec_lo, rec_hi):
        ctx = 0
        mask = (1 << (2 * order)) - 1
        for p in range(int(lengths[r])):
            si = (j - sym_lo) & (NUM_STATES - 1)
            x = xs[si]
            slot = x & (PROB_SCALE - 1)
            c1 = int(cum[ctx, 1])
            c2 = int(cum[ctx, 2])
            c3 = int(cum[ctx, 3])
            s = (slot >= c1) + (slot >= c2) + (slot >= c3)
            f = int(freq[ctx, s])
            if f == 0:
                return wi, 1, j
            x = f * (x >> PROB_BITS) + slot - int(cum[ctx, s])
            if x < RANS_L:
                if wi >= len(words):
                    return wi, 2, j
                x = (x << 16) | int(words[wi])
                wi += 1
            xs[si] = x
            out[j] = s
            j += 1
            ctx = ((ctx << 2) | s) & mask
    return wi, 0, j


def sctx_decode_plain(words: torch.Tensor, starts: torch.Tensor, plan: torch.Tensor,
                      freq: torch.Tensor, order: int) -> tuple:
    """The plain version of ``fq_sctx_decode`` (CPU tensors): the payload's
    (W,) int16 words, record ``starts``, the host ``plan`` with the chunks'
    word counts and states, ``freq`` the (4**order, 4) int16 table ->
    (packed rows uint8 (m,), info int64 (4, 2); see
    :func:`.ctxcoder.decode_chunks`)."""
    p = plan.numpy()
    lengths = np.diff(starts.numpy())
    f = freq.numpy().view(np.uint16)
    cum = np.zeros(f.shape, np.uint32)
    np.cumsum(f[:, :-1], axis=1, out=cum[:, 1:])
    bases = np.zeros(int(p[PLAN_SB + NUM_CHUNKS]), np.uint8)
    info = decode_chunks(plan, words, lambda k, state, w: _decode_chunk(
        bases, lengths, int(p[PLAN_RB + k]), int(p[PLAN_RB + k + 1]), int(p[PLAN_SB + k]),
        state, w, order, f, cum), True)
    return torch.from_numpy(pack_stream(bases, lengths)), info


# ---------------------------------------------------------------------------
# Stream API
# ---------------------------------------------------------------------------


def prepare(packed: np.ndarray, lengths: np.ndarray, device=None):
    """-> (flat base symbols, max-order histogram). The pass runs on
    ``device`` (default: the CUDA card; ``fq_sctx_prepare``,
    :func:`.ctxprep.sctx_prepare`) and the bases stay there
    (:class:`.ctxprep.Symbols`); the lengths are checked against the packed
    size first, as :func:`unpack_stream` does."""
    from . import ctxprep

    lengths = np.asarray(lengths, np.int64)
    if int(lengths.sum()) and int(packed_row_lengths(lengths).sum()) != len(packed):
        raise SctxError("packed sequence data does not match lengths")
    return ctxprep.sctx_prepare(resolve_device(device), packed, lengths)


def encode_prepared(
    bases: Symbols,
    lengths: np.ndarray,
    hist6: np.ndarray,
) -> bytes:
    """Encode from a :func:`prepare` result at the order with the smallest
    estimate. ``bases``: the prepared symbols, coded where they lie
    (``fq_sctx_encode`` and ``fq_rans_compact`` on a card, the walks below on
    the CPU)."""
    from . import cuda_kernels

    lengths = np.asarray(lengths, np.int64)
    order, _ = pick_order(hist6)
    hist = marginalize(hist6, order) if order < MAX_ORDER else hist6
    freq = normalize_tables(hist)
    pending = launch_encode(cuda_kernels.sctx_encode, bases, lengths, freq, order,
                            SctxError("invalid sctx frequency table"))

    from ..entropy import zstd as zstd_entropy

    # the table blob is made on the host while the card codes
    blob = zstd_entropy.get_codec().compress(serialize_tables(freq))
    states, word_runs = pending.result()
    out = bytearray()
    out += struct.pack(HEADER_FMT, int(lengths.sum()), order, NUM_CHUNKS)
    out += struct.pack("<I", len(blob))
    out += blob
    for xs, words in zip(states, word_runs):
        out += np.asarray(xs).reshape(NUM_STATES).astype("<u4").tobytes()
        out += struct.pack("<I", len(words))
    for words in word_runs:
        out += np.asarray(words).astype("<u2").tobytes()
    return bytes(out)


def encode(packed: bytes | np.ndarray, lengths: np.ndarray, device=None) -> bytes:
    """packed rows + record lengths -> sctx payload (the prepare pass and
    the coder on ``device``, default: the CUDA card)."""
    p = (
        np.frombuffer(packed, np.uint8)
        if isinstance(packed, (bytes, bytearray))
        else packed
    )
    lengths = np.asarray(lengths, dtype=np.int64)
    bases, hist6 = prepare(p, lengths, device)
    return encode_prepared(bases, lengths, hist6)


def decode(payload: bytes, lengths: np.ndarray, device=None) -> bytes:
    """sctx payload + record lengths -> packed seq stream bytes, decoded on
    ``device`` (default: the CUDA card; ``fq_sctx_decode``), the payload
    parsed and its tables read on the host."""
    from . import cuda_kernels

    dev = resolve_device(device)
    lengths = np.asarray(lengths, dtype=np.int64)
    buf = memoryview(payload)
    if len(buf) < 12:
        raise SctxError("truncated sctx stream")
    total, order, nchunks = struct.unpack_from(HEADER_FMT, buf, 0)
    (blob_size,) = struct.unpack_from("<I", buf, 8)
    off = 12
    if int(lengths.sum()) != total:
        raise SctxError("sctx total does not match record lengths")
    if (
        nchunks != NUM_CHUNKS
        or order not in ORDERS
        or len(buf) < off + blob_size
    ):
        raise SctxError("truncated sctx stream")

    from ..entropy import zstd as zstd_entropy

    try:
        blob = zstd_entropy.get_codec().decompress(
            bytes(buf[off : off + blob_size])
        )
    except zstd_entropy.ZstdError as e:
        raise SctxError(f"corrupt sctx table blob: {e}") from None
    freq = deserialize_tables(blob, order)
    off += blob_size

    states, counts, off = read_chunk_heads(buf, off, nchunks, SctxError("truncated sctx stream"))
    if len(buf) < off + 2 * sum(counts):
        raise SctxError("truncated sctx words")
    words = np.frombuffer(buf[off : off + 2 * sum(counts)], "<u2")
    packed, info = cuda_kernels.sctx_decode(
        to_device(dev, words.view(np.int16)), to_device(dev, record_bounds(lengths)),
        coder_plan(lengths, counts, states), to_device(dev, freq.view(np.int16)), order)
    raise_fault(info, SCTX_FAULTS, SctxError)
    return packed.cpu().numpy().tobytes()
