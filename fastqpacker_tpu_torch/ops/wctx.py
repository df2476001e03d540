"""Wide-interleaved context-modeled rANS coder (FQZ v3 ``TAG_WCTX``).

The port of ``fastqpacker_tpu/ops/wctx.py``: the same wire stream for the
same symbols, with the two device programs (lockstep encode, lockstep
decode) as the Hopper kernels of ``csrc/wctx_codec.cu`` (wrappers in
:mod:`.cuda_kernels`). The plain PyTorch versions of those programs are
here; the wrappers run them on CPU tensors, and the kernels are held
against them on the card.

The host context coders (:mod:`.seqctx` order-k sequences, :mod:`.qualctx`
order-1 qualities) run 4-16 sequential rANS states. This is the device
context coder: the same static two-pass models evaluated over N (256-8192)
record-aligned lanes in lockstep, so the entropy stage of ``fqpack --mesh``
keeps context modeling on the accelerator.

- **Segment lanes, not stride lanes.** Lane ``l`` codes a *contiguous*,
  record-aligned run of records (``qualctx.chunk_bounds(lengths, N)``),
  one symbol per step. Contexts look backward *within* a lane, so the
  per-step context update is a per-lane carry.
- **Context models** are exactly the host coders' (bit-equal tables):
  model 0 = seq order-k (ctx = previous k base codes in-record); model 1 =
  qual (ctx = position bucket x previous-quality bin; order 1 adds the
  bucket of the quality before that).
- **Table lookups are gathers**: the device programs take one ``(C, npres +
  1)`` table of per-context cumulative frequencies in present-symbol order
  whose last column is the row's total; ``c = row[sym]``, ``f = row[sym +
  1] - c``, and the decoder's symbol is the last column ``<=`` the state's
  low 12 bits.
- **Everything else is the order-0 coder's** (:mod:`.rans`): 32-bit
  states, 16-bit renorm, 12-bit probabilities, backward encode with a flag
  per cell, word compaction on the device (``fq_rans_compact``), global
  (step, lane) word order.

Wire format (little-endian), one standalone stream:

  u8 model | u8 order | u8 lanes_log2 | u8 reserved | u32 total_syms
  | u16 npres | u8 present[npres]
  | u32 blob_len | blob = zstd(dense (C, npres) u16 freq table)
  | u32 nwords | u32 states[N] | u16 words[nwords]

Symbols are the *unpacked* representation (base codes for model 0, raw
integrated qualities for model 1); the v3 wire streams are packed rows /
per-record deltas. Lane layout, step count and the per-(step, lane)
record-start mask are all derived deterministically from ``lengths`` +
``lanes`` on both sides. The (S, N) lane matrices are built on the device
(``fq_wctx_layout``: the encoder's symbol-index and context matrices, the
decoder's start matrix), and the decoded matrix goes back to record order
there (``fq_wctx_unlayout``: symbols, packed rows or deltas), so only the
wire bytes cross to the host (:mod:`.ctxprep`); the numpy lane functions
below are the reference the tests and the kernel benchmarks use.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import ctxprep, rans
from .ctxprep import UNLAYOUT_DELTA, UNLAYOUT_FLAT, UNLAYOUT_PACKED
from .device import resolve_device, to_device
from .qualctx import chunk_bounds

PROB_BITS = rans.PROB_BITS
PROB_SCALE = rans.PROB_SCALE
RANS_L = rans.RANS_L

MODEL_SEQ = 0
MODEL_QUAL = 1
SEQ_ORDERS = (2, 4, 6)

# qual context geometry (must mirror ops/qualctx.py)
NUM_QBINS = 48
NUM_PBUCKETS = 8
NUM_Q2B = 8  # model-1 prev2 buckets: min(prev2,46)>>3, sentinel 7 at p<2
QUAL_NUM_CTX = NUM_PBUCKETS * NUM_QBINS  # 384 (model 1 order 0)
QUAL2_NUM_CTX = QUAL_NUM_CTX * NUM_Q2B  # 3072 (model 1 order 1)
POS_CAP = 4000  # the decoder's position counter stops here (last bucket)

HEADER_FMT = "<BBBxI"
B_MAX = 64  # hard gate on present-symbol width
MAX_DECODE_LANES = 8192  # the decode kernel's widest cluster: 16 CTAs x 512 threads

_M32 = 0xFFFFFFFF


class WctxError(ValueError):
    pass


def model_geometry(model: int, order: int) -> tuple[int, int, int]:
    """-> (C contexts, H, L) with H*L = pow2ceil(C), ctx = hi*L + lo (the
    factorization is the JAX package's; the port uses only C)."""
    if model == MODEL_SEQ:
        if order not in SEQ_ORDERS:
            raise WctxError(f"unsupported wctx seq order {order}")
        c = 4**order
        h = 1 << order  # H = L = 2**order
        return c, h, h
    if model == MODEL_QUAL:
        if order == 0:
            return QUAL_NUM_CTX, 32, 16
        if order == 1:  # qualctx model 1: x prev2 bucket (4096 padded)
            return QUAL2_NUM_CTX, 64, 64
        raise WctxError(f"unsupported wctx qual order {order}")
    raise WctxError(f"unknown wctx model {model}")


def pick_lanes(n: int) -> int:
    """Lane count by stream size: wider = fewer sequential steps, but
    4 B/lane of wire state caps the useful width."""
    if n >= (8 << 20):
        return 8192
    if n >= (2 << 20):
        return 4096
    if n >= (256 << 10):
        return 1024
    return 256


def pick_lanes_for(hist: np.ndarray, n: int) -> int:
    """Ratio-aware lane pick: start from the speed tier and halve while
    the 4 B/lane states exceed 0.5% of the ESTIMATED coded size — on
    high-ratio context streams the raw-size tier otherwise spends 1-2% of
    the container on states. Floor 1024. The states are ~half real payload
    (encode starts each lane at RANS_L = 2^16 and stores a 32-bit state),
    so shrinking the lane count — not state compression — is the only
    real lever. The pick is on the wire."""
    N = pick_lanes(n)
    while N > 1024 and 4 * N > estimate_size(hist, N) * 0.005:
        N //= 2
    return N


# ---------------------------------------------------------------------------
# Lane layout (host reference, deterministic from lengths + lanes)
# ---------------------------------------------------------------------------


def lane_bounds(lengths: np.ndarray, lanes: int) -> tuple[np.ndarray, int]:
    """-> (symbol bounds (lanes+1,), S = max lane segment length)."""
    _, sb = chunk_bounds(lengths.astype(np.int64), lanes)
    sb = np.asarray(sb, np.int64)
    seg = np.diff(sb)
    return sb, int(seg.max()) if len(seg) else 0


def to_matrix(
    flat: np.ndarray, sb: np.ndarray, S: int, fill: int
) -> np.ndarray:
    """Flat per-symbol array -> (S, N) lane matrix (lane l's segment in
    column l, padded with ``fill``)."""
    n_lanes = len(sb) - 1
    seg = np.diff(sb)
    out = np.full((n_lanes, S), fill, dtype=flat.dtype)
    mask = np.arange(S, dtype=np.int64)[None, :] < seg[:, None]
    out[mask] = flat  # row-major: lane 0's segment, then lane 1's, ...
    return np.ascontiguousarray(out.T)


def from_matrix(mat: np.ndarray, sb: np.ndarray) -> np.ndarray:
    """Inverse of :func:`to_matrix` (drops padding)."""
    seg = np.diff(sb)
    S = mat.shape[0]
    mask = np.arange(S, dtype=np.int64)[None, :] < seg[:, None]
    return mat.T[mask]


def start_matrix(
    lengths: np.ndarray, sb: np.ndarray, S: int
) -> np.ndarray:
    """(S, N) bool: position (t, l) begins a record. Row 0 is forced True
    and EVERY padding cell is True (each pad symbol is its own
    pseudo-record), so padding always codes under one fixed, known
    context (0 for seq, the record-start sentinel context for qual).
    The decoder derives the identical matrix from lengths, so the context
    recurrence agrees by construction."""
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    marks = np.zeros(total, dtype=bool)
    if total:
        starts = np.zeros(len(lengths), dtype=np.int64)
        np.cumsum(lengths[:-1], out=starts[1:])
        marks[starts[lengths > 0]] = True
    m = to_matrix(marks, sb, S, 1)  # padding cells -> True
    if S:
        m[0, :] = True
    return m


def _shift_down(mat: np.ndarray, i: int, fill: int = 0) -> np.ndarray:
    out = np.full_like(mat, fill)
    if i < mat.shape[0]:
        out[i:] = mat[:-i] if i else mat
    return out


def position_matrix(startm: np.ndarray) -> np.ndarray:
    """(S, N) int32 in-record positions; padding continues counting past
    its record's end (the decode carry does the same: p = start?0:p+1)."""
    S, n_lanes = startm.shape
    idx = np.arange(S, dtype=np.int64)[:, None]
    last = np.maximum.accumulate(np.where(startm, idx, -1), axis=0)
    return (idx - last).astype(np.int32)


def context_matrix(
    symm: np.ndarray, startm: np.ndarray, model: int, order: int
) -> np.ndarray:
    """(S, N) int32 context ids from the symbol + start matrices — the
    vectorized twin of the decoder's per-step carry recurrence (and, on
    data positions, of seqctx.contexts / qualctx.contexts model 0)."""
    p = position_matrix(startm)
    if model == MODEL_SEQ:
        ctx = np.zeros(symm.shape, dtype=np.int32)
        s32 = symm.astype(np.int32)
        for i in range(1, order + 1):
            prev = _shift_down(s32, i)
            ctx |= np.where(p >= i, prev, 0) << (2 * (i - 1))
        return ctx
    # qual: ctx0 = min(p>>4, 7)*48 + qbin; order 1 appends the prev2
    # bucket (qualctx.contexts model 1): ctx1 = ctx0*8 + q2b
    prev = _shift_down(symm.astype(np.int32), 1)
    qbin = np.where(p == 0, NUM_QBINS - 1, np.minimum(prev, 46))
    pb = np.minimum(p >> 4, NUM_PBUCKETS - 1)
    ctx = (pb * NUM_QBINS + qbin).astype(np.int32)
    if order == 0:
        return ctx
    prev2 = _shift_down(symm.astype(np.int32), 2)
    q2b = np.where(p >= 2, np.minimum(prev2, 46) >> 3, NUM_Q2B - 1)
    return (ctx * NUM_Q2B + q2b).astype(np.int32)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


def matrix_histogram(
    symm: np.ndarray, ctxm: np.ndarray, C: int,
    seg: np.ndarray | None = None,
) -> np.ndarray:
    """(C, 256) int64 histogram. With ``seg`` (real symbols per lane),
    only data cells count — pad cells are skipped by the coders, so the
    tables are exactly the host prepare histograms."""
    if seg is not None:
        S = symm.shape[0]
        mask = np.arange(S, dtype=np.int64)[:, None] < seg[None, :]
        flat = (
            ctxm[mask].astype(np.int64) * 256 + symm[mask].astype(np.int64)
        )
    else:
        flat = ctxm.astype(np.int64).reshape(-1) * 256 + symm.reshape(-1)
    return np.bincount(flat, minlength=C * 256).reshape(C, 256)


def normalize_tables(hist: np.ndarray) -> np.ndarray:
    """Per-context largest-remainder normalization to PROB_SCALE,
    vectorized across contexts (any alphabet width)."""
    hist = hist.astype(np.int64)
    totals = hist.sum(axis=1, keepdims=True)
    used = totals[:, 0] > 0
    freq = np.zeros(hist.shape, dtype=np.int64)
    safe = np.maximum(totals, 1)
    freq[used] = (hist[used] * PROB_SCALE) // safe[used]
    bump = (hist > 0) & (freq == 0)
    freq[bump] = 1
    diff = PROB_SCALE - freq.sum(axis=1)
    # settle the residual on each used context's largest bucket; where the
    # bumps of 1 outweigh it, redo the row with the scalar reference
    top = np.argmax(freq, axis=1)
    rows = np.flatnonzero(used)
    freq[rows, top[rows]] += diff[rows]
    bad = np.flatnonzero(used & (freq.min(axis=1) < 0))
    for c in bad:
        freq[c] = rans.normalize_freqs(hist[c].copy())
    return freq.astype(np.uint16)


def estimate_size(
    hist: np.ndarray, lanes: int, freq: np.ndarray | None = None
) -> int:
    """Coded-size estimate from the (C, A) data histogram: exact payload
    bits + lane states + the EXACT compressed table bytes (the dense
    present-column table is small, so compressing it for the estimate
    costs ~nothing and removes the pick's main error source)."""
    if freq is None:
        freq = normalize_tables(hist)
    nz = hist > 0
    f = freq.astype(np.float64)
    bits = float(
        np.sum(hist[nz] * (PROB_BITS - np.log2(np.maximum(f[nz], 1))))
    )
    present = np.flatnonzero(nz.any(axis=0))
    npres = len(present)
    table_bytes = len(_compress_table(freq[:, present]))
    return (
        int(bits / 8) + 12 + table_bytes + 4 * lanes + 4 + 2 + npres
    )


def build_tables(
    symm: np.ndarray, ctxm: np.ndarray, C: int,
    seg: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """-> (present (npres,) int, freq (C, npres) u16 in present order)."""
    hist = matrix_histogram(symm, ctxm, C, seg)
    present = np.flatnonzero(hist.sum(axis=0) > 0)
    freq_full = normalize_tables(hist)
    return present, np.ascontiguousarray(freq_full[:, present])


def _pcum_from_freq(freq_p: np.ndarray) -> np.ndarray:
    """(C, npres) freqs -> (C, npres) exclusive cumulative (int32)."""
    cum = np.zeros(freq_p.shape, np.int64)
    np.cumsum(freq_p[:, :-1].astype(np.int64), axis=1, out=cum[:, 1:])
    return cum.astype(np.int32)


def device_table(freq_p: np.ndarray) -> np.ndarray:
    """(C, npres) freqs -> the (C, npres + 1) int16 table of the device
    programs: the exclusive cumulative of :func:`_pcum_from_freq` and, in
    the last column, the row's total (PROB_SCALE, or 0 for a context that
    never occurs)."""
    tab = np.zeros((freq_p.shape[0], freq_p.shape[1] + 1), np.int64)
    np.cumsum(freq_p.astype(np.int64), axis=1, out=tab[:, 1:])
    return tab.astype(np.int16)


def _sym_to_idx(present: np.ndarray) -> np.ndarray:
    m = np.zeros(256, np.uint8)
    m[present] = np.arange(len(present), dtype=np.uint8)
    return m


def _compress_table(freq_p: np.ndarray) -> bytes:
    from ..entropy import zstd as zstd_entropy

    return zstd_entropy.get_codec().compress(
        np.ascontiguousarray(freq_p.astype("<u2")).tobytes()
    )


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the two device programs
# ---------------------------------------------------------------------------


def wctx_encode_plain(
    sym: torch.Tensor,
    ctx: torch.Tensor,
    seg: torch.Tensor,
    tab: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward lockstep encode of all lanes, one row per step.

    ``sym``: (S, N) uint8 present-index symbols; ``ctx``: (S, N) int16
    context ids; ``seg``: (N,) int32 real symbols per lane (cells at ``t >=
    seg[lane]`` are padding and are skipped); ``tab``: (C, npres + 1) int16
    (:func:`device_table`). Returns ``(words int16 (S*N,), flags uint8
    (S*N,), states int32 (N,), status int32 (1,))``: per cell the state's
    low 16 bits and whether they were emitted (both 0 on padding), the
    final states, as bit patterns, and 1 in ``status`` when a live cell met
    a zero frequency or an index outside the table (such a cell codes with
    ``f = 1``).
    """
    dev = sym.device
    S, N = sym.shape
    C, width = tab.shape
    tabf = tab.to(torch.int64).reshape(-1)
    seg64 = seg.to(torch.int64).clamp(0, S)
    words = torch.zeros((S, N), dtype=torch.int64, device=dev)
    flags = torch.zeros((S, N), dtype=torch.bool, device=dev)
    x = torch.full((N,), RANS_L, dtype=torch.int64, device=dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(S - 1, -1, -1):
        live = seg64 > t
        s = sym[t].to(torch.int64)
        c = ctx[t].to(torch.int64)
        inside = (s < width - 1) & (c >= 0) & (c < C)
        at = torch.where(inside, c * width + s, zero)
        cum = torch.where(inside, tabf[at], zero)
        f = torch.where(inside, tabf[at + 1] - cum, one)
        wrong = ~inside | (f < 1) | (f > PROB_SCALE)
        bad = bad | (wrong & live).any()
        f = torch.where(wrong | ~live, one, f)
        emit = ((x >> 20) >= f) & live
        words[t] = torch.where(live, x & 0xFFFF, zero)
        flags[t] = emit
        x1 = torch.where(emit, x >> 16, x)
        q = torch.div(x1, f, rounding_mode="floor")
        x = torch.where(live, ((q << PROB_BITS) + x1 % f + cum) & _M32, x)
    return (
        rans._bits16(words).reshape(-1),
        flags.to(torch.uint8).reshape(-1),
        rans._bits32(x),
        bad.to(torch.int32).reshape(1),
    )


def wctx_decode_plain(
    words: torch.Tensor,
    states: torch.Tensor,
    startm: torch.Tensor,
    seg: torch.Tensor,
    tab: torch.Tensor,
    present: torch.Tensor,
    model: int,
    order: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward lockstep decode, one row per step.

    ``words``: (W,) int16 in global (step, lane) order; ``states``: (N,)
    int32; ``startm``: (S, N) uint8, 1 where a record starts; ``seg``,
    ``tab`` as in :func:`wctx_encode_plain`; ``present``: (npres,) uint8
    raw symbol values. The context is carried per lane (contexts see raw
    symbol values, and the previous symbols move only on live cells); the
    symbol is the last column of the context's row that is ``<=`` the
    state's low 12 bits; per step the lanes whose state fell below
    ``RANS_L`` take consecutive words in lane order. Words past the end of
    the buffer read as 0. Returns ``(present-index symbols uint8 (S, N), 0
    on padding; info int64 (2,))``: the words consumed, and 1 when a live
    cell met a context whose row is empty (it decodes with ``f = 1``).
    """
    dev = states.device
    S, N = startm.shape
    C, width = tab.shape
    npres = width - 1
    tab64 = tab.to(torch.int64)
    pres = present.to(torch.int64)
    seg64 = seg.to(torch.int64).clamp(0, S)
    total_words = words.numel()
    wpad = torch.cat(
        [rans._u16(words), torch.zeros(1, dtype=torch.int64, device=dev)]
    )
    x = rans._u32(states)
    ctx = torch.zeros(N, dtype=torch.int64, device=dev)
    pp = torch.zeros(N, dtype=torch.int64, device=dev)  # position + 1
    prev = torch.zeros(N, dtype=torch.int64, device=dev)
    prev2 = torch.zeros(N, dtype=torch.int64, device=dev)
    out = torch.zeros((S, N), dtype=torch.uint8, device=dev)
    base = torch.zeros(1, dtype=torch.int64, device=dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    mask = (1 << (2 * order)) - 1
    for t in range(S):
        live = seg64 > t
        start = startm[t] != 0
        if model == MODEL_SEQ:
            c = torch.where(start, 0, ((ctx << 2) | prev) & mask)
            ctx = torch.where(live, c, ctx)
        else:
            p1 = torch.where(start, 1, torch.clamp(pp + 1, max=POS_CAP))
            pp = torch.where(live, p1, pp)
            pos = p1 - 1
            qbin = torch.where(start, NUM_QBINS - 1, torch.clamp(prev, max=46))
            c = torch.clamp(pos >> 4, max=NUM_PBUCKETS - 1) * NUM_QBINS + qbin
            if order == 1:
                q2b = torch.where(
                    pos >= 2, torch.clamp(prev2, max=46) >> 3, NUM_Q2B - 1
                )
                c = c * NUM_Q2B + q2b
        rows = tab64[c]  # (N, npres + 1)
        slot = x & (PROB_SCALE - 1)
        sym = (rows[:, 1:npres] <= slot[:, None]).sum(dim=1)
        cum = rows.gather(1, sym[:, None])[:, 0]
        f = rows.gather(1, sym[:, None] + 1)[:, 0] - cum
        wrong = (f < 1) | (f > PROB_SCALE)
        bad = bad | (wrong & live).any()
        f = torch.where(wrong, 1, f)
        x1 = (f * (x >> PROB_BITS) + slot - cum) & _M32
        need = (x1 < RANS_L) & live
        ni = need.to(torch.int64)
        rank = torch.cumsum(ni, dim=0) - ni
        w = wpad[torch.clamp(base + rank, max=total_words)]
        x1 = torch.where(need, ((x1 << 16) | w) & _M32, x1)
        x = torch.where(live, x1, x)
        out[t] = torch.where(live, sym, 0).to(torch.uint8)
        prev2 = torch.where(live, prev, prev2)
        prev = torch.where(live, pres[sym], prev)
        base = base + ni.sum()
    return out, torch.cat([base, bad.to(torch.int64).reshape(1)])


# ---------------------------------------------------------------------------
# Stream API
# ---------------------------------------------------------------------------


def stream_layout(lengths: np.ndarray, lanes: int):
    """-> (sb, S, seg int32 (lanes,)) of a stream's lane layout."""
    sb, S = lane_bounds(lengths, lanes)
    return sb, S, (sb[1:] - sb[:-1]).astype(np.int32)


def _on(dev: torch.device, a, dtype: np.dtype) -> torch.Tensor:
    """A matrix built on ``dev`` as it is, or a host array copied there."""
    if isinstance(a, torch.Tensor):
        return a
    return to_device(dev, np.asarray(a).astype(dtype, copy=False))


def launch_encode(
    dev: torch.device,
    sym_idx,
    ctxm,
    seg: np.ndarray,
    freq_p: np.ndarray,
):
    """Enqueue one stream's encode and word compaction on ``dev``'s
    current stream; the (S, N) matrices are tensors on ``dev``
    (:func:`prepare_encode`) or host arrays. Returns the device tensors
    ``(flat, total, states, status)`` that :func:`fetch_encoded` reads."""
    from . import cuda_kernels

    words, flags, states, status = cuda_kernels.wctx_encode(
        _on(dev, sym_idx, np.uint8),
        _on(dev, ctxm, np.int16),
        to_device(dev, seg.astype(np.int32)),
        to_device(dev, device_table(freq_p)),
    )
    flat, total = cuda_kernels.rans_compact(words, flags)
    return flat, total, states, status


def fetch_encoded(handles) -> tuple[np.ndarray, np.ndarray]:
    """Wait for :func:`launch_encode`'s work and copy back ``(words u16,
    states u32)``."""
    flat, total, states, status = handles
    if int(status.item()):
        raise WctxError("invalid wctx frequency table")
    total_h = int(total.item())
    words_h = flat[:total_h].cpu().numpy().view(np.uint16)
    return words_h, states.cpu().numpy().view(np.uint32)


def assemble_payload(
    model: int,
    order: int,
    lanes: int,
    n: int,
    present: np.ndarray,
    freq_p: np.ndarray,
    states: np.ndarray,
    words: np.ndarray,
) -> bytes:
    blob = _compress_table(freq_p)
    out = bytearray()
    out += struct.pack(HEADER_FMT, model, order, lanes.bit_length() - 1, n)
    out += struct.pack("<H", len(present))
    out += present.astype(np.uint8).tobytes()
    out += struct.pack("<I", len(blob))
    out += blob
    out += struct.pack("<I", len(words))
    out += states.astype("<u4").tobytes()
    out += words.astype("<u2").tobytes()
    return bytes(out)


def _check_lanes(lanes: int) -> None:
    if lanes <= 0 or lanes & (lanes - 1):
        raise ValueError(f"lanes must be a power of two, got {lanes}")


def data_histogram(
    flat_syms: np.ndarray, lengths: np.ndarray, model: int, order: int
) -> np.ndarray:
    """(C, 256) int64 histogram of a flat stream's symbols under its
    in-record contexts: what :func:`matrix_histogram` counts over the data
    cells of its lane matrices, for any lane count."""
    from . import qualctx, seqctx

    C, _, _ = model_geometry(model, order)
    syms = np.asarray(flat_syms, np.uint8)
    if model == MODEL_SEQ:
        ctx = seqctx.contexts(syms, lengths, order)
    else:
        ctx = qualctx.contexts(syms, lengths, model=order)
    flat = ctx.astype(np.int64) * 256 + syms.astype(np.int64)
    return np.bincount(flat, minlength=C * 256).reshape(C, 256)


def prepare_encode(
    dev: torch.device, syms, lengths: np.ndarray, hist: np.ndarray,
    model: int, order: int, lanes: int,
) -> dict:
    """One stream's encode inputs on ``dev``: the lane layout, the tables
    from ``hist`` (its (C, 256) data histogram: pad cells are skipped by
    the coders, so the tables are the prepare histograms') and the (S, N)
    symbol-index and context matrices, built there by ``fq_wctx_layout``
    from the flat symbols (:class:`.ctxprep.Symbols` already on the device,
    or a host array). The pad symbol is the most frequent one."""
    from . import cuda_kernels

    lengths = np.asarray(lengths, np.int64)
    tab, S, seg = ctxprep.lane_layout(lengths, lanes)
    hist = hist.astype(np.int64)
    counts = hist.sum(axis=0)
    present = np.flatnonzero(counts > 0)
    freq_p = np.ascontiguousarray(normalize_tables(hist)[:, present])
    if isinstance(syms, ctxprep.Symbols):
        sym_t = syms.on(dev)
    else:
        sym_t = to_device(dev, np.asarray(syms, np.uint8))
    sym_idx, ctxm = cuda_kernels.wctx_layout(
        sym_t, to_device(dev, ctxprep.record_bounds(lengths)), to_device(dev, tab), S,
        model, order, to_device(dev, _sym_to_idx(present)), int(np.argmax(counts)))
    return {
        "sb": tab[0], "S": S, "n": len(syms), "npres": len(present), "seg": seg,
        "present": present, "freq_p": freq_p, "sym_idx": sym_idx, "ctxm": ctxm,
    }


def encode_stream(
    flat_syms: np.ndarray,
    lengths: np.ndarray,
    model: int,
    order: int,
    lanes: int | None = None,
    device=None,
) -> bytes:
    """Encode one unpacked symbol stream on ``device`` (default: the CUDA
    card); returns the standalone TAG_WCTX wire payload."""
    dev = resolve_device(device)
    lengths = np.asarray(lengths, np.int64)
    n = len(flat_syms)
    if n == 0 or int(lengths.sum()) != n:
        raise WctxError("wctx stream length does not match records")
    N = lanes or pick_lanes(n)
    _check_lanes(N)
    hist = data_histogram(flat_syms, lengths, model, order)
    if model == MODEL_QUAL and int((hist.sum(axis=0) > 0).sum()) > B_MAX:
        raise WctxError(
            f"wctx present alphabet {int((hist.sum(axis=0) > 0).sum())} exceeds {B_MAX}"
        )
    p = prepare_encode(dev, flat_syms, lengths, hist, model, order, N)
    words, states = fetch_encoded(
        launch_encode(dev, p["sym_idx"], p["ctxm"], p["seg"], p["freq_p"])
    )
    return assemble_payload(
        model, order, N, n, p["present"], p["freq_p"], states, words
    )


def parse_stream(payload: bytes | memoryview):
    """Wire parse -> dict of fields (shared by all decode entries)."""
    from ..entropy import zstd as zstd_entropy

    buf = memoryview(payload)
    hdr = struct.calcsize(HEADER_FMT)
    if len(buf) < hdr + 2:
        raise WctxError("truncated wctx stream")
    model, order, lanes_log2, total = struct.unpack_from(
        HEADER_FMT, buf, 0
    )
    C, _, _ = model_geometry(model, order)  # validates model/order
    off = hdr
    (npres,) = struct.unpack_from("<H", buf, off)
    off += 2
    if npres == 0 or npres > 256 or len(buf) < off + npres + 4:
        raise WctxError("truncated wctx stream")
    present = np.frombuffer(buf[off : off + npres], np.uint8).astype(
        np.int64
    )
    if npres > 1 and not (np.diff(present) > 0).all():
        raise WctxError("invalid wctx present list")
    off += npres
    (blob_len,) = struct.unpack_from("<I", buf, off)
    off += 4
    if len(buf) < off + blob_len + 4:
        raise WctxError("truncated wctx stream")
    blob = bytes(buf[off : off + blob_len])
    off += blob_len
    (nwords,) = struct.unpack_from("<I", buf, off)
    off += 4
    N = 1 << lanes_log2
    if len(buf) < off + 4 * N + 2 * nwords:
        raise WctxError("truncated wctx stream")
    states = np.frombuffer(buf[off : off + 4 * N], "<u4").astype(
        np.uint32
    )
    off += 4 * N
    words = np.frombuffer(buf[off : off + 2 * nwords], "<u2")

    try:
        table_raw = zstd_entropy.get_codec().decompress(blob)
    except zstd_entropy.ZstdError as e:
        raise WctxError(f"corrupt wctx table blob: {e}") from None
    if len(table_raw) != C * npres * 2:
        raise WctxError("wctx table blob size mismatch")
    freq_p = (
        np.frombuffer(table_raw, "<u2").astype(np.uint16)
        .reshape(C, npres)
    )
    sums = freq_p.astype(np.int64).sum(axis=1)
    if not np.all((sums == 0) | (sums == PROB_SCALE)):
        raise WctxError("invalid wctx frequency table")
    return {
        "model": model,
        "order": order,
        "N": N,
        "total": total,
        "present": present,
        "freq_p": freq_p,
        "states": states,
        "words": words,
    }


def launch_decode(
    dev: torch.device, p: dict, lengths: np.ndarray, output: int = UNLAYOUT_FLAT
):
    """Enqueue the decode of one parsed stream (:func:`parse_stream`) on
    ``dev``'s current stream: the start matrix (``fq_wctx_layout``), the
    decode, and the decoded matrix back in record order
    (``fq_wctx_unlayout``) as ``output`` says: the symbols
    (:data:`UNLAYOUT_FLAT`), packed sequence rows (:data:`UNLAYOUT_PACKED`)
    or the quality delta stream (:data:`UNLAYOUT_DELTA`). Returns what
    :func:`fetch_decoded` reads."""
    from . import cuda_kernels

    N = p["N"]
    if dev.type == "cuda" and N > MAX_DECODE_LANES:
        raise WctxError("unsupported wctx lane count")
    lengths = np.asarray(lengths, np.int64)
    tab, S, seg = ctxprep.lane_layout(lengths, N)
    packed = output == UNLAYOUT_PACKED
    bounds_h = ctxprep.record_bounds(lengths, packed=packed)
    bounds = to_device(dev, bounds_h)
    tab_d = to_device(dev, tab)
    present = to_device(dev, p["present"].astype(np.uint8))
    startm = cuda_kernels.wctx_layout(
        None, bounds[0] if packed else bounds, tab_d, S, p["model"], p["order"])
    out, info = cuda_kernels.wctx_decode(
        to_device(dev, np.asarray(p["words"]).astype("<u2").view(np.int16)),
        to_device(dev, p["states"].view(np.int32)),
        startm,
        to_device(dev, seg),
        to_device(dev, device_table(p["freq_p"])),
        present,
        p["model"],
        p["order"],
    )
    size = int(bounds_h[1, -1] if packed else bounds_h[-1])
    wire, fault = cuda_kernels.wctx_unlayout(out, bounds, tab_d, present, output, size)
    return wire, info, fault, p


def fetch_decoded(handles) -> np.ndarray:
    """Wait for :func:`launch_decode`'s work, check it and return its
    output bytes (np.uint8)."""
    wire, info, fault, p = handles
    consumed, bad = (int(v) for v in info.cpu())
    # a sound stream uses up exactly the words it carries
    if consumed != len(p["words"]):
        raise WctxError("trailing wctx words")
    if bad or int(fault.item()):
        raise WctxError("corrupted wctx stream")
    return wire.cpu().numpy()


def wire_output(p: dict) -> int:
    """The v3 wire form of a parsed stream's symbols: packed rows for the
    sequence model, the delta stream for qualities."""
    return UNLAYOUT_PACKED if p["model"] == MODEL_SEQ else UNLAYOUT_DELTA


def decode_stream(
    payload: bytes, lengths: np.ndarray, device=None
) -> np.ndarray:
    """Decode a TAG_WCTX payload on ``device`` (default: the CUDA card) ->
    flat unpacked symbols (np.uint8)."""
    dev = resolve_device(device)
    lengths = np.asarray(lengths, np.int64)
    p = parse_stream(payload)
    if int(lengths.sum()) != p["total"]:
        raise WctxError("wctx total does not match record lengths")
    if p["total"] == 0:
        return np.zeros(0, np.uint8)
    return fetch_decoded(launch_decode(dev, p, lengths))


def decode_wire(payload: bytes, lengths: np.ndarray, device=None) -> bytes:
    """Decode a TAG_WCTX payload on ``device`` (default: the CUDA card) to
    the v3 wire stream of its slot: packed sequence rows or the quality
    delta stream, built on the device; only those bytes come back."""
    dev = resolve_device(device)
    lengths = np.asarray(lengths, np.int64)
    p = parse_stream(payload)
    if int(lengths.sum()) != p["total"]:
        raise WctxError("wctx total does not match record lengths")
    if p["total"] == 0:
        return b""
    return fetch_decoded(launch_decode(dev, p, lengths, wire_output(p))).tobytes()
