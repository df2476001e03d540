"""The context-model passes as tensor functions: the qctx and sctx prepare
passes and the wctx lane matrices, both ways.

The port's counterpart of ``fq_qctx_prepare`` and ``fq_sctx_prepare`` of
``fastqpacker_tpu/runtime/fqruntime.cpp`` (the JAX package's C++ runtime)
and of the host passes of :mod:`.wctx` around its device programs
(``start_matrix``, ``to_matrix``, ``context_matrix``, the present-symbol map,
``from_matrix``) with :func:`.seqctx.pack_stream` and the quality delta
transform after them. On the card each is one kernel of
``csrc/ctxprep.cu``; the symbols stay there between the passes.

Each ``*_plain`` function is the plain PyTorch version of one kernel: what
the wrappers of :mod:`.cuda_kernels` run on CPU tensors and what the kernels
are held against on the card. Every output equals the numpy functions'
byte for byte, pad cells of the lane matrices included.

Record geometry passes as int64 boundary vectors, made on the host from the
lengths (:func:`record_bounds`, :func:`lane_layout`): ``bounds[r]`` is the
first symbol of record ``r`` (``bounds[nrec]`` the total) and, for the
packed sequence stream, a second row holds each record's first packed byte.
"""

from __future__ import annotations

import numpy as np
import torch

from .ctxcoder import chunk_bounds_arrays
from .device import to_device

# qctx context geometry (ops/qualctx.py)
NUM_QBINS = 48
NUM_PBUCKETS = 8
NUM_Q2B = 8
QCTX_CONTEXTS = NUM_PBUCKETS * NUM_QBINS * NUM_Q2B  # 3072, the max model
# sctx: the max order's contexts (ops/seqctx.py MAX_ORDER = 6)
SCTX_ORDER = 6
SCTX_CONTEXTS = 4**SCTX_ORDER

# the kernels' tiles (csrc/ctxprep.cu kQTile, kSTile, kLSteps, kLLanes, kUSteps, kULanes)
QCTX_TILE = 8192  # delta bytes per tile of fq_qctx_prepare
QCTX_TABLE_SLOTS = 8192  # (key, count) slots of its CTAs' histogram tables
SCTX_TILE = 16384  # bases per tile of fq_sctx_prepare (16 a thread)
LAYOUT_TILE_STEPS = 256  # steps x lanes per tile of fq_wctx_layout
LAYOUT_TILE_LANES = 64
LAYOUT_POSITION_CAP = 112  # in-record positions past it give the same contexts (kLPosCap)
UNLAYOUT_TILE_STEPS = 256  # steps x lanes per tile of fq_wctx_unlayout
UNLAYOUT_TILE_LANES = 64
QCTX_MAX_SYMBOLS = (1 << 31) - 1  # symbols of a stream: no int32 count can overflow

# fq_wctx_unlayout's outputs
UNLAYOUT_FLAT = 0  # the symbols in record order
UNLAYOUT_PACKED = 1  # packed sequence rows, 4 bases a byte, zero pad bits
UNLAYOUT_DELTA = 2  # the per-record quality delta stream

_I64 = torch.int64


# ---------------------------------------------------------------------------
# host geometry
# ---------------------------------------------------------------------------


def record_bounds(lengths: np.ndarray, packed: bool = False) -> np.ndarray:
    """(nrec + 1,) int64 symbol starts of the records and their total; with
    ``packed``, (2, nrec + 1) with each record's first packed byte (4 bases
    a byte, each record from a fresh byte) as the second row."""
    lengths = np.asarray(lengths, np.int64)
    out = np.zeros((2 if packed else 1, len(lengths) + 1), np.int64)
    np.cumsum(lengths, out=out[0, 1:])
    if packed:
        np.cumsum((lengths + 3) >> 2, out=out[1, 1:])
        return out
    return out[0]


def lane_layout(lengths: np.ndarray, lanes: int) -> tuple[np.ndarray, int, np.ndarray]:
    """-> ``(lanes_tab, S, seg)``: a (2, lanes + 1) int64 table of each
    lane's first symbol (row 0, ``wctx.lane_bounds``'s ``sb``) and first
    record (row 1), the step count S (the longest lane) and the (lanes,)
    int32 symbols per lane."""
    rb, sb = chunk_bounds_arrays(np.asarray(lengths, np.int64), lanes)
    seg = np.diff(sb)
    return np.stack([sb, rb]), int(seg.max()) if len(seg) else 0, seg.astype(np.int32)


# ---------------------------------------------------------------------------
# plain versions of the four kernels
# ---------------------------------------------------------------------------


def _records_of(j: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """The record of each symbol index: the last ``r`` with ``starts[r] <=
    j`` (zero-length records share their start with the next one)."""
    return torch.searchsorted(starts, j, right=True) - 1


def qctx_keys(delta: torch.Tensor, bounds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (raw int64, histogram key ``ctx * 256 + raw`` int64) per symbol of
    :func:`qctx_prepare_plain` (n >= 1)."""
    dev = delta.device
    n = delta.numel()
    j = torch.arange(n, dtype=_I64, device=dev)
    start = bounds[_records_of(j, bounds)]
    p = j - start
    csum = torch.cumsum(delta.to(_I64), 0)
    before = torch.cat([torch.zeros(1, dtype=_I64, device=dev), csum])[start]
    raw = (csum - before) & 255
    prev = torch.where(p >= 1, raw[(j - 1).clamp(min=0)], 0)
    prev2 = torch.where(p >= 2, raw[(j - 2).clamp(min=0)], 0)
    qbin = torch.where(p == 0, NUM_QBINS - 1, prev.clamp(max=46))
    ctx = (p >> 4).clamp(max=NUM_PBUCKETS - 1) * NUM_QBINS + qbin
    q2b = torch.where(p >= 2, prev2.clamp(max=46) >> 3, NUM_Q2B - 1)
    return raw, (ctx * NUM_Q2B + q2b) * 256 + raw


def qctx_prepare_plain(
    delta: torch.Tensor, bounds: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-record integration of the (n,) uint8 quality delta stream mod 256
    -> raw (n,) uint8, and the (3072, 256) int32 histogram of raw values
    under the max-model context ``qctx_ctx_m(1, p, prev, prev2)``
    (``fqruntime.cpp:1575-1590``): position bucket min(p >> 4, 7), previous
    value bin (47 at p = 0), bucket of the one before (7 at p < 2)."""
    if delta.numel() == 0:
        hist = torch.zeros((QCTX_CONTEXTS, 256), dtype=torch.int32, device=delta.device)
        return delta.clone(), hist
    raw, keys = qctx_keys(delta, bounds)
    hist = torch.bincount(keys, minlength=QCTX_CONTEXTS * 256)
    return raw.to(torch.uint8), hist.to(torch.int32).view(QCTX_CONTEXTS, 256)


def _unpack_plain(packed: torch.Tensor, bounds: torch.Tensor, n: int) -> tuple:
    """-> (bases int64 (n,), in-record positions, records) of packed rows."""
    j = torch.arange(n, dtype=_I64, device=packed.device)
    rec = _records_of(j, bounds[0])
    p = j - bounds[0][rec]
    byte = packed[bounds[1][rec] + (p >> 2)].to(_I64)
    return (byte >> ((p & 3) * 2)) & 3, p, rec


def sctx_keys(packed: torch.Tensor, bounds: torch.Tensor, n: int) -> tuple:
    """-> (bases int64, histogram key ``ctx * 4 + base`` int64) per base of
    :func:`sctx_prepare_plain` (n >= 1 bases)."""
    dev = packed.device
    bases, p, _ = _unpack_plain(packed, bounds, n)
    ctx = torch.zeros(n, dtype=_I64, device=dev)
    for i in range(1, SCTX_ORDER + 1):
        prev = torch.zeros(n, dtype=_I64, device=dev)
        prev[i:] = bases[:-i]
        ctx |= torch.where(p >= i, prev, 0) << (2 * (i - 1))
    return bases, ctx * 4 + bases


def sctx_prepare_plain(
    packed: torch.Tensor, bounds: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed 2-bit rows -> one base per byte (n,) uint8, and the (4096, 4)
    int32 histogram with the record's previous six bases as context (most
    recent in the low bits, missing ones 0). ``bounds``: (2, nrec + 1),
    :func:`record_bounds` with ``packed``."""
    dev = packed.device
    n = int(bounds[0, -1])
    if n == 0:
        hist = torch.zeros((SCTX_CONTEXTS, 4), dtype=torch.int32, device=dev)
        return torch.zeros(0, dtype=torch.uint8, device=dev), hist
    bases, keys = sctx_keys(packed, bounds, n)
    hist = torch.bincount(keys, minlength=SCTX_CONTEXTS * 4)
    return bases.to(torch.uint8), hist.to(torch.int32).view(SCTX_CONTEXTS, 4)


def _grid(lanes: torch.Tensor, steps: int):
    """Per cell (t, l) of the (S, N) lane matrix: its flat symbol index and
    whether it holds data (t < seg[l])."""
    dev = lanes.device
    sb = lanes[0]
    t = torch.arange(steps, dtype=_I64, device=dev)[:, None]
    j = sb[None, :-1] + t
    return j, t < (sb[1:] - sb[:-1])[None, :]


def wctx_layout_plain(
    syms: torch.Tensor | None,
    bounds: torch.Tensor,
    lanes: torch.Tensor,
    steps: int,
    model: int,
    order: int,
    idx_map: torch.Tensor | None,
    pad_sym: int,
):
    """The (S, N) lane matrices of one stream, cell (t, l) holding flat
    symbol ``sb[l] + t`` while ``t < seg[l]`` and padding after it.

    Encode (``syms`` the (n,) uint8 symbols): ``(sym_idx uint8, ctx
    int16)``, each cell's present-symbol index (``idx_map[sym]``, pad cells
    ``idx_map[pad_sym]``) and context (:func:`.wctx.context_matrix`: the
    record's previous ``order`` bases for model 0; position bucket and
    previous quality bins for model 1; a pad cell is a record start, context
    0, or 47 / 383 for qualities at order 0 / 1). Decode (``syms`` None):
    the uint8 start matrix (:func:`.wctx.start_matrix`: 1 where a record
    begins, on every pad cell and on row 0)."""
    j, data = _grid(lanes, steps)
    jc = torch.where(data, j, 0)
    p = jc - bounds[_records_of(jc, bounds)]
    p = torch.where(data, p, 0)
    p[0] = 0  # row 0 is a start
    if syms is None:
        return (p == 0).to(torch.uint8)
    s = syms.to(_I64)

    def back(i):  # the symbol i positions back in the record, 0 if none
        return torch.where(p >= i, s[(jc - i).clamp(min=0)], 0)

    if model == 0:
        ctx = torch.zeros_like(p)
        for i in range(1, order + 1):
            ctx |= back(i) << (2 * (i - 1))
    else:
        qbin = torch.where(p == 0, NUM_QBINS - 1, back(1).clamp(max=46))
        ctx = (p >> 4).clamp(max=NUM_PBUCKETS - 1) * NUM_QBINS + qbin
        if order == 1:
            q2b = torch.where(p >= 2, back(2).clamp(max=46) >> 3, NUM_Q2B - 1)
            ctx = ctx * NUM_Q2B + q2b
    sym = torch.where(data, s[jc], pad_sym)
    return idx_map.to(_I64)[sym].to(torch.uint8), ctx.to(torch.int16)


def wctx_unlayout_plain(
    out: torch.Tensor,
    bounds: torch.Tensor,
    lanes: torch.Tensor,
    present: torch.Tensor,
    mode: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The decoded (S, N) present-index matrix back in record order:
    ``present[idx]`` per data cell (:func:`.wctx.from_matrix` and the
    present map), then, by ``mode``, the symbols as they are
    (:data:`UNLAYOUT_FLAT`), packed sequence rows (:data:`UNLAYOUT_PACKED`,
    :func:`.seqctx.pack_stream`: ``bounds`` (2, nrec + 1)) or the quality
    delta stream (:data:`UNLAYOUT_DELTA`, the inverse of the qctx
    integration). -> (uint8 bytes, int32 (1,) fault: 1 where a data cell's
    index is >= npres; such a cell reads as ``present[npres - 1]``)."""
    dev = out.device
    starts = bounds[0] if bounds.dim() == 2 else bounds
    n = int(starts[-1])
    npres = present.numel()
    sb = lanes[0]
    j = torch.arange(n, dtype=_I64, device=dev)
    lane = torch.searchsorted(sb, j, right=True) - 1
    idx = out[j - sb[lane], lane].to(_I64)
    fault = (idx >= npres).any().to(torch.int32).reshape(1)
    sym = present.to(_I64)[idx.clamp(max=npres - 1)]
    if mode == UNLAYOUT_FLAT:
        return sym.to(torch.uint8), fault
    if mode == UNLAYOUT_DELTA:
        p = j - starts[_records_of(j, starts)]
        prev = torch.cat([torch.zeros(1, dtype=_I64, device=dev), sym[:-1]])
        return torch.where(p == 0, sym, sym - prev).to(torch.uint8), fault
    # packed rows: byte b of record r holds its bases 4k .. 4k + 3
    pstarts = bounds[1]
    m = int(pstarts[-1])
    b = torch.arange(m, dtype=_I64, device=dev)
    rec = _records_of(b, pstarts)
    first = starts[rec] + 4 * (b - pstarts[rec])
    acc = torch.zeros(m, dtype=_I64, device=dev)
    for k in range(4):
        live = first + k < starts[rec + 1]
        v = sym[(first + k).clamp(max=n - 1)]
        acc |= torch.where(live, (v << (2 * k)) & 255, 0)
    return acc.to(torch.uint8), fault


# ---------------------------------------------------------------------------
# prepared symbols on a device
# ---------------------------------------------------------------------------


class Symbols:
    """A prepare pass's symbols on their device, the records' starts there
    (``bounds``: (nrec + 1,) int64, the pass's own upload, or None), and the
    symbols' host copy, made on first use (:meth:`numpy`): only the host
    coders read it (the sequence coverage candidate, ``sldm``). ``ready`` is
    the event after the pass on a card (None on the CPU)."""

    def __init__(self, tensor: torch.Tensor, bounds: torch.Tensor | None = None):
        self.tensor = tensor
        self.bounds = bounds
        self.ready = None
        if tensor.device.type == "cuda":
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(tensor.device))
        self._host = None

    def __len__(self) -> int:
        return self.tensor.numel()

    def _onto(self, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        if self.ready is not None:
            stream = torch.cuda.current_stream(t.device)
            stream.wait_event(self.ready)
            t.record_stream(stream)
        return t if t.device == dev else t.to(dev)

    def on(self, dev: torch.device) -> torch.Tensor:
        """The symbols on ``dev``, for work on its current stream. The
        stream that reads them (a copy to another card runs on the current
        stream of the symbols' own) waits for the pass, and the tensor is
        recorded on it."""
        return self._onto(self.tensor, dev)

    def starts_on(self, dev: torch.device, lengths: np.ndarray) -> torch.Tensor:
        """The records' starts on ``dev`` as :meth:`on` gives the symbols:
        the pass's own, else uploaded from ``lengths``."""
        if self.bounds is None:
            return to_device(dev, record_bounds(lengths))
        return self._onto(self.bounds, dev)

    def numpy(self) -> np.ndarray:
        if self._host is None:
            if self.ready is not None:
                self.ready.synchronize()
            self._host = self.tensor.cpu().numpy()
        return self._host


def qctx_prepare(dev: torch.device, delta: np.ndarray, lengths: np.ndarray):
    """The qctx prepare of a host delta stream on ``dev`` (kernel 1):
    -> (:class:`Symbols` raw, (3072, 256) int64 host histogram)."""
    from . import cuda_kernels

    bounds = to_device(dev, record_bounds(lengths))
    raw, hist = cuda_kernels.qctx_prepare(to_device(dev, np.asarray(delta, np.uint8)), bounds)
    return Symbols(raw, bounds), hist.cpu().numpy().astype(np.int64)


def sctx_prepare(dev: torch.device, packed: np.ndarray, lengths: np.ndarray):
    """The sctx prepare of a host packed stream on ``dev`` (kernel 2):
    -> (:class:`Symbols` bases, (4096, 4) int64 host histogram)."""
    from . import cuda_kernels

    bounds = record_bounds(lengths, packed=True)
    on_dev = to_device(dev, bounds)
    bases, hist = cuda_kernels.sctx_prepare(
        to_device(dev, np.asarray(packed, np.uint8)), on_dev, int(bounds[0, -1]))
    return Symbols(bases, on_dev[0]), hist.cpu().numpy().astype(np.int64)
