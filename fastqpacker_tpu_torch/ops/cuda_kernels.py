"""Wrappers of the port's Hopper kernels (``csrc/*.cu``).

Dense codec (``csrc/dense_codec.cu``): ``encode_arrays`` replaces
``fastqpacker_tpu/ops/pallas_kernels.py``'s ``encode_arrays_pallas`` and
``decode_arrays`` its ``decode_arrays_pallas`` (and the XLA twins in
``fastqpacker_tpu/ops/device.py``). Order-0 rANS (``csrc/rans_codec.cu``):
``rans_encode``, ``rans_compact`` and ``rans_decode`` replace the XLA
programs ``_encode_kernel``, ``_compact_global`` and ``_decode_kernel`` of
``fastqpacker_tpu/ops/rans.py``. CRC32 (``csrc/crc32.cu``):
``crc32_chunks`` replaces ``_crc_lanes_kernel`` of
``fastqpacker_tpu/ops/crc32.py`` and the host combine around it. Context
rANS (``csrc/wctx_codec.cu``): ``wctx_encode`` and ``wctx_decode`` replace
the XLA programs ``_encode_kernel`` and ``_decode_kernel`` of
``fastqpacker_tpu/ops/wctx.py``. Block stages (``csrc/records.cu``):
``records_scan``, ``rows_gather``, ``streams_build`` and ``fastq_assemble``
replace the host functions ``fq_scan_records_ex``, ``fq_gather_rows``,
``fq_build_streams`` and ``fq_decode_block_full`` / ``fq_assemble`` of
``fastqpacker_tpu/runtime/fqruntime.cpp`` (the JAX package's C++ runtime).
Context-model passes (``csrc/ctxprep.cu``): ``qctx_prepare`` and
``sctx_prepare`` replace ``fq_qctx_prepare`` and ``fq_sctx_prepare`` of that
runtime; ``wctx_layout`` replaces the host passes ``start_matrix``,
``to_matrix`` and ``context_matrix`` (with the present-symbol map) of
``fastqpacker_tpu/ops/wctx.py``, and ``wctx_unlayout`` its ``from_matrix``
and present map, then ``pack_stream`` of ``fastqpacker_tpu/ops/seqctx.py`` or
the quality delta transform (``_raw_to_delta``) of
``fastqpacker_tpu/pipeline/native.py``. Byte histogram
(``csrc/hist256.cu``): ``hist256`` replaces the runtime's ``fq_hist256``.
Header tokenizer (``csrc/tokens.cu``): ``tok_encode`` and ``tok_decode``
replace its ``fq_tok_encode`` and ``fq_tok_decode``. Context coders
(``csrc/ctxcoder.cu``): ``qctx_encode``, ``qctx_decode``, ``sctx_encode`` and
``sctx_decode`` replace its ``fq_qctx_encode``, ``fq_qctx_decode``,
``fq_sctx_encode`` and ``fq_sctx_decode``.

Each wrapper checks its tensors, allocates the outputs on their device and
launches on the current CUDA stream. A CPU tensor goes to the plain PyTorch
version (:mod:`.device`, :mod:`.rans`, :mod:`.crc32`, :mod:`.wctx`,
:mod:`.records`, :mod:`.ctxprep`, :mod:`.tokenize`, :mod:`.qualctx`,
:mod:`.seqctx`); a CUDA
tensor launches the kernel or raises.

``launches`` counts kernel launches per kernel, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from . import build
from . import reference as refops
from .crc32 import crc32_chunks_plain
from .device import DenseEncoded, decode_arrays_plain, encode_arrays_plain
from .rans import MAX_LANES as RANS_MAX_LANES
from .rans import RANS_L, hist256_plain, rans_compact_plain, rans_decode_plain, rans_encode_plain
from . import ctxcoder, ctxprep, qualctx, records, seqctx, tokenize
from .wctx import MAX_DECODE_LANES as WCTX_MAX_DECODE_LANES
from .wctx import wctx_decode_plain, wctx_encode_plain

ENCODE = "fq_dense_encode"
DECODE = "fq_dense_decode"
RANS_ENCODE = "fq_rans_encode"
RANS_COMPACT = "fq_rans_compact"
RANS_DECODE = "fq_rans_decode"
CRC32 = "fq_crc32_chunks"
WCTX_ENCODE = "fq_wctx_encode"
WCTX_DECODE = "fq_wctx_decode"
RECORDS_SCAN = "fq_records_scan"
ROWS_GATHER = "fq_rows_gather"
STREAMS_BUILD = "fq_streams_build"
FASTQ_ASSEMBLE = "fq_fastq_assemble"
QCTX_PREPARE = "fq_qctx_prepare"
SCTX_PREPARE = "fq_sctx_prepare"
WCTX_LAYOUT = "fq_wctx_layout"
WCTX_UNLAYOUT = "fq_wctx_unlayout"
HIST256 = "fq_hist256"
TOK_ENCODE = "fq_tok_encode"
TOK_DECODE = "fq_tok_decode"
TOK_DECODE_WRITE = "fq_tok_decode_write"
QCTX_ENCODE = "fq_qctx_encode"
QCTX_DECODE = "fq_qctx_decode"
SCTX_ENCODE = "fq_sctx_encode"
SCTX_DECODE = "fq_sctx_decode"

# which library (csrc/<name>.cu) exports each launcher
_LIBRARY = {
    fn: lib for lib, fns in build.SIGNATURES.items() for fn in fns
}


class LaunchCounts:
    """Launches per kernel. Pipeline workers launch from many threads, so
    every read-modify-write happens under one lock."""

    def __init__(self, names):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(names, 0)

    def bump(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            for name in self._counts:
                self._counts[name] = 0

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._counts[name]

    def as_dict(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


# one count per kernel: a wrapper's second call of its library is not counted
_UNCOUNTED = frozenset(build.SECOND_CALLS)
launches = LaunchCounts(fn for fn in _LIBRARY if fn not in _UNCOUNTED)
# the qctx decode's route a call: the dense rows in shared memory, or the
# slot table through the L2 (:func:`qctx_decode`)
QCTX_ROUTES = ("shared", "l2")
qctx_routes = LaunchCounts(QCTX_ROUTES)


def reset_launches() -> None:
    launches.reset()
    qctx_routes.reset()


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_offset(qual_offset: int) -> None:
    if not 0 <= qual_offset <= 255:
        raise ValueError(f"qual_offset must be a byte, got {qual_offset}")


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch ``name`` on ``device``'s current stream with ``args``
    (tensors pass as pointers, integers as they are) and count it. The
    launch is a ``record_function`` span named ``name``, so a
    ``torch.profiler`` trace shows which wrapper launched each kernel."""
    for a in args:
        if isinstance(a, torch.Tensor) and a.data_ptr() % 16:
            raise ValueError(f"{name}: tensor storage is not 16-byte aligned")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    lib = build.load(_LIBRARY[name])
    with torch.profiler.record_function(name), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError_t {rc}")
    if name not in _UNCOUNTED:
        launches.bump(name)


def _plain_or_cuda(dev: torch.device) -> bool:
    """True for a CPU tensor (plain version); a CUDA tensor launches the
    kernel; any other device is refused."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {dev}")
    return dev.type == "cpu"


def encode_arrays(
    seq: torch.Tensor,
    qual: torch.Tensor,
    lengths: torch.Tensor,
    qual_offset: int,
    npos_cap: int = refops.MAX_SEQUENCE_LENGTH,
) -> DenseEncoded:
    """Dense block encode of (R, L) uint8 seq/qual and (R,) int32 lengths;
    N positions are tracked below ``min(length, npos_cap)``. Any L; every
    output is contiguous at its exact width, from one launch."""
    r, l = seq.shape
    dev = seq.device
    _check("seq", seq, torch.uint8, (r, l), dev)
    _check("qual", qual, torch.uint8, (r, l), dev)
    _check("lengths", lengths, torch.int32, (r,), dev)
    _check_offset(qual_offset)
    if not 0 < npos_cap <= refops.NPOS_CAP_WIDE:
        raise ValueError(f"npos_cap must be a positive int32, got {npos_cap}")
    if _plain_or_cuda(dev):
        return encode_arrays_plain(seq, qual, lengths, qual_offset, npos_cap)
    packed = torch.empty((r, -(-l // 4)), dtype=torch.uint8, device=dev)
    nmask = torch.empty((r, -(-l // 8)), dtype=torch.uint8, device=dev)
    n_counts = torch.empty((r,), dtype=torch.int32, device=dev)
    delta = torch.empty((r, l), dtype=torch.uint8, device=dev)
    if r:
        _launch(ENCODE, dev, seq, qual, lengths, packed, nmask, n_counts,
                delta, r, l, qual_offset, npos_cap)
    return DenseEncoded(packed, nmask, n_counts, delta)


def decode_arrays(
    packed: torch.Tensor,
    qual_delta: torch.Tensor,
    lengths: torch.Tensor,
    qual_offset: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense block decode: (R, >= ceil(L/4)) packed (its row pitch passes
    to the kernel) and (R, L) deltas -> contiguous (R, L) ASCII bases and
    qualities, from one launch."""
    r, l = qual_delta.shape
    dev = qual_delta.device
    if packed.dim() != 2 or packed.shape[0] != r or packed.shape[1] < -(-l // 4):
        raise ValueError(
            f"packed: expected ({r}, >= {-(-l // 4)}), got {tuple(packed.shape)}"
        )
    _check("packed", packed, torch.uint8, packed.shape, dev)
    _check("qual_delta", qual_delta, torch.uint8, (r, l), dev)
    _check("lengths", lengths, torch.int32, (r,), dev)
    _check_offset(qual_offset)
    if _plain_or_cuda(dev):
        return decode_arrays_plain(packed, qual_delta, lengths, qual_offset)
    seq = torch.empty((r, l), dtype=torch.uint8, device=dev)
    qual = torch.empty((r, l), dtype=torch.uint8, device=dev)
    if r:
        _launch(DECODE, dev, packed, qual_delta, seq, qual, r, l,
                packed.shape[1], qual_offset)
    return seq, qual


class DenseGeometry(NamedTuple):
    """The dense kernels' launch at one row length: ``route`` "tile" (tiles
    of ``rows`` whole rows, one warp each, ``warps`` warps and ``shared``
    dynamic shared bytes a CTA) or "row" (one CTA per row, for rows longer
    than ``max_tile_len``)."""

    route: str
    rows: int
    warps: int
    shared: int
    max_tile_len: int


def dense_geometry(length: int, pitch: int | None = None, encode: bool = True) -> DenseGeometry:
    """The launch ``fq_dense_encode`` (or, with ``encode=False``,
    ``fq_dense_decode`` at packed row pitch ``pitch``, default ceil(L/4))
    makes at row length ``length``, as the kernels' library computes it
    (built on first use, so a card's machine only). Launches nothing."""
    pitch = -(-length // 4) if pitch is None else pitch
    out = (ctypes.c_int * 5)()
    rc = build.load(_LIBRARY[ENCODE]).fq_dense_geometry(
        length, pitch, int(encode), ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"no dense geometry for length {length}, pitch {pitch}: "
                         f"cudaError_t {rc}")
    return DenseGeometry("row" if out[0] else "tile", *out[1:])


# ---------------------------------------------------------------------------
# order-0 rANS
# ---------------------------------------------------------------------------

COMPACT_TILE = 4096  # cells per CTA of the compaction (csrc/rans_codec.cu kTile)


def _check_lanes(lanes: int) -> None:
    if lanes <= 0 or lanes & (lanes - 1):
        raise ValueError(f"lanes must be a power of two, got {lanes}")


def rans_encode(
    data: torch.Tensor,
    steps: int,
    lanes: int,
    pad_sym: int,
    freq_cum: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward lockstep rANS encode of an (n,) uint8 stream laid out as
    (steps, lanes); see :func:`..ops.rans.rans_encode_plain`."""
    n = data.numel()
    dev = data.device
    _check("data", data, torch.uint8, (n,), dev)
    _check("freq_cum", freq_cum, torch.int32, (2, 256), dev)
    _check_lanes(lanes)
    if not 0 < n <= steps * lanes or n <= (steps - 1) * lanes:
        raise ValueError(f"{n} bytes do not fill {steps} rows of {lanes} lanes")
    if not 0 <= pad_sym <= 255:
        raise ValueError(f"pad_sym must be a byte, got {pad_sym}")
    if _plain_or_cuda(dev):
        return rans_encode_plain(data, steps, lanes, pad_sym, freq_cum)
    m = steps * lanes
    words = torch.empty((m,), dtype=torch.int16, device=dev)
    flags = torch.empty((m,), dtype=torch.uint8, device=dev)
    states = torch.empty((lanes,), dtype=torch.int32, device=dev)
    _launch(RANS_ENCODE, dev, data, n, steps, lanes, pad_sym, freq_cum,
            words, flags, states)
    return words, flags, states


def rans_compact(
    words: torch.Tensor, flags: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flagged words in flat order (a cell is kept where its flag byte is
    not 0); see :func:`..ops.rans.rans_compact_plain`."""
    m = words.numel()
    dev = words.device
    _check("words", words, torch.int16, (m,), dev)
    _check("flags", flags, torch.uint8, (m,), dev)
    if m == 0:
        raise ValueError("nothing to compact")
    if _plain_or_cuda(dev):
        return rans_compact_plain(words, flags)
    tiles = -(-m // COMPACT_TILE)
    tile_counts = torch.empty((tiles,), dtype=torch.int32, device=dev)
    tile_offsets = torch.empty((tiles,), dtype=torch.int64, device=dev)
    out = torch.empty((m,), dtype=torch.int16, device=dev)
    total = torch.empty((1,), dtype=torch.int64, device=dev)
    _launch(RANS_COMPACT, dev, words, flags, m, tile_counts, tile_offsets,
            out, total)
    return out, total


def rans_decode(
    words: torch.Tensor,
    states: torch.Tensor,
    slot_tab: torch.Tensor,
    steps: int,
    lanes: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward lockstep rANS decode; see
    :func:`..ops.rans.rans_decode_plain`. The kernel picks its cluster
    geometry (:func:`rans_decode_geometry`)."""
    dev = states.device
    _check("words", words, torch.int16, (words.numel(),), dev)
    _check("states", states, torch.int32, (lanes,), dev)
    _check("slot_tab", slot_tab, torch.int32, (4096,), dev)
    _check_lanes(lanes)
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")
    if _plain_or_cuda(dev):
        return rans_decode_plain(words, states, slot_tab, steps, lanes)
    if lanes > RANS_MAX_LANES:
        raise ValueError(
            f"the decode kernel holds at most {RANS_MAX_LANES} lanes, got {lanes}")
    out = torch.empty((steps * lanes,), dtype=torch.uint8, device=dev)
    consumed = torch.empty((1,), dtype=torch.int64, device=dev)
    _launch(RANS_DECODE, dev, words, words.numel(), states, slot_tab, steps,
            lanes, out, consumed)
    return out, consumed


class RansDecodeGeometry(NamedTuple):
    """The order-0 decode kernel's launch: ``threads`` per CTA, a cluster of
    ``cluster`` CTAs (one per SM), ``lanes_per_thread`` lanes each, and the
    dynamic shared bytes of one CTA (slot table and word ring)."""

    threads: int
    cluster: int
    lanes_per_thread: int
    shared: int


def rans_decode_geometry(lanes: int) -> RansDecodeGeometry:
    """The geometry ``fq_rans_decode`` launches for ``lanes`` lanes, as the
    kernel's library computes it (built on first use, so a card's machine
    only). Launches nothing."""
    out = (ctypes.c_int * 4)()
    rc = build.load(_LIBRARY[RANS_DECODE]).fq_rans_decode_geometry(
        lanes, ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"no decode geometry for {lanes} lanes: cudaError_t {rc}")
    return RansDecodeGeometry(*out)


# ---------------------------------------------------------------------------
# context-modeled rANS
# ---------------------------------------------------------------------------


def _check_table(tab: torch.Tensor, dev) -> tuple[int, int]:
    if tab.dim() != 2 or not 2 <= tab.shape[1] <= 257 or tab.shape[0] < 1:
        raise ValueError(f"tab: expected (C, npres + 1), got {tuple(tab.shape)}")
    _check("tab", tab, torch.int16, tab.shape, dev)
    return tab.shape[0], tab.shape[1]


# The kernels take at least one warp of lanes; a narrower stream is padded
# with empty lanes at the end, which take no word and do not move the rank.
_WCTX_MIN_LANES = 32


def _pad_lanes(x: torch.Tensor, fill: int) -> torch.Tensor:
    """``x`` (last dimension = lanes < 32) widened to 32 lanes with ``fill``."""
    out = torch.full((*x.shape[:-1], _WCTX_MIN_LANES), fill, dtype=x.dtype,
                     device=x.device)
    out[..., : x.shape[-1]] = x
    return out


def wctx_encode(
    sym: torch.Tensor,
    ctx: torch.Tensor,
    seg: torch.Tensor,
    tab: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward lockstep context-rANS encode of an (S, N) symbol matrix;
    see :func:`..ops.wctx.wctx_encode_plain`."""
    if sym.dim() != 2 or sym.shape[0] < 1:
        raise ValueError(f"sym: expected (S, N) with S >= 1, got {tuple(sym.shape)}")
    steps, lanes = sym.shape
    dev = sym.device
    _check("sym", sym, torch.uint8, (steps, lanes), dev)
    _check("ctx", ctx, torch.int16, (steps, lanes), dev)
    _check("seg", seg, torch.int32, (lanes,), dev)
    contexts, width = _check_table(tab, dev)
    _check_lanes(lanes)
    if _plain_or_cuda(dev):
        return wctx_encode_plain(sym, ctx, seg, tab)
    if lanes < _WCTX_MIN_LANES:
        words, flags, states, status = wctx_encode(
            _pad_lanes(sym, 0), _pad_lanes(ctx, 0), _pad_lanes(seg, 0), tab)
        cut = lambda a: a.view(steps, -1)[:, :lanes].reshape(-1)  # noqa: E731
        return cut(words), cut(flags), states[:lanes].clone(), status
    m = steps * lanes
    words = torch.empty((m,), dtype=torch.int16, device=dev)
    flags = torch.empty((m,), dtype=torch.uint8, device=dev)
    states = torch.empty((lanes,), dtype=torch.int32, device=dev)
    status = torch.zeros((1,), dtype=torch.int32, device=dev)
    _launch(WCTX_ENCODE, dev, sym, ctx, seg, tab, contexts, width, steps, lanes,
            words, flags, states, status)
    return words, flags, states, status


class WctxDecodeGeometry(NamedTuple):
    """The decode kernel's launch: ``threads`` per CTA, one lane each, a
    cluster of ``cluster`` CTAs (one per SM), whether the table sits in each
    CTA's shared memory (else it is read through the read-only cache), and
    the dynamic shared bytes of one CTA (word ring, start-mask rows, table)."""

    threads: int
    cluster: int
    table_shared: bool
    shared: int


def wctx_decode_geometry(lanes: int, contexts: int, width: int) -> WctxDecodeGeometry:
    """The geometry ``fq_wctx_decode`` launches for ``lanes`` lanes and a
    (contexts, width) table, as the kernel's library computes it (built on
    first use, so a card's machine only). Launches nothing."""
    out = (ctypes.c_int * 4)()
    rc = build.load(_LIBRARY[WCTX_DECODE]).fq_wctx_decode_geometry(
        lanes, contexts, width, ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"no decode geometry for {lanes} lanes and a table of "
                         f"{contexts} x {width}: cudaError_t {rc}")
    return WctxDecodeGeometry(out[0], out[1], bool(out[2]), out[3])


def wctx_decode(
    words: torch.Tensor,
    states: torch.Tensor,
    startm: torch.Tensor,
    seg: torch.Tensor,
    tab: torch.Tensor,
    present: torch.Tensor,
    model: int,
    order: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward lockstep context-rANS decode; see
    :func:`..ops.wctx.wctx_decode_plain`. The kernel picks its cluster
    geometry (:func:`wctx_decode_geometry`)."""
    if startm.dim() != 2 or startm.shape[0] < 1:
        raise ValueError(f"startm: expected (S, N) with S >= 1, got {tuple(startm.shape)}")
    steps, lanes = startm.shape
    dev = states.device
    _check("words", words, torch.int16, (words.numel(),), dev)
    _check("states", states, torch.int32, (lanes,), dev)
    _check("startm", startm, torch.uint8, (steps, lanes), dev)
    _check("seg", seg, torch.int32, (lanes,), dev)
    contexts, width = _check_table(tab, dev)
    _check("present", present, torch.uint8, (width - 1,), dev)
    _check_lanes(lanes)
    if (model, order) not in ((0, 2), (0, 4), (0, 6), (1, 0), (1, 1)):
        raise ValueError(f"unsupported wctx model/order {model}/{order}")
    need = 4**order if model == 0 else 384 * (8 if order else 1)
    if contexts != need:
        raise ValueError(f"tab: model {model} order {order} has {need} contexts, got {contexts}")
    if _plain_or_cuda(dev):
        return wctx_decode_plain(words, states, startm, seg, tab, present,
                                 model, order)
    if lanes > WCTX_MAX_DECODE_LANES:
        raise ValueError(
            f"the decode kernel holds at most {WCTX_MAX_DECODE_LANES} lanes, got {lanes}"
        )
    if lanes < _WCTX_MIN_LANES:
        out, info = wctx_decode(
            words, _pad_lanes(states, RANS_L), _pad_lanes(startm, 1),
            _pad_lanes(seg, 0), tab, present, model, order)
        return out[:, :lanes].contiguous(), info
    out = torch.empty((steps, lanes), dtype=torch.uint8, device=dev)
    info = torch.empty((2,), dtype=torch.int64, device=dev)
    _launch(WCTX_DECODE, dev, words, words.numel(), states, startm, seg, tab,
            contexts, width, present, model, order, steps, lanes, out, info)
    return out, info


# ---------------------------------------------------------------------------
# CRC32
# ---------------------------------------------------------------------------


# One ticket counter per (device, CUDA stream): the kernel's last CTA is
# the one that takes the last ticket, and every launch leaves its counter at
# 0, so launches on one stream (which run in order) share it and launches on
# other streams never do.
_crc_tickets: dict[tuple[int, int], torch.Tensor] = {}
_crc_tickets_lock = threading.Lock()


def _crc_ticket(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    with _crc_tickets_lock:
        t = _crc_tickets.get(key)
        if t is None:  # zeroed once, on the stream that will use it
            t = _crc_tickets[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
        return t


def crc32_chunks(data: torch.Tensor) -> torch.Tensor:
    """CRC32 of an (n,) uint8 tensor, n >= 1 -> (1,) int32 holding the u32
    bit pattern; see :func:`..ops.crc32.crc32_chunks_plain`. One launch."""
    n = data.numel()
    dev = data.device
    _check("data", data, torch.uint8, (n,), dev)
    if n == 0:
        raise ValueError("empty input (its CRC32 is 0 by definition)")
    if _plain_or_cuda(dev):
        return crc32_chunks_plain(data)
    span = build.load(_LIBRARY[CRC32]).fq_crc32_span_bytes()
    partials = torch.empty((-(-n // span),), dtype=torch.int32, device=dev)
    out = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        ticket = _crc_ticket(dev, torch.cuda.current_stream(dev).cuda_stream)
    _launch(CRC32, dev, data, n, partials, ticket, out)
    return out


# ---------------------------------------------------------------------------
# block stages: record scan, row gather, stream build, FASTQ assembly
# ---------------------------------------------------------------------------


def _scratch(dev: torch.device, nbytes: int) -> torch.Tensor:
    """A records launcher's scratch, sized by its formula in :mod:`.records`."""
    return torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)


_sm_counts: dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    n = _sm_counts.get(dev.index)
    if n is None:
        n = _sm_counts[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


class _Chained:
    """The ticket word and status words of the launches whose tiles wait
    on each other or count who finishes last (the scan, the back-to-back
    gather, the stream build, the assembly, the qctx prepare, the unlayout's
    fault flag), and the histogram's 256 u64 sums, one per (device,
    CUDA stream): launches on one stream run in order, so they share them.
    The ticket is left at 0 by every launch; the status words are zeroed once
    and never cleared, and each launch takes an epoch of its own, so a word
    of an earlier launch reads as not ready. The sums (``acc``) are zeroed
    once; the CTA that finishes a bin zeroes it again."""

    def __init__(self, dev: torch.device, tiles: int):
        self.ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.status = torch.zeros((tiles * records.STATUS_WORDS,), dtype=torch.int64, device=dev)
        self.acc = torch.zeros((256,), dtype=torch.int64, device=dev)
        self.epoch = 0


_chained: dict[tuple[int, int], _Chained] = {}
_chained_lock = threading.Lock()


def _chained_state(dev: torch.device, tiles: int, epochs: int = 1) -> tuple[_Chained, int]:
    """This stream's ticket and status words for ``tiles`` tiles, and the
    first of ``epochs`` fresh epochs (a call that launches several chained
    kernels takes one each). A larger launch gets a larger status buffer,
    zeroed on this stream before the launch."""
    with torch.cuda.device(dev):
        key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
        with _chained_lock:
            st = _chained.get(key)
            if st is None:
                st = _chained[key] = _Chained(dev, max(tiles, 4096))
            elif st.status.numel() < tiles * records.STATUS_WORDS:
                st.status = torch.zeros((tiles * 2 * records.STATUS_WORDS,), dtype=torch.int64,
                                        device=dev)
            st.epoch += epochs
            return st, st.epoch - epochs + 1


def _check_1d(name: str, t: torch.Tensor, dtype, dev) -> None:
    if t.dtype != dtype or t.dim() != 1 or t.device != dev:
        raise ValueError(f"{name}: expected a 1-D {dtype} tensor on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def records_scan(text: torch.Tensor, max_records: int):
    """Scan up to ``max_records`` FASTQ records of the (n,) uint8 ``text``
    -> ``(offsets, qmin, info)``; see
    :func:`..ops.records.records_scan_plain`. Two launches (the newlines,
    the records)."""
    n = text.numel()
    dev = text.device
    _check("text", text, torch.uint8, (n,), dev)
    if max_records <= 0:
        raise ValueError(f"max_records must be positive, got {max_records}")
    if _plain_or_cuda(dev):
        return records.records_scan_plain(text, max_records)
    offsets = torch.empty((max_records, 8), dtype=torch.int64, device=dev)
    qmin = torch.empty((max_records,), dtype=torch.int16, device=dev)
    info = torch.empty((records.SCAN_INFO,), dtype=torch.int64, device=dev)
    ctas = records.scan_ctas(max_records, _sm_count(dev))
    scratch = _scratch(dev, records.records_scan_scratch(max_records, ctas))
    st, epoch = _chained_state(dev, records.scan_tiles(n))
    _launch(RECORDS_SCAN, dev, text, n, max_records, ctas, scratch, st.ticket, st.status,
            epoch, offsets, qmin, info)
    return offsets, qmin, info


def rows_gather(
    data: torch.Tensor,
    starts: torch.Tensor | None,
    lens: torch.Tensor,
    rows: int,
    width: int,
    fill: int,
    quarter: tuple[torch.Tensor, int] | None = None,
):
    """Variable-length runs of ``data`` into a padded (rows, width) uint8
    matrix; ``starts`` and ``lens`` are 1-D int64, strided views allowed
    (a column of the scan's offsets), ``starts=None`` for runs back to back
    from 0; ``quarter=(data2, width2)`` (back to back only) also returns the
    (rows, width2) matrix of the runs of ``(lens + 3) >> 2`` bytes of
    ``data2`` (the decode's packed bases beside its qualities); see
    :func:`..ops.records.rows_gather_plain`. One launch."""
    dev = data.device
    _check("data", data, torch.uint8, (data.numel(),), dev)
    _check_1d("lens", lens, torch.int64, dev)
    r = lens.numel()
    if starts is not None:
        _check_1d("starts", starts, torch.int64, dev)
        if starts.numel() != r:
            raise ValueError(f"starts: {starts.numel()} rows, lens {r}")
    if rows < r or width < 0 or not 0 <= fill <= 255:
        raise ValueError(f"rows_gather: rows {rows} < {r}, width {width} or fill {fill}")
    data2, width2 = quarter if quarter is not None else (None, 0)
    if quarter is not None:
        _check("data2", data2, torch.uint8, (data2.numel(),), dev)
        if starts is not None or width2 < 0:
            raise ValueError("rows_gather: a quarter gather takes runs back to back, width >= 0")
    if _plain_or_cuda(dev):
        return records.rows_gather_plain(data, starts, lens, rows, width, fill, quarter)
    out = torch.empty((rows, width), dtype=torch.uint8, device=dev)
    out2 = torch.empty((rows, width2), dtype=torch.uint8, device=dev) if quarter else None
    tile_rows = records.gather_tile_rows(width + width2, starts is None)
    if starts is None:
        st, epoch = _chained_state(dev, -(-rows // tile_rows))
    else:  # the tiles are independent: no ticket, no status
        st, epoch = None, 1
    # passed as pointers: a stream at any byte offset of a staging buffer,
    # int64 columns of the scan's offsets (the kernel reads the source in
    # aligned words of its own and the offsets one at a time)
    _launch(ROWS_GATHER, dev, data.data_ptr(), data.numel(),
            0 if starts is None else starts.data_ptr(),
            0 if starts is None else starts.stride(0), lens.data_ptr(), lens.stride(0),
            r, rows, width, fill, data2.data_ptr() if quarter else 0,
            data2.numel() if quarter else 0, width2, out2.data_ptr() if quarter else 0,
            tile_rows, st.ticket.data_ptr() if st else 0, st.status.data_ptr() if st else 0,
            epoch, out)
    return (out, out2) if quarter is not None else out


def streams_build(
    text: torch.Tensor,
    offsets: torch.Tensor,
    packed: torch.Tensor,
    qual_delta: torch.Tensor,
    nmask: torch.Tensor,
    n_counts: torch.Tensor,
    wide: bool,
    sizes: list[int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """The six raw v1/v2 streams of ``len(offsets)`` records in one buffer
    at the byte ``sizes``; see :func:`..ops.records.streams_build_plain`.
    One launch."""
    dev = text.device
    _check("text", text, torch.uint8, (text.numel(),), dev)
    n = offsets.shape[0]
    _check("offsets", offsets, torch.int64, (n, 8), dev)
    rows = packed.shape[0]
    if n <= 0 or rows < n or len(sizes) != 6:
        raise ValueError(f"streams_build: {n} records, {rows} rows, sizes {sizes}")
    for name, t in (("packed", packed), ("qual_delta", qual_delta), ("nmask", nmask)):
        if (t.dim() != 2 or t.shape[0] != rows or t.stride(1) != 1
                or t.dtype != torch.uint8 or t.device != dev):
            raise ValueError(f"{name}: expected ({rows}, *) uint8 rows on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    _check("n_counts", n_counts, torch.int32, (rows,), dev)
    if _plain_or_cuda(dev):
        return records.streams_build_plain(text, offsets, packed, qual_delta, nmask,
                                           n_counts, wide, sizes)
    out = torch.empty((max(sum(sizes), 1),), dtype=torch.uint8, device=dev)
    info = torch.empty((2,), dtype=torch.int64, device=dev)
    tile = records.stream_tile_records(sizes, n)
    st, epoch = _chained_state(dev, -(-n // tile))
    _launch(STREAMS_BUILD, dev, text, offsets, n, packed, packed.stride(0), qual_delta,
            qual_delta.stride(0), nmask, nmask.stride(0), n_counts, int(wide), *sizes, tile,
            st.ticket, st.status, epoch, out, info)
    return out[: sum(sizes)], info


def fastq_assemble(
    seq_rows: torch.Tensor,
    qual_rows: torch.Tensor,
    lengths: torch.Tensor,
    headers: torch.Tensor,
    plus: torch.Tensor | None,
    npos: torch.Tensor,
    wide: bool,
    len_n: int,
    seq_n: int,
    qual_n: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A block's FASTQ text from the dense decode's rows and the header,
    plus and npos streams; see :func:`..ops.records.fastq_assemble_plain`.
    Three launches (the uniform checks and length sums, the chains that are
    not uniform, the text), counted as one call of the kernel."""
    dev = seq_rows.device
    r = lengths.numel()
    _check("lengths", lengths, torch.int64, (r,), dev)
    if seq_rows.dim() != 2 or seq_rows.shape[0] != r:
        raise ValueError(f"seq_rows: expected ({r}, L), got {tuple(seq_rows.shape)}")
    _check("seq_rows", seq_rows, torch.uint8, seq_rows.shape, dev)
    _check("qual_rows", qual_rows, torch.uint8, seq_rows.shape, dev)
    for name, t in (("headers", headers), ("plus", plus), ("npos", npos)):
        if t is not None:
            _check(name, t, torch.uint8, (t.numel(),), dev)
    if r == 0:
        raise ValueError("fastq_assemble: no records")
    if _plain_or_cuda(dev):
        return records.fastq_assemble_plain(seq_rows, qual_rows, lengths, headers, plus,
                                            npos, wide, len_n, seq_n, qual_n)
    has_plus = plus is not None
    plus_n = plus.numel() if has_plus else 0
    unit = 4 if wide else 2
    nodes = (headers.numel(), plus_n, npos.numel() // unit)
    if r > records.NODE_LIMIT or max(nodes) > records.NODE_LIMIT:
        raise ValueError(f"fastq_assemble: {r} records or streams of {nodes} nodes "
                         f"(at most {records.NODE_LIMIT} each)")
    cap = records.assemble_capacity(r, headers.numel(), plus_n, qual_n, has_plus)
    out = torch.empty((max(cap, 1),), dtype=torch.uint8, device=dev)
    info = torch.empty((2,), dtype=torch.int64, device=dev)
    checks = max(1, min(_sm_count(dev), -(-r // records.CHECK_THREADS)))
    scratch = _scratch(dev, records.assemble_scratch(r, checks))
    tiles = [records.chain_tile_nodes(n) for n in nodes]
    chain_tiles = sum(n // t + 1 for n, t in zip(nodes, tiles))
    tile_records = records.assemble_tile_records(seq_rows.shape[1])
    st, epoch = _chained_state(dev, chain_tiles)
    # streams may be views at any byte offset of a staging buffer
    _launch(FASTQ_ASSEMBLE, dev, seq_rows, qual_rows, seq_rows.shape[1], lengths, r,
            headers.data_ptr(), headers.numel(), tiles[0],
            plus.data_ptr() if has_plus else 0, plus_n, int(has_plus), tiles[1],
            npos.data_ptr(), npos.numel(), int(wide), tiles[2], len_n, seq_n, qual_n,
            checks, tile_records, scratch, out, cap, info,
            st.ticket, st.status, epoch)
    return out[:cap], info


# ---------------------------------------------------------------------------
# context-model passes: qctx / sctx prepare, the wctx lane matrices
# ---------------------------------------------------------------------------


def _check_bounds(name: str, t: torch.Tensor, rows: int, dev) -> int:
    """A (rows, nrec + 1) int64 bounds tensor (1-D for one row) -> nrec."""
    if (t.dtype != torch.int64 or t.dim() != (1 if rows == 1 else 2) or t.device != dev
            or t.shape[-1] < 1 or (rows > 1 and t.shape[0] != rows) or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous ({rows}, nrec + 1) int64 tensor on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.shape[-1] - 1


def qctx_prepare(delta: torch.Tensor, bounds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Integration and max-model histogram of an (n,) uint8 quality delta
    stream whose records start at ``bounds`` ((nrec + 1,) int64, the last
    = n, checked by the caller) -> (raw (n,) uint8, (3072, 256) int32); see
    :func:`..ops.ctxprep.qctx_prepare_plain`. A memset of the histogram and
    one launch; its tiles chain through this stream's status words."""
    n = delta.numel()
    dev = delta.device
    _check("delta", delta, torch.uint8, (n,), dev)
    nrec = _check_bounds("bounds", bounds, 1, dev)
    if n > ctxprep.QCTX_MAX_SYMBOLS:
        raise ValueError(f"qctx_prepare: {n} symbols (at most {ctxprep.QCTX_MAX_SYMBOLS})")
    if _plain_or_cuda(dev):
        return ctxprep.qctx_prepare_plain(delta, bounds)
    raw = torch.empty((n,), dtype=torch.uint8, device=dev)
    hist = torch.empty((ctxprep.QCTX_CONTEXTS, 256), dtype=torch.int32, device=dev)
    st, epoch = _chained_state(dev, -(-n // ctxprep.QCTX_TILE))
    _launch(QCTX_PREPARE, dev, delta, n, bounds, nrec, raw, hist, st.ticket, st.status, epoch)
    return raw, hist


def sctx_prepare(packed: torch.Tensor, bounds: torch.Tensor, n: int):
    """Unpack of (m,) uint8 packed sequence rows and the order-6 histogram;
    ``bounds``: (2, nrec + 1) int64, the records' first base and first packed
    byte (:func:`..ops.ctxprep.record_bounds`), ``n`` the bases (its last
    first-base entry, checked by the caller) -> (bases (n,) uint8, (4096, 4)
    int32); see :func:`..ops.ctxprep.sctx_prepare_plain`. A memset of the
    histogram and one launch (persistent CTAs on tiles of
    :data:`..ops.ctxprep.SCTX_TILE` bases)."""
    m = packed.numel()
    dev = packed.device
    _check("packed", packed, torch.uint8, (m,), dev)
    nrec = _check_bounds("bounds", bounds, 2, dev)
    if _plain_or_cuda(dev):
        return ctxprep.sctx_prepare_plain(packed, bounds)
    bases = torch.empty((n,), dtype=torch.uint8, device=dev)
    hist = torch.empty((ctxprep.SCTX_CONTEXTS, 4), dtype=torch.int32, device=dev)
    _launch(SCTX_PREPARE, dev, packed, m, bounds, nrec, bases, hist)
    return bases, hist


def _check_lane_table(lanes_tab: torch.Tensor, steps: int, dev) -> int:
    if (lanes_tab.dtype != torch.int64 or lanes_tab.dim() != 2 or lanes_tab.shape[0] != 2
            or lanes_tab.shape[1] < 2 or lanes_tab.device != dev
            or not lanes_tab.is_contiguous()):
        raise ValueError(f"lanes_tab: expected a contiguous (2, lanes + 1) int64 tensor on "
                         f"{dev}, got {lanes_tab.dtype} {tuple(lanes_tab.shape)}")
    if steps < 1:
        raise ValueError(f"steps must be positive, got {steps}")
    return lanes_tab.shape[1] - 1


def wctx_layout(
    syms: torch.Tensor | None,
    bounds: torch.Tensor,
    lanes_tab: torch.Tensor,
    steps: int,
    model: int,
    order: int,
    idx_map: torch.Tensor | None = None,
    pad_sym: int = 0,
):
    """The (steps, lanes) matrices of one wctx stream: with ``syms`` the
    (n,) uint8 symbols, ``(sym_idx uint8, ctx int16)`` (``idx_map`` the
    (256,) uint8 present-index map, ``pad_sym`` the pad symbol); with
    ``syms`` None the uint8 start matrix of the decoder. ``bounds``: (nrec +
    1,) int64 record starts; ``lanes_tab``: (2, lanes + 1) int64 lane
    starts and first records (:func:`..ops.ctxprep.lane_layout`). See
    :func:`..ops.ctxprep.wctx_layout_plain`. One launch, a CTA per
    :data:`..ops.ctxprep.LAYOUT_TILE_STEPS` x ``LAYOUT_TILE_LANES`` cells."""
    dev = bounds.device
    _check_bounds("bounds", bounds, 1, dev)
    lanes = _check_lane_table(lanes_tab, steps, dev)
    if (model, order) not in ((0, 2), (0, 4), (0, 6), (1, 0), (1, 1)):
        raise ValueError(f"unsupported wctx model/order {model}/{order}")
    if syms is not None:
        _check("syms", syms, torch.uint8, (syms.numel(),), dev)
        if idx_map is None:
            raise ValueError("wctx_layout: the encode needs idx_map")
        _check("idx_map", idx_map, torch.uint8, (256,), dev)
        if not 0 <= pad_sym <= 255:
            raise ValueError(f"pad_sym must be a byte, got {pad_sym}")
    if _plain_or_cuda(dev):
        return ctxprep.wctx_layout_plain(syms, bounds, lanes_tab, steps, model, order,
                                         idx_map, pad_sym)
    if syms is None:
        start = torch.empty((steps, lanes), dtype=torch.uint8, device=dev)
        _launch(WCTX_LAYOUT, dev, None, bounds, lanes_tab, lanes, steps, model, order, None,
                0, None, None, start)
        return start
    sym_idx = torch.empty((steps, lanes), dtype=torch.uint8, device=dev)
    ctx = torch.empty((steps, lanes), dtype=torch.int16, device=dev)
    _launch(WCTX_LAYOUT, dev, syms, bounds, lanes_tab, lanes, steps, model, order, idx_map,
            pad_sym, sym_idx, ctx, None)
    return sym_idx, ctx


def wctx_unlayout(
    mat: torch.Tensor,
    bounds: torch.Tensor,
    lanes_tab: torch.Tensor,
    present: torch.Tensor,
    mode: int,
    size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The decoded (steps, lanes) present-index matrix in record order, as
    ``mode`` says (:data:`..ops.ctxprep.UNLAYOUT_FLAT`, ``_PACKED`` with
    (2, nrec + 1) ``bounds``, ``_DELTA``), ``size`` output bytes (the
    symbols, or the packed bytes) -> (uint8 (size,), int32 (1,) fault); see
    :func:`..ops.ctxprep.wctx_unlayout_plain`. One launch, which writes the
    fault flag too (its last CTA, by this stream's ticket)."""
    if mat.dim() != 2 or mat.shape[0] < 1:
        raise ValueError(f"mat: expected (S, N) with S >= 1, got {tuple(mat.shape)}")
    steps, lanes = mat.shape
    dev = mat.device
    _check("mat", mat, torch.uint8, (steps, lanes), dev)
    if mode not in (ctxprep.UNLAYOUT_FLAT, ctxprep.UNLAYOUT_PACKED, ctxprep.UNLAYOUT_DELTA):
        raise ValueError(f"unknown unlayout mode {mode}")
    nrec = _check_bounds("bounds", bounds, 2 if mode == ctxprep.UNLAYOUT_PACKED else 1, dev)
    if _check_lane_table(lanes_tab, steps, dev) != lanes:
        raise ValueError(f"lanes_tab: {lanes_tab.shape[1] - 1} lanes, mat {lanes}")
    if not 1 <= present.numel() <= 256:
        raise ValueError(f"present: 1 to 256 symbols, got {present.numel()}")
    _check("present", present, torch.uint8, (present.numel(),), dev)
    if _plain_or_cuda(dev):
        return ctxprep.wctx_unlayout_plain(mat, bounds, lanes_tab, present, mode)
    dst = torch.empty((size,), dtype=torch.uint8, device=dev)
    fault = torch.empty((1,), dtype=torch.int32, device=dev)
    st, epoch = _chained_state(dev, 1)
    _launch(WCTX_UNLAYOUT, dev, mat, bounds, nrec, lanes_tab, lanes, steps, present,
            present.numel(), mode, dst, fault, st.ticket, st.status, epoch)
    return dst, fault


# ---------------------------------------------------------------------------
# the runtime's byte histogram and header tokenizer
# ---------------------------------------------------------------------------


def _check_bytes(name: str, t: torch.Tensor, dev) -> int:
    """A contiguous 1-D uint8 tensor (a view at any byte offset) -> its
    length."""
    _check_1d(name, t, torch.uint8, dev)
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.numel()


def hist256(data: torch.Tensor) -> torch.Tensor:
    """The 256 byte counts of an (n,) uint8 tensor, a view at any byte
    offset -> (256,) int64; see :func:`..ops.rans.hist256_plain`. One launch
    (its CTAs add into this stream's accumulator, ``_Chained.acc``; the last
    to add to a bin writes it out and leaves it at 0)."""
    dev = data.device
    n = _check_bytes("data", data, dev)
    if _plain_or_cuda(dev):
        return hist256_plain(data)
    lib = build.load(_LIBRARY[HIST256])
    ptr = data.data_ptr() if n else 0
    ctas = lib.fq_hist256_ctas(n, ptr % 16, _sm_count(dev))
    out = torch.empty((256,), dtype=torch.int64, device=dev)
    st, _ = _chained_state(dev, 1)
    _launch(HIST256, dev, ptr, n, ctas, st.acc, out)
    return out


_TOK_LIMIT = (1 << 31) - 2  # stream bytes a call takes (int32 positions)


def _tok_limit(name: str, n: int) -> None:
    if n > _TOK_LIMIT:  # not a malformed stream: no ValueError
        raise RuntimeError(f"{name}: {n} bytes (at most {_TOK_LIMIT})")


def tok_encode(stream: torch.Tensor, count: int,
               lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The tokenized form of the u16-length-prefixed header stream ``stream``
    ((n,) uint8, a view at any byte offset) of ``count`` records -> uint8
    tensor on its device; see :func:`..ops.tokenize.tok_encode_plain`. A
    malformed stream raises ``ValueError`` with the plain version's string.
    ``lengths``: the records' header lengths on the card (1-D int64, any
    stride: the record scan's column), for a stream the stream build wrote
    from them; the kernel then takes the record starts from their sum and
    launches once, and lengths that are not the stream's raise
    ``RuntimeError``. Without them the record starts come from the stream
    (the chain kernel, then the encode). Then the fault and the size are
    read back. The plain version reads only the stream."""
    dev = stream.device
    n = _check_bytes("stream", stream, dev)
    if count < 0:
        raise ValueError(f"count must be >= 0, got {count}")
    if lengths is not None:
        _check_1d("lengths", lengths, torch.int64, dev)
        if lengths.numel() != count:
            raise ValueError(f"lengths: {lengths.numel()} records, count {count}")
    if _plain_or_cuda(dev):
        return tokenize.tok_encode_plain(stream, count)
    _tok_limit(TOK_ENCODE, n)
    if count == 0 or 2 * count > n:
        # no chain to walk: a record takes two bytes at least
        if count == 0 and n == 0:
            return torch.zeros((1,), dtype=torch.uint8, device=dev)  # varint(0)
        raise ValueError(tokenize.TOK_ENCODE_FAULTS[1 if count else 2])
    out, info = tok_encode_launch(stream, count, lengths)
    fault, size = info[tokenize.TOK_INFO_FAULT : tokenize.TOK_INFO_SIZE + 1].tolist()
    if fault == tokenize.TOK_ENCODE_LENGTHS:
        raise RuntimeError(f"{TOK_ENCODE}: the header lengths are not the stream's")
    if fault:
        raise ValueError(tokenize.TOK_ENCODE_FAULTS[fault])
    return out[:size]


def tok_encode_launch(stream: torch.Tensor, count: int, lengths: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`tok_encode`'s launches on a CUDA tensor (1 <= count <= n / 2),
    read back nothing: -> (out, its ``encode_bound`` bytes; info, int64 with
    the fault and the size at ``tokenize.TOK_INFO_FAULT`` / ``_SIZE``). One
    launch with ``lengths``, two without."""
    dev, n = stream.device, stream.numel()
    lib = build.load(_LIBRARY[TOK_ENCODE])
    if lengths is None:
        starts = torch.empty((count + 1,), dtype=torch.int32, device=dev)
        maps = torch.empty((lib.fq_tok_map_words(n),), dtype=torch.int64, device=dev)
        chain_info = torch.empty((tokenize.TOK_INFO_SLOTS,), dtype=torch.int64, device=dev)
        scratch = (starts.data_ptr(), chain_info.data_ptr(), maps.data_ptr())
    else:
        scratch = (0, 0, 0)
    out = torch.empty((tokenize.encode_bound(n, count),), dtype=torch.uint8, device=dev)
    info = torch.empty((tokenize.TOK_INFO_SLOTS,), dtype=torch.int64, device=dev)
    st, epoch = _chained_state(dev, lib.fq_tok_tiles(n, count), epochs=2)
    _launch(TOK_ENCODE, dev, stream.data_ptr(), n, count,
            0 if lengths is None else lengths.data_ptr(),
            0 if lengths is None else lengths.stride(0), *scratch, out, info,
            st.ticket, st.status, epoch)
    return out, info


def tok_decode(data: torch.Tensor, count: int) -> torch.Tensor:
    """The u16-length-prefixed header stream of ``count`` records that the
    tokenized stream ``data`` ((m,) uint8, a view at any byte offset)
    codes -> uint8 tensor on its device; see
    :func:`..ops.tokenize.tok_decode_plain`. A corrupt stream raises
    ``ValueError`` with the plain version's string for its first fault in
    stream order. The declared size (the leading varint) is read on the
    card (for count 0, with nothing to launch, on the host); the output is
    sized from the decoded lengths. Two calls: the op chain and the resolve
    (two launches); then, with the fault and the size read back and no
    fault, the write (one launch)."""
    dev = data.device
    m = _check_bytes("data", data, dev)
    if count < 0:
        raise ValueError(f"count must be >= 0, got {count}")
    if _plain_or_cuda(dev):
        return tokenize.tok_decode_plain(data, count)
    _tok_limit(TOK_DECODE, m)
    if count == 0:
        # no record to decode, no launch: the declared size alone decides
        total, _ = tokenize._read_varint(data[:10].cpu().numpy().tobytes(), 0)
        if total != 0:
            raise ValueError(tokenize.TOK_FAULTS[9])
        return torch.empty((0,), dtype=torch.uint8, device=dev)
    if m == 0:
        raise ValueError(tokenize.TOK_FAULTS[1])  # no varint of the declared size
    call = tok_decode_launch(data, count)
    key, size, mismatch = call.info[
        tokenize.TOK_INFO_FAULT : tokenize.TOK_INFO_MISMATCH + 1].tolist()
    if key != tokenize.TOK_NO_FAULT:
        code, pos = key & 15, key >> 4
        if code not in tokenize.TOK_FAULTS:
            raise RuntimeError(f"{TOK_DECODE}: internal fault {code} at {pos}")
        op = int(data[pos].item()) if code == 7 else 0
        raise ValueError(tokenize.TOK_FAULTS[code].format(op=op))
    if mismatch:
        raise ValueError(tokenize.TOK_FAULTS[9])
    return tok_decode_write(call, size)


class TokDecodeCall(NamedTuple):
    """A decode's first call: its arguments (the second call takes them
    again) and its info (int64: the first fault's position * 16 + code, or
    ``tokenize.TOK_NO_FAULT``, the output size and whether it differs from
    the declared total, at ``tokenize.TOK_INFO_FAULT`` / ``_SIZE`` /
    ``_MISMATCH``)."""

    args: tuple
    info: torch.Tensor


def tok_decode_launch(data: torch.Tensor, count: int) -> TokDecodeCall:
    """:func:`tok_decode`'s first call on a CUDA tensor of m >= 1 bytes
    (count >= 0), read back nothing."""
    dev, m = data.device, data.numel()
    # a record ends at an op byte: past m records the chain runs out (or
    # faults first) whatever the count
    count = min(count, m)
    lib = build.load(_LIBRARY[TOK_DECODE])
    ops = torch.empty((m,), dtype=torch.int32, device=dev)
    recstart = torch.empty((count + 2,), dtype=torch.int32, device=dev)
    maps = torch.empty((lib.fq_tok_map_words(m),), dtype=torch.int64, device=dev)
    fin = torch.empty((m * lib.fq_tok_state_bytes(),), dtype=torch.uint8, device=dev)
    agg = torch.empty((m * lib.fq_tok_agg_bytes(),), dtype=torch.uint8, device=dev)
    rbase = torch.empty((count + 1,), dtype=torch.int64, device=dev)
    info = torch.empty((tokenize.TOK_INFO_SLOTS,), dtype=torch.int64, device=dev)
    st, epoch = _chained_state(dev, lib.fq_tok_tiles(m, count), epochs=2)
    args = (data.data_ptr(), m, count, ops, recstart, maps, fin, agg, rbase, info)
    _launch(TOK_DECODE, dev, *args, st.ticket, st.status, epoch)
    return TokDecodeCall(args, info)


def tok_decode_write(call: TokDecodeCall, size: int) -> torch.Tensor:
    """A decode's second call, after a first that found no fault: the
    ``size`` output bytes (the first call's size)."""
    out = torch.empty((size,), dtype=torch.uint8, device=call.info.device)
    if size:
        _launch(TOK_DECODE_WRITE, call.info.device, *call.args, out)
    return out


# ---------------------------------------------------------------------------
# the runtime's context coders: qctx / sctx encode and decode
# ---------------------------------------------------------------------------


def _check_plan(plan: torch.Tensor) -> tuple[int, int]:
    """A host int64 plan (:func:`..ops.ctxcoder.coder_plan`) -> (symbols,
    packed bytes) of its stream."""
    if (plan.dtype != torch.int64 or plan.device.type != "cpu" or not plan.is_contiguous()
            or tuple(plan.shape) != (ctxcoder.PLAN_WORDS,)):
        raise ValueError(f"plan: expected a contiguous ({ctxcoder.PLAN_WORDS},) int64 CPU "
                         f"tensor, got {plan.dtype} {tuple(plan.shape)} on {plan.device}")
    return int(plan[ctxcoder.PLAN_SB + 4]), int(plan[ctxcoder.PLAN_PSTART + 4])


def _check_starts(starts: torch.Tensor, plan: torch.Tensor, dev) -> None:
    _check_1d("starts", starts, torch.int64, dev)
    if not starts.is_contiguous() or starts.numel() != int(plan[ctxcoder.PLAN_RB + 4]) + 1:
        raise ValueError(f"starts: {starts.numel()} entries for "
                         f"{int(plan[ctxcoder.PLAN_RB + 4])} records")


def _coder_encode(name: str, syms, starts, plan, tab, arg: int, contexts: int, width: int,
                  plain):
    n = syms.numel()
    dev = syms.device
    _check("syms", syms, torch.uint8, (n,), dev)
    if n == 0 or _check_plan(plan)[0] != n:
        raise ValueError(f"{name}: {n} symbols, a plan of {_check_plan(plan)[0]}")
    _check_starts(starts, plan, dev)
    _check("tab", tab, torch.int64, (contexts, width), dev)
    if _plain_or_cuda(dev):
        return plain(syms, starts, plan, tab, arg)
    words = torch.empty((n,), dtype=torch.int16, device=dev)
    flags = torch.empty((n,), dtype=torch.uint8, device=dev)
    states = torch.empty((ctxcoder.CHAINS,), dtype=torch.int32, device=dev)
    counts = torch.empty((ctxcoder.CHAINS,), dtype=torch.int64, device=dev)
    _launch(name, dev, syms, starts, plan, tab, arg, words, flags, states, counts)
    return words, flags, states, counts


def qctx_encode(raw: torch.Tensor, starts: torch.Tensor, plan: torch.Tensor,
                tab: torch.Tensor, model: int):
    """Backward qctx encode of the (n,) raw qualities (n >= 1) of records
    starting at ``starts`` ((nrec + 1,) int64, on their device), the chunks
    of the host ``plan``, ``tab`` the model's (contexts, 256) int64 entries
    (:func:`..ops.ctxcoder.encode_table`) -> (words int16 (n,), flags uint8 (n,), states int32
    (16,), counts int64 (16,), -1 where a chain met a present symbol with no
    frequency); see :func:`..ops.qualctx.qctx_encode_plain`. One launch: a
    CTA a (chunk, state) chain."""
    if model not in qualctx.MODELS:
        raise ValueError(f"unsupported qctx model {model}")
    contexts = qualctx.NUM_CTX2 if model else qualctx.NUM_CTX
    return _coder_encode(QCTX_ENCODE, raw, starts, plan, tab, model, contexts, 256,
                         qualctx.qctx_encode_plain)


def sctx_encode(bases: torch.Tensor, starts: torch.Tensor, plan: torch.Tensor,
                tab: torch.Tensor, order: int):
    """Backward sctx encode of (n,) bases 0-3 at ``order``, ``tab`` the
    (4**order, 4) int64 entries; as :func:`qctx_encode`, see
    :func:`..ops.seqctx.sctx_encode_plain`. One launch."""
    if order not in seqctx.ORDERS:
        raise ValueError(f"unsupported sctx order {order}")
    return _coder_encode(SCTX_ENCODE, bases, starts, plan, tab, order, 4**order, 4,
                         seqctx.sctx_encode_plain)


def _check_words(words: torch.Tensor, plan: torch.Tensor, dev) -> None:
    _check("words", words, torch.int16, (words.numel(),), dev)
    p = plan[ctxcoder.PLAN_WSTART : ctxcoder.PLAN_WCOUNT + 4].tolist()
    if p[3] + p[7] > words.numel() or min(p) < 0:
        raise ValueError(f"words: {words.numel()} words, the plan's chunks end at {p[3] + p[7]}")


def qctx_decode(words: torch.Tensor, starts: torch.Tensor, plan: torch.Tensor,
                fcum: torch.Tensor, model: int, checks: bool, alphabet=None):
    """Forward qctx decode of the payload's (W,) int16 words (its chunks'
    runs back to back) with the host ``plan`` (word counts and states), the
    model's (contexts, 256) int32 entries ``fcum``; ``checks``: the JAX
    package's whole-file decoder's checks -> (the delta stream uint8 (n,),
    info int64 (4, 2): each chunk's first fault code and symbol index); see
    :func:`..ops.qualctx.qctx_decode_plain`. ``alphabet``: every symbol with
    a frequency in ``fcum`` (:func:`..ops.qualctx.table_alphabet`, on the
    host); on the card it picks the route by the table's size
    (:func:`..ops.qualctx.dense_layout`): the dense rows in shared memory, a
    CTA a chunk, one launch; else the slot table through the L2, two
    launches (the table, the walk). Either counts as one call, and
    ``qctx_routes`` counts the route."""
    dev = words.device
    n, _ = _check_plan(plan)
    _check_words(words, plan, dev)
    _check_starts(starts, plan, dev)
    if model not in qualctx.MODELS:
        raise ValueError(f"unsupported qctx model {model}")
    contexts = qualctx.NUM_CTX2 if model else qualctx.NUM_CTX
    _check("fcum", fcum, torch.int32, (contexts, 256), dev)
    if _plain_or_cuda(dev):
        return qualctx.qctx_decode_plain(words, starts, plan, fcum, model, checks)
    if alphabet is None:
        raise ValueError("qctx_decode: the table's alphabet (qualctx.table_alphabet) picks "
                         "the route on the card")
    layout = qualctx.dense_layout(alphabet, model)
    if words.numel() == 0:  # a valid pointer for the kernel (never read)
        words = torch.empty((8,), dtype=torch.int16, device=dev)
    out = torch.empty((max(n, 1),), dtype=torch.uint8, device=dev)
    info = torch.empty((ctxcoder.NUM_CHUNKS, 2), dtype=torch.int64, device=dev)
    if layout is not None:
        syms = torch.zeros((qualctx.DENSE_MAX_COLUMNS,), dtype=torch.uint8)
        syms[: len(layout.symbols)] = torch.from_numpy(layout.symbols)
        _launch(QCTX_DECODE, dev, words, starts, plan, fcum, contexts, model, int(checks), syms,
                len(layout.symbols), layout.tile, 0, out, info)
    else:
        slot = torch.empty((contexts * qualctx.PROB_SCALE,), dtype=torch.uint8, device=dev)
        _launch(QCTX_DECODE, dev, words, starts, plan, fcum, contexts, model, int(checks), 0, 0,
                0, slot, out, info)
    qctx_routes.bump("shared" if layout is not None else "l2")
    return out[:n], info


def sctx_decode(words: torch.Tensor, starts: torch.Tensor, plan: torch.Tensor,
                freq: torch.Tensor, order: int):
    """Forward sctx decode straight to the packed rows: ``freq`` the
    (4**order, 4) int16 table -> (packed uint8 (m,), info int64 (4, 2)); as
    :func:`qctx_decode`, see :func:`..ops.seqctx.sctx_decode_plain`. One
    launch, a CTA a chunk: the context rows in its shared memory, a chain
    warp fed tiles of words and record starts by the CTA's other warps."""
    dev = words.device
    n, m = _check_plan(plan)
    _check_words(words, plan, dev)
    _check_starts(starts, plan, dev)
    if order not in seqctx.ORDERS:
        raise ValueError(f"unsupported sctx order {order}")
    _check("freq", freq, torch.int16, (4**order, 4), dev)
    if _plain_or_cuda(dev):
        return seqctx.sctx_decode_plain(words, starts, plan, freq, order)
    if words.numel() == 0:
        words = torch.empty((8,), dtype=torch.int16, device=dev)
    out = torch.empty((max(m, 1),), dtype=torch.uint8, device=dev)
    info = torch.empty((ctxcoder.NUM_CHUNKS, 2), dtype=torch.int64, device=dev)
    _launch(SCTX_DECODE, dev, words, starts, plan, freq, order, out, info)
    return out[:m], info
