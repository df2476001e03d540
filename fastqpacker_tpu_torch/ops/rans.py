"""Interleaved-lane order-0 rANS entropy coder (FQZ v3 ``TAG_RANS``).

The port of ``fastqpacker_tpu/ops/rans.py``: the same wire stream for the
same bytes, with the three device programs (lockstep encode, word
compaction, lockstep decode) as the Hopper kernels of
``csrc/rans_codec.cu`` (wrappers in :mod:`.cuda_kernels`). The plain
PyTorch versions of those programs are here; the wrappers run them on CPU
tensors, and the kernels are held against them on the card.

- **Interleaving**: N lanes (256, 4096 or 16384 by stream size); lane ``l``
  codes symbols ``l, l+N, l+2N, ...`` so a ``(steps, N)`` row-major matrix
  IS the byte stream.
- **State**: 32-bit, 16-bit renormalisation, 12-bit probabilities (table
  total 4096). Encode walks the rows backwards, emitting 0/1 u16 words per
  lane per step; a prefix sum + scatter flattens them to global (step,
  lane) order, exactly the forward decoder's consumption order.
- **Per-stream tables**: 256-entry frequency table normalised to 4096 on
  the host (largest remainder); a 4096-entry slot table for decode.

Wire format per stream (little-endian):
  u32 raw_len | u8 lanes_log2 | u8[3] reserved | u16 freq[256]
  | u32 final_states[N] | u32 total_words | u16 words[total]

The padding needed to fill the last row is the stream's most frequent byte
(cheapest to code) and is included in the histogram.

torch has no arithmetic on unsigned 32-bit integers, so the plain versions
compute in int64 and mask to 32 bits; tensors that cross the kernel
boundary hold u16 / u32 bit patterns in int16 / int32.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .device import resolve_device, to_device

PROB_BITS = 12
PROB_SCALE = 1 << PROB_BITS  # 4096
RANS_L = 1 << 16  # state lower bound
HEADER_FMT = "<IB3x"
MAX_LANES = 16384  # the decode kernel's cluster holds 16 CTAs x 256 threads x 4

_M32 = 0xFFFFFFFF


class RansError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Frequency tables (host)
# ---------------------------------------------------------------------------


def normalize_freqs(hist: np.ndarray) -> np.ndarray:
    """Normalize a 256-bin histogram to sum exactly PROB_SCALE.

    Every present symbol gets freq >= 1; the residual is settled against
    the largest buckets (largest-remainder style).
    """
    hist = hist.astype(np.int64)
    total = int(hist.sum())
    if total == 0:
        raise RansError("cannot build table for empty stream")
    freq = (hist * PROB_SCALE // total).astype(np.int64)
    freq[(hist > 0) & (freq == 0)] = 1
    diff = PROB_SCALE - int(freq.sum())
    if diff != 0:
        order = np.argsort(-freq, kind="stable")
        i = 0
        step = 1 if diff > 0 else -1
        remaining = abs(diff)
        while remaining > 0:
            s = order[i % 256]
            if step > 0 and freq[s] > 0:
                freq[s] += 1
                remaining -= 1
            elif step < 0 and freq[s] > 1:
                freq[s] -= 1
                remaining -= 1
            i += 1
            if i > 100000:  # pragma: no cover - safety net
                raise RansError("failed to normalize frequency table")
    return freq.astype(np.uint16)


def cumulative(freq: np.ndarray) -> np.ndarray:
    cum = np.zeros(256, dtype=np.uint32)
    np.cumsum(freq[:-1], out=cum[1:])
    return cum


def slot_tables(freq: np.ndarray):
    """(slot_sym i32[4096], slot_freq u32[4096], slot_cum u32[4096])."""
    freq = freq.astype(np.int64)
    slot_sym = np.repeat(np.arange(256, dtype=np.int32), freq)
    cum = cumulative(freq.astype(np.uint16))
    return (
        slot_sym.astype(np.int32),
        freq[slot_sym].astype(np.uint32),
        cum[slot_sym].astype(np.uint32),
    )


def pack_slot_table(freq: np.ndarray) -> np.ndarray:
    """(4096,) u32 decode table: (freq-1) | cum<<12 | sym<<24."""
    sym, sfreq, scum = slot_tables(freq)
    return (
        (sfreq.astype(np.uint32) - 1)
        | (scum.astype(np.uint32) << 12)
        | (sym.astype(np.uint32) << 24)
    )


def reciprocals(freq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The encode kernel's per-symbol reciprocal of frequencies 1-4096
    (Granlund and Montgomery's round-up method): ``l = ceil(log2 f)`` and
    ``m = floor(2^32 (2^l - f) / f) + 1``, as uint64 arrays."""
    f = np.asarray(freq, np.uint64)
    l = np.zeros_like(f)
    for k in range(1, PROB_BITS + 1):
        l[f > (1 << (k - 1))] = k
    m = (((np.uint64(1) << l) - f) << np.uint64(32)) // f + np.uint64(1)
    return m, l


def reciprocal_div(x: np.ndarray, m: np.ndarray, l: np.ndarray) -> np.ndarray:
    """``x // f`` for uint32 ``x`` as the encode kernel computes it from
    :func:`reciprocals`: ``t = mulhi(m, x)``, ``q = (t + ((x - t) >> min(l,
    1))) >> max(l - 1, 0)``. Exact for every x < 2^32 (Granlund and
    Montgomery 1994, theorem 4.2)."""
    x = np.asarray(x, np.uint64)
    t = (m * x) >> np.uint64(32)
    return (t + ((x - t) >> np.minimum(l, 1))) >> (np.maximum(l, 1) - np.uint64(1))


def _pick_lanes(n: int) -> int:
    # wider interleave = fewer sequential steps on the device. Lane-state
    # wire overhead is 4 B/lane, so the wide tiers only engage when that is
    # <1% of the stream. The tier is written into the stream.
    if n >= (8 << 20):
        return 16384
    return 4096 if n >= (2 << 20) else 256


# ---------------------------------------------------------------------------
# Bit patterns across the kernel boundary
# ---------------------------------------------------------------------------


def _bits16(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^16) -> the same bits as int16."""
    return (((x & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)


def _bits32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same bits as int32."""
    return (((x & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _u16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the three device programs
# ---------------------------------------------------------------------------


def rans_encode_plain(
    data: torch.Tensor,
    steps: int,
    lanes: int,
    pad_sym: int,
    freq_cum: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward lockstep encode of all lanes.

    ``data``: (n,) uint8 with ``n <= steps * lanes`` (cells past ``n`` code
    ``pad_sym``); ``freq_cum``: (2, 256) int32, freq row 0, cum row 1.
    Returns ``(words int16 (steps*lanes,), flags uint8 (steps*lanes,),
    states int32 (lanes,))``: per cell the state's low 16 bits and whether
    they were emitted, and the final states, as bit patterns.
    """
    dev = data.device
    n = data.numel()
    mat = torch.full((steps * lanes,), pad_sym, dtype=torch.int64, device=dev)
    mat[:n] = data
    mat = mat.view(steps, lanes)
    freq = freq_cum[0].to(torch.int64)
    cum = freq_cum[1].to(torch.int64)
    words = torch.empty((steps, lanes), dtype=torch.int64, device=dev)
    flags = torch.empty((steps, lanes), dtype=torch.bool, device=dev)
    x = torch.full((lanes,), RANS_L, dtype=torch.int64, device=dev)
    for t in range(steps - 1, -1, -1):
        f = freq[mat[t]]
        c = cum[mat[t]]
        emit = (x >> 20) >= f  # x >= f << 20
        words[t] = x & 0xFFFF
        flags[t] = emit
        x = torch.where(emit, x >> 16, x)
        q = torch.div(x, f, rounding_mode="floor")
        x = ((q << PROB_BITS) + x % f + c) & _M32
    return (
        _bits16(words).reshape(-1),
        flags.to(torch.uint8).reshape(-1),
        _bits32(x),
    )


def rans_compact_plain(
    words: torch.Tensor, flags: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flatten the flagged words to global (step, lane) order: a cell is
    kept where its flag byte is not 0, rank = exclusive prefix of the kept
    cells, ``out[rank] = word``. Returns ``(out int16 (m,), total int64
    (1,))``; cells of ``out`` at or past ``total`` are unspecified."""
    mask = flags.bool()
    keep = mask.to(torch.int64)
    rank = torch.cumsum(keep, dim=0) - keep
    out = torch.zeros_like(words)
    out[rank[mask]] = words[mask]
    return out, keep.sum().reshape(1)


def rans_decode_plain(
    words: torch.Tensor,
    states: torch.Tensor,
    slot_tab: torch.Tensor,
    steps: int,
    lanes: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward lockstep decode.

    ``words``: (W,) int16 in global (step, lane) order; ``states``: (lanes,)
    int32; ``slot_tab``: (4096,) int32 packed (freq-1) | cum<<12 | sym<<24.
    Per step the lanes whose state fell below ``RANS_L`` take consecutive
    words in lane order. Words past the end of the buffer read as 0.
    Returns ``(symbols uint8 (steps*lanes,), consumed int64 (1,))``.
    """
    dev = states.device
    tab = _u32(slot_tab)
    total_words = words.numel()
    wpad = torch.cat([_u16(words), torch.zeros(1, dtype=torch.int64, device=dev)])
    x = _u32(states)
    base = torch.zeros(1, dtype=torch.int64, device=dev)
    out = torch.empty((steps, lanes), dtype=torch.uint8, device=dev)
    for t in range(steps):
        slot = x & (PROB_SCALE - 1)
        e = tab[slot]
        f = (e & 0xFFF) + 1
        c = (e >> 12) & 0xFFF
        out[t] = (e >> 24).to(torch.uint8)
        x = (f * (x >> PROB_BITS) + slot - c) & _M32
        need = x < RANS_L
        ni = need.to(torch.int64)
        rank = torch.cumsum(ni, dim=0) - ni
        w = wpad[torch.clamp(base + rank, max=total_words)]
        x = torch.where(need, ((x << 16) | w) & _M32, x)
        base = base + ni.sum()
    return out.reshape(-1), base


def hist256_plain(data: torch.Tensor) -> torch.Tensor:
    """The 256 counts of the bytes of an (n,) uint8 CPU tensor, int64: the
    plain version of ``fq_hist256`` (``csrc/hist256.cu``, which replaces
    the JAX runtime's ``fq_hist256``)."""
    return torch.bincount(data, minlength=256)


def histogram(data: torch.Tensor) -> np.ndarray:
    """The (256,) int64 host counts of a uint8 tensor, counted where it lies
    (``fq_hist256`` on the card, :func:`hist256_plain` on the CPU)."""
    from . import cuda_kernels

    return cuda_kernels.hist256(data).cpu().numpy()


# ---------------------------------------------------------------------------
# Host-facing stream API
# ---------------------------------------------------------------------------


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, np.uint8)
    return data


def encode_stream(
    data: bytes | np.ndarray, lanes: int | None = None, device=None,
    view: torch.Tensor | None = None, hist: np.ndarray | None = None,
) -> bytes:
    """rANS-encode one byte stream on ``device`` (default: the CUDA card).

    ``view`` and ``hist``: the same bytes already on ``device`` and their
    (256,) counts (the v3 pick's estimate made both); given together, the
    stream is neither uploaded nor counted again."""
    dev = resolve_device(device)
    raw = _as_u8(data)
    n = len(raw)
    if (view is None) != (hist is None):
        raise ValueError("view and hist come together")
    if view is not None and (view.numel() != n or np.shape(hist) != (256,)):
        raise ValueError(f"view: {view.numel()} bytes for a stream of {n}, "
                         f"hist of shape {np.shape(hist)}")
    if n == 0:
        return struct.pack(HEADER_FMT, 0, 0)
    N = lanes or _pick_lanes(n)
    if N & (N - 1) or not 0 < N <= MAX_LANES:
        raise ValueError(f"lanes must be a power of two up to {MAX_LANES}")
    steps = -(-n // N)

    if view is None:
        # the table from the copy the encode reads: the stream goes up once
        view = to_device(dev, raw)
        hist = histogram(view)
    else:
        hist = np.array(hist, dtype=np.int64)
    pad_sym = int(np.argmax(hist))  # before the padding is counted
    hist[pad_sym] += steps * N - n
    freq = normalize_freqs(hist)
    return assemble_payload(
        n, N, freq, *fetch_encoded(launch_encode(dev, view, N, pad_sym, freq))
    )


def launch_encode(
    dev: torch.device, raw, lanes: int, pad_sym: int,
    freq: np.ndarray,
):
    """Enqueue the encode and word compaction of ``raw`` (host bytes, or a
    uint8 tensor on ``dev`` at any byte offset) with a given table
    (``freq`` (256,) summing to PROB_SCALE, the counts of the ``pad_sym``
    cells that fill the last row included) on ``dev``'s current stream. Returns the device tensors that
    :func:`fetch_encoded` reads."""
    from . import cuda_kernels

    steps = -(-len(raw) // lanes)
    freq_cum = np.stack(
        [freq.astype(np.int32), cumulative(freq).astype(np.int32)]
    )
    if isinstance(raw, torch.Tensor):
        if raw.device.type == "cuda":  # made on another stream, read on this one
            raw.record_stream(torch.cuda.current_stream(raw.device))
            if raw.data_ptr() % 16:  # the encode stages 16-byte units: an aligned copy
                raw = raw.clone()
    else:
        raw = to_device(dev, raw)
    words, flags, states = cuda_kernels.rans_encode(
        raw, steps, lanes, pad_sym, to_device(dev, freq_cum)
    )
    flat, total = cuda_kernels.rans_compact(words, flags)
    return flat, total, states


def fetch_encoded(handles) -> tuple[np.ndarray, np.ndarray]:
    """Wait for :func:`launch_encode`'s work and copy back ``(states u32,
    words u16)``."""
    flat, total, states = handles
    total_h = int(total.item())
    words_h = flat[:total_h].cpu().numpy().view(np.uint16)
    return states.cpu().numpy().view(np.uint32), words_h


def assemble_payload(
    n: int, lanes: int, freq: np.ndarray, states: np.ndarray,
    words: np.ndarray,
) -> bytes:
    out = bytearray()
    out += struct.pack(HEADER_FMT, n, lanes.bit_length() - 1)
    out += freq.astype("<u2").tobytes()
    out += states.astype("<u4").tobytes()
    out += struct.pack("<I", len(words))
    out += words.astype("<u2").tobytes()
    return bytes(out)


def decode_stream(payload: bytes | np.ndarray, device=None) -> bytes:
    """Decode an rANS stream produced by :func:`encode_stream` on
    ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    buf = _as_u8(payload)
    hdr_size = struct.calcsize(HEADER_FMT)
    if len(buf) < hdr_size:
        raise RansError("truncated rANS stream header")
    raw_len, lanes_log2 = struct.unpack(HEADER_FMT, buf[:hdr_size].tobytes())
    if raw_len == 0:
        return b""
    N = 1 << lanes_log2

    off = hdr_size
    need = 512 + 4 * N + 4
    if len(buf) < off + need:
        raise RansError("truncated rANS stream tables")
    freq = buf[off : off + 512].view("<u2").astype(np.uint16)
    off += 512
    states = buf[off : off + 4 * N].view("<u4").astype(np.uint32)
    off += 4 * N
    (total_words,) = struct.unpack("<I", buf[off : off + 4].tobytes())
    off += 4
    if len(buf) < off + 2 * total_words:
        raise RansError("truncated rANS stream words")
    words = buf[off : off + 2 * total_words].view("<u2")

    if int(freq.astype(np.int64).sum()) != PROB_SCALE:
        raise RansError("invalid rANS frequency table")
    if N > MAX_LANES:
        raise RansError("unsupported rANS lane count")

    return fetch_decoded(
        launch_decode(dev, words, states, freq, raw_len, N), raw_len,
        total_words,
    )


def launch_decode(
    dev: torch.device, words: np.ndarray, states: np.ndarray,
    freq: np.ndarray, raw_len: int, lanes: int,
):
    """Enqueue the decode of ``raw_len`` symbols with a given table on
    ``dev``'s current stream. Returns what :func:`fetch_decoded` reads."""
    from . import cuda_kernels

    return cuda_kernels.rans_decode(
        to_device(dev, words.astype("<u2").view(np.int16)),
        to_device(dev, states.view(np.int32)),
        to_device(dev, pack_slot_table(freq).view(np.int32)),
        -(-raw_len // lanes),
        lanes,
    )


def fetch_decoded(handles, raw_len: int, total_words: int) -> bytes:
    out, consumed = handles
    # a sound stream uses up exactly the words it carries
    if int(consumed.item()) != total_words:
        raise RansError("corrupted rANS stream data")
    return out[:raw_len].cpu().numpy().tobytes()
