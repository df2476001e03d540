"""One block per device: the entropy stage over a list of devices.

The port of the stream-level functions of ``fastqpacker_tpu/parallel/mesh.py``.
There a mesh is a 1-D ``jax.sharding.Mesh`` and a group of D streams is one
``shard_map`` program; here a mesh is a **list of** ``torch.device`` of
length D, and a group is one launch per device of the list, each on that
device's CUDA stream, of the kernels of :mod:`..ops.cuda_kernels`
(``fq_rans_encode`` + ``fq_rans_compact``, ``fq_rans_decode``,
``fq_wctx_encode`` + ``fq_rans_compact``, ``fq_wctx_decode``). A device may
stand in the list more than once. All of it runs in one process; the
in-program ``all_gather`` of word counts of the JAX programs produces
offsets that the stream APIs discard, so no collective is needed here.

What a group shares is on the wire and is kept exactly: one rANS frequency
table and lane count per group of order-0 streams, one context order and
lane count per group of context-coded streams. A container written through
a mesh of D devices therefore depends on D.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from ..ops import device as devops
from ..ops import rans, wctx

ENTROPY_LANES = 256


def make_mesh(n_devices: Optional[int] = None, device=None) -> list[torch.device]:
    """The device list of a mesh. ``device="cuda"`` (the default) takes the
    cards there are, or the first ``n_devices`` of them, and raises when
    asked for more; ``device="cpu"`` gives ``n_devices`` (default 1) CPU
    entries, on which the kernels' plain versions run."""
    dev = devops.resolve_device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    if dev.type == "cpu":
        return [dev] * (n_devices or 1)
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n > have:
        raise ValueError(f"asked for {n} CUDA devices, {have} present")
    return [torch.device("cuda", i) for i in range(n)]


def _resolve_mesh(mesh) -> list[torch.device]:
    return list(mesh) if mesh is not None else make_mesh()


def _pow2ceil(x: int, lo: int) -> int:
    return max(lo, 1 << max(x - 1, 0).bit_length())


def _pick_smax(steps: int) -> int:
    s = 256
    while s < steps:
        s *= 2
    return s


class _Launched:
    """Work enqueued on one device's stream: its handles, and the event
    that says the device has done it."""

    def __init__(self, dev: torch.device, fn, *args):
        self.dev = dev
        with devops.worker_stream(dev):
            self.handles = fn(dev, *args)
            self.event = None
            if dev.type == "cuda":
                self.event = torch.cuda.Event()
                self.event.record()

    def fetch(self, fn, *args):
        if self.event is not None:
            self.event.synchronize()
        with devops.worker_stream(self.dev):
            return fn(self.handles, *args)


# ---------------------------------------------------------------------------
# Order-0 rANS over a device list
# ---------------------------------------------------------------------------


def entropy_table(
    streams: np.ndarray,
    pad_sym: int | None = None,
    raw_lens: np.ndarray | None = None,
    lanes: int = ENTROPY_LANES,
):
    """Group-shared rANS table over ``(D, M)`` per-device streams.

    The per-block pipeline builds a table per stream; the device-list
    pipeline shares one table per group (as the reference fixes the
    quality encoding from the first batch, compress.go:137-154). Lane
    padding symbols are included: with ``raw_lens`` given, each stream
    ``i`` pads only to ``ceil(raw_lens[i]/N)*N``; otherwise every stream
    pads to ``ceil(M/N)*N``. Returns (freq_cum (2, 256) u32, pad_sym).
    """
    d, m = streams.shape
    n_lanes = lanes
    if raw_lens is None:
        steps = -(-m // n_lanes)
        pad_count = (steps * n_lanes - m) * d
        hist = np.bincount(
            streams.reshape(-1), minlength=256
        ).astype(np.int64)
    else:
        lens = np.asarray(raw_lens, np.int64)
        coded = -(-lens // n_lanes) * n_lanes
        pad_count = int((coded - lens).sum())
        hist = np.zeros(256, np.int64)
        for i in range(d):
            hist += np.bincount(streams[i, : lens[i]], minlength=256)
    if pad_sym is None:
        pad_sym = int(np.argmax(hist))
    hist[pad_sym] += pad_count
    freq = rans.normalize_freqs(hist)
    freq_cum = np.stack(
        [freq.astype(np.uint32), rans.cumulative(freq).astype(np.uint32)]
    )
    return freq_cum, pad_sym


def entropy_encode_streams(
    streams: list[bytes | np.ndarray],
    mesh=None,
    async_result: bool = False,
):
    """Encode one byte stream per device with the order-0 rANS kernels and
    return **standalone wire payloads** (the exact :mod:`..ops.rans`
    stream format), each decodable independently by ``rans.decode_stream``.
    This is the entry the v3 mesh pipeline writes TAG_RANS streams through
    (pipeline/meshpipe.py).

    The group shares one frequency table (computed here, embedded in every
    stream) and one lane count; each stream codes ``ceil(len/N)`` steps of
    its own. Empty streams come back as the canonical empty payload.

    ``async_result=True`` returns a zero-argument *finisher* instead of
    the payloads: the kernels are launched, but nothing is synchronised or
    copied back until the finisher runs, so the caller overlaps the
    device round with host work.
    """
    mesh = _resolve_mesh(mesh)
    d = len(mesh)
    if len(streams) != d:
        raise ValueError(f"need {d} streams (one per device), got {len(streams)}")
    rows = [
        np.frombuffer(s, np.uint8) if isinstance(s, (bytes, bytearray)) else s
        for s in streams
    ]
    lens = np.array([len(r) for r in rows], np.int32)
    empty = struct.pack(rans.HEADER_FMT, 0, 0)
    if int(lens.max(initial=0)) == 0:
        res = [empty] * d
        return (lambda: res) if async_result else res

    # lane count scales with the longest stream like rans._pick_lanes
    N = rans._pick_lanes(int(lens.max()))
    batch = np.zeros((d, int(lens.max())), np.uint8)
    for i, r in enumerate(rows):
        batch[i, : len(r)] = r
    freq_cum, pad_sym = entropy_table(batch, raw_lens=lens, lanes=N)
    del batch
    freq = freq_cum[0].astype(np.uint16)

    launched = [
        _Launched(dev, rans.launch_encode, r, N, pad_sym, freq)
        if len(r) else None
        for dev, r in zip(mesh, rows)
    ]

    def finish() -> list[bytes]:
        return [
            empty if job is None else rans.assemble_payload(
                int(n), N, freq, *job.fetch(rans.fetch_encoded)
            )
            for job, n in zip(launched, lens)
        ]

    return finish if async_result else finish()


def entropy_decode_streams(
    payloads: list[bytes],
    mesh=None,
) -> list[bytes] | None:
    """Batch-decode one standard rANS wire payload per device — the decode
    twin of :func:`entropy_encode_streams`. Returns the decoded byte
    streams, or ``None`` when the group is not batchable (mixed lane
    counts or frequency tables — e.g. containers written by the per-block
    pipeline, whose tables are per-stream): the caller falls back to
    per-stream decoding. Empty payloads decode to empty bytes and don't
    affect batchability.
    """
    mesh = _resolve_mesh(mesh)
    d = len(mesh)
    if len(payloads) != d:
        raise ValueError(f"need {d} payloads, got {len(payloads)}")
    hdr_size = struct.calcsize(rans.HEADER_FMT)
    parsed = []
    lanes_set = set()
    freq_ref: bytes | None = None
    for p in payloads:
        buf = np.frombuffer(p, np.uint8) if not isinstance(p, np.ndarray) else p
        if len(buf) < hdr_size:
            raise rans.RansError("truncated rANS stream header")
        raw_len, lanes_log2 = struct.unpack(
            rans.HEADER_FMT, bytes(buf[:hdr_size])
        )
        if raw_len == 0:
            parsed.append(None)
            continue
        N = 1 << lanes_log2
        off = hdr_size
        if len(buf) < off + 512 + 4 * N + 4:
            raise rans.RansError("truncated rANS stream tables")
        freq_bytes = bytes(buf[off : off + 512])
        off += 512
        states = buf[off : off + 4 * N].view("<u4").astype(np.uint32)
        off += 4 * N
        (total,) = struct.unpack("<I", bytes(buf[off : off + 4]))
        off += 4
        if len(buf) < off + 2 * total:
            raise rans.RansError("truncated rANS stream words")
        words = buf[off : off + 2 * total].view("<u2")
        parsed.append((raw_len, N, freq_bytes, states, words))
        lanes_set.add(N)
        if freq_ref is None:
            freq_ref = freq_bytes
        elif freq_bytes != freq_ref:
            return None  # mixed tables: not batchable
    if freq_ref is None:  # all empty
        return [b""] * d
    if len(lanes_set) != 1:
        return None
    if max(p[0] for p in parsed if p) > (1 << 30):
        # hostile declared lengths: the per-stream path allocates per
        # stream with its own typed failures
        return None
    N = lanes_set.pop()
    if N > rans.MAX_LANES:
        return None  # the per-stream path refuses it by name
    freq = np.frombuffer(freq_ref, "<u2").astype(np.uint16)
    if int(freq.astype(np.int64).sum()) != rans.PROB_SCALE:
        raise rans.RansError("invalid rANS frequency table")

    m = _pow2ceil(max(p[0] for p in parsed if p), N)
    w_cap = -(-m // N) * N + N
    if any(p is not None and len(p[4]) > w_cap for p in parsed):
        return None  # hostile word count beyond plausible; fall back

    launched = [
        None if p is None
        else _Launched(dev, rans.launch_decode, p[4], p[3], freq, p[0], N)
        for dev, p in zip(mesh, parsed)
    ]
    return [
        b"" if job is None
        else job.fetch(rans.fetch_decoded, p[0], len(p[4]))
        for job, p in zip(launched, parsed)
    ]


# ---------------------------------------------------------------------------
# Context-modeled entropy stage (ops/wctx.py) over a device list — the
# device coder that keeps the v3 context-model ratio wins on the mesh path
# ---------------------------------------------------------------------------


def _wctx_block_prep(syms, lengths, hist, model, order, N):
    """Host-side per-block prep for the wctx encode: lane layout,
    matrices, tables. ``hist``: (C, 256) DATA histogram — used as-is: pad
    cells are skipped by the coders, so the tables are exactly the host
    prepare histograms. Returns a dict of the pieces."""
    lengths = np.asarray(lengths, np.int64)
    sb, S, seg = wctx.stream_layout(lengths, N)
    hist = hist.astype(np.int64)
    pad_sym = int(np.argmax(hist.sum(axis=0)))
    present = np.flatnonzero(hist.sum(axis=0) > 0)
    freq_full = wctx.normalize_tables(hist)
    freq_p = np.ascontiguousarray(freq_full[:, present])
    startm = wctx.start_matrix(lengths, sb, S)
    symm = wctx.to_matrix(np.asarray(syms, np.uint8), sb, S, pad_sym)
    ctxm = wctx.context_matrix(symm, startm, model, order)
    sym_idx = wctx._sym_to_idx(present)[symm]
    return {
        "sb": sb, "S": S, "n": len(syms), "npres": len(present), "seg": seg,
        "present": present, "freq_p": freq_p,
        "sym_idx": sym_idx, "ctxm": ctxm,
    }


def wctx_encode_streams(
    jobs: list,
    model: int,
    order: int,
    mesh=None,
    lanes: int | None = None,
    async_result: bool = False,
):
    """Encode one unpacked symbol stream per device with the context
    coder; returns standalone TAG_WCTX wire payloads (each independently
    decodable by ``ops/wctx.decode_stream``).

    ``jobs``: up to D entries of ``(flat_syms, lengths, data_hist)``
    where ``data_hist`` is the (C, 256) histogram over data positions
    (sctx/qualctx prepare output reshaped); ``None`` entries are skipped
    (their payload comes back as ``None``).

    ``async_result=True`` returns a zero-argument finisher (launch now,
    synchronise/fetch/assemble later) — see entropy_encode_streams.
    """
    mesh = _resolve_mesh(mesh)
    d = len(mesh)
    if len(jobs) > d:
        raise ValueError(f"need <= {d} jobs, got {len(jobs)}")
    jobs = list(jobs) + [None] * (d - len(jobs))
    wctx.model_geometry(model, order)  # validates model/order
    max_n = max((len(j[0]) for j in jobs if j), default=0)
    if max_n == 0:
        res = [None] * d
        return (lambda: res) if async_result else res
    # one lane count per group: the most ratio-constrained block decides
    N = lanes or min(
        wctx.pick_lanes_for(j[2], len(j[0])) for j in jobs if j
    )

    preps = [
        _wctx_block_prep(j[0], j[1], j[2], model, order, N) if j else None
        for j in jobs
    ]
    launched = [
        None if p is None else _Launched(
            dev, wctx.launch_encode, p["sym_idx"], p["ctxm"], p["seg"],
            p["freq_p"],
        )
        for dev, p in zip(mesh, preps)
    ]
    for p in preps:
        if p is not None:  # the matrices are on their device now
            del p["sym_idx"], p["ctxm"]

    def finish():
        out: list[bytes | None] = []
        for job, p in zip(launched, preps):
            if p is None:
                out.append(None)
                continue
            words, states = job.fetch(wctx.fetch_encoded)
            out.append(wctx.assemble_payload(
                model, order, N, p["n"], p["present"], p["freq_p"],
                states, words,
            ))
        return out

    return finish if async_result else finish()


def wctx_decode_streams(
    payloads: list,
    lengths_list: list,
    mesh=None,
) -> list | None:
    """Batch-decode one TAG_WCTX payload per device — the decode twin of
    :func:`wctx_encode_streams`. Returns flat unpacked symbol arrays, or
    ``None`` when the group is not batchable (mixed models/orders/lane
    counts — fall back to per-stream decoding). ``None`` payload slots
    are skipped."""
    mesh = _resolve_mesh(mesh)
    d = len(mesh)
    if len(payloads) > d:
        raise ValueError(f"need <= {d} payloads, got {len(payloads)}")
    payloads = list(payloads) + [None] * (d - len(payloads))
    lengths_list = list(lengths_list) + [None] * (d - len(lengths_list))
    parsed = [
        wctx.parse_stream(p) if p is not None else None for p in payloads
    ]
    live = [p for p in parsed if p]
    if not live:
        return [None] * d
    keys = {(p["model"], p["order"], p["N"]) for p in live}
    if len(keys) != 1:
        return None
    _, _, N = keys.pop()
    lens_l = []
    steps = []
    for p, lens in zip(parsed, lengths_list):
        if p is None:
            lens_l.append(None)
            continue
        lens = np.asarray(lens, np.int64)
        if int(lens.sum()) != p["total"]:
            raise wctx.WctxError(
                "wctx total does not match record lengths"
            )
        if p["total"] > (1 << 30):
            return None  # hostile declared size: per-stream fallback
        lens_l.append(lens)
        steps.append(wctx.lane_bounds(lens, N)[1])
    w_cap = _pick_smax(max(steps)) * N + N
    if any(p is not None and len(p["words"]) > w_cap for p in parsed):
        return None  # hostile word count: per-stream fallback

    launched = [
        None if p is None or p["total"] == 0
        else _Launched(dev, wctx.launch_decode, p, lens)
        for dev, p, lens in zip(mesh, parsed, lens_l)
    ]
    res = []
    for job, p in zip(launched, parsed):
        if p is None:
            res.append(None)
        elif job is None:
            res.append(np.zeros(0, np.uint8))
        else:
            res.append(job.fetch(wctx.fetch_decoded))
    return res
