"""One block per device: the dense and entropy stages over a list of devices.

The port of ``fastqpacker_tpu/parallel/mesh.py``. There a mesh is a 1-D
``jax.sharding.Mesh`` and a group of D blocks or streams is one ``shard_map``
program; here a mesh is a **list of** ``torch.device`` of length D, and a group
is one worker thread per CUDA entry of the list (:func:`for_each_device`), each
preparing its entry's host arrays and launching the kernels of
:mod:`..ops.cuda_kernels` on its own CUDA stream of its device
(``fq_dense_encode`` / ``fq_dense_decode``, ``fq_rans_encode`` +
``fq_rans_compact``, ``fq_rans_decode``, ``fq_wctx_encode`` +
``fq_rans_compact``, ``fq_wctx_decode``). A device may stand in the list more
than once: it then gets several threads and several streams. All of it runs in
one process, so the in-program ``all_gather`` of the JAX programs is D scalars
copied to the host, and their exclusive prefix is taken there (int64 where
JAX's were int32; the values agree below 2 GiB per group). The multi-process
exchange is :mod:`.multihost`'s.

What a group shares is on the wire and is kept exactly: one rANS frequency
table and lane count per group of order-0 streams, one context order and
lane count per group of context-coded streams. A container written through
a mesh of D devices therefore depends on D.

Not carried: ``entropy_encode_sharded_raw``, ``wctx_encode_sharded`` and
``wctx_decode_sharded`` emit the TPU's layouts (uncompacted emits with an emit
bitmask for host compaction, int8 table planes). Their wire is computed on the
card by :func:`entropy_encode_streams`, :func:`wctx_encode_streams` and
:func:`wctx_decode_streams`, which compact on the device.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops import cuda_kernels
from ..ops import device as devops
from ..ops import rans, wctx
from ..ops import reference as refops

ENTROPY_LANES = 256


def make_mesh(n_devices: Optional[int] = None, device=None) -> list[torch.device]:
    """The device list of a mesh. ``device="cuda"`` (the default) takes the
    cards there are, or the first ``n_devices`` of them, and raises when
    asked for more; a card named with its index (``"cuda:1"``) starts the
    list at that card. ``device="cpu"`` gives ``n_devices`` (default 1) CPU
    entries, on which the kernels' plain versions run."""
    dev = devops.resolve_device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    if dev.type == "cpu":
        return [dev] * (n_devices or 1)
    first = dev.index or 0
    have = torch.cuda.device_count() - first
    n = have if n_devices is None else n_devices
    if not 0 < n <= have:
        where = f" from cuda:{first}" if first else ""
        raise ValueError(f"asked for {n} CUDA devices{where}, {have} present")
    return [torch.device("cuda", first + i) for i in range(n)]


def _resolve_mesh(mesh) -> list[torch.device]:
    return list(mesh) if mesh is not None else make_mesh()


def _pow2ceil(x: int, lo: int) -> int:
    return max(lo, 1 << max(x - 1, 0).bit_length())


def _pick_smax(steps: int) -> int:
    s = 256
    while s < steps:
        s *= 2
    return s


def for_each_device(mesh, fn: Callable, items, threads: Optional[bool] = None) -> list:
    """``fn(dev, item)`` for each device of ``mesh`` and its item (``None``
    items give ``None``), the results in list order.

    With ``threads`` (default: when the list has CUDA entries) each entry
    runs on a worker thread of its own, with that entry's card as its current
    device (the kernels' geometry queries read it) and ``fn`` on its own CUDA
    stream (:func:`..ops.device.worker_stream`), so the cards, or the streams
    of one card listed several times, prepare, launch and fetch at the same
    time. Without, the entries run one after another on the calling thread
    (the default for a CPU mesh: the plain coders only slow each other down
    under threads). An exception of any entry is raised after all have
    ended, the first in list order.

    The streams are joined both ways on the card: an entry's stream first
    waits for the work the caller's current stream had enqueued (its
    inputs), and the caller's current stream then waits for the work each
    entry enqueued, so its results can be read there (``.cpu()``) without
    a host wait for work that is still in flight."""
    items = list(items)
    if len(items) != len(mesh):
        raise ValueError(f"need {len(mesh)} items, got {len(items)}")
    # a card named without an index is the calling thread's current one
    cards = [
        torch.device("cuda", torch.cuda.current_device())
        if dev.type == "cuda" and dev.index is None else dev
        for dev in mesh
    ]
    inputs_ready = {dev: torch.cuda.current_stream(dev).record_event()
                    for dev in set(cards) if dev.type == "cuda"}

    def run(dev, item):
        if item is None:
            return None, None
        if dev.type != "cuda":
            return fn(dev, item), None
        with torch.cuda.device(dev), devops.worker_stream(dev):
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(inputs_ready[dev])
            return fn(dev, item), stream.record_event()

    live = sum(item is not None for item in items)
    if threads is None:
        threads = any(dev.type == "cuda" for dev in mesh)
    if not threads or live <= 1:
        out = [run(dev, item) for dev, item in zip(cards, items)]
    else:
        with ThreadPoolExecutor(max_workers=live) as pool:
            futures = [pool.submit(run, dev, item) for dev, item in zip(cards, items)]
            errors = [f.exception() for f in futures]
        for e in errors:
            if e is not None:
                raise e
        out = [f.result() for f in futures]
    for dev, (_, done) in zip(cards, out):
        if done is not None:
            torch.cuda.current_stream(dev).wait_event(done)
    return [result for result, _ in out]


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
# The dense codec, one shard of rows per device
# ---------------------------------------------------------------------------


def shard_rows(a: np.ndarray, mesh) -> list[torch.Tensor]:
    """Split the rows of a host ``(D*R, ...)`` array into D shards, each
    copied to its device of ``mesh``. Uneven batches are refused."""
    d = len(mesh)
    if a.shape[0] % d != 0:
        raise ValueError(f"batch rows {a.shape[0]} not divisible by {d} devices")
    r = a.shape[0] // d
    return for_each_device(
        mesh, lambda dev, k: devops.to_device(dev, a[k * r : (k + 1) * r]), range(d))


def gather_rows(shards) -> np.ndarray:
    """The shards of :func:`shard_rows` (or of any sharded output) back in
    one host array, in device order."""
    return np.concatenate([t.cpu().numpy() for t in shards])


def gather_encoded(encs: list[devops.DenseEncoded]) -> refops.EncodedArrays:
    """The shards of :func:`encode_sharded` as one set of host arrays."""
    return refops.EncodedArrays(*(gather_rows(field) for field in zip(*encs)))


def _exclusive_prefix(sizes) -> np.ndarray:
    sizes = np.asarray(sizes, np.int64)
    return np.cumsum(sizes) - sizes


def encode_sharded(
    seq: list[torch.Tensor],
    qual: list[torch.Tensor],
    lengths: list[torch.Tensor],
    *,
    qual_offset: int,
    mesh,
) -> tuple[list[devops.DenseEncoded], np.ndarray]:
    """The dense encode of one shard of R records per device, plus each
    shard's file offset. ``seq`` / ``qual``: (R, L) uint8 and ``lengths``:
    (R,) int32 per device of ``mesh``, each on its device (:func:`shard_rows`).

    Each shard runs ``fq_dense_encode`` on its device and sums its raw
    payload size there (packed bytes + quality bytes + 4 bytes per record,
    ``sum((len+3)//4) + sum(len) + 4*R``); the D sizes come to the host and
    their exclusive prefix is each shard's offset: where its block lands in
    the file (the ordered collector, compress.go:365-403). Returns one
    ``DenseEncoded`` per shard, on its device, and the (D,) int64 offsets."""
    mesh = _resolve_mesh(mesh)
    if not len(seq) == len(qual) == len(lengths) == len(mesh):
        raise ValueError(f"need one shard per device of {len(mesh)}")

    def encode(dev, k):
        enc = cuda_kernels.encode_arrays(seq[k], qual[k], lengths[k], qual_offset)
        n = lengths[k].to(torch.int64)
        size = ((n + 3) // 4).sum() + n.sum() + 4 * n.numel()
        return enc, int(size.item())

    out = for_each_device(mesh, encode, range(len(mesh)))
    return [enc for enc, _ in out], _exclusive_prefix([size for _, size in out])


def decode_sharded(
    packed: list[torch.Tensor],
    qual_delta: list[torch.Tensor],
    lengths: list[torch.Tensor],
    *,
    qual_offset: int,
    mesh,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The dense decode of each shard on its device (``fq_dense_decode``):
    (seq ASCII, qual ASCII) per shard, each on its device."""
    mesh = _resolve_mesh(mesh)
    if not len(packed) == len(qual_delta) == len(lengths) == len(mesh):
        raise ValueError(f"need one shard per device of {len(mesh)}")
    out = for_each_device(
        mesh,
        lambda dev, k: cuda_kernels.decode_arrays(
            packed[k], qual_delta[k], lengths[k], qual_offset),
        range(len(mesh)),
    )
    return [s for s, _ in out], [q for _, q in out]


def encode_blocks_parallel(
    seq: np.ndarray,
    qual: np.ndarray,
    lengths: np.ndarray,
    qual_offset: int,
    mesh=None,
) -> tuple[list[devops.DenseEncoded], np.ndarray]:
    """Host-facing helper: shard a host ``(D*R, L)`` batch over ``mesh``
    (default: every card) and run :func:`encode_sharded`."""
    mesh = _resolve_mesh(mesh)
    return encode_sharded(
        shard_rows(seq, mesh), shard_rows(qual, mesh),
        shard_rows(np.asarray(lengths, np.int32), mesh),
        qual_offset=qual_offset, mesh=mesh,
    )


# ---------------------------------------------------------------------------
# Order-0 rANS over a device list
# ---------------------------------------------------------------------------


def entropy_table(
    streams,
    pad_sym: int | None = None,
    raw_lens: np.ndarray | None = None,
    lanes: int = ENTROPY_LANES,
):
    """Group-shared rANS table over ``(D, M)`` per-device streams: a host
    array, or D uint8 tensors (stream ``i`` of ``raw_lens[i]`` bytes, or
    M), each counted where it lies (one ``fq_hist256`` a stream on a card;
    the counts are summed exactly on the host).

    The per-block pipeline builds a table per stream; the device-list
    pipeline shares one table per group (as the reference fixes the
    quality encoding from the first batch, compress.go:137-154). Lane
    padding symbols are included: with ``raw_lens`` given, each stream
    ``i`` pads only to ``ceil(raw_lens[i]/N)*N``; otherwise every stream
    pads to ``ceil(M/N)*N``. Returns (freq_cum (2, 256) u32, pad_sym).
    """
    if isinstance(streams, np.ndarray):
        streams = list(torch.from_numpy(np.ascontiguousarray(streams, np.uint8)))
    d = len(streams)
    m = max((t.numel() for t in streams), default=0)
    n_lanes = lanes
    if raw_lens is None:
        lens = np.full(d, m, np.int64)
        steps = -(-m // n_lanes)
        pad_count = (steps * n_lanes - m) * d
    else:
        lens = np.asarray(raw_lens, np.int64)
        coded = -(-lens // n_lanes) * n_lanes
        pad_count = int((coded - lens).sum())
    hist = np.zeros(256, np.int64)
    for i in range(d):
        if lens[i]:
            hist += rans.histogram(streams[i][: lens[i]])
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
    # each stream goes up to its device once: the table is counted there
    # (one fq_hist256 a stream) and the encode reads the same copy
    on_dev = for_each_device(mesh, devops.to_device, rows)
    freq_cum, pad_sym = entropy_table(on_dev, raw_lens=lens, lanes=N)
    freq = freq_cum[0].astype(np.uint16)

    launched = for_each_device(
        mesh, lambda dev, r: _Launched(dev, rans.launch_encode, r, N, pad_sym, freq),
        [r if len(r) else None for r in on_dev],
    )

    def finish() -> list[bytes]:
        fetched = for_each_device(
            mesh, lambda dev, job: job.fetch(rans.fetch_encoded), launched)
        return [
            empty if got is None else rans.assemble_payload(int(n), N, freq, *got)
            for got, n in zip(fetched, lens)
        ]

    return finish if async_result else finish()


class ShardedStreams(NamedTuple):
    """What :func:`entropy_encode_sharded` returns."""

    words: list[torch.Tensor]  # per shard (steps*N,) int16 on its device; [:total] valid
    states: list[torch.Tensor]  # per shard (N,) int32 on its device
    totals: np.ndarray  # (D,) int64 words per shard
    offsets: np.ndarray  # (D,) int64 exclusive prefix of ``totals``


def _raw_lens(raw_lens, d: int, m: int) -> np.ndarray:
    lens = np.full(d, m, np.int64) if raw_lens is None else np.asarray(raw_lens, np.int64)
    if len(lens) != d or (lens < 0).any() or (lens > m).any():
        raise ValueError(f"need {d} stream lengths in [0, {m}]")
    return lens


def entropy_encode_sharded(
    streams,
    freq_cum: np.ndarray,
    raw_lens: np.ndarray | None = None,
    *,
    mesh,
    pad_sym: int,
    m_per_shard: int,
    lanes: int = ENTROPY_LANES,
) -> ShardedStreams:
    """Per-shard interleaved-lane rANS encode with a shared table, and each
    shard's word offset: the entropy stage of the sharded compress step.

    ``streams``: a host (D, M) uint8 array or D (M,) uint8 tensors, one per
    device of ``mesh``; ``freq_cum``: (2, 256) from :func:`entropy_table`
    (the pad cells counted). Shard d codes ``ceil(raw_lens[d]/N)`` steps of
    its row (default M), as a standalone stream of that length would: the
    cells of those steps past M are ``pad_sym``, the row must be padded with
    it up to there. It runs ``fq_rans_encode`` and ``fq_rans_compact`` on its
    device; the D word totals come to the host, and their exclusive prefix
    is each shard's offset."""
    mesh = _resolve_mesh(mesh)
    d, n = len(mesh), lanes
    if n <= 0 or n & (n - 1):
        raise ValueError(f"lanes must be a power of two, got {n}")
    lens = _raw_lens(raw_lens, d, m_per_shard)
    fc = np.ascontiguousarray(freq_cum, np.uint32).astype(np.int32)
    if not 0 <= pad_sym <= 255:
        raise ValueError(f"pad_sym must be a byte, got {pad_sym}")

    def encode(dev, k):
        steps = -(-int(lens[k]) // n)
        if steps == 0:
            return (torch.zeros(0, dtype=torch.int16, device=dev),
                    torch.full((n,), rans.RANS_L, dtype=torch.int32, device=dev), 0)
        row = streams[k]
        row = row if isinstance(row, torch.Tensor) else devops.to_device(dev, row)
        words, flags, states = cuda_kernels.rans_encode(
            row[: min(m_per_shard, steps * n)].contiguous(), steps, n, pad_sym,
            devops.to_device(dev, fc))
        flat, total = cuda_kernels.rans_compact(words, flags)
        return flat, states, int(total.item())

    out = for_each_device(mesh, encode, range(d))
    totals = np.array([t for _, _, t in out], np.int64)
    return ShardedStreams([w for w, _, _ in out], [s for _, s, _ in out], totals,
                          _exclusive_prefix(totals))


def entropy_decode_sharded(
    words: list[torch.Tensor],
    states: list[torch.Tensor],
    freq_cum: np.ndarray,
    raw_lens: np.ndarray | None = None,
    *,
    mesh,
    m_per_shard: int,
    lanes: int = ENTROPY_LANES,
) -> list[torch.Tensor]:
    """Per-shard rANS decode with the shared table, the inverse of
    :func:`entropy_encode_sharded`: ``fq_rans_decode`` of
    ``ceil(raw_lens[d]/N)`` steps (default M) on each shard's device.
    Returns one (M,) uint8 tensor per shard; cells past a shard's coded
    steps are 0."""
    mesh = _resolve_mesh(mesh)
    d, n = len(mesh), lanes
    lens = _raw_lens(raw_lens, d, m_per_shard)
    freq = np.asarray(freq_cum)[0].astype(np.uint16)
    if int(freq.astype(np.int64).sum()) != rans.PROB_SCALE:
        raise rans.RansError("invalid rANS frequency table")
    slot_tab = rans.pack_slot_table(freq).view(np.int32)

    def decode(dev, k):
        out = torch.zeros(m_per_shard, dtype=torch.uint8, device=dev)
        steps = -(-int(lens[k]) // n)
        if steps:
            sym, _ = cuda_kernels.rans_decode(
                words[k], states[k], devops.to_device(dev, slot_tab), steps, n)
            m = min(m_per_shard, steps * n)
            out[:m] = sym[:m]
        return out

    return for_each_device(mesh, decode, range(d))


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

    def decode(dev, p):
        raw_len, _, _, states, words = p
        return _Launched(dev, rans.launch_decode, words, states, freq, raw_len, N).fetch(
            rans.fetch_decoded, raw_len, len(words))

    return [b"" if out is None else out for out in for_each_device(mesh, decode, parsed)]


# ---------------------------------------------------------------------------
# Context-modeled entropy stage (ops/wctx.py) over a device list — the
# device coder that keeps the v3 context-model ratio wins on the mesh path
# ---------------------------------------------------------------------------


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
    where ``flat_syms`` are the prepared symbols (a host array, or the
    :class:`..ops.ctxprep.Symbols` of a prepare pass, best on the entry's
    device) and ``data_hist`` is the (C, 256) histogram over data positions
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

    def prep_and_launch(dev, job):
        # the lane layout and tables on the host, the matrices on ``dev``
        p = wctx.prepare_encode(dev, job[0], job[1], job[2], model, order, N)
        launched = _Launched(
            dev, wctx.launch_encode, p.pop("sym_idx"), p.pop("ctxm"), p["seg"],
            p["freq_p"],
        )  # the matrices are on their device now
        return p, launched

    started = for_each_device(mesh, prep_and_launch, jobs)

    def finish():
        def fetch(dev, pl):
            p, launched = pl
            words, states = launched.fetch(wctx.fetch_encoded)
            return wctx.assemble_payload(
                model, order, N, p["n"], p["present"], p["freq_p"], states, words)

        return for_each_device(mesh, fetch, started)

    return finish if async_result else finish()


def wctx_decode_streams(
    payloads: list,
    lengths_list: list,
    mesh=None,
    wire: bool = False,
) -> list | None:
    """Batch-decode one TAG_WCTX payload per device — the decode twin of
    :func:`wctx_encode_streams`. Returns flat unpacked symbol arrays (with
    ``wire``, each stream's v3 wire bytes instead: packed rows or quality
    deltas, built on its device), or ``None`` when the group is not
    batchable (mixed models/orders/lane counts — fall back to per-stream
    decoding). ``None`` payload slots are skipped."""
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

    def decode(dev, job):
        p, lens = job
        if p["total"] == 0:
            return np.zeros(0, np.uint8)
        output = wctx.wire_output(p) if wire else wctx.UNLAYOUT_FLAT
        return _Launched(dev, wctx.launch_decode, p, lens, output).fetch(wctx.fetch_decoded)

    return for_each_device(
        mesh, decode, [None if p is None else (p, lens) for p, lens in zip(parsed, lens_l)])
