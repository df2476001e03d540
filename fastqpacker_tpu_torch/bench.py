"""The port's benchmark: one metric of seeded synthetic FASTQ, one JSON line.

The PyTorch/CUDA twin of the repo's ``bench.py`` (which drives the JAX
package): the same 13 metrics, the same metric names, units and rounding in
the JSON line ``{"metric", "value", "unit", "vs_baseline"}`` on stdout, and
the same fixtures (``synth_fastq``, byte-equal to ``bench.synth_fastq``).
Diagnostics go to stderr: the card's name and power limit (``nvidia-smi``),
the estimator's windows, a roofline line for the dense kernels, and the
kernel launches of the run.

Everything runs on the CUDA card; ``--cpu`` runs the kernels' plain PyTorch
versions instead. Without a card and without ``--cpu`` it raises before any
JSON line: there is no fallback.

- ``compress``, ``compress-v3``, ``decompress``, ``decompress-v3``: the
  device pipeline file to file (``pipeline/device.py``), best wall time of
  :func:`phase_robust_best`;
- ``kernel``, ``decode-kernel``: ``fq_dense_encode`` / ``fq_dense_decode``
  at 65,536 x 152, device-resident, timed by CUDA events;
- ``mesh-entropy``, ``mesh-entropy-decode``: the order-0 rANS kernels
  (encode and word compaction, decode) on up to 16 / 64 MiB;
- ``wctx-entropy``, ``wctx-entropy-decode``: the context-rANS kernels on
  the quality model, order 0, up to 64 MiB;
- ``mesh-e2e``: ``compress_mesh`` on one card, the context-model corpus;
- ``micro``: the block stages (parse: the text's copy to the card and its
  record scan there; stream build; zstd on the host);
- ``ratio``: the ``fqz-v3-max`` model's compression ratio, round trip
  checked.

Usage: python -m fastqpacker_tpu_torch.bench [--mb 128] [--metric M]
       [--repeats 5] [--fixture iid|genomic] [--cpu] [--profile DIR]
(or ``fqpack bench ...`` through ``python -m fastqpacker_tpu_torch.cli.fqpack``).
"""

from __future__ import annotations

import argparse
import functools
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# vs_baseline divides by the Go fqpack's published CPU rates (its README,
# BASELINE.md): 2,967.3 MB/s compress on an M4 MacBook Pro, and 8.9 GB
# decompressed in 2.95 s. They are not the card's numbers.
BASELINE_COMPRESS_MBPS = 2967.3
BASELINE_DECOMPRESS_MBPS = 9011.2 / 2.95
BASELINE_RATIO = 3.25  # the Go fqpack's published ratio on ERR532393

# NVIDIA H100 SXM published memory rate; the dense kernels are bound by it
HBM_BYTES_PER_S = 3.35e12

METRICS = (
    "compress", "compress-v3", "decompress", "decompress-v3",
    "kernel",
    "decode-kernel",
    "mesh-entropy", "mesh-entropy-decode", "mesh-e2e",
    "wctx-entropy", "wctx-entropy-decode", "micro", "ratio",
)
# the metrics that read the --mb fixture (the others make their own inputs)
_FIXTURE_METRICS = ("compress", "compress-v3", "decompress", "decompress-v3",
                    "micro", "ratio")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

# order-1 transition probabilities of the markov corpus, row = previous base
_MARKOV_PROBS = np.array(
    [
        [0.17, 0.45, 0.25, 0.13],
        [0.13, 0.17, 0.45, 0.25],
        [0.45, 0.25, 0.13, 0.17],
        [0.25, 0.13, 0.17, 0.45],
    ]
)
_SPLITMIX_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SPLITMIX_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_M2 = np.uint64(0x94D049BB133111EB)
_IDENTITY_MAP = 0b11100100  # the map p -> p, 2 bits per start state


def _splitmix16(seed: int, start: int, count: int) -> np.ndarray:
    """The low 16 bits of SplitMix64 draws ``start+1 .. start+count`` from
    ``seed``: the i-th state is seed + i * gamma (mod 2^64), then mixed."""
    z = np.arange(start + 1, start + count + 1, dtype=np.uint64)
    z *= _SPLITMIX_GAMMA
    z += np.uint64(seed)
    z ^= z >> np.uint64(30)
    z *= _SPLITMIX_M1
    z ^= z >> np.uint64(27)
    z *= _SPLITMIX_M2
    z ^= z >> np.uint64(31)
    return z.astype(np.uint16)


def markov_genome(n: int, prob16: np.ndarray, seed: int) -> np.ndarray:
    """(n,) base codes of an order-1 Markov chain from base 0, each step
    drawn from the low 16 bits of a SplitMix64 stream (``prob16``: (4, 4)
    rows in 1/65536 units): the C++ runtime's ``fq_markov_gen``, which the
    JAX package's ``bench.synth_fastq`` uses, vectorized.

    Each draw is a map from the 4 previous states to the next, coded in a
    byte. The n maps are cut into chunks; one pass composes each chunk's
    maps for all 4 start states at once, the chunk starts are resolved in
    order, and a second pass replays the chunks from their starts."""
    cum = np.cumsum(prob16.astype(np.int64), axis=1)
    cum[:, 3] = 65536
    u = np.arange(65536, dtype=np.int64)
    nxt = (u[:, None, None] >= cum[None, :, :3]).sum(axis=2)  # (u, prev) -> next
    map_of_u = (nxt << (2 * np.arange(4))).sum(axis=1).astype(np.uint8)
    codes = np.arange(256)
    apply = ((codes[:, None] >> (2 * np.arange(4))) & 3).astype(np.uint8)  # (map, p)
    compose = np.zeros((256, 256), np.uint8)  # (first, then) -> composed map
    for p in range(4):
        compose |= apply[codes[None, :], apply[codes[:, None], p]] << np.uint8(2 * p)

    k = max(1, math.isqrt(n))
    chunks = -(-n // k)
    maps = np.full(chunks * k, _IDENTITY_MAP, np.uint8)
    slab = 1 << 22
    for off in range(0, n, slab):
        cnt = min(slab, n - off)
        maps[off : off + cnt] = map_of_u[_splitmix16(seed, off, cnt)]
    maps = np.ascontiguousarray(maps.reshape(chunks, k).T)  # (step, chunk)

    whole = np.full(chunks, _IDENTITY_MAP, np.uint8)
    for row in maps:
        whole = compose[whole, row]
    starts = np.empty(chunks, np.uint8)
    state = 0
    for c in range(chunks):
        starts[c] = state
        state = int(apply[whole[c], state])
    out = np.empty((k, chunks), np.uint8)
    state = starts
    for j, row in enumerate(maps):
        state = apply[row, state]
        out[j] = state
    return np.ascontiguousarray(out.T).reshape(-1)[:n]


def synth_fastq(
    target_mb: int,
    read_len: int = 151,
    seed: int = 42,
    genomic: bool = False,
    markov: bool = False,
) -> bytes:
    """Realistic-shape Illumina FASTQ, byte-equal to ``bench.synth_fastq``
    for the same arguments (its ``markov`` corpus as it is where the JAX
    package's C++ runtime is built).

    ``genomic=True`` samples reads from one synthetic genome at 15x
    coverage instead of IID bases (block-local redundancy, which the v3
    ``TAG_SLDM`` candidate exists for). ``markov=True`` is the
    context-model corpus: an order-1 Markov genome (~1.84 bits/base) cut
    into disjoint reads, with per-record random-walk qualities, on which
    the context models win and LZ finds nothing."""
    rng = np.random.default_rng(seed)
    rec_bytes = 38 + 2 * (read_len + 1) + 2
    n = (target_mb << 20) // rec_bytes

    bases = np.frombuffer(b"ACGT", np.uint8)
    if markov:
        glen = max(n * read_len, read_len + 1)  # ~1x coverage
        prob16 = np.round(_MARKOV_PROBS * 65536).astype(np.uint16)
        genome = markov_genome(glen, prob16, seed)
        # disjoint shuffled partition: exactly 1x coverage, no read overlap
        starts = rng.permutation(n).astype(np.int64) * read_len
        codes = genome[starts[:, None] + np.arange(read_len)]
        ne = max(1, n * read_len // 500)
        codes[rng.integers(0, n, ne), rng.integers(0, read_len, ne)] = (
            rng.integers(0, 4, ne).astype(np.uint8)
        )
        seq = bases[codes]
        nn = max(1, n * read_len // 1000)
        seq[rng.integers(0, n, nn), rng.integers(0, read_len, nn)] = ord("N")
        qsteps = rng.integers(-2, 3, size=(n, read_len)).astype(np.int32)
        qual = np.clip(
            33 + 30 + np.cumsum(qsteps, axis=1) // 3, 33, 74
        ).astype(np.uint8)
        return _assemble_fastq(n, read_len, seq, qual)
    if genomic:
        coverage = 15
        glen = max(n * read_len // coverage, read_len + 1)
        genome = rng.integers(0, 4, size=glen).astype(np.uint8)
        starts = rng.integers(0, glen - read_len, size=n)
        codes = genome[starts[:, None] + np.arange(read_len)]
        # ~0.2% sequencing-error substitutions
        ne = max(1, n * read_len // 500)
        codes[rng.integers(0, n, ne), rng.integers(0, read_len, ne)] = (
            rng.integers(0, 4, ne).astype(np.uint8)
        )
        seq = bases[codes]
    else:
        seq = bases[rng.integers(0, 4, size=(n, read_len))]
    # sparse N positions (~0.1%)
    nn = max(1, n * read_len // 1000)
    seq[rng.integers(0, n, nn), rng.integers(0, read_len, nn)] = ord("N")

    # quality: pool of correlated random-walk rows, tiled across records
    pool = 512
    steps = rng.integers(-2, 3, size=(pool, read_len)).astype(np.int32)
    qrows = np.clip(
        33 + 30 + np.cumsum(steps, axis=1) // 3, 33, 74
    ).astype(np.uint8)
    qual = qrows[np.arange(n) % pool]
    return _assemble_fastq(n, read_len, seq, qual)


def _assemble_fastq(
    n: int, read_len: int, seq: np.ndarray, qual: np.ndarray
) -> bytes:
    """FASTQ text of n fixed-width records: header
    ``@SIM0.<9-digit id> <id % 4>:N:0:ACGTACGT length=<L>``, bases, ``+``,
    qualities; one numpy concatenation of the rows."""
    from .utils.synth import _headers

    def col(ch: bytes) -> np.ndarray:
        return np.full((n, len(ch)), np.frombuffer(ch, np.uint8))

    return np.concatenate(
        [_headers(n, read_len), col(b"\n"), seq, col(b"\n+\n"), qual, col(b"\n")],
        axis=1,
    ).tobytes()


class NullWriter(io.RawIOBase):
    def __init__(self):
        self.nbytes = 0

    def write(self, b) -> int:
        self.nbytes += len(b)
        return len(b)

    def writable(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# wall-clock metrics
# ---------------------------------------------------------------------------


def phase_robust_best(
    once,
    repeats: int = 3,
    window_s: float = 2.0,
    min_windows: int = 3,
    cap_s: float = 90.0,
    min_s: float = 60.0,
    agree: float = 0.02,
) -> float:
    """Phase-robust best-of estimator, shared by every wall-clock metric
    (the JAX bench's, unchanged). Hosts swing 30-40% run to run and can
    alternate fast and slow phases on minute timescales, so a fixed best-of
    window can sit entirely inside a slow phase.

    ``once`` runs the workload one time and returns its wall seconds.
    Sample in ~``window_s`` windows and keep extending until the best
    has been REPRODUCED: the two fastest window-bests must agree within
    ``agree`` (the fast phase seen at least twice), never stopping
    before ``min_s`` of sampling, up to a ``cap_s`` cap. The headline stays
    best-of; the reproduction requirement is what makes a bad phase unable
    to erase a real win."""
    window_bests = []
    best = float("inf")
    loop_t0 = time.perf_counter()
    runs = 0
    while True:
        wbest = float("inf")
        w_t0 = time.perf_counter()
        while time.perf_counter() - w_t0 < window_s:
            wbest = min(wbest, once())
            runs += 1
        window_bests.append(wbest)
        best = min(best, wbest)
        elapsed = time.perf_counter() - loop_t0
        if (
            elapsed >= min_s
            and len(window_bests) >= max(min_windows, 2)
            and runs >= repeats
        ):
            lo = sorted(window_bests)[:2]
            if lo[1] / lo[0] - 1.0 <= agree:
                break  # fast phase reproduced: best is evidence
        if elapsed >= cap_s:
            break
    spread = (max(window_bests) / min(window_bests) - 1.0) * 100
    lo = sorted(window_bests)[:2]
    # one window (a run longer than cap_s) has no second best to agree with
    top2 = f"{(lo[1] / lo[0] - 1) * 100:.1f}%" if len(lo) == 2 else "n/a"
    log(
        f"estimator: {runs} runs / {len(window_bests)} windows, "
        f"window-best spread {spread:.0f}%, "
        f"top-2 agree {top2}"
    )
    return best


def _file_to_file(path: str, run, estimator: dict, repeats: int) -> float:
    """Best wall seconds of ``run(reader, writer)`` from the file ``path``
    into ``/dev/null`` (a real file sink, like the reference's file-to-file
    benchmark)."""
    with open(os.devnull, "wb", buffering=0) as w:

        def once() -> float:
            with open(path, "rb") as r:
                t0 = time.perf_counter()
                run(r, w)
                return time.perf_counter() - t0

        return phase_robust_best(once, repeats, **estimator)


def bench_compress(
    data: bytes, device="cuda", repeats: int = 3, v3: bool = False, **estimator
):
    """Compress throughput from a real file on ``device``:
    ``compress_device`` with ``Options()`` (FQZ v2) or, with ``v3``,
    ``Options(version=3)``. A warm-up run (kernel build, page cache) gives
    the ratio; ``estimator`` passes through to :func:`phase_robust_best`.
    Returns (MB/s, ratio, best seconds)."""
    import tempfile

    from .format import container
    from .ops.device import resolve_device
    from .pipeline import api
    from .pipeline import device as devpipe

    dev = resolve_device(device)
    opts = api.Options(version=container.VERSION_3_NATIVE) if v3 else api.Options()

    def run(r, w):
        devpipe.compress_device(r, w, opts, device=dev)

    fd, path = tempfile.mkstemp(suffix=".fq")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        warm = NullWriter()
        with open(path, "rb") as r:
            run(r, warm)
        out_size = warm.nbytes
        best = _file_to_file(path, run, estimator, repeats)
    finally:
        os.unlink(path)
    return len(data) / 1e6 / best, len(data) / out_size, best


def bench_decompress(
    data: bytes, device="cuda", repeats: int = 3, v3: bool = False, **estimator
):
    """Decompress throughput with the same estimator and file-to-file
    shape as :func:`bench_compress`; the container is made on ``device``
    too, and the warm-up's output size is checked. Returns (MB/s, best
    seconds)."""
    import tempfile

    from . import compress_bytes
    from .format import container
    from .ops.device import resolve_device
    from .pipeline import api
    from .pipeline import device as devpipe

    dev = resolve_device(device)
    opts = api.Options(version=container.VERSION_3_NATIVE) if v3 else api.Options()
    comp = compress_bytes(data, opts, device=dev)
    log(f"container: {len(comp):,} bytes ({'v3' if v3 else 'v2'})")

    def run(r, w):
        devpipe.decompress_device(r, w, device=dev)

    fd, path = tempfile.mkstemp(suffix=".fqz")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(comp)
        out = NullWriter()
        with open(path, "rb") as r:
            run(r, out)  # warm-up
        if out.nbytes != len(data):
            raise RuntimeError(
                f"decompress size mismatch: {out.nbytes} bytes, want {len(data)}")
        best = _file_to_file(path, run, estimator, repeats)
    finally:
        os.unlink(path)
    return len(data) / 1e6 / best, best


# ---------------------------------------------------------------------------
# kernel metrics: device-resident inputs, CUDA event timing
# ---------------------------------------------------------------------------


def _device_ms(fn, arg_sets, iters: int, dev: torch.device) -> float:
    """Mean ms per call of ``fn(*args)`` over ``iters`` calls rotating over
    ``arg_sets``, after one warm-up call each. On the card: CUDA events
    around calls queued behind a sleep kernel, so they time the device's
    back-to-back work, not the host's enqueue. On the CPU: the host clock."""
    for args in arg_sets:
        fn(*args)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        return (time.perf_counter() - t0) * 1e3 / iters
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
        enqueue_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(min(enqueue_s * 2.5 + 0.002, 2.0) * 2e9))
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rotations(tensors, bytes_per_call: int, dev: torch.device) -> list:
    """On the card, copies of ``tensors`` enough to move > 150 MB between
    two calls on the same inputs (three times the H100's 50 MB L2), so
    each call finds its inputs cold, as the pipeline does."""
    if dev.type != "cuda":
        return [tuple(tensors)]
    k = max(2, -(-150_000_000 // bytes_per_call))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(k - 1)]


@functools.lru_cache(maxsize=1)
def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(0)} (nvidia-smi failed: {e})"


def _roofline(name: str, nbytes: int, ms: float, dev: torch.device) -> None:
    if dev.type != "cuda":
        return
    rate = nbytes / (ms / 1e3)
    log(
        f"roofline {name}: {ms * 1e3:.2f} us per launch, {rate / 1e9:.1f} GB/s of "
        f"bytes moved once = {100 * rate / HBM_BYTES_PER_S:.1f}% of the H100's "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s (bound {nbytes / HBM_BYTES_PER_S * 1e6:.2f} us; "
        f"{card_line()})"
    )


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"bench check failed: {what}")


def _dense_inputs(r: int, read_len: int, dev: torch.device):
    rng = np.random.default_rng(0)
    ab = np.frombuffer(b"ACGT", np.uint8)
    seq = torch.from_numpy(ab[rng.integers(0, 4, size=(r, read_len))]).to(dev)
    qual = torch.from_numpy(
        rng.integers(33, 74, size=(r, read_len)).astype(np.uint8)).to(dev)
    lengths = torch.full((r,), read_len, dtype=torch.int32, device=dev)
    return seq, qual, lengths


def bench_kernel(read_len: int = 152, r: int = 65536, steps: int = 20, device="cuda"):
    """Steady-state ``fq_dense_encode`` throughput, data resident on the
    card: seq + qual bytes per launch over the launch time (CUDA events over
    ``steps`` launches, inputs rotated past the L2). The JAX bench chained
    its launches in one program and fitted a slope to cancel a relay's
    dispatch cost and XLA's dead-code elimination; neither exists here."""
    from .ops import cuda_kernels as ck
    from .ops.device import resolve_device

    dev = resolve_device(device)
    seq, qual, lengths = _dense_inputs(r, read_len, dev)
    # reads seq, qual, lengths; writes packed, nmask, n_counts, deltas
    nbytes = (3 * r * read_len + 8 * r + r * -(-read_len // 4)
              + r * -(-read_len // 8))
    sets = _rotations((seq, qual, lengths), nbytes, dev)
    ms = _device_ms(lambda s, q, n: ck.encode_arrays(s, q, n, 33), sets, steps, dev)
    _roofline("encode-kernel", nbytes, ms, dev)
    return 2 * r * read_len / 1e6 / (ms / 1e3)


def bench_decode_kernel(read_len: int = 152, r: int = 65536, steps: int = 20,
                        device="cuda"):
    """Steady-state ``fq_dense_decode`` throughput (packed bases and
    quality deltas -> ASCII), data resident: seq + qual ASCII bytes per
    launch over the launch time; the decode of the first launch is checked
    against the encoded input."""
    from .ops import cuda_kernels as ck
    from .ops.device import resolve_device

    dev = resolve_device(device)
    seq, qual, lengths = _dense_inputs(r, read_len, dev)
    enc = ck.encode_arrays(seq, qual, lengths, 33)
    got_seq, got_qual = ck.decode_arrays(enc.packed, enc.qual_delta, lengths, 33)
    _check(torch.equal(got_seq, seq) and torch.equal(got_qual, qual),
           "dense decode(encode(x)) == x")
    # reads packed and deltas, writes bases and qualities
    nbytes = r * -(-read_len // 4) + 3 * r * read_len
    sets = _rotations((enc.packed, enc.qual_delta, lengths), nbytes, dev)
    ms = _device_ms(lambda p, d, n: ck.decode_arrays(p, d, n, 33), sets, steps, dev)
    _roofline("decode-kernel", nbytes, ms, dev)
    return 2 * r * read_len / 1e6 / (ms / 1e3)


def _order0_stream(mb: float, dev: torch.device) -> dict:
    """``mb`` MiB of symbols 0-44 on ``dev``, encoded once at the lane tier
    ``rans._pick_lanes`` gives with the mesh path's table
    (``parallel/mesh.py:entropy_table``; for one stream it is the stream
    API's table, so the payload is ``rans.encode_stream``'s), its words
    compacted and decoded once on ``dev`` and checked against the input."""
    from .ops import cuda_kernels as ck
    from .ops import rans
    from .parallel import mesh as pmesh

    m = int(mb * (1 << 20))
    lanes = rans._pick_lanes(m)
    rows = -(-m // lanes)
    data_h = np.random.default_rng(0).integers(0, 45, size=m).astype(np.uint8)
    freq_cum, pad_sym = pmesh.entropy_table(data_h[None, :], lanes=lanes)
    fc = torch.from_numpy(freq_cum.astype(np.int32)).to(dev)
    slot = torch.from_numpy(
        rans.pack_slot_table(freq_cum[0].astype(np.uint16)).view(np.int32)).to(dev)

    def encode(d):
        words, flags, states = ck.rans_encode(d, rows, lanes, pad_sym, fc)
        return (*ck.rans_compact(words, flags), states)

    def decode(words, states):
        return ck.rans_decode(words, states, slot, rows, lanes)

    data = torch.from_numpy(data_h).to(dev)
    flat, total, states = encode(data)
    words = flat[: int(total.item())].clone()
    out, consumed = decode(words, states)
    _check(int(consumed.item()) == words.numel()
           and torch.equal(out[:m].cpu(), torch.from_numpy(data_h)),
           "order-0 decode(encode(x)) == x")
    return {"m": m, "cells": rows * lanes, "lanes": lanes, "data": data, "words": words,
            "states": states, "encode": encode, "decode": decode}


def bench_mesh_entropy(mb: float = 16, steps: int = 20, device="cuda"):
    """Order-0 rANS encode throughput of ``mb`` MiB of symbols 0-44
    (:func:`_order0_stream`), data resident. The port's stream API
    compacts the words on the card, so the timed unit is
    ``fq_rans_encode`` + ``fq_rans_compact`` (the JAX bench timed the raw
    encode and compacted on the host)."""
    from .ops.device import resolve_device

    dev = resolve_device(device)
    st = _order0_stream(mb, dev)
    # encode: symbols in, words and flags out; compaction: words and flags
    # in, kept words out
    nbytes = st["m"] + 6 * st["cells"] + 2 * st["words"].numel()
    ms = _device_ms(st["encode"], _rotations((st["data"],), nbytes, dev), steps, dev)
    return st["m"] / 1e6 / (ms / 1e3)


def bench_mesh_entropy_decode(mb: float = 16, steps: int = 20, device="cuda"):
    """Order-0 rANS decode throughput (``fq_rans_decode``) of one stream
    of ``mb`` MiB of symbols 0-44 (:func:`_order0_stream`), data resident,
    repeated launches. The decode table is the port's slot table of the
    frequencies (JAX's gather-free ``compact_tables`` is a TPU layout)."""
    from .ops.device import resolve_device

    dev = resolve_device(device)
    st = _order0_stream(mb, dev)
    nbytes = 2 * st["words"].numel() + 4 * st["lanes"] + st["cells"]
    ms = _device_ms(lambda w: st["decode"](w, st["states"]),
                    _rotations((st["words"],), nbytes, dev), steps, dev)
    return st["m"] / 1e6 / (ms / 1e3)


def wctx_bench_table(contexts: int, npres: int = 46):
    """The uniform smoothed table of the wctx metrics: every context codes
    every one of ``npres`` symbols (the JAX bench's, ``bench.py`` lines
    596-615), as ``(freq_p (C, npres) u16, tab (C, npres + 1) int16)``,
    ``tab`` in the port's device layout (:func:`..ops.wctx.device_table`:
    exclusive cumulative frequencies, the row total in the last column)."""
    from .ops import wctx

    base = wctx.PROB_SCALE // npres
    freq_p = np.full((contexts, npres), base, np.uint16)
    freq_p[:, 0] += wctx.PROB_SCALE - base * npres
    return freq_p, wctx.device_table(freq_p)


def bench_wctx_entropy(mb: float = 16, steps: int = 20, decode: bool = False,
                       device="cuda"):
    """Context-rANS kernel throughput (``fq_wctx_encode``, or with
    ``decode`` ``fq_wctx_decode``) on the quality model, order 0 (384
    contexts), of ``mb`` MiB of one clipped random walk in 0-45 cut into
    151-symbol records, at the lane count ``wctx.pick_lanes`` gives, with
    the uniform table of :func:`wctx_bench_table` (a throughput metric: a
    real histogram pass over the matrix takes seconds). Decode: one real
    encode, then repeated decodes. Both check one round trip."""
    from .ops import cuda_kernels as ck
    from .ops import wctx
    from .ops.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    read_len = 151
    nrec = int(mb * (1 << 20)) // read_len
    lengths = np.full(nrec, read_len, np.int64)
    total = nrec * read_len
    syms = np.clip(
        30 + np.cumsum(rng.integers(-2, 3, total)) // 2, 0, 45
    ).astype(np.uint8)
    lanes = wctx.pick_lanes(total)
    contexts, _, _ = wctx.model_geometry(wctx.MODEL_QUAL, 0)
    sb, s, seg_h = wctx.stream_layout(lengths, lanes)
    startm = wctx.start_matrix(lengths, sb, s)
    symm = wctx.to_matrix(syms, sb, s, 0)
    ctxm = wctx.context_matrix(symm, startm, wctx.MODEL_QUAL, 0)
    freq_p, tab_h = wctx_bench_table(contexts)
    # every symbol 0-45 is present, so a symbol's present index is itself
    sym = torch.from_numpy(symm).to(dev)
    ctx = torch.from_numpy(ctxm.astype(np.int16)).to(dev)
    seg = torch.from_numpy(seg_h).to(dev)
    tab = torch.from_numpy(tab_h).to(dev)
    present = torch.arange(freq_p.shape[1], dtype=torch.uint8, device=dev)
    startm_d = torch.from_numpy(startm.view(np.uint8)).to(dev)

    words, flags, states, status = ck.wctx_encode(sym, ctx, seg, tab)
    _check(int(status.item()) == 0, "wctx encode status")
    flat, nwords = ck.rans_compact(words, flags)
    nwords = int(nwords.item())
    words_d = flat[:nwords].clone()
    out, info = ck.wctx_decode(words_d, states, startm_d, seg, tab, present,
                               wctx.MODEL_QUAL, 0)
    consumed, bad = (int(v) for v in info.cpu())
    _check(consumed == nwords and not bad
           and np.array_equal(wctx.from_matrix(out.cpu().numpy(), sb), syms),
           "wctx decode(encode(x)) == x")
    cells = s * lanes
    if not decode:
        # reads symbols, contexts, the table; writes words, flags, states
        nbytes = 3 * cells + tab_h.nbytes + 3 * cells + 4 * lanes
        ms = _device_ms(lambda y, c: ck.wctx_encode(y, c, seg, tab),
                        _rotations((sym, ctx), nbytes, dev), steps, dev)
        return total / 1e6 / (ms / 1e3)
    nbytes = 2 * nwords + 4 * lanes + cells + tab_h.nbytes + cells

    def dec(w):
        return ck.wctx_decode(w, states, startm_d, seg, tab, present, wctx.MODEL_QUAL, 0)

    ms = _device_ms(dec, _rotations((words_d,), nbytes, dev), steps, dev)
    return total / 1e6 / (ms / 1e3)


def bench_mesh_e2e(mb: int = 64, repeats: int = 3, device="cuda"):
    """End-to-end ``fqpack --mesh`` compress on one card (the card of
    ``device``): host scan, stream build, the device entropy stage, word
    compaction and the container write, wall clock, on the context-model
    corpus (``markov=True``, seed 42 + i per repeat) so the ``TAG_WCTX``
    coder carries the dominant streams. Returns (best MB/s, best ratio)."""
    from .ops.device import resolve_device
    from .parallel import mesh as pmesh
    from .pipeline import api, meshpipe

    mesh = pmesh.make_mesh(1, resolve_device(device))
    best = 0.0
    ratio = 0.0
    for i in range(repeats):
        data = synth_fastq(mb, seed=42 + i, markov=True)
        sink = NullWriter()
        t0 = time.perf_counter()
        meshpipe.compress_mesh(io.BytesIO(data), sink, api.Options(), mesh)
        dt = time.perf_counter() - t0
        log(
            f"mesh-e2e[{i}]: {len(data)/1e6/dt:.1f} MB/s "
            f"({sink.nbytes:,} bytes, {len(data)/sink.nbytes:.2f}x)"
        )
        best = max(best, len(data) / 1e6 / dt)
        ratio = max(ratio, len(data) / sink.nbytes)
    return best, ratio


def bench_micro(data: bytes, device: torch.device):
    """Stage microbenchmarks (the reference's BenchmarkReadBatch,
    BenchmarkCompressBlock and pack/delta benches): the parser (the text's
    copy to ``device`` and the record scan there, ``fq_records_scan``), the
    stream build of the first block (row gathers, dense encode and
    ``fq_streams_build`` on ``device``, the copy back) and zstd on the host,
    each as MB/s on stderr; the JSON line carries the parser rate."""
    from .entropy import zstd as z
    from .parser.fastq import FastqStreamParser
    from .pipeline import blocks as blockcodec

    results = {}

    t0 = time.perf_counter()
    blocks = list(FastqStreamParser(io.BytesIO(data), block_size=100000,
                                    device=device).blocks())
    results["parse"] = len(data) / 1e6 / (time.perf_counter() - t0)
    blk = blocks[0]

    t0 = time.perf_counter()
    raw = blockcodec.block_to_raw_streams(blk, 33)
    results["build_streams"] = 2 * blk.total_bases / 1e6 / (time.perf_counter() - t0)
    codec = z.get_codec()
    streams = raw.ordered(2)
    total = sum(len(s) for s in streams)
    t0 = time.perf_counter()
    comp = [codec.compress(s) for s in streams]
    results["zstd_encode"] = total / 1e6 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for c in comp:
        codec.decompress(c)
    results["zstd_decode"] = total / 1e6 / (time.perf_counter() - t0)

    for name, mbps in results.items():
        log(f"  micro {name:<14} {mbps:8.0f} MB/s")
    return results


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def _result(metric: str, value: float, baseline: float, digits: int = 1,
            unit: str = "MB/s") -> dict:
    return {
        "metric": metric,
        "value": round(value, digits),
        "unit": unit,
        "vs_baseline": round(value / baseline, 3),
    }


def _run_metric(args, data, device: torch.device) -> int:
    if args.metric == "micro":
        mbps = bench_micro(data, device).get("parse", 0.0)
        result = _result("parse_throughput", mbps, BASELINE_COMPRESS_MBPS)
    elif args.metric == "kernel":
        result = _result("encode_kernel_throughput", bench_kernel(device=device),
                         BASELINE_COMPRESS_MBPS)
    elif args.metric == "decode-kernel":
        result = _result("decode_kernel_throughput", bench_decode_kernel(device=device),
                         BASELINE_DECOMPRESS_MBPS)
    elif args.metric == "mesh-entropy":
        # 16 MiB cap, as the JAX bench: a v3 block's per-stream shards sit
        # under it (a 100,000-record block's quality stream is ~15 MB)
        result = _result("mesh_entropy_encode_throughput",
                         bench_mesh_entropy(min(args.mb, 16), device=device),
                         BASELINE_COMPRESS_MBPS)
    elif args.metric == "mesh-entropy-decode":
        result = _result("mesh_entropy_decode_throughput",
                         bench_mesh_entropy_decode(min(args.mb, 64), device=device),
                         BASELINE_DECOMPRESS_MBPS)
    elif args.metric == "wctx-entropy":
        result = _result("wctx_entropy_encode_throughput",
                         bench_wctx_entropy(min(args.mb, 64), device=device),
                         BASELINE_COMPRESS_MBPS)
    elif args.metric == "wctx-entropy-decode":
        result = _result("wctx_entropy_decode_throughput",
                         bench_wctx_entropy(min(args.mb, 64), decode=True, device=device),
                         BASELINE_DECOMPRESS_MBPS)
    elif args.metric == "mesh-e2e":
        mbps, ratio = bench_mesh_e2e(min(args.mb, 128), args.repeats, device=device)
        log(f"mesh-e2e best={mbps:.1f} MB/s ratio={ratio:.2f}x")
        result = _result("mesh_e2e_compress_throughput", mbps, BASELINE_COMPRESS_MBPS)
    elif args.metric in ("decompress", "decompress-v3"):
        v3 = args.metric == "decompress-v3"
        mbps, best = bench_decompress(data, device, args.repeats, v3=v3)
        log(f"decompress best={best:.3f}s")
        result = _result("decompress_v3_throughput" if v3 else "decompress_throughput",
                         mbps, BASELINE_DECOMPRESS_MBPS)
    elif args.metric == "ratio":
        # the best-ratio model (fqz-v3-max); the synthetic fixture
        # compresses better than real reads
        from . import compress_bytes, decompress_bytes
        from .models import get_model

        comp = compress_bytes(data, get_model("fqz-v3-max").options(), device=device)
        _check(decompress_bytes(comp, device=device) == data, "ratio round trip")
        ratio = len(data) / len(comp)
        log(f"v3-max ratio {ratio:.3f}x ({len(comp):,} bytes)")
        result = _result("compression_ratio", ratio, BASELINE_RATIO, digits=3, unit="x")
    else:
        v3 = args.metric == "compress-v3"
        mbps, ratio, best = bench_compress(data, device, args.repeats, v3=v3)
        log(f"compress best={best:.3f}s ratio={ratio:.2f}x")
        result = _result("compress_v3_throughput" if v3 else "compress_throughput",
                         mbps, BASELINE_COMPRESS_MBPS)
    print(json.dumps(result), flush=True)
    return 0


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fqpack bench",
        description="Benchmark the PyTorch/CUDA port: one metric, one JSON line",
    )
    ap.add_argument("--mb", type=int, default=128)
    ap.add_argument("--metric", choices=METRICS, default="compress")
    # more best-of samples stabilize the headline on a noisy host
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument(
        "--fixture",
        choices=["iid", "genomic"],
        default="iid",
        help="genomic = reads sampled from one genome at 15x coverage "
        "(block-local redundancy, engages v3 TAG_SLDM)",
    )
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain PyTorch versions on the CPU")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace to DIR")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)

    from .ops import cuda_kernels
    from .ops.device import resolve_device
    from .utils import malloc_tuning
    from .utils.profiling import trace

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --cpu to run the kernels' "
            "plain versions on the CPU")
    device = resolve_device("cpu" if args.cpu else "cuda")
    log(f"device={device}" + (f" {card_line()}" if device.type == "cuda" else ""))

    malloc_tuning.tune()
    log("tuning allocator + pre-faulting heap ...")
    t0 = time.perf_counter()
    malloc_tuning.warm_heap(min(args.mb * 4, 512) << 20)
    log(f"heap warm in {time.perf_counter()-t0:.1f}s")

    data = None
    if args.metric in _FIXTURE_METRICS:
        log(f"generating {args.mb} MB synthetic FASTQ ...")
        t0 = time.perf_counter()
        data = synth_fastq(args.mb, genomic=(args.fixture == "genomic"))
        log(f"generated {len(data)/1e6:.1f} MB in {time.perf_counter()-t0:.2f}s")

    cuda_kernels.reset_launches()
    with trace(args.profile, cuda=device.type == "cuda"):
        rc = _run_metric(args, data, device)
    log(f"launches {json.dumps(cuda_kernels.launches.as_dict())}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
