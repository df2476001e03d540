"""The port's CUDA kernels on the card (dense codec, order-0 rANS, CRC32,
context rANS): kernel == plain version, and a GPU compress byte-identical
to the CPU compress, for FQZ v2, v3 and the ``--mesh`` path.

Marked ``cuda``; each test skips when ``torch.cuda.is_available()`` is
False. On a machine with a card: ``python -m pytest tests/test_torch_cuda.py
-m cuda``. Comparisons are exact (integer codec, tolerance 0).
"""

import io
import json
import subprocess
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu_torch.ops import crc32 as port_crc32
from fastqpacker_tpu_torch.ops import cuda_kernels
from fastqpacker_tpu_torch.ops import device as port_device
from fastqpacker_tpu_torch.ops import rans as port_rans
from fastqpacker_tpu_torch.utils.synth import synth_fastq
from torch_ctxprep_inputs import (layout_edge_cases, prepare_edge_cases, sctx_prepare_edge_cases,
                                  unlayout_edge_cases)

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent

SHAPES = [(8, 152), (16, 31), (4, 8), (300, 64), (3, 1), (3, 65544), (37500, 160)]
ALPHABET = b"ACGTNacgt.RY"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _block(rng, r, l):
    lengths = rng.integers(0, l + 1, size=r).astype(np.int32)
    lengths[1::4] = 0
    lengths[0] = l
    ab = np.frombuffer(ALPHABET, np.uint8)
    seq = ab[rng.integers(0, len(ab), size=(r, l))]
    qual = rng.integers(33, 105, size=(r, l)).astype(np.uint8)
    pad = np.arange(l)[None, :] >= lengths[:, None]
    seq[pad] = 0
    qual[pad] = 0xFF
    return seq, qual, lengths


@pytest.mark.parametrize("r,l", SHAPES)
@pytest.mark.parametrize("offset", [33, 64])
def test_kernels_match_plain(r, l, offset, cuda):
    rng = np.random.default_rng(r + l + offset)
    s, q, n = (torch.from_numpy(x).to(cuda) for x in _block(rng, r, l))
    cuda_kernels.reset_launches()
    got = cuda_kernels.encode_arrays(s, q, n, offset)
    want = port_device.encode_arrays_plain(s, q, n, offset)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    seq, qual = cuda_kernels.decode_arrays(want.packed, want.qual_delta, n, offset)
    seq_p, qual_p = port_device.decode_arrays_plain(
        want.packed, want.qual_delta, n, offset
    )
    torch.cuda.synchronize()
    assert torch.equal(seq, seq_p) and torch.equal(qual, qual_p)
    counts = cuda_kernels.launches.as_dict()
    assert counts.pop(cuda_kernels.ENCODE) == counts.pop(cuda_kernels.DECODE) == 1
    assert not any(counts.values())


def test_gpu_compress_matches_cpu(cuda):
    data = synth_fastq(24, seed=3) + synth_fastq(4, read_len=300, min_len=50, seed=4)
    cuda_kernels.reset_launches()
    comp = tfq.compress_bytes(data, device=cuda)
    assert cuda_kernels.launches[cuda_kernels.ENCODE] >= 2
    assert comp == tfq.compress_bytes(data, device="cpu")
    assert tfq.decompress_bytes(comp, device=cuda) == data
    assert cuda_kernels.launches[cuda_kernels.DECODE] == (
        cuda_kernels.launches[cuda_kernels.ENCODE]
    )


def test_launch_counter_under_concurrent_launches(cuda):
    """Pipeline workers launch from many threads: no count is lost."""
    s = torch.zeros((64, 32), dtype=torch.uint8, device=cuda)
    n = torch.full((64,), 32, dtype=torch.int32, device=cuda)
    threads, per_thread = 16, 25
    cuda_kernels.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [
            threading.Thread(
                target=lambda: [cuda_kernels.encode_arrays(s, s, n, 33)
                                for _ in range(per_thread)]
            )
            for _ in range(threads)
        ]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize()
    assert cuda_kernels.launches[cuda_kernels.ENCODE] == threads * per_thread


# ragged tiles (R not a multiple of 16) and odd lengths, at exact widths
DENSE_EDGE = [(r, l) for r in (1, 15, 16, 17, 33) for l in (1, 8, 31, 151)]


def _dense_equal_plain(cuda, r, l, offset, seed, npos_cap=None):
    """Both dense kernels against their plain versions on one seeded
    block: every output byte-equal, contiguous at its exact width; the
    decode also from a packed matrix wider than ceil(L/4)."""
    rng = np.random.default_rng(seed)
    s, q, n = (torch.from_numpy(x).to(cuda) for x in _block(rng, r, l))
    kw = {} if npos_cap is None else {"npos_cap": npos_cap}
    got = cuda_kernels.encode_arrays(s, q, n, offset, **kw)
    want = port_device.encode_arrays_plain(s, q, n, offset, **kw)
    widths = ((r, -(-l // 4)), (r, -(-l // 8)), (r,), (r, l))
    for a, b, w in zip(got, want, widths):
        assert a.is_contiguous() and tuple(a.shape) == w
        assert torch.equal(a, b)
    seq_p, qual_p = port_device.decode_arrays_plain(want.packed, want.qual_delta, n, offset)
    wide = torch.cat([want.packed, torch.full((r, 7), 0xA5, dtype=torch.uint8,
                                              device=cuda)], dim=1)
    for packed in (want.packed, wide):
        seq, qual = cuda_kernels.decode_arrays(packed, want.qual_delta, n, offset)
        assert seq.is_contiguous() and qual.is_contiguous()
        assert tuple(seq.shape) == tuple(qual.shape) == (r, l)
        assert torch.equal(seq, seq_p) and torch.equal(qual, qual_p)
    torch.cuda.synchronize()


@pytest.mark.parametrize("r,l", DENSE_EDGE + [(33, 321), (1000, 151), (100_000, 151)])
@pytest.mark.parametrize("offset", [33, 64])
def test_dense_kernels_match_plain_at_exact_widths(r, l, offset, cuda):
    _dense_equal_plain(cuda, r, l, offset, seed=r * 7 + l + offset)


@pytest.mark.parametrize("side", [-1, 0, 1, 977])
def test_dense_kernels_on_both_sides_of_the_long_row_threshold(side, cuda):
    """Rows up to the threshold go through the tile kernels, longer rows
    through the row kernels; both equal the plain versions, with the N
    tracking cap and without it."""
    t = cuda_kernels.dense_geometry(151).max_tile_len
    l = t + side
    for encode in (True, False):
        g = cuda_kernels.dense_geometry(l, encode=encode)
        assert g.route == ("tile" if l <= t else "row")
    for r in (17, 33):
        _dense_equal_plain(cuda, r, l, 33, seed=r + l)
        _dense_equal_plain(cuda, r, l, 64, seed=r + l + 1, npos_cap=100)


def test_dense_one_kernel_per_wrapper_call(cuda):
    """At the v3 / mesh block shape (100,000 x 151) one wrapper call, its
    outputs made contiguous as a copy to the host makes them, runs one CUDA
    kernel: no zero-fill, pad or slice copy around it."""
    rng = np.random.default_rng(151)
    s, q, n = (torch.from_numpy(x).to(cuda) for x in _block(rng, 100_000, 151))
    enc = cuda_kernels.encode_arrays(s, q, n, 33)
    torch.cuda.synchronize()
    for call in (
        lambda: [x.contiguous() for x in cuda_kernels.encode_arrays(s, q, n, 33)],
        lambda: [x.contiguous() for x in cuda_kernels.decode_arrays(
            enc.packed, enc.qual_delta, n, 33)],
    ):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        ops = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"
               for _ in range(e.count)]
        assert len(ops) == 1, ops


def test_dense_kernels_from_two_threads_at_two_shared_sizes(cuda):
    """Pipeline workers launch from several threads: tiles of two sizes
    (L = 151 and L = 1,000, two dynamic shared-memory sizes) run at once,
    in a loop, and every launch matches the plain version."""
    rng = np.random.default_rng(12)
    cases = []
    for r, l in ((5000, 151), (600, 1000)):
        s, q, n = (torch.from_numpy(x).to(cuda) for x in _block(rng, r, l))
        want = port_device.encode_arrays_plain(s, q, n, 33)
        cases.append(((s, q, n), want,
                      port_device.decode_arrays_plain(want.packed, want.qual_delta, n, 33)))
    g = [cuda_kernels.dense_geometry(l) for l in (151, 1000)]
    assert g[0].route == g[1].route == "tile" and g[0].shared != g[1].shared
    torch.cuda.synchronize()

    def call(i):
        (s, q, n), want, (seq_p, qual_p) = cases[i]
        got = cuda_kernels.encode_arrays(s, q, n, 33)
        seq, qual = cuda_kernels.decode_arrays(want.packed, want.qual_delta, n, 33)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(seq, seq_p) and torch.equal(qual, qual_p)

    _from_two_threads(call, cuda, rounds=100)


def test_gpu_v3_and_mesh_match_cpu_at_odd_and_long_reads(cuda):
    """The v3 path on reads of 50-300 bp and of 1,100-1,500 bp (both dense
    routes) and the mesh path on reads of 60-151 bp: the card's containers
    equal the CPU's, and the card decodes them."""
    from fastqpacker_tpu_torch.parallel import mesh as pmesh
    from fastqpacker_tpu_torch.pipeline import meshpipe

    data = (synth_fastq(0.6, read_len=300, min_len=50, seed=21)
            + synth_fastq(0.4, read_len=1500, min_len=1100, seed=22))
    opts = tfq.Options(version=3, block_size=1500, workers=1)
    cuda_kernels.reset_launches()
    comp = tfq.compress_bytes(data, opts, device=cuda)
    blocks = cuda_kernels.launches[cuda_kernels.ENCODE]
    assert blocks >= 2
    assert comp == tfq.compress_bytes(data, opts, device="cpu")
    cuda_kernels.reset_launches()
    assert tfq.decompress_bytes(comp, device=cuda) == data
    assert cuda_kernels.launches[cuda_kernels.DECODE] == blocks

    one = len(synth_fastq(0, read_len=151))
    data = synth_fastq(4000 * one / (1 << 20), read_len=151, min_len=60, seed=23,
                       qual_model="phredwalk", seq_model="markov")
    mopts = tfq.Options(block_size=2000)
    comp = meshpipe.compress_mesh_bytes(data, mopts, [cuda])
    assert comp == meshpipe.compress_mesh_bytes(data, mopts, pmesh.make_mesh(1, device="cpu"))
    out = io.BytesIO()
    meshpipe.decompress_mesh(io.BytesIO(comp), out, [cuda])
    assert out.getvalue() == data


def _rans_inputs(rng, n, lanes, alphabet):
    data = rng.integers(0, alphabet, n).astype(np.uint8)
    steps = -(-n // lanes)
    hist = np.bincount(data, minlength=256).astype(np.int64)
    pad = int(np.argmax(hist))
    hist[pad] += steps * lanes - n
    freq = port_rans.normalize_freqs(hist)
    fc = np.stack([freq.astype(np.int32), port_rans.cumulative(freq).astype(np.int32)])
    return data, steps, pad, freq, fc


@pytest.mark.parametrize("lanes", [1, 4, 32, 256, 512, 1024, 2048, 4096, 8192, 16384])
@pytest.mark.parametrize("alphabet", [1, 40, 256])
def test_rans_kernels_match_plain(lanes, alphabet, cuda):
    """Encode, compact and decode against their plain versions, with a
    ragged last row, and decode(encode(x)) == x."""
    rng = np.random.default_rng(lanes + alphabet)
    n = 37 * lanes + lanes // 2 + 1
    data, steps, pad, freq, fc = _rans_inputs(rng, n, lanes, alphabet)
    d, t = torch.from_numpy(data).to(cuda), torch.from_numpy(fc).to(cuda)
    cuda_kernels.reset_launches()
    words, flags, states = cuda_kernels.rans_encode(d, steps, lanes, pad, t)
    pw, pf, ps = port_rans.rans_encode_plain(d, steps, lanes, pad, t)
    assert torch.equal(words, pw) and torch.equal(flags, pf) and torch.equal(states, ps)
    flat, total = cuda_kernels.rans_compact(words, flags)
    pflat, ptotal = port_rans.rans_compact_plain(words, flags)
    k = int(total)
    assert k == int(ptotal) and torch.equal(flat[:k], pflat[:k])
    tab = torch.from_numpy(port_rans.pack_slot_table(freq).view(np.int32)).to(cuda)
    stream = flat[:k].clone()
    out, consumed = cuda_kernels.rans_decode(stream, states, tab, steps, lanes)
    pout, pconsumed = port_rans.rans_decode_plain(stream, states, tab, steps, lanes)
    torch.cuda.synchronize()
    assert int(consumed) == int(pconsumed) == k
    assert torch.equal(out, pout)
    assert out[:n].cpu().numpy().tobytes() == data.tobytes()
    counts = cuda_kernels.launches.as_dict()
    assert [counts[x] for x in (cuda_kernels.RANS_ENCODE, cuda_kernels.RANS_COMPACT,
                                cuda_kernels.RANS_DECODE)] == [1, 1, 1]


def test_rans_decode_never_reads_past_a_short_word_buffer(cuda):
    """A stream that lost words: the kernel reads zeros, reports more
    words consumed than carried, and the stream API raises."""
    data = np.random.default_rng(1).integers(0, 30, 300_000).astype(np.uint8)
    good = port_rans.encode_stream(data, device=cuda)
    assert good == port_rans.encode_stream(data, device="cpu")
    assert port_rans.decode_stream(good, device=cuda) == data.tobytes()
    off = 8 + 512 + 4 * 256
    total = int.from_bytes(good[off : off + 4], "little")
    bad = good[:off] + (total - 100).to_bytes(4, "little") + good[off + 4 : -200]
    with pytest.raises(port_rans.RansError, match="corrupted rANS stream data"):
        port_rans.decode_stream(bad, device=cuda)


def _rans_stream(rng, n, lanes, cuda):
    """A stream of ``n`` walk-like deltas encoded on ``lanes`` lanes by the
    kernels: (data, steps, states, slot table, words) on the card."""
    data, steps, pad, freq, fc = _rans_inputs(rng, n, lanes, 40)
    d, t = torch.from_numpy(data).to(cuda), torch.from_numpy(fc).to(cuda)
    words, flags, states = cuda_kernels.rans_encode(d, steps, lanes, pad, t)
    flat, total = cuda_kernels.rans_compact(words, flags)
    tab = torch.from_numpy(port_rans.pack_slot_table(freq).view(np.int32)).to(cuda)
    return data, steps, states, tab, flat[: int(total)].clone()


def _from_two_threads(call, cuda, rounds=300):
    """``call(0)`` and ``call(1)`` (each one launch that checks its own
    result) in a loop of ``rounds`` from two threads at once, one CUDA
    stream each, with the interpreter switching threads as often as it can:
    pipeline workers launch so."""
    errors, done = [], [0, 0]

    def work(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                for _ in range(rounds):
                    call(i)
                    done[i] += 1
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[0]
    assert done == [rounds, rounds]


def test_rans_decode_from_two_threads_at_two_shared_sizes(cuda):
    """v3 decode workers launch from a pool of threads, one CUDA stream
    each: the 4,096-lane tier (16 CTAs, 48 KiB of dynamic shared memory)
    and the 256-lane tier (one CTA, 18 KiB) run the same kernel instance at
    once, in a loop, and every launch matches the plain version."""
    rng = np.random.default_rng(6)
    cases = []
    for lanes in (4096, 256):
        _, steps, states, tab, stream = _rans_stream(rng, 20 * lanes + 7, lanes, cuda)
        g = cuda_kernels.rans_decode_geometry(lanes)
        assert g.lanes_per_thread == 1
        pout, _ = port_rans.rans_decode_plain(stream, states, tab, steps, lanes)
        cases.append(((stream, states, tab, steps, lanes), pout, stream.numel()))
    torch.cuda.synchronize()

    def call(i):
        args, want, words = cases[i]
        out, consumed = cuda_kernels.rans_decode(*args)
        assert torch.equal(out, want) and int(consumed) == words

    _from_two_threads(call, cuda)


@pytest.mark.parametrize("lanes", [256, 2048, 4096, 16384])
def test_rans_corrupt_streams_at_every_cluster_size(lanes, cuda):
    """A stream that lost words reads zeros past the end of the word ring:
    the kernel's symbols and words consumed equal the plain version's, and
    the stream API raises "corrupted rANS stream data", at clusters of 1, 8
    and 16 CTAs."""
    rng = np.random.default_rng(77 + lanes)
    data = rng.integers(0, 30, 12 * lanes + 5).astype(np.uint8)
    good = port_rans.encode_stream(data, lanes=lanes, device=cuda)
    assert port_rans.decode_stream(good, device=cuda) == data.tobytes()
    off = 8 + 512 + 4 * lanes
    total = int.from_bytes(good[off : off + 4], "little")
    for lost in (1, 9, total // 2):
        bad = good[:off] + (total - lost).to_bytes(4, "little") + good[off + 4 : -2 * lost]
        with pytest.raises(port_rans.RansError, match="corrupted rANS stream data"):
            port_rans.decode_stream(bad, device=cuda)
    _, steps, states, tab, stream = _rans_stream(rng, len(data), lanes, cuda)
    short = stream[: stream.numel() // 2].clone()
    out, consumed = cuda_kernels.rans_decode(short, states, tab, steps, lanes)
    pout, pconsumed = port_rans.rans_decode_plain(short, states, tab, steps, lanes)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and int(consumed) == int(pconsumed) != short.numel()


RANS_TIERS = [1 << i for i in range(15)]


@pytest.mark.parametrize("lanes", RANS_TIERS)
def test_rans_decode_geometry_owns_every_lane_once(lanes, cuda):
    """The geometry the decode's C entry launches, read from its library,
    for every lane count it takes: K contiguous lanes per thread, each lane
    owned once, a cluster of at most 16 CTAs, the slot table and a word
    ring of four words per lane (at least 32) in at most 227 KB of shared
    memory per CTA; one CTA up to 256 lanes, several SMs past that."""
    g = cuda_kernels.rans_decode_geometry(lanes)
    assert g.threads % 32 == 0 and 32 <= g.threads <= 1024
    assert 1 <= g.cluster <= 16 and g.cluster & (g.cluster - 1) == 0
    if lanes < 32:  # one warp, the first `lanes` threads live
        assert (g.threads, g.cluster, g.lanes_per_thread) == (32, 1, 1)
    else:  # thread i of CTA r owns lanes (r * threads + i) * K ... + K - 1
        owner = np.zeros(lanes, np.int64)
        for r in range(g.cluster):
            for i in range(g.threads):
                lane0 = (r * g.threads + i) * g.lanes_per_thread
                owner[lane0 : lane0 + g.lanes_per_thread] += 1
        assert (owner == 1).all()
    assert g.shared == 4 * 4096 + 2 * max(4 * lanes, 32) <= 227 * 1024
    assert g.cluster == (1 if lanes <= 256 else min(16, lanes // 256))
    assert g.threads == (max(lanes, 32) if lanes <= 256 else 256)


@pytest.mark.parametrize("lanes", [0, 3, 3000, 32768])
def test_rans_decode_geometry_refuses_lanes_outside_the_kernel(lanes, cuda):
    with pytest.raises(ValueError, match="no decode geometry"):
        cuda_kernels.rans_decode_geometry(lanes)


CRC_CHUNK = port_crc32.CHUNK
CRC_SPAN = port_crc32.CTA_CHUNKS * CRC_CHUNK


@pytest.mark.parametrize(
    "n", [1, 255, 256, 257, 1024, 16383, 16384, 16385, 1_000_003, 15_100_000,
          3 * CRC_CHUNK + 17, 32 * CRC_CHUNK - 1, 32 * CRC_CHUNK, CRC_SPAN - 1,
          CRC_SPAN, CRC_SPAN + 1, 2 * CRC_SPAN + 32 * CRC_CHUNK + 3, 3_800_000,
          ((1 << 8) + 1) * CRC_SPAN + 7]
)
def test_crc32_kernel_matches_zlib_and_plain(n, cuda):
    data = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    t = torch.from_numpy(data).to(cuda)
    got = cuda_kernels.crc32_chunks(t)
    torch.cuda.synchronize()
    assert int(got.item()) & 0xFFFFFFFF == zlib.crc32(data.tobytes())
    if n <= 1_000_003:
        assert torch.equal(got, port_crc32.crc32_chunks_plain(t))
    assert port_crc32.crc32_device(data, device=cuda) == zlib.crc32(data.tobytes())


def test_crc32_kernel_geometry_and_one_launch_per_crc(cuda):
    """The span the wrapper sizes its partials by is the kernel's, and each
    CRC is one launch of it (no zeroed output before it)."""
    from fastqpacker_tpu_torch.ops import build

    assert build.load("crc32").fq_crc32_span_bytes() == CRC_SPAN
    data = torch.from_numpy(np.random.default_rng(8).integers(0, 256, 5 * CRC_SPAN + 9)
                            .astype(np.uint8)).to(cuda)
    want = zlib.crc32(data.cpu().numpy().tobytes())
    cuda_kernels.crc32_chunks(data)  # the stream's ticket counter exists
    torch.cuda.synchronize()
    cuda_kernels.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        outs = [cuda_kernels.crc32_chunks(data) for _ in range(3)]
        torch.cuda.synchronize()
    assert [int(o.item()) & 0xFFFFFFFF for o in outs] == [want] * 3
    assert cuda_kernels.launches.as_dict()[cuda_kernels.CRC32] == 3
    kernels = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if kernels:  # where the profiler sees the card: nothing but the kernel ran
        assert kernels == ["crc32_kernel"] or all("crc32_kernel" in k for k in kernels)


def test_crc32_wrapper_refuses_a_misaligned_view(cuda):
    """The kernel reads 16-byte pieces from the stream's start: a view that
    does not start on 16 bytes is refused, never read wrongly."""
    data = torch.from_numpy(np.random.default_rng(9).integers(0, 256, 40_000)
                            .astype(np.uint8)).to(cuda)
    for off in (1, 3, 8):
        with pytest.raises(ValueError, match="16-byte aligned"):
            cuda_kernels.crc32_chunks(data[off:])
    ok = data[16:]
    assert int(cuda_kernels.crc32_chunks(ok).item()) & 0xFFFFFFFF == zlib.crc32(
        data.cpu().numpy()[16:].tobytes())


def test_crc32_from_two_threads(cuda):
    """Two streams compute CRCs at once, each with its own ticket counter:
    every result is right, at one span and at many."""
    rng = np.random.default_rng(10)
    cases = []
    for n in (CRC_SPAN - 3, 40 * CRC_SPAN + 5):
        d = rng.integers(0, 256, n).astype(np.uint8)
        cases.append((torch.from_numpy(d).to(cuda), zlib.crc32(d.tobytes())))
    torch.cuda.synchronize()

    def call(i):
        data, want = cases[i]
        assert int(cuda_kernels.crc32_chunks(data).item()) & 0xFFFFFFFF == want

    _from_two_threads(call, cuda, rounds=200)


# flag bytes and their probabilities: the densities of the CPU tests, and
# bytes of 2 and 255, which count as kept
COMPACT_FLAGS = {
    "none": {0: 1.0}, "0.001": {0: 0.999, 1: 0.001}, "0.11": {0: 0.89, 1: 0.11},
    "0.5": {0: 0.5, 1: 0.5}, "all": {1: 1.0},
    "bytes_2_255": {0: 0.4, 1: 0.2, 2: 0.2, 255: 0.2},
}
COMPACT_WAVES = 20_000_003  # cells: several waves of CTAs on 132 SMs


def _compact_case(rng, m, flag_bytes, cuda):
    """Seeded (m,) int16 words and uint8 flags on the card, and the kept
    words as ``torch.masked_select`` gives them."""
    words = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, m).astype(np.int16)).to(cuda)
    flags = torch.from_numpy(rng.choice(np.array(list(flag_bytes), np.uint8), m,
                                        p=list(flag_bytes.values()))).to(cuda)
    return words, flags, torch.masked_select(words, flags.bool())


def _compact_equal(words, flags, want):
    flat, total = cuda_kernels.rans_compact(words, flags)
    k = int(total)
    assert k == want.numel()
    assert torch.equal(flat[:k], want)


@pytest.mark.parametrize("size", ["1", "tile-1", "tile", "tile+1", "waves"])
@pytest.mark.parametrize("density", list(COMPACT_FLAGS))
def test_rans_compact_kernel_matches_plain_and_masked_select(size, density, cuda):
    """The compaction at one cell, around one tile and over several waves
    of CTAs, at each flag density and with flag bytes of 2 and 255: the
    kept words and the total equal the plain version's and
    ``torch.masked_select``'s."""
    tile = cuda_kernels.COMPACT_TILE
    m = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "waves": COMPACT_WAVES}[size]
    rng = np.random.default_rng(m + len(density))
    words, flags, want = _compact_case(rng, m, COMPACT_FLAGS[density], cuda)
    flat, total = cuda_kernels.rans_compact(words, flags)
    pflat, ptotal = port_rans.rans_compact_plain(words, flags)
    k = int(total)
    assert k == int(ptotal) == want.numel()
    assert torch.equal(flat[:k], pflat[:k]) and torch.equal(flat[:k], want)


def test_rans_compact_back_to_back_sizes_on_one_stream(cuda):
    """Launches of other sizes queued on one stream with no wait between
    them (each with its own scratch, freed and taken again on the stream):
    every result is right."""
    tile = cuda_kernels.COMPACT_TILE
    rng = np.random.default_rng(11)
    cases = [_compact_case(rng, m, {0: 0.7, 1: 0.2, 255: 0.1}, cuda)
             for m in (3 * tile + 5, 1, COMPACT_WAVES, tile + 1, 7 * tile, 2 * tile - 1, 5)]
    torch.cuda.synchronize()
    results = [cuda_kernels.rans_compact(w, f) for w, f, _ in cases * 3]
    for (_, _, want), (flat, total) in zip(cases * 3, results):
        assert int(total) == want.numel()
        assert torch.equal(flat[: want.numel()], want)


# the compaction's kernels, in launch order (csrc/rans_codec.cu)
COMPACT_KERNELS = ("rans_tile_counts_kernel", "rans_scan_tiles_kernel", "rans_scatter_kernel")


_PROFILE_COMPACT = """
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from fastqpacker_tpu_torch.ops import cuda_kernels
rng = np.random.default_rng(13)
m = 922 * 16384
words = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, m).astype(np.int16)).cuda()
flags = torch.from_numpy((rng.random(m) < 0.11).astype(np.uint8)).cuda()
cuda_kernels.rans_compact(words, flags)
torch.cuda.synchronize()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    cuda_kernels.rans_compact(words, flags)
    torch.cuda.synchronize()
print(json.dumps([e.key for e in prof.key_averages() if e.device_type.name == "CUDA"
                  for _ in range(e.count)]))
"""


def test_rans_compact_runs_its_three_kernels_and_nothing_else(cuda):
    """One wrapper call at the v3 quality stream's size runs the
    compaction's three kernels (counts, scan of the counts, scatter), one
    launch each, and no fill or copy. Profiled in a process of its own: in
    a long process the profiler can miss a session's kernels."""
    run = subprocess.run([sys.executable, "-c", _PROFILE_COMPACT, str(REPO)],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    ops = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(ops) == 3 and all(any(name in k for k in ops) for name in COMPACT_KERNELS), ops


def test_rans_compact_from_two_threads(cuda):
    """Two streams compact at once, each with its own scratch: every
    result is right, at many tiles and at a few."""
    tile = cuda_kernels.COMPACT_TILE
    rng = np.random.default_rng(14)
    cases = [_compact_case(rng, m, COMPACT_FLAGS["bytes_2_255"], cuda)
             for m in (40 * tile + 3, 3 * tile - 1)]
    torch.cuda.synchronize()
    _from_two_threads(lambda i: _compact_equal(*cases[i]), cuda)


@pytest.mark.parametrize("first", [1, 1025, 2049, 3073])
def test_rans_encode_reciprocal_at_every_frequency(first, cuda):
    """The encode divides by each symbol's frequency through a reciprocal:
    one table per frequency f (symbol 0 at f, the rest spread over the other
    255 symbols), a stream mostly of symbol 0, so the states run through the
    reachable range at that f; the kernel's words, flags and states equal
    the plain version's for every f in 1-4096 (four cases of 1,024)."""
    lanes, steps = 32, 40
    rng = np.random.default_rng(first)
    for f in range(first, first + 1024):
        freq = np.zeros(256, np.int64)
        freq[0] = f
        rest = 4096 - f
        if rest:
            k = min(255, rest)
            freq[1 : 1 + k] = rest // k
            freq[1 : 1 + rest % k] += 1
        cum = np.concatenate([[0], np.cumsum(freq)[:-1]])
        present = np.flatnonzero(freq)
        data = np.where(rng.random(steps * lanes) < 0.9, 0,
                        rng.choice(present, steps * lanes)).astype(np.uint8)
        fc = torch.from_numpy(np.stack([freq, cum]).astype(np.int32)).to(cuda)
        d = torch.from_numpy(data).to(cuda)
        got = cuda_kernels.rans_encode(d, steps, lanes, 0, fc)
        want = port_rans.rans_encode_plain(d, steps, lanes, 0, fc)
        for a, b in zip(got, want):
            assert torch.equal(a, b), f


def test_wctx_decode_from_two_threads_at_two_shared_sizes(cuda):
    """The sequence model at order 2 on 4,096 lanes (a cluster of 16 CTAs,
    a 32 KiB word ring each) and on 256 lanes (one CTA, 2 KiB) run the same
    decode instance from two threads at once, 300 rounds each; every launch
    matches the plain version. The shared-memory cap is set once per
    instance, so no launch finds it lowered by the other thread."""
    import torch_wctx_inputs as wi
    from fastqpacker_tpu_torch.ops import wctx

    cases = []
    for lanes in (4096, 256):
        rng = np.random.default_rng(lanes)
        c = _wctx_case(rng, 0, 2, lanes, 2 * lanes, 40)
        enc = wi.encode_tensors(c["symm"], c["ctxm"], c["seg"], c["freq_p"],
                                c["present"], cuda)
        words, flags, states, _ = cuda_kernels.wctx_encode(*enc)
        flat, total = cuda_kernels.rans_compact(words, flags)
        dec = (flat[: int(total)].clone(), states,
               *wi.decode_tensors(np.zeros(0, np.uint16), np.zeros(0, np.uint32),
                                  c["startm"], c["seg"], c["freq_p"], c["present"],
                                  cuda)[2:])
        want = wctx.wctx_decode_plain(*dec, 0, 2)
        cases.append((dec, want, cuda_kernels.wctx_decode_geometry(
            lanes, int(c["freq_p"].shape[0]), len(c["present"]) + 1).shared))
    assert cases[0][2] != cases[1][2]
    torch.cuda.synchronize()

    def call(i):
        dec, (pout, pinfo), _ = cases[i]
        out, info = cuda_kernels.wctx_decode(*dec, 0, 2)
        assert torch.equal(out, pout) and torch.equal(info, pinfo)

    _from_two_threads(call, cuda)


def test_wctx_encode_from_two_threads_at_two_shared_sizes(cuda):
    """The encode's table in shared memory: 16 contexts at order 2 (12 KiB
    of dynamic shared memory with the tiles) and 4,096 at order 6 (52 KiB,
    past the 48 KiB default) from two threads at once, 300 rounds each;
    every launch matches the plain version."""
    import torch_wctx_inputs as wi
    from fastqpacker_tpu_torch.ops import wctx

    cases = []
    for order in (2, 6):
        rng = np.random.default_rng(order)
        c = _wctx_case(rng, 0, order, 256, 400, 60)
        enc = wi.encode_tensors(c["symm"], c["ctxm"], c["seg"], c["freq_p"],
                                c["present"], cuda)
        cases.append((enc, wctx.wctx_encode_plain(*enc)))
    torch.cuda.synchronize()

    def call(i):
        enc, want = cases[i]
        for a, b in zip(cuda_kernels.wctx_encode(*enc), want):
            assert torch.equal(a, b)

    _from_two_threads(call, cuda)


class _Pipe(io.RawIOBase):
    """A reader that cannot be addressed (no buffer, no file): the bytes
    come as from a pipe."""

    def __init__(self, data):
        self._r = io.BytesIO(data)

    def readable(self):
        return True

    def readinto(self, b):
        got = self._r.read(min(len(b), 65536))
        b[: len(got)] = got
        return len(got)


def test_piped_wctx_container_decodes_through_several_workers(cuda):
    """A TAG_WCTX container from a pipe takes the per-block decoder, whose
    workers decode the sequence and quality streams (two shared sizes of
    the decode) from several threads at once on the card."""
    from fastqpacker_tpu_torch.pipeline import device as pdevice
    from fastqpacker_tpu_torch.pipeline import meshpipe

    one = len(synth_fastq(0, read_len=100))
    data = synth_fastq(9000 * one / (1 << 20), read_len=100, seed=13,
                       qual_model="phredwalk", seq_model="markov")
    comp = meshpipe.compress_mesh_bytes(data, tfq.Options(block_size=1800), [cuda])
    for _ in range(3):
        cuda_kernels.reset_launches()
        out = io.BytesIO()
        pdevice.decompress_device(io.BufferedReader(_Pipe(comp)), out,
                                  tfq.DecompressOptions(workers=6), device=cuda)
        assert out.getvalue() == data
        assert cuda_kernels.launches[cuda_kernels.WCTX_DECODE] > 5


def test_gpu_v3_compress_matches_cpu(cuda):
    """FQZ v3 on rANS-picking data: the card's container equals the CPU's,
    the qual stream of every block is TAG_RANS, and both decode."""
    data = synth_fastq(12, seed=5, qual_model="walk")
    opts = tfq.Options(version=3, block_size=20_000, workers=4)
    cuda_kernels.reset_launches()
    comp = tfq.compress_bytes(data, opts, device=cuda)
    counts = cuda_kernels.launches.as_dict()
    assert comp == tfq.compress_bytes(data, opts, device="cpu")
    r = io.BytesIO(comp)
    tfq.container.read_file_header(r)
    blocks = 0
    while (hdr := tfq.container.read_block_header(r, 3)) is not None:
        sizes = hdr.stream_sizes(2)
        payload = r.read(sum(sizes))
        assert payload[sizes[0]] == tfq.container.TAG_RANS
        blocks += 1
    assert counts[cuda_kernels.RANS_ENCODE] == counts[cuda_kernels.RANS_COMPACT] == blocks
    assert counts[cuda_kernels.ENCODE] == blocks and counts[cuda_kernels.CRC32] > 0
    cuda_kernels.reset_launches()
    assert tfq.decompress_bytes(comp, tfq.DecompressOptions(workers=4), device=cuda) == data
    assert cuda_kernels.launches[cuda_kernels.RANS_DECODE] == blocks
    assert cuda_kernels.launches[cuda_kernels.DECODE] == blocks


# ---------------------------------------------------------------------------
# context-modeled rANS (csrc/wctx_codec.cu)
# ---------------------------------------------------------------------------


def _wctx_case(rng, model, order, lanes, n_rec, hi_len):
    """One stream's host prep by the port's numpy functions, with ragged
    lanes: zero-length records, lanes with no symbols, a record longer
    than a lane."""
    import torch_wctx_inputs as wi
    from fastqpacker_tpu_torch.ops import wctx

    lengths = wi.rand_lengths(rng, n_rec, 0, hi_len)
    lengths[3] = 40 * hi_len
    lengths[10 : 10 + n_rec // 8] = 0
    syms = wi.symbols(rng, model, lengths)
    C = wctx.model_geometry(model, order)[0]
    sb, S, seg = wctx.stream_layout(lengths, lanes)
    startm = wctx.start_matrix(lengths, sb, S)
    symm = wctx.to_matrix(syms, sb, S, 0)
    ctxm = wctx.context_matrix(symm, startm, model, order)
    present, freq_p = wctx.build_tables(symm, ctxm, C, seg)
    return dict(lengths=lengths, syms=syms, sb=sb, S=S, seg=seg, startm=startm,
                symm=symm, ctxm=ctxm, present=present, freq_p=freq_p)


@pytest.mark.parametrize("lanes", [4, 32, 256, 512, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("model,order", [(0, 2), (0, 4), (0, 6), (1, 0), (1, 1)])
def test_wctx_kernels_match_plain(model, order, lanes, cuda):
    """Encode and decode against their plain versions, every output in
    full, and decode(encode(x)) == x."""
    import torch_wctx_inputs as wi
    from fastqpacker_tpu_torch.ops import wctx

    rng = np.random.default_rng(1000 * model + 10 * order + lanes)
    c = _wctx_case(rng, model, order, lanes, max(64, lanes // 2), 60)
    assert (c["seg"] == 0).any()
    enc = wi.encode_tensors(c["symm"], c["ctxm"], c["seg"], c["freq_p"],
                            c["present"], cuda)
    cuda_kernels.reset_launches()
    got = cuda_kernels.wctx_encode(*enc)
    want = wctx.wctx_encode_plain(*enc)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    words, flags, states, status = got
    assert int(status) == 0
    flat, total = cuda_kernels.rans_compact(words, flags)
    stream = flat[: int(total)].clone()
    dec = (stream, states,
           *wi.decode_tensors(np.zeros(0, np.uint16), np.zeros(0, np.uint32),
                              c["startm"], c["seg"], c["freq_p"], c["present"],
                              cuda)[2:])
    out, info = cuda_kernels.wctx_decode(*dec, model, order)
    pout, pinfo = wctx.wctx_decode_plain(*dec, model, order)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and torch.equal(info, pinfo)
    assert info.tolist() == [int(total), 0]
    idx = wctx.from_matrix(out.cpu().numpy(), c["sb"])
    assert np.array_equal(c["present"].astype(np.uint8)[idx], c["syms"])
    counts = cuda_kernels.launches.as_dict()
    assert counts[cuda_kernels.WCTX_ENCODE] == counts[cuda_kernels.WCTX_DECODE] == 1


@pytest.mark.parametrize("model,order", [(0, 6), (1, 1)])
def test_wctx_stream_api_matches_cpu_and_flags_corruption(model, order, cuda):
    import torch_wctx_inputs as wi
    from fastqpacker_tpu_torch.ops import wctx

    rng = np.random.default_rng(5 + model)
    lengths = wi.rand_lengths(rng, 3000, 0, 150)
    syms = wi.symbols(rng, model, lengths)
    good = wctx.encode_stream(syms, lengths, model, order, device=cuda)
    assert good == wctx.encode_stream(syms, lengths, model, order, device="cpu")
    assert np.array_equal(wctx.decode_stream(good, lengths, device=cuda), syms)
    p = wctx.parse_stream(good)
    nwords = len(p["words"])
    at = len(good) - 2 * nwords - 4 * p["N"] - 4
    lost = good[:at] + (nwords - 40).to_bytes(4, "little") + good[at + 4 : -80]
    with pytest.raises(wctx.WctxError, match="trailing wctx words"):
        wctx.decode_stream(lost, lengths, device=cuda)
    # an empty context row: the kernel flags it as the plain version does
    sb, S, seg = wctx.stream_layout(lengths, p["N"])
    freq_p = p["freq_p"].copy()
    freq_p[p["freq_p"].sum(axis=1).argmax() if model else 0] = 0
    dec = wi.decode_tensors(p["words"], p["states"],
                            wctx.start_matrix(lengths, sb, S), seg, freq_p,
                            p["present"], cuda)
    out, info = cuda_kernels.wctx_decode(*dec, model, order)
    pout, pinfo = wctx.wctx_decode_plain(*dec, model, order)
    torch.cuda.synchronize()
    assert int(pinfo[1]) == 1
    assert torch.equal(out, pout) and torch.equal(info, pinfo)


def test_wctx_encode_flags_an_invalid_table(cuda):
    import torch_wctx_inputs as wi
    from fastqpacker_tpu_torch.ops import wctx

    rng = np.random.default_rng(9)
    c = _wctx_case(rng, 0, 2, 256, 200, 40)
    freq_p = c["freq_p"].copy()
    ctx0 = int(c["ctxm"][1, 0])
    s = int(np.flatnonzero(c["present"] == c["symm"][1, 0])[0])
    freq_p[ctx0, (s + 1) % len(c["present"])] += freq_p[ctx0, s]
    freq_p[ctx0, s] = 0
    enc = wi.encode_tensors(c["symm"], c["ctxm"], c["seg"], freq_p, c["present"], cuda)
    got = cuda_kernels.wctx_encode(*enc)
    want = wctx.wctx_encode_plain(*enc)
    torch.cuda.synchronize()
    assert int(got[3]) == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    sym_idx = wctx._sym_to_idx(c["present"])[c["symm"]]
    with pytest.raises(wctx.WctxError, match="invalid wctx frequency table"):
        wctx.fetch_encoded(wctx.launch_encode(cuda, sym_idx, c["ctxm"], c["seg"], freq_p))


@pytest.mark.parametrize("d", [1, 4])
def test_gpu_mesh_container_matches_cpu(d, cuda):
    """``compress_mesh`` with the one card listed d times: the container
    equals the CPU's for the same d, TAG_WCTX is picked, both decoders of
    the card read it, and the launch counts follow the tags."""
    from fastqpacker_tpu_torch.parallel import mesh as pmesh
    from fastqpacker_tpu_torch.pipeline import meshpipe

    one = len(synth_fastq(0, read_len=100))
    data = synth_fastq(9000 * one / (1 << 20), read_len=100, seed=11,
                       qual_model="phredwalk", seq_model="markov")
    opts = tfq.Options(block_size=1800)
    cuda_kernels.reset_launches()
    comp = meshpipe.compress_mesh_bytes(data, opts, [cuda] * d)
    counts = cuda_kernels.launches.as_dict()
    assert comp == meshpipe.compress_mesh_bytes(
        data, opts, pmesh.make_mesh(d, device="cpu"))
    r = io.BytesIO(comp)
    tfq.container.read_file_header(r)
    n_wctx = blocks = 0
    while (hdr := tfq.container.read_block_header(r, 3)) is not None:
        sizes = hdr.stream_sizes(2)
        payload = r.read(sum(sizes))
        assert payload[sizes[0]] == tfq.container.TAG_WCTX
        n_wctx += 1 + (payload[0] == tfq.container.TAG_WCTX)
        blocks += 1
    assert blocks == 5 and n_wctx > blocks
    assert counts[cuda_kernels.WCTX_ENCODE] >= n_wctx  # candidates that lost too
    assert counts[cuda_kernels.RANS_COMPACT] == (
        counts[cuda_kernels.WCTX_ENCODE] + counts[cuda_kernels.RANS_ENCODE])
    cuda_kernels.reset_launches()
    out = io.BytesIO()
    meshpipe.decompress_mesh(io.BytesIO(comp), out, [cuda] * d)
    assert out.getvalue() == data
    assert cuda_kernels.launches[cuda_kernels.WCTX_DECODE] == n_wctx
    cuda_kernels.reset_launches()
    assert tfq.decompress_bytes(comp, device=cuda) == data  # routed by the tag
    assert cuda_kernels.launches[cuda_kernels.WCTX_DECODE] == n_wctx


@pytest.mark.parametrize("lanes", [256, 2048, 4096, 8192])
@pytest.mark.parametrize("model,order", [(0, 2), (1, 1)])
def test_wctx_corrupt_streams_at_every_cluster_size(model, order, lanes, cuda):
    """A stream that lost words reads zeros past the end of the word ring
    and raises "trailing wctx words"; an empty context row raises
    "corrupted wctx stream"; the kernel's outputs equal the plain version's
    on both, at clusters of 1, 8 and 16 CTAs."""
    import torch_wctx_inputs as wi
    from fastqpacker_tpu_torch.ops import wctx

    rng = np.random.default_rng(31 + lanes + model)
    lengths = wi.rand_lengths(rng, 4000, 0, 150)
    syms = wi.symbols(rng, model, lengths)
    good = wctx.encode_stream(syms, lengths, model, order, lanes=lanes, device=cuda)
    assert np.array_equal(wctx.decode_stream(good, lengths, device=cuda), syms)
    p = wctx.parse_stream(good)
    nwords = len(p["words"])
    at = len(good) - 2 * nwords - 4 * p["N"] - 4
    for lost in (3, 40, nwords // 2):
        bad = good[:at] + (nwords - lost).to_bytes(4, "little") + good[at + 4 : -2 * lost]
        with pytest.raises(wctx.WctxError, match="trailing wctx words"):
            wctx.decode_stream(bad, lengths, device=cuda)
    sb, S, seg = wctx.stream_layout(lengths, lanes)
    startm = wctx.start_matrix(lengths, sb, S)
    for words, freq_p in (
        (p["words"][: nwords - nwords // 2], p["freq_p"]),
        (p["words"], _without_a_used_row(p["freq_p"], model)),
    ):
        dec = wi.decode_tensors(words, p["states"], startm, seg, freq_p,
                                p["present"], cuda)
        out, info = cuda_kernels.wctx_decode(*dec, model, order)
        pout, pinfo = wctx.wctx_decode_plain(*dec, model, order)
        torch.cuda.synchronize()
        assert torch.equal(out, pout) and torch.equal(info, pinfo)
        # words missing: more consumed than carried; a row emptied: flagged
        assert int(info[0]) != len(words) or int(info[1]) == 1
    # the stream API raises as the CPU's does on the same input
    q = {**p, "freq_p": _without_a_used_row(p["freq_p"], model)}
    with pytest.raises(wctx.WctxError) as on_cpu:
        wctx.fetch_decoded(wctx.launch_decode(torch.device("cpu"), q, lengths))
    with pytest.raises(wctx.WctxError, match=f"^{on_cpu.value}$"):
        wctx.fetch_decoded(wctx.launch_decode(cuda, q, lengths))


def _without_a_used_row(freq_p, model):
    out = freq_p.copy()
    out[freq_p.sum(axis=1).argmax() if model else 0] = 0
    return out


WCTX_TIERS = [32, 64, 128, 256, 512, 1024, 2048, 4096, 8192]


@pytest.mark.parametrize("lanes", WCTX_TIERS)
@pytest.mark.parametrize("model,order", [(0, 2), (0, 4), (0, 6), (1, 0), (1, 1)])
def test_wctx_decode_geometry_owns_every_lane_once(model, order, lanes, cuda):
    """The geometry the decode's C entry launches, read from its library,
    for every lane tier and each model's widest table (4 base codes, 64
    quality values): one lane per thread, each lane owned once, a cluster of
    at most 16 CTAs, at most 227 KB of shared memory per CTA; several SMs
    from 512 lanes up; the table in shared memory except the 3,072-context
    quality order-1 table, read through the read-only cache."""
    from fastqpacker_tpu_torch.ops import wctx

    C = wctx.model_geometry(model, order)[0]
    width = (4 if model == 0 else wctx.B_MAX) + 1
    g = cuda_kernels.wctx_decode_geometry(lanes, C, width)
    assert g.threads % 32 == 0 and 32 <= g.threads <= 512
    assert 1 <= g.cluster <= 16 and g.cluster & (g.cluster - 1) == 0
    # thread i of CTA r owns lane r * threads + i
    owner = np.zeros(lanes, np.int64)
    for r in range(g.cluster):
        owner[r * g.threads : (r + 1) * g.threads] += 1
    assert g.cluster * g.threads == lanes and (owner == 1).all()
    assert g.table_shared == ((model, order) != (1, 1))
    # the ring holds two steps' worst case ahead, one step in use and the
    # 16-byte alignment slack; eight start-mask rows of the CTA's lanes
    table = 2 * C * width if g.table_shared else 0
    assert g.shared == 2 * 4 * lanes + 8 * g.threads + table <= 227 * 1024
    assert g.cluster == (1 if lanes <= 256 else 16 if lanes == 8192 else lanes // 256)


@pytest.mark.parametrize("lanes", [16, 3000, 16384])
def test_wctx_decode_geometry_refuses_lanes_outside_the_kernel(lanes, cuda):
    with pytest.raises(ValueError, match="no decode geometry"):
        cuda_kernels.wctx_decode_geometry(lanes, 16, 5)


# ---------------------------------------------------------------------------
# the CLI surfaces: check, cat (ranges), --pair
# ---------------------------------------------------------------------------


def _tags_per_block(comp: bytes) -> list[tuple[int, int]]:
    """(seq tag, qual tag) of each block of a v3 container."""
    r = io.BytesIO(comp)
    fh = tfq.container.read_file_header(r)
    rows = []
    while (hdr := tfq.container.read_block_header(r, fh.version)) is not None:
        sizes = hdr.stream_sizes(2)
        payload = r.read(sum(sizes))
        rows.append((payload[0], payload[sizes[0]]))
    return rows


def _check(path, device):
    from fastqpacker_tpu_torch.cli import inspect as port_inspect

    out = io.StringIO()
    return port_inspect.check(str(path), out=out, device=device), out.getvalue()


def test_check_and_cat_on_the_card_equal_the_cpu(cuda, tmp_path):
    """``check`` and ``cat`` on v2 and v3: the card's output equals the
    CPU's, and the decode kernels launch for the covering blocks only (v2:
    one dense decode per block; v3: one rANS decode per TAG_RANS stream,
    CRC32 launched)."""
    from fastqpacker_tpu_torch.pipeline import ranges

    data = synth_fastq(6, seed=21, qual_model="walk")
    for version, block in ((2, 5_000), (3, 5_000)):
        path = tmp_path / f"v{version}.fqz"
        comp = tfq.compress_bytes(data, tfq.Options(version=version, block_size=block),
                                  device="cpu")
        path.write_bytes(comp)
        blocks = len(ranges.index_path(str(path)).entries)
        assert blocks >= 3
        cuda_kernels.reset_launches()
        got = _check(path, cuda)
        counts = cuda_kernels.launches.as_dict()
        assert got == _check(path, "cpu") == (0, f"OK: decoded {len(data):,} bytes of FASTQ\n")
        assert counts[cuda_kernels.DECODE] == blocks
        if version == 3:
            n_rans = sum((s == 0) + (q == 0) for s, q in _tags_per_block(comp))
            assert counts[cuda_kernels.RANS_DECODE] == n_rans >= blocks
            assert counts[cuda_kernels.CRC32] > 0
        n = data.count(b"\n") // 4
        for start, stop, covered in ((block - 3, block + 2, 2), (n - 1, n, 1), (5, 6, 1)):
            cuda_kernels.reset_launches()
            got = ranges.read_record_range(str(path), start, stop, device=cuda)
            assert cuda_kernels.launches[cuda_kernels.DECODE] == covered
            assert got == ranges.read_record_range(str(path), start, stop, device="cpu")
        bad = bytearray(comp)
        bad[len(bad) // 2] ^= 0xFF
        path.write_bytes(bytes(bad))
        rc, line = _check(path, cuda)
        assert (rc, line) == _check(path, "cpu") and rc == 1
        assert line.startswith("check FAILED: ")


def test_mesh_container_cat_launches_for_the_covering_blocks_only(cuda, tmp_path):
    """``cat`` of a ``--mesh`` container on the card: one ``fq_wctx_decode``
    per TAG_WCTX stream of the covering blocks, nothing for the others; the
    bytes equal the CPU's; ``check`` decodes every stream on the card."""
    from fastqpacker_tpu_torch.pipeline import meshpipe, ranges

    one = len(synth_fastq(0, read_len=100))
    data = synth_fastq(5400 * one / (1 << 20), read_len=100, seed=17,
                       qual_model="phredwalk", seq_model="markov")
    comp = meshpipe.compress_mesh_bytes(data, tfq.Options(block_size=1800), [cuda])
    path = tmp_path / "m.fqz"
    path.write_bytes(comp)
    wctx = [(s == 6) + (q == 6) for s, q in _tags_per_block(comp)]
    assert len(wctx) == 3 and all(wctx)
    for start, stop, covering in ((1795, 1805, (0, 1)), (3700, 3701, (2,))):
        cuda_kernels.reset_launches()
        got = ranges.read_record_range(str(path), start, stop, device=cuda)
        assert cuda_kernels.launches[cuda_kernels.WCTX_DECODE] == sum(wctx[i] for i in covering)
        assert cuda_kernels.launches[cuda_kernels.DECODE] == len(covering)
        assert got == ranges.read_record_range(str(path), start, stop, device="cpu")
    cuda_kernels.reset_launches()
    assert _check(path, cuda) == (0, f"OK: decoded {len(data):,} bytes of FASTQ\n")
    assert cuda_kernels.launches[cuda_kernels.WCTX_DECODE] == sum(wctx)


@pytest.mark.parametrize("version", [2, 3])
def test_paired_on_the_card_equals_the_cpu(version, cuda):
    """``compress_paired`` / ``decompress_paired`` on the card: the same
    container as the CPU's, the two mate files back, one dense encode and
    one dense decode per block."""
    from fastqpacker_tpu_torch.pipeline import api

    data = synth_fastq(4, seed=23, qual_model="walk")
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)[3::4] + 1
    recs = np.split(np.frombuffer(data, np.uint8), nl[:-1])
    recs = recs[: len(recs) // 2 * 2]
    r1 = b"".join(r.tobytes() for r in recs[0::2])
    r2 = b"".join(r.tobytes() for r in recs[1::2])
    opts = tfq.Options(version=version, block_size=5_000)
    comps = {}
    for dev in (cuda, "cpu"):
        cuda_kernels.reset_launches()
        out = io.BytesIO()
        api.compress_paired(io.BytesIO(r1), io.BytesIO(r2), out, opts, device=dev)
        comps[str(dev)] = (out.getvalue(), cuda_kernels.launches.as_dict())
    comp, counts = comps[str(cuda)]
    assert comp == comps["cpu"][0]
    blocks = len(_tags_per_block(comp))
    assert counts[cuda_kernels.ENCODE] == blocks
    if version == 3:
        assert counts[cuda_kernels.RANS_ENCODE] == counts[cuda_kernels.RANS_COMPACT] >= blocks
    cuda_kernels.reset_launches()
    w1, w2 = io.BytesIO(), io.BytesIO()
    api.decompress_paired(io.BytesIO(comp), w1, w2, device=cuda)
    assert (w1.getvalue(), w2.getvalue()) == (r1, r2)
    assert cuda_kernels.launches[cuda_kernels.DECODE] == blocks


def _card_mesh(cuda, d=4):
    """d shard devices: the first d cards, or the one card listed d times."""
    n = torch.cuda.device_count()
    if n >= d:
        return [torch.device("cuda", i) for i in range(d)]
    return [torch.device("cuda", torch.cuda.current_device())] * d


def test_sharded_dense_on_the_card_equals_the_cpu(cuda):
    """``encode_blocks_parallel`` / ``decode_sharded`` over four shard
    devices: arrays and offsets equal to four CPU entries', one dense encode
    and decode per shard, each shard's outputs on its device."""
    from fastqpacker_tpu_torch.parallel import mesh as pmesh

    mesh = _card_mesh(cuda)
    rng = np.random.default_rng(41)
    seq, qual, lengths = _block(rng, 4 * 300, 151)
    cuda_kernels.reset_launches()
    encs, offsets = pmesh.encode_blocks_parallel(seq, qual, lengths, 33, mesh)
    s, q = pmesh.decode_sharded([e.packed for e in encs], [e.qual_delta for e in encs],
                                pmesh.shard_rows(lengths, mesh), qual_offset=33, mesh=mesh)
    assert cuda_kernels.launches[cuda_kernels.ENCODE] == 4
    assert cuda_kernels.launches[cuda_kernels.DECODE] == 4
    assert all(e.packed.device == dev for e, dev in zip(encs, mesh))
    want, want_offsets = pmesh.encode_blocks_parallel(
        seq, qual, lengths, 33, pmesh.make_mesh(4, device="cpu"))
    got, ref = pmesh.gather_encoded(encs), pmesh.gather_encoded(want)
    for f in ("packed", "nmask_bits", "n_counts", "qual_delta"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert np.array_equal(offsets, want_offsets)
    ws, wq = pmesh.decode_sharded(
        [e.packed for e in want], [e.qual_delta for e in want],
        pmesh.shard_rows(lengths, pmesh.make_mesh(4, device="cpu")), qual_offset=33,
        mesh=pmesh.make_mesh(4, device="cpu"))
    assert np.array_equal(pmesh.gather_rows(s), pmesh.gather_rows(ws))
    assert np.array_equal(pmesh.gather_rows(q), pmesh.gather_rows(wq))


@pytest.mark.parametrize("lanes", [256, 4096])
def test_sharded_entropy_on_the_card_equals_the_cpu(lanes, cuda):
    """``entropy_encode_sharded`` / ``entropy_decode_sharded`` over four
    shard devices with ragged stream lengths: words, states, totals and
    offsets equal to the CPU's, and the round trip."""
    from fastqpacker_tpu_torch.parallel import mesh as pmesh

    mesh, cpu = _card_mesh(cuda), pmesh.make_mesh(4, device="cpu")
    rng = np.random.default_rng(lanes)
    m = 3 * lanes + 17
    streams = rng.integers(0, 40, (4, m)).astype(np.uint8)
    raw_lens = np.array([m, 0, lanes + 1, m - 5])
    freq_cum, pad_sym = pmesh.entropy_table(streams, raw_lens=raw_lens, lanes=lanes)
    for i, n in enumerate(raw_lens):
        streams[i, n:] = pad_sym
    kw = dict(pad_sym=pad_sym, m_per_shard=m, lanes=lanes)
    got = pmesh.entropy_encode_sharded(streams, freq_cum, raw_lens, mesh=mesh, **kw)
    want = pmesh.entropy_encode_sharded(streams, freq_cum, raw_lens, mesh=cpu, **kw)
    assert np.array_equal(got.totals, want.totals) and np.array_equal(got.offsets, want.offsets)
    for k in range(4):
        t = int(got.totals[k])
        assert torch.equal(got.words[k][:t].cpu(), want.words[k][:t])
        assert torch.equal(got.states[k].cpu(), want.states[k])
    out = pmesh.entropy_decode_sharded(got.words, got.states, freq_cum, raw_lens, mesh=mesh,
                                       m_per_shard=m, lanes=lanes)
    for k, n in enumerate(raw_lens):
        assert np.array_equal(out[k].cpu().numpy()[:n], streams[k, :n])


def test_threaded_mesh_round_equals_the_calling_thread(cuda, monkeypatch):
    """``compress_mesh`` / ``decompress_mesh`` through the one card listed
    four times: the dispatcher's worker threads give the container of the
    calling thread and of four CPU entries."""
    from fastqpacker_tpu_torch.parallel import mesh as pmesh
    from fastqpacker_tpu_torch.pipeline import meshpipe

    one = len(synth_fastq(0, read_len=100))
    data = synth_fastq(7200 * one / (1 << 20), read_len=100, seed=12,
                       qual_model="phredwalk", seq_model="markov")
    opts = tfq.Options(block_size=1800)
    mesh = _card_mesh(cuda)
    threaded = meshpipe.compress_mesh_bytes(data, opts, mesh)
    out = io.BytesIO()
    meshpipe.decompress_mesh(io.BytesIO(threaded), out, mesh)
    assert out.getvalue() == data
    orig = pmesh.for_each_device
    monkeypatch.setattr(pmesh, "for_each_device",
                        lambda m, f, items, threads=None: orig(m, f, items, False))
    assert meshpipe.compress_mesh_bytes(data, opts, mesh) == threaded
    assert threaded == meshpipe.compress_mesh_bytes(data, opts, pmesh.make_mesh(4, device="cpu"))


@pytest.mark.parametrize("version", [2, 3])
def test_multihost_on_the_card_equals_the_cpu(version, cuda, tmp_path):
    """``simulate_multihost`` / ``simulate_multihost_decompress`` with three
    hosts on the card: the file equals the CPU's, its decode is the input,
    and the kernels ran."""
    from fastqpacker_tpu_torch.parallel import multihost as mh

    data = synth_fastq(3, seed=31, qual_model="walk")
    src = tmp_path / "in.fq"
    src.write_bytes(data)
    opts = tfq.Options(version=version, block_size=4000)
    cuda_kernels.reset_launches()
    mh.simulate_multihost(str(src), str(tmp_path / "gpu.fqz"), 3, opts, device=cuda)
    assert cuda_kernels.launches[cuda_kernels.ENCODE] > 0
    mh.simulate_multihost(str(src), str(tmp_path / "cpu.fqz"), 3, opts, device="cpu")
    comp = (tmp_path / "gpu.fqz").read_bytes()
    assert comp == (tmp_path / "cpu.fqz").read_bytes()
    cuda_kernels.reset_launches()
    mh.simulate_multihost_decompress(str(tmp_path / "gpu.fqz"), str(tmp_path / "o.fq"), 3,
                                     device=cuda)
    assert (tmp_path / "o.fq").read_bytes() == data
    assert cuda_kernels.launches[cuda_kernels.DECODE] > 0
    if version == 3:
        assert cuda_kernels.launches[cuda_kernels.RANS_DECODE] > 0


_GLOO_WORKER = r"""
import sys
import torch.distributed as dist
sys.path.insert(0, sys.argv[6])
import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu_torch.parallel import multihost as mh

pid, nproc, port, in_path, out_path = sys.argv[1:6]
mh.init_distributed(f"127.0.0.1:{port}", int(nproc), int(pid), timeout=120)
mh.compress_multihost(in_path, out_path, tfq.Options(version=3, block_size=4000))
dist.barrier()
mh.decompress_multihost(out_path, out_path + ".fq")
dist.barrier()
dist.destroy_process_group()
"""


@pytest.mark.timeout(300)
def test_two_process_gloo_on_the_card_equals_the_simulation(cuda, tmp_path):
    """Two processes in a gloo group, each on ``cuda:(rank % count)`` (both
    on the one card of a one-card machine): the file equals the simulation
    and decodes to the input."""
    import socket

    from fastqpacker_tpu_torch.parallel import multihost as mh

    data = synth_fastq(3, seed=33, qual_model="walk")
    src, out = tmp_path / "in.fq", tmp_path / "out.fqz"
    src.write_bytes(data)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(rank), "2", str(port),
                               str(src), str(out), str(REPO)], stderr=subprocess.PIPE)
             for rank in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err.decode(errors="replace")[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    mh.simulate_multihost(str(src), str(tmp_path / "sim.fqz"), 2,
                          tfq.Options(version=3, block_size=4000), device=cuda)
    assert out.read_bytes() == (tmp_path / "sim.fqz").read_bytes()
    assert (tmp_path / "out.fqz.fq").read_bytes() == data


@pytest.mark.parametrize("kind", ["rans", "wctx"])
def test_corrupt_stream_strings_on_the_card_equal_the_cpu(kind, cuda):
    """A flipped bit inside a TAG_RANS (v3) or TAG_WCTX (``--mesh``) stream
    of an addressable container: the card's default decoder (the rANS kernel;
    the batched TAG_WCTX route) says the CPU's string, the JAX package's
    whole-file one; read from a stream that cannot be addressed, the
    per-block string stays."""
    from fastqpacker_tpu_torch.pipeline import meshpipe
    from fastqpacker_tpu_torch.pipeline.blocks import RUNTIME_STREAM_ERRORS

    if kind == "rans":
        data = synth_fastq(1, seed=35, qual_model="walk")
        comp = tfq.compress_bytes(data, tfq.Options(version=3, workers=1), device="cpu")
        slot, tag = 1, tfq.container.TAG_RANS
    else:
        one = len(synth_fastq(0, read_len=100))
        data = synth_fastq(3600 * one / (1 << 20), read_len=100, seed=37,
                           qual_model="phredwalk", seq_model="markov")
        comp = meshpipe.compress_mesh_bytes(data, tfq.Options(block_size=1800), [cuda])
        slot, tag = 1, tfq.container.TAG_WCTX
    r = io.BytesIO(comp)
    tfq.container.read_file_header(r)
    sizes = tfq.container.read_block_header(r, 3).stream_sizes(2)
    start = r.tell() + sum(sizes[:slot])
    assert comp[start] == tag
    for k in range(4):
        bad = bytearray(comp)
        bad[start + 1 + (2 * k + 1) * (sizes[slot] - 1) // 8] ^= 1 << k
        bad = bytes(bad)
        outcomes = []
        for dev in (cuda, "cpu"):
            try:
                tfq.decompress_bytes(bad, device=dev)
                outcomes.append(("ok", ""))
            except Exception as e:
                outcomes.append((type(e).__name__, str(e)))
        assert outcomes[0] == outcomes[1] and outcomes[0][0] != "ok", k
        if outcomes[0][1] == RUNTIME_STREAM_ERRORS[tag]:
            pipe = io.BufferedReader(io.BytesIO(bad))
            with pytest.raises(Exception) as per_block:
                tfq.decompress(pipe, io.BytesIO(), device=cuda)
            assert str(per_block.value) != RUNTIME_STREAM_ERRORS[tag]


# ---------------------------------------------------------------------------
# fqpack bench and --backend auto on the card
# ---------------------------------------------------------------------------

BENCH_KERNEL_METRICS = {
    "kernel": ("encode_kernel_throughput", cuda_kernels.ENCODE),
    "decode-kernel": ("decode_kernel_throughput", cuda_kernels.DECODE),
    "mesh-entropy": ("mesh_entropy_encode_throughput", cuda_kernels.RANS_COMPACT),
    "mesh-entropy-decode": ("mesh_entropy_decode_throughput", cuda_kernels.RANS_DECODE),
    "wctx-entropy": ("wctx_entropy_encode_throughput", cuda_kernels.WCTX_ENCODE),
    "wctx-entropy-decode": ("wctx_entropy_decode_throughput", cuda_kernels.WCTX_DECODE),
}


@pytest.mark.parametrize("metric", sorted(BENCH_KERNEL_METRICS))
def test_bench_kernel_metric_on_the_card(metric, cuda):
    """``fqpack bench --mb 2 --metric M`` on the card: exit 0, one JSON line
    with the JAX bench's metric name and a value > 0, and the metric's
    kernel launched (the launch counts on stderr)."""
    name, kernel = BENCH_KERNEL_METRICS[metric]
    p = subprocess.run(
        [sys.executable, "-m", "fastqpacker_tpu_torch.cli.fqpack", "bench", "--mb", "2",
         "--metric", metric],
        capture_output=True, text=True, cwd=REPO, timeout=600,
    )
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got["metric"] == name and got["unit"] == "MB/s" and got["value"] > 0
    launches = json.loads(p.stderr.splitlines()[-1].removeprefix("launches "))
    assert launches[kernel] > 0


def test_bench_wall_clock_and_mesh_e2e_on_the_card(cuda):
    from fastqpacker_tpu_torch import bench

    short = {"window_s": 0.2, "min_s": 0.0, "cap_s": 2.0}
    data = bench.synth_fastq(4)
    for v3 in (False, True):
        mbps, ratio, _ = bench.bench_compress(data, cuda, 1, v3=v3, **short)
        _, cpu_ratio, _ = bench.bench_compress(data, "cpu", 1, v3=v3, **short)
        assert mbps > 0 and ratio == cpu_ratio
        assert bench.bench_decompress(data, cuda, 1, v3=v3, **short)[0] > 0
    cuda_kernels.reset_launches()
    mbps, ratio = bench.bench_mesh_e2e(1, repeats=1, device=cuda)
    assert mbps > 0 and ratio > 1
    assert cuda_kernels.launches[cuda_kernels.WCTX_ENCODE] > 0


def test_make_mesh_starts_at_the_named_card(cuda):
    from fastqpacker_tpu_torch.parallel import mesh as pmesh

    last = torch.cuda.device_count() - 1
    assert pmesh.make_mesh(1, "cuda:0") == [torch.device("cuda", 0)]
    assert pmesh.make_mesh(None, f"cuda:{last}") == [torch.device("cuda", last)]
    with pytest.raises(ValueError):
        pmesh.make_mesh(2, f"cuda:{last}")


def test_transfer_bandwidth_on_the_card(cuda):
    from fastqpacker_tpu_torch.pipeline import auto

    mbps = auto.transfer_bandwidth_mbps(cuda)
    assert np.isfinite(mbps) and mbps > 0


def test_backend_auto_chooses_the_card(cuda, tmp_path):
    """``--backend auto`` with an empty probe cache measures the card's
    transfer rate, takes the card and says so; the container equals
    ``--backend cuda``'s. Under ``FQZ_BACKEND=cpu`` it takes the CPU, with
    the same container."""
    import os

    src = tmp_path / "in.fq"
    src.write_bytes(synth_fastq(2, seed=41))
    env = {**os.environ, "TMPDIR": str(tmp_path), "PYTHONPATH": str(REPO)}
    env.pop("FQZ_BACKEND", None)

    def run(backend, out, **extra):
        p = subprocess.run(
            [sys.executable, "-m", "fastqpacker_tpu_torch.cli.fqpack", "--backend", backend,
             "-i", str(src), "-o", str(out)],
            capture_output=True, text=True, cwd=REPO, timeout=300, env={**env, **extra},
        )
        assert p.returncode == 0, p.stderr
        return p.stderr

    err = run("auto", tmp_path / "auto.fqz")
    assert err.startswith("backend auto: cuda (transfer ") and err.endswith(" MB/s)\n")
    assert run("cuda", tmp_path / "cuda.fqz") == ""
    assert run("auto", tmp_path / "cached.fqz") == "backend auto: cuda (cached probe)\n"
    err = run("auto", tmp_path / "cpu.fqz", FQZ_BACKEND="cpu")
    assert err == "backend auto: cpu (FQZ_BACKEND=cpu)\n"
    want = (tmp_path / "cuda.fqz").read_bytes()
    for name in ("auto", "cached", "cpu"):
        assert (tmp_path / f"{name}.fqz").read_bytes() == want


# ---------------------------------------------------------------------------
# the block stages (csrc/records.cu): scan, gather, stream build, assembly
# ---------------------------------------------------------------------------


def _records_text(seed, n, read_len, crlf=False, varlen=False, n_rich=False, plus=False):
    rng = np.random.default_rng(seed)
    nl = b"\r\n" if crlf else b"\n"
    bases = np.frombuffer(b"ACGTNNNNacgtRY." if n_rich else b"ACGTN", np.uint8)
    recs = []
    for i in range(n):
        ln = int(rng.integers(0, read_len + 1)) if varlen else read_len
        seq = bases[rng.integers(0, len(bases), ln)].tobytes()
        qual = rng.integers(33, 75, ln).astype(np.uint8).tobytes()
        hdr = b"r%d" % i if varlen else b"r%07d" % i
        p = hdr if plus else b""
        recs.append(b"@" + hdr + nl + seq + nl + b"+" + p + nl + qual + nl)
    return b"".join(recs)


def _normalized(data: bytes) -> bytes:
    """The text a round trip gives back: CR stripped, bases upper case,
    every non-ACGT base an N (the wire keeps 2-bit codes and N positions)."""
    lines = data.replace(b"\r", b"").split(b"\n")
    for i in range(1, len(lines), 4):
        b = np.frombuffer(lines[i], np.uint8) & 0xDF
        lines[i] = np.where(np.isin(b, np.frombuffer(b"ACGT", np.uint8)), b,
                            ord("N")).astype(np.uint8).tobytes()
    return b"\n".join(lines)


RECORD_TEXTS = {
    "uniform151": dict(n=3000, read_len=151),
    "varlen_crlf_plus": dict(n=2000, read_len=300, crlf=True, varlen=True, plus=True),
    "n_rich_varlen": dict(n=2500, read_len=90, varlen=True, n_rich=True),
    "one_record": dict(n=1, read_len=7),
}


@pytest.mark.parametrize("name", sorted(RECORD_TEXTS))
@pytest.mark.parametrize("wide", [False, True])
def test_records_kernels_match_plain(name, wide, cuda):
    """The four block-stage kernels against their plain versions, byte for
    byte, and the text rebuilt from the streams equal to the input."""
    from fastqpacker_tpu_torch.ops import records as recops
    from fastqpacker_tpu_torch.pipeline import blocks as pblocks

    data = _records_text(len(name), **RECORD_TEXTS[name])
    text = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda)
    for max_records in (1, 3, 5000):
        got = cuda_kernels.records_scan(text, max_records)
        want = recops.records_scan_plain(text, max_records)
        n = int(want[2][recops.SCAN_COUNT])
        assert torch.equal(got[2], want[2])
        assert torch.equal(got[0][:n], want[0][:n]) and torch.equal(got[1][:n], want[1][:n])
    offsets, _, info = got
    n = int(info[recops.SCAN_COUNT])
    offsets = offsets[:n]
    width = pblocks.bucket_len(int(info[recops.SCAN_SEQ_MAX]))
    rows = []
    for col, fill in ((2, 0), (6, 0xFF)):
        g = cuda_kernels.rows_gather(text, offsets[:, col], offsets[:, 3], n + 5, width, fill)
        assert torch.equal(g, recops.rows_gather_plain(text, offsets[:, col], offsets[:, 3],
                                                       n + 5, width, fill))
        rows.append(g)
    lens32 = torch.zeros(n + 5, dtype=torch.int32, device=cuda)
    lens32[:n] = offsets[:, 3]
    enc = cuda_kernels.encode_arrays(*rows, lens32, 33, npos_cap=(1 << 31) - 1 if wide else 1 << 16)
    sizes = recops.stream_sizes(info.cpu().numpy(), wide)
    args = (text, offsets, enc.packed, enc.qual_delta, enc.nmask_bits, enc.n_counts, wide, sizes)
    buf, binfo = cuda_kernels.streams_build(*args)
    pbuf, pinfo = recops.streams_build_plain(*args)
    assert torch.equal(buf, pbuf) and torch.equal(binfo, pinfo)
    cut = np.cumsum([0] + sizes)
    seq_s, qual_s, hdr_s, plus_s, npos_s, len_s = (buf[cut[i] : cut[i + 1]] for i in range(6))
    lens = len_s.clone().view(torch.int32).to(torch.int64)
    packed = cuda_kernels.rows_gather(seq_s, None, (lens + 3) >> 2, n, width // 4, 0)
    deltas = cuda_kernels.rows_gather(qual_s, None, lens, n, width, 0)
    assert torch.equal(packed, recops.rows_gather_plain(seq_s, None, (lens + 3) >> 2, n,
                                                        width // 4, 0))
    seq, qual = cuda_kernels.decode_arrays(packed, deltas, lens.to(torch.int32), 33)
    for plus in (plus_s, None):  # v2, and v1's bare '+'
        a = (seq, qual, lens, hdr_s, plus, npos_s, wide, sizes[5], sizes[0], sizes[1])
        out, ainfo = cuda_kernels.fastq_assemble(*a)
        pout, pinfo = recops.fastq_assemble_plain(*a)
        total = int(pinfo[0])
        assert torch.equal(ainfo, pinfo) and torch.equal(out[:total], pout[:total])
        if plus is not None:
                assert bytes(out[:total].cpu().numpy()) == _normalized(data)


@pytest.mark.parametrize("field", ["seq", "qual", "headers", "plus", "npos", "lengths"])
def test_records_stream_faults_on_the_card_equal_the_cpu(field, cuda):
    """A truncated or flipped byte in each decoded stream: the card's
    assembly gives the CPU's text or the CPU's error, type and string."""
    from fastqpacker_tpu_torch.entropy import zstd as pzstd
    from fastqpacker_tpu_torch.pipeline import blocks as pblocks

    data = _records_text(5, 400, 80, varlen=True, n_rich=True, plus=True)
    comp = tfq.compress_bytes(data, tfq.Options(block_size=1000), device="cpu")
    C = tfq.container
    hdr = C.parse_block_header(comp[C.FILE_HEADER_SIZE :], 2)
    ds = pblocks.decode_streams(hdr, comp[C.FILE_HEADER_SIZE + C.BLOCK_HEADER_SIZE_V2 :], 2,
                                pzstd.get_codec())
    orig = getattr(ds, field)
    for k in range(6):
        if k < 3:
            bad = orig[: max(len(orig) - 1 - k * len(orig) // 3, 0)]
        else:
            bad = orig.copy()
            bad[(k - 3) * len(orig) // 3] ^= 0x37
        setattr(ds, field, bad)
        outs = []
        for dev in (cuda, "cpu"):
            try:
                outs.append(("ok", pblocks.streams_to_fastq(ds, 33, dev)))
            except ValueError as e:
                outs.append((type(e).__name__, str(e)))
        assert outs[0] == outs[1]
    setattr(ds, field, orig)


def test_records_v2_container_and_text_equal_the_cpu_at_two_blocks(cuda):
    """The v2 route end to end on the card: a container of two blocks equal
    to the CPU's, decoded to the input, the block stages launched per block."""
    data = _records_text(6, 75_000, 151)
    cuda_kernels.reset_launches()
    comp = tfq.compress_bytes(data, device=cuda)
    counts = cuda_kernels.launches.as_dict()
    assert comp == tfq.compress_bytes(data, device="cpu")
    assert counts[cuda_kernels.STREAMS_BUILD] == 2 and counts[cuda_kernels.ROWS_GATHER] == 4
    assert counts[cuda_kernels.RECORDS_SCAN] >= 2
    cuda_kernels.reset_launches()
    assert tfq.decompress_bytes(comp, device=cuda) == data
    assert cuda_kernels.launches[cuda_kernels.FASTQ_ASSEMBLE] == 2
    # one pair gather (quality deltas and packed bases) per block
    assert cuda_kernels.launches[cuda_kernels.ROWS_GATHER] == 2


def test_records_failing_build_raises_and_never_runs_the_plain_version(cuda, monkeypatch):
    """No fallback: when the block stages' library does not build, a CUDA
    tensor raises; nothing runs the plain version in its place."""
    from fastqpacker_tpu_torch.ops import build
    from fastqpacker_tpu_torch.ops import records as recops

    def fail(name):
        raise RuntimeError(f"nvcc failed to build {name}.cu")

    def plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(build, "_libs", {k: v for k, v in build._libs.items() if k != "records"})
    monkeypatch.setattr(build, "_compile", fail)
    monkeypatch.setattr(recops, "records_scan_plain", plain)
    text = torch.from_numpy(np.frombuffer(b"@r\nAC\n+\nII\n", np.uint8).copy()).to(cuda)
    with pytest.raises(RuntimeError, match="nvcc failed to build records.cu"):
        cuda_kernels.records_scan(text, 4)
    with pytest.raises(RuntimeError, match="nvcc failed to build records.cu"):
        tfq.compress_bytes(b"@r\nAC\n+\nII\n", device=cuda)


GATHER_WIDTHS = [40, 80, 160, 45, 7, 0]


@pytest.mark.parametrize("width", GATHER_WIDTHS)
@pytest.mark.parametrize("offset", [0, 1, 3, 13])
def test_records_gather_matches_plain_at_tile_edges(width, offset, cuda):
    """Both routes of the gather and the pair gather, byte for byte against
    the plain version: rows one short of, at and one past the tile edges,
    sources that are views at odd byte offsets, starts that ascend and
    starts that do not (some before the source, some past its end), lengths
    of 0 and past the width, rows past the runs."""
    from fastqpacker_tpu_torch.ops import records as recops

    import torch_records_inputs as ri

    edges = set()
    for tile in (recops.gather_tile_rows(width, False), recops.gather_tile_rows(width, True),
                 recops.gather_tile_rows(width + width // 4, True)):
        edges |= {tile - 1, tile, tile + 1, 3 * tile + 1}
    for r in sorted(e for e in edges if e > 0):
        rng = np.random.default_rng(r * 100 + width + offset)
        data, starts, scattered, lens = ri.gather_case(rng, r, 9000, hi=width + 9)
        buf = torch.from_numpy(np.concatenate([np.zeros(offset, np.uint8), data])).to(cuda)
        d = buf[offset:]
        d2 = torch.flip(buf, (0,))[offset + 1 :]  # another view, odd offset
        ln = torch.from_numpy(lens).to(cuda)
        rows = r + 5
        for st in (starts, scattered):
            s_t = torch.from_numpy(st).to(cuda)
            got = cuda_kernels.rows_gather(d, s_t, ln, rows, width, 0xFF)
            assert torch.equal(got, recops.rows_gather_plain(d, s_t, ln, rows, width, 0xFF))
            # strided columns, as the scan's offsets are
            cols = torch.stack([s_t, ln], 1)
            got = cuda_kernels.rows_gather(d, cols[:, 0], cols[:, 1], rows, width, 7)
            assert torch.equal(got, recops.rows_gather_plain(d, s_t, ln, rows, width, 7))
        got = cuda_kernels.rows_gather(d, None, ln, rows, width, 0)
        assert torch.equal(got, recops.rows_gather_plain(d, None, ln, rows, width, 0))
        pair = cuda_kernels.rows_gather(d, None, ln, rows, width, 0, quarter=(d2, width // 4))
        want = recops.rows_gather_plain(d, None, ln, rows, width, 0, quarter=(d2, width // 4))
        assert torch.equal(pair[0], want[0]) and torch.equal(pair[1], want[1])


def test_records_gather_back_to_back_over_many_tiles(cuda):
    """The look-back over hundreds of tiles (the decode's 100,000-record
    block), launches back to back on one stream and on a second stream,
    against the plain version: every launch takes fresh status words."""
    from fastqpacker_tpu_torch.ops import records as recops

    rng = np.random.default_rng(5)
    lens = torch.from_numpy(rng.integers(0, 161, 100_000)).to(cuda)
    data = torch.from_numpy(rng.integers(0, 256, int(lens.sum()) + 5).astype(np.uint8)).to(cuda)
    want = recops.rows_gather_plain(data[3:], None, lens, 100_000, 160, 0,
                                    quarter=(data[1:], 40))
    side = torch.cuda.Stream()
    for stream in (torch.cuda.current_stream(), side, torch.cuda.current_stream()):
        with torch.cuda.stream(stream):
            outs = [cuda_kernels.rows_gather(data[3:], None, lens, 100_000, 160, 0,
                                             quarter=(data[1:], 40)) for _ in range(3)]
        stream.synchronize()
        for got in outs:
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _assemble_args(data: bytes, wide: bool, cuda, plus=True):
    """The assembly's inputs of a one-block container of ``data`` (the
    decoded rows and streams), on the card."""
    from fastqpacker_tpu_torch.entropy import zstd as pzstd
    from fastqpacker_tpu_torch.pipeline import blocks as pblocks

    C = tfq.container
    comp = tfq.compress_bytes(data, tfq.Options(block_size=1 << 20), device="cpu")
    hdr = C.parse_block_header(comp[C.FILE_HEADER_SIZE :], 2)
    ds = pblocks.decode_streams(hdr, comp[C.FILE_HEADER_SIZE + C.BLOCK_HEADER_SIZE_V2 :], 2,
                                pzstd.get_codec())
    if wide:  # the v3 layout of the same positions
        ds.npos = np.frombuffer(ds.npos.tobytes(), "<u2").astype("<u4").view(np.uint8)
    r = ds.num_records
    lens = torch.from_numpy(ds.lengths.view("<u4").astype(np.int64)).to(cuda)
    width = pblocks.bucket_len(int(lens.max()))
    seq_t, qual_t = (torch.from_numpy(x.copy()).to(cuda) for x in (ds.seq, ds.qual))
    deltas, packed = cuda_kernels.rows_gather(qual_t, None, lens, r, width, 0,
                                              quarter=(seq_t, width // 4))
    seq, qual = cuda_kernels.decode_arrays(packed, deltas, lens.to(torch.int32), 33)
    streams = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
               for x in (ds.headers, ds.plus, ds.npos)]
    return ds, [seq, qual, lens, streams[0], streams[1] if plus else None, streams[2], wide,
                len(ds.lengths), len(ds.seq), len(ds.qual)]


def _assemble_equal(args):
    from fastqpacker_tpu_torch.ops import records as recops

    out, info = cuda_kernels.fastq_assemble(*args)
    pout, pinfo = recops.fastq_assemble_plain(*args)
    assert torch.equal(info, pinfo), (info.tolist(), pinfo.tolist())
    if int(pinfo[1]) & ~recops.FAULT_INVALID_NPOS == 0:
        total = int(pinfo[0])
        assert torch.equal(out[:total], pout[:total])
    return pout, pinfo


def _edge_names():
    import torch_records_inputs as ri

    return sorted(ri.edge_cases())


@pytest.mark.parametrize("name", _edge_names())
@pytest.mark.parametrize("wide", [False, True])
def test_records_assemble_matches_plain_at_chain_tile_edges(name, wide, cuda):
    """Chained streams that end at, one before and one past the chain
    kernel's tile edges, records on every edge, a uniform stream that only
    its last records break, a 65,535-byte header and plus line: the card's
    text and info equal the plain version's, with and without the plus
    stream (v1's bare '+'), and the text equals the input."""
    import torch_records_inputs as ri

    data = ri.edge_cases()[name]
    _, args = _assemble_args(data, wide, cuda)
    pout, pinfo = _assemble_equal(args)
    assert int(pinfo[1]) == 0 and bytes(pout[: int(pinfo[0])].cpu().numpy()) == data
    args[4] = None
    _assemble_equal(args)


ASSEMBLE_FAULTS = {
    "headers_cut": ("headers", lambda x: x[:-1]),
    "headers_half": ("headers", lambda x: x[: len(x) // 2]),
    "headers_flip": ("headers", lambda x: _flip(x, 1)),
    "plus_cut": ("plus", lambda x: x[:-1]),
    "npos_cut": ("npos", lambda x: x[:-2]),
    "npos_odd": ("npos", lambda x: x[:-1]),
    "npos_past_read": ("npos", lambda x: _flip(x, -1, 0x7F)),
    "npos_first": ("npos", lambda x: _flip(x, 0, 0x05)),
    "seq_short": ("seq_n", lambda n: n - 1),
    "qual_short": ("qual_n", lambda n: n - 1),
    "lengths_short": ("len_n", lambda n: n - 1),
    "headers_and_npos": ("headers+npos", None),
}


def _flip(x, at, bits=0x40):
    y = x.clone()
    y[at] ^= bits
    return y


@pytest.mark.parametrize("fault", sorted(ASSEMBLE_FAULTS))
@pytest.mark.parametrize("wide", [False, True])
def test_records_assemble_faults_match_plain(fault, wide, cuda):
    """Each assembly fault, and two at once: the card's info words (the
    text's bytes and every fault bit) equal the plain version's."""
    from fastqpacker_tpu_torch.ops import records as recops

    import torch_records_inputs as ri

    data = ri.fastq(300, 7, read_len=(20, 90))
    _, args = _assemble_args(data, wide, cuda)
    at = {"headers": 3, "plus": 4, "npos": 5, "len_n": 7, "seq_n": 8, "qual_n": 9}
    field, fn = ASSEMBLE_FAULTS[fault]
    if fault == "headers_and_npos":
        args[3] = args[3][:-3]
        args[5] = _flip(args[5], -1, 0x7F)
    else:
        args[at[field]] = fn(args[at[field]])
    _, pinfo = _assemble_equal(args)
    assert int(pinfo[1]) != 0 or fault in ("headers_flip", "npos_first")
    assert recops.fault_message(int(pinfo[1])) is not None or fault in ("headers_flip",
                                                                        "npos_first")


def test_records_variable_width_names_at_100000_records(cuda):
    """A 100,000-record block of Illumina-style read names of varying width
    (the header chain is not uniform) through the four block stages on the
    card: every kernel equal to its plain version and the text to the
    input."""
    from fastqpacker_tpu_torch.ops import records as recops
    from fastqpacker_tpu_torch.pipeline import blocks as pblocks
    from fastqpacker_tpu_torch.utils.synth import illumina_fastq

    data = illumina_fastq(100_000, seed=11)
    text = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda)
    offsets, _, info = cuda_kernels.records_scan(text, 100_000)
    assert int(info[recops.SCAN_COUNT]) == 100_000
    width = pblocks.bucket_len(int(info[recops.SCAN_SEQ_MAX]))
    rows = [cuda_kernels.rows_gather(text, offsets[:, c], offsets[:, 3], 100_000, width, f)
            for c, f in ((2, 0), (6, 0xFF))]
    for (c, f), g in zip(((2, 0), (6, 0xFF)), rows):
        assert torch.equal(g, recops.rows_gather_plain(text, offsets[:, c], offsets[:, 3],
                                                       100_000, width, f))
    for wide in (False, True):
        ds, args = _assemble_args(data, wide, cuda)
        pout, pinfo = _assemble_equal(args)
        assert int(pinfo[1]) == 0 and bytes(pout[: int(pinfo[0])].cpu().numpy()) == data
        assert pblocks.streams_to_fastq(ds, 33, cuda, wide_npos=wide) == data


def _scan_equal(text, max_records):
    """The scan kernel against its plain version: every info slot, the
    offsets and (without a fault) the quality minima of the records found."""
    from fastqpacker_tpu_torch.ops import records as recops

    got = cuda_kernels.records_scan(text, max_records)
    want = recops.records_scan_plain(text, max_records)
    torch.cuda.synchronize()
    n = int(want[2][recops.SCAN_COUNT])
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[0][:n], want[0][:n])
    if not int(want[2][recops.SCAN_ERROR]):
        assert torch.equal(got[1][:n], want[1][:n])
    return got


def _scan_edge_names():
    import torch_records_inputs as ri

    return sorted(ri.scan_edge_cases())


def _streams_edge_names():
    import torch_records_inputs as ri

    return sorted(ri.streams_edge_cases())


@pytest.mark.parametrize("name", _scan_edge_names())
def test_records_scan_matches_plain_at_tile_edges(name, cuda):
    """Texts cut at the scan kernel's 32 KiB tiles (``scan_edge_cases``):
    the card's info, offsets and quality minima equal the plain version's,
    at the case's max_records and at one record fewer, in two launches."""
    import torch_records_inputs as ri

    data, max_records = ri.scan_edge_cases()[name]
    text = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda)
    cuda_kernels.reset_launches()
    for m in {max_records, max(1, max_records - 1)}:
        _scan_equal(text, m)
    assert cuda_kernels.launches[cuda_kernels.RECORDS_SCAN] == len({max_records,
                                                                   max(1, max_records - 1)})


def _streams_case(data, wide, cuda):
    """The stream build's inputs for one block of ``data`` on the card (the
    plain scan, gathers and encode) and its plain result."""
    from fastqpacker_tpu_torch.ops import device as devops
    from fastqpacker_tpu_torch.ops import records as recops
    from fastqpacker_tpu_torch.pipeline import blocks as pblocks

    text = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda)
    n = data.count(b"\n") // 4
    offsets, _, info = recops.records_scan_plain(text, n)
    info_h = info.cpu().numpy()
    width = pblocks.bucket_len(int(info_h[recops.SCAN_SEQ_MAX]))
    rows = [recops.rows_gather_plain(text, offsets[:, c], offsets[:, 3], n + 3, width, f)
            for c, f in ((2, 0), (6, 0xFF))]
    lens32 = torch.zeros(n + 3, dtype=torch.int32, device=cuda)
    lens32[:n] = offsets[:, 3]
    enc = devops.encode_arrays_plain(*rows, lens32, 33, (1 << 31) - 1 if wide else 1 << 16)
    sizes = recops.stream_sizes(info_h, wide)
    args = (text, offsets, enc.packed, enc.qual_delta, enc.nmask_bits, enc.n_counts, wide, sizes)
    return args, recops.streams_build_plain(*args)


@pytest.mark.parametrize("name", _streams_edge_names())
@pytest.mark.parametrize("wide", [False, True])
def test_records_streams_match_plain_at_tile_edges(name, wide, cuda):
    """Blocks cut at the stream build's tiles of records, ranges that start
    and end inside 16-byte units, reads with no N and all N (narrow and
    wide), a 70,000-bp read (``streams_edge_cases``): the card's buffer and
    info equal the plain version's, from one launch."""
    import torch_records_inputs as ri

    args, (pbuf, pinfo) = _streams_case(ri.streams_edge_cases()[name], wide, cuda)
    cuda_kernels.reset_launches()
    buf, info = cuda_kernels.streams_build(*args)
    torch.cuda.synchronize()
    assert torch.equal(info, pinfo) and torch.equal(buf, pbuf)
    assert cuda_kernels.launches[cuda_kernels.STREAMS_BUILD] == 1


def test_records_kernels_from_two_threads_on_own_and_shared_streams(cuda):
    """The scan, the stream build, the decoder's pair gather and the
    assembly (a chain that leaves the read-name fast path, u32 N positions)
    from two threads at once, on a stream each and then on one shared
    stream: every call equals the plain version. The ticket and status words
    are per stream, an epoch per call."""
    from fastqpacker_tpu_torch.ops import records as recops

    import torch_records_inputs as ri

    blocks = []
    for i, name in enumerate(("names_long", "npos_2048")):
        ds, args = _assemble_args(ri.edge_cases()[name], bool(i), cuda)
        lens, r, width = args[2], args[2].numel(), args[0].shape[1]
        qual, seq = (torch.from_numpy(x.copy()).to(cuda) for x in (ds.qual, ds.seq))
        blocks.append((args, recops.fastq_assemble_plain(*args), qual, seq, lens, r, width,
                       recops.rows_gather_plain(qual, None, lens, r, width, 0,
                                                quarter=(seq, width // 4))))
    scans = []
    for name in ("crlf_split", "bad_plus_tile5_bad_header_tile1"):
        data, m = ri.scan_edge_cases()[name]
        text = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda)
        scans.append((text, m, recops.records_scan_plain(text, m)))
    streams = [_streams_case(ri.streams_edge_cases()[name], bool(i), cuda)
               for i, name in enumerate(("three_tiles_unaligned", "all_n_wide"))]
    torch.cuda.synchronize()

    def call(i):
        args, (pout, pinfo), qual, seq, lens, r, width, (gq, gp) = blocks[i]
        out, info = cuda_kernels.fastq_assemble(*args)
        q, pk = cuda_kernels.rows_gather(qual, None, lens, r, width, 0, quarter=(seq, width // 4))
        text, m, (poffs, _, pscan) = scans[i]
        offs, _, scan = cuda_kernels.records_scan(text, m)
        sargs, (pbuf, pbinfo) = streams[i]
        buf, binfo = cuda_kernels.streams_build(*sargs)
        torch.cuda.current_stream().synchronize()
        total = int(pinfo[0])
        assert torch.equal(info, pinfo) and torch.equal(out[:total], pout[:total])
        assert torch.equal(q, gq) and torch.equal(pk, gp)
        n = int(pscan[recops.SCAN_COUNT])
        assert torch.equal(scan, pscan) and torch.equal(offs[:n], poffs[:n])
        assert torch.equal(binfo, pbinfo) and torch.equal(buf, pbuf)

    _from_two_threads(call, cuda, rounds=60)
    shared, errors = torch.cuda.Stream(cuda), []

    def work(i):
        try:
            with torch.cuda.stream(shared):
                for _ in range(60):
                    call(i)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    workers = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in workers) and not errors, errors


def test_records_device_operations_per_wrapper_call(cuda):
    """One device operation per gather call, from the text, back to back
    and as the decoder's pair; at most three per assembly call, two per
    scan call and one per stream build call, with fixed-width headers and
    with names of varying width. Counted by
    ``torch.profiler`` in a process of its own (``scripts/records_ab.py
    --ops-only``): in a long process the profiler can miss kernels."""
    cmd = [sys.executable, str(REPO / "scripts" / "records_ab.py"), "--root", str(REPO),
           "--ops-only", "--shape", "v2_37500x151", "--shape", "names_100000x151"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    cases = json.loads(proc.stdout.strip().splitlines()[-1])["cases"]
    limit = {"text": 1, "back_to_back": 1, "decoder": 1, "assemble": 3, "scan": 2, "streams": 1}
    assert {(c["shape"], c["route"]) for c in cases} == {
        (s, r) for s in ("v2_37500x151", "names_100000x151") for r in limit}
    for c in cases:
        assert 1 <= c["device_ops_per_call"] <= limit[c["route"]], c


# ---------------------------------------------------------------------------
# the context-model passes (csrc/ctxprep.cu)
# ---------------------------------------------------------------------------

CTX_LENGTHS = {
    "varlen_with_empty": lambda rng: np.where(rng.random(5000) < 0.1, 0,
                                              rng.integers(1, 300, 5000)),
    "fixed151": lambda rng: np.full(20_000, 151),
    "long_read": lambda rng: np.array([37, 70_001, 0, 5, 151, 0]),
}


@pytest.mark.parametrize("case", sorted(CTX_LENGTHS))
def test_ctxprep_kernels_match_plain(case, cuda):
    """The four kernels against their plain versions on the card, byte for
    byte: both prepare passes, the layout at every model and order (encode
    matrices and start matrix) on 256 to 8,192 lanes, the unlayout in its
    three modes; one launch each."""
    from fastqpacker_tpu_torch.ops import ctxprep

    rng = np.random.default_rng(sorted(CTX_LENGTHS).index(case))
    lengths = CTX_LENGTHS[case](rng).astype(np.int64)
    n = int(lengths.sum())
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    delta, bounds = t(rng.integers(0, 256, n).astype(np.uint8)), t(ctxprep.record_bounds(lengths))
    pb_h = ctxprep.record_bounds(lengths, packed=True)
    packed, pbounds = t(rng.integers(0, 256, int(pb_h[1, -1])).astype(np.uint8)), t(pb_h)
    cuda_kernels.reset_launches()
    raw, hist2 = cuda_kernels.qctx_prepare(delta, bounds)
    bases, hist6 = cuda_kernels.sctx_prepare(packed, pbounds, n)
    for got, want in ((raw, hist2), ctxprep.qctx_prepare_plain(delta, bounds)), \
            ((bases, hist6), ctxprep.sctx_prepare_plain(packed, pbounds)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cuda_kernels.launches[cuda_kernels.QCTX_PREPARE] == 1
    assert cuda_kernels.launches[cuda_kernels.SCTX_PREPARE] == 1
    for model, order in [(0, 2), (0, 4), (0, 6), (1, 0), (1, 1)]:
        syms = bases if model == 0 else raw
        counts = np.bincount(syms.cpu().numpy(), minlength=256)
        present = np.flatnonzero(counts > 0)
        idx = np.zeros(256, np.uint8)
        idx[present] = np.arange(len(present))
        for lanes in (256, 8192):
            tab_h, steps, seg = ctxprep.lane_layout(lengths, lanes)
            tab = t(tab_h)
            args = (syms, bounds, tab, steps, model, order, t(idx), int(np.argmax(counts)))
            got = cuda_kernels.wctx_layout(*args)
            want = ctxprep.wctx_layout_plain(*args)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            start = cuda_kernels.wctx_layout(None, bounds, tab, steps, model, order)
            assert torch.equal(start, ctxprep.wctx_layout_plain(None, bounds, tab, steps, model,
                                                                order, None, 0))
            mat = torch.where(t(np.arange(steps)[:, None] < seg[None, :]), got[0], 0)
            pads = np.argwhere(np.arange(steps)[:, None] >= seg[None, :])
            if len(pads):  # a pad cell past the present symbols: no fault
                mat[tuple(pads[0])] = 200
            pres = t(present.astype(np.uint8))
            for mode, b, size in ((ctxprep.UNLAYOUT_FLAT, bounds, n),
                                  (ctxprep.UNLAYOUT_PACKED, pbounds, int(pb_h[1, -1])),
                                  (ctxprep.UNLAYOUT_DELTA, bounds, n)):
                out, fault = cuda_kernels.wctx_unlayout(mat, b, tab, pres, mode, size)
                pout, pfault = ctxprep.wctx_unlayout_plain(mat, b, tab, pres, mode)
                torch.cuda.synchronize()
                assert torch.equal(out, pout) and torch.equal(fault, pfault)
                assert int(fault) == 0
                if mode == ctxprep.UNLAYOUT_FLAT:
                    assert torch.equal(out, syms)


def _unlayout_edge(case, model, cuda):
    """(matrix, bounds, packed bounds, lane table, present, n, m, lengths,
    lanes) of one ``unlayout_edge_cases`` case on the card: the symbols'
    present indices in their lane cells, 255 on the pad cells."""
    from fastqpacker_tpu_torch.ops import ctxprep

    import torch_ctxprep_inputs as ci

    lengths, lanes, syms = ci.unlayout_stream(case, model, 70 + model)
    tab, steps, seg = ctxprep.lane_layout(lengths, lanes)
    present = np.flatnonzero(np.bincount(syms, minlength=256) > 0)
    idx = np.zeros(256, np.uint8)
    idx[present] = np.arange(len(present))
    mat = np.full((steps, lanes), 255, np.uint8)
    for lane in range(lanes):
        mat[: seg[lane], lane] = idx[syms[tab[0, lane]: tab[0, lane + 1]]]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    pb = ctxprep.record_bounds(lengths, packed=True)
    return (t(mat), t(pb[0]), t(pb), t(tab), t(present.astype(np.uint8)), int(pb[0, -1]),
            int(pb[1, -1]), lengths, lanes)


@pytest.mark.parametrize("case", sorted(prepare_edge_cases()))
def test_ctxprep_qctx_prepare_matches_plain_at_tile_edges(case, cuda):
    """The qctx prepare's tiles (record starts on and beside a tile edge, a
    tile with no start, zero-length records at an edge, all-zero deltas on
    one key per position bucket, uniform deltas that overflow a CTA's table)
    against the plain version, byte for byte; one launch a call."""
    from fastqpacker_tpu_torch.ops import ctxprep

    import torch_ctxprep_inputs as ci

    lengths, delta = ci.prepare_stream(case, seed=80)
    d = torch.from_numpy(delta).to(cuda)
    b = torch.from_numpy(ctxprep.record_bounds(lengths)).to(cuda)
    cuda_kernels.reset_launches()
    for _ in range(3):  # the tickets and status words go on across calls
        raw, hist = cuda_kernels.qctx_prepare(d, b)
        praw, phist = ctxprep.qctx_prepare_plain(d, b)
        torch.cuda.synchronize()
        assert torch.equal(raw, praw) and torch.equal(hist, phist)
    assert cuda_kernels.launches[cuda_kernels.QCTX_PREPARE] == 3


@pytest.mark.parametrize("case", sorted(sctx_prepare_edge_cases()))
def test_ctxprep_sctx_prepare_matches_plain_at_tile_edges(case, cuda):
    """The sctx prepare's tiles (records of 0-7 bases, starts 1-15 bases
    before a thread's 16 bases and a tile edge, a 70,001-bp read, pad bits
    set, a tile of 1-base records) against the plain version, byte for
    byte; a memset and one launch a call."""
    from fastqpacker_tpu_torch.ops import ctxprep

    import torch_ctxprep_inputs as ci

    lengths, packed = ci.sctx_prepare_stream(case, seed=81)
    pk = torch.from_numpy(packed).to(cuda)
    b = torch.from_numpy(ctxprep.record_bounds(lengths, packed=True)).to(cuda)
    n = int(lengths.sum())
    cuda_kernels.reset_launches()
    for _ in range(2):
        bases, hist = cuda_kernels.sctx_prepare(pk, b, n)
        pbases, phist = ctxprep.sctx_prepare_plain(pk, b)
        torch.cuda.synchronize()
        assert torch.equal(bases, pbases) and torch.equal(hist, phist)
    assert cuda_kernels.launches[cuda_kernels.SCTX_PREPARE] == 2


@pytest.mark.parametrize("model,order", [(0, 2), (0, 4), (0, 6), (1, 0), (1, 1)])
@pytest.mark.parametrize("case", sorted(layout_edge_cases()))
def test_ctxprep_layout_matches_plain_at_tile_edges(case, model, order, cuda):
    """The layout's tiles (2,047 lanes, steps one past a tile, segments
    shorter than a tile, records that start at a tile's first step,
    positions past 112) against the plain version, byte for byte: the
    encoder's matrices and the start matrix; one launch each."""
    from fastqpacker_tpu_torch.ops import ctxprep

    import torch_ctxprep_inputs as ci

    lengths, lanes, syms = ci.layout_stream(case, model, 82)
    tab, steps, _ = ctxprep.lane_layout(lengths, lanes)
    counts = np.bincount(syms, minlength=256)
    idx = np.zeros(256, np.uint8)
    idx[counts > 0] = np.arange(int((counts > 0).sum()))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    args = (t(syms), t(ctxprep.record_bounds(lengths)), t(tab), steps, model, order, t(idx),
            int(np.argmax(counts)))
    cuda_kernels.reset_launches()
    got = cuda_kernels.wctx_layout(*args)
    start = cuda_kernels.wctx_layout(None, *args[1:6])
    want = ctxprep.wctx_layout_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(start, ctxprep.wctx_layout_plain(None, *args[1:6], None, 0))
    assert cuda_kernels.launches[cuda_kernels.WCTX_LAYOUT] == 2


@pytest.mark.parametrize("model", [0, 1])
@pytest.mark.parametrize("case", sorted(unlayout_edge_cases()))
def test_ctxprep_unlayout_matches_plain_at_tile_edges(case, model, cuda):
    """The unlayout's tiles (segments shorter than a tile, steps one past a
    multiple of a tile, 2,047 lanes, a 70,001-bp read, packed bytes across a
    tile edge, records of 1-3 bases) in its three modes against the plain
    version, byte for byte; a fault on the first data cell of a run and on
    the last sets the flag, pads past the present symbols do not; one launch
    a call."""
    from fastqpacker_tpu_torch.ops import ctxprep

    import torch_ctxprep_inputs as ci

    mat, b, pb, tab, pres, n, m, lengths, lanes = _unlayout_edge(case, model, cuda)
    cuda_kernels.reset_launches()
    for mode, bb, size in ((ctxprep.UNLAYOUT_FLAT, b, n), (ctxprep.UNLAYOUT_PACKED, pb, m),
                           (ctxprep.UNLAYOUT_DELTA, b, n)):
        out, fault = cuda_kernels.wctx_unlayout(mat, bb, tab, pres, mode, size)
        pout, pfault = ctxprep.wctx_unlayout_plain(mat, bb, tab, pres, mode)
        torch.cuda.synchronize()
        assert torch.equal(out, pout) and torch.equal(fault, pfault) and int(fault) == 0
    for t, lane in ci.run_edges(lengths, lanes):
        bad = mat.clone()
        bad[t, lane] = pres.numel()
        for mode, bb, size in ((ctxprep.UNLAYOUT_PACKED, pb, m), (ctxprep.UNLAYOUT_DELTA, b, n)):
            out, fault = cuda_kernels.wctx_unlayout(bad, bb, tab, pres, mode, size)
            pout, pfault = ctxprep.wctx_unlayout_plain(bad, bb, tab, pres, mode)
            torch.cuda.synchronize()
            assert torch.equal(out, pout) and int(fault) == int(pfault) == 1
    assert cuda_kernels.launches[cuda_kernels.WCTX_UNLAYOUT] == 3 + 2 * 3


def test_ctxprep_kernels_from_two_threads_on_own_and_shared_streams(cuda):
    """The qctx prepare and the unlayout (whose tiles and fault flag use the
    stream's ticket and status words) from two threads at once, on a stream
    each and then on one shared stream: every call equals the plain
    version."""
    from fastqpacker_tpu_torch.ops import ctxprep

    import torch_ctxprep_inputs as ci

    work_items = []
    for i, (pcase, ucase) in enumerate((("tile_without_a_start", "long_read"),
                                        ("starts_at_tile_edges", "packed_bytes_across_tiles"))):
        lengths, delta = ci.prepare_stream(pcase, seed=90 + i)
        d = torch.from_numpy(delta).to(cuda)
        b = torch.from_numpy(ctxprep.record_bounds(lengths)).to(cuda)
        mat, ub, pb, tab, pres, n, m, _, _ = _unlayout_edge(ucase, 0, cuda)
        if i:  # a fault in the second thread's matrix only
            mat[0, 0] = pres.numel()
        work_items.append(((d, b), ctxprep.qctx_prepare_plain(d, b), (mat, pb, tab, pres),
                           ctxprep.wctx_unlayout_plain(mat, pb, tab, pres,
                                                       ctxprep.UNLAYOUT_PACKED), m))
    torch.cuda.synchronize()

    def call(i):
        qargs, (praw, phist), uargs, (pout, pfault), m = work_items[i]
        raw, hist = cuda_kernels.qctx_prepare(*qargs)
        out, fault = cuda_kernels.wctx_unlayout(*uargs, ctxprep.UNLAYOUT_PACKED, m)
        torch.cuda.current_stream().synchronize()
        assert torch.equal(raw, praw) and torch.equal(hist, phist)
        assert torch.equal(out, pout) and torch.equal(fault, pfault) and int(fault) == i

    _from_two_threads(call, cuda, rounds=40)
    shared, errors = torch.cuda.Stream(cuda), []

    def work(i):
        try:
            with torch.cuda.stream(shared):
                for _ in range(40):
                    call(i)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    workers = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in workers) and not errors, errors


def test_ctxprep_device_operations_per_wrapper_call(cuda):
    """Two device operations per qctx or sctx prepare call (the histogram's
    memset and the kernel), one per layout call (the encoder's matrices at
    every model and order, the start matrix) and one per unlayout call (no
    fill of the fault flag), counted by ``torch.profiler`` in a process of
    its own (``scripts/ctxprep_ab.py --ops-only``) at 20,000-record blocks."""
    cmd = [sys.executable, str(REPO / "scripts" / "ctxprep_ab.py"), "--root", str(REPO),
           "--ops-only", "--records", "20000"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    cases = json.loads(proc.stdout.strip().splitlines()[-1])["cases"]
    want = {"qctx": 2, "sctx": 2, "layout_encode": 1, "layout_decode": 1, "unlayout": 1}
    routes = [c["route"] for c in cases]
    assert {r: routes.count(r) for r in want} == {"qctx": 2, "sctx": 2, "layout_encode": 5,
                                                 "layout_decode": 5, "unlayout": 2}
    for c in cases:
        assert c["device_ops_per_call"] == want[c["route"]], c


def test_ctxprep_v3_and_mesh_containers_equal_the_cpu_at_two_blocks(cuda):
    """v3 (qctx / sctx candidates prepared on the card) and ``--mesh`` (the
    plan's prepare passes, the encode's lane matrices, the decoders' start
    matrices and wire bytes on the card): containers and text equal to the
    CPU's at two blocks, each kernel launched where the path runs it."""
    from fastqpacker_tpu_torch.parallel import mesh as pmesh
    from fastqpacker_tpu_torch.pipeline import meshpipe

    one = len(synth_fastq(0, read_len=151))
    data = synth_fastq(2 * 12_000 * one / (1 << 20), seed=21, qual_model="walk")
    v3 = tfq.Options(version=3, workers=1, block_size=12_000)
    cuda_kernels.reset_launches()
    comp = tfq.compress_bytes(data, v3, device=cuda)
    counts = cuda_kernels.launches.as_dict()
    assert comp == tfq.compress_bytes(data, v3, device="cpu")
    assert counts[cuda_kernels.QCTX_PREPARE] >= 2 and counts[cuda_kernels.SCTX_PREPARE] >= 1
    assert tfq.decompress_bytes(comp, device=cuda) == data
    one = len(synth_fastq(0, read_len=100))
    data = synth_fastq(3600 * one / (1 << 20), read_len=100, seed=22,
                       qual_model="phredwalk", seq_model="markov")
    opts = tfq.Options(block_size=1800)
    cuda_kernels.reset_launches()
    mcomp = meshpipe.compress_mesh_bytes(data, opts, [cuda])
    counts = cuda_kernels.launches.as_dict()
    assert mcomp == meshpipe.compress_mesh_bytes(data, opts, pmesh.make_mesh(1, device="cpu"))
    assert counts[cuda_kernels.QCTX_PREPARE] == counts[cuda_kernels.SCTX_PREPARE] == 2
    assert counts[cuda_kernels.WCTX_LAYOUT] == counts[cuda_kernels.WCTX_ENCODE] > 0
    for decode in (lambda: meshpipe_decode(meshpipe, mcomp, [cuda]),
                   lambda: tfq.decompress_bytes(mcomp, device=cuda)):
        cuda_kernels.reset_launches()
        assert decode() == data
        counts = cuda_kernels.launches.as_dict()
        assert (counts[cuda_kernels.WCTX_LAYOUT] == counts[cuda_kernels.WCTX_UNLAYOUT]
                == counts[cuda_kernels.WCTX_DECODE] > 0)


def meshpipe_decode(meshpipe, comp, mesh) -> bytes:
    out = io.BytesIO()
    meshpipe.decompress_mesh(io.BytesIO(comp), out, mesh)
    return out.getvalue()


def test_ctxprep_failing_build_raises_and_never_runs_the_plain_version(cuda, monkeypatch):
    """No fallback: when the context passes' library does not build, a CUDA
    tensor raises; nothing runs the plain versions in their place."""
    from fastqpacker_tpu_torch.ops import build, ctxprep, qualctx

    def fail(name):
        raise RuntimeError(f"nvcc failed to build {name}.cu")

    def plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(build, "_libs", {k: v for k, v in build._libs.items() if k != "ctxprep"})
    monkeypatch.setattr(build, "_compile", fail)
    for name in ("qctx_prepare_plain", "sctx_prepare_plain", "wctx_layout_plain",
                 "wctx_unlayout_plain"):
        monkeypatch.setattr(ctxprep, name, plain)
    lengths = np.full(10, 20, np.int64)
    with pytest.raises(RuntimeError, match="nvcc failed to build ctxprep.cu"):
        qualctx.prepare(np.zeros(200, np.uint8), lengths, cuda)
    bounds = torch.from_numpy(ctxprep.record_bounds(lengths)).to(cuda)
    tab = torch.from_numpy(ctxprep.lane_layout(lengths, 256)[0]).to(cuda)
    with pytest.raises(RuntimeError, match="nvcc failed to build ctxprep.cu"):
        cuda_kernels.wctx_layout(None, bounds, tab, 20, 1, 0)


# ---------------------------------------------------------------------------
# the runtime's byte histogram and header tokenizer (csrc/hist256.cu,
# csrc/tokens.cu)
# ---------------------------------------------------------------------------

from torch_tokens_inputs import (decode_fault_cases, header_edge_cases,  # noqa: E402
                                 hist_edge_cases, stream_of)

HIST_CASES = hist_edge_cases()
TOK_HEADERS = header_edge_cases()
TOK_FAULTS = decode_fault_cases()


def _on(cuda, b: bytes, off: int = 0) -> torch.Tensor:
    """``b`` on the card as a view that starts ``off`` bytes into its buffer."""
    buf = torch.from_numpy(np.frombuffer(b"\x5a" * off + b + b"\x5a", np.uint8).copy()).to(cuda)
    return buf[off : off + len(b)]


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_hist256_matches_plain(case, cuda):
    """Lengths 0, 1, 15, 16, 17 and several CTAs, views at offsets 1-15,
    one-symbol, 256-symbol and skewed streams, two bytes in turn, walk
    deltas, uniform bytes, a wave and the shortest stream that fills the
    grid, less or more one: one launch, counts equal to the plain version's."""
    buf, off, n = HIST_CASES[case]
    t = _on(cuda, buf[off : off + n], off % 16)
    cuda_kernels.reset_launches()
    got = cuda_kernels.hist256(t)
    assert cuda_kernels.launches.as_dict()[cuda_kernels.HIST256] == 1
    assert torch.equal(got.cpu(), port_rans.hist256_plain(t.cpu()))


def test_hist256_counts_exactly_past_every_threads_flush(cuda):
    """One byte, long enough that every thread of a full wave flushes its
    column of u16 counters at least once (a view at offset 3): the count is
    exact, and the next call on the stream too."""
    from torch_tokens_inputs import hist_flush_bytes

    n = hist_flush_bytes(torch.cuda.get_device_properties(cuda).multi_processor_count)
    buf = torch.full((n + 3,), 201, dtype=torch.uint8, device=cuda)
    got = cuda_kernels.hist256(buf[3:])
    want = torch.zeros((256,), dtype=torch.int64)
    want[201] = n
    assert torch.equal(got.cpu(), want)
    del buf
    small = _on(cuda, bytes(range(256)) * 7, 5)
    assert torch.equal(cuda_kernels.hist256(small).cpu(), torch.full((256,), 7, dtype=torch.int64))


def test_hist256_twice_around_a_chained_kernel(cuda):
    """Two histograms on one stream with a kernel that takes the stream's
    chained state between them (the header tokenizer): both count exactly,
    and the accumulator is back at 0 after each."""
    headers = [b"r:%d" % i for i in range(3000)]
    view = _on(cuda, stream_of(headers), 1)
    lens = torch.tensor([len(h) for h in headers], dtype=torch.int64, device=cuda)
    a = _on(cuda, HIST_CASES["walk_deltas_off5"][0][5:600_005], 5)
    b = _on(cuda, HIST_CASES["alternating_two"][0], 0)
    key = (cuda.index or 0, torch.cuda.current_stream(cuda).cuda_stream)
    for t in (a, b, a):
        got = cuda_kernels.hist256(t)
        cuda_kernels.tok_encode(view, len(headers), lens)
        assert torch.equal(got.cpu(), port_rans.hist256_plain(t.cpu()))
        assert not cuda_kernels._chained[key].acc.any()


@pytest.mark.parametrize("case", sorted(TOK_HEADERS))
def test_tok_encode_and_decode_match_plain(case, cuda):
    """Every header edge and corpus: the tokenized bytes of a view at an odd
    offset equal the plain version's, and decode back to the stream, one
    launch of each wrapper a call."""
    from fastqpacker_tpu_torch.ops import tokenize

    headers = TOK_HEADERS[case]
    s = stream_of(headers)
    view = _on(cuda, s, 3)
    cuda_kernels.reset_launches()
    got = cuda_kernels.tok_encode(view, len(headers))
    want = tokenize.tok_encode_plain(view.cpu(), len(headers))
    assert torch.equal(got.cpu(), want)
    back = cuda_kernels.tok_decode(_on(cuda, want.numpy().tobytes()), len(headers))
    assert back.cpu().numpy().tobytes() == s
    counts = cuda_kernels.launches.as_dict()
    launched = 1 if headers else 0
    assert counts[cuda_kernels.TOK_ENCODE] == counts[cuda_kernels.TOK_DECODE] == launched


@pytest.mark.parametrize("case", sorted(TOK_FAULTS))
def test_tok_decode_faults_match_plain(case, cuda):
    """Each decode fault raises the plain version's string on the card (the
    first in stream order); the streams whose bytes past the last record
    would fault decode as on the CPU."""
    from fastqpacker_tpu_torch.ops import tokenize

    data, count = TOK_FAULTS[case]
    try:
        want = tokenize.decode_plain(data, count)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            cuda_kernels.tok_decode(_on(cuda, data), count)
        assert str(got.value) == str(e)
    else:
        assert cuda_kernels.tok_decode(_on(cuda, data), count).cpu().numpy().tobytes() == want


@pytest.mark.parametrize("stream,count", [
    (stream_of([b"a", b"b"]), 3), (stream_of([b"a", b"b"])[:-1], 2),
    (stream_of([b"a", b"b"]) + b"\x00", 2), (stream_of([b"a", b"b"]), 1),
    (stream_of([b"a" * 300, b"b"])[:-5], 2), (b"\x05", 1),
])
def test_tok_encode_faults_match_plain(stream, count, cuda):
    from fastqpacker_tpu_torch.ops import tokenize

    with pytest.raises(ValueError) as want:
        tokenize.encode_plain(stream, count)
    with pytest.raises(ValueError) as got:
        cuda_kernels.tok_encode(_on(cuda, stream, 5), count)
    assert str(got.value) == str(want.value)


def test_tokens_v3_container_equals_the_cpu_with_launches_by_tag(cuda):
    """Names in instrument order, three v3 blocks: the card's container
    equals the CPU's, every header stream is ``TAG_TOK``; one tokenizer
    encode a block, one decode a ``TAG_TOK`` stream, and one histogram an
    estimate or rANS table."""
    from fastqpacker_tpu_torch.pipeline import native
    from fastqpacker_tpu_torch.utils.synth import ordered_illumina_fastq

    data = ordered_illumina_fastq(15_000, seed=7)
    v3 = tfq.Options(version=3, workers=1, block_size=5000)
    cuda_kernels.reset_launches()
    comp = tfq.compress_bytes(data, v3, device=cuda)
    c = cuda_kernels.launches.as_dict()
    assert comp == tfq.compress_bytes(data, v3, device="cpu")
    r = io.BytesIO(comp)
    fh = tfq.container.read_file_header(r)
    tags = []
    while (hdr := tfq.container.read_block_header(r, fh.version)) is not None:
        sizes = hdr.stream_sizes(tfq.container.VERSION_2)
        payload = r.read(sum(sizes))
        tags.append((payload[0], payload[sizes[0]], payload[sizes[0] + sizes[1]]))
    assert [t[2] for t in tags] == [native.TAG_TOK] * 3
    assert c[cuda_kernels.TOK_ENCODE] == 3
    # a 5,000-record block's sequence (190,000 B) and quality (755,000 B)
    # streams are both estimated; a stream that picks rANS would take its
    # table from its estimate's counts
    assert c[cuda_kernels.HIST256] == 2 * 3
    cuda_kernels.reset_launches()
    assert tfq.decompress_bytes(comp, device=cuda) == data
    d = cuda_kernels.launches.as_dict()
    assert d[cuda_kernels.TOK_DECODE] == 3 and d[cuda_kernels.TOK_ENCODE] == 0
    assert d[cuda_kernels.HIST256] == 0


def test_tokens_failing_build_raises_and_never_runs_the_plain_version(cuda, monkeypatch):
    """No fallback: when the tokenizer's or the histogram's library does not
    build, a CUDA tensor raises RuntimeError (which the v3 header pick does
    not catch); nothing runs the plain versions in their place."""
    from fastqpacker_tpu_torch.entropy import zstd
    from fastqpacker_tpu_torch.ops import build, tokenize
    from fastqpacker_tpu_torch.pipeline import native

    def fail(name):
        raise RuntimeError(f"nvcc failed to build {name}.cu")

    def plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(build, "_libs", {k: v for k, v in build._libs.items()
                                         if k not in ("tokens", "hist256")})
    monkeypatch.setattr(build, "_compile", fail)
    monkeypatch.setattr(tokenize, "encode_plain", plain)
    monkeypatch.setattr(tokenize, "decode_plain", plain)
    monkeypatch.setattr(cuda_kernels, "hist256_plain", plain)
    s = stream_of([b"r:1", b"r:2"])
    with pytest.raises(RuntimeError, match="nvcc failed to build tokens.cu"):
        native._encode_tagged_headers(s, _on(cuda, s), 2, zstd.get_codec())
    with pytest.raises(RuntimeError, match="nvcc failed to build hist256.cu"):
        native._rans_size_estimate(_on(cuda, bytes(20000), 3))


@pytest.mark.parametrize("case", sorted(k for k, v in TOK_HEADERS.items() if v))
def test_tok_encode_from_header_lengths_equals_the_bare_stream(case, cuda):
    """The compress path's route (the record starts from the header lengths
    the stream was built from, one launch) and the bare stream's (the
    record chain, then the encode) give the plain version's bytes, one
    counted launch a call."""
    from fastqpacker_tpu_torch.ops import tokenize

    headers = TOK_HEADERS[case]
    view = _on(cuda, stream_of(headers), 3)
    # a column of an (n, 2) tensor, as the lengths are a column of the scan's offsets
    lengths = torch.tensor([[7, len(h)] for h in headers], dtype=torch.int64, device=cuda)[:, 1]
    want = tokenize.tok_encode_plain(view.cpu(), len(headers))
    cuda_kernels.reset_launches()
    assert torch.equal(cuda_kernels.tok_encode(view, len(headers), lengths).cpu(), want)
    assert torch.equal(cuda_kernels.tok_encode(view, len(headers)).cpu(), want)
    assert cuda_kernels.launches.as_dict()[cuda_kernels.TOK_ENCODE] == 2


def test_tok_encode_refuses_lengths_that_are_not_the_streams(cuda):
    """Header lengths that do not add up to the stream are a fault of the
    caller, not of the stream: RuntimeError, which the v3 header pick does
    not turn into zstd."""
    headers = [b"r:%d" % i for i in range(300)]
    view = _on(cuda, stream_of(headers), 1)
    for lens in ([len(h) for h in headers[:-1]] + [len(headers[-1]) + 1],
                 [len(h) for h in headers[:-1]] + [70000],
                 [len(h) - 1 for h in headers]):
        with pytest.raises(RuntimeError, match="header lengths"):
            cuda_kernels.tok_encode(view, len(headers),
                                    torch.tensor(lens, dtype=torch.int64, device=cuda))


def test_tok_decode_device_operations_do_not_grow_with_count(cuda):
    """A decode runs the same 4 device operations at 1,000 and 100,000
    records (the chain, the resolve, the read-back, the write): no launch a
    round; the encode from header lengths one kernel and its read-back, a
    bare stream's the chain too. Counted in a process of its own
    (``scripts/tokens_ab.py --ops-only``): in a long process the profiler
    can miss kernels."""
    want = {"decode": 4, "encode_lengths": 2, "encode": 3}
    for records in (1000, 100_000):
        cmd = [sys.executable, str(REPO / "scripts" / "tokens_ab.py"), "--root", str(REPO),
               "--ops-only", "--records", str(records)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-2000:]
        cases = json.loads(proc.stdout.strip().splitlines()[-1])["cases"]
        assert {c["route"]: c["device_ops_per_call"] for c in cases} == want, cases


# ---------------------------------------------------------------------------
# the runtime's context coders (csrc/ctxcoder.cu)
# ---------------------------------------------------------------------------

import torch_ctxcoder_inputs as cci  # noqa: E402

CODER_CASES = {f"{c[0]}-{c[1]}-{c[4]}": c for c in cci.coder_cases()}
GOLDEN_CTX = REPO / "tests" / "testdata" / "golden" / "golden_ctx_v3.fqz"
GOLDEN_CTX_SHA256 = "173eef211411531f4ccf343a983fe62ed4756ccd8254e230aae710e655dea76a"


def _tensors_equal(got, want) -> bool:
    return all(g.shape == w.shape and torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))


def _coder_round(stream, syms_in, lengths, arg, cuda):
    """The encode kernel against its plain version on the same stream, then
    the decode kernel against its plain version on the plain encode's words
    (both qctx check modes); returns the plain encode's outputs."""
    cpu = cci.coder_inputs(stream, syms_in, lengths, "cpu", arg)
    want = cci.empty_encode()
    if len(cpu["syms"]):
        want = cci.coder_encode(stream, cpu)
        got = cci.coder_encode(stream, cci.coder_inputs(stream, syms_in, lengths, cuda, arg))
        torch.cuda.synchronize()
        assert _tensors_equal(got, want)
    for checks in ((False, True) if stream == "qctx" else (False,)):
        ref = cci.coder_decode(stream, cci.coder_decode_args(stream, cpu, want, "cpu", checks))
        got = cci.coder_decode(stream, cci.coder_decode_args(stream, cpu, want, cuda, checks))
        assert _tensors_equal(got, ref) and not ref[1][:, 0].any()
    return want


@pytest.mark.parametrize("case", sorted(CODER_CASES))
def test_ctxcoder_kernels_match_plain(case, cuda):
    """Every CPU case (the JAX coder tests' cases, chunks with no record, one
    symbol, a binned stream's scarce words) at qctx models 0 and 1 and sctx
    orders 2, 4 and 6: the encode's words, flags, states and counts and the
    decode's output and fault info byte-equal to the plain versions."""
    stream, _, syms_in, lengths, arg = CODER_CASES[case]
    _coder_round(stream, syms_in, lengths, arg, cuda)


@pytest.mark.parametrize("stream", ["qctx", "sctx"])
def test_ctxcoder_kernels_match_plain_at_a_full_block(stream, cuda):
    """A 100,000 x 151 block of the context-model corpus (Markov bases,
    Phred walks) at the model or order the v3 pick takes: the kernels equal
    the plain versions (Python walks, tens of seconds each), and the card's
    encode and decode round-trip through the payload wrappers."""
    from fastqpacker_tpu_torch.ops import qualctx, seqctx

    rng = np.random.default_rng(151)
    lengths = cci.block_lengths(100_000)
    if stream == "qctx":
        raw = np.clip(30 + np.cumsum(rng.integers(-2, 3, (100_000, 151)), axis=1) // 3,
                      0, 41).astype(np.uint8).reshape(-1)
        syms_in = qualctx.deintegrate(raw, lengths)
        mod = qualctx
    else:
        syms_in = seqctx.pack_stream(cci.markov(rng, 100_000, 151), lengths).tobytes()
        mod = seqctx
    _coder_round(stream, syms_in, lengths, None, cuda)
    payload = mod.encode(syms_in, lengths, device=cuda)
    assert payload == mod.encode(syms_in, lengths, device="cpu")
    assert mod.decode(payload, lengths, device=cuda) == syms_in


@pytest.mark.parametrize("stream", ["qctx", "sctx"])
def test_ctxcoder_fault_strings_on_the_card_equal_the_cpu(stream, cuda):
    """Each decode fault (a chunk that runs out of words, one with a word
    left over, faults in two chunks, an empty context row), with and
    without the whole-file checks: the card raises the CPU's string, or
    decodes where the CPU does. A present symbol with no frequency in the
    encode's table raises the JAX runtime's string on both."""
    from fastqpacker_tpu_torch.ops import ctxcoder, ctxprep, qualctx, seqctx

    mod = qualctx if stream == "qctx" else seqctx
    payloads, lengths = (cci.qctx_fault_payloads() if stream == "qctx"
                         else cci.sctx_fault_payloads())
    for name, payload in payloads.items():
        for kw in (({}, {"runtime_checks": True}) if stream == "qctx" else ({},)):
            outs = []
            for dev in (cuda, "cpu"):
                try:
                    outs.append(("ok", mod.decode(payload, lengths, device=dev, **kw)))
                except ValueError as e:
                    outs.append(("error", str(e)))
            assert outs[0] == outs[1], (name, kw)
    case = CODER_CASES[f"{stream}-varlen-{1 if stream == 'qctx' else 4}"]
    err = qualctx.QctxError if stream == "qctx" else seqctx.SctxError
    for dev in (cuda, "cpu"):
        inp = cci.coder_inputs(stream, case[2], case[3], dev, case[4])
        freq = inp["freq"].copy()
        # the context of every record's first symbol (qctx model 1: the sentinels)
        freq[(qualctx.NUM_QBINS - 1) * qualctx.NUM_Q2B + qualctx.NUM_Q2B - 1
             if stream == "qctx" else 0] = 0
        pending = ctxcoder.launch_encode(
            cuda_kernels.qctx_encode if stream == "qctx" else cuda_kernels.sctx_encode,
            ctxprep.Symbols(inp["syms"]), case[3], freq, case[4],
            err(f"invalid {stream} frequency table"))
        with pytest.raises(err, match=f"^invalid {stream} frequency table$"):
            pending.result()


def test_ctxcoder_device_operations_per_wrapper_call(cuda):
    """One wrapper call runs its own kernels and nothing else: one a qctx or
    sctx encode, one a qctx decode on its dense route and two on its L2
    route (the slot table, the walk), one an sctx decode; counted by
    ``torch.profiler`` in a process of its own (``scripts/ctxcoder_ab.py
    --ops-only``) at a 20,000-record block."""
    cmd = [sys.executable, str(REPO / "scripts" / "ctxcoder_ab.py"), "--root", str(REPO),
           "--ops-only", "--records", "20000"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    cases = {c["route"]: c["device_ops"] for c in
             json.loads(proc.stdout.strip().splitlines()[-1])["cases"]}
    assert {r: len(o) for r, o in cases.items()} == {
        "qctx_encode": 1, "qctx_decode": 1, "qctx_decode_l2": 2, "sctx_encode": 1,
        "sctx_decode": 1}, cases
    for route, ops in cases.items():
        assert all("encode_kernel" in o or "decode_kernel" in o or "slots_kernel" in o
                   for o in ops), (route, ops)


def test_ctxcoder_qctx_decode_route_follows_the_table_size(cuda):
    """The dense route for the walk and binned tables at both models, the
    L2 route for 94 symbols (``uniform-random``): each call counted on its
    route, both byte-equal to the plain version (``_coder_round``)."""
    from fastqpacker_tpu_torch.ops import qualctx

    for name, route in (("varlen", "shared"), ("varlen-binned", "shared"),
                        ("uniform-random", "l2")):
        for model in qualctx.MODELS:
            stream, _, syms_in, lengths, arg = CODER_CASES[f"qctx-{name}-{model}"]
            cpu = cci.coder_inputs(stream, syms_in, lengths, "cpu", arg)
            want = (qualctx.dense_layout(cpu["alphabet"], model) is not None)
            assert want == (route == "shared")
            cuda_kernels.reset_launches()
            _coder_round(stream, syms_in, lengths, arg, cuda)
            assert cuda_kernels.qctx_routes.as_dict() == {
                "shared": 2 * (route == "shared"), "l2": 2 * (route == "l2")}, name


def test_ctxcoder_dense_bytes_equal_the_host_layout(cuda):
    """``fq_qctx_dense_bytes`` (the kernel's shared layout) equals the
    host's ``qualctx.dense_shared_bytes``, by which the route is chosen."""
    from fastqpacker_tpu_torch.ops import build, qualctx

    lib = build.load("ctxcoder")
    for n in (1, 5, 41, 43, 63):
        for model in qualctx.MODELS:
            for tile in qualctx.DENSE_TILES:
                assert lib.fq_qctx_dense_bytes(n, model, tile) == qualctx.dense_shared_bytes(
                    n, model, tile), (n, model, tile)


@pytest.mark.parametrize("stream", ["qctx", "sctx"])
def test_ctxcoder_tile_edge_fault_on_the_card_equals_the_cpu(stream, cuda):
    """A chunk that runs out of words at the last symbol of a tile: the
    card's fault code and symbol index equal the plain version's, and its
    string the CPU's."""
    from fastqpacker_tpu_torch.ops import qualctx, seqctx

    payload, lengths, k, j = cci.tile_fault_payloads()[stream]
    got = cci.coder_decode(stream, cci.payload_decode_args(stream, payload, lengths, cuda))[1]
    want = cci.coder_decode(stream, cci.payload_decode_args(stream, payload, lengths, "cpu"))[1]
    assert got[: k + 1].tolist() == want[: k + 1].tolist() and want[k].tolist() == [2, j]
    mod = qualctx if stream == "qctx" else seqctx
    outs = []
    for dev in (cuda, "cpu"):
        with pytest.raises(ValueError) as e:
            mod.decode(payload, lengths, device=dev)
        outs.append(str(e.value))
    assert outs[0] == outs[1] == f"truncated {stream} words"


def _ctx_tags(comp: bytes) -> list:
    r = io.BytesIO(comp)
    fh = tfq.container.read_file_header(r)
    tags = []
    while (hdr := tfq.container.read_block_header(r, fh.version)) is not None:
        sizes = hdr.stream_sizes(tfq.container.VERSION_2)
        payload = r.read(sum(sizes))
        tags.append((payload[0], payload[sizes[0]]))
    return tags


def test_ctxcoder_v3_container_equals_the_cpu_with_launches_by_tag(cuda, monkeypatch):
    """Two v3 blocks of the context-model corpus: the card's container
    equals the CPU's, every block TAG_SCTX / TAG_QCTX; at least one encode a
    tagged stream, one compaction an encode, one decode a stream, and no
    prepared symbols copied back to the host (``Symbols._host`` stays
    None)."""
    from fastqpacker_tpu_torch.ops import ctxprep
    from fastqpacker_tpu_torch.pipeline import native

    made = []
    init = ctxprep.Symbols.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(ctxprep.Symbols, "__init__", record)
    data = synth_fastq(0.9, seed=5, qual_model="phredwalk", seq_model="markov")
    nrec = data.count(b"\n") // 4
    v3 = tfq.Options(version=3, workers=1, block_size=-(-nrec // 2))
    cuda_kernels.reset_launches()
    comp = tfq.compress_bytes(data, v3, device=cuda)
    c = cuda_kernels.launches.as_dict()
    on_card = [s for s in made if s.tensor.is_cuda]
    assert on_card and all(s._host is None for s in on_card)
    assert comp == tfq.compress_bytes(data, v3, device="cpu")
    assert _ctx_tags(comp) == [(native.TAG_SCTX, native.TAG_QCTX)] * 2
    assert c[cuda_kernels.QCTX_ENCODE] >= 2 and c[cuda_kernels.SCTX_ENCODE] >= 2
    assert c[cuda_kernels.RANS_COMPACT] == (c[cuda_kernels.QCTX_ENCODE] + c[cuda_kernels.SCTX_ENCODE]
                                            + c[cuda_kernels.RANS_ENCODE])
    assert c[cuda_kernels.QCTX_DECODE] == c[cuda_kernels.SCTX_DECODE] == 0
    cuda_kernels.reset_launches()
    assert tfq.decompress_bytes(comp, device=cuda) == data
    d = cuda_kernels.launches.as_dict()
    assert d[cuda_kernels.QCTX_DECODE] == d[cuda_kernels.SCTX_DECODE] == 2
    assert d[cuda_kernels.QCTX_ENCODE] == d[cuda_kernels.SCTX_ENCODE] == 0


def test_ctxcoder_golden_ctx_decodes_on_the_card(cuda):
    """``golden_ctx_v3.fqz`` decodes on the card to its FASTQ's SHA-256,
    its TAG_QCTX and TAG_SCTX streams by one decode launch each."""
    import hashlib

    cuda_kernels.reset_launches()
    back = tfq.decompress_bytes(GOLDEN_CTX.read_bytes(), device=cuda)
    counts = cuda_kernels.launches.as_dict()
    assert hashlib.sha256(back).hexdigest() == GOLDEN_CTX_SHA256
    assert counts[cuda_kernels.QCTX_DECODE] == counts[cuda_kernels.SCTX_DECODE] == 1


def test_ctxcoder_kernels_from_two_threads_on_own_streams(cuda):
    """Two threads, each on a CUDA stream of its own, encode and decode
    their own streams at once (scratch and fault info are per call): each
    equals its single-threaded result."""
    from fastqpacker_tpu_torch.ops import qualctx, seqctx

    jobs = [(qualctx, *CODER_CASES["qctx-varlen-1"][2:4]),
            (seqctx, *CODER_CASES["sctx-varlen-6"][2:4]),
            (qualctx, *CODER_CASES["qctx-varlen-binned-0"][2:4]),
            (seqctx, *CODER_CASES["sctx-markov-40x151-2"][2:4])]
    want = [mod.encode(s, lengths, device="cpu") for mod, s, lengths in jobs]
    results = {}

    def work(i):
        mod, s, lengths = jobs[i]
        with torch.cuda.stream(torch.cuda.Stream()):
            for _ in range(5):
                p = mod.encode(s, lengths, device=cuda)
                results.setdefault(i, []).append((p, mod.decode(p, lengths, device=cuda)))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, (_, s, _) in enumerate(jobs):
        assert results[i] == [(want[i], bytes(s))] * 5


def test_ctxcoder_failing_build_raises_and_never_runs_the_plain_version(cuda, monkeypatch):
    """No fallback: when the context coders' library does not build, the
    encode and the decode raise; nothing runs the plain versions."""
    from fastqpacker_tpu_torch.ops import build, qualctx, seqctx

    def fail(name):
        raise RuntimeError(f"nvcc failed to build {name}.cu")

    def plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    _, lengths, delta = cci.qctx_case("varlen")
    payload = qualctx.encode(delta, lengths, device="cpu")
    monkeypatch.setattr(build, "_libs", {k: v for k, v in build._libs.items() if k != "ctxcoder"})
    monkeypatch.setattr(build, "_compile", fail)
    for mod, name in ((qualctx, "qctx_encode_plain"), (qualctx, "qctx_decode_plain"),
                      (seqctx, "sctx_encode_plain"), (seqctx, "sctx_decode_plain")):
        monkeypatch.setattr(mod, name, plain)
    with pytest.raises(RuntimeError, match="nvcc failed to build ctxcoder.cu"):
        qualctx.encode(delta, lengths, device=cuda)
    with pytest.raises(RuntimeError, match="nvcc failed to build ctxcoder.cu"):
        qualctx.decode(payload, lengths, device=cuda)
    _, lengths, packed = cci.sctx_cases()["markov-40x151"]
    with pytest.raises(RuntimeError, match="nvcc failed to build ctxcoder.cu"):
        seqctx.encode(packed, lengths, device=cuda)
