"""The block stages of the port (``ops/records.py``: record scan, row gather,
stream build, FASTQ assembly) against the JAX package's, byte for byte.

The JAX package runs these stages in its C++ runtime
(``fastqpacker_tpu/runtime/bindings.py``: ``scan_records``, ``gather_rows``,
``build_raw_streams``, ``decode_block_full``, ``assemble_fastq``) and in
Python (``parser/fastq.py``'s numpy route, ``pipeline/blocks.py``'s
``streams_to_fastq``). The port runs the kernels' plain PyTorch versions here
(``device="cpu"``); the same seeded or generated inputs go to both, and every
output and error string must be equal (tolerance 0).
"""

import io

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import fastqpacker_tpu as jfq
import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu.ops import reference as jrefops
from fastqpacker_tpu.parser import fastq as jparser
from fastqpacker_tpu.pipeline import blocks as jblocks
from fastqpacker_tpu.runtime import bindings
from fastqpacker_tpu_torch.entropy import zstd as pzstd
from fastqpacker_tpu_torch.ops import cuda_kernels
from fastqpacker_tpu_torch.ops import records as recops
from fastqpacker_tpu_torch.parser import fastq as pparser
from fastqpacker_tpu_torch.pipeline import blocks as pblocks
from torch_wctx_inputs import one_torch_thread  # noqa: F401  (autouse fixture)

import torch_records_inputs as ri
from torch_jax_runtime import ensure as ensure_jax_runtime
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

C = tfq.container
FIELDS = ("seq", "qual", "headers", "plus", "npos", "lengths")
SETTINGS = settings(max_examples=30, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])


@pytest.fixture(scope="module", autouse=True)
def _runtime():
    """The JAX package's C++ runtime is the reference of these stages (loaded
    again if this process met it while another was building it)."""
    assert ensure_jax_runtime()


@st.composite
def fastq_texts(draw, max_records=10, max_len=40):
    """FASTQ text: CRLF or LF, empty header and plus payloads, reads of
    length 0, N-rich and lowercase bases, and a partial trailing record."""
    nl = draw(st.sampled_from(["\n", "\r\n"]))
    recs = []
    for i in range(draw(st.integers(0, max_records))):
        hdr = draw(st.text("ACGT0123456789:_ .r/", max_size=12))
        ln = draw(st.integers(0, max_len))
        seq = draw(st.text("ACGTNNNNacgtRY.", min_size=ln, max_size=ln))
        qual = "".join(chr(33 + draw(st.integers(0, 60))) for _ in range(ln))
        plus = draw(st.sampled_from(["", hdr, "x"]))
        recs.append(f"@{hdr}{nl}{seq}{nl}+{plus}{nl}{qual}{nl}")
    tail = draw(st.sampled_from(["", "@part", "@part\n", "@part\nAC\n", "@part\nAC\n+",
                                 "@part\nAC\n+\n", "@part\nAC\n+\nII"]))
    return ("".join(recs) + tail).encode()


def _fastq(n, seed, varlen=True, maxlen=151, alphabet="ACGTN", plus=False):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        ln = int(rng.integers(0, maxlen + 1)) if varlen else maxlen
        s = "".join(alphabet[b] for b in rng.integers(0, len(alphabet), ln))
        q = "".join(chr(33 + int(b)) for b in rng.integers(0, 41, ln))
        p = f"p{i}" if plus else ""
        recs.append(f"@rd_{i} x={i % 7}{'y' * (i % 3)}\n{s}\n+{p}\n{q}\n")
    return "".join(recs).encode()


def _error(call):
    try:
        return "ok", call()
    except ValueError as e:
        return type(e).__name__, str(e)


class _Trickle:
    """A reader that hands out at most ``k`` bytes a call and has no
    ``readinto``: windows of the streaming route end mid-record."""

    def __init__(self, data: bytes, k: int):
        self.data, self.k, self.pos = data, k, 0

    def read(self, n=-1):
        n = self.k if n is None or n < 0 else min(n, self.k)
        out = self.data[self.pos : self.pos + n]
        self.pos += len(out)
        return out


# ---------------------------------------------------------------------------
# 1. record scan
# ---------------------------------------------------------------------------


@SETTINGS
@given(data=fastq_texts(), max_records=st.integers(1, 12))
def test_scan_equals_the_runtime_scan(data, max_records):
    arr = np.frombuffer(data, np.uint8)
    offs, consumed, err = bindings.scan_records(arr, max_records)
    got, qmin, info = cuda_kernels.records_scan(torch.from_numpy(arr.copy()), max_records)
    assert int(info[recops.SCAN_ERROR]) == err
    if err:
        return
    n = int(info[recops.SCAN_COUNT])
    assert n == len(offs) and int(info[recops.SCAN_CONSUMED]) == consumed
    assert np.array_equal(got[:n].numpy(), offs)
    # the runtime's quality minimum for Phred detection, per record
    for i in range(n):
        q = arr[offs[i, 6] : offs[i, 6] + offs[i, 7]]
        assert int(qmin[i]) == (int(q.min()) if len(q) else recops.EMPTY_QMIN)
    if n:
        lens = offs[:, 3]
        assert int(info[recops.SCAN_SEQ_SUM]) == lens.sum()
        assert int(info[recops.SCAN_SEQ_MAX]) == lens.max()
        assert int(info[recops.SCAN_PACKED_SUM]) == ((lens + 3) // 4).sum()
        assert int(info[recops.SCAN_HDR_MAX]) == offs[:, 1].max()
        assert int(info[recops.SCAN_PLUS_SUM]) == offs[:, 5].sum()


@pytest.mark.parametrize("name", sorted(ri.scan_edge_cases()))
def test_scan_at_tile_edges_equals_the_runtime_scan(name):
    """Texts cut at the scan kernel's 32 KiB tiles (a newline at an edge and
    one byte either side, a CRLF split across one, a 70,000-bp read with an N
    past 65,536, malformed lines in two tiles, a malformed line past the
    lines looked at, max_records reached mid-tile, empty text, no trailing
    newline): the plain version's error, count, consumed bytes, offsets,
    quality minima and sums equal the runtime scan's, and its v2 overflow row
    the first record with a non-ACGT base at 65,536 or past."""
    data, max_records = ri.scan_edge_cases()[name]
    arr = np.frombuffer(data, np.uint8)
    offs, consumed, err = bindings.scan_records(arr, max_records)
    got, qmin, info = cuda_kernels.records_scan(torch.from_numpy(arr.copy()), max_records)
    assert int(info[recops.SCAN_ERROR]) == err
    assert err or name not in ("bad_plus_tile5_bad_header_tile1",
                               "bad_header_tile4_bad_length_tile2")
    if err:
        # the lower line index wins: the fault of the earlier tile
        want = {"bad_plus_tile5_bad_header_tile1": 1, "bad_header_tile4_bad_length_tile2": 3}
        assert err == want[name]
        return
    n = int(info[recops.SCAN_COUNT])
    assert n == len(offs) == min(max_records, (arr == 0x0A).sum() // 4)
    assert int(info[recops.SCAN_CONSUMED]) == consumed
    assert np.array_equal(got[:n].numpy(), offs)
    for i in range(n):
        q = arr[offs[i, 6] : offs[i, 6] + offs[i, 7]]
        assert int(qmin[i]) == (int(q.min()) if len(q) else recops.EMPTY_QMIN)
    over = recops.NONE
    for i in range(n):
        seq = arr[offs[i, 2] : offs[i, 2] + offs[i, 3]]
        amb = ~np.isin(seq & 0xDF, np.frombuffer(b"ACGT", np.uint8))
        if over == recops.NONE and amb[recops.V2_NPOS_LIMIT :].any():
            over = i
    assert int(info[recops.SCAN_OVERFLOW_ROW]) == over
    assert (over != recops.NONE) == (name == "read_70000_n_past_65536")
    if n:
        lens = offs[:, 3]
        assert int(info[recops.SCAN_SEQ_SUM]) == lens.sum()
        assert int(info[recops.SCAN_SEQ_MAX]) == lens.max()
        assert int(info[recops.SCAN_PACKED_SUM]) == ((lens + 3) // 4).sum()
        assert int(info[recops.SCAN_HDR_SUM]) == offs[:, 1].sum()
        assert int(info[recops.SCAN_PLUS_MAX]) == offs[:, 5].max()


def _jax_blocks(data, block_size, route):
    p = jparser.FastqStreamParser(io.BytesIO(data), block_size=block_size)
    return list(p._blocks_numpy() if route == "numpy" else p.blocks())


def _port_blocks(data, block_size, reader):
    src = io.BytesIO(data) if reader == "view" else _Trickle(data, 7)
    return list(pparser.FastqStreamParser(src, block_size=block_size, device="cpu").blocks())


def _same_blocks(got, want):
    assert [b.n for b in got] == [b.n for b in want]
    for g, w in zip(got, want):
        assert np.array_equal(g.lengths, w.lengths)
        for name in ("header_starts", "header_lengths", "plus_starts", "plus_lengths"):
            assert np.array_equal(getattr(g, name), getattr(w, name)), name
        assert [g.record(i) for i in range(g.n)] == [w.record(i) for i in range(w.n)]
        assert np.array_equal(g.seq, w.seq) and np.array_equal(g.qual, w.qual)
        assert g.text.tobytes() == w.text[: len(g.text)].tobytes()


@SETTINGS
@given(data=fastq_texts(max_records=14, max_len=120), block_size=st.integers(1, 6),
       reader=st.sampled_from(["view", "trickle"]), route=st.sampled_from(["native", "numpy"]))
def test_parser_blocks_equal_both_jax_routes(data, block_size, reader, route):
    """Blocks, offsets, records and padded rows of the port's parser equal
    the JAX parser's (its runtime route and its numpy route), from a view of
    the input and from a reader whose windows end mid-record; a malformed
    input fails with the same string."""
    want = _error(lambda: _jax_blocks(data, block_size, route))
    got = _error(lambda: _port_blocks(data, block_size, reader))
    assert got[0] == want[0]
    if got[0] != "ok":
        assert got == want
        return
    _same_blocks(got[1], want[1])


BAD_LINES = {
    "header": (0, lambda line: b"x" + line[1:]),
    "sequence": (1, lambda line: line + b"A"),
    "plus": (2, lambda line: b"-" + line[1:]),
    "quality": (3, lambda line: line[:-1]),
    "empty_header": (0, lambda line: b""),
    "empty_plus": (2, lambda line: b""),
}


@pytest.mark.parametrize("where", sorted(BAD_LINES))
@pytest.mark.parametrize("record", [0, 5, 11])
def test_malformed_line_fails_as_in_jax(where, record):
    """One malformed line of a record, in the first block or a later one:
    the same error from both packages' compress (and the first bad line wins
    over a later one)."""
    lines = _fastq(12, seed=3).split(b"\n")
    which, mutate = BAD_LINES[where]
    lines[4 * record + which] = mutate(lines[4 * record + which])
    lines[4 * 11 + 2] = b"-late"  # a later fault that must not win
    data = b"\n".join(lines)
    want = _error(lambda: jfq.compress_bytes(data, jfq.Options(block_size=4)))
    got = _error(lambda: tfq.compress_bytes(data, tfq.Options(block_size=4), device="cpu"))
    assert got == want and got[0] == "FastqParseError"


@pytest.mark.parametrize("tail", [b"x\n", b"@r\nAC\n-\n", b"@r\nAC\n+", b"@r\nAC\n", b"\n\n\n"])
def test_leftover_lines_fail_as_in_jax(tail):
    """The complete lines of a trailing partial record are validated (an
    unterminated one is not)."""
    data = _fastq(9, seed=4) + tail
    for block in (4, 100):
        want = _error(lambda: jfq.compress_bytes(data, jfq.Options(block_size=block)))
        got = _error(lambda: tfq.compress_bytes(data, tfq.Options(block_size=block),
                                                device="cpu"))
        assert got[0] == want[0]
        assert got == want if got[0] != "ok" else got[1] == want[1]


# ---------------------------------------------------------------------------
# 2. row gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fill", [0, 0xFF])
@pytest.mark.parametrize("width", [0, 3, 32, 45])
def test_gather_equals_the_runtime_gather(fill, width):
    rng = np.random.default_rng(width + fill)
    data = rng.integers(0, 256, 500).astype(np.uint8)
    lens = rng.integers(0, 50, 17).astype(np.int64)
    starts = rng.integers(0, 450, 17).astype(np.int64)
    want = bindings.gather_rows(data, starts, lens, pad_to=width, fill=fill)
    t = torch.from_numpy(data)
    got = cuda_kernels.rows_gather(t, torch.from_numpy(starts), torch.from_numpy(lens),
                                   20, width, fill)
    assert np.array_equal(got[:17].numpy(), want)
    assert (got[17:] == fill).all()
    # back to back from 0 (the decoder's layout), and bytes past the end
    back = cuda_kernels.rows_gather(t, None, torch.from_numpy(lens), 17, width, fill)
    excl = np.concatenate(([0], np.cumsum(lens)[:-1]))
    want = bindings.gather_rows(np.concatenate([data, np.full(1000, fill, np.uint8)]),
                                excl, lens, pad_to=width, fill=fill)
    assert np.array_equal(back.numpy(), want)


@pytest.mark.parametrize("route", ["text", "back_to_back", "pair"])
@pytest.mark.parametrize("width", [40, 80, 45])
@pytest.mark.parametrize("offset", [1, 3])
def test_gather_widths_and_views_equal_the_runtime_gather(route, width, offset):
    """Gathers at widths the kernel stores in 8-byte units (40: the decode's
    packed rows at L = 160), 16-byte units (80) and single bytes (45), from
    views at odd byte offsets, with rows one short of, at and one past the
    kernel's tile edges; the pair gather returns the runtime's two gathers
    (the packed rows at (length + 3) // 4)."""
    tile = recops.gather_tile_rows(width + width // 4 * (route == "pair"), route != "text")
    for r in (tile - 1, tile, tile + 1):
        rng = np.random.default_rng(r + width + offset)
        data, starts, _, lens = ri.gather_case(rng, r, 4 * r + 2 * width * r, hi=width + 5)
        view = torch.from_numpy(np.concatenate([np.zeros(offset, np.uint8), data]))[offset:]
        lt = torch.from_numpy(lens)
        if route == "text":  # the runtime reads past the end: give it fill bytes there
            got = cuda_kernels.rows_gather(view, torch.from_numpy(starts), lt, r, width, 0xFF)
            want = bindings.gather_rows(np.concatenate([data, np.full(2 * width, 0xFF, np.uint8)]),
                                        starts, lens, pad_to=width, fill=0xFF)
            assert np.array_equal(got.numpy(), want)
            continue
        excl = np.concatenate(([0], np.cumsum(lens)[:-1]))
        pad = np.concatenate([data, np.zeros(2 * width, np.uint8)])
        want = bindings.gather_rows(pad, excl, lens, pad_to=width, fill=0)
        if route == "back_to_back":
            got = cuda_kernels.rows_gather(view, None, lt, r, width, 0)
            assert np.array_equal(got.numpy(), want)
            continue
        q = (lens + 3) // 4
        qexcl = np.concatenate(([0], np.cumsum(q)[:-1]))
        want_q = bindings.gather_rows(pad, qexcl, q, pad_to=width // 4, fill=0)
        got, got_q = cuda_kernels.rows_gather(view, None, lt, r, width, 0,
                                              quarter=(view, width // 4))
        assert np.array_equal(got.numpy(), want) and np.array_equal(got_q.numpy(), want_q)


def test_kernel_geometry_equals_the_source():
    """The geometry the wrappers pass and the tests cut their inputs at is
    the kernel source's (``csrc/records.cu``)."""
    import re
    from pathlib import Path

    src = (Path(recops.__file__).parent.parent / "csrc" / "records.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr (?:long long|int) {name} = ([^;]+);", src)
        return eval(m.group(1).replace("LL", ""), {})  # noqa: S307 (the repo's own source)

    assert const("kTile") == recops.SCAN_TILE
    assert const("kThreads") // 32 * (32 // const("kGroup")) == recops.SCAN_CTA_RECORDS
    assert const("kScanCtasPerSm") == recops.SCAN_CTAS_PER_SM
    assert const("kParts") == recops.SCAN_PARTS
    assert const("kStreamMaxRecords") == recops.STREAM_TILE_RECORDS
    assert const("kStreamWindow") == recops.STREAM_WINDOW
    for sizes, n in (([0] * 6, 1), ([38, 151, 30, 2, 2, 4], 1), ([10**6] * 6, 3)):
        tile = recops.stream_tile_records([x * n for x in sizes], n)
        assert 8 <= tile <= recops.STREAM_TILE_RECORDS and tile & (tile - 1) == 0
    assert const("kGatherMaxRows") == recops.GATHER_MAX_ROWS
    assert const("kChainMinTile") == recops.CHAIN_MIN_TILE
    assert const("kChainMaxTile") == recops.CHAIN_MAX_TILE
    assert const("kWriteMaxRecords") == recops.ASSEMBLE_MAX_RECORDS
    assert 2 * recops.ASSEMBLE_ROW_BYTES == const("kRowStage")
    assert const("kCheckThreads") == recops.CHECK_THREADS
    assert const("kSlotWords") == recops.SLOT_WORDS
    assert const("kStatusWords") == recops.STATUS_WORDS
    assert const("kNodeLimit") == recops.NODE_LIMIT
    for n in (0, 1, 16 * 1024 - 1, 16 * 1024, 16 * 1024 + 1, 4_700_000):
        tile = recops.chain_tile_nodes(n)
        assert recops.CHAIN_MIN_TILE <= tile <= recops.CHAIN_MAX_TILE and tile & (tile - 1) == 0
        assert n + 1 <= recops.CHAIN_TILES * tile or tile == recops.CHAIN_MAX_TILE
    for w in (0, 1, 40, 200, 16384, 100_000):
        for chained in (False, True):
            assert 1 <= recops.gather_tile_rows(w, chained) <= recops.GATHER_MAX_ROWS
        assert 1 <= recops.assemble_tile_records(w) <= recops.ASSEMBLE_MAX_RECORDS
    for records, sms in ((1, 132), (37_500, 132), (100_000, 132), (10**7, 4)):
        assert 1 <= recops.scan_ctas(records, sms) <= recops.SCAN_CTAS_PER_SM * sms
    assert recops.scan_tiles(0) == 1 and recops.scan_tiles(recops.SCAN_TILE + 1) == 2


# ---------------------------------------------------------------------------
# 3. stream build
# ---------------------------------------------------------------------------


@SETTINGS
@given(data=fastq_texts(max_records=12, max_len=90), wide=st.booleans())
def test_streams_equal_the_runtime_stream_build(data, wide):
    cut = data.rfind(b"@part")
    data = data[:cut] if cut >= 0 else data
    if not data:
        return
    jblock = _jax_blocks(data, 1000, "native")[0]
    pblock = _port_blocks(data, 1000, "view")[0]
    want = bindings.build_raw_streams(jblock, 33, wide)
    got = pblocks.block_to_raw_streams(pblock, 33, wide_npos=wide)
    for name in FIELDS:
        assert getattr(got, name) == bytes(memoryview(getattr(want, name))), name
    assert (got.num_records, got.original_seq_size) == (want.num_records, want.original_seq_size)


@pytest.mark.parametrize("name", sorted(ri.streams_edge_cases()))
@pytest.mark.parametrize("wide", [False, True])
def test_streams_at_tile_edges_equal_the_runtime_stream_build(name, wide):
    """Blocks cut at the stream build kernel's tiles of records (one tile,
    one record either side, three tiles of ranges that start and end inside
    16-byte units), reads with no N and all N, narrow and wide, and a
    70,000-bp read: the six streams equal the runtime's, u16 and u32 N
    positions."""
    data = ri.streams_edge_cases()[name]
    jblock = _jax_blocks(data, 1 << 20, "native")[0]
    pblock = _port_blocks(data, 1 << 20, "view")[0]
    assert pblock.n == jblock.n == data.count(b"\n") // 4
    want = bindings.build_raw_streams(jblock, 33, wide)
    got = pblocks.block_to_raw_streams(pblock, 33, wide_npos=wide)
    for field in FIELDS:
        assert getattr(got, field) == bytes(memoryview(getattr(want, field))), field
    assert (got.num_records, got.original_seq_size) == (want.num_records, want.original_seq_size)
    if name.startswith("records_"):  # the kernel's tile at these sizes: the cut is at its edge
        sizes = recops.stream_sizes(pblock.info, wide)
        assert recops.stream_tile_records(sizes, pblock.n) == recops.STREAM_TILE_RECORDS


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("field", ["header", "plus"])
@pytest.mark.parametrize("size", [65535, 65536])
def test_field_of_65535_bytes_and_one_more(version, field, size):
    """A header or plus payload of 65,535 bytes fits the u16 prefix; one of
    65,536 fails with the JAX package's string."""
    long = "h" * size
    rec = f"@{long if field == 'header' else 'r'}\nACGT\n+{long if field == 'plus' else ''}\nIIII\n"
    data = (rec + "@r2\nAC\n+\nII\n").encode()
    want = _error(lambda: jfq.compress_bytes(data, jfq.Options(version=version)))
    got = _error(lambda: tfq.compress_bytes(data, tfq.Options(version=version), device="cpu"))
    assert got == want
    assert (got[0] == "ok") == (size == 65535)
    if got[0] == "ok":
        assert tfq.decompress_bytes(got[1], device="cpu") == data or version == 1


# ---------------------------------------------------------------------------
# 4. FASTQ assembly
# ---------------------------------------------------------------------------


def _streams(data, version, block_size=10_000):
    comp = tfq.compress_bytes(data, tfq.Options(block_size=block_size, version=version),
                              device="cpu")
    r = io.BytesIO(comp)
    fh = C.read_file_header(r)
    hdr = C.read_block_header(r, fh.version)
    payload = r.read(sum(hdr.stream_sizes(fh.version)))
    return hdr, payload, fh


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("alphabet", ["ACGT", "ACGTNNNNacgtRY."])
def test_text_equals_the_runtime_decode(version, alphabet):
    data = _fastq(300, seed=5, alphabet=alphabet, plus=True)
    hdr, payload, fh = _streams(data, version)
    ds = pblocks.decode_streams(hdr, payload, version, pzstd.get_codec())
    want = bindings.decode_block_full(ds, 33, False)
    assert pblocks.streams_to_fastq(ds, 33, "cpu") == want


def test_assembly_equals_the_runtime_assembly():
    """The assembly kernel's plain version from the dense decode's rows and
    the three chained streams equals ``fq_assemble`` given the walked
    chains and the N-restored rows."""
    data = _fastq(200, seed=6, alphabet="ACGTNNN", plus=True)
    hdr, payload, _ = _streams(data, 2)
    ds = pblocks.decode_streams(hdr, payload, 2, pzstd.get_codec())
    r = ds.num_records
    lengths = ds.lengths.view("<u4").astype(np.int64)
    width = int(lengths.max())
    packed = bindings.gather_rows(ds.seq, np.concatenate(([0], np.cumsum((lengths + 3) // 4)[:-1])),
                                  (lengths + 3) // 4, pad_to=-(-width // 4))
    deltas = bindings.gather_rows(ds.qual, np.concatenate(([0], np.cumsum(lengths)[:-1])),
                                  lengths, pad_to=width)
    seq, qual = jrefops.decode_block_arrays(packed, deltas, lengths.astype(np.int32), 33)
    counts, rows, pos = bindings.parse_npos(ds.npos, r)
    seq = np.array(seq)
    seq[rows, pos] = ord("N")
    hs, hl = bindings.parse_len16(ds.headers, r, "header")
    ps, pl = bindings.parse_len16(ds.plus, r, "plus-line payload")
    want = bindings.assemble_fastq(ds.headers, hs, hl, ds.plus, ps, pl, 1, seq,
                                   np.array(qual), lengths)
    seq_t, qual_t = (torch.from_numpy(np.ascontiguousarray(x)) for x in
                     jrefops.decode_block_arrays(packed, deltas, lengths.astype(np.int32), 33))
    out, info = cuda_kernels.fastq_assemble(
        seq_t, qual_t, torch.from_numpy(lengths), torch.from_numpy(ds.headers.copy()),
        torch.from_numpy(ds.plus.copy()), torch.from_numpy(ds.npos.copy()), False,
        len(ds.lengths), len(ds.seq), len(ds.qual))
    assert int(info[1]) == 0
    assert out[: int(info[0])].numpy().tobytes() == want == data


def _jax_device_text(ds, wide):
    """The JAX package's device-path assembly (its numpy walk around a
    dense decode; the order of its checks is the port's)."""
    return jblocks.streams_to_fastq(ds, 33, jrefops.decode_block_arrays, wide_npos=wide)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("how", ["truncate_1", "truncate_half", "flip_first", "flip_last"])
@pytest.mark.parametrize("version", [2, 3])
def test_stream_faults_fail_as_in_jax(field, how, version):
    """One truncated or flipped byte in each of a block's six decoded
    streams: the same text or the same error (type and string) as the JAX
    package's device path, the first fault in the same order."""
    data = _fastq(40, seed=7, alphabet="ACGTNN", plus=True)
    hdr, payload, _ = _streams(data, 2)
    ds = pblocks.decode_streams(hdr, payload, 2, pzstd.get_codec())
    orig = getattr(ds, field)
    if how.startswith("truncate"):
        bad = orig[: len(orig) - 1] if how == "truncate_1" else orig[: len(orig) // 2]
    else:
        bad = orig.copy()
        bad[0 if how == "flip_first" else -1] ^= 0x41
    setattr(ds, field, bad)
    wide = version == 3
    if wide:  # the v3 layout of the same positions: u32 counts and positions
        ds.npos = np.frombuffer(ds.npos[: len(ds.npos) // 2 * 2].tobytes(), "<u2").astype(
            "<u4").view(np.uint8)
    want = _error(lambda: _jax_device_text(ds, wide))
    got = _error(lambda: pblocks.streams_to_fastq(ds, 33, "cpu", wide_npos=wide))
    assert got == want


@pytest.mark.parametrize("version", [1, 2])
def test_empty_and_zero_length_reads_round_trip(version):
    data = b"@\n\n+\n\n@e2\nN\n+\n!\n@\nAC\n+\nII\n"
    got = tfq.compress_bytes(data, tfq.Options(version=version), device="cpu")
    assert got == jfq.compress_bytes(data, jfq.Options(version=version))
    assert tfq.decompress_bytes(got, device="cpu") == jfq.decompress_bytes(got)


def test_chains_equal_a_walk():
    """Pointer doubling gives every node of a length-prefixed chain, and
    truncation, as the sequential walk does."""
    rng = np.random.default_rng(8)
    for trial in range(40):
        r = int(rng.integers(0, 30))
        lens = rng.integers(0, 9, r)
        stream = b"".join(int(n).to_bytes(2, "little") + bytes(int(n)) for n in lens)
        cut = len(stream) - int(rng.integers(0, 3)) * (trial % 2)
        data = np.frombuffer(stream[:cut], np.uint8)
        s = recops.chain_starts(torch.from_numpy(data.copy()), 1, 2, len(data), r)
        try:
            starts, walked = bindings.parse_len16(data, r, "header")
        except ValueError:
            assert int(s[r]) == len(data) + 1
            continue
        assert int(s[r]) <= len(data)
        assert np.array_equal(s[:r].numpy() + 2, starts)


@pytest.mark.parametrize("name", sorted(ri.edge_cases()))
def test_chains_at_tile_edges_equal_the_runtime(name):
    """Header, plus and N-position streams that end at, one before and one
    past the chain kernel's tile edges (records on every edge, a stream that
    only its last records keep from being uniform, 65,535-byte header and
    plus lines): every chain node equals the runtime's walk, and the block's
    text equals the runtime's decode and the input."""
    data = ri.edge_cases()[name]
    hdr, payload, _ = _streams(data, 2, block_size=1 << 20)
    ds = pblocks.decode_streams(hdr, payload, 2, pzstd.get_codec())
    r = ds.num_records
    for field, what in (("headers", "header"), ("plus", "plus-line payload")):
        stream = getattr(ds, field)
        s = recops.chain_starts(torch.from_numpy(stream.copy()), 1, 2, len(stream), r)
        starts, _ = bindings.parse_len16(stream, r, what)
        assert np.array_equal(s[:r].numpy() + 2, starts) and int(s[r]) == len(stream)
    counts, _, _ = bindings.parse_npos(ds.npos, r)
    s = recops.chain_starts(torch.from_numpy(ds.npos.copy()), 2, 1, len(ds.npos) // 2, r)
    assert np.array_equal(np.diff(s.numpy()), 1 + counts)
    assert pblocks.streams_to_fastq(ds, 33, "cpu") == bindings.decode_block_full(ds, 33, False)
    assert pblocks.streams_to_fastq(ds, 33, "cpu") == data


@pytest.mark.parametrize("version", [2, 3])
def test_variable_width_names_equal_jax(version):
    """Illumina-style read names of varying width (a header stream that is
    not one record length throughout): the same container as the JAX
    package's and the same text back."""
    from fastqpacker_tpu_torch.utils.synth import illumina_fastq

    data = illumina_fastq(2500, read_len=60, seed=version)
    opts = dict(block_size=1000, version=version)
    got = tfq.compress_bytes(data, tfq.Options(**opts), device="cpu")
    assert got == jfq.compress_bytes(data, jfq.Options(**opts))
    assert tfq.decompress_bytes(got, device="cpu") == data == jfq.decompress_bytes(got)


def _first_npos_unit(npos: np.ndarray, unit: int) -> int:
    """The unit index of the first recorded N position of a stream."""
    vals = npos[: len(npos) // unit * unit].view("<u2" if unit == 2 else "<u4")
    at = 0
    while vals[at] == 0:
        at += 1
    return at + 1


FAULTS = {
    "lengths": lambda ds, u: setattr(ds, "lengths", ds.lengths[:-1]),
    "seq": lambda ds, u: setattr(ds, "seq", ds.seq[:-1]),
    "qual": lambda ds, u: setattr(ds, "qual", ds.qual[:-1]),
    "npos_cut": lambda ds, u: setattr(ds, "npos", ds.npos[: -2 * u]),
    "npos_invalid": lambda ds, u: ds.npos.__setitem__(
        slice(u * _first_npos_unit(ds.npos, u), u * _first_npos_unit(ds.npos, u) + 2), 0xFF),
    "headers": lambda ds, u: setattr(ds, "headers", ds.headers[:-1]),
    "plus": lambda ds, u: setattr(ds, "plus", ds.plus[:-1]),
}


@pytest.mark.parametrize("pair", [(a, b) for i, a in enumerate(FAULTS) for b in list(FAULTS)[i:]])
@pytest.mark.parametrize("version", [2, 3])
def test_fault_order_equals_jax(pair, version):
    """One or two assembly faults at once (every fault bit): the same
    error, type and string, as the JAX package's device path, the first
    fault in the decoder's order."""
    data = _fastq(40, seed=7, alphabet="ACGTNN", plus=True)
    hdr, payload, _ = _streams(data, 2)
    ds = pblocks.decode_streams(hdr, payload, 2, pzstd.get_codec())
    wide = version == 3
    unit = 4 if wide else 2
    if wide:
        ds.npos = np.frombuffer(ds.npos.tobytes(), "<u2").astype("<u4").view(np.uint8).copy()
    else:
        ds.npos = ds.npos.copy()
    for name in set(pair):
        FAULTS[name](ds, unit)
    want = _error(lambda: _jax_device_text(ds, wide))
    got = _error(lambda: pblocks.streams_to_fastq(ds, 33, "cpu", wide_npos=wide))
    assert got == want and got[0] != "ok"
    flags_bit = [m for m in recops.ASSEMBLE_FAULTS if m == got[1]]
    assert flags_bit, got


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("version", [1, 2, 3])
def test_round_trip_containers_equal_jax(version):
    data = _fastq(700, seed=9, alphabet="ACGTNacgt", plus=True)
    opts = dict(block_size=250, version=version)
    got = tfq.compress_bytes(data, tfq.Options(**opts), device="cpu")
    assert got == jfq.compress_bytes(data, jfq.Options(**opts))
    assert tfq.decompress_bytes(got, device="cpu") == jfq.decompress_bytes(got)


def test_mesh_round_trip_container_equals_jax():
    from fastqpacker_tpu.parallel import mesh as jmesh
    from fastqpacker_tpu.pipeline import meshpipe as jmeshpipe
    from fastqpacker_tpu_torch.parallel import mesh as pmesh
    from fastqpacker_tpu_torch.pipeline import meshpipe as pmeshpipe

    data = _fastq(300, seed=10)
    want = jmeshpipe.compress_mesh_bytes(data, jfq.Options(block_size=150), jmesh.make_mesh(1))
    got = pmeshpipe.compress_mesh_bytes(data, tfq.Options(block_size=150),
                                        pmesh.make_mesh(1, device="cpu"))
    assert got == want
    out = io.BytesIO()
    pmeshpipe.decompress_mesh(io.BytesIO(got), out, pmesh.make_mesh(1, device="cpu"))
    assert out.getvalue() == data


@pytest.mark.parametrize("version", [1, 2])
def test_v1_v2_route_builds_no_host_row_matrix(version, monkeypatch):
    """The v1/v2 compress reads rows on the block's device only: the padded
    host matrices of a block are never built (nor are its host offsets)."""

    def refuse(self, *a):
        raise AssertionError("a host row matrix or host offsets were built")

    monkeypatch.setattr(pparser.RecordBlock, "_host_rows", refuse)
    monkeypatch.setattr(pparser.RecordBlock, "offsets", property(refuse))
    data = _fastq(500, seed=11, plus=True, alphabet="ACGTN")
    got = tfq.compress_bytes(data, tfq.Options(block_size=120, version=version), device="cpu")
    assert got == jfq.compress_bytes(data, jfq.Options(block_size=120, version=version))


@pytest.mark.parametrize("low_record", [None, 0, 45, 150])
def test_detection_window_reads_the_scan_minima(low_record):
    """Phred+64 detection over the reference's window of records, spanning
    several blocks, from the scan's per-record minima: all qualities >= 64
    give +64, one low record inside the window gives +33, as in the JAX
    package."""
    rng = np.random.default_rng(12)
    recs = []
    for i in range(160):
        ln = int(rng.integers(0, 30))
        q = bytes(64 + int(b) for b in rng.integers(0, 40, ln))
        if i == low_record:
            q = b"#" + q
            ln += 1
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, b"A" * ln, q))
    data = b"".join(recs)
    for block in (7, 1000):
        got = tfq.compress_bytes(data, tfq.Options(block_size=block), device="cpu")
        assert got == jfq.compress_bytes(data, jfq.Options(block_size=block))
        assert C.parse_file_header(got[: C.FILE_HEADER_SIZE]).phred64 == (low_record is None)
