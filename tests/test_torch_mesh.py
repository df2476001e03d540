"""Port vs JAX package: the ``--mesh`` path (``parallel/mesh.py`` stream
functions and ``pipeline/meshpipe.py``) on a device list of length d.

The same seeded inputs go through ``fastqpacker_tpu`` on ``pmesh.make_mesh(d)``
of the virtual CPU devices (tests/conftest.py) and through the port on
``make_mesh(d, device="cpu")`` (the kernels' plain PyTorch versions).
Containers and payload lists are compared byte for byte (tolerance 0). A
``--mesh`` container depends on d (one lane count and one table per round of
d blocks), so identity is per d. One block size serves most cases: the JAX
side compiles one program per (mesh, padded steps, lanes, alphabet) shape.
"""

import io
import struct

import numpy as np
import pytest
import torch

import fastqpacker_tpu as jfq
import fastqpacker_tpu_torch as tfq
import torch_wctx_inputs as wi
from fastqpacker_tpu.ops import qualctx as jqualctx
from fastqpacker_tpu.ops import rans as jrans
from fastqpacker_tpu.ops import wctx as jwctx
from fastqpacker_tpu.parallel import mesh as jmesh
from fastqpacker_tpu.pipeline import meshpipe as jmeshpipe
from fastqpacker_tpu.pipeline import native as jnative
from fastqpacker_tpu_torch.entropy.zstd import ZstdError
from fastqpacker_tpu_torch.ops import rans as prans
from fastqpacker_tpu_torch.ops import wctx as pwctx
from fastqpacker_tpu_torch.parallel import mesh as pmesh
from fastqpacker_tpu_torch.pipeline import meshpipe as pmeshpipe
from fastqpacker_tpu_torch.utils.synth import synth_fastq
from torch_wctx_inputs import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

C = tfq.container
BLOCK = 1800


@pytest.fixture(autouse=True)
def _host_rans_backend(monkeypatch):
    """Which JAX rANS decode runs on the CPU is process state; pin it."""
    monkeypatch.setenv("FQZ_RANS_BACKEND", "host")


def _markov(n_records, seed=7, read_len=100):
    """The context-model corpus (Markov bases, per-record Phred walks)."""
    one = len(synth_fastq(0, read_len=read_len))  # bytes of one record
    data = synth_fastq(
        (n_records * one + one // 2) / (1 << 20), read_len=read_len, seed=seed,
        qual_model="phredwalk", seq_model="markov",
    )
    assert data.count(b"\n") == 4 * n_records
    return data


def _noise(n, seed, read_len=80):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    out = []
    for i in range(n):
        ln = read_len + int(rng.integers(-4, 5))
        seq = bases[rng.integers(0, 5, ln)].tobytes()
        qual = rng.integers(33, 74, ln).astype(np.uint8).tobytes()
        out.append(b"@r%d d:%d\n%s\n+\n%s\n" % (i, i % 5, seq, qual))
    return b"".join(out)


def _tags(comp: bytes) -> list[tuple[int, int]]:
    r = io.BytesIO(comp)
    fh = C.read_file_header(r)
    if fh.flags & C.FLAG_SEQ_DICT:
        C.read_seq_dict_section(r)
    rows = []
    while (hdr := C.read_block_header(r, fh.version)) is not None:
        sizes = hdr.stream_sizes(C.VERSION_2)
        payload = r.read(sum(sizes))
        rows.append((payload[0], payload[sizes[0]]))
    return rows


def _both(data, d, **opts):
    want = jmeshpipe.compress_mesh_bytes(data, jfq.Options(**opts), jmesh.make_mesh(d))
    got = pmeshpipe.compress_mesh_bytes(
        data, tfq.Options(**opts), pmesh.make_mesh(d, device="cpu")
    )
    return got, want


def _decodes_everywhere(comp, data, d):
    """Both packages' ordinary and batched decoders read ``comp``."""
    one = tfq.DecompressOptions(workers=1)  # the plain versions thread badly
    assert tfq.decompress_bytes(comp, one, device="cpu") == data
    out = io.BytesIO()
    pmeshpipe.decompress_mesh(io.BytesIO(comp), out, pmesh.make_mesh(d, device="cpu"))
    assert out.getvalue() == data
    assert jfq.decompress_bytes(comp) == data


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 4])
def test_markov_container_identical_and_context_coded(d):
    """d = 4: five blocks, a full round and a partial last round; d = 1:
    three rounds."""
    blocks = 5 if d == 4 else 3
    data = _markov(blocks * BLOCK - 300)
    got, want = _both(data, d, block_size=BLOCK)
    assert got == want
    tags = _tags(got)
    assert len(tags) == blocks
    assert all(q == C.TAG_WCTX for _, q in tags), tags
    assert any(s == C.TAG_WCTX for s, _ in tags), tags
    _decodes_everywhere(got, data, d)
    if d == 4:  # the JAX package's batched decoder reads the port's container
        out = io.BytesIO()
        jmeshpipe.decompress_mesh(io.BytesIO(got), out, jmesh.make_mesh(d))
        assert out.getvalue() == data


@pytest.mark.parametrize("d", [1, 4])
def test_single_block_container_identical(d):
    data = _markov(BLOCK)
    got, want = _both(data, d, block_size=BLOCK)
    assert got == want and len(_tags(got)) == 1
    _decodes_everywhere(got, data, d)


@pytest.mark.parametrize("d", [1, 4])
def test_phred64_container_identical(d):
    lines = _markov(2 * BLOCK).split(b"\n")
    for i in range(3, len(lines), 4):  # quality lines: +33 -> +64 (all >= 64)
        lines[i] = bytes(b + 31 for b in lines[i])
    data = b"\n".join(lines)
    got, want = _both(data, d, block_size=BLOCK)
    assert got == want
    assert C.read_file_header(io.BytesIO(got)).phred64
    assert any(q == C.TAG_WCTX for _, q in _tags(got))
    _decodes_everywhere(got, data, d)


@pytest.mark.parametrize("d", [1, 4])
def test_noise_container_picks_rans_and_is_identical(d):
    """Quality walks above the context model's bins: the quality slot goes
    to the order-0 coder with one table per round; IID sequence stays zstd.
    Three blocks: with d = 4 a partial round padded with empty streams."""
    one = len(synth_fastq(0, read_len=100))
    data = synth_fastq(3000 * one / (1 << 20), read_len=100, seed=3, qual_model="walk")
    got, want = _both(data, d, block_size=1100)
    assert got == want
    tags = _tags(got)
    assert len(tags) == 3 and all(q == C.TAG_RANS for _, q in tags), tags
    _decodes_everywhere(got, data, d)


@pytest.mark.parametrize("d", [1, 4])
def test_seq_dict_container_identical(d):
    """Coverage data: the cross-block dictionary section and TAG_SLDM
    candidates of the mesh path; decompress_mesh routes it to the ordinary
    decoder."""
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 20000)
    bases = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for i in range(6000):  # 15x coverage of a 20 kb genome
        start = int(rng.integers(0, len(genome) - 60))
        seq = bases[genome[start : start + 60]].tobytes().decode()
        reads.append(f"@r{i}\n{seq}\n+\n{'I' * 60}\n")
    data = "".join(reads).encode()
    got, want = _both(data, d, block_size=1500)
    assert got == want
    assert C.read_file_header(io.BytesIO(got)).flags & C.FLAG_SEQ_DICT
    _decodes_everywhere(got, data, d)


def test_edge_inputs_identical():
    for data in (
        b"",
        b"@a\r\n\r\n+\r\n\r\n@b\nACGT\n+pay\nIIII\n@c\nacgtn\n+\nIIIII\n",
    ):
        got, want = _both(data, 4)
        assert got == want
        assert tfq.decompress_bytes(got, device="cpu") == jfq.decompress_bytes(want)


def test_lossless_refused_with_the_jax_string():
    data = b"@r\nACGT\n+\nIIII\n"
    with pytest.raises(ValueError) as want:
        jmeshpipe.compress_mesh_bytes(data, jfq.Options(lossless=True), jmesh.make_mesh(1))
    with pytest.raises(ValueError) as got:
        pmeshpipe.compress_mesh_bytes(
            data, tfq.Options(lossless=True), pmesh.make_mesh(1, device="cpu")
        )
    assert str(got.value) == str(want.value)


def test_decompress_mesh_reads_per_block_containers_and_rejects_v2():
    """Containers of the per-block v3 pipeline (per-stream tables, other
    tags) fall back block by block; lossless ones go to the ordinary
    decoder; v2 is refused with the JAX package's string."""
    data = _noise(900, seed=8)
    mesh = pmesh.make_mesh(4, device="cpu")
    for opts in (tfq.Options(version=3, block_size=250),
                 tfq.Options(version=3, block_size=250, lossless=True)):
        comp = tfq.compress_bytes(data, opts, device="cpu")
        out = io.BytesIO()
        pmeshpipe.decompress_mesh(io.BytesIO(comp), out, mesh)
        assert out.getvalue() == data
    v2 = tfq.compress_bytes(data, device="cpu")
    with pytest.raises(jfq.container.FormatError) as want:
        jmeshpipe.decompress_mesh(io.BytesIO(v2), io.BytesIO(), jmesh.make_mesh(1))
    with pytest.raises(C.FormatError) as got:
        pmeshpipe.decompress_mesh(io.BytesIO(v2), io.BytesIO(), mesh)
    assert str(got.value) == str(want.value)


def test_corrupt_mesh_container_fails_typed():
    data = _markov(2 * BLOCK)
    mesh = pmesh.make_mesh(2, device="cpu")
    comp = pmeshpipe.compress_mesh_bytes(data, tfq.Options(block_size=BLOCK), mesh)
    rng = np.random.default_rng(0)
    hits = 0
    for _ in range(6):
        b = bytearray(comp)
        b[int(rng.integers(100, len(b)))] ^= int(rng.integers(1, 256))
        out = io.BytesIO()
        try:
            pmeshpipe.decompress_mesh(io.BytesIO(bytes(b)), out, mesh)
            assert out.getvalue() == data  # the flip hit dead bytes only
        except (C.FormatError, ZstdError):
            hits += 1
    assert hits >= 3


@pytest.mark.parametrize("slot", [2, 5])
def test_corrupt_zstd_frame_strings_follow_each_jax_decoder(slot):
    """A TAG_WCTX container whose headers (2) or lengths (5) frame fails its
    checksum: ``decompress_mesh`` keeps libzstd's name, as the JAX package's
    ``decompress_mesh`` does; with ``runtime_errors`` (the default decoder's
    route on the card) and in the default decoder on the CPU the string is
    the JAX package's default decoder's (its C++ runtime)."""
    from fastqpacker_tpu.runtime import bindings

    assert bindings.available() and bindings.decompress_mt_v3_ex_available()
    data = _markov(2 * BLOCK)
    mesh = pmesh.make_mesh(1, device="cpu")
    comp = pmeshpipe.compress_mesh_bytes(data, tfq.Options(block_size=BLOCK), mesh)
    r = io.BytesIO(comp)
    C.read_file_header(r)
    sizes = C.read_block_header(r, 3).stream_sizes(C.VERSION_2)
    base = r.tell()
    assert comp[base + sizes[0]] == C.TAG_WCTX
    bad = bytearray(comp)
    bad[base + sum(sizes[: slot + 1]) - 1] ^= 0x10  # the frame's checksum
    bad = bytes(bad)
    with pytest.raises(Exception) as mesh_want:
        jmeshpipe.decompress_mesh(io.BytesIO(bad), io.BytesIO(), jmesh.make_mesh(1))
    with pytest.raises(Exception) as default_want:
        jfq.decompress_bytes(bad)
    assert str(default_want.value) == "corrupted zstd frame in block payload"
    assert str(mesh_want.value) == "Restored data doesn't match checksum"
    for kwargs, want in (({}, mesh_want), ({"runtime_errors": True}, default_want)):
        with pytest.raises(ZstdError) as got:
            pmeshpipe.decompress_mesh(io.BytesIO(bad), io.BytesIO(), mesh, **kwargs)
        assert type(want.value).__name__ == "ZstdError"
        assert str(got.value) == str(want.value)
    with pytest.raises(ZstdError, match=f"^{default_want.value}$"):
        tfq.decompress_bytes(bad, device="cpu")


# ---------------------------------------------------------------------------
# stream lists
# ---------------------------------------------------------------------------


def _wctx_jobs(rng, k):
    n_rec, L = 900, 90
    lengths = np.full(n_rec, L, np.int64)
    jobs = []
    for _ in range(k):
        q = wi.walk_quals(rng, n_rec * L, hi=46)
        d = q.reshape(n_rec, L).astype(np.int16)
        delta = np.concatenate([d[:, :1], np.diff(d, axis=1) % 256], axis=1)
        raw, hist2 = jqualctx.prepare(delta.astype(np.uint8).reshape(-1), lengths)
        assert np.array_equal(raw, q)
        jobs.append((q, lengths, jqualctx.hist_for_model(hist2, 0)))
    return jobs


@pytest.mark.parametrize("d", [1, 2, 4])
def test_wctx_stream_lists_equal(d):
    rng = np.random.default_rng(50 + d)
    jobs = _wctx_jobs(rng, max(1, d - 1))
    if d == 4:
        jobs.insert(1, None)  # a skipped slot; the last slot is padding
    want = jmesh.wctx_encode_streams(jobs, 1, 0, jmesh.make_mesh(d), lanes=256)
    mesh = pmesh.make_mesh(d, device="cpu")
    got = pmesh.wctx_encode_streams(jobs, 1, 0, mesh, lanes=256)
    assert got == want and len(got) == d
    finisher = pmesh.wctx_encode_streams(jobs, 1, 0, mesh, lanes=256, async_result=True)
    assert finisher() == want
    lens = [j[1] if j else None for j in jobs]
    back = pmesh.wctx_decode_streams(got[: len(jobs)], lens, mesh)
    assert len(back) == d
    for j, b in zip(jobs, back):
        assert (b is None) if j is None else np.array_equal(b, j[0])
    assert all(b is None for b in back[len(jobs):])


def test_wctx_group_lane_count_is_the_groups_minimum():
    """Without ``lanes``: one lane count per group, the smallest
    ``pick_lanes_for`` of its blocks, written into every stream."""
    rng = np.random.default_rng(60)
    jobs = _wctx_jobs(rng, 2)
    mesh = pmesh.make_mesh(2, device="cpu")
    got = pmesh.wctx_encode_streams(jobs, 1, 0, mesh)
    n = min(pwctx.pick_lanes_for(j[2], len(j[0])) for j in jobs)
    assert [pwctx.parse_stream(p)["N"] for p in got] == [n, n]
    assert n == min(jwctx.pick_lanes_for(j[2], len(j[0])) for j in jobs)


def test_wctx_decode_streams_unbatchable_groups_return_none():
    rng = np.random.default_rng(61)
    lengths = wi.rand_lengths(rng, 200, 1, 40)
    q = wi.walk_quals(rng, int(lengths.sum()))
    a = pwctx.encode_stream(q, lengths, 1, 0, lanes=256, device="cpu")
    b = pwctx.encode_stream(q, lengths, 1, 1, lanes=256, device="cpu")
    c = pwctx.encode_stream(q, lengths, 1, 0, lanes=512, device="cpu")
    mesh = pmesh.make_mesh(2, device="cpu")
    for pair in ([a, b], [a, c]):
        assert pmesh.wctx_decode_streams(pair, [lengths, lengths], mesh) is None
        assert jmesh.wctx_decode_streams(pair, [lengths, lengths], jmesh.make_mesh(2)) is None
    assert pmesh.wctx_decode_streams([None, None], [None, None], mesh) == [None, None]
    with pytest.raises(pwctx.WctxError, match="wctx total does not match record lengths"):
        pmesh.wctx_decode_streams([a], [lengths[:-1]], mesh)
    with pytest.raises(ValueError, match="need <= 2 payloads, got 3"):
        pmesh.wctx_decode_streams([a, a, a], [lengths] * 3, mesh)
    with pytest.raises(ValueError, match="need <= 2 jobs, got 3"):
        pmesh.wctx_encode_streams([None] * 3, 1, 0, mesh)
    assert pmesh.wctx_encode_streams([None, None], 1, 0, mesh) == [None, None]


@pytest.mark.parametrize("d", [1, 2, 4])
def test_entropy_stream_lists_equal(d):
    rng = np.random.default_rng(70 + d)
    lens = [30000, 0, 12345, 257][:d]
    if d == 1:
        lens = [30000]
    streams = [rng.integers(0, 40, size=n).astype(np.uint8).tobytes() for n in lens]
    want = jmesh.entropy_encode_streams(streams, jmesh.make_mesh(d))
    mesh = pmesh.make_mesh(d, device="cpu")
    got = pmesh.entropy_encode_streams(streams, mesh)
    assert got == want
    assert pmesh.entropy_encode_streams(streams, mesh, async_result=True)() == want
    if d > 1:
        assert got[1] == struct.pack(prans.HEADER_FMT, 0, 0)
    assert pmesh.entropy_decode_streams(got, mesh) == streams
    for s, p in zip(streams, got):  # standalone streams, both packages
        assert prans.decode_stream(p, device="cpu") == s
        assert jrans.decode_stream(p) == s


def test_entropy_table_equal():
    rng = np.random.default_rng(80)
    streams = rng.integers(0, 9, size=(3, 5000)).astype(np.uint8)
    lens = np.array([5000, 1200, 0], np.int32)
    for kw in ({}, {"raw_lens": lens}, {"raw_lens": lens, "lanes": 4096}, {"pad_sym": 3}):
        got_fc, got_pad = pmesh.entropy_table(streams, **kw)
        want_fc, want_pad = jmesh.entropy_table(streams, **kw)
        assert got_pad == want_pad and np.array_equal(got_fc, want_fc)
        assert got_fc.dtype == want_fc.dtype


def test_entropy_decode_streams_unbatchable_groups_return_none():
    rng = np.random.default_rng(81)
    a = prans.encode_stream(rng.integers(0, 40, 20000).astype(np.uint8), device="cpu")
    b = prans.encode_stream(rng.integers(0, 9, 20000).astype(np.uint8), device="cpu")
    mesh = pmesh.make_mesh(2, device="cpu")
    assert pmesh.entropy_decode_streams([a, b], mesh) is None  # two tables
    empty = struct.pack(prans.HEADER_FMT, 0, 0)
    assert pmesh.entropy_decode_streams([empty, empty], mesh) == [b"", b""]
    assert pmesh.entropy_encode_streams([b"", b""], mesh) == [empty, empty]
    with pytest.raises(prans.RansError, match="truncated rANS stream header"):
        pmesh.entropy_decode_streams([a[:3], a], mesh)
    with pytest.raises(prans.RansError, match="truncated rANS stream words"):
        pmesh.entropy_decode_streams([a[:-2], a], mesh)
    with pytest.raises(ValueError, match="need 2 payloads, got 1"):
        pmesh.entropy_decode_streams([a], mesh)
    with pytest.raises(ValueError, match=r"need 2 streams \(one per device\), got 1"):
        pmesh.entropy_encode_streams([b"x"], mesh)
    lost = bytearray(a)
    off = 8 + 512 + 4 * 256
    total = int.from_bytes(a[off : off + 4], "little")
    lost[off : off + 4] = (total - 50).to_bytes(4, "little")
    with pytest.raises(prans.RansError, match="corrupted rANS stream data"):
        pmesh.entropy_decode_streams([bytes(lost[:-100]), empty], mesh)


# ---------------------------------------------------------------------------
# the device list, and the pieces the mesh path added elsewhere
# ---------------------------------------------------------------------------


def test_make_mesh(monkeypatch):
    assert pmesh.make_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert pmesh.make_mesh(device="cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="at least one device"):
        pmesh.make_mesh(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pmesh.make_mesh() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert pmesh.make_mesh(1) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="asked for 4 CUDA devices, 2 present"):
        pmesh.make_mesh(4)


def test_make_mesh_starts_at_a_named_card(monkeypatch):
    """``make_mesh(1, "cuda:1")`` is the card of that index (``fqpack bench
    --metric mesh-e2e`` runs on the card it is given, not on cuda:0)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert pmesh.make_mesh(1, "cuda:1") == [torch.device("cuda", 1)]
    assert pmesh.make_mesh(None, "cuda:1") == [torch.device("cuda", 1), torch.device("cuda", 2)]
    assert pmesh.make_mesh(1, torch.device("cuda", 2)) == [torch.device("cuda", 2)]
    assert pmesh.make_mesh(2, "cuda:0") == pmesh.make_mesh(2)
    with pytest.raises(ValueError, match="asked for 3 CUDA devices from cuda:1, 2 present"):
        pmesh.make_mesh(3, "cuda:1")
    with pytest.raises(ValueError, match="asked for 0 CUDA devices from cuda:3, 0 present"):
        pmesh.make_mesh(None, "cuda:3")


def test_raw_to_delta_equals_jax():
    """The quality delta stream that the port builds from a decoded
    ``TAG_WCTX`` matrix (the plain version of ``fq_wctx_unlayout``, which
    took the place of its ``_raw_to_delta``) equals the JAX package's
    ``_raw_to_delta`` and integrates back to the qualities."""
    import torch

    from fastqpacker_tpu_torch.ops import ctxprep

    rng = np.random.default_rng(90)
    lengths = wi.rand_lengths(rng, 300)
    raw = wi.walk_quals(rng, int(lengths.sum()))
    present = np.flatnonzero(np.bincount(raw, minlength=256) > 0)
    tab, steps, _ = ctxprep.lane_layout(lengths, 256)
    mat = pwctx._sym_to_idx(present)[pwctx.to_matrix(raw, tab[0], steps, int(present[0]))]
    delta, fault = ctxprep.wctx_unlayout_plain(
        torch.from_numpy(mat), torch.from_numpy(ctxprep.record_bounds(lengths)),
        torch.from_numpy(tab), torch.from_numpy(present.astype(np.uint8)),
        ctxprep.UNLAYOUT_DELTA)
    assert delta.numpy().tobytes() == jnative._raw_to_delta(raw, lengths)
    assert int(fault) == 0
    assert np.array_equal(jqualctx.integrate(delta.numpy(), lengths), raw)
    # an empty stream: decode_wire returns before any launch
    assert pwctx.decode_wire(_empty_wctx(pwctx.MODEL_QUAL, 1), lengths[:0], "cpu") == (
        jnative._raw_to_delta(raw[:0], lengths[:0]))


def _empty_wctx(model, order, lanes_log2=8):
    """A TAG_WCTX payload of zero symbols: one present symbol, all-zero
    tables, no words."""
    from fastqpacker_tpu_torch.entropy import zstd as pzstd

    ctxs = pwctx.model_geometry(model, order)[0]
    blob = pzstd.get_codec().compress(bytes(2 * ctxs))
    return (struct.pack(pwctx.HEADER_FMT, model, order, lanes_log2, 0)
            + struct.pack("<H", 1) + bytes(1) + struct.pack("<I", len(blob)) + blob
            + struct.pack("<I", 0) + bytes(4 << lanes_log2))


@pytest.mark.parametrize("records", [0, 3])
@pytest.mark.parametrize("model, order", [(pwctx.MODEL_SEQ, 2), (pwctx.MODEL_QUAL, 1)])
def test_decode_wire_of_an_empty_stream_equals_jax(model, order, records):
    """A ``TAG_WCTX`` payload over no records, or over records of length 0,
    decodes to the empty wire stream of its slot on the CPU, as the JAX
    package's decode and its ``pack_stream`` / ``_raw_to_delta`` give it."""
    from fastqpacker_tpu.ops import seqctx as jseqctx

    payload = _empty_wctx(model, order)
    lengths = np.zeros(records, np.int64)
    flat = jwctx.decode_stream(payload, lengths)
    assert len(flat) == 0
    if model == pwctx.MODEL_SEQ:
        want = jseqctx.pack_stream(flat, lengths).tobytes()
    else:
        want = jnative._raw_to_delta(flat, lengths)
    assert pwctx.decode_wire(payload, lengths, "cpu") == want == b""


def test_source_view_and_first_block_sniff(tmp_path):
    from fastqpacker_tpu.pipeline import device as jdevice
    from fastqpacker_tpu_torch.pipeline import device as pdevice
    from fastqpacker_tpu_torch.utils.inmem import source_view

    data = _markov(BLOCK)
    mesh = pmesh.make_mesh(1, device="cpu")
    comp = pmeshpipe.compress_mesh_bytes(data, tfq.Options(block_size=BLOCK), mesh)
    plain = tfq.compress_bytes(data, tfq.Options(version=3, block_size=BLOCK), device="cpu")
    for c, want in ((comp, True), (plain, False), (comp[:20], False)):
        body = memoryview(c)[C.FILE_HEADER_SIZE:]
        assert pdevice._first_block_wctx(body) is want
        assert jdevice._first_block_wctx(body) is want
    r = io.BytesIO(comp)
    r.read(C.FILE_HEADER_SIZE)
    assert bytes(source_view(r)) == comp[C.FILE_HEADER_SIZE:]
    path = tmp_path / "c.fqz"
    path.write_bytes(comp)
    with open(path, "rb") as f:
        f.read(C.FILE_HEADER_SIZE)
        assert bytes(source_view(f)) == comp[C.FILE_HEADER_SIZE:]
    assert source_view(io.BufferedReader(io.BytesIO(comp))) is None
