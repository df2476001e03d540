"""The port's FQZ v3 (``--format native``) pipeline against the JAX
package's, byte for byte.

The same seeded input goes to ``fastqpacker_tpu_torch.compress_bytes(...,
Options(version=3), device="cpu")`` and to the JAX package's per-block
Python path (``pipeline.native.compress_native`` with ``encode_arrays``
given, which skips its whole-file C++ call). Containers must be identical
(one worker: the cross-block probe memo is order-dependent), each package
must decode the other's, the golden v3 containers must decode, and errors
must carry the same type and message. All comparisons are exact.
"""

import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import fastqpacker_tpu as jfq
import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu.ops import reference as jax_refops
from fastqpacker_tpu.pipeline import native as jax_native
from fastqpacker_tpu_torch.pipeline import api as port_api
from fastqpacker_tpu_torch.pipeline import native as port_native
from torch_wctx_inputs import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "testdata" / "golden"
C = tfq.container


@pytest.fixture(autouse=True)
def _jax_codes_rans_with_its_sequential_twin(monkeypatch):
    """Which rANS backend the JAX package picks on the CPU is process state
    (a memoized transfer probe that other test files may have set). Pin it:
    the sequential twin writes the same streams as the XLA programs, and
    only it reports a stream whose word count does not fit."""
    monkeypatch.setenv("FQZ_RANS_BACKEND", "host")


def _fastq(n, seed, varlen=False, maxlen=151, alphabet="ACGTN", qbase=33,
           qlevels=41, plus=False):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        ln = int(rng.integers(0, maxlen + 1)) if varlen else maxlen
        s = "".join(alphabet[b] for b in rng.integers(0, len(alphabet), ln))
        q = "".join(chr(qbase + int(b)) for b in rng.integers(0, qlevels, ln))
        p = f"rd_{i} x={i % 5}" if plus else ""
        recs.append(f"@rd_{i} x={i % 5}\n{s}\n+{p}\n{q}\n")
    return "".join(recs).encode()


def _ctx_fastq(nrec=700, length=151):
    """Correlated DNA, sticky binned qualities, structured headers: the
    recipe of the committed ``golden_ctx_v3.fqz`` at a size on which the
    per-symbol Python coders stay quick. The JAX package codes it as
    TAG_SCTX / TAG_QCTX / TAG_TOK."""
    rng = np.random.default_rng(20260818)
    sym = np.frombuffer(b"ACGTN", np.uint8)
    cur = rng.integers(0, 4, nrec)
    m = np.empty((nrec, length), np.uint8)
    for p in range(length):
        stay = rng.random(nrec) < 0.62
        cur = np.where(stay, cur, rng.integers(0, 4, nrec))
        m[:, p] = cur
    m[rng.integers(0, nrec, 20), rng.integers(0, length, 20)] = 4
    levels = np.array([2, 12, 23, 37], np.uint8)
    steps = np.cumsum(rng.integers(-1, 2, (nrec, length)), axis=1)
    q = levels[np.clip((steps // 6) % 4, 0, 3)] + 33
    return b"".join(
        b"@GCTX.%d 1:N:0:ACGT\n" % i + sym[m[i]].tobytes() + b"\n+\n"
        + q[i].tobytes() + b"\n"
        for i in range(nrec)
    )


def _coverage_fastq(nrec=1300, length=151):
    """Reads sampled from a 3 kb genome: block 0's coverage probe fires,
    so the container carries FLAG_SEQ_DICT and TAG_SLDM streams."""
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 3000)
    sym = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(nrec):
        s = int(rng.integers(0, len(genome) - length))
        q = rng.integers(33, 74, length).astype(np.uint8)
        recs.append(
            b"@cov.%d\n" % i + sym[genome[s : s + length]].tobytes()
            + b"\n+\n" + q.tobytes() + b"\n"
        )
    return b"".join(recs)


def _walk_fastq():
    from fastqpacker_tpu_torch.utils.synth import synth_fastq

    return synth_fastq(1.5, seed=3, qual_model="walk")


# name -> (input, options shared by both packages)
CASES = {
    "default": (lambda: _fastq(900, 1), dict(block_size=400)),
    "max_ratio": (lambda: _fastq(700, 2, qlevels=8), dict(block_size=400, order1_qual=True)),
    "lossless": (
        lambda: _fastq(500, 3, varlen=True, alphabet="ACGTNacgtnRY."),
        dict(block_size=200, lossless=True),
    ),
    "phred64": (lambda: _fastq(600, 4, qbase=64), dict(block_size=250)),
    "varlen": (lambda: _fastq(900, 5, varlen=True, maxlen=300, plus=True), dict(block_size=300)),
    "n_heavy": (
        lambda: _fastq(400, 6, varlen=True, alphabet="NNNNACGTacgtRY."),
        dict(block_size=150),
    ),
    "coverage_seq_dict": (_coverage_fastq, dict(block_size=650)),
    "context_coders": (_ctx_fastq, dict()),
    "context_coders_max_ratio": (_ctx_fastq, dict(order1_qual=True)),
    "rans_qualities": (_walk_fastq, dict(block_size=2500)),
    "one_record": (lambda: b"@r\nACGTN\n+\nIIII#\n", dict()),
}


def _jax_blockwise(data, **opts):
    out = io.BytesIO()
    jax_native.compress_native(
        io.BytesIO(data), out, jfq.Options(version=3, workers=1, **opts),
        encode_arrays=jax_refops.encode_block_arrays,
    )
    return out.getvalue()


def _port(data, **opts):
    return tfq.compress_bytes(
        data, tfq.Options(version=3, workers=1, **opts), device="cpu"
    )


def _stream_tags(comp):
    """(file flags, [(seq tag, qual tag, headers tag) per block])."""
    r = io.BytesIO(comp)
    fh = C.read_file_header(r)
    if fh.flags & C.FLAG_SEQ_DICT:
        C.read_seq_dict_section(r)
    tags = []
    while (hdr := C.read_block_header(r, 3)) is not None:
        sizes = hdr.stream_sizes(2)
        p = r.read(sum(sizes))
        tags.append((p[0], p[sizes[0]], p[sizes[0] + sizes[1]]))
    return fh.flags, tags


@pytest.mark.parametrize("case", sorted(CASES))
def test_containers_byte_identical(case):
    make, opts = CASES[case]
    data = make()
    got = _port(data, **opts)
    want = _jax_blockwise(data, **opts)
    assert got == want
    # each package decodes the other's container
    plain = jfq.decompress_bytes(want)
    assert tfq.decompress_bytes(want, device="cpu") == plain
    assert jfq.decompress_bytes(got) == plain
    # the format normalizes lowercase and exotic bases unless lossless
    if case != "n_heavy":
        assert plain == data


def test_cases_reach_every_codec_tag():
    """The inputs above are not all zstd: each pick is exercised."""
    flags, tags = _stream_tags(_port(_ctx_fastq()))
    assert tags == [(C.TAG_SCTX, C.TAG_QCTX, C.TAG_TOK)]
    flags, tags = _stream_tags(_port(_coverage_fastq(), block_size=650))
    assert flags & C.FLAG_SEQ_DICT and all(t[0] == C.TAG_SLDM for t in tags)
    assert len(tags) == 2
    flags, tags = _stream_tags(_port(_walk_fastq(), block_size=2500))
    assert len(tags) >= 2 and all(t[1] == C.TAG_RANS for t in tags)
    flags, tags = _stream_tags(
        _port(_fastq(500, 3, varlen=True, alphabet="ACGTNacgtnRY."),
              block_size=200, lossless=True)
    )
    assert flags & C.FLAG_LOSSLESS


def test_equals_the_jax_default_entry_point():
    """``fastqpacker_tpu.compress_bytes`` (its whole-file C++ call) writes
    the same container on a small input."""
    data = _fastq(900, 1)
    want = jfq.compress_bytes(data, jfq.Options(version=3, block_size=400, workers=1))
    assert _port(data, block_size=400) == want


def test_default_block_size_is_100k_records():
    data = _fastq(50, 8)
    comp = _port(data)
    assert C.read_file_header(io.BytesIO(comp)).block_size == 100_000
    assert comp == _jax_blockwise(data)


def test_empty_input():
    got = _port(b"")
    assert got == _jax_blockwise(b"")
    assert len(got) == C.FILE_HEADER_SIZE and got[4] == 3
    assert tfq.decompress_bytes(got, device="cpu") == b""


def test_golden_v3_decodes():
    got = tfq.decompress_bytes((GOLDEN / "golden_v3.fqz").read_bytes(), device="cpu")
    assert got == (GOLDEN / "golden.fq").read_bytes()


def test_golden_ctx_v3_decodes():
    """The committed context-coder container (TAG_SCTX, TAG_QCTX model 1,
    TAG_TOK): the port's Python coders decode it to what the JAX package
    decodes."""
    comp = (GOLDEN / "golden_ctx_v3.fqz").read_bytes()
    flags, tags = _stream_tags(comp)
    assert tags[0] == (C.TAG_SCTX, C.TAG_QCTX, C.TAG_TOK)
    assert tfq.decompress_bytes(comp, device="cpu") == jfq.decompress_bytes(comp)


def test_long_read_with_trailing_n_round_trips():
    """v3 has no 65,536 bp tracking cap (u32 N positions)."""
    seq = "A" * 65540 + "N" * 4
    data = f"@long\n{seq}\n+\n{'I' * len(seq)}\n".encode()
    got = _port(data)
    assert got == _jax_blockwise(data)
    assert tfq.decompress_bytes(got, device="cpu") == data


@pytest.mark.parametrize("workers", [1, 3])
def test_workers_are_honoured_both_ways(workers, monkeypatch):
    """``-w`` reaches the block pool on compress and on decompress, and
    the output does not depend on it."""
    seen = []
    real = port_api.ordered_map_write

    def spy(w, jobs, fn, n):
        seen.append(n)
        return real(w, jobs, fn, n)

    monkeypatch.setattr(port_api, "ordered_map_write", spy)
    data = _fastq(900, 9, varlen=True)
    comp = tfq.compress_bytes(
        data, tfq.Options(version=3, block_size=100, workers=workers), device="cpu"
    )
    back = tfq.decompress_bytes(
        comp, tfq.DecompressOptions(workers=workers), device="cpu"
    )
    assert back == data and seen == [workers, workers]
    assert jfq.decompress_bytes(comp) == data


def _flip(comp: bytes, pos: int) -> bytes:
    bad = bytearray(comp)
    bad[pos] ^= 0x01
    return bytes(bad)


def test_crc_mismatch_message():
    """A flipped bit in the stored CRC field of the first block header."""
    comp = _port(_fastq(300, 10))
    bad = _flip(comp, C.FILE_HEADER_SIZE + 36)
    with pytest.raises(C.FormatError, match="block CRC32 mismatch: corrupted data"):
        tfq.decompress_bytes(bad, device="cpu")
    with pytest.raises(Exception) as want:
        _jax_blockwise_decode(bad)
    assert str(want.value) == "block CRC32 mismatch: corrupted data"


def _jax_blockwise_decode(comp: bytes) -> bytes:
    """The JAX package's per-block v3 decode (``decode_block_payload``),
    without its whole-file C++ call."""
    from fastqpacker_tpu.entropy import zstd as jax_zstd
    from fastqpacker_tpu.format import container as jc

    r = io.BytesIO(comp)
    fh = jc.read_file_header(r)
    out = []
    while (hdr := jc.read_block_header(r, 3)) is not None:
        payload = r.read(sum(hdr.stream_sizes(2)))
        out.append(
            jax_native.decode_block_payload(
                hdr, payload, jax_zstd.get_codec(), 64 if fh.phred64 else 33,
                lossless=bool(fh.flags & jc.FLAG_LOSSLESS),
            )
        )
    return b"".join(out)


@pytest.mark.parametrize("where", ["seq_tag", "qual_rans_words", "payload_cut", "header_cut"])
def test_corrupt_v3_errors_match_jax(where):
    data = _walk_fastq()
    comp = _port(data, block_size=100_000)
    hdr = C.parse_block_header(comp[C.FILE_HEADER_SIZE :], 3)
    body = C.FILE_HEADER_SIZE + C.BLOCK_HEADER_SIZE_V3
    if where == "seq_tag":
        bad = bytearray(comp)
        bad[body] = 9
        bad = bytes(bad)
    elif where == "qual_rans_words":
        bad = _flip(comp, body + hdr.seq_data_size + hdr.qual_data_size - 5)
    elif where == "payload_cut":
        bad = comp[: body + 1000]
    else:
        bad = comp[: C.FILE_HEADER_SIZE + 7]
    with pytest.raises(Exception) as want:
        _jax_blockwise_decode(bad)
    with pytest.raises(Exception) as got:
        tfq.decompress_bytes(bad, device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_wctx_streams_are_refused_by_name():
    """A stream that only claims ``TAG_WCTX`` (the device context coder
    is ported now: tests/test_torch_wctx.py, test_torch_mesh.py) fails as
    in the JAX package's per-block decoder, by the parse error's name, when
    the file is read from a stream that cannot be addressed; from an
    addressable file both default decoders say the whole-file decoder's
    "corrupted wctx stream"."""
    comp = bytearray(_port(_fastq(300, 11)))
    comp[C.FILE_HEADER_SIZE + C.BLOCK_HEADER_SIZE_V3] = C.TAG_WCTX
    with pytest.raises(Exception) as want:
        _jax_blockwise_decode(bytes(comp))
    with pytest.raises(Exception) as got:
        tfq.decompress(_Unaddressable(bytes(comp)), io.BytesIO(), device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__ == "FormatError"
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("unknown wctx model")
    with pytest.raises(Exception) as want:
        jfq.decompress_bytes(bytes(comp))
    with pytest.raises(Exception) as got:
        tfq.decompress_bytes(bytes(comp), device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__ == "FormatError"
    assert str(got.value) == str(want.value) == "corrupted wctx stream"


class _Unaddressable(io.RawIOBase):
    """A readable stream with no buffer to view (a pipe's stand-in)."""

    def __init__(self, data: bytes):
        self._src = io.BytesIO(data)

    def readable(self):
        return True

    def readinto(self, b):
        data = self._src.read(len(b))
        b[: len(data)] = data
        return len(data)


def test_lossless_needs_v3():
    with pytest.raises(ValueError) as want:
        jfq.compress_bytes(b"@r\nacgt\n+\nIIII\n", jfq.Options(lossless=True))
    with pytest.raises(ValueError) as got:
        tfq.compress_bytes(b"@r\nacgt\n+\nIIII\n", tfq.Options(lossless=True), device="cpu")
    assert str(got.value) == str(want.value)


def test_malformed_fastq_errors_match():
    bad = b"@r1\nACGT\n+\nIII\n"
    with pytest.raises(Exception) as want:
        _jax_blockwise(bad)
    with pytest.raises(Exception) as got:
        _port(bad)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_no_device_programs_outside_the_given_device(monkeypatch):
    """``device="cpu"`` never reaches for the card, and the default device
    without a card raises before any work."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _fastq(50, 12)
    comp = _port(data)
    assert tfq.decompress_bytes(comp, device="cpu") == data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfq.compress_bytes(data, tfq.Options(version=3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfq.decompress_bytes(comp)


def _cli(module, argv):
    return subprocess.run(
        [sys.executable, "-m", module, *argv], capture_output=True, text=True,
        cwd=REPO, timeout=240,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "FQZ_FORCE_CPU": "1",
             "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
    )


@pytest.mark.parametrize("flags", [["--format", "native"], ["--max-ratio"], ["--lossless"]])
def test_cli_native_equals_jax_cli(flags, tmp_path):
    data = _fastq(600, 13, varlen=True, alphabet="ACGTNacgt")
    src = tmp_path / "in.fq"
    src.write_bytes(data)
    port_fqz, jax_fqz, back = tmp_path / "p.fqz", tmp_path / "j.fqz", tmp_path / "b.fq"
    common = ["--backend", "cpu", "-w", "1", "-b", "250", *flags, "-i", str(src)]
    p = _cli("fastqpacker_tpu_torch.cli.fqpack", [*common, "-o", str(port_fqz)])
    assert p.returncode == 0, p.stderr
    j = _cli("fastqpacker_tpu.cli.fqpack", [*common, "-o", str(jax_fqz)])
    assert j.returncode == 0, j.stderr
    assert port_fqz.read_bytes() == jax_fqz.read_bytes()
    d = _cli("fastqpacker_tpu_torch.cli.fqpack",
             ["--backend", "cpu", "-w", "2", "-d", "-i", str(jax_fqz), "-o", str(back)])
    assert d.returncode == 0, d.stderr
    assert back.read_bytes() == jfq.decompress_bytes(jax_fqz.read_bytes())
    if flags == ["--lossless"]:
        assert back.read_bytes() == data


def test_block_streams_match_jax_wide_npos():
    """One block's uncompressed v3 streams (u32 N positions) and the
    lossless side data."""
    from fastqpacker_tpu.parser import fastq as jax_parser
    from fastqpacker_tpu.pipeline import blocks as jax_blocks
    from fastqpacker_tpu_torch.parser import fastq as port_parser
    from fastqpacker_tpu_torch.pipeline import blocks as port_blocks

    data = _fastq(300, 14, varlen=True, alphabet="NNACGTacgtRY.")
    jax_block = jax_parser.parse_all(data)[0]
    block = next(port_parser.FastqStreamParser(io.BytesIO(data), device="cpu").blocks())
    raw = port_blocks.block_to_raw_streams(block, 33, wide_npos=True)
    want = jax_blocks.block_to_raw_streams(jax_block, 33, wide_npos=True)
    for name in ("seq", "qual", "headers", "plus", "npos", "lengths"):
        assert getattr(raw, name) == bytes(memoryview(getattr(want, name))), name
    lens = block.lengths.astype(np.int64)
    assert port_native._lossless_extra(block, lens) == jax_native._lossless_extra(
        jax_block, jax_block.lengths.astype(np.int64)
    )
    counts, rows, pos = port_blocks.parse_npos_stream(
        np.frombuffer(raw.npos, np.uint8), block.n, wide=True
    )
    jc, jr, jp = jax_blocks.parse_npos_stream(
        np.frombuffer(raw.npos, np.uint8), block.n, wide=True
    )
    assert np.array_equal(counts, jc) and np.array_equal(rows, jr) and np.array_equal(pos, jp)


def _mesh_container():
    """A container with TAG_WCTX sequence and quality streams, written by
    the JAX package's mesh path on one device."""
    from fastqpacker_tpu.parallel import mesh as jax_mesh
    from fastqpacker_tpu.pipeline import meshpipe as jax_meshpipe
    from fastqpacker_tpu_torch.utils.synth import synth_fastq

    one = len(synth_fastq(0, read_len=100))
    data = synth_fastq(1800 * one / (1 << 20), read_len=100, seed=31,
                       qual_model="phredwalk", seq_model="markov")
    comp = jax_meshpipe.compress_mesh_bytes(
        data, jfq.Options(block_size=1800), jax_mesh.make_mesh(1)
    )
    return data, comp


def test_wctx_streams_decode_in_the_per_block_decoder():
    """The ``TAG_WCTX`` branch of ``_decode_tagged`` and the ``predecoded``
    argument of ``decode_block_payload`` against the JAX package's."""
    from fastqpacker_tpu.entropy import zstd as jax_zstd
    from fastqpacker_tpu_torch.entropy import zstd as port_zstd

    data, comp = _mesh_container()
    assert tfq.decompress_bytes(comp, device="cpu") == data
    hdr = C.parse_block_header(comp[C.FILE_HEADER_SIZE :], 3)
    payload = comp[C.FILE_HEADER_SIZE + C.BLOCK_HEADER_SIZE_V3 :]
    assert payload[0] == payload[hdr.seq_data_size] == C.TAG_WCTX
    codec, dev = port_zstd.get_codec(), port_native.devops.resolve_device("cpu")
    lengths = np.full(1800, 100, np.int64)
    streams = []
    for at, size in ((0, hdr.seq_data_size), (hdr.seq_data_size, hdr.qual_data_size)):
        chunk = payload[at : at + size]
        got = port_native._decode_tagged(chunk, codec, dev, 1800, lengths)
        assert got == jax_native._decode_tagged(chunk, jax_zstd.get_codec(), 1800, lengths)
        streams.append(got)
    # streams decoded elsewhere are taken as they are, under the block CRC
    text = port_native.decode_block_payload(
        hdr, payload, codec, 33, dev, predecoded={0: streams[0], 1: streams[1]}
    )
    assert text == data
    wrong = bytes([streams[1][0] ^ 1]) + streams[1][1:]
    with pytest.raises(C.FormatError, match="block CRC32 mismatch"):
        port_native.decode_block_payload(
            hdr, payload, codec, 33, dev, predecoded={1: wrong}
        )
    # the tag outside the two slots that carry record lengths
    with pytest.raises(jfq.container.FormatError) as want:
        jax_native._decode_tagged(payload[: hdr.seq_data_size], jax_zstd.get_codec(), 1800)
    with pytest.raises(C.FormatError) as got:
        port_native._decode_tagged(payload[: hdr.seq_data_size], codec, dev, 1800)
    assert str(got.value) == str(want.value)
    # a flipped byte inside the stream: typed, never a crash
    bad = bytearray(comp)
    bad[C.FILE_HEADER_SIZE + C.BLOCK_HEADER_SIZE_V3 + hdr.seq_data_size // 2] ^= 0x40
    with pytest.raises(C.FormatError):
        tfq.decompress_bytes(bytes(bad), device="cpu")
