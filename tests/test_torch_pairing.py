"""The port's paired-end path (``utils/pairing.py``,
``api.compress_paired`` / ``decompress_paired``, ``fqpack --pair``) against
the JAX package's.

Mirrors ``tests/test_pairing.py``: the interleaving reader and the
de-interleaving writer on small chunks and bounded reads, a record-count
mismatch, an odd record count, and the paired round trip on v2 and v3,
whose container must equal the JAX ``compress_paired`` container; a JAX
paired container must split in the port into the same two files. The port
runs on the CPU (``device="cpu"``); comparisons are exact.
"""

import gzip
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu.pipeline import api as jax_api
from fastqpacker_tpu.utils import pairing as jax_pairing
from fastqpacker_tpu_torch.pipeline import api as port_api
from fastqpacker_tpu_torch.utils import pairing
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
ENV = {**os.environ, "FQZ_FORCE_CPU": "1", "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
C = tfq.container


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions are loops of small tensor operations: torch's
    thread pool only adds hand-offs, and beside other test processes it
    oversubscribes the cores (as ``torch_wctx_inputs.one_torch_thread``,
    here for the module's fixtures too)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _host_rans_backend(monkeypatch):
    """Which JAX rANS decode runs on the CPU is process state; pin it."""
    monkeypatch.setenv("FQZ_RANS_BACKEND", "host")


def mate_files(n: int, tag: str) -> bytes:
    out = []
    for i in range(n):
        seq = "ACGT" * (2 + (i * 7 + len(tag)) % 5)
        out.append(f"@pair{i}/{tag} run=7\n{seq}\n+\n{'F' * len(seq)}\n")
    return "".join(out).encode()


def seeded_mates(n: int, seed: int) -> tuple[bytes, bytes]:
    """Two mate files of variable-length records (0-180 bp, CRLF on some
    lines, plus-line payloads)."""
    rng = np.random.default_rng(seed)
    mates = []
    for tag in "12":
        recs = []
        for i in range(n):
            ln = int(rng.integers(0, 181))
            s = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), ln))
            q = bytes(rng.integers(33, 75, ln).astype(np.uint8))
            eol = b"\r\n" if i % 7 == 3 else b"\n"
            plus = b"+r%d" % i if i % 5 == 0 else b"+"
            recs.append(b"@m%d/%s" % (i, tag.encode()) + eol + s + eol + plus + b"\n" + q + b"\n")
        mates.append(b"".join(recs))
    return mates[0], mates[1]


R1 = mate_files(517, "1")
R2 = mate_files(517, "2")


def interleaved_expect(r1: bytes, r2: bytes) -> bytes:
    recs1 = r1.splitlines(keepends=True)
    recs2 = r2.splitlines(keepends=True)
    out = []
    for i in range(len(recs1) // 4):
        out += recs1[i * 4 : i * 4 + 4] + recs2[i * 4 : i * 4 + 4]
    return b"".join(out)


def test_interleaved_reader_small_chunks():
    rd = pairing.InterleavedPairReader(io.BytesIO(R1), io.BytesIO(R2), chunk_bytes=256)
    assert rd.read() == interleaved_expect(R1, R2)


def test_interleaved_reader_bounded_reads():
    rd = pairing.InterleavedPairReader(io.BytesIO(R1), io.BytesIO(R2))
    got = b""
    while chunk := rd.read(1000):
        got += chunk
    assert got == interleaved_expect(R1, R2)


@pytest.mark.parametrize("chunk_bytes", [13, 97, 4096, 8 << 20])
@pytest.mark.parametrize("read_size", [-1, 333])
def test_interleaved_reader_matches_jax(chunk_bytes, read_size):
    r1, r2 = seeded_mates(400, seed=chunk_bytes)

    def drain(mod):
        rd = mod.InterleavedPairReader(io.BytesIO(r1), io.BytesIO(r2), chunk_bytes=chunk_bytes)
        parts = []
        while part := rd.read(read_size):
            parts.append(part)
        return parts

    got = drain(pairing)
    assert got == drain(jax_pairing)
    assert b"".join(got) == interleaved_expect(r1, r2)


@pytest.mark.parametrize("n1,n2", [(517, 516), (516, 517), (0, 3), (99, 517)])
def test_count_mismatch_raises(n1, n2):
    rd = pairing.InterleavedPairReader(
        io.BytesIO(mate_files(n1, "1")), io.BytesIO(mate_files(n2, "2")))
    with pytest.raises(pairing.PairError) as got:
        rd.read()
    jrd = jax_pairing.InterleavedPairReader(
        io.BytesIO(mate_files(n1, "1")), io.BytesIO(mate_files(n2, "2")))
    with pytest.raises(jax_pairing.PairError) as want:
        jrd.read()
    assert str(got.value) == str(want.value) == pairing.ERR_COUNT_MISMATCH
    assert isinstance(got.value, ValueError)


@pytest.mark.parametrize("step", [1, 777, 1 << 20])
def test_deinterleaving_writer_chunked(step):
    text = interleaved_expect(R1, R2)
    w1, w2 = io.BytesIO(), io.BytesIO()
    dw = pairing.DeinterleavingWriter(w1, w2)
    for i in range(0, len(text), step):
        assert dw.write(text[i : i + step]) == len(text[i : i + step])
    dw.close()
    assert w1.getvalue() == R1
    assert w2.getvalue() == R2


def test_deinterleaving_writer_matches_jax():
    r1, r2 = seeded_mates(300, seed=4)
    text = interleaved_expect(r1, r2)
    outs = []
    for mod in (pairing, jax_pairing):
        w1, w2 = io.BytesIO(), io.BytesIO()
        dw = mod.DeinterleavingWriter(w1, w2)
        for i in range(0, len(text), 1234):
            dw.write(text[i : i + 1234])
        dw.close()
        outs.append((w1.getvalue(), w2.getvalue()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("tail", [b"@odd\nACGT\n+\nFFFF\n", b"@cut\nAC"])
def test_deinterleave_odd_records_raises(tail):
    text = interleaved_expect(R1, R2) + tail
    dw = pairing.DeinterleavingWriter(io.BytesIO(), io.BytesIO())
    dw.write(text)
    with pytest.raises(pairing.PairError, match="odd number") as got:
        dw.close()
    assert str(got.value) == jax_pairing.ERR_ODD_RECORDS


def _jax_paired(r1, r2, version, **opts):
    """The JAX package's per-block path writes the v3 container (its
    whole-file C++ call is skipped for a non-addressable reader anyway)."""
    out = io.BytesIO()
    jax_api.compress_paired(io.BytesIO(r1), io.BytesIO(r2), out,
                            jax_api.Options(version=version, workers=1, **opts))
    return out.getvalue()


def _port_paired(r1, r2, version, **opts):
    out = io.BytesIO()
    port_api.compress_paired(io.BytesIO(r1), io.BytesIO(r2), out,
                             tfq.Options(version=version, workers=1, **opts), device="cpu")
    return out.getvalue()


def _split(decompress_paired, comp, **kw):
    w1, w2 = io.BytesIO(), io.BytesIO()
    decompress_paired(io.BytesIO(comp), w1, w2, **kw)
    return w1.getvalue(), w2.getvalue()


@pytest.mark.parametrize("version", [C.VERSION_2, C.VERSION_3_NATIVE])
@pytest.mark.parametrize("mates", ["fixed", "seeded"])
def test_paired_round_trip_matches_jax(version, mates):
    r1, r2 = (R1, R2) if mates == "fixed" else seeded_mates(450, seed=version)
    comp = _port_paired(r1, r2, version, block_size=100)
    jcomp = _jax_paired(r1, r2, version, block_size=100)
    assert comp == jcomp
    fh = C.read_file_header(io.BytesIO(comp))
    assert fh.paired and fh.version == version
    # the paired container is the interleaved text's container with the flag
    assert comp == tfq.compress_bytes(
        interleaved_expect(r1, r2),
        tfq.Options(version=version, workers=1, block_size=100, flags=C.FLAG_PAIRED_END),
        device="cpu")
    r1_cr, r2_cr = (x.replace(b"\r\n", b"\n") for x in (r1, r2))
    assert _split(port_api.decompress_paired, jcomp, device="cpu") == (r1_cr, r2_cr)
    assert _split(jax_api.decompress_paired, comp) == (r1_cr, r2_cr)


def test_paired_container_decodes_interleaved_without_split():
    comp = _port_paired(R1, R2, C.VERSION_2)
    assert tfq.decompress_bytes(comp, device="cpu") == interleaved_expect(R1, R2)


@pytest.mark.parametrize("comp", ["unpaired", "short", "not_fqz"])
def test_paired_decode_refusals_match_jax(comp):
    data = {"unpaired": tfq.compress_bytes(R1, device="cpu"), "short": b"FQZ\x00\x02",
            "not_fqz": b"NOTFQZ" * 3}[comp]
    with pytest.raises(C.FormatError) as got:
        _split(port_api.decompress_paired, data, device="cpu")
    with pytest.raises(jax_api.container.FormatError) as want:
        _split(jax_api.decompress_paired, data)
    assert str(got.value) == str(want.value)
    if comp == "unpaired":
        assert "not paired-end (FlagPairedEnd not set)" in str(got.value)


def _corrupt_last_frame_byte(comp: bytes, version: int) -> bytes:
    """``comp`` with the checksum byte of block 0's headers frame flipped."""
    r = io.BytesIO(comp)
    C.read_file_header(r)
    hdr = C.read_block_header(r, version)
    sizes = hdr.stream_sizes(C.VERSION_2)
    at = r.tell() + sizes[0] + sizes[1] + sizes[2] - 1
    out = bytearray(comp)
    out[at] ^= 0x10
    return bytes(out)


@pytest.mark.parametrize("version", [C.VERSION_2, C.VERSION_3_NATIVE])
def test_paired_decode_is_not_addressable(version):
    """The paired decode reads through a reader that is not addressable, in
    both packages: the corrupt-zstd error is the one each package's
    per-block decoder gives, the same in both. For v3 that is libzstd's
    name, where the whole-file decode of the same bytes (an addressable
    source) names the frame as the JAX runtime does."""
    import fastqpacker_tpu as jfq

    comp = _corrupt_last_frame_byte(_port_paired(R1, R2, version, block_size=100), version)

    def outcome(fn, *args, **kw):
        with pytest.raises(Exception) as e:
            fn(*args, **kw)
        return type(e.value).__name__, str(e.value)

    got = outcome(_split, port_api.decompress_paired, comp, device="cpu")
    assert got == outcome(_split, jax_api.decompress_paired, comp)
    whole = outcome(tfq.decompress_bytes, comp, device="cpu")
    assert whole == outcome(jfq.decompress_bytes, comp)
    assert whole == ("ZstdError", "corrupted zstd frame in block payload")
    if version == C.VERSION_3_NATIVE:
        assert got == ("ZstdError", "Restored data doesn't match checksum")
    else:  # v1/v2 name a failing frame per block either way
        assert got == whole


def test_paired_readers_are_not_addressable():
    from fastqpacker_tpu_torch.utils.inmem import source_view

    chained = port_api._ChainedReader(b"FQZ", io.BytesIO(b"rest"))
    interleaved = pairing.InterleavedPairReader(io.BytesIO(R1), io.BytesIO(R2))
    assert source_view(chained) is None and source_view(interleaved) is None


def test_chained_reader_replays_the_head():
    for n in (-1, 0, 1, 2, 3, 4, 9):
        rd = port_api._ChainedReader(b"abc", io.BytesIO(b"defgh"))
        jrd = jax_api._ChainedReader(b"abc", io.BytesIO(b"defgh"))
        got = [rd.read(n) for _ in range(4)]
        assert got == [jrd.read(n) for _ in range(4)]
    assert port_api._ChainedReader(b"abc", io.BytesIO(b"de")).read() == b"abcde"


def _cli(module, argv):
    p = subprocess.run([sys.executable, "-m", module, "--backend", "cpu", *argv],
                       capture_output=True, env=ENV, cwd=REPO, timeout=110)
    return p.returncode, p.stdout, p.stderr


@pytest.mark.timeout(300)
def test_cli_paired_matches_jax_cli(tmp_path):
    """``--pair`` with a gzipped mate on compress, ``-d --pair`` on
    decompress, and the mate-count mismatch: both CLIs, each in its own
    process; stdout, stderr, exit codes and files equal."""
    f1, f2, bad = tmp_path / "r1.fq", tmp_path / "r2.fq.gz", tmp_path / "r2bad.fq"
    f1.write_bytes(R1)
    f2.write_bytes(gzip.compress(R2))
    bad.write_bytes(mate_files(99, "2"))
    files = {}
    for tag, module in (("p", "fastqpacker_tpu_torch.cli.fqpack"),
                        ("j", "fastqpacker_tpu.cli.fqpack")):
        fz, o1, o2 = (tmp_path / f"{tag}{n}" for n in ("pe.fqz", "o1.fq", "o2.fq"))
        runs = [
            _cli(module, ["-i", str(f1), "--pair", str(f2), "-o", str(fz)]),
            _cli(module, ["-d", "-i", str(fz), "-o", str(o1), "--pair", str(o2)]),
            _cli(module, ["-i", str(f1), "--pair", str(bad), "-c"]),
        ]
        files[tag] = (runs, fz.read_bytes(), o1.read_bytes(), o2.read_bytes())
    assert files["p"] == files["j"]
    runs, comp, o1, o2 = files["p"]
    assert [r[0] for r in runs] == [0, 0, 1]
    assert runs[2][2] == b"error: paired inputs have different record counts\n"
    assert (o1, o2) == (R1, R2) and C.read_file_header(io.BytesIO(comp)).paired
