"""A corrupt tagged stream of an addressable v3 file: the port names it as
the JAX package's default decoder does.

That decoder hands an addressable, non-lossless v3 body to its whole-file
C++ runtime, which says one string per codec whatever the fault
(``blocks.RUNTIME_STREAM_ERRORS``); its per-block decoders, which read pipes,
name the fault. Six bits flipped inside each tagged stream of block 0 (the
tag byte left alone) give the same type and string through
``decompress_bytes`` and ``check`` in both packages, and the first flip of
each gives the same stdout, stderr and exit code through both CLIs; read
from a pipe, the per-block strings stay.
"""

import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import fastqpacker_tpu as jfq
import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu.cli import inspect as jax_inspect
from fastqpacker_tpu_torch.cli import inspect as port_inspect
from fastqpacker_tpu_torch.entropy import zstd as port_zstd
from fastqpacker_tpu_torch.format import container as C
from fastqpacker_tpu_torch.parallel import mesh as pmesh
from fastqpacker_tpu_torch.pipeline import meshpipe as pmeshpipe
from fastqpacker_tpu_torch.pipeline.blocks import RUNTIME_STREAM_ERRORS
from fastqpacker_tpu_torch.utils.synth import synth_fastq
from test_torch_inspect import _coverage, _ctx_fastq, _markov
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
# the JAX CLI's per-block rANS decoder is pinned to its host twin, as
# ``_host_rans_backend`` pins it in this process (ROADMAP.md Queue C 3)
ENV = {**os.environ, "FQZ_FORCE_CPU": "1", "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
       "FQZ_RANS_BACKEND": "host"}
FLIPS = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain wctx coder is a loop of small tensor operations (see
    ``test_torch_inspect``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _host_rans_backend(monkeypatch):
    """Which JAX rANS decode runs on the CPU is process state; pin it."""
    monkeypatch.setenv("FQZ_RANS_BACKEND", "host")


def _walk():
    one = len(synth_fastq(0, read_len=151))
    return synth_fastq(1200 * one / (1 << 20), read_len=151, seed=3, qual_model="walk")


def _v3(data, **opts):
    return tfq.compress_bytes(data, tfq.Options(version=3, workers=1, **opts), device="cpu")


def _block0_streams(comp: bytes):
    """(file prefix, block 0 header, its six streams, the rest)."""
    r = io.BytesIO(comp)
    fh = C.read_file_header(r)
    if fh.flags & C.FLAG_SEQ_DICT:
        C.read_seq_dict_section(r)
    head = comp[: r.tell()]
    hdr = C.read_block_header(r, C.VERSION_3_NATIVE)
    sizes = hdr.stream_sizes(C.VERSION_2)
    payload = r.read(sum(sizes))
    streams = [payload[sum(sizes[:k]) : sum(sizes[: k + 1])] for k in range(6)]
    return head, hdr, streams, r.read()


def _bad_tokens(comp: bytes) -> bytes:
    """``comp`` with block 0's TAG_TOK stream replaced by a sound zstd frame
    of a token stream cut in half: the frame decodes, the tokens do not."""
    head, hdr, streams, rest = _block0_streams(comp)
    codec = port_zstd.get_codec()
    assert streams[2][0] == C.TAG_TOK
    tokens = codec.decompress(streams[2][1:])
    streams[2] = bytes([C.TAG_TOK]) + codec.compress(tokens[: len(tokens) // 2])
    hdr = dataclasses.replace(hdr, header_data_size=len(streams[2]))
    return head + hdr.to_bytes(C.VERSION_3_NATIVE) + b"".join(streams) + rest


def _mesh():
    return pmeshpipe.compress_mesh_bytes(
        _markov(3600), tfq.Options(block_size=1800), pmesh.make_mesh(1, device="cpu"))


# case -> (container, slot, tag); the containers are made once per module
CASES = {
    "rans": ("walk", 1, C.TAG_RANS),
    "sctx": ("ctx", 0, C.TAG_SCTX),
    "qctx": ("ctx", 1, C.TAG_QCTX),
    "tok": ("bad_tokens", 2, C.TAG_TOK),
    "sldm": ("dict", 0, C.TAG_SLDM),
    "wctx_seq": ("mesh", 0, C.TAG_WCTX),
    "wctx_qual": ("mesh", 1, C.TAG_WCTX),
}
MAKERS = {
    "walk": lambda: _v3(_walk()),
    "ctx": lambda: _v3(_ctx_fastq()),
    "dict": lambda: _v3(_coverage(), block_size=650),
    "mesh": _mesh,
}


@pytest.fixture(scope="module")
def containers():
    made = {name: make() for name, make in MAKERS.items()}
    made["bad_tokens"] = _bad_tokens(made["ctx"])
    return made


def _flipped(comp: bytes, slot: int, tag: int) -> list[bytes]:
    """Six copies of ``comp``, each with one bit flipped at a spread of
    positions inside block 0's stream ``slot`` (after its tag byte); the
    TAG_TOK case is already corrupt and comes back as it is."""
    if tag == C.TAG_TOK:
        return [comp]
    head, hdr, streams, _ = _block0_streams(comp)
    assert streams[slot][0] == tag
    start = len(head) + C.block_header_size(C.VERSION_3_NATIVE) + sum(map(len, streams[:slot]))
    size = len(streams[slot]) - 1
    out = []
    for k in range(FLIPS):
        b = bytearray(comp)
        b[start + 1 + (2 * k + 1) * size // (2 * FLIPS)] ^= 1 << k
        out.append(bytes(b))
    return out


def _outcome(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e)
    return "ok", ""


def _check(mod, path, **kw):
    out = io.StringIO()
    return mod.check(str(path), out=out, **kw), out.getvalue()


def _cli(module, argv, stdin=None):
    p = subprocess.run([sys.executable, "-m", module, "--backend", "cpu", *argv],
                       input=stdin, capture_output=True, env=ENV, cwd=REPO, timeout=110)
    return p.returncode, p.stdout, p.stderr


class _Pipe(io.RawIOBase):
    """A readable stream that cannot be addressed (no fileno, no buffer)."""

    def __init__(self, data: bytes):
        self._src = io.BytesIO(data)

    def readable(self):
        return True

    def readinto(self, b):
        data = self._src.read(len(b))
        b[: len(data)] = data
        return len(data)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", list(CASES))
def test_corrupt_stream_strings_follow_the_jax_default_decoder(case, containers, tmp_path,
                                                                monkeypatch):
    which, slot, tag = CASES[case]
    codec_string = ("FormatError", RUNTIME_STREAM_ERRORS[tag])
    path = tmp_path / "bad.fqz"
    named, cli_done = 0, False
    for k, bad in enumerate(_flipped(containers[which], slot, tag)):
        want = _outcome(lambda: jfq.decompress_bytes(bad))
        assert want[0] != "ok", k
        assert _outcome(lambda: tfq.decompress_bytes(bad, device="cpu")) == want, k
        path.write_bytes(bad)
        got = _check(port_inspect, path, device="cpu")
        assert got == _check(jax_inspect, path) == (1, f"check FAILED: {want[1]}\n"), k
        if want != codec_string:  # the CRC caught it, or a frame header hit
            continue                 # sent the file to the Python decoder
        named += 1
        if not cli_done:  # the CLIs, each in its own process
            for argv in (["-d", "-i", str(path), "-o", str(tmp_path / "o.fq")],
                         ["check", str(path)]):
                got = _cli("fastqpacker_tpu_torch.cli.fqpack", ["-w", "1", *argv])
                assert got == _cli("fastqpacker_tpu.cli.fqpack", argv), argv
                assert got[0] == 1 and codec_string[1].encode() in got[1] + got[2]
            cli_done = True
            pipe = bad
    assert named >= (1 if tag == C.TAG_TOK else FLIPS // 2)
    # from a pipe both packages take their per-block decoders, which name
    # the fault as the JAX package's reference decoders do
    port_pipe = _outcome(lambda: tfq.decompress(_Pipe(pipe), io.BytesIO(), device="cpu"))
    assert port_pipe[0] != "ok"
    if case not in ("wctx_seq", "wctx_qual"):  # ROADMAP.md Queue C: XLA vs numpy wctx strings
        assert port_pipe == _jax_reference_pipe(pipe, monkeypatch)


def _jax_reference_pipe(bad: bytes, monkeypatch):
    """The JAX package's per-block decode of ``bad`` read from a pipe, with
    its reference context coders and tokenizer: where its C++ runtime is
    built its per-block qctx / sctx / token decoders call their C++ twins,
    whose strings differ (ROADMAP.md Queue C); the port's per-block decoders
    are the reference's copies."""
    from fastqpacker_tpu.ops import qualctx, seqctx, tokenize
    from fastqpacker_tpu.pipeline import native

    with monkeypatch.context() as m:
        m.setattr(qualctx, "_native", lambda: None)
        m.setattr(seqctx, "_native", lambda: None)
        m.setattr(native, "_tok_decode", tokenize.decode)
        return _outcome(lambda: jfq.decompress(_Pipe(bad), io.BytesIO()))


def test_a_pipe_keeps_the_per_block_string_in_the_cli(containers, tmp_path):
    """``fqpack -d`` reading a corrupt rANS stream from standard input: both
    CLIs print the per-block decoder's string."""
    (bad, *_) = _flipped(containers["walk"], 1, C.TAG_RANS)
    out = str(tmp_path / "o.fq")
    got = _cli("fastqpacker_tpu_torch.cli.fqpack", ["-w", "1", "-d", "-o", out], stdin=bad)
    assert got == _cli("fastqpacker_tpu.cli.fqpack", ["-d", "-o", out], stdin=bad)
    assert got[0] == 1 and got[2] == b"error: corrupted rANS stream data\n"


def test_corrupt_dictionary_section_matches_jax(containers):
    """The dictionary section is decoded before the blocks, by the Python
    half of both default decoders: a flipped byte there fails alike."""
    comp = containers["dict"]
    r = io.BytesIO(comp)
    C.read_file_header(r)
    start = r.tell()
    C.read_seq_dict_section(r)
    bad = bytearray(comp)
    bad[(start + r.tell()) // 2] ^= 0x20
    bad = bytes(bad)
    want = _outcome(lambda: jfq.decompress_bytes(bad))
    assert want[0] != "ok"
    assert _outcome(lambda: tfq.decompress_bytes(bad, device="cpu")) == want


def test_the_qctx_checks_stay_off_the_per_block_routes(containers, monkeypatch):
    """Flips that only the whole-file decoder's qctx checks catch (a slot of
    a symbol with no frequency, words left at the end of a chunk): through a
    pipe the port's per-block decoder leaves them to the block CRC, as the
    JAX package's reference decoder does."""
    seen = set()
    for bad in _flipped(containers["ctx"], 1, C.TAG_QCTX):
        got = _outcome(lambda: tfq.decompress(_Pipe(bad), io.BytesIO(), device="cpu"))
        assert got == _jax_reference_pipe(bad, monkeypatch)
        assert _outcome(lambda: tfq.decompress_bytes(bad, device="cpu")) == (
            "FormatError", "corrupted qctx quality data")
        seen.add(got[1])
    assert "block CRC32 mismatch: corrupted data" in seen
