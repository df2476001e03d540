"""The port's FQZ v1/v2 pipeline against the JAX package's, byte for byte.

The same seeded input goes to ``fastqpacker_tpu_torch.compress_bytes(...,
device="cpu")``, to ``fastqpacker_tpu.compress_bytes`` and to
``fastqpacker_tpu.pipeline.device.compress_device``; the containers must
be identical, each package must decode the other's, the golden v2
containers must decode, and errors must carry the same type and message.
"""

import io
from functools import partial
from pathlib import Path

import numpy as np
import pytest

import fastqpacker_tpu as jfq
import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu.pipeline import auto as jax_auto
from fastqpacker_tpu.pipeline import device as jax_device_pipe

GOLDEN = Path(__file__).parent / "testdata" / "golden"


def _fastq(n, seed, varlen=False, maxlen=151, alphabet="ACGTN", qbase=33,
           plus=False, crlf=False):
    rng = np.random.default_rng(seed)
    nl = "\r\n" if crlf else "\n"
    recs = []
    for i in range(n):
        ln = int(rng.integers(0, maxlen + 1)) if varlen else maxlen
        s = "".join(alphabet[b] for b in rng.integers(0, len(alphabet), ln))
        q = "".join(chr(qbase + int(b)) for b in rng.integers(0, 41, ln))
        p = f"rd_{i} x={i % 5}" if plus else ""
        recs.append(f"@rd_{i} x={i % 5}{nl}{s}{nl}+{p}{nl}{q}{nl}")
    return "".join(recs).encode()


CASES = {
    "uniform": dict(n=400, seed=1),
    "varlen": dict(n=500, seed=2, varlen=True, maxlen=300),
    "n_heavy": dict(n=300, seed=3, varlen=True, alphabet="NNNNACGTacgtRY."),
    "phred64": dict(n=300, seed=4, qbase=64),
    "plus_payload": dict(n=300, seed=5, plus=True, varlen=True),
    "crlf": dict(n=300, seed=6, crlf=True, varlen=True),
}


@pytest.fixture
def jax_device_path(monkeypatch):
    """The JAX device pipeline, past its transfer probe."""
    monkeypatch.setattr(jax_auto, "device_worthwhile", lambda: True)

    def compress(data, opts):
        out = io.BytesIO()
        jax_device_pipe.compress_device(io.BytesIO(data), out, opts)
        return out.getvalue()

    def decompress(comp):
        out = io.BytesIO()
        jax_device_pipe.decompress_device(io.BytesIO(comp), out)
        return out.getvalue()

    return compress, decompress


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("version", [1, 2])
def test_containers_byte_identical(case, version, jax_device_path):
    data = _fastq(**CASES[case])
    block = 90  # >= 3 blocks for every case
    got = tfq.compress_bytes(
        data, tfq.Options(block_size=block, version=version), device="cpu"
    )
    want = jfq.compress_bytes(data, jfq.Options(block_size=block, version=version))
    assert got == want
    jax_compress, jax_decompress = jax_device_path
    assert got == jax_compress(data, jfq.Options(block_size=block, version=version))
    # each package decodes the other's container
    plain = jfq.decompress_bytes(want)
    assert tfq.decompress_bytes(want, device="cpu") == plain
    assert jax_decompress(got) == plain
    # the format normalizes CRLF, lowercase and exotic bases, and v1 has
    # no plus-line payload; everything else round-trips exactly
    if case not in ("crlf", "n_heavy") and (version == 2 or case != "plus_payload"):
        assert plain == data


def test_default_block_size_and_detection_window():
    """Auto block size, with the Phred window spanning several blocks."""
    data = _fastq(1200, seed=7, varlen=True, qbase=64)
    for opts in (tfq.Options(), tfq.Options(block_size=250)):
        got = tfq.compress_bytes(data, opts, device="cpu")
        want = jfq.compress_bytes(data, jfq.Options(block_size=opts.block_size))
        assert got == want
        assert got[9] & tfq.container.FLAG_PHRED64
        assert tfq.decompress_bytes(got, device="cpu") == data


def test_empty_input():
    got = tfq.compress_bytes(b"", device="cpu")
    assert got == jfq.compress_bytes(b"")
    assert len(got) == tfq.container.FILE_HEADER_SIZE
    assert tfq.decompress_bytes(got, device="cpu") == b""


@pytest.mark.parametrize(
    "comp,text", [("golden_v2.fqz", "golden.fq"), ("golden_p64_v2.fqz", "golden_p64.fq")]
)
def test_golden_v2_decodes(comp, text):
    got = tfq.decompress_bytes((GOLDEN / comp).read_bytes(), device="cpu")
    assert got == (GOLDEN / text).read_bytes()


@pytest.mark.parametrize(
    "bad",
    [
        b"r1\nACGT\n+\nIIII\n",  # no '@'
        b"@r1\nACGT\n-\nIIII\n",  # no '+'
        b"@r1\nACGT\n+\nIII\n",  # length mismatch
        b"@r1\nACGT\n+\nIIII\n@r2\nAC\n-\n",  # trailing partial record
        b"@r1\nACGT\n+\nIIII\nr2\n",
    ],
)
def test_malformed_fastq_errors_match(bad, jax_device_path):
    jax_compress, _ = jax_device_path
    for jax_call in (lambda: jfq.compress_bytes(bad), lambda: jax_compress(bad, None)):
        with pytest.raises(Exception) as want:
            jax_call()
        with pytest.raises(Exception) as got:
            tfq.compress_bytes(bad, device="cpu")
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)


def test_long_read_ambiguity_overflow_matches():
    seq = "A" * 65540 + "N" * 4
    data = f"@long\n{seq}\n+\n{'I' * len(seq)}\n".encode()
    with pytest.raises(ValueError) as want:
        jfq.compress_bytes(data)
    with pytest.raises(ValueError) as got:
        tfq.compress_bytes(data, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("pos", [3, 12, 20, 60, 400, -5])
def test_corrupt_container_errors_match(pos, jax_device_path):
    """A flipped byte fails the same way as in the JAX device pipeline
    (header region, block header, zstd frames and their checksums)."""
    data = _fastq(300, seed=8, varlen=True)
    comp = bytearray(tfq.compress_bytes(data, tfq.Options(block_size=100), device="cpu"))
    comp[pos] ^= 0xFF
    _, jax_decompress = jax_device_path
    with pytest.raises(Exception) as want:
        jax_decompress(bytes(comp))
    with pytest.raises(Exception) as got:
        tfq.decompress_bytes(bytes(comp), device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_truncated_container_errors_match(jax_device_path):
    comp = tfq.compress_bytes(_fastq(200, seed=9), tfq.Options(block_size=64), device="cpu")
    _, jax_decompress = jax_device_path
    for cut in (5, 12, 30, len(comp) - 7):
        with pytest.raises(Exception) as want:
            jax_decompress(comp[:cut])
        with pytest.raises(Exception) as got:
            tfq.decompress_bytes(comp[:cut], device="cpu")
        assert (type(got.value).__name__, str(got.value)) == (
            type(want.value).__name__, str(want.value)
        )


def test_v3_is_refused():
    data = _fastq(20, seed=10)
    with pytest.raises(NotImplementedError, match="FQZ v3 is not yet ported"):
        tfq.compress_bytes(data, tfq.Options(version=3), device="cpu")
    with pytest.raises(NotImplementedError, match="FQZ v3 is not yet ported"):
        tfq.decompress_bytes((GOLDEN / "golden_v3.fqz").read_bytes(), device="cpu")


def test_streams_from_file_objects_and_workers(tmp_path):
    """File sources and sinks, one worker and many: the same container."""
    data = _fastq(700, seed=11, varlen=True)
    src = tmp_path / "in.fq"
    src.write_bytes(data)
    want = jfq.compress_bytes(data, jfq.Options(block_size=100))
    for workers in (1, 5):
        dst = tmp_path / f"out{workers}.fqz"
        with open(src, "rb") as r, open(dst, "wb") as w:
            tfq.compress(r, w, tfq.Options(block_size=100, workers=workers), device="cpu")
        assert dst.read_bytes() == want
        back = tmp_path / f"back{workers}.fq"
        with open(dst, "rb") as r, open(back, "wb") as w:
            tfq.decompress(r, w, tfq.DecompressOptions(workers=workers), device="cpu")
        assert back.read_bytes() == data


@pytest.mark.parametrize("case", ["n_heavy", "plus_payload"])
def test_block_streams_match_jax(case):
    """One block's uncompressed wire streams, and the text rebuilt from
    them, with the port's adapters plugged into its block codec."""
    from fastqpacker_tpu.parser import fastq as jax_parser
    from fastqpacker_tpu.pipeline import blocks as jax_blocks
    from fastqpacker_tpu_torch.entropy import zstd as port_zstd
    from fastqpacker_tpu_torch.ops import device as port_device
    from fastqpacker_tpu_torch.parser import fastq as port_parser
    from fastqpacker_tpu_torch.pipeline import blocks as port_blocks

    data = _fastq(**CASES[case])
    jax_block = jax_parser.parse_all(data)[0]
    block = next(port_parser.FastqStreamParser(io.BytesIO(data)).blocks())
    raw = port_blocks.block_to_raw_streams(
        block, 33, partial(port_device.encode_block_arrays, device="cpu")
    )
    want = jax_blocks.block_to_raw_streams(jax_block, 33)
    for name in ("seq", "qual", "headers", "plus", "npos", "lengths"):
        assert getattr(raw, name) == bytes(memoryview(getattr(want, name))), name

    codec = port_zstd.get_codec()
    comp = port_blocks.compress_raw_streams(raw, codec, 2)
    hdr = tfq.container.parse_block_header(comp, 2)
    ds = port_blocks.decode_streams(hdr, comp[36:], 2, codec)
    text = port_blocks.streams_to_fastq(
        ds, 33, partial(port_device.decode_block_arrays, device="cpu")
    )
    assert text == jfq.decompress_bytes(jfq.compress_bytes(data))
