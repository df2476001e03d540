"""The port's ``fqscramble`` (``cli/fqscramble.py``, ``utils/gopcg.py``)
against the JAX package's.

The port runs Go's PCG-DXSM, ``uint64n`` and ``Shuffle`` in pure Python;
the JAX tool takes its C++ runtime when it has one (the bytes are the same,
which its own tests hold against its Python twin). Both modes must give the
JAX tool's bytes: the default (Go-exact) mode chunked or whole, and
``--fast``; on ``golden.fq``, on a seeded variable-length corpus with
UTF-8, CRLF and an incomplete last group, and from ``.gz`` input.
"""

import gzip
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fastqpacker_tpu.cli import fqscramble as jax_scramble
from fastqpacker_tpu.parser import fastq as jax_fastq
from fastqpacker_tpu.utils import gopcg as jax_gopcg
from fastqpacker_tpu_torch.cli import fqscramble as port_scramble
from fastqpacker_tpu_torch.parser import fastq as port_fastq
from fastqpacker_tpu_torch.utils import gopcg
from torch_wctx_inputs import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
GOLDEN_FQ = (REPO / "tests" / "testdata" / "golden" / "golden.fq").read_bytes()
ENV = {**os.environ, "FQZ_FORCE_CPU": "1", "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}


def corpus(n: int, seed: int, exotic: bool = True) -> bytes:
    """Variable-length reads (0-150 bp) with CRLF line ends on some records;
    with ``exotic``, a multi-byte UTF-8 base and an invalid byte now and
    then, and an incomplete trailing group."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        ln = int(rng.integers(0, 151))
        s = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), ln))
        if exotic and i % 11 == 5:
            s += "é".encode() + b"\xff"
        q = bytes(rng.integers(33, 75, len(s)).astype(np.uint8))
        eol = b"\r\n" if i % 6 == 1 else b"\n"
        recs.append(b"@s%d x\n" % i + s + eol + b"+\n" + q + b"\n")
    return b"".join(recs) + (b"@tail\nACGT\n+\n" if exotic else b"")


def test_pcg_stream_and_uint64n_match_jax():
    for seed in (42, 0, 7, 2**63 + 17):
        a, b = gopcg.GoPCG(seed, seed), jax_gopcg.GoPCG(seed, seed)
        assert [a.uint64() for _ in range(200)] == [b.uint64() for _ in range(200)]
        for n in (1, 2, 3, 5, 8, 151, 1 << 40, (1 << 63) + 3, (1 << 64) - 1):
            assert [a.uint64n(n) for _ in range(20)] == [b.uint64n(n) for _ in range(20)]
        seq_a, seq_b = list(range(97)), list(range(97))
        a.shuffle(seq_a)
        b.shuffle(seq_b)
        assert seq_a == seq_b


@pytest.mark.parametrize("name", ["golden", "corpus"])
@pytest.mark.parametrize("seed", [42, 7])
def test_scramble_text_matches_jax(name, seed):
    data = GOLDEN_FQ if name == "golden" else corpus(300, seed)
    got = gopcg.scramble_text(data, seed)
    assert got == jax_gopcg.scramble_text(data, seed)
    assert got != data.replace(b"\r", b"")


@pytest.mark.parametrize("chunk_bytes", [7, 1000, 64 << 20])
def test_scramble_stream_pcg_matches_jax_chunked_and_whole(chunk_bytes):
    data = corpus(400, 3)
    out = io.BytesIO()
    port_scramble.scramble_stream_pcg(io.BytesIO(data), out, seed=5, chunk_bytes=chunk_bytes)
    want = io.BytesIO()
    jax_scramble.scramble_stream_pcg(io.BytesIO(data), want, seed=5)
    assert out.getvalue() == want.getvalue() == gopcg.scramble_text(data, 5)


@pytest.mark.parametrize("name", ["golden", "corpus"])
@pytest.mark.parametrize("block_size", [20000, 37])
def test_fast_mode_matches_jax(name, block_size):
    data = GOLDEN_FQ if name == "golden" else corpus(500, 9, exotic=False)
    got, want = io.BytesIO(), io.BytesIO()
    port_scramble.scramble_stream(io.BytesIO(data), got, seed=11, block_size=block_size)
    jax_scramble.scramble_stream(io.BytesIO(data), want, seed=11, block_size=block_size)
    assert got.getvalue() == want.getvalue()
    assert len(got.getvalue()) == len(data.replace(b"\r", b""))


def test_record_matches_jax():
    data = corpus(50, 2, exotic=False).replace(b"+\n", b"+p\n", 7)
    port_blk = next(port_fastq.FastqStreamParser(io.BytesIO(data), block_size=100).blocks())
    jax_blk = next(jax_fastq.FastqStreamParser(io.BytesIO(data), block_size=100).blocks())
    assert [port_blk.record(i) for i in range(port_blk.n)] == [
        jax_blk.record(i) for i in range(jax_blk.n)]


@pytest.mark.parametrize("fast", [False, True])
def test_main_reads_gzip_like_jax(fast, tmp_path):
    src = tmp_path / "in.fq.gz"
    src.write_bytes(gzip.compress(GOLDEN_FQ))
    outs = []
    for mod in (port_scramble, jax_scramble):
        out = tmp_path / f"{mod.__name__}.fq"
        assert mod.main(["-i", str(src), "-o", str(out), "-seed", "3",
                         *(["--fast"] if fast else [])]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) == len(GOLDEN_FQ)


def test_main_errors_like_jax(tmp_path, capsys):
    src = tmp_path / "bad.fq"
    src.write_bytes(b"r1\nACGT\n+\nIIII\n")
    args = ["--fast", "-i", str(src), "-o", str(tmp_path / "o.fq")]
    assert jax_scramble.main(args) == 1
    want = capsys.readouterr().err
    assert port_scramble.main(args) == 1
    assert capsys.readouterr().err == want


def _cli(module, argv, stdin=None):
    p = subprocess.run([sys.executable, "-m", module, *argv], input=stdin,
                       capture_output=True, env=ENV, cwd=REPO, timeout=110)
    return p.returncode, p.stdout, p.stderr


@pytest.mark.timeout(300)
def test_cli_matches_jax_cli(tmp_path):
    """``fqscramble -seed 7 FILE``, ``--fast`` and stdin to stdout: both tools,
    each in its own process."""
    src = tmp_path / "in.fq"
    src.write_bytes(GOLDEN_FQ)
    for argv, stdin in ((["-seed", "7", str(src)], None), (["--fast", "-i", str(src)], None),
                        (["-seed", "7"], GOLDEN_FQ)):
        got = _cli("fastqpacker_tpu_torch.cli.fqscramble", argv, stdin)
        assert got == _cli("fastqpacker_tpu.cli.fqscramble", argv, stdin), argv
        assert got[0] == 0 and len(got[1]) == len(GOLDEN_FQ)
