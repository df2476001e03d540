"""The port's fqpack CLI against the JAX package's CLI."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastqpacker_tpu.cli import fqpack as jax_cli
from fastqpacker_tpu_torch.cli import fqpack as port_cli

REPO = Path(__file__).resolve().parent.parent
ENV = {
    **os.environ,
    "FQZ_FORCE_CPU": "1",
    "JAX_PLATFORMS": "cpu",
    "PYTHONPATH": str(REPO),
}


def _fastq(n, seed):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        ln = int(rng.integers(1, 200))
        s = "".join("ACGTN"[b] for b in rng.integers(0, 5, ln))
        q = "".join(chr(33 + int(b)) for b in rng.integers(0, 41, ln))
        recs.append(f"@cli_{i}\n{s}\n+\n{q}\n")
    return "".join(recs).encode()


def _run(module, args):
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        capture_output=True, env=ENV, cwd=REPO, timeout=110,
    )


@pytest.mark.timeout(120)
def test_cli_round_trip_matches_jax_cli(tmp_path):
    data = _fastq(900, seed=1)
    src = tmp_path / "in.fq"
    src.write_bytes(data)
    port_fqz, jax_fqz, back = (tmp_path / n for n in ("p.fqz", "j.fqz", "back.fq"))

    p = _run("fastqpacker_tpu_torch.cli.fqpack",
             ["--backend", "cpu", "-b", "250", "-i", str(src), "-o", str(port_fqz)])
    assert p.returncode == 0, p.stderr
    j = _run("fastqpacker_tpu.cli.fqpack",
             ["--backend", "cpu", "-b", "250", "-i", str(src), "-o", str(jax_fqz)])
    assert j.returncode == 0, j.stderr
    assert port_fqz.read_bytes() == jax_fqz.read_bytes()

    d = _run("fastqpacker_tpu_torch.cli.fqpack",
             ["--backend", "cpu", "-d", "-i", str(jax_fqz), "-o", str(back)])
    assert d.returncode == 0, d.stderr
    assert back.read_bytes() == data


@pytest.mark.parametrize(
    "argv,name",
    [
        (["--format", "native"], "--format native"),
        (["--max-ratio"], "--max-ratio"),
        (["--lossless"], "--lossless"),
        (["--mesh"], "--mesh"),
        (["--pair", "r2.fq"], "--pair"),
        (["info", "x.fqz"], "info"),
        (["check", "x.fqz"], "check"),
        (["cat", "x.fqz"], "cat"),
        (["bench", "--mb", "1"], "bench"),
    ],
)
def test_unported_surfaces_exit_1(argv, name, capsys):
    assert port_cli.main(argv) == 1
    assert capsys.readouterr().err == (
        f"error: {name} is not yet ported in fastqpacker_tpu_torch\n"
    )


@pytest.mark.parametrize(
    "bad",
    [b"r1\nACGT\n+\nIIII\n", b"@r1\nACGT\n-\nIIII\n", b"@r1\nACGT\n+\nIII\n"],
)
def test_malformed_input_errors_match_jax_cli(bad, tmp_path, capsys):
    src = tmp_path / "bad.fq"
    src.write_bytes(bad)
    argv = ["--backend", "cpu", "-i", str(src), "-o", str(tmp_path / "o.fqz")]
    assert jax_cli.main(argv) == 1
    want = capsys.readouterr().err
    assert port_cli.main(argv) == 1
    assert capsys.readouterr().err == want


def test_corrupt_container_exit_code(tmp_path, capsys):
    src = tmp_path / "bad.fqz"
    src.write_bytes(b"NOTFQZ" * 4)
    argv = ["--backend", "cpu", "-d", "-i", str(src), "-o", str(tmp_path / "o.fq")]
    assert jax_cli.main(argv) == 1
    want = capsys.readouterr().err
    assert port_cli.main(argv) == 1
    assert capsys.readouterr().err == want == (
        "error: invalid magic bytes: not an FQZ file\n"
    )


def test_cuda_backend_without_a_card_fails(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.fq"
    src.write_bytes(_fastq(5, seed=2))
    assert port_cli.main(["-i", str(src), "-o", str(tmp_path / "o.fqz")]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_version_and_help(capsys):
    assert port_cli.main(["-version"]) == 0
    assert capsys.readouterr().out == "fqpack version 0.1.0\n"
    assert port_cli.main(["-h"]) == 0
    assert "--backend" in capsys.readouterr().err
