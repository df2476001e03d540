"""The port's fqpack CLI against the JAX package's CLI."""

import dataclasses
import io
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastqpacker_tpu.cli import fqpack as jax_cli
import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu_torch.cli import fqpack as port_cli
from fastqpacker_tpu_torch.format import container as C
from torch_wctx_inputs import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
ENV = {
    **os.environ,
    "FQZ_FORCE_CPU": "1",
    "JAX_PLATFORMS": "cpu",
    "PYTHONPATH": str(REPO),
    # one intra-op thread in each CLI process: beside the other test
    # processes, torch's thread pool oversubscribes the cores
    "OMP_NUM_THREADS": "1",
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
        (["--mesh", "--pair", "r2.fq"], "--mesh"),
        (["--pair", "r2.fq"], "--pair"),
        (["info", "x.fqz"], "info"),
        (["check", "x.fqz"], "check"),
        (["cat", "x.fqz"], "cat"),
        (["bench", "--mb", "1"], "bench"),
    ],
)
def test_unported_surfaces_exit_1(argv, name, tmp_path, capsys):
    """No surface of the JAX CLI is left unported. ``bench`` forwards to the
    port's bench (``fastqpacker_tpu_torch/bench.py``): ``bench --cpu --mb 1
    --metric micro`` exits 0 with one JSON line. The others, on the same
    argv with the files missing (``-i`` names a file, so nothing reads
    stdin), exit 1 in both CLIs with the same output. ``--mesh --pair`` is
    refused after ``-i`` and ``-o`` are opened, as the JAX CLI does it:
    ``-o`` exists afterwards in both."""
    if name == "bench":
        assert port_cli.main(["bench", "--cpu", "--mb", "1", "--metric", "micro"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert len(out) == 1
        assert json.loads(out[0])["metric"] == "parse_throughput"
        return
    src = tmp_path / "in.fq"
    src.write_bytes(_fastq(5, seed=6))
    out = tmp_path / "o.fqz"
    argv = [str(tmp_path / a) if a.endswith((".fq", ".fqz")) else a for a in argv]
    if name in ("--mesh", "--pair"):
        argv += ["-i", str(src), "-o", str(out)]
    argv = ["--backend", "cpu", *argv]
    got = {}
    for cli in (jax_cli, port_cli):
        rc = cli.main(argv)
        got[cli] = (rc, *capsys.readouterr(), out.exists())
        out.unlink(missing_ok=True)
    assert got[port_cli] == got[jax_cli]
    rc, stdout, stderr, made = got[port_cli]
    assert rc == 1 and made == (name in ("--mesh", "--pair"))
    if name == "--mesh":
        assert stderr == "error: --mesh does not support --pair yet\n"
    elif name == "check":
        assert stdout.startswith("check FAILED: [Errno 2] ") and stderr == ""
    else:
        assert "No such file or directory" in stderr and stdout == ""


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


# A byte flipped mid-file lands in a zstd frame of a block payload. The JAX
# CLI's default decoder (its C++ runtime) names that failure with one
# string; its ``-d --mesh`` decoder passes libzstd's name on. The port's
# CLI follows each.
ZSTD_PAYLOAD = "error: corrupted zstd frame in block payload\n"


@pytest.mark.timeout(300)
@pytest.mark.parametrize(
    "flags", [[], ["--format", "native"], ["--mesh"]], ids=["v2", "native", "mesh"]
)
def test_flipped_byte_errors_match_jax_cli(flags, tmp_path, capsys):
    src = tmp_path / "in.fq"
    src.write_bytes(_fastq(900, seed=5))
    comp = tmp_path / "c.fqz"
    argv = ["--backend", "cpu", "-b", "250", *flags, "-i", str(src), "-o", str(comp)]
    assert port_cli.main(argv) == 0
    bad = bytearray(comp.read_bytes())
    bad[len(bad) // 2] ^= 0xFF
    comp.write_bytes(bytes(bad))
    for dflags in (["-d"], ["-d", "--mesh"]) if "--mesh" in flags else (["-d"],):
        args = ["--backend", "cpu", *dflags, "-i", str(comp), "-o", str(tmp_path / "o.fq")]
        j = subprocess.run(
            [sys.executable, "-m", "fastqpacker_tpu.cli.fqpack", *args],
            capture_output=True, env={**ENV, "XLA_FLAGS": ""}, cwd=REPO, timeout=110,
        )
        assert port_cli.main(["-w", "1", *args]) == j.returncode == 1
        got = capsys.readouterr().err
        assert got == j.stderr.decode()
        if dflags == ["-d"]:
            assert got == ZSTD_PAYLOAD
        else:
            assert got.startswith("error: ") and got != ZSTD_PAYLOAD


def _unsized_frame(raw: bytes) -> bytes:
    """A zstd frame of ``raw`` whose header declares no content size (raw
    blocks of at most 64 KiB, a 1 MiB window), as a streaming encoder
    writes it."""
    out = bytearray(struct.pack("<IBB", 0xFD2FB528, 0x00, 10 << 3))
    chunks = [raw[i : i + 65536] for i in range(0, len(raw), 65536)] or [b""]
    for k, c in enumerate(chunks):
        out += struct.pack("<I", (len(c) << 3) | (k == len(chunks) - 1))[:3] + c
    return bytes(out)


_SIZE_FIELDS = ("seq_data_size", "qual_data_size", "header_data_size",
                "plus_data_size", "npositions_size", "seq_lengths_size")


def _edit_blocks(comp: bytes, version: int, edit) -> bytes:
    """``comp`` with ``edit(i, streams)`` applied to the stream list of
    each block i (v2 slots), the block headers' sizes rewritten."""
    r = io.BytesIO(comp)
    C.read_file_header(r)
    out = bytearray(comp[: r.tell()])
    i = 0
    while (hdr := C.read_block_header(r, version)) is not None:
        sizes = hdr.stream_sizes(C.VERSION_2)
        payload = r.read(sum(sizes))
        streams = [payload[sum(sizes[:k]) : sum(sizes[: k + 1])] for k in range(6)]
        edit(i, streams)
        hdr = dataclasses.replace(
            hdr, **{f: len(x) for f, x in zip(_SIZE_FIELDS, streams)})
        out += hdr.to_bytes(version) + b"".join(streams)
        i += 1
    assert i == 3
    return bytes(out)


def _corrupt_frame(streams, slot=2):
    """The last byte of a frame (its checksum) flipped: libzstd says
    "Restored data doesn't match checksum"."""
    streams[slot] = streams[slot][:-1] + bytes([streams[slot][-1] ^ 0x10])


def _queue_c_container(case: str, version: int) -> bytes:
    """Three 300-record blocks with the faults of one case:
    ``pipe``: one corrupt frame (block 1), read from a pipe;
    ``unsized``: block 0's lengths frame declares no content size, block 2
    has a corrupt frame (the JAX runtime hands the whole file to its Python
    decoder);
    ``two_faults``: a corrupt frame in block 0 and the last block cut short
    (the JAX runtime's first pass meets the cut before any block decodes)."""
    from fastqpacker_tpu_torch.entropy import zstd as port_zstd

    comp = tfq.compress_bytes(_fastq(900, seed=5), tfq.Options(block_size=300, version=version),
                              device="cpu")

    def edit(i, streams):
        if case == "unsized" and i == 0:
            streams[5] = _unsized_frame(port_zstd.get_codec().decompress(streams[5]))
        if (case, i) in (("pipe", 1), ("unsized", 2), ("two_faults", 0)):
            _corrupt_frame(streams)

    out = _edit_blocks(comp, version, edit)
    return out[:-50] if case == "two_faults" else out


@pytest.mark.timeout(300)
@pytest.mark.parametrize(
    "case,version,dflags",
    [("pipe", 3, ["-d"]), ("pipe", 3, ["-d", "--mesh"]),
     ("unsized", 3, ["-d"]), ("unsized", 3, ["-d", "--mesh"]),
     ("two_faults", 3, ["-d"]), ("two_faults", 3, ["-d", "--mesh"]),
     ("two_faults", 2, ["-d"])],
)
def test_zstd_fault_strings_follow_the_jax_cli_per_file(case, version, dflags, tmp_path):
    """The corrupt-zstd string is the JAX CLI's for the whole file: its
    default decoder names a failing frame "corrupted zstd frame in block
    payload" only where its runtime takes the file (an addressable source
    whose first pass over the block headers finds no frame without a
    declared size), and reports the faults in the order that pass and its
    decoders meet them. Both CLIs in their own processes, one worker for
    the port."""
    comp = tmp_path / "c.fqz"
    comp.write_bytes(_queue_c_container(case, version))
    out = tmp_path / "o.fq"
    if case == "pipe":  # stdin from a pipe: the source cannot be addressed
        args, stdin = ["-o", str(out)], comp.read_bytes()
    else:
        args, stdin = ["-i", str(comp), "-o", str(out)], None
    got = {}
    for module, extra in (("fastqpacker_tpu.cli.fqpack", []),
                          ("fastqpacker_tpu_torch.cli.fqpack", ["-w", "1"])):
        p = subprocess.run(
            [sys.executable, "-m", module, "--backend", "cpu", *extra, *dflags, *args],
            input=stdin, capture_output=True, env={**ENV, "XLA_FLAGS": ""}, cwd=REPO,
            timeout=140,
        )
        got[module] = (p.returncode, p.stderr.decode())
    jax_rc, jax_err = got["fastqpacker_tpu.cli.fqpack"]
    assert got["fastqpacker_tpu_torch.cli.fqpack"] == (jax_rc, jax_err) and jax_rc == 1
    if case == "two_faults" and dflags == ["-d"]:
        assert jax_err == "error: truncated block payload\n"
    else:
        assert jax_err == "error: Restored data doesn't match checksum\n"


@pytest.mark.parametrize("fmt", ["v2", "v3", "v3_lossless"])
@pytest.mark.parametrize("seed", range(4))
def test_mutated_container_errors_match_jax(fmt, seed):
    """Bit flips, truncations and random bytes: the port's
    ``decompress_bytes`` on the CPU fails (or not) as the JAX package's
    default ``decompress_bytes`` (its C++ runtime; lossless v3 containers go
    to its Python decoder, which keeps libzstd's names) does, type and
    string."""
    import fastqpacker_tpu as jfq
    import fastqpacker_tpu_torch as tfq
    from fastqpacker_tpu.runtime import bindings

    assert bindings.available() and bindings.mt_available()
    data = _fastq(400, seed=10 + seed)
    opts = tfq.Options(block_size=100, version=2 if fmt == "v2" else 3,
                       lossless=fmt == "v3_lossless")
    comp = tfq.compress_bytes(data, opts, device="cpu")
    rng = np.random.default_rng(100 * len(fmt) + seed)

    def outcome(decompress, b):
        try:
            return decompress(b) == data
        except Exception as e:
            return type(e).__name__, str(e)

    zstd_failures = 0
    for k in range(12):
        b = bytearray(comp)
        at = int(rng.integers(0, len(b)))
        if k % 3 == 0:
            b[at] ^= 1 << int(rng.integers(0, 8))
        elif k % 3 == 1:
            del b[at:]
        else:
            b[at] = int(rng.integers(0, 256))
        want = outcome(jfq.decompress_bytes, bytes(b))
        assert outcome(lambda x: tfq.decompress_bytes(x, device="cpu"), bytes(b)) == want
        zstd_failures += isinstance(want, tuple) and want[0] == "ZstdError"
    assert zstd_failures > 0


def test_cuda_backend_without_a_card_fails(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.fq"
    src.write_bytes(_fastq(5, seed=2))
    assert port_cli.main(["-i", str(src), "-o", str(tmp_path / "o.fqz")]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize(
    "argv",
    [["check", "{fqz}"], ["cat", "{fqz}", "-r", "1:2"],
     ["-i", "{fq}", "--pair", "{fq}", "-o", "{out}"],
     ["-d", "-i", "{fqz}", "--pair", "{out}", "-o", "{out}.1"]],
    ids=["check", "cat", "pair", "pair_d"],
)
def test_card_surfaces_without_a_card_fail(argv, tmp_path, capsys, monkeypatch):
    """``check``, ``cat`` and ``--pair`` run on the card by default: without
    one they fail, and nothing runs on the CPU instead."""
    src = tmp_path / "in.fq"
    src.write_bytes(_fastq(5, seed=7))
    fqz = tmp_path / "in.fqz"
    fqz.write_bytes(tfq.compress_bytes(src.read_bytes(), tfq.Options(flags=C.FLAG_PAIRED_END),
                                       device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    names = {"fqz": fqz, "fq": src, "out": tmp_path / "o"}
    assert port_cli.main([a.format(**names) for a in argv]) == 1
    out, err = capsys.readouterr()
    assert out == "" and err.startswith("error: no CUDA device is available")


def test_version_and_help(capsys):
    assert port_cli.main(["-version"]) == 0
    assert capsys.readouterr().out == "fqpack version 0.1.0\n"
    assert port_cli.main(["-h"]) == 0
    assert "--backend" in capsys.readouterr().err


@pytest.mark.timeout(600)
def test_cli_mesh_matches_jax_cli(tmp_path):
    """``--mesh`` on one device: the JAX CLI on its one CPU device (its own
    process, without the virtual devices of the tests) and the port's CLI
    with ``--backend cpu`` write the same bytes; each reads the other's."""
    from fastqpacker_tpu_torch.utils.synth import synth_fastq

    one = len(synth_fastq(0, read_len=100))
    data = synth_fastq(3000 * one / (1 << 20), read_len=100, seed=21,
                       qual_model="phredwalk", seq_model="markov")
    src = tmp_path / "in.fq"
    src.write_bytes(data)
    port_fqz, jax_fqz = tmp_path / "p.fqz", tmp_path / "j.fqz"
    j = subprocess.run(
        [sys.executable, "-m", "fastqpacker_tpu.cli.fqpack", "--mesh", "-b", "1800",
         "-i", str(src), "-o", str(jax_fqz)],
        capture_output=True, env={**ENV, "XLA_FLAGS": ""}, cwd=REPO, timeout=550,
    )
    assert j.returncode == 0, j.stderr
    assert port_cli.main(["--backend", "cpu", "--mesh", "-b", "1800", "-i", str(src),
                          "-o", str(port_fqz)]) == 0
    comp = port_fqz.read_bytes()
    assert comp == jax_fqz.read_bytes()
    assert comp[4] == 3  # --mesh implies the v3 container
    tags = set()
    r = io.BytesIO(comp)
    C.read_file_header(r)
    while (hdr := C.read_block_header(r, 3)) is not None:
        sizes = hdr.stream_sizes(2)
        payload = r.read(sum(sizes))
        tags.add(payload[sizes[0]])
    assert tags == {C.TAG_WCTX}
    for flags in (["-d", "--mesh"], ["-d"]):
        back = tmp_path / f"back{len(flags)}.fq"
        assert port_cli.main(["--backend", "cpu", "-w", "1", *flags, "-i", str(jax_fqz),
                              "-o", str(back)]) == 0
        assert back.read_bytes() == data
    back = tmp_path / "jback.fq"
    assert jax_cli.main(["--backend", "cpu", "-d", "-i", str(port_fqz), "-o", str(back)]) == 0
    assert back.read_bytes() == data


@pytest.mark.parametrize(
    "flags", [["--mesh", "--max-ratio"], ["--mesh", "--lossless"],
              ["--mesh", "--pair", "r2.fq"], ["-d", "--mesh", "--max-ratio"]],
)
def test_cli_mesh_refusals_match_jax_cli(flags, tmp_path, capsys):
    src = tmp_path / "in.fq"
    src.write_bytes(_fastq(5, seed=3))
    argv = ["--backend", "cpu", *flags, "-i", str(src), "-o", str(tmp_path / "o.fqz")]
    assert jax_cli.main(argv) == 1
    want = capsys.readouterr().err
    assert port_cli.main(argv) == 1
    assert capsys.readouterr().err == want
    assert want.startswith("error: --mesh does not support ")


def test_cli_mesh_on_cuda_without_a_card_fails(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.fq"
    src.write_bytes(_fastq(5, seed=4))
    for flags in (["--mesh"], ["-d", "--mesh"]):
        assert port_cli.main([*flags, "-i", str(src), "-o", str(tmp_path / "o")]) == 1
        assert "no CUDA device" in capsys.readouterr().err
