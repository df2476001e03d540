"""The port's ``fqpack info`` / ``fqpack check`` (``cli/inspect.py``)
against the JAX package's, on the same files.

``info`` must print the same text byte for byte (tag names included) on
every golden container and on containers of every other kind the port
writes (v1, a sequence dictionary, lossless, paired-end, ``--mesh``).
``check`` must print the same line and return the same code on good
containers and on the corrupt cases whose ``-d`` errors
``tests/test_torch_cli.py`` holds against the JAX CLI; the port's runs on
the CPU (``device="cpu"``).
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu.cli import inspect as jax_inspect
from fastqpacker_tpu_torch.cli import inspect as port_inspect
from fastqpacker_tpu_torch.parallel import mesh as pmesh
from fastqpacker_tpu_torch.pipeline import api as port_api
from fastqpacker_tpu_torch.pipeline import meshpipe as pmeshpipe
from fastqpacker_tpu_torch.utils.synth import synth_fastq
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "testdata" / "golden"
ENV = {**os.environ, "FQZ_FORCE_CPU": "1", "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
C = tfq.container

# For a corrupt TAG_WCTX stream the JAX package has strings of its own
# (ROADMAP.md Queue C, "known, not a port fault"): its numpy / C++ coders
# say "truncated wctx words" where its XLA decoder and the port say
# "trailing wctx words". That pair is named here and not held equal: JAX
# string -> the port's, a prefix or "wctx" anywhere in it. (The whole-file
# decoder's "corrupted wctx stream" is held equal: the port's default
# decoder says it too.)
KNOWN_WCTX = {"truncated wctx words": "trailing wctx words"}


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


def _fastq(n, seed, alphabet="ACGTN", qbase=33):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        ln = int(rng.integers(1, 200))
        s = "".join(alphabet[b] for b in rng.integers(0, len(alphabet), ln))
        q = "".join(chr(qbase + int(b)) for b in rng.integers(0, 41, ln))
        recs.append(f"@cli_{i}\n{s}\n+\n{q}\n")
    return "".join(recs).encode()


def _ctx_fastq(nrec=700, length=151):
    """Correlated DNA, sticky binned qualities, structured headers (the
    recipe of ``golden_ctx_v3.fqz``, small): TAG_SCTX / TAG_QCTX / TAG_TOK."""
    rng = np.random.default_rng(20260818)
    sym = np.frombuffer(b"ACGTN", np.uint8)
    cur = rng.integers(0, 4, nrec)
    m = np.empty((nrec, length), np.uint8)
    for p in range(length):
        stay = rng.random(nrec) < 0.62
        cur = np.where(stay, cur, rng.integers(0, 4, nrec))
        m[:, p] = cur
    levels = np.array([2, 12, 23, 37], np.uint8)
    steps = np.cumsum(rng.integers(-1, 2, (nrec, length)), axis=1)
    q = levels[np.clip((steps // 6) % 4, 0, 3)] + 33
    return b"".join(b"@GCTX.%d 1:N:0:ACGT\n" % i + sym[m[i]].tobytes() + b"\n+\n"
                    + q[i].tobytes() + b"\n" for i in range(nrec))


def _coverage(n=1300, length=151):
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 3000)
    sym = np.frombuffer(b"ACGT", np.uint8)
    return b"".join(
        b"@cov.%d\n" % i + sym[genome[s : s + length]].tobytes() + b"\n+\n"
        + rng.integers(33, 74, length).astype(np.uint8).tobytes() + b"\n"
        for i, s in enumerate(rng.integers(0, len(genome) - length, n)))


def _markov(n, read_len=100):
    one = len(synth_fastq(0, read_len=read_len))
    return synth_fastq((n * one + one // 2) / (1 << 20), read_len=read_len, seed=7,
                       qual_model="phredwalk", seq_model="markov")


def _paired(version):
    r1, r2 = _fastq(150, 11), _fastq(150, 12)
    out = io.BytesIO()
    port_api.compress_paired(io.BytesIO(r1), io.BytesIO(r2), out,
                             tfq.Options(block_size=100, version=version), device="cpu")
    return out.getvalue()


def _v3(data, **opts):
    return tfq.compress_bytes(data, tfq.Options(version=3, workers=1, **opts), device="cpu")


MADE = {
    "v1": lambda: tfq.compress_bytes(_fastq(300, 1), tfq.Options(block_size=100, version=1),
                                     device="cpu"),
    "ctx_v3": lambda: _v3(_ctx_fastq()),
    "seq_dict": lambda: _v3(_coverage(), block_size=650),
    "lossless": lambda: _v3(_fastq(300, 3, alphabet="ACGTNacgtRY."), block_size=100,
                            lossless=True),
    "phred64_v3": lambda: _v3(_fastq(200, 4, qbase=64)),
    "paired_v2": lambda: _paired(2),
    "paired_v3": lambda: _paired(3),
    "mesh": lambda: pmeshpipe.compress_mesh_bytes(
        _markov(3600), tfq.Options(block_size=1800), pmesh.make_mesh(1, device="cpu")),
}


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    root = tmp_path_factory.mktemp("inspect")
    out = {}
    for name, make in MADE.items():
        out[name] = root / f"{name}.fqz"
        out[name].write_bytes(make())
    return out


def _info(mod, path):
    out = io.StringIO()
    assert mod.info(str(path), out=out) == 0
    return out.getvalue()


def _check(mod, path, **kw):
    out = io.StringIO()
    try:
        return mod.check(str(path), out=out, **kw), out.getvalue()
    except Exception as e:  # an escape must be the same in both
        return type(e).__name__, str(e)


GOLDEN_FILES = sorted(p.name for p in GOLDEN.glob("*.fqz"))


@pytest.mark.parametrize("name", GOLDEN_FILES + list(MADE))
def test_info_matches_jax(name, made):
    path = GOLDEN / name if name in GOLDEN_FILES else made[name]
    got = _info(port_inspect, path)
    assert got == _info(jax_inspect, path)
    if name in ("golden_ctx_v3.fqz", "ctx_v3"):
        assert "[sctx]" in got and "[qctx]" in got and "[tok+zstd]" in got
    if name == "mesh":
        assert got.count("[wctx x2]") == 2
    if name.startswith("paired"):
        assert "paired-end" in got


@pytest.mark.parametrize("name", ["golden_v2.fqz", "golden_p64_v2.fqz", "golden_v3.fqz"]
                         + list(MADE))
def test_check_matches_jax(name, made):
    path = GOLDEN / name if name in GOLDEN_FILES else made[name]
    got = _check(port_inspect, path, device="cpu")
    assert got == _check(jax_inspect, path)
    assert got[0] == 0 and got[1].startswith("OK: decoded ")


def _same_or_known(got, want):
    """``got`` equals ``want``, or the two differ only by a pair of
    :data:`KNOWN_WCTX`."""
    if got == want:
        return True
    for jax_text, port_text in KNOWN_WCTX.items():
        if want == (1, f"check FAILED: {jax_text}\n"):
            return got[0] == 1 and got[1].startswith("check FAILED: ") and port_text in got[1]
    return False


@pytest.mark.parametrize("kind", ["v2", "native", "mesh"])
def test_check_flipped_byte_matches_jax(kind, tmp_path):
    """A byte flipped mid-file, as ``test_flipped_byte_errors_match_jax_cli``
    holds for ``-d``: the same failure line."""
    data = _fastq(900, seed=5)
    opts = tfq.Options(block_size=250, version=2 if kind == "v2" else 3)
    if kind == "mesh":
        comp = pmeshpipe.compress_mesh_bytes(data, opts, pmesh.make_mesh(1, device="cpu"))
    else:
        comp = tfq.compress_bytes(data, opts, device="cpu")
    bad = bytearray(comp)
    bad[len(bad) // 2] ^= 0xFF
    path = tmp_path / "c.fqz"
    path.write_bytes(bytes(bad))
    got = _check(port_inspect, path, device="cpu")
    assert got == _check(jax_inspect, path)
    assert got[0] == 1 and got[1].startswith("check FAILED: ")


@pytest.mark.parametrize(
    "fmt,seed", [(f, s) for f in ("v2", "v3", "v3_lossless") for s in range(4)] + [("mesh", 0)])
def test_check_mutated_container_matches_jax(fmt, seed, tmp_path):
    """Bit flips, truncations and random bytes, as
    ``test_mutated_container_errors_match_jax`` holds for ``decompress_bytes``
    (v2, v3, lossless v3), and a ``--mesh`` container: ``check`` prints
    the same line and returns the same code in both packages."""
    if fmt == "mesh":
        data = _markov(1600)
        comp = pmeshpipe.compress_mesh_bytes(data, tfq.Options(block_size=800),
                                             pmesh.make_mesh(1, device="cpu"))
    else:
        data = _fastq(400, 10 + seed)
        opts = tfq.Options(block_size=100, version=2 if fmt == "v2" else 3,
                           lossless=fmt == "v3_lossless")
        comp = tfq.compress_bytes(data, opts, device="cpu")
    rng = np.random.default_rng(100 * len(fmt) + seed)
    path = tmp_path / "m.fqz"
    failures = 0
    for k in range(12 if fmt != "mesh" else 6):
        b = bytearray(comp)
        at = int(rng.integers(0, len(b)))
        if k % 3 == 0:
            b[at] ^= 1 << int(rng.integers(0, 8))
        elif k % 3 == 1:
            del b[at:]
        else:
            b[at] = int(rng.integers(0, 256))
        path.write_bytes(bytes(b))
        want = _check(jax_inspect, path)
        got = _check(port_inspect, path, device="cpu")
        assert _same_or_known(got, want), (k, got, want)
        failures += want[0] == 1
    assert failures > 0


def _cli(module, argv):
    p = subprocess.run([sys.executable, "-m", module, "--backend", "cpu", *argv],
                       capture_output=True, env=ENV, cwd=REPO, timeout=110)
    return p.returncode, p.stdout, p.stderr


@pytest.mark.timeout(300)
def test_cli_info_and_check_match_jax_cli(made, tmp_path):
    """``info`` and ``check`` in both CLIs, each in its own process: stdout,
    stderr and the exit code, on good files, a corrupt one and a missing
    one."""
    bad = tmp_path / "bad.fqz"
    comp = bytearray(made["paired_v2"].read_bytes())
    comp[len(comp) // 2] ^= 0xFF
    bad.write_bytes(bytes(comp))
    for argv, rc in ((["info", str(made["paired_v3"])], 0),
                     (["check", str(made["seq_dict"])], 0),
                     (["check", str(bad)], 1),
                     (["info", str(tmp_path / "missing.fqz")], 1)):
        got = _cli("fastqpacker_tpu_torch.cli.fqpack", argv)
        assert got == _cli("fastqpacker_tpu.cli.fqpack", argv), argv
        assert got[0] == rc


@pytest.mark.timeout(120)
def test_cli_info_into_a_closed_pipe_exits_141(made):
    """``fqpack info x.fqz | head`` with the reader gone: both CLIs exit 141
    and print no traceback."""
    for module in ("fastqpacker_tpu_torch.cli.fqpack", "fastqpacker_tpu.cli.fqpack"):
        p = subprocess.Popen([sys.executable, "-m", module, "info", str(made["mesh"])],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=ENV, cwd=REPO)
        p.stdout.close()
        err = p.stderr.read()
        assert (p.wait(timeout=100), err) == (141, b""), module
