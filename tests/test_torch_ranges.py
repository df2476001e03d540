"""The port's random-access decode (``pipeline/ranges.py``, ``fqpack cat``)
against the JAX package's, on the same files.

Containers are written once per module by the port on the CPU: FQZ v2, v3,
a v3 container with a sequence dictionary (``FLAG_SEQ_DICT``) and a
``--mesh`` container (``TAG_WCTX`` streams). Every range is read by both
packages' ``read_record_range`` and held against the slice of the input
text; comparisons are exact.
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
from fastqpacker_tpu.cli import fqpack as jax_cli
from fastqpacker_tpu.pipeline import ranges as jax_ranges
from fastqpacker_tpu_torch.cli import fqpack as port_cli
from fastqpacker_tpu_torch.parallel import mesh as pmesh
from fastqpacker_tpu_torch.pipeline import meshpipe as pmeshpipe
from fastqpacker_tpu_torch.pipeline import ranges as port_ranges
from fastqpacker_tpu_torch.utils.synth import synth_fastq
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


def _fastq(n, seed):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        ln = int(rng.integers(1, 160))
        s = "".join("ACGTN"[b] for b in rng.integers(0, 5, ln))
        q = "".join(chr(33 + int(b)) for b in rng.integers(0, 41, ln))
        recs.append(f"@rng_{i} lane{i % 4}\n{s}\n+\n{q}\n")
    return "".join(recs).encode()


def _coverage(n=1300, length=151):
    """Reads sampled from a 3 kb genome: block 0's coverage probe fires, so
    the v3 container carries FLAG_SEQ_DICT and TAG_SLDM streams."""
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 3000)
    sym = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(n):
        s = int(rng.integers(0, len(genome) - length))
        q = rng.integers(33, 74, length).astype(np.uint8)
        recs.append(b"@cov.%d\n" % i + sym[genome[s : s + length]].tobytes()
                    + b"\n+\n" + q.tobytes() + b"\n")
    return b"".join(recs)


def _markov(n, read_len=100):
    one = len(synth_fastq(0, read_len=read_len))
    data = synth_fastq((n * one + one // 2) / (1 << 20), read_len=read_len, seed=7,
                       qual_model="phredwalk", seq_model="markov")
    assert data.count(b"\n") == 4 * n
    return data


# kind -> (input, block size, container writer)
KINDS = {
    "v2": (lambda: _fastq(1037, 1), 100,
           lambda d: tfq.compress_bytes(d, tfq.Options(block_size=100), device="cpu")),
    "v3": (lambda: _fastq(1037, 1), 100,
           lambda d: tfq.compress_bytes(d, tfq.Options(block_size=100, version=3, workers=1),
                                        device="cpu")),
    "seq_dict": (_coverage, 650,
                 lambda d: tfq.compress_bytes(d, tfq.Options(block_size=650, version=3,
                                                             workers=1), device="cpu")),
    "mesh": (lambda: _markov(3600), 1800,
             lambda d: pmeshpipe.compress_mesh_bytes(d, tfq.Options(block_size=1800),
                                                     pmesh.make_mesh(1, device="cpu"))),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """kind -> (path, input text, block size, records)."""
    root = tmp_path_factory.mktemp("ranges")
    out = {}
    for kind, (make, block, write) in KINDS.items():
        data = make()
        path = root / f"{kind}.fqz"
        path.write_bytes(write(data))
        out[kind] = (str(path), data, block, data.count(b"\n") // 4)
    return out


def records_slice(text: bytes, start: int, stop: int) -> bytes:
    nl = np.flatnonzero(np.frombuffer(text, np.uint8) == 0x0A)
    n = len(nl) // 4
    start, stop = min(start, n), min(stop, n)
    a = 0 if start == 0 else int(nl[4 * start - 1]) + 1
    b = 0 if stop == 0 else int(nl[4 * stop - 1]) + 1
    return text[a:b] if stop > start else b""


def test_container_kinds(files):
    """Each container is the kind it stands for."""
    for kind, (path, _, _, _) in files.items():
        comp = Path(path).read_bytes()
        fh = C.read_file_header(io.BytesIO(comp))
        assert fh.version == (2 if kind == "v2" else 3)
        assert bool(fh.flags & C.FLAG_SEQ_DICT) == (kind == "seq_dict")
    r = io.BytesIO(Path(files["mesh"][0]).read_bytes())
    C.read_file_header(r)
    hdr = C.read_block_header(r, 3)
    payload = r.read(hdr.seq_data_size + 1)
    assert payload[0] == payload[hdr.seq_data_size] == C.TAG_WCTX


@pytest.mark.parametrize("kind", list(KINDS))
def test_index_matches_jax(kind, files):
    path, _, block, n = files[kind]
    got = port_ranges.index_path(path)
    want = jax_ranges.index_path(path)
    assert got.total_records == want.total_records == n
    assert [vars(e) for e in got.entries] == [vars(e) for e in want.entries]
    assert [e.num_records for e in got.entries][:-1] == [block] * (len(got.entries) - 1)
    assert (got.seq_dict is None) == (want.seq_dict is None) == (kind != "seq_dict")
    if got.seq_dict is not None:
        assert np.array_equal(got.seq_dict, want.seq_dict)


def _ranges(kind, block, n):
    """(start, stop) cases: across a block boundary, the last record, an
    open stop; except on the mesh container (whose blocks decode slowly on
    the CPU), also inside one block, an empty range, a stop clamped past
    the end, and (v2/v3) several blocks."""
    cases = [(block - 5, block + 5), (n - 1, n), (n - 7, None)]
    if kind != "mesh":
        cases += [(block + 3, block + 9), (block + 3, block + 3), (n - 7, n + 1000)]
    if kind in ("v2", "v3"):
        cases += [(0, 5), (333, 777), (0, n)]
    return cases


@pytest.mark.parametrize("kind", list(KINDS))
def test_record_ranges_match_jax(kind, files):
    path, data, block, n = files[kind]
    idx = port_ranges.index_path(path)
    for start, stop in _ranges(kind, block, n):
        got = port_ranges.read_record_range(path, start, stop, index=idx, device="cpu")
        assert got == jax_ranges.read_record_range(path, start, stop)
        assert got == records_slice(data, start, n if stop is None else stop)


@pytest.mark.parametrize("start,stop", [(-1, 5), (10, 5)])
def test_range_errors_match_jax(start, stop, files):
    path = files["v2"][0]
    with pytest.raises(ValueError) as want:
        jax_ranges.read_record_range(path, start, stop)
    with pytest.raises(ValueError) as got:
        port_ranges.read_record_range(path, start, stop, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["", "95:105", "7", ":5", "5:", "7:7", "9:3", "-1:3",
                                  "x", "1:y", "3::4"])
def test_parse_record_range_matches_jax(spec):
    def outcome(parse):
        try:
            return parse(spec)
        except RuntimeError as e:
            return str(e)

    assert outcome(port_cli._parse_record_range) == outcome(jax_cli._parse_record_range)


def test_covering_blocks_only(files, monkeypatch):
    """A range decodes only the blocks that cover it."""
    path, _, block, _ = files["v2"]
    seen = []
    decode = port_ranges._decode_entry
    monkeypatch.setattr(port_ranges, "_decode_entry",
                        lambda f, fh, e, *a: seen.append(e.record_start) or decode(f, fh, e, *a))
    port_ranges.read_record_range(path, block - 1, block + 1, device="cpu")
    assert seen == [0, block]
    seen.clear()
    port_ranges.read_record_range(path, 5 * block + 2, 5 * block + 3, device="cpu")
    assert seen == [5 * block]


def _cli(module, argv):
    p = subprocess.run([sys.executable, "-m", module, "--backend", "cpu", *argv],
                       capture_output=True, env=ENV, cwd=REPO, timeout=110)
    return p.returncode, p.stdout, p.stderr.decode()


@pytest.mark.timeout(300)
def test_cli_cat_matches_jax_cli(files):
    """``cat FILE -r 95:105``, ``-r 7`` (a bare N), ``-r 9:3`` (refused),
    and ``cat -r A:B FILE`` (argparse refuses the order): stdout, stderr and
    the exit code of both CLIs, each in its own process. Of argparse's
    message the error line is compared: its usage lines list each CLI's own
    ``--backend`` choices."""
    path, data, _, _ = files["v2"]
    for argv in (["cat", path, "-r", "95:105"], ["cat", path, "-r", "7"],
                 ["cat", path, "-r", "9:3"], ["cat", "-r", "95:105", path]):
        got = _cli("fastqpacker_tpu_torch.cli.fqpack", argv)
        want = _cli("fastqpacker_tpu.cli.fqpack", argv)
        if argv[-1] == path:
            got, want = (x[:2] + (x[2].splitlines()[-1],) for x in (got, want))
        assert got == want, argv
        if argv[-1] == "95:105":
            assert got[0] == 0 and got[1] == records_slice(data, 95, 105)
        if argv[-1] == "7":
            assert got[0] == 0 and got[1] == records_slice(data, 7, 8)
        if argv[-1] == "9:3":
            assert got[0] == 1 and "invalid record range" in got[2]
        if argv[-1] == path:
            assert got == (2, b"", f"fqpack: error: unrecognized arguments: {path}")
