"""Port vs JAX package: ``parallel/multihost.py`` with simulated hosts.

Every simulated host's part runs in one process in both packages (the
port's on the CPU, ``device="cpu"``): the record-aligned ranges, the
sections and the file must be byte for byte the JAX package's for 1, 2, 4
and 7 hosts, v2 and v3, and the decompress must give the input back.
"""

import numpy as np
import pytest

import fastqpacker_tpu as jfq
import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu.parallel import multihost as jmh
from fastqpacker_tpu_torch.format import container as C
from fastqpacker_tpu_torch.parallel import multihost as pmh
from fastqpacker_tpu_torch.utils.synth import synth_fastq
from torch_wctx_inputs import one_torch_thread  # noqa: F401  (fixture)
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _host_rans_backend(monkeypatch):
    """Which JAX rANS decode runs on the CPU is process state; pin it."""
    monkeypatch.setenv("FQZ_RANS_BACKEND", "host")


def _fastq(n, seed=0, tricky_quals=False):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        ln = int(rng.integers(5, 180))
        s = "".join("ACGTN"[b] for b in rng.integers(0, 5, ln))
        if tricky_quals:
            # qualities full of '@' and '+' to stress record alignment
            q = "".join("@+"[int(b)] for b in rng.integers(0, 2, ln))
        else:
            q = "".join(chr(33 + int(b)) for b in rng.integers(0, 42, ln))
        recs.append(f"@mh_{i} r={i}\n{s}\n+\n{q}\n")
    return "".join(recs).encode()


@pytest.mark.parametrize("tricky", [False, True])
@pytest.mark.parametrize("hosts", [1, 2, 4, 7])
def test_host_ranges_equal_jax(tmp_path, hosts, tricky):
    data = _fastq(300, seed=1, tricky_quals=tricky)
    p = tmp_path / "in.fq"
    p.write_bytes(data)
    ranges = pmh.host_ranges(str(p), hosts)
    assert ranges == jmh.host_ranges(str(p), hosts)
    assert ranges[0][0] == 0 and ranges[-1][1] == len(data)
    for (_, e1), (s2, _) in zip(ranges, ranges[1:]):
        assert e1 == s2
    for s, _ in ranges:
        if s < len(data):
            lines = data[s : s + 4096].split(b"\n")
            assert lines[0][:1] == b"@" and lines[2][:1] == b"+"
            assert len(lines[1]) == len(lines[3])


def _both(fn_name, *args, **kw):
    """The file each package's ``fn_name`` writes (the port's on the CPU)."""
    out = {}
    for mod, extra in ((jmh, {}), (pmh, {"device": CPU})):
        dst = args[1] + (".port" if mod is pmh else ".jax")
        getattr(mod, fn_name)(args[0], dst, *args[2:], **kw, **extra)
        with open(dst, "rb") as f:
            out[mod] = f.read()
    return out[pmh], out[jmh]


@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("hosts", [1, 2, 4, 7])
def test_simulated_compress_and_decompress_equal_jax(tmp_path, hosts, version):
    data = _fastq(500 if version == 2 else 400, seed=2 + hosts)
    fin = tmp_path / "in.fq"
    fin.write_bytes(data)
    opts = dict(block_size=64, version=version)
    got, want = _both("simulate_multihost", str(fin), str(tmp_path / "out.fqz"), hosts,
                      tfq.Options(**opts))
    assert got == want
    assert jfq.decompress_bytes(got) == data
    assert tfq.decompress_bytes(got, device=CPU) == data
    fz = tmp_path / "c.fqz"
    fz.write_bytes(got)
    back, jback = _both("simulate_multihost_decompress", str(fz), str(tmp_path / "back.fq"),
                        hosts)
    assert back == jback == data


def test_single_host_equals_the_single_process_container(tmp_path):
    data = _fastq(200, seed=3)
    fin = tmp_path / "in.fq"
    fin.write_bytes(data)
    fout = tmp_path / "out1.fqz"
    pmh.simulate_multihost(str(fin), str(fout), 1, tfq.Options(block_size=50), device=CPU)
    assert fout.read_bytes() == tfq.compress_bytes(data, tfq.Options(block_size=50, workers=1),
                                                   device=CPU)


@pytest.mark.parametrize("version", [2, 3])
def test_phred64_flag_via_broadcast(tmp_path, version):
    q64 = "".join(chr(64 + i % 40) for i in range(60))
    data = "".join(f"@p{i}\n{'ACGT' * 15}\n+\n{q64}\n" for i in range(50)).encode()
    fin = tmp_path / "in.fq"
    fin.write_bytes(data)
    got, want = _both("simulate_multihost", str(fin), str(tmp_path / "out.fqz"), 2,
                      tfq.Options(block_size=10, version=version))
    assert got == want
    assert C.parse_file_header(got[:10]).phred64
    assert tfq.decompress_bytes(got, device=CPU) == data


def test_align_rejects_quality_at_lines(tmp_path):
    """A '@' quality line must not be mistaken for a record start."""
    data = (
        b"@r1\nACGTA\n+\n@@@@@\n"
        b"@r2\nGGGTT\n+\nIIIII\n"
        b"@r3\nCCCAA\n+\nJJJJJ\n"
    )
    p = tmp_path / "t.fq"
    p.write_bytes(data)
    with open(p, "rb") as f:
        pos = pmh.align_to_record(f, 5, len(data))
        assert pos == jmh.align_to_record(f, 5, len(data))
    assert data[pos:].startswith(b"@r2\n")
    for at in range(len(data)):
        assert pmh._is_record_start(data, at) == jmh._is_record_start(data, at)


@pytest.mark.parametrize("hosts", [1, 3, 5])
def test_decompress_of_a_single_process_container(tmp_path, hosts):
    data = _fastq(400, seed=9)
    fz = tmp_path / "c.fqz"
    fz.write_bytes(tfq.compress_bytes(data, tfq.Options(block_size=37), device=CPU))
    back, jback = _both("simulate_multihost_decompress", str(fz), str(tmp_path / "out.fq"), hosts)
    assert back == jback == data


def test_index_blocks_and_stripes_equal_jax(tmp_path):
    data = _fastq(100, seed=11)
    comp = tfq.compress_bytes(data, tfq.Options(block_size=30), device=CPU)
    fz = tmp_path / "c.fqz"
    fz.write_bytes(comp)
    fh, blocks = pmh.index_blocks(str(fz))
    jfh, jblocks = jmh.index_blocks(str(fz))
    assert blocks == jblocks and (fh.version, fh.flags) == (jfh.version, jfh.flags)
    assert len(blocks) == 4 and blocks[0][0] == 10
    assert sum(b[1] for b in blocks) == len(comp) - 10
    for hosts in (1, 2, 3, 4, 7):
        for h in range(hosts):
            assert pmh._stripe(blocks, hosts, h) == jmh._stripe(blocks, hosts, h)


def test_dictionary_container_decompress(tmp_path):
    """The sequence-dictionary section is skipped by the indexer and read
    once by each host (``decompress_native(skip_sections=True)``)."""
    from test_torch_inspect import _coverage

    data = _coverage()
    comp = tfq.compress_bytes(data, tfq.Options(version=3, block_size=650, workers=1),
                              device=CPU)
    assert C.parse_file_header(comp[:10]).flags & C.FLAG_SEQ_DICT
    src = tmp_path / "in.fqz"
    src.write_bytes(comp)
    _, blocks = pmh.index_blocks(str(src))
    assert len(blocks) == 2 and all(size < len(comp) for _, size in blocks)
    back, jback = _both("simulate_multihost_decompress", str(src), str(tmp_path / "out.fq"), 3)
    assert back == jback == data


def test_detection_block_only_in_host0_range(tmp_path):
    """The file-wide Phred flag comes from the FILE's fixed detection
    window (the first min(100k, file) records), never from a host's range:
    a file whose window says +64 but whose tail holds sub-59 bytes encodes
    every host against +64, in both packages."""
    n = 110_000
    seq = "ACGTACGTAA"
    hi, lo = chr(70) * len(seq), chr(40) * len(seq)
    recs = [f"@r{i}\n{seq}\n+\n{hi}\n" for i in range(100_000)]
    recs += [f"@r{i}\n{seq}\n+\n{lo}\n" for i in range(100_000, n)]
    data = "".join(recs).encode()
    src = tmp_path / "in.fq"
    src.write_bytes(data)
    opts = tfq.Options(block_size=20_000)
    assert pmh._detect_file_qual_offset(str(src), opts) == 64
    got, want = _both("simulate_multihost", str(src), str(tmp_path / "multi.fqz"), 4, opts)
    assert got == want and C.parse_file_header(got[:10]).phred64
    fz = tmp_path / "m.fqz"
    fz.write_bytes(got)
    back, _ = _both("simulate_multihost_decompress", str(fz), str(tmp_path / "rt.fq"), 3)
    assert back == data


def test_corrupt_section_keeps_the_per_block_string(tmp_path):
    """A stripe starts mid-file, so a fault is named by the per-block
    decoders, in both packages."""
    one = len(synth_fastq(0, read_len=151))
    data = synth_fastq(900 * one / (1 << 20), read_len=151, seed=3, qual_model="walk")
    comp = bytearray(tfq.compress_bytes(data, tfq.Options(version=3, block_size=300, workers=1),
                                        device=CPU))
    fz = tmp_path / "c.fqz"
    fz.write_bytes(bytes(comp))
    _, blocks = pmh.index_blocks(str(fz))
    off, size = blocks[1]
    comp[off + size // 2] ^= 0x04
    fz.write_bytes(bytes(comp))
    outcomes = []
    for mod, kw in ((pmh, {"device": CPU}), (jmh, {})):
        try:
            mod.simulate_multihost_decompress(str(fz), str(tmp_path / "o.fq"), 2, **kw)
            outcomes.append(("ok", ""))
        except Exception as e:
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1] and outcomes[0][0] != "ok"


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fin = tmp_path / "in.fq"
    fin.write_bytes(_fastq(20))
    for call in (lambda: pmh.simulate_multihost(str(fin), str(tmp_path / "o"), 2),
                 lambda: pmh.init_distributed(),
                 lambda: pmh.process_device()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert pmh.init_distributed(device=CPU) == (0, 1)
    assert pmh.process_device("cpu").type == "cpu"
