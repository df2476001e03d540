"""The port's benchmark (``fastqpacker_tpu_torch/bench.py``) against the
repo's JAX ``bench.py``, on the CPU at small sizes.

The fixtures are byte-equal to ``bench.synth_fastq``; the estimator gives
the same best and windows under a fake clock; every metric prints the JAX
bench's JSON line (name, unit, rounding, ``vs_baseline``) for the same
measured value; the wall-clock and ratio metrics give the JAX package's
containers; the kernel metrics run at tiny shapes on the plain versions;
without a card and without ``--cpu`` nothing is printed. Comparisons are
exact.
"""

import argparse
import io
import itertools
import json
import os
import time

import numpy as np
import pytest

import bench as jbench
from fastqpacker_tpu import Options as JOptions
from fastqpacker_tpu import compress_bytes as jcompress_bytes
from fastqpacker_tpu import models as jmodels
from fastqpacker_tpu.pipeline import api as japi
from fastqpacker_tpu.utils import profiling as jprofiling
from fastqpacker_tpu_torch import bench as pbench
from fastqpacker_tpu_torch.cli import fqpack as port_cli
from fastqpacker_tpu_torch.ops import wctx as pwctx
from fastqpacker_tpu_torch.utils import profiling as pprofiling
from torch_wctx_inputs import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)


def _runtime_built() -> bool:
    from fastqpacker_tpu.runtime import bindings

    return bindings.available()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [{}, {"genomic": True}, {"markov": True}, {"markov": True, "seed": 43},
     {"read_len": 100, "seed": 7}],
    ids=["iid", "genomic", "markov", "markov_seed43", "iid_100bp"],
)
def test_synth_fastq_equals_the_jax_bench(kw):
    if kw.get("markov") and not _runtime_built():
        pytest.skip("the JAX bench's markov corpus is the C++ runtime's "
                    "(fastqpacker_tpu/runtime), which is not built here")
    assert pbench.synth_fastq(1, **kw) == jbench.synth_fastq(1, **kw)


@pytest.mark.parametrize("n", [1, 2, 3, 15, 16, 17, 1000, 65_537, 1_000_003])
def test_markov_genome_equals_the_runtime_chain(n):
    if not _runtime_built():
        pytest.skip("fastqpacker_tpu/runtime (fq_markov_gen) is not built here")
    from fastqpacker_tpu.runtime import bindings

    prob16 = np.round(pbench._MARKOV_PROBS * 65536).astype(np.uint16)
    for seed in (0, 42, 2**64 - 1):
        got = pbench.markov_genome(n, prob16, seed)
        assert got.dtype == np.uint8 and got.shape == (n,)
        assert np.array_equal(got, bindings.markov_gen(n, prob16, seed))


def test_markov_genome_follows_its_definition():
    """The chain against a plain loop over SplitMix64 (the runtime's C
    code, transcribed), with no runtime needed."""
    prob16 = np.array([[1000, 20000, 30000, 14536]] * 4, np.uint16)
    prob16[2] = [30000, 1, 1, 35534]
    cum = np.cumsum(prob16.astype(np.int64), axis=1)
    cum[:, 3] = 65536
    mask = (1 << 64) - 1
    s, prev, want = 9, 0, []
    for _ in range(3001):
        s = (s + 0x9E3779B97F4A7C15) & mask
        z = s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        u = (z ^ (z >> 31)) & 0xFFFF
        prev = int(u >= cum[prev, 0]) + int(u >= cum[prev, 1]) + int(u >= cum[prev, 2])
        want.append(prev)
    assert pbench.markov_genome(3001, prob16, 9).tolist() == want


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [{}, {"repeats": 40, "window_s": 1.0, "min_s": 3.0, "cap_s": 9.0},
     {"window_s": 0.5, "min_s": 0.0, "cap_s": 2.0, "min_windows": 2},
     {"agree": 0.0, "cap_s": 30.0, "min_s": 5.0}],
    ids=["defaults", "short", "shortest", "never_agree"],
)
def test_phase_robust_best_equals_jax_under_a_fake_clock(kw, monkeypatch, capsys):
    timings = np.random.default_rng(5).uniform(0.05, 0.9, 97).round(4).tolist()

    def run(mod):
        clock = [0.0]
        it = itertools.cycle(timings)
        monkeypatch.setattr(time, "perf_counter", lambda: clock[0])

        def once() -> float:
            t = next(it)
            clock[0] += t
            return t

        best = mod.phase_robust_best(once, **kw)
        return best, clock[0], capsys.readouterr().err

    got, want = run(pbench), run(jbench)
    assert got == want
    assert "windows" in got[2]


# ---------------------------------------------------------------------------
# the JSON line of every metric
# ---------------------------------------------------------------------------

VALUE = 1234.56789


def _fixed(*_a, **_k):
    return VALUE


@pytest.mark.parametrize("metric", pbench.METRICS)
def test_json_line_equals_the_jax_bench(metric, monkeypatch, capsys):
    """Every metric's JSON line (name, unit, rounding, vs_baseline) is the
    JAX bench's for the same measured value; the ratio metric measures for
    real on the CPU, on the same data."""
    for mod in (jbench, pbench):
        for fn in ("bench_kernel", "bench_decode_kernel", "bench_mesh_entropy",
                   "bench_mesh_entropy_decode", "bench_wctx_entropy"):
            monkeypatch.setattr(mod, fn, _fixed)
        monkeypatch.setattr(mod, "bench_micro", lambda data, *device: {"parse": VALUE})
        monkeypatch.setattr(mod, "bench_mesh_e2e", lambda *a, **k: (VALUE, 4.2))
        monkeypatch.setattr(mod, "bench_compress", lambda *a, **k: (VALUE, 4.2, 0.5))
        monkeypatch.setattr(mod, "bench_decompress", lambda *a, **k: (VALUE, 0.5))
    data = jbench.synth_fastq(1) if metric == "ratio" else b""
    args = argparse.Namespace(metric=metric, mb=1, repeats=1)
    lines = {}
    for mod, device in ((jbench, False), (pbench, pbench.torch.device("cpu"))):
        assert mod._run_metric(args, data, device) == 0
        out = capsys.readouterr().out.splitlines()
        assert len(out) == 1
        lines[mod] = json.loads(out[0])
    assert lines[pbench] == lines[jbench]
    assert set(lines[pbench]) == {"metric", "value", "unit", "vs_baseline"}


def test_metric_choices_equal_the_jax_bench():
    src = open(jbench.__file__).read()
    for metric in pbench.METRICS:
        assert f'"{metric}"' in src
    assert len(pbench.METRICS) == 13


def _main_lines(argv, capsys):
    assert pbench.main(argv) == 0
    out, err = capsys.readouterr()
    return out.splitlines(), err


@pytest.mark.timeout(300)
def test_ratio_main_equals_the_jax_package(capsys):
    lines, err = _main_lines(["--cpu", "--mb", "1", "--metric", "ratio"], capsys)
    assert len(lines) == 1
    got = json.loads(lines[0])
    data = jbench.synth_fastq(1)
    comp = japi.compress_bytes(data, jmodels.get_model("fqz-v3-max").options())
    assert got == {"metric": "compression_ratio", "value": round(len(data) / len(comp), 3),
                   "unit": "x", "vs_baseline": round(len(data) / len(comp) / 3.25, 3)}
    assert f"({len(comp):,} bytes)" in err
    assert err.splitlines()[-1].startswith("launches {")


def test_micro_main_prints_one_json_line(capsys):
    lines, err = _main_lines(["--cpu", "--mb", "1", "--metric", "micro"], capsys)
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got["metric"] == "parse_throughput" and got["unit"] == "MB/s"
    assert got["value"] > 0
    for stage in ("parse", "build_streams", "zstd_encode", "zstd_decode"):
        assert f"micro {stage}" in err
    launches = json.loads(err.splitlines()[-1].removeprefix("launches "))
    assert not any(launches.values())  # host stages only


@pytest.mark.timeout(300)
def test_fqpack_bench_forwards_to_the_port_bench(tmp_path):
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    p = subprocess.run(
        [sys.executable, "-m", "fastqpacker_tpu_torch.cli.fqpack", "bench", "--cpu",
         "--mb", "1", "--metric", "micro"],
        capture_output=True, text=True, cwd=tmp_path, timeout=280,
        env={**os.environ, "PYTHONPATH": str(repo)},
    )
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout)["metric"] == "parse_throughput"


# ---------------------------------------------------------------------------
# the wall-clock metrics: the JAX package's containers
# ---------------------------------------------------------------------------

SHORT = {"window_s": 0.01, "min_s": 0.0, "cap_s": 0.05, "min_windows": 2}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("v3", [False, True], ids=["v2", "v3"])
def test_wall_clock_metrics_give_the_jax_containers(v3, capsys):
    data = jbench.synth_fastq(1, seed=3)
    want = jcompress_bytes(data, JOptions(version=3) if v3 else JOptions())
    mbps, ratio, best = pbench.bench_compress(data, "cpu", 1, v3=v3, **SHORT)
    assert ratio == len(data) / len(want)
    assert mbps == len(data) / 1e6 / best > 0
    mbps, best = pbench.bench_decompress(data, "cpu", 1, v3=v3, **SHORT)
    assert mbps == len(data) / 1e6 / best > 0
    err = capsys.readouterr().err
    assert f"container: {len(want):,} bytes ({'v3' if v3 else 'v2'})" in err
    assert err.count("estimator: ") == 2


# ---------------------------------------------------------------------------
# the kernel metrics at tiny shapes on the plain versions
# ---------------------------------------------------------------------------


def test_wctx_table_equals_the_jax_bench_pcum():
    """``bench.py:596-615``'s ``pcum`` (before ``pack_planes``), in the
    port's device layout: the first npres + 1 columns."""
    for contexts in (384, 3072, 16):
        npres = 46
        base = pwctx.PROB_SCALE // npres
        freq_p = np.full((contexts, npres), base, np.uint16)
        freq_p[:, 0] += pwctx.PROB_SCALE - base * npres
        B = 2
        while B < npres:
            B *= 2
        pcum = np.zeros((contexts, B), np.int32)
        pc = np.zeros((contexts, npres), np.int64)
        np.cumsum(freq_p[:, :-1].astype(np.int64), axis=1, out=pc[:, 1:])
        pcum[:, :npres] = pc
        if npres < B:
            tail = pc[:, -1] + freq_p[:, -1].astype(np.int32)
            for j in range(npres, B):
                pcum[:, j] = tail
        got_freq, tab = pbench.wctx_bench_table(contexts)
        assert np.array_equal(got_freq, freq_p)
        assert tab.dtype == np.int16 and tab.shape == (contexts, npres + 1)
        assert np.array_equal(tab.astype(np.int32), pcum[:, : npres + 1])
        assert (pcum[:, npres:] == pwctx.PROB_SCALE).all()


@pytest.mark.timeout(300)
@pytest.mark.parametrize(
    "call",
    [
        lambda: pbench.bench_kernel(read_len=9, r=33, steps=2, device="cpu"),
        lambda: pbench.bench_decode_kernel(read_len=9, r=33, steps=2, device="cpu"),
        lambda: pbench.bench_mesh_entropy(1 / 64, steps=1, device="cpu"),
        lambda: pbench.bench_mesh_entropy_decode(1 / 64, steps=1, device="cpu"),
        lambda: pbench.bench_wctx_entropy(1 / 256, steps=1, device="cpu"),
        lambda: pbench.bench_wctx_entropy(1 / 256, steps=1, decode=True, device="cpu"),
        lambda: pbench.bench_mesh_e2e(1, repeats=1, device="cpu")[0],
    ],
    ids=["kernel", "decode-kernel", "mesh-entropy", "mesh-entropy-decode",
         "wctx-entropy", "wctx-entropy-decode", "mesh-e2e"],
)
def test_kernel_metrics_run_on_the_plain_versions(call):
    value = call()
    assert np.isfinite(value) and value > 0


def test_no_card_no_cpu_raises_and_prints_nothing(capsys):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbench.main(["--mb", "1", "--metric", "kernel"])
    assert capsys.readouterr().out == ""
    assert port_cli.main(["bench", "--mb", "1", "--metric", "micro"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and err.startswith("error: no CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbench.bench_kernel(read_len=9, r=33, steps=1)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_trace_writes_a_trace_file_and_none_does_nothing(tmp_path, capsys):
    import torch

    log_dir = tmp_path / "prof"
    with pprofiling.trace(str(log_dir)):
        torch.ones(64).add_(1)
    files = list(log_dir.rglob("*.json"))
    assert files and files[0].stat().st_size > 0
    assert capsys.readouterr().err == f"profile trace written to {log_dir}\n"
    with pprofiling.trace(None):
        pass
    with pprofiling.trace(""):
        pass
    assert capsys.readouterr().err == ""
    assert not (tmp_path / "None").exists()


def test_bench_profile_flag_writes_a_trace(tmp_path, capsys):
    lines, err = _main_lines(["--cpu", "--mb", "1", "--metric", "kernel",
                              "--profile", str(tmp_path / "p")], capsys)
    assert len(lines) == 1 and json.loads(lines[0])["metric"] == "encode_kernel_throughput"
    assert f"profile trace written to {tmp_path / 'p'}" in err
    assert list((tmp_path / "p").rglob("*.json"))


def test_stage_timer_report_equals_jax():
    totals = {"parse": 1.25, "zstd": 0.5, "dense encode": 3.125, "x" * 30: 0.0001}
    counts = {"parse": 4, "zstd": 7, "dense encode": 1, "x" * 30: 2}
    texts = []
    for mod in (jprofiling, pprofiling):
        timer = mod.StageTimer()
        timer.totals.update(totals)
        timer.counts.update(counts)
        out = io.StringIO()
        timer.report(out)
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    timer = pprofiling.StageTimer()
    with timer.stage("a"):
        pass
    with timer.stage("a"):
        pass
    assert timer.counts["a"] == 2 and timer.totals["a"] >= 0


def test_phase_robust_best_survives_one_window(monkeypatch, capsys):
    """A run longer than ``cap_s`` leaves one window: the port returns its
    time and logs no top-2 agreement, where the JAX bench's estimator
    raises IndexError (``bench.py:241`` reads a second window-best)."""
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])

    def once() -> float:
        clock[0] += 5.0
        return 5.0

    assert pbench.phase_robust_best(once, window_s=1.0, min_s=0.0, cap_s=2.0) == 5.0
    assert capsys.readouterr().err == (
        "estimator: 1 runs / 1 windows, window-best spread 0%, top-2 agree n/a\n")
    with pytest.raises(IndexError):
        jbench.phase_robust_best(once, window_s=1.0, min_s=0.0, cap_s=2.0)
