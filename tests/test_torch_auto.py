"""The port's ``--backend auto`` probe (``pipeline/auto.py``) and its CLI.

``bounded_probe`` and ``cached_probe`` keep the JAX functions' semantics
(``FQZ_PROBE_TIMEOUT``, ``FQZ_PROBE_CACHE_TTL``) with a cache file of the
port's own; ``device_worthwhile`` follows ``FQZ_BACKEND`` and
``FQZ_SANITIZE`` and is False here (no card). ``--backend auto`` is opt-in:
the default stays ``cuda``, and ``auto`` prints its choice on stderr.
"""

import functools
import json
import os
import tempfile
import time

import pytest
import torch

from fastqpacker_tpu.cli import fqpack as jax_cli
from fastqpacker_tpu.pipeline import auto as jauto
from fastqpacker_tpu_torch.cli import fqpack as port_cli
from fastqpacker_tpu_torch.pipeline import auto as pauto
from fastqpacker_tpu_torch.utils.synth import synth_fastq
from torch_wctx_inputs import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)


@pytest.fixture
def probe_env(monkeypatch, tmp_path):
    """A private temp dir for the probe caches, no backend settings, and
    the per-process verdict cleared before and after."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for var in ("FQZ_BACKEND", "FQZ_SANITIZE", "FQZ_PROBE_TIMEOUT",
                "FQZ_PROBE_CACHE_TTL", "FQZ_FORCE_CPU"):
        monkeypatch.delenv(var, raising=False)
    pauto.backend_choice.cache_clear()
    yield tmp_path
    pauto.backend_choice.cache_clear()


# ---------------------------------------------------------------------------
# bounded_probe
# ---------------------------------------------------------------------------


def _boom():
    raise RuntimeError("probe failed")


def _slow():
    time.sleep(2.0)
    return "late"


@pytest.mark.parametrize("mod", [pauto, jauto], ids=["port", "jax"])
def test_bounded_probe_value_error_and_timeout(mod, probe_env, monkeypatch):
    assert mod.bounded_probe(lambda: 42, 5.0, "fb") == 42
    assert mod.bounded_probe(_boom, 5.0, "fb") == "fb"
    monkeypatch.setenv("FQZ_PROBE_TIMEOUT", "0.05")
    t0 = time.perf_counter()
    assert mod.bounded_probe(_slow, 60.0, "fb") == "fb"
    assert time.perf_counter() - t0 < 1.5
    monkeypatch.setenv("FQZ_PROBE_TIMEOUT", "not-a-number")  # default applies
    assert mod.bounded_probe(lambda: 7, 5.0, "fb") == 7


# ---------------------------------------------------------------------------
# cached_probe
# ---------------------------------------------------------------------------


def _counted(value):
    calls = []

    def compute():
        calls.append(1)
        return value

    return compute, calls


def test_cache_file_is_the_ports_own(probe_env):
    path = pauto._cache_path()
    assert os.path.dirname(path) == str(probe_env)
    assert os.path.basename(path) == f"fqz_torch_probe_cache_{os.getuid()}.json"
    assert path != jauto._cache_path()
    # the JAX package's verdict under the same key does not route the port
    with open(jauto._cache_path(), "w") as f:
        json.dump({"ts": time.time(), "values": {"device_worthwhile": True}}, f)
    compute, calls = _counted(False)
    assert pauto.cached_probe("device_worthwhile", compute) is False
    assert calls == [1]


def test_cached_probe_ttl(probe_env, monkeypatch):
    compute, calls = _counted(1)
    assert pauto.cached_probe("k", compute) is True  # coerced to bool
    assert pauto.cached_probe("k", compute) is True
    assert calls == [1]  # the second call read the file
    with open(pauto._cache_path()) as f:
        assert json.load(f)["values"] == {"k": True}
    other, other_calls = _counted(0)
    assert pauto.cached_probe("k2", other) is False and other_calls == [1]
    with open(pauto._cache_path()) as f:
        assert json.load(f)["values"] == {"k": True, "k2": False}
    # a stale file means probing again
    monkeypatch.setenv("FQZ_PROBE_CACHE_TTL", "0.5")
    time.sleep(0.6)
    assert pauto.cached_probe("k", compute) is True and calls == [1, 1]


def test_cached_probe_ttl_zero_never_caches(probe_env, monkeypatch):
    monkeypatch.setenv("FQZ_PROBE_CACHE_TTL", "0")
    compute, calls = _counted(True)
    for _ in range(3):
        assert pauto.cached_probe("k", compute) is True
    assert calls == [1, 1, 1]
    assert not os.path.exists(pauto._cache_path())


@pytest.mark.parametrize("content", [b"{not json", b"[1, 2]", b'{"ts": "x", "values": 3}'])
def test_cached_probe_corrupt_file_reprobes(probe_env, content):
    with open(pauto._cache_path(), "wb") as f:
        f.write(content)
    compute, calls = _counted(True)
    assert pauto.cached_probe("k", compute) is True and calls == [1]
    assert pauto.cached_probe("k", compute) is True and calls == [1]  # rewritten


# ---------------------------------------------------------------------------
# device_worthwhile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "env,want",
    [
        ({"FQZ_BACKEND": "cuda"}, (True, "FQZ_BACKEND=cuda")),
        ({"FQZ_BACKEND": "DEVICE"}, (True, "FQZ_BACKEND=device")),
        ({"FQZ_BACKEND": "cpu"}, (False, "FQZ_BACKEND=cpu")),
        ({"FQZ_BACKEND": "host"}, (False, "FQZ_BACKEND=host")),
        ({"FQZ_SANITIZE": "1"}, (False, "FQZ_SANITIZE is set")),
        ({"FQZ_SANITIZE": "1", "FQZ_BACKEND": "cpu"}, (False, "FQZ_SANITIZE is set")),
        ({}, (False, "no CUDA device")),
    ],
)
def test_device_worthwhile_settings(env, want, probe_env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pauto.backend_choice() == want
    assert pauto.device_worthwhile() is want[0]
    assert not os.path.exists(pauto._cache_path())  # no probe ran


def test_device_worthwhile_is_false_here(probe_env):
    assert not torch.cuda.is_available()
    assert pauto.device_worthwhile() is False


def test_transfer_bandwidth_needs_a_card():
    assert pauto.transfer_bandwidth_mbps("cpu") == float("inf")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pauto.transfer_bandwidth_mbps()
    assert pauto.MIN_TRANSFER_MBPS == jauto.MIN_TRANSFER_MBPS == 1000.0


@pytest.mark.parametrize(
    "rate,want",
    [(25_000.0, (True, "transfer 25000 MB/s")), (999.0, (False, "transfer 999 MB/s")),
     (None, (False, "transfer probe failed or timed out"))],
)
def test_probe_verdicts_with_a_card(rate, want, probe_env, monkeypatch):
    """With a card the verdict is the measured rate against the minimum,
    bounded (an error gives False) and cached across processes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def measure(device=None, nbytes=2 << 20):
        if rate is None:
            raise RuntimeError("copy failed")
        return rate

    monkeypatch.setattr(pauto, "transfer_bandwidth_mbps", measure)
    assert pauto.backend_choice() == want
    pauto.backend_choice.cache_clear()
    assert pauto.backend_choice() == (want[0], "cached probe")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_default_backend_stays_cuda():
    assert port_cli.build_argparser().parse_args([]).backend == "cuda"
    args = port_cli.build_argparser().parse_args(["--backend", "auto"])
    assert args.backend == "auto"


def _run_cli(cli, argv, capsys):
    rc = cli.main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("flags", [[], ["--format", "native", "-w", "1"]],
                         ids=["v2", "v3"])
def test_cli_auto_takes_the_cpu_here_and_says_so(flags, probe_env, capsys):
    src = probe_env / "in.fq"
    src.write_bytes(synth_fastq(0.25, seed=21, min_len=40, read_len=170))
    outs = {b: probe_env / f"{b}.fqz" for b in ("auto", "cpu", "jax")}
    rc, _, err = _run_cli(port_cli, ["--backend", "auto", *flags, "-i", str(src),
                                     "-o", str(outs["auto"])], capsys)
    assert rc == 0 and err == "backend auto: cpu (no CUDA device)\n"
    rc, _, err = _run_cli(port_cli, ["--backend", "cpu", *flags, "-i", str(src),
                                     "-o", str(outs["cpu"])], capsys)
    assert rc == 0 and err == ""
    rc, _, _ = _run_cli(jax_cli, ["--backend", "cpu", *flags, "-i", str(src),
                                  "-o", str(outs["jax"])], capsys)
    assert rc == 0
    assert outs["auto"].read_bytes() == outs["cpu"].read_bytes() == outs["jax"].read_bytes()


def test_cli_auto_under_fqz_backend_cpu(probe_env, capsys, monkeypatch):
    monkeypatch.setenv("FQZ_BACKEND", "cpu")
    src = probe_env / "in.fq"
    data = synth_fastq(0.1, seed=22)
    src.write_bytes(data)
    rc, _, err = _run_cli(port_cli, ["--backend", "auto", "-i", str(src), "-o",
                                     str(probe_env / "a.fqz")], capsys)
    assert rc == 0 and err == "backend auto: cpu (FQZ_BACKEND=cpu)\n"


@pytest.mark.parametrize("sub", ["-d", "check", "cat", "--mesh", "--pair", "info"])
def test_every_backend_subcommand_takes_auto(sub, probe_env, capsys):
    data = synth_fastq(0.05, seed=23, read_len=100)
    src = probe_env / "in.fq"
    src.write_bytes(data)
    fqz = probe_env / "in.fqz"
    assert port_cli.main(["--backend", "cpu", "-i", str(src), "-o", str(fqz)]) == 0
    out = probe_env / "out"
    argv = {
        "-d": ["-d", "-i", str(fqz), "-o", str(out)],
        "check": ["check", str(fqz)],
        "cat": ["cat", str(fqz), "-r", "3:5", "-o", str(out)],
        "--mesh": ["--mesh", "-i", str(src), "-o", str(out)],
        "--pair": ["--pair", str(src), "-i", str(src), "-o", str(out)],
        "info": ["info", str(fqz)],
    }[sub]
    capsys.readouterr()
    rc, stdout, err = _run_cli(port_cli, ["--backend", "auto", *argv], capsys)
    assert rc == 0, err
    if sub == "info":  # info reads headers only: no backend, no probe
        assert err == "" and not os.path.exists(pauto._cache_path())
    else:
        assert err == "backend auto: cpu (no CUDA device)\n"
    if sub == "-d":
        assert out.read_bytes() == data


def test_cli_auto_that_chooses_the_card_runs_on_it(probe_env, capsys, monkeypatch):
    """A verdict for the card routes to ``cuda`` (which fails here), never
    silently to the host."""
    monkeypatch.setattr(pauto, "backend_choice",
                        functools.lru_cache(lambda: (True, "transfer 25000 MB/s")))
    src = probe_env / "in.fq"
    src.write_bytes(synth_fastq(0.05, seed=24))
    rc, _, err = _run_cli(port_cli, ["--backend", "auto", "-i", str(src), "-o",
                                     str(probe_env / "a.fqz")], capsys)
    assert rc == 1
    assert err.splitlines()[0] == "backend auto: cuda (transfer 25000 MB/s)"
    assert "no CUDA device" in err.splitlines()[1]
