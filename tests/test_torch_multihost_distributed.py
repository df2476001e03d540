"""A real two-process run of the port's multi-host path on the CPU.

Two processes join a gloo group on a free local port
(``init_distributed``), each compresses its range and ``pwrite``\\ s its
section at the offset the size all-gather gives, then (after a barrier:
``compress_multihost`` returns after its own write, not its peers') each
decompresses its stripe. The container must be byte for byte the
single-process simulation's and the JAX package's, and both outputs must
decode to the input.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import fastqpacker_tpu as jfq
import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu.parallel import multihost as jmh
from fastqpacker_tpu_torch.parallel import multihost as pmh
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import sys
import torch
import torch.distributed as dist
import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu_torch.parallel import multihost as mh

torch.set_num_threads(1)
pid, nproc, port, in_path, out_path, version = sys.argv[1:7]
rank, size = mh.init_distributed(f"127.0.0.1:{port}", int(nproc), int(pid), device="cpu",
                                 timeout=120)
assert (rank, size) == (int(pid), int(nproc))
mh.compress_multihost(in_path, out_path, tfq.Options(block_size=150, version=int(version)),
                      device="cpu")
dist.barrier()
mh.decompress_multihost(out_path, out_path + ".fq", device="cpu")
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout(240)
@pytest.mark.parametrize("version", [2, 3])
def test_two_process_gloo_compress_and_decompress(tmp_path, version):
    rng = np.random.default_rng(5)
    recs = []
    for i in range(1200):
        ln = int(rng.integers(1, 160))
        s = "".join("ACGTN"[b] for b in rng.integers(0, 5, ln))
        q = "".join(chr(33 + int(b)) for b in rng.integers(0, 42, ln))
        recs.append(f"@mh{i}\n{s}\n+\n{q}\n")
    data = "".join(recs).encode()
    in_path = tmp_path / "in.fq"
    in_path.write_bytes(data)
    out_path = tmp_path / "out.fqz"
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)

    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port), str(in_path), str(out_path),
             str(version)],
            env=env, stderr=subprocess.PIPE, cwd=str(tmp_path),
        )
        for i in range(2)
    ]
    try:
        for p in procs:
            _, err = p.communicate(timeout=200)
            assert p.returncode == 0, f"worker failed:\n{err.decode(errors='replace')[-2000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    comp = out_path.read_bytes()
    opts = tfq.Options(block_size=150, version=version)
    sim = tmp_path / "sim.fqz"
    pmh.simulate_multihost(str(in_path), str(sim), 2, opts, device="cpu")
    jsim = tmp_path / "jsim.fqz"
    jmh.simulate_multihost(str(in_path), str(jsim), 2, opts)
    assert comp == sim.read_bytes() == jsim.read_bytes()
    assert (tmp_path / "out.fqz.fq").read_bytes() == data
    assert tfq.decompress_bytes(comp, device="cpu") == data
    assert jfq.decompress_bytes(comp) == data
