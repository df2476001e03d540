"""The port stands alone: no JAX, no fastqpacker_tpu, no silent CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu_torch.ops import device as port_device

REPO = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

for name in ("jax", "jaxlib"):
    sys.modules[name] = None  # any import of them fails


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name == "fastqpacker_tpu" or name.startswith("fastqpacker_tpu."):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Blocker())
import fastqpacker_tpu_torch

names = [m.name for m in pkgutil.walk_packages(
    fastqpacker_tpu_torch.__path__, "fastqpacker_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "fastqpacker_tpu")
          and sys.modules[m] is not None]
assert not leaked, leaked
print(len(names))
"""


@pytest.mark.timeout(120)
def test_imports_with_jax_and_the_jax_package_blocked():
    p = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        capture_output=True, text=True, cwd=REPO, timeout=110,
    )
    assert p.returncode == 0, p.stderr
    assert int(p.stdout.strip()) >= 20  # every module of the package


def test_default_device_raises_without_a_card(monkeypatch):
    """No ``device=`` means the card; without one the entry points raise
    before any work, and nothing runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_cpu(*args, **kwargs):
        raise AssertionError("ran on the CPU")

    from fastqpacker_tpu_torch.ops import cuda_kernels

    monkeypatch.setattr(cuda_kernels, "encode_arrays_plain", no_cpu)
    monkeypatch.setattr(cuda_kernels, "decode_arrays_plain", no_cpu)
    data = b"@r\nACGT\n+\nIIII\n"
    for call in (
        lambda: tfq.compress_bytes(data),
        lambda: tfq.decompress_bytes(b"FQZ\x00\x02" + bytes(5)),
        lambda: port_device.encode_block_arrays(None, None, None, 33),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
