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
    assert int(p.stdout.strip()) >= 44  # every module of the package


def test_the_v3_modules_are_in_the_package():
    """The modules of the FQZ v3 slice exist under the port (so the walk
    above imported them with JAX and the JAX package blocked)."""
    import importlib

    for name in ("ops.rans", "ops.crc32", "ops.tokenize", "ops.qualctx",
                 "ops.seqctx", "ops.sldm", "pipeline.native"):
        mod = importlib.import_module(f"fastqpacker_tpu_torch.{name}")
        assert "fastqpacker_tpu_torch" in mod.__file__
    src = (REPO / "fastqpacker_tpu_torch").rglob("*.py")
    for path in [*src, REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith(("jax", "fastqpacker_tpu.")), (path, line)
                assert words[1] != "fastqpacker_tpu", (path, line)


def test_the_mesh_slice_modules_are_in_the_package():
    """The modules of the device context coder and the ``--mesh`` path
    exist under the port, import neither JAX nor the JAX package, and the
    kernel source and its launchers are registered with the build."""
    import importlib

    from fastqpacker_tpu_torch.ops import build, cuda_kernels

    for name in ("ops.wctx", "parallel.mesh", "pipeline.meshpipe", "utils.inmem"):
        mod = importlib.import_module(f"fastqpacker_tpu_torch.{name}")
        assert "fastqpacker_tpu_torch" in mod.__file__
        for line in Path(mod.__file__).read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith(("jax", "fastqpacker_tpu.")), line
                assert words[1] != "fastqpacker_tpu", line
    assert (REPO / "fastqpacker_tpu_torch" / "csrc" / "wctx_codec.cu").is_file()
    assert set(build.SIGNATURES["wctx_codec"]) == {"fq_wctx_encode", "fq_wctx_decode"}
    assert {"fq_wctx_encode", "fq_wctx_decode"} <= set(cuda_kernels.launches.as_dict())
    # the eight kernels of the three paths, the four block stages, the
    # four context-model passes, the byte histogram, the tokenizer's two and
    # the four context coders
    assert len(cuda_kernels.launches.as_dict()) == 23


def test_the_block_stage_modules_are_in_the_package():
    """The block stages (record scan, row gather, stream build, FASTQ
    assembly) and the modules that route through them exist under the port,
    so the walk above imported them with JAX and the JAX package blocked,
    none of them imports either, and their source and launchers are
    registered with the build."""
    import importlib

    from fastqpacker_tpu_torch.ops import build, cuda_kernels

    for name in ("ops.records", "ops.cuda_kernels", "parser.fastq", "pipeline.api",
                 "pipeline.blocks", "pipeline.device", "pipeline.native",
                 "pipeline.meshpipe", "pipeline.ranges", "parallel.multihost", "bench"):
        mod = importlib.import_module(f"fastqpacker_tpu_torch.{name}")
        assert "fastqpacker_tpu_torch" in mod.__file__
        for line in Path(mod.__file__).read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith(("jax", "fastqpacker_tpu.")), line
                assert words[1] != "fastqpacker_tpu", line
    assert (REPO / "fastqpacker_tpu_torch" / "csrc" / "records.cu").is_file()
    stages = {"fq_records_scan", "fq_rows_gather", "fq_streams_build", "fq_fastq_assemble"}
    assert set(build.SIGNATURES["records"]) == stages
    assert stages <= set(cuda_kernels.launches.as_dict())


def test_the_context_pass_modules_are_in_the_package():
    """The context-model passes (``ops/ctxprep.py``: the qctx and sctx
    prepare passes, the wctx lane matrices both ways) exist under the port,
    so the walk above imported them with JAX and the JAX package blocked,
    neither they nor the modules that route through them import either, and
    their source and launchers are registered with the build."""
    import importlib

    from fastqpacker_tpu_torch.ops import build, cuda_kernels

    for name in ("ops.ctxprep", "ops.qualctx", "ops.seqctx", "ops.wctx", "parallel.mesh",
                 "pipeline.native", "pipeline.meshpipe"):
        mod = importlib.import_module(f"fastqpacker_tpu_torch.{name}")
        assert "fastqpacker_tpu_torch" in mod.__file__
        for line in Path(mod.__file__).read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith(("jax", "fastqpacker_tpu.")), line
                assert words[1] != "fastqpacker_tpu", line
    assert (REPO / "fastqpacker_tpu_torch" / "csrc" / "ctxprep.cu").is_file()
    passes = {"fq_qctx_prepare", "fq_sctx_prepare", "fq_wctx_layout", "fq_wctx_unlayout"}
    assert set(build.SIGNATURES["ctxprep"]) == passes
    assert passes <= set(cuda_kernels.launches.as_dict())


def test_the_histogram_and_tokenizer_kernels_are_in_the_package():
    """The runtime's byte histogram (``csrc/hist256.cu``) and header
    tokenizer (``csrc/tokens.cu``) exist under the port, the modules that
    route through them import neither JAX nor the JAX package, and their
    launchers are registered with the build (the decode's second call
    uncounted)."""
    import importlib

    from fastqpacker_tpu_torch.ops import build, cuda_kernels

    for name in ("ops.rans", "ops.tokenize", "ops.cuda_kernels", "pipeline.blocks",
                 "pipeline.native", "pipeline.meshpipe", "parallel.mesh", "utils.synth"):
        mod = importlib.import_module(f"fastqpacker_tpu_torch.{name}")
        assert "fastqpacker_tpu_torch" in mod.__file__
        for line in Path(mod.__file__).read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith(("jax", "fastqpacker_tpu.")), line
                assert words[1] != "fastqpacker_tpu", line
    for src in ("hist256.cu", "tokens.cu"):
        assert (REPO / "fastqpacker_tpu_torch" / "csrc" / src).is_file()
    assert set(build.SIGNATURES["hist256"]) == {"fq_hist256"}
    assert set(build.SIGNATURES["tokens"]) == {"fq_tok_encode", "fq_tok_decode",
                                               "fq_tok_decode_write"}
    counted = set(cuda_kernels.launches.as_dict())
    assert {"fq_hist256", "fq_tok_encode", "fq_tok_decode"} <= counted
    assert "fq_tok_decode_write" not in counted


def test_the_cli_surface_modules_are_in_the_package():
    """The modules of the CLI surfaces (``info``, ``check``, ``cat -r``,
    ``--pair``, ``fqscramble``) exist under the port, so the walk above
    imported them with JAX and the JAX package blocked, and none of them
    imports either."""
    import importlib

    for name in ("pipeline.ranges", "cli.inspect", "utils.pairing", "utils.gopcg",
                 "cli.fqscramble", "pipeline.api", "cli.fqpack"):
        mod = importlib.import_module(f"fastqpacker_tpu_torch.{name}")
        assert "fastqpacker_tpu_torch" in mod.__file__
        for line in Path(mod.__file__).read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith(("jax", "fastqpacker_tpu.")), line
                assert words[1] != "fastqpacker_tpu", line
    from fastqpacker_tpu_torch.pipeline import api

    assert callable(api.compress_paired) and callable(api.decompress_paired)


def test_the_parallel_modules_are_in_the_package():
    """The several-card and several-host modules (``parallel/mesh.py``'s
    sharded programs, ``parallel/multihost.py``) exist under the port, so the
    walk above imported them with JAX and the JAX package blocked, and
    neither imports either."""
    import importlib

    for name in ("parallel.mesh", "parallel.multihost"):
        mod = importlib.import_module(f"fastqpacker_tpu_torch.{name}")
        assert "fastqpacker_tpu_torch" in mod.__file__
        for line in Path(mod.__file__).read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith(("jax", "fastqpacker_tpu.")), line
                assert words[1] != "fastqpacker_tpu", line
    from fastqpacker_tpu_torch.parallel import mesh, multihost

    for fn in ("encode_sharded", "decode_sharded", "encode_blocks_parallel",
               "entropy_encode_sharded", "entropy_decode_sharded", "for_each_device"):
        assert callable(getattr(mesh, fn))
    for fn in ("init_distributed", "align_to_record", "host_ranges", "compress_host_section",
               "exchange_section_sizes", "compress_multihost", "simulate_multihost",
               "index_blocks", "decompress_host_section", "decompress_multihost",
               "simulate_multihost_decompress"):
        assert callable(getattr(multihost, fn))


def test_the_bench_modules_are_in_the_package():
    """The benchmark and its helpers (``bench``, ``models``,
    ``utils/profiling.py``, ``utils/malloc_tuning.py``, ``pipeline/auto.py``)
    exist under the port with the JAX package's names, so the walk above
    imported them with JAX and the JAX package blocked, and none of them
    imports either."""
    import importlib

    for name in ("bench", "models", "models.flagship", "utils.profiling",
                 "utils.malloc_tuning", "pipeline.auto"):
        mod = importlib.import_module(f"fastqpacker_tpu_torch.{name}")
        assert "fastqpacker_tpu_torch" in mod.__file__
        for line in Path(mod.__file__).read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith(("jax", "fastqpacker_tpu.")), line
                assert words[1] != "fastqpacker_tpu", line
    from fastqpacker_tpu_torch import bench, models
    from fastqpacker_tpu_torch.pipeline import auto
    from fastqpacker_tpu_torch.utils import malloc_tuning, profiling

    assert len(bench.METRICS) == 13 and callable(bench.main)
    assert callable(models.get_model) and callable(auto.device_worthwhile)
    assert callable(profiling.trace) and callable(malloc_tuning.warm_heap)


def test_default_device_raises_without_a_card(monkeypatch):
    """No ``device=`` means the card; without one the entry points raise
    before any work, and nothing runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_cpu(*args, **kwargs):
        raise AssertionError("ran on the CPU")

    from fastqpacker_tpu_torch.ops import cuda_kernels

    for plain in ("encode_arrays_plain", "decode_arrays_plain",
                  "rans_encode_plain", "rans_compact_plain",
                  "rans_decode_plain", "crc32_chunks_plain",
                  "wctx_encode_plain", "wctx_decode_plain"):
        monkeypatch.setattr(cuda_kernels, plain, no_cpu)
    from fastqpacker_tpu_torch.ops import ctxprep as port_ctxprep

    for plain in ("qctx_prepare_plain", "sctx_prepare_plain", "wctx_layout_plain",
                  "wctx_unlayout_plain"):
        monkeypatch.setattr(port_ctxprep, plain, no_cpu)
    from fastqpacker_tpu_torch.ops import crc32 as port_crc32
    from fastqpacker_tpu_torch.ops import rans as port_rans
    from fastqpacker_tpu_torch.ops import wctx as port_wctx
    from fastqpacker_tpu_torch.ops import qualctx as port_qualctx
    from fastqpacker_tpu_torch.ops import seqctx as port_seqctx
    from fastqpacker_tpu_torch.parallel import mesh as port_mesh
    from fastqpacker_tpu_torch.parallel import multihost as port_multihost
    from fastqpacker_tpu_torch.pipeline import meshpipe as port_meshpipe
    from fastqpacker_tpu_torch.cli import inspect as port_inspect
    from fastqpacker_tpu_torch.pipeline import api as port_api
    from fastqpacker_tpu_torch.pipeline import ranges as port_ranges
    from fastqpacker_tpu_torch import bench as port_bench
    from fastqpacker_tpu_torch.pipeline import auto as port_auto
    import io
    import numpy as np

    data = b"@r\nACGT\n+\nIIII\n"
    for call in (
        lambda: tfq.compress_bytes(data),
        lambda: tfq.compress_bytes(data, tfq.Options(version=3)),
        lambda: tfq.decompress_bytes(b"FQZ\x00\x02" + bytes(5)),
        lambda: tfq.decompress_bytes(b"FQZ\x00\x03" + bytes(5)),
        lambda: port_device.encode_block_arrays(None, None, None, 33),
        lambda: port_rans.encode_stream(b"x" * 100),
        lambda: port_rans.decode_stream(b"x" * 100),
        lambda: port_crc32.crc32_device(b"x" * 100_000),
        lambda: port_wctx.encode_stream(np.zeros(9, np.uint8), np.array([9]), 0, 2),
        lambda: port_wctx.decode_stream(b"x" * 100, np.array([9])),
        lambda: port_wctx.decode_wire(b"x" * 100, np.array([9])),
        lambda: port_qualctx.prepare(np.zeros(9, np.uint8), np.array([9])),
        lambda: port_qualctx.sample_estimate(np.zeros(64, np.uint8), np.full(4, 16), 8),
        lambda: port_qualctx.encode(bytes(9), np.array([9])),
        lambda: port_seqctx.prepare(np.zeros(3, np.uint8), np.array([9])),
        lambda: port_seqctx.sample_estimate(np.zeros(16, np.uint8), np.full(4, 16), 8),
        lambda: port_seqctx.encode(bytes(3), np.array([9])),
        lambda: port_qualctx.decode(b"x" * 100, np.array([9])),
        lambda: port_seqctx.decode(b"x" * 100, np.array([9])),
        lambda: port_mesh.make_mesh(),
        lambda: port_mesh.entropy_encode_streams([b"x" * 100]),
        lambda: port_meshpipe.compress_mesh_bytes(data),
        lambda: port_meshpipe.decompress_mesh(
            io.BytesIO(b"FQZ\x00\x03" + bytes(5)), io.BytesIO()),
        lambda: port_ranges.read_record_range("missing.fqz", 0, 1),
        lambda: port_inspect.check("missing.fqz"),
        lambda: port_api.compress_paired(io.BytesIO(data), io.BytesIO(data), io.BytesIO()),
        lambda: port_api.decompress_paired(io.BytesIO(b"FQZ\x00\x02" + bytes(5)),
                                           io.BytesIO(), io.BytesIO()),
        lambda: port_mesh.encode_blocks_parallel(np.zeros((4, 8), np.uint8),
                                                 np.zeros((4, 8), np.uint8),
                                                 np.full(4, 8, np.int32), 33),
        lambda: port_mesh.entropy_encode_sharded(np.zeros((1, 8), np.uint8), None, mesh=None,
                                                 pad_sym=0, m_per_shard=8),
        lambda: port_multihost.init_distributed(),
        lambda: port_multihost.simulate_multihost("missing.fq", "out.fqz", 2),
        lambda: port_multihost.simulate_multihost_decompress("missing.fqz", "out.fq", 2),
        lambda: port_multihost.compress_multihost("missing.fq", "out.fqz"),
        lambda: port_bench.main(["--mb", "1", "--metric", "micro"]),
        lambda: port_bench.bench_mesh_e2e(1, repeats=1),
        lambda: port_auto.transfer_bandwidth_mbps(),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
