"""The port's order-0 byte histogram (``fq_hist256``, ``csrc/hist256.cu``)
against the JAX package's, on the CPU.

Seeded numpy streams go through ``cuda_kernels.hist256`` (a CPU tensor takes
its plain version, ``rans.hist256_plain``), ``np.bincount`` and the JAX
package's ``runtime.bindings.hist256`` (its C++ runtime, built on first
use); then the callers that build rANS tables and size estimates from it:
``pipeline/native.py:_rans_size_estimate`` on a view of the stream build's
buffer (its counts handed on to ``rans.encode_stream``, so a v3 stream that
picks rANS is counted once), ``parallel/mesh.py:entropy_table`` on
per-device streams. All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from fastqpacker_tpu.parallel import mesh as jmesh
from fastqpacker_tpu.pipeline import native as jnative
from fastqpacker_tpu.runtime import bindings
from fastqpacker_tpu_torch.ops import cuda_kernels
from fastqpacker_tpu_torch.ops import rans as trans
from fastqpacker_tpu_torch.parallel import mesh as tmesh
from fastqpacker_tpu_torch.pipeline import blocks as tblocks
from fastqpacker_tpu_torch.pipeline import native as tnative
import torch_tokens_inputs
from torch_tokens_inputs import hist_edge_cases
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

CPU = torch.device("cpu")
HIST_CASES = hist_edge_cases()


def _view(buf: bytes, off: int, n: int) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(buf, np.uint8).copy())[off : off + n]


@pytest.mark.parametrize("name,const", [
    ("HIST_THREADS", "kThreads"), ("HIST_CTAS_PER_SM", "kCtasPerSm"),
    ("HIST_MIN_UNITS", "kMinUnits"), ("HIST_FLUSH_UNITS", "kFlushUnits"),
])
def test_edge_inputs_follow_the_kernel_grid(name, const):
    """The edges are cut at the kernel's grid: the sizes they are cut at
    equal the constants of ``csrc/hist256.cu``."""
    import re
    from pathlib import Path

    src = (Path(trans.__file__).parent.parent / "csrc" / "hist256.cu").read_text()
    m = re.search(rf"constexpr int {const} = (\d+);", src)
    assert m and int(m.group(1)) == getattr(torch_tokens_inputs, name)


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_hist256_equals_bincount_and_the_jax_runtime(case):
    """Lengths 0, 1, 15, 16, 17 and past several CTAs, views at each offset
    1-15, one-symbol, 256-symbol and skewed streams, two bytes in turn, walk
    deltas, uniform bytes, a wave and the shortest stream that fills the
    grid, less or more one: the wrapper's counts equal ``np.bincount`` and the JAX runtime's
    ``fq_hist256``."""
    buf, off, n = HIST_CASES[case]
    view = _view(buf, off, n)
    got = cuda_kernels.hist256(view)
    assert got.dtype == torch.int64 and tuple(got.shape) == (256,)
    arr = np.frombuffer(buf, np.uint8)[off : off + n]
    want = np.bincount(arr, minlength=256)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(trans.histogram(view), want)
    assert int(got.sum()) == n
    if bindings.available():
        assert np.array_equal(bindings.hist256(arr.copy()), want)


def test_hist256_refuses_what_is_not_a_byte_stream():
    with pytest.raises(ValueError):
        cuda_kernels.hist256(torch.zeros((4,), dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_kernels.hist256(torch.zeros((4, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        cuda_kernels.hist256(torch.zeros((8,), dtype=torch.uint8)[::2])


@pytest.mark.parametrize("n,seed", [(16384, 1), (100_003, 2), (262_147, 3)])
@pytest.mark.parametrize("offset", [0, 5])
def test_rans_size_estimate_on_a_view_equals_the_jax_package(n, seed, offset):
    """The v3 pick's estimate from the stream where the stream build left it
    (a view at any offset of its buffer), equal to the JAX package's from
    the host bytes."""
    rng = np.random.default_rng(seed)
    s = np.clip(rng.normal(30, 6, n + offset), 0, 255).astype(np.uint8).tobytes()
    view = torch.from_numpy(np.frombuffer(s, np.uint8).copy())[offset:]
    est, hist = tnative._rans_size_estimate(view)
    assert est == jnative._rans_size_estimate(s[offset:])
    assert np.array_equal(hist, np.bincount(np.frombuffer(s[offset:], np.uint8), minlength=256))


@pytest.mark.parametrize("n,seed", [(1, 4), (300_000, 5)])
def test_rans_stream_table_from_the_histogram_equals_the_jax_package(n, seed):
    """``rans.encode_stream`` builds its table from the copy it encodes: the
    stream equals the JAX package's."""
    from fastqpacker_tpu.ops import rans as jrans

    rng = np.random.default_rng(seed)
    data = rng.choice(np.arange(20, dtype=np.uint8), size=n).astype(np.uint8)
    assert trans.encode_stream(data.tobytes(), device=CPU) == jrans.encode_stream(data.tobytes())


@pytest.mark.parametrize("n,seed,offset", [(1, 6, 0), (20_000, 7, 3), (300_000, 8, 9)])
def test_rans_stream_from_a_view_and_its_counts_equals_the_jax_package(n, seed, offset,
                                                                        monkeypatch):
    """``rans.encode_stream`` given the stream's view and its counts (the
    estimate's) counts nothing: its stream equals the JAX package's."""
    from fastqpacker_tpu.ops import rans as jrans

    rng = np.random.default_rng(seed)
    data = rng.choice(np.arange(30, dtype=np.uint8), size=n + offset).astype(np.uint8)
    view = torch.from_numpy(data.copy())[offset:]
    hist = np.bincount(data[offset:], minlength=256).astype(np.int64)

    def counted(_):
        raise AssertionError("the stream was counted again")

    with monkeypatch.context() as m:
        m.setattr(trans, "histogram", counted)
        got = trans.encode_stream(data[offset:].tobytes(), device=CPU, view=view, hist=hist)
    assert got == jrans.encode_stream(data[offset:].tobytes())
    assert np.array_equal(hist, np.bincount(data[offset:], minlength=256))  # not modified
    with pytest.raises(ValueError):
        trans.encode_stream(data[offset:].tobytes(), device=CPU, view=view)
    with pytest.raises(ValueError):
        trans.encode_stream(data[offset + 1 :].tobytes(), device=CPU, view=view, hist=hist)


def test_v3_block_counts_each_stream_once(monkeypatch):
    """A v3 compress whose quality streams pick ``TAG_RANS``: one
    ``rans.histogram`` a size estimate (each block's sequence and quality
    streams) and none in the rANS encode, which takes the estimate's view
    and counts; the container equals the JAX package's."""
    import io

    import fastqpacker_tpu as jfq
    import fastqpacker_tpu_torch as tfq
    from fastqpacker_tpu.ops import reference as jax_refops
    from fastqpacker_tpu_torch.utils.synth import synth_fastq

    monkeypatch.setenv("FQZ_RANS_BACKEND", "host")  # the JAX package's sequential twin
    data = synth_fastq(1.5, seed=3, qual_model="walk")
    counted, estimates = [], []
    real_hist, real_est = trans.histogram, tnative._rans_size_estimate

    def histogram(view):
        counted.append(view.numel())
        return real_hist(view)

    def estimate(view):
        estimates.append(view.numel())
        return real_est(view)

    monkeypatch.setattr(trans, "histogram", histogram)
    monkeypatch.setattr(tnative, "_rans_size_estimate", estimate)
    got = tfq.compress_bytes(data, tfq.Options(version=3, workers=1, block_size=2500),
                             device="cpu")
    out = io.BytesIO()
    jnative.compress_native(io.BytesIO(data), out,
                            jfq.Options(version=3, workers=1, block_size=2500),
                            encode_arrays=jax_refops.encode_block_arrays)
    assert got == out.getvalue()
    blocks = -(-data.count(b"\n") // 4 // 2500)
    assert counted == estimates and len(estimates) == 2 * blocks
    r = io.BytesIO(got)
    fh = tfq.container.read_file_header(r)
    rans_streams = 0
    while (hdr := tfq.container.read_block_header(r, fh.version)) is not None:
        sizes = hdr.stream_sizes(tfq.container.VERSION_2)
        payload = r.read(sum(sizes))
        rans_streams += (payload[0] == tnative.TAG_RANS) + (payload[sizes[0]] == tnative.TAG_RANS)
    assert rans_streams >= blocks


@pytest.mark.parametrize("raw_lens", [None, [5000, 0, 4096, 777]])
def test_entropy_table_over_device_streams_equals_the_jax_package(raw_lens):
    """The group table from one histogram a stream, each stream a tensor on
    its device (here the CPU) or rows of a host array, equal to the JAX
    package's ``entropy_table``."""
    rng = np.random.default_rng(11)
    streams = rng.integers(0, 40, size=(4, 5000), dtype=np.uint8)
    lens = None if raw_lens is None else np.array(raw_lens)
    want = jmesh.entropy_table(streams, raw_lens=lens, lanes=256)
    for given in (streams, [torch.from_numpy(r.copy()) for r in streams]):
        freq_cum, pad_sym = tmesh.entropy_table(given, raw_lens=lens, lanes=256)
        assert np.array_equal(freq_cum, want[0]) and pad_sym == want[1]


def test_raw_streams_keep_the_stream_build_buffer():
    """A block's RawStreams keep the buffer the stream build wrote: each
    device view holds the same bytes as the host stream."""
    from fastqpacker_tpu_torch.parser.fastq import FastqStreamParser
    from fastqpacker_tpu_torch.utils.synth import synth_fastq
    import io

    data = synth_fastq(0.2, seed=9, qual_model="walk")
    blk = next(FastqStreamParser(io.BytesIO(data), block_size=100_000, device=CPU).blocks())
    raw = tblocks.block_to_raw_streams(blk, 33, wide_npos=True)
    for i, s in enumerate(raw.ordered(3)):
        assert raw.device_view(i).numpy().tobytes() == s
