"""The port's order-0 byte histogram (``fq_hist256``, ``csrc/hist256.cu``)
against the JAX package's, on the CPU.

Seeded numpy streams go through ``cuda_kernels.hist256`` (a CPU tensor takes
its plain version, ``rans.hist256_plain``), ``np.bincount`` and the JAX
package's ``runtime.bindings.hist256`` (its C++ runtime, built on first
use); then the callers that build rANS tables and size estimates from it:
``pipeline/native.py:_rans_size_estimate`` on a view of the stream build's
buffer, ``parallel/mesh.py:entropy_table`` on per-device streams. All
comparisons are exact.
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
from torch_tokens_inputs import hist_edge_cases
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

CPU = torch.device("cpu")
HIST_CASES = hist_edge_cases()


def _view(buf: bytes, off: int, n: int) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(buf, np.uint8).copy())[off : off + n]


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_hist256_equals_bincount_and_the_jax_runtime(case):
    """Lengths 0, 1, 15, 16, 17 and past several CTAs, views at each offset
    1-15, one-symbol, 256-symbol and skewed streams: the wrapper's counts
    equal ``np.bincount`` and the JAX runtime's ``fq_hist256``."""
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
    assert tnative._rans_size_estimate(view) == jnative._rans_size_estimate(s[offset:])


@pytest.mark.parametrize("n,seed", [(1, 4), (300_000, 5)])
def test_rans_stream_table_from_the_histogram_equals_the_jax_package(n, seed):
    """``rans.encode_stream`` builds its table from the copy it encodes: the
    stream equals the JAX package's."""
    from fastqpacker_tpu.ops import rans as jrans

    rng = np.random.default_rng(seed)
    data = rng.choice(np.arange(20, dtype=np.uint8), size=n).astype(np.uint8)
    assert trans.encode_stream(data.tobytes(), device=CPU) == jrans.encode_stream(data.tobytes())


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
