"""The port's chunk-parallel CRC32 against zlib and the JAX package's.

``fastqpacker_tpu_torch.ops.crc32`` on ``device="cpu"`` runs the plain
PyTorch version of the kernel (per-chunk raw table CRC, a binary tree of
constant GF(2) shifts, the finish constants). It must equal ``zlib.crc32``
at every length, ``fastqpacker_tpu.ops.crc32.crc32_device`` (the XLA lane
program + host combine), and the two packages' combines must agree. Exact.
"""

import zlib

import numpy as np
import pytest
import torch

from fastqpacker_tpu.ops import crc32 as jcrc
from fastqpacker_tpu_torch.ops import crc32 as tcrc
from fastqpacker_tpu_torch.ops import cuda_kernels
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

C = tcrc.CHUNK
M = tcrc.MIN_DEVICE_BYTES
W = 32 * C  # a warp's chunks
S = tcrc.CTA_CHUNKS * C  # a CTA's span
# lengths at chunk, warp and span edges, and past several spans
EDGES = [3 * C + 17, W - 1, W, W + 1, S - 1, S, S + 1, 2 * S + W + 3, 9 * S - 5]


def _bytes(n, seed=0):
    return np.random.default_rng(seed + n).integers(0, 256, n).astype(np.uint8)


def _kernel_crc(data: np.ndarray) -> int:
    return int(cuda_kernels.crc32_chunks(torch.from_numpy(data)).item()) & 0xFFFFFFFF


@pytest.mark.parametrize(
    "n", [1, 2, 15, 16, 17, C - 1, C, C + 1, 2 * C, 3 * C + 5, M - 1, M, M + 1,
          5000, 100_003, 250_007, (1 << 20) + 3, *EDGES]
)
def test_chunk_program_equals_zlib(n):
    """The device program itself (no size rule), below one chunk, at
    chunk edges and with a ragged last chunk."""
    data = _bytes(n)
    assert _kernel_crc(data) == zlib.crc32(data.tobytes())


@pytest.mark.parametrize("n", [0, 1, M - 1, M, M + 1, 250_000])
def test_crc32_device_equals_zlib(n):
    data = _bytes(n, seed=7)
    assert tcrc.crc32_device(data, device="cpu") == zlib.crc32(data.tobytes())
    assert tcrc.crc32_device(data.tobytes(), device="cpu") == zlib.crc32(data.tobytes())


@pytest.mark.parametrize("n", [M, 40_001, *[e for e in EDGES if e >= M]])
def test_equals_jax_crc32_device(n):
    data = _bytes(n, seed=3)
    assert tcrc.crc32_device(data, device="cpu") == jcrc.crc32_device(data)


def test_quality_stream_size():
    """The main path's largest stream: 100,000 records x 151 qualities."""
    data = _bytes(15_100_000, seed=1)
    assert tcrc.crc32_device(data, device="cpu") == zlib.crc32(data.tobytes())


@pytest.mark.parametrize("chunk", [16, 64, 4096])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000])
def test_plain_version_at_other_chunk_sizes(chunk, n):
    data = _bytes(n, seed=chunk)
    got = int(tcrc.crc32_chunks_plain(torch.from_numpy(data), chunk).item())
    assert got & 0xFFFFFFFF == zlib.crc32(data.tobytes())


@pytest.mark.parametrize("la,lb", [(0, 5), (5, 0), (1, 1), (777, 12_345), (70_000, 3)])
def test_combine_matches_jax_and_zlib(la, lb):
    a, b = _bytes(la, 1).tobytes(), _bytes(lb, 2).tobytes()
    ca, cb = zlib.crc32(a), zlib.crc32(b)
    got = tcrc.crc32_combine(ca, cb, lb)
    assert got == zlib.crc32(a + b)
    assert got == jcrc.crc32_combine(ca, cb, lb)


def test_tensor_gf2_arithmetic_matches_the_integer_version():
    rng = np.random.default_rng(4)
    a = rng.integers(1, 1 << 32, 50, dtype=np.int64)
    b = rng.integers(0, 1 << 32, 50, dtype=np.int64)
    got = tcrc._multmodp_t(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert [int(v) for v in got] == [
        tcrc._multmodp(int(x), int(y)) for x, y in zip(a, b)
    ]
    # x^-1 inverts x: the finish takes out exactly the zeros that filled
    # the last chunk, however many
    for t in (0, 1, 7, C - 1, 4096, 15_100_000, (1 << 40) + 9):
        unshift, _ = tcrc.finish_constants(10, 10 + t)
        for v in (1, 0x80000000, 0xDEADBEEF):
            assert tcrc._multmodp(unshift, tcrc._multmodp(tcrc._x8n_modp(t), v)) == v


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="empty"):
        cuda_kernels.crc32_chunks(torch.zeros(0, dtype=torch.uint8))
    with pytest.raises(TypeError):
        cuda_kernels.crc32_chunks(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        cuda_kernels.crc32_chunks(torch.zeros((2, 2), dtype=torch.uint8))
