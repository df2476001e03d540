"""The dense codec's CUDA kernels on the card: kernel == plain version,
and a GPU compress byte-identical to the CPU compress.

Marked ``cuda``; each test skips when ``torch.cuda.is_available()`` is
False. On a machine with a card: ``python -m pytest tests/test_torch_cuda.py
-m cuda``. Comparisons are exact (integer codec, tolerance 0).
"""

import sys
import threading

import numpy as np
import pytest
import torch

import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu_torch.ops import cuda_kernels
from fastqpacker_tpu_torch.ops import device as port_device
from fastqpacker_tpu_torch.utils.synth import synth_fastq

pytestmark = pytest.mark.cuda

SHAPES = [(8, 152), (16, 31), (4, 8), (300, 64), (3, 1), (3, 65544), (37500, 160)]
ALPHABET = b"ACGTNacgt.RY"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _block(rng, r, l):
    lengths = rng.integers(0, l + 1, size=r).astype(np.int32)
    lengths[1::4] = 0
    lengths[0] = l
    ab = np.frombuffer(ALPHABET, np.uint8)
    seq = ab[rng.integers(0, len(ab), size=(r, l))]
    qual = rng.integers(33, 105, size=(r, l)).astype(np.uint8)
    pad = np.arange(l)[None, :] >= lengths[:, None]
    seq[pad] = 0
    qual[pad] = 0xFF
    return seq, qual, lengths


@pytest.mark.parametrize("r,l", SHAPES)
@pytest.mark.parametrize("offset", [33, 64])
def test_kernels_match_plain(r, l, offset, cuda):
    rng = np.random.default_rng(r + l + offset)
    s, q, n = (torch.from_numpy(x).to(cuda) for x in _block(rng, r, l))
    cuda_kernels.reset_launches()
    got = cuda_kernels.encode_arrays(s, q, n, offset)
    want = port_device.encode_arrays_plain(s, q, n, offset)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    seq, qual = cuda_kernels.decode_arrays(want.packed, want.qual_delta, n, offset)
    seq_p, qual_p = port_device.decode_arrays_plain(
        want.packed, want.qual_delta, n, offset
    )
    torch.cuda.synchronize()
    assert torch.equal(seq, seq_p) and torch.equal(qual, qual_p)
    assert cuda_kernels.launches == {
        cuda_kernels.ENCODE: 1, cuda_kernels.DECODE: 1
    }


def test_gpu_compress_matches_cpu(cuda):
    data = synth_fastq(24, seed=3) + synth_fastq(4, read_len=300, min_len=50, seed=4)
    cuda_kernels.reset_launches()
    comp = tfq.compress_bytes(data, device=cuda)
    assert cuda_kernels.launches[cuda_kernels.ENCODE] >= 2
    assert comp == tfq.compress_bytes(data, device="cpu")
    assert tfq.decompress_bytes(comp, device=cuda) == data
    assert cuda_kernels.launches[cuda_kernels.DECODE] == (
        cuda_kernels.launches[cuda_kernels.ENCODE]
    )


def test_launch_counter_under_concurrent_launches(cuda):
    """Pipeline workers launch from many threads: no count is lost."""
    s = torch.zeros((64, 32), dtype=torch.uint8, device=cuda)
    n = torch.full((64,), 32, dtype=torch.int32, device=cuda)
    threads, per_thread = 16, 25
    cuda_kernels.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [
            threading.Thread(
                target=lambda: [cuda_kernels.encode_arrays(s, s, n, 33)
                                for _ in range(per_thread)]
            )
            for _ in range(threads)
        ]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize()
    assert cuda_kernels.launches[cuda_kernels.ENCODE] == threads * per_thread
