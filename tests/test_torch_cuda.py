"""The port's CUDA kernels on the card (dense codec, order-0 rANS, CRC32):
kernel == plain version, and a GPU compress byte-identical to the CPU
compress, for FQZ v2 and v3.

Marked ``cuda``; each test skips when ``torch.cuda.is_available()`` is
False. On a machine with a card: ``python -m pytest tests/test_torch_cuda.py
-m cuda``. Comparisons are exact (integer codec, tolerance 0).
"""

import io
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu_torch.ops import crc32 as port_crc32
from fastqpacker_tpu_torch.ops import cuda_kernels
from fastqpacker_tpu_torch.ops import device as port_device
from fastqpacker_tpu_torch.ops import rans as port_rans
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
    counts = cuda_kernels.launches.as_dict()
    assert counts.pop(cuda_kernels.ENCODE) == counts.pop(cuda_kernels.DECODE) == 1
    assert not any(counts.values())


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


def _rans_inputs(rng, n, lanes, alphabet):
    data = rng.integers(0, alphabet, n).astype(np.uint8)
    steps = -(-n // lanes)
    hist = np.bincount(data, minlength=256).astype(np.int64)
    pad = int(np.argmax(hist))
    hist[pad] += steps * lanes - n
    freq = port_rans.normalize_freqs(hist)
    fc = np.stack([freq.astype(np.int32), port_rans.cumulative(freq).astype(np.int32)])
    return data, steps, pad, freq, fc


@pytest.mark.parametrize("lanes", [4, 32, 256, 2048, 4096, 8192, 16384])
@pytest.mark.parametrize("alphabet", [1, 40, 256])
def test_rans_kernels_match_plain(lanes, alphabet, cuda):
    """Encode, compact and decode against their plain versions, with a
    ragged last row, and decode(encode(x)) == x."""
    rng = np.random.default_rng(lanes + alphabet)
    n = 37 * lanes + lanes // 2 + 1
    data, steps, pad, freq, fc = _rans_inputs(rng, n, lanes, alphabet)
    d, t = torch.from_numpy(data).to(cuda), torch.from_numpy(fc).to(cuda)
    cuda_kernels.reset_launches()
    words, flags, states = cuda_kernels.rans_encode(d, steps, lanes, pad, t)
    pw, pf, ps = port_rans.rans_encode_plain(d, steps, lanes, pad, t)
    assert torch.equal(words, pw) and torch.equal(flags, pf) and torch.equal(states, ps)
    flat, total = cuda_kernels.rans_compact(words, flags)
    pflat, ptotal = port_rans.rans_compact_plain(words, flags)
    k = int(total)
    assert k == int(ptotal) and torch.equal(flat[:k], pflat[:k])
    tab = torch.from_numpy(port_rans.pack_slot_table(freq).view(np.int32)).to(cuda)
    stream = flat[:k].clone()
    out, consumed = cuda_kernels.rans_decode(stream, states, tab, steps, lanes)
    pout, pconsumed = port_rans.rans_decode_plain(stream, states, tab, steps, lanes)
    torch.cuda.synchronize()
    assert int(consumed) == int(pconsumed) == k
    assert torch.equal(out, pout)
    assert out[:n].cpu().numpy().tobytes() == data.tobytes()
    counts = cuda_kernels.launches.as_dict()
    assert [counts[x] for x in (cuda_kernels.RANS_ENCODE, cuda_kernels.RANS_COMPACT,
                                cuda_kernels.RANS_DECODE)] == [1, 1, 1]


def test_rans_decode_never_reads_past_a_short_word_buffer(cuda):
    """A stream that lost words: the kernel reads zeros, reports more
    words consumed than carried, and the stream API raises."""
    data = np.random.default_rng(1).integers(0, 30, 300_000).astype(np.uint8)
    good = port_rans.encode_stream(data, device=cuda)
    assert good == port_rans.encode_stream(data, device="cpu")
    assert port_rans.decode_stream(good, device=cuda) == data.tobytes()
    off = 8 + 512 + 4 * 256
    total = int.from_bytes(good[off : off + 4], "little")
    bad = good[:off] + (total - 100).to_bytes(4, "little") + good[off + 4 : -200]
    with pytest.raises(port_rans.RansError, match="corrupted rANS stream data"):
        port_rans.decode_stream(bad, device=cuda)


@pytest.mark.parametrize(
    "n", [1, 255, 256, 257, 1024, 16383, 16384, 16385, 1_000_003, 15_100_000]
)
def test_crc32_kernel_matches_zlib_and_plain(n, cuda):
    data = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    t = torch.from_numpy(data).to(cuda)
    got = cuda_kernels.crc32_chunks(t)
    torch.cuda.synchronize()
    assert int(got.item()) & 0xFFFFFFFF == zlib.crc32(data.tobytes())
    if n <= 1_000_003:
        assert torch.equal(got, port_crc32.crc32_chunks_plain(t))
    assert port_crc32.crc32_device(data, device=cuda) == zlib.crc32(data.tobytes())


def test_gpu_v3_compress_matches_cpu(cuda):
    """FQZ v3 on rANS-picking data: the card's container equals the CPU's,
    the qual stream of every block is TAG_RANS, and both decode."""
    data = synth_fastq(12, seed=5, qual_model="walk")
    opts = tfq.Options(version=3, block_size=20_000, workers=4)
    cuda_kernels.reset_launches()
    comp = tfq.compress_bytes(data, opts, device=cuda)
    counts = cuda_kernels.launches.as_dict()
    assert comp == tfq.compress_bytes(data, opts, device="cpu")
    r = io.BytesIO(comp)
    tfq.container.read_file_header(r)
    blocks = 0
    while (hdr := tfq.container.read_block_header(r, 3)) is not None:
        sizes = hdr.stream_sizes(2)
        payload = r.read(sum(sizes))
        assert payload[sizes[0]] == tfq.container.TAG_RANS
        blocks += 1
    assert counts[cuda_kernels.RANS_ENCODE] == counts[cuda_kernels.RANS_COMPACT] == blocks
    assert counts[cuda_kernels.ENCODE] == blocks and counts[cuda_kernels.CRC32] > 0
    cuda_kernels.reset_launches()
    assert tfq.decompress_bytes(comp, tfq.DecompressOptions(workers=4), device=cuda) == data
    assert cuda_kernels.launches[cuda_kernels.RANS_DECODE] == blocks
    assert cuda_kernels.launches[cuda_kernels.DECODE] == blocks
