"""The port's dense block codec against the JAX package's.

The port's kernel wrappers run their plain PyTorch versions on CPU
tensors; the JAX side runs its XLA programs and its Pallas kernels in
interpret mode. The same seeded numpy inputs go to both, and every
comparison is exact (the codec is integer arithmetic: tolerance 0).
Quality deltas and decoded bytes are compared at positions < length, as
tests/test_pallas_kernels.py does; the rest in full.
"""

import numpy as np
import pytest
import torch

from fastqpacker_tpu.ops import device as jax_device
from fastqpacker_tpu.ops import pallas_kernels as jax_pallas
from fastqpacker_tpu.ops import reference as jax_ref
from fastqpacker_tpu_torch.ops import cuda_kernels
from fastqpacker_tpu_torch.ops import device as port_device
from fastqpacker_tpu_torch.ops import reference as port_ref

SHAPES = [(8, 152), (16, 31), (4, 8), (300, 64), (3, 1)]
ALPHABET = b"ACGTNacgt.RY"
SEQ_PAD, QUAL_PAD = 0x00, 0xFF


def random_block(rng, r, l, alphabet=ALPHABET):
    """Padded (seq, qual, lengths) with empty rows and one full row."""
    lengths = rng.integers(0, l + 1, size=r).astype(np.int32)
    lengths[1::4] = 0  # empty rows
    lengths[0] = l
    ab = np.frombuffer(alphabet, np.uint8)
    seq = ab[rng.integers(0, len(ab), size=(r, l))]
    qual = rng.integers(33, 105, size=(r, l)).astype(np.uint8)
    pad = np.arange(l)[None, :] >= lengths[:, None]
    seq[pad] = SEQ_PAD
    qual[pad] = QUAL_PAD
    return seq, qual, lengths


def _in_lengths(lengths, l):
    return np.arange(l)[None, :] < lengths[:, None]


def _assert_encode_equal(got, want, lengths):
    np.testing.assert_array_equal(got.packed, np.asarray(want.packed))
    np.testing.assert_array_equal(got.nmask_bits, np.asarray(want.nmask_bits))
    np.testing.assert_array_equal(got.n_counts, np.asarray(want.n_counts))
    mask = _in_lengths(lengths, got.qual_delta.shape[1])
    np.testing.assert_array_equal(
        got.qual_delta[mask], np.asarray(want.qual_delta)[mask]
    )


@pytest.mark.parametrize("r,l", SHAPES)
@pytest.mark.parametrize("offset", [33, 64])
def test_encode_matches_jax(r, l, offset):
    rng = np.random.default_rng(r * 1000 + l + offset)
    seq, qual, lengths = random_block(rng, r, l)
    got = port_device.encode_block_arrays(seq, qual, lengths, offset, device="cpu")
    assert got.packed.shape == (r, -(-l // 4))
    assert got.nmask_bits.shape == (r, -(-l // 8))
    assert got.n_counts.dtype == np.int32 and got.qual_delta.shape == (r, l)
    _assert_encode_equal(
        got, jax_device.encode_block_arrays(seq, qual, lengths, offset), lengths
    )
    _assert_encode_equal(
        got,
        jax_pallas.encode_block_arrays(
            seq.copy(), qual.copy(), lengths, offset, interpret=True
        ),
        lengths,
    )


@pytest.mark.parametrize("r,l", SHAPES)
@pytest.mark.parametrize("offset", [33, 64])
def test_decode_matches_jax(r, l, offset):
    rng = np.random.default_rng(r * 77 + l + offset)
    seq, qual, lengths = random_block(rng, r, l)
    enc = jax_ref.encode_block_arrays(seq, qual, lengths, offset)
    got_seq, got_qual = port_device.decode_block_arrays(
        enc.packed, enc.qual_delta, lengths, offset, device="cpu"
    )
    mask = _in_lengths(lengths, l)
    # decode restores the qualities and the ACGT bases (N restore and
    # case folding are the host's, as in every backend)
    np.testing.assert_array_equal(got_qual[mask], qual[mask])
    acgt = np.isin(seq, np.frombuffer(b"ACGT", np.uint8)) & mask
    np.testing.assert_array_equal(got_seq[acgt], seq[acgt])
    for want_seq, want_qual in (
        jax_device.decode_block_arrays(enc.packed, enc.qual_delta, lengths, offset),
        jax_pallas.decode_block_arrays(
            enc.packed, enc.qual_delta.copy(), lengths, offset, interpret=True
        ),
    ):
        np.testing.assert_array_equal(got_seq[mask], np.asarray(want_seq)[mask])
        np.testing.assert_array_equal(got_qual[mask], np.asarray(want_qual)[mask])


def test_long_read_n_cap_and_overflow_guard():
    """L = 65,544: an N past position 65,536 sets no mask bit and no count
    in either package, and both overflow guards reject it verbatim."""
    rng = np.random.default_rng(65544)
    r, l = 3, 65544
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(r, l))]
    qual = rng.integers(33, 75, size=(r, l)).astype(np.uint8)
    lengths = np.array([l, l, 100], dtype=np.int32)
    seq[0, 70] = ord("N")
    seq[1, 65540] = ord("N")  # past the cap
    seq[2, 100:] = SEQ_PAD
    qual[2, 100:] = QUAL_PAD

    got = port_device.encode_block_arrays(seq, qual, lengths, 33, device="cpu")
    assert list(got.n_counts) == [1, 0, 0]
    _assert_encode_equal(
        got, jax_device.encode_block_arrays(seq, qual, lengths, 33), lengths
    )
    _assert_encode_equal(
        got,
        jax_pallas.encode_block_arrays(
            seq.copy(), qual.copy(), lengths, 33, interpret=True
        ),
        lengths,
    )

    with pytest.raises(ValueError) as want:
        jax_ref.check_ambiguous_overflow(seq, lengths)
    with pytest.raises(ValueError) as got_err:
        port_ref.check_ambiguous_overflow(seq, lengths)
    assert str(got_err.value) == str(want.value)
    assert "beyond position 65536" in str(got_err.value)


def test_cpu_path_leaves_launch_counters_at_zero():
    cuda_kernels.reset_launches()
    rng = np.random.default_rng(5)
    seq, qual, lengths = random_block(rng, 64, 160)
    enc = port_device.encode_block_arrays(seq, qual, lengths, 33, device="cpu")
    port_device.decode_block_arrays(
        enc.packed, enc.qual_delta, lengths, 33, device="cpu"
    )
    counts = cuda_kernels.launches.as_dict()
    assert set(counts) >= {cuda_kernels.ENCODE, cuda_kernels.DECODE}
    assert not any(counts.values())


def test_launch_counters_are_thread_safe():
    """Pipeline workers launch from many threads: bumps from more threads
    than cores, with a short switch interval, lose no count, and a reset
    between two rounds starts again from zero."""
    import sys
    import threading

    counts = cuda_kernels.LaunchCounts(["a", "b"])
    threads, per_thread = 16, 2000

    def work():
        for i in range(per_thread):
            counts.bump("a" if i % 2 else "b")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(2):
            counts.reset()
            workers = [threading.Thread(target=work) for _ in range(threads)]
            for t in workers:
                t.start()
            for t in workers:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in workers)
            assert counts.as_dict() == {
                "a": threads * per_thread // 2, "b": threads * per_thread // 2
            }
    finally:
        sys.setswitchinterval(old)
    assert counts["a"] + counts["b"] == threads * per_thread
    # the module's own counters are of this type, one per exported kernel
    assert isinstance(cuda_kernels.launches, cuda_kernels.LaunchCounts)
    assert set(cuda_kernels.launches.as_dict()) == {
        cuda_kernels.ENCODE, cuda_kernels.DECODE, cuda_kernels.RANS_ENCODE,
        cuda_kernels.RANS_COMPACT, cuda_kernels.RANS_DECODE, cuda_kernels.CRC32,
        cuda_kernels.WCTX_ENCODE, cuda_kernels.WCTX_DECODE,
        cuda_kernels.RECORDS_SCAN, cuda_kernels.ROWS_GATHER, cuda_kernels.STREAMS_BUILD,
        cuda_kernels.FASTQ_ASSEMBLE, cuda_kernels.QCTX_PREPARE, cuda_kernels.SCTX_PREPARE,
        cuda_kernels.WCTX_LAYOUT, cuda_kernels.WCTX_UNLAYOUT, cuda_kernels.HIST256,
        cuda_kernels.TOK_ENCODE, cuda_kernels.TOK_DECODE, cuda_kernels.QCTX_ENCODE,
        cuda_kernels.QCTX_DECODE, cuda_kernels.SCTX_ENCODE, cuda_kernels.SCTX_DECODE,
    }


@pytest.mark.parametrize("cap", [None, 100, port_ref.NPOS_CAP_WIDE])
def test_npos_cap_matches_jax(cap):
    """The tracking cap of the ambiguity mask: the v1/v2 default, a small
    one, and none (FQZ v3's u32 positions) on a read longer than 65,536."""
    rng = np.random.default_rng(7)
    r, l = 2, 65600
    seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, size=(r, l))]
    qual = rng.integers(33, 75, size=(r, l)).astype(np.uint8)
    lengths = np.array([l, 65000], dtype=np.int32)
    seq[1, 65000:] = SEQ_PAD
    qual[1, 65000:] = QUAL_PAD
    kw = {} if cap is None else {"npos_cap": cap}
    got = port_device.encode_block_arrays(seq, qual, lengths, 33, device="cpu", **kw)
    want = jax_ref.encode_block_arrays(seq, qual, lengths, 33, **kw)
    _assert_encode_equal(got, want, lengths)
    assert np.array_equal(
        np.unpackbits(got.nmask_bits, axis=1, bitorder="little", count=l),
        port_ref.ambiguity_mask(seq, lengths, **kw),
    )


def test_wrappers_refuse_other_devices_and_bad_inputs():
    """A tensor that is neither on the CPU nor on a card is refused, not
    computed some other way; so are wrong types and shapes."""
    meta = torch.empty((4, 32), dtype=torch.uint8, device="meta")
    lens = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kernels.encode_arrays(meta, meta, lens, 33)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kernels.decode_arrays(meta[:, :8].contiguous(), meta, lens, 33)

    seq = torch.zeros((4, 32), dtype=torch.uint8)
    with pytest.raises(TypeError):
        cuda_kernels.encode_arrays(seq, seq.to(torch.int32), torch.zeros(4, dtype=torch.int32), 33)
    with pytest.raises(ValueError, match="shape"):
        cuda_kernels.encode_arrays(seq, seq[:3], torch.zeros(4, dtype=torch.int32), 33)
    with pytest.raises(ValueError, match="packed"):
        cuda_kernels.decode_arrays(seq[:, :7], seq, torch.zeros(4, dtype=torch.int32), 33)


# ragged tiles and odd lengths: R and L not multiples of 16
EXACT_SHAPES = [(r, l) for r in (1, 15, 17, 33) for l in (1, 31, 151, 321)]


@pytest.mark.parametrize("r,l", EXACT_SHAPES)
def test_exact_widths_match_jax(r, l):
    """The wrapper at R and L that are not multiples of 16: its outputs
    are contiguous at their exact widths and equal the JAX package's
    (XLA programs, and the Pallas kernels in interpret mode); the decode
    restores the block from them."""
    rng = np.random.default_rng(r * 131 + l)
    seq, qual, lengths = random_block(rng, r, l)
    s, q, n = (torch.from_numpy(x) for x in (seq, qual, lengths))
    enc = cuda_kernels.encode_arrays(s, q, n, 33)
    widths = ((r, -(-l // 4)), (r, -(-l // 8)), (r,), (r, l))
    for x, w in zip(enc, widths):
        assert x.is_contiguous() and tuple(x.shape) == w
    got = port_ref.EncodedArrays(*(x.numpy() for x in enc))
    _assert_encode_equal(got, jax_device.encode_block_arrays(seq, qual, lengths, 33), lengths)
    _assert_encode_equal(
        got,
        jax_pallas.encode_block_arrays(seq.copy(), qual.copy(), lengths, 33, interpret=True),
        lengths,
    )
    dec_seq, dec_qual = cuda_kernels.decode_arrays(enc.packed, enc.qual_delta, n, 33)
    assert dec_seq.is_contiguous() and dec_qual.is_contiguous()
    assert tuple(dec_seq.shape) == tuple(dec_qual.shape) == (r, l)
    want_seq, want_qual = jax_device.decode_block_arrays(
        got.packed, got.qual_delta, lengths, 33)
    mask = _in_lengths(lengths, l)
    np.testing.assert_array_equal(dec_seq.numpy()[mask], np.asarray(want_seq)[mask])
    np.testing.assert_array_equal(dec_qual.numpy()[mask], np.asarray(want_qual)[mask])
    np.testing.assert_array_equal(dec_qual.numpy()[mask], qual[mask])


@pytest.mark.parametrize("extra", [1, 3, 16])
def test_decode_takes_a_packed_matrix_wider_than_needed(extra):
    """``decode_arrays`` reads ceil(L/4) columns of a wider packed matrix
    (its row pitch); the columns past them change nothing."""
    rng = np.random.default_rng(extra)
    r, l = 17, 151
    seq, qual, lengths = random_block(rng, r, l)
    enc = jax_ref.encode_block_arrays(seq, qual, lengths, 33)
    junk = rng.integers(0, 256, size=(r, extra)).astype(np.uint8)
    wide = np.concatenate([enc.packed, junk], axis=1)
    n = torch.from_numpy(lengths)
    got_seq, got_qual = cuda_kernels.decode_arrays(
        torch.from_numpy(wide), torch.from_numpy(enc.qual_delta), n, 33)
    assert tuple(got_seq.shape) == (r, l) and got_seq.is_contiguous()
    want_seq, want_qual = jax_device.decode_block_arrays(enc.packed, enc.qual_delta, lengths, 33)
    mask = _in_lengths(lengths, l)
    np.testing.assert_array_equal(got_seq.numpy()[mask], np.asarray(want_seq)[mask])
    np.testing.assert_array_equal(got_qual.numpy()[mask], np.asarray(want_qual)[mask])
    np.testing.assert_array_equal(got_qual.numpy()[mask], qual[mask])
