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
    assert cuda_kernels.launches == {
        cuda_kernels.ENCODE: 0, cuda_kernels.DECODE: 0
    }


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
