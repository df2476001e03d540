"""Codec constants and host-side semantics shared by every backend.

The port's copy of the parts of ``fastqpacker_tpu/ops/reference.py`` its
path needs. Wire semantics (Go reference, internal/encoder):

- 2-bit base packing A=00 C=01 G=10 T=11, 4 bases/byte LSB-first,
  case-insensitive, every non-ACGT byte packs as A with its position
  recorded separately (sequence.go:58-98).
- N-position tracking capped at ``MAX_SEQUENCE_LENGTH`` = 65536
  (sequence.go:11, compress.go:477-488).
- Quality: subtract Phred offset then per-record byte-wrapping delta
  (quality.go:53-103).

The dense transforms themselves are ``ops/device.py`` (plain PyTorch) and
``ops/cuda_kernels.py`` (the Hopper kernels).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_SEQUENCE_LENGTH = 1 << 16  # 65536 (sequence.go:11)
# FQZ v3 tracks N positions as u32: no cap short of a row's width (an int32)
NPOS_CAP_WIDE = (1 << 31) - 1

PHRED33_OFFSET = 33
PHRED64_OFFSET = 64

_A, _C, _G, _T = ord("A"), ord("C"), ord("G"), ord("T")


@dataclass
class EncodedArrays:
    """Dense per-block encode results as host arrays."""

    packed: np.ndarray  # (R, ceil(L/4)) uint8, 2-bit codes LSB-first
    nmask_bits: np.ndarray  # (R, ceil(L/8)) uint8, little-endian bitmask of non-ACGT
    n_counts: np.ndarray  # (R,) int32 count of non-ACGT positions (capped at 65536)
    qual_delta: np.ndarray  # (R, L) uint8 normalized+delta quality


def ambiguity_mask(
    seq: np.ndarray, lengths: np.ndarray, npos_cap: int = MAX_SEQUENCE_LENGTH
) -> np.ndarray:
    """True where the byte is not ACGT/acgt, within the record length and
    below the tracking cap (sequence.go:89-96; v3 passes
    :data:`NPOS_CAP_WIDE`)."""
    upper = seq & 0xDF
    valid = (upper == _A) | (upper == _C) | (upper == _G) | (upper == _T)
    col = np.arange(seq.shape[1], dtype=np.int64)[None, :]
    in_range = col < lengths[:, None].astype(np.int64)
    return (~valid) & in_range & (col < npos_cap)


def detect_offset_from_min(m: int) -> int:
    """Phred offset from the window's minimum quality byte
    (quality.go:22-49 thresholds): < 59 -> +33, >= 64 -> +64,
    ambiguous 59-63 -> +33."""
    if m < 59:
        return PHRED33_OFFSET
    if m >= 64:
        return PHRED64_OFFSET
    return PHRED33_OFFSET


def check_ambiguous_overflow(
    seq: np.ndarray, lengths: np.ndarray, headers: list[bytes] | None = None
) -> None:
    """Fail-fast guard against silent N loss on very long reads.

    Mirrors compress.go:477-488: a record longer than 65536 bp whose tail
    contains any non-ACGT byte cannot be represented (u16 N positions) and
    must be rejected rather than silently corrupted.
    """
    L = seq.shape[1]
    if L <= MAX_SEQUENCE_LENGTH:
        return
    upper = seq[:, MAX_SEQUENCE_LENGTH:] & 0xDF
    valid = (upper == _A) | (upper == _C) | (upper == _G) | (upper == _T)
    col = np.arange(MAX_SEQUENCE_LENGTH, L, dtype=np.int64)[None, :]
    in_range = col < lengths[:, None].astype(np.int64)
    bad = (~valid) & in_range
    if bad.any():
        row = int(np.flatnonzero(bad.any(axis=1))[0])
        name = headers[row].decode("latin-1") if headers else f"record {row}"
        raise ambiguous_overflow_error(name, int(lengths[row]))


def ambiguous_overflow_error(name: str, length: int) -> ValueError:
    """The reference's error for a record of ``length`` bp with a non-ACGT
    byte past the u16 N-position cap."""
    return ValueError(
        f'record "{name}": sequence length {length} has '
        f"ambiguous bases beyond position {MAX_SEQUENCE_LENGTH}; "
        f"N-position tracking is limited to {MAX_SEQUENCE_LENGTH} bp"
    )
