"""Coverage-redundancy sequence candidate (FQZ v3 ``TAG_SLDM``).

Real sequencing runs sample the same genome many times over: any two
reads covering the same locus share a long exact substring (up to one
sequencing error). Neither of the existing sequence candidates can see
that redundancy —

- the 2-bit pack + zstd path (the reference's design, sequence.go:58-137
  + compress.go:523-528) hides matches from zstd's byte-granular search
  unless the two reads happen to align mod 4 within their packed rows,
  and level-1's window/search misses most of what remains;
- the order-k context model (ops/seqctx.py) is capped at k=6, far below
  the ~constant-entropy context length of a genome.

This candidate instead codes the block's bases *unpacked* (one code
byte per base, records concatenated — the same symbol order as
ops/seqctx.py) with zstd long-distance matching tuned for read overlap
(entropy/zstd.py: window 2^25, min-match 16, LDM hash 2^24, rate 2^2).
On genome-sampled reads (15x coverage of a 2 Mb genome) it measures
0.54 bits/base where packed+zstd floors at 1.89 — within 11% of
zstd-19 on the raw text.

Redundancy is block-local: a 15 Mbase block of a human-scale WGS run
re-covers almost nothing of itself, while small genomes, amplicons and
RNA-seq re-cover heavily. The encoder therefore gates the candidate on
a sampled 16-mer duplicate probe (:func:`coverage_probe`) in the
default pipeline, and always measures it under ``--max-ratio``; either
way the pick is by measured output size.

The decode transform (codes -> packed rows, zero padding bits) must be
byte-identical to the wire's packed layout — the block CRC32 covers the
packed stream. This is the port's copy of the numpy paths of
``fastqpacker_tpu/ops/sldm.py``.
"""

from __future__ import annotations

import numpy as np

from ..entropy import zstd as zstd_entropy
from . import seqctx

# Sampled 16-mer duplicate-fraction gate for the default pipeline. A
# 16-mer is exactly 4 packed bytes, so sampling u32 windows from the
# packed stream costs no unpacking; two overlapping reads collide only
# when their genome offsets agree mod 4 (1/4 of overlaps), which still
# leaves coverage>=2 data orders of magnitude above the IID floor
# (~2.5% at 15x vs ~0.001% on random DNA).
PROBE_TARGET_SAMPLES = 1 << 16
PROBE_MIN_SAMPLES = 1 << 12
DUP_THRESHOLD = 0.002

# Cross-block dictionary: block 0's first DICT_BYTES of
# unpacked codes, stored once in the container (FLAG_SEQ_DICT) and
# referenced as an LDM prefix by every TAG_SLDM stream — coverage
# matches then cross block boundaries (the per-block window forfeited
# them). 8 MB of prefix + a 15 MB block stays under the 2^25 match
# window.
DICT_BYTES = 8 << 20


class SldmError(ValueError):
    pass


def coverage_probe(packed: np.ndarray) -> float:
    """Duplicate fraction among sampled u32 (16-base) windows of the
    packed stream; ~0 on coverage-free data. Returns 0.0 when the
    stream is too small to sample meaningfully."""
    n = len(packed) - 4
    if n < 4 * PROBE_MIN_SAMPLES:
        return 0.0
    stride = max(4, n // PROBE_TARGET_SAMPLES)
    offs = np.arange(0, n, stride, dtype=np.int64)
    words = (
        packed[offs].astype(np.uint32)
        | (packed[offs + 1].astype(np.uint32) << 8)
        | (packed[offs + 2].astype(np.uint32) << 16)
        | (packed[offs + 3].astype(np.uint32) << 24)
    )
    distinct = len(np.unique(words))
    return 1.0 - distinct / len(words)


def unpack(packed: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Flat packed stream -> flat base codes (one byte per base)."""
    try:
        return seqctx.unpack_stream(packed, lengths)
    except seqctx.SctxError as e:
        raise SldmError(str(e)) from None


def pack(bases: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Flat base codes -> flat packed stream, zero padding bits."""
    return seqctx.pack_stream(bases & 3, lengths)


def _ldm_codec() -> zstd_entropy.ZstdCodec:
    return zstd_entropy.ZstdCodec(level=1, ldm=True)


def encode(
    packed: np.ndarray, lengths: np.ndarray, prefix: np.ndarray | None = None
) -> bytes:
    """TAG_SLDM payload: one zstd-LDM frame over the unpacked codes,
    optionally matched against the container dictionary ``prefix``."""
    bases = unpack(packed, lengths)
    return _ldm_codec().compress(bases, prefix=prefix)


def encode_bases(
    bases: np.ndarray, prefix: np.ndarray | None = None
) -> bytes:
    """As :func:`encode` but from already-unpacked codes (the encoder
    reuses the sctx candidate's prepare output when it ran)."""
    return _ldm_codec().compress(np.ascontiguousarray(bases), prefix=prefix)


def decode(
    payload: bytes,
    lengths: np.ndarray,
    prefix: np.ndarray | None = None,
) -> bytes:
    """TAG_SLDM payload -> packed seq stream bytes (wire layout)."""
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    try:
        raw = zstd_entropy.get_codec().decompress(
            payload, expected_size=total, prefix=prefix
        )
    except zstd_entropy.ZstdError as e:
        raise SldmError(f"corrupted sldm sequence data: {e}") from None
    if len(raw) != total:
        raise SldmError("sldm sequence data does not match lengths")
    bases = np.frombuffer(raw, np.uint8)
    return pack(bases, lengths).tobytes()


def build_dict(packed: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Container dictionary: block 0's first DICT_BYTES unpacked codes."""
    codes = unpack(packed, lengths)
    return np.ascontiguousarray(codes[:DICT_BYTES]).copy()


def compress_dict(codes: np.ndarray) -> bytes:
    """Dictionary section payload: one self-contained zstd-LDM frame."""
    return _ldm_codec().compress(codes)


def decompress_dict(comp: bytes, raw_len: int) -> np.ndarray:
    try:
        raw = zstd_entropy.get_codec().decompress(
            comp, expected_size=raw_len
        )
    except zstd_entropy.ZstdError as e:
        raise SldmError(
            f"corrupted sequence dictionary: {e}"
        ) from None
    if len(raw) != raw_len:
        raise SldmError("sequence dictionary does not match declared size")
    return np.frombuffer(raw, np.uint8)
