"""Paired-end FASTQ interleaving and de-interleaving.

The port's copy of ``fastqpacker_tpu/utils/pairing.py``. The reference
defines ``FlagPairedEnd`` in its container format (container.go:14-17) but
never sets it; this module implements the feature: R1/R2 mate files are
interleaved record by record on compress (R1[0], R2[0], R1[1], R2[1], ...)
and split back into two files on decompress.

All splicing is whole-chunk vectorized: record extents come from one
newline scan, and the byte movement is a single varlen scatter per chunk
(numpy), with no per-record Python loop.
"""

from __future__ import annotations

from typing import BinaryIO

import numpy as np

from . import varlen

NEWLINE = 0x0A


class PairError(ValueError):
    """Mate files disagree (record counts) or stream is not pairable."""


ERR_COUNT_MISMATCH = "paired inputs have different record counts"
ERR_ODD_RECORDS = "paired container holds an odd number of records"


def _record_ends(data: np.ndarray) -> np.ndarray:
    """End offsets (exclusive) of complete 4-line records in ``data``."""
    nl = np.flatnonzero(data == NEWLINE)
    return nl[3::4] + 1


def _interleave_chunk(
    d1: np.ndarray, ends1: np.ndarray, d2: np.ndarray, ends2: np.ndarray,
    k: int,
) -> tuple[bytes, int, int]:
    """Interleave the first ``k`` records of each buffer.

    Returns (interleaved bytes, consumed1, consumed2).
    """
    cut1 = int(ends1[k - 1])
    cut2 = int(ends2[k - 1])
    lens1 = np.diff(ends1[:k], prepend=0)
    lens2 = np.diff(ends2[:k], prepend=0)
    lens = np.empty(2 * k, dtype=np.int64)
    lens[0::2] = lens1
    lens[1::2] = lens2
    dst = np.zeros(2 * k, dtype=np.int64)
    np.cumsum(lens[:-1], out=dst[1:])
    out = np.empty(cut1 + cut2, dtype=np.uint8)
    # One scatter: rows are consumed flat in [all R1 records, all R2
    # records] order and land at their interleaved destinations.
    varlen.scatter_rows(
        out,
        np.concatenate([d1[:cut1], d2[:cut2]]),
        np.concatenate([dst[0::2], dst[1::2]]),
        np.concatenate([lens1, lens2]),
    )
    return out.tobytes(), cut1, cut2


class InterleavedPairReader:
    """Read two FASTQ streams as one record-interleaved stream.

    Implements ``read()`` so it can feed any compress pipeline directly.
    Raises :class:`PairError` if the mate files end with different record
    counts. Trailing partial records are dropped on both sides (matching
    the single-file parser's treatment of truncated final records,
    parser.go:136-184).
    """

    def __init__(self, r1: BinaryIO, r2: BinaryIO, chunk_bytes: int = 8 << 20):
        self.r1 = r1
        self.r2 = r2
        self.chunk_bytes = chunk_bytes
        self._p1 = b""
        self._p2 = b""
        self._eof1 = False
        self._eof2 = False
        self._out = b""
        self._done = False

    def _fill(self, which: int) -> None:
        if which == 1 and not self._eof1:
            chunk = self.r1.read(self.chunk_bytes)
            if chunk:
                self._p1 += chunk
            else:
                self._eof1 = True
        elif which == 2 and not self._eof2:
            chunk = self.r2.read(self.chunk_bytes)
            if chunk:
                self._p2 += chunk
            else:
                self._eof2 = True

    def _produce(self) -> None:
        """Generate the next interleaved chunk into ``self._out``."""
        while not self._done:
            if not self._eof1 and len(self._p1) < self.chunk_bytes:
                self._fill(1)
                continue
            if not self._eof2 and len(self._p2) < self.chunk_bytes:
                self._fill(2)
                continue
            d1 = np.frombuffer(self._p1, dtype=np.uint8)
            d2 = np.frombuffer(self._p2, dtype=np.uint8)
            ends1 = _record_ends(d1)
            ends2 = _record_ends(d2)
            k = min(len(ends1), len(ends2))
            if k == 0:
                if self._eof1 and self._eof2:
                    if len(ends1) != len(ends2):
                        raise PairError(ERR_COUNT_MISMATCH)
                    self._done = True
                    return
                # one side stalled with a full buffer and no complete
                # record: grow its buffer
                if len(ends1) == 0 and not self._eof1:
                    self._fill(1)
                elif len(ends2) == 0 and not self._eof2:
                    self._fill(2)
                else:
                    # the zero-record side is at EOF but the other still
                    # has records
                    raise PairError(ERR_COUNT_MISMATCH)
                continue
            out, cut1, cut2 = _interleave_chunk(d1, ends1, d2, ends2, k)
            self._p1 = self._p1[cut1:]
            self._p2 = self._p2[cut2:]
            self._out += out
            return

    def read(self, n: int = -1) -> bytes:
        while not self._done and (n < 0 or len(self._out) < n):
            before = len(self._out)
            self._produce()
            if self._done and len(self._out) == before:
                break
        if n < 0 or n >= len(self._out):
            data, self._out = self._out, b""
            return data
        data, self._out = self._out[:n], self._out[n:]
        return data


class DeinterleavingWriter:
    """Split an interleaved FASTQ text stream into two mate writers.

    Records alternate R1/R2 by a global counter; byte movement is one
    varlen scatter per ``write`` call. ``close()`` validates that the
    stream ended on a mate boundary.
    """

    def __init__(self, w1: BinaryIO, w2: BinaryIO):
        self.w1 = w1
        self.w2 = w2
        self._buf = b""
        self._next_is_r2 = False
        self._counts = [0, 0]

    def write(self, data: bytes) -> int:
        self._buf += data
        arr = np.frombuffer(self._buf, dtype=np.uint8)
        ends = _record_ends(arr)
        m = len(ends)
        if m == 0:
            return len(data)
        cut = int(ends[m - 1])
        lens = np.diff(ends, prepend=0)
        parity = (np.arange(m) + int(self._next_is_r2)) % 2
        sel1 = parity == 0
        lens1 = lens[sel1]
        lens2 = lens[~sel1]
        total1 = int(lens1.sum())
        out = np.empty(cut, dtype=np.uint8)
        dst = np.empty(m, dtype=np.int64)
        dst[sel1] = np.cumsum(lens1) - lens1
        dst[~sel1] = total1 + np.cumsum(lens2) - lens2
        varlen.scatter_rows(out, arr[:cut], dst, lens)
        self.w1.write(out[:total1].tobytes())
        self.w2.write(out[total1:].tobytes())
        self._counts[0] += int(sel1.sum())
        self._counts[1] += m - int(sel1.sum())
        self._next_is_r2 = bool((int(self._next_is_r2) + m) % 2)
        self._buf = self._buf[cut:]
        return len(data)

    def close(self) -> None:
        if self._buf.strip() or self._counts[0] != self._counts[1]:
            raise PairError(ERR_ODD_RECORDS)
