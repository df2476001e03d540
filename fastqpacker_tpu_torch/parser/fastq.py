"""Vectorized FASTQ parsing into device-friendly record blocks.

The numpy path of ``fastqpacker_tpu/parser/fastq.py``: newline positions
are found with whole-buffer numpy scans, lines are validated in bulk, and
sequence/quality bytes land in padded ``(records, max_len)`` matrices ready
for the device.

Behavioral contract matched to the Go reference (parser.go):

- Lines split on ``\\n``; a trailing ``\\r`` is stripped (parser.go:213-214).
- Record = 4 lines: header starting ``@`` (stripped), sequence, separator
  starting ``+`` (payload kept, ``+`` stripped), quality
  (parser.go:61-106); ``len(seq) == len(qual)`` enforced (parser.go:179).
- Error messages match parser.go:70,88,180 verbatim.
- A trailing record whose lines end before the 4th newline is dropped, but
  its *complete* lines are still validated (parser.go:136-184).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, Iterator

import numpy as np

from ..utils import varlen

NEWLINE = 0x0A
CR = 0x0D

ERR_HEADER = "invalid FASTQ: header line must start with @"
ERR_PLUS = "invalid FASTQ: separator line must start with +"
ERR_LEN_MISMATCH = "invalid FASTQ: sequence and quality lengths must match"

# Quality padding byte: 0xFF never appears in valid Phred data and keeps
# masked minima correct during encoding detection.
QUAL_PAD = 0xFF
SEQ_PAD = 0x00  # packs to code 0 ('A'); never emitted thanks to length masks


class FastqParseError(ValueError):
    pass


@dataclass
class RecordBlock:
    """A block of parsed FASTQ records in dense layout.

    ``seq``/``qual`` are ``(n, max_len)`` uint8 padded matrices and
    ``lengths`` the per-record sequence lengths. Headers and plus-line
    payloads stay on host as raw byte runs referenced into ``text``.
    """

    n: int
    seq: np.ndarray
    qual: np.ndarray
    lengths: np.ndarray
    text: np.ndarray
    header_starts: np.ndarray
    header_lengths: np.ndarray
    plus_starts: np.ndarray
    plus_lengths: np.ndarray

    @property
    def max_len(self) -> int:
        return int(self.lengths.max()) if self.n else 0

    def header_stream(self) -> bytes:
        """u16 length-prefixed header stream (compress.go:514-515)."""
        return varlen.build_len16_stream(
            self.text, self.header_starts, self.header_lengths
        )

    def plus_stream(self) -> bytes:
        """u16 length-prefixed plus-line payload stream (compress.go:518-519)."""
        return varlen.build_len16_stream(
            self.text, self.plus_starts, self.plus_lengths
        )

    def record(self, i: int) -> tuple[bytes, bytes, bytes, bytes]:
        """(header, sequence, plus, quality) bytes of record i."""
        ln = int(self.lengths[i])
        h, p = int(self.header_starts[i]), int(self.plus_starts[i])
        return (
            self.text[h : h + int(self.header_lengths[i])].tobytes(),
            self.seq[i, :ln].tobytes(),
            self.text[p : p + int(self.plus_lengths[i])].tobytes(),
            self.qual[i, :ln].tobytes(),
        )


def _line_bounds(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Start/end (exclusive, CR-stripped) offsets of complete lines."""
    nl = np.flatnonzero(data == NEWLINE)
    starts = np.empty_like(nl)
    if len(nl):
        starts[0] = 0
        starts[1:] = nl[:-1] + 1
    ends = nl.copy()
    if len(nl):
        has_cr = (ends > starts) & (data[np.maximum(ends - 1, 0)] == CR)
        ends[has_cr] -= 1
    return starts, ends


def _records_from_lines(
    data: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    n: int,
    leftover_check: bool = True,
) -> RecordBlock:
    lens = ends - starts

    h_idx = np.arange(n) * 4
    s_idx = h_idx + 1
    p_idx = h_idx + 2
    q_idx = h_idx + 3

    hdr_ok = (lens[h_idx] > 0) & (data[starts[h_idx]] == ord("@")) if n else np.empty(0, bool)
    plus_ok = (lens[p_idx] > 0) & (data[starts[p_idx]] == ord("+")) if n else np.empty(0, bool)
    len_ok = lens[s_idx] == lens[q_idx] if n else np.empty(0, bool)

    if n and not (hdr_ok.all() and plus_ok.all() and len_ok.all()):
        # Report the error the reference would hit first: the failing check
        # at the lowest line number (header @ line 4i, plus @ 4i+2,
        # mismatch detected after line 4i+3).
        bad_hdr = np.flatnonzero(~hdr_ok)
        bad_plus = np.flatnonzero(~plus_ok)
        bad_len = np.flatnonzero(~len_ok)
        cands = []
        if len(bad_hdr):
            cands.append((bad_hdr[0] * 4 + 0, ERR_HEADER))
        if len(bad_plus):
            cands.append((bad_plus[0] * 4 + 2, ERR_PLUS))
        if len(bad_len):
            cands.append((bad_len[0] * 4 + 3, ERR_LEN_MISMATCH))
        cands.sort()
        raise FastqParseError(cands[0][1])

    if leftover_check:
        _validate_leftover_lines(data, starts, ends, n)

    seq_starts = starts[s_idx] if n else np.empty(0, np.int64)
    seq_lens = lens[s_idx] if n else np.empty(0, np.int64)
    qual_starts = starts[q_idx] if n else np.empty(0, np.int64)

    return RecordBlock(
        n=n,
        seq=varlen.gather_rows(data, seq_starts, seq_lens, fill=SEQ_PAD),
        qual=varlen.gather_rows(data, qual_starts, seq_lens, fill=QUAL_PAD),
        lengths=seq_lens.astype(np.int32),
        text=data,
        header_starts=(starts[h_idx] + 1) if n else np.empty(0, np.int64),
        header_lengths=(lens[h_idx] - 1) if n else np.empty(0, np.int64),
        plus_starts=(starts[p_idx] + 1) if n else np.empty(0, np.int64),
        plus_lengths=(lens[p_idx] - 1) if n else np.empty(0, np.int64),
    )


def _validate_leftover_lines(
    data: np.ndarray, starts: np.ndarray, ends: np.ndarray, n: int
) -> None:
    """Validate complete lines of a trailing partial record.

    The reference reads these lines before hitting EOF, so their structural
    checks still fire even though the record is dropped (parser.go:136-168).
    Unterminated trailing bytes (no final newline) are never validated.
    """
    total = len(starts)
    extra = total - n * 4
    if extra >= 1:
        i = n * 4
        if ends[i] == starts[i] or data[starts[i]] != ord("@"):
            raise FastqParseError(ERR_HEADER)
    if extra >= 3:
        i = n * 4 + 2
        if ends[i] == starts[i] or data[starts[i]] != ord("+"):
            raise FastqParseError(ERR_PLUS)


class FastqStreamParser:
    """Streaming block parser: yields :class:`RecordBlock` of ``block_size``
    records from chunked reads (the reference's producer goroutine and
    record batches, compress.go:303-363)."""

    def __init__(
        self,
        reader: BinaryIO,
        block_size: int = 100000,
        chunk_bytes: int = 8 << 20,
    ):
        self.reader = reader
        self.block_size = block_size
        self.chunk_bytes = chunk_bytes
        self._pending = b""
        self._eof = False

    def _read_more(self) -> bool:
        chunk = self.reader.read(self.chunk_bytes)
        if not chunk:
            self._eof = True
            return False
        self._pending += chunk
        return True

    def blocks(self) -> Iterator[RecordBlock]:
        lines_needed = self.block_size * 4
        while True:
            data = np.frombuffer(self._pending, dtype=np.uint8)
            nl_count = int((data == NEWLINE).sum()) if len(data) else 0
            if nl_count < lines_needed and not self._eof:
                if self._read_more():
                    continue
            if len(data) == 0:
                return
            nl = np.flatnonzero(data == NEWLINE)
            n_complete = len(nl) // 4
            n_take = min(n_complete, self.block_size)
            if n_take == 0:
                if self._eof:
                    # Partial record at EOF: validate complete lines, drop.
                    starts, ends = _line_bounds(data)
                    _validate_leftover_lines(data, starts, ends, 0)
                    return
                self._read_more()
                continue
            cut = int(nl[n_take * 4 - 1]) + 1
            is_tail = self._eof and n_take * 4 == len(nl)
            if is_tail:
                starts, ends = _line_bounds(data)
                yield _records_from_lines(
                    data, starts, ends, n_take, leftover_check=True
                )
                return
            block_data = data[:cut].copy()
            starts, ends = _line_bounds(block_data)
            block = _records_from_lines(
                block_data, starts, ends, n_take, leftover_check=False
            )
            self._pending = data[cut:].tobytes()
            yield block
            if self._eof and not self._pending:
                return

