"""FASTQ parsing into record blocks, scanned on the block's device.

The port of ``fastqpacker_tpu/parser/fastq.py``. The JAX package scans
records with its C++ runtime (``fq_scan_records_ex``); here the text of a
block goes to its device in one copy and :func:`..ops.cuda_kernels.records_scan`
(``csrc/records.cu``, or its plain PyTorch version on the CPU) finds every
record there. One synchronisation a block brings back the record count,
the bytes consumed, the first error and the per-record quality minima;
the offsets stay on the device, where the stream build reads them.

Behavioral contract matched to the Go reference (parser.go):

- Lines split on ``\\n``; a trailing ``\\r`` is stripped (parser.go:213-214).
- Record = 4 lines: header starting ``@`` (stripped), sequence, separator
  starting ``+`` (payload kept, ``+`` stripped), quality
  (parser.go:61-106); ``len(seq) == len(qual)`` enforced (parser.go:179).
- Error messages match parser.go:70,88,180 verbatim; the first malformed
  line wins.
- A trailing record whose lines end before the 4th newline is dropped, but
  its *complete* lines are still validated (parser.go:136-184).
"""

from __future__ import annotations

import contextlib
import io
import warnings
from typing import BinaryIO, Iterator

import numpy as np
import torch

from ..ops import records as recops
from ..utils.inmem import source_view

ERR_HEADER = "invalid FASTQ: header line must start with @"
ERR_PLUS = "invalid FASTQ: separator line must start with +"
ERR_LEN_MISMATCH = "invalid FASTQ: sequence and quality lengths must match"
SCAN_ERRORS = {1: ERR_HEADER, 2: ERR_PLUS, 3: ERR_LEN_MISMATCH}

# Quality padding byte: 0xFF never appears in valid Phred data and keeps
# masked minima correct during encoding detection.
QUAL_PAD = 0xFF
SEQ_PAD = 0x00  # packs to code 0 ('A'); never emitted thanks to length masks


class FastqParseError(ValueError):
    pass


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over the bytes of ``a`` without a copy. The source may
    be read-only (a ``bytes`` object, a read-only mmap); tensors made here
    are only read."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(a)


class RecordBlock:
    """A block of ``n`` parsed FASTQ records.

    ``text`` is the block's FASTQ text on the host (a numpy view of the
    input), ``dev_text`` the same bytes on the block's device, ``dev_offsets``
    the scan's (n, 8) int64 offsets there (``ops/records.py``), ``info`` its
    sums (``SCAN_*``) and ``qmin`` the per-record quality minima, both on
    the host. The host views of the JAX package's block (``offsets``,
    ``lengths``, ``header_starts`` ..., and the padded ``seq`` / ``qual``
    matrices) are built on first access: the v1/v2 route never builds them.
    """

    def __init__(self, n: int, text: np.ndarray, dev_text: torch.Tensor,
                 dev_offsets: torch.Tensor, info: np.ndarray, qmin: np.ndarray):
        self.n = n
        self.text = text
        self.dev_text = dev_text
        self.dev_offsets = dev_offsets
        self.info = info
        self.qmin = qmin
        self._offsets = None
        self._seq = None
        self._qual = None

    @property
    def device(self) -> torch.device:
        return self.dev_text.device

    @property
    def offsets(self) -> np.ndarray:
        if self._offsets is None:
            self._offsets = self.dev_offsets.cpu().numpy()
        return self._offsets

    @property
    def lengths(self) -> np.ndarray:
        return self.offsets[:, 3].astype(np.int32)

    @property
    def header_starts(self) -> np.ndarray:
        return self.offsets[:, 0]

    @property
    def header_lengths(self) -> np.ndarray:
        return self.offsets[:, 1]

    @property
    def plus_starts(self) -> np.ndarray:
        return self.offsets[:, 4]

    @property
    def plus_lengths(self) -> np.ndarray:
        return self.offsets[:, 5]

    @property
    def max_len(self) -> int:
        return int(self.info[recops.SCAN_SEQ_MAX])

    @property
    def total_bases(self) -> int:
        return int(self.info[recops.SCAN_SEQ_SUM])

    @property
    def max_field(self) -> int:
        """The longest header or plus-line payload."""
        return max(int(self.info[recops.SCAN_HDR_MAX]), int(self.info[recops.SCAN_PLUS_MAX]))

    @property
    def overflow_row(self) -> int | None:
        """The first record with a non-ACGT base at position >= 65,536."""
        row = int(self.info[recops.SCAN_OVERFLOW_ROW])
        return None if row == recops.NONE else row

    def qual_min(self, take: int) -> int:
        """The least quality byte of the first ``take`` records, or
        :data:`..ops.records.EMPTY_QMIN` (256) when they have none."""
        return int(self.qmin[:take].min()) if take > 0 else recops.EMPTY_QMIN

    def rows(self, which: str, rows: int, width: int) -> torch.Tensor:
        """The sequences (``which="seq"``, fill ``SEQ_PAD``) or qualities
        (fill ``QUAL_PAD``) as a padded (rows, width) matrix on the block's
        device: one row gather from the device text."""
        from ..ops import cuda_kernels

        col, fill = (2, SEQ_PAD) if which == "seq" else (6, QUAL_PAD)
        return cuda_kernels.rows_gather(self.dev_text, self.dev_offsets[:, col],
                                        self.dev_offsets[:, 3], rows, width, fill)

    def _host_rows(self, which: str) -> np.ndarray:
        return self.rows(which, self.n, self.max_len).cpu().numpy()

    @property
    def seq(self) -> np.ndarray:
        """(n, max_len) uint8 sequences padded with ``SEQ_PAD``."""
        if self._seq is None:
            self._seq = self._host_rows("seq")
        return self._seq

    @property
    def qual(self) -> np.ndarray:
        """(n, max_len) uint8 qualities padded with ``QUAL_PAD``."""
        if self._qual is None:
            self._qual = self._host_rows("qual")
        return self._qual

    def record(self, i: int) -> tuple[bytes, bytes, bytes, bytes]:
        """(header, sequence, plus, quality) bytes of record i."""
        h, hl, s, sl, p, pl, q, ql = (int(x) for x in self.offsets[i])
        t = self.text
        return (t[h : h + hl].tobytes(), t[s : s + sl].tobytes(),
                t[p : p + pl].tobytes(), t[q : q + ql].tobytes())


class FastqStreamParser:
    """Streaming block parser: yields :class:`RecordBlock` of ``block_size``
    records (the reference's producer goroutine and record batches,
    compress.go:303-363), each scanned on ``device`` (default: the CPU, the
    kernel's plain version). ``stream``: the CUDA stream of the copies and
    the scan (default: the current one).

    An addressable source (a ``BytesIO``, a regular file) is scanned in
    windows of one view of it; any other is read into page-locked buffers
    with ``readinto``, the unconsumed tail carried into the next one. A
    window holds about ``block_size`` records by an adaptive estimate of
    the record size and grows when it holds fewer.
    """

    def __init__(
        self,
        reader: BinaryIO,
        block_size: int = 100000,
        device=None,
        stream: "torch.cuda.Stream | None" = None,
    ):
        self.reader = reader
        self.block_size = block_size
        self.device = torch.device("cpu" if device is None else device)
        self.stream = stream
        self._eof = False

    def _on_stream(self):
        if self.stream is not None:
            return torch.cuda.stream(self.stream)
        return contextlib.nullcontext()

    def _scan(self, window: np.ndarray):
        """The window to the device, the scan, one synchronisation: returns
        (device text, device offsets, host info, host qmin)."""
        from ..ops import cuda_kernels

        host = host_tensor(window)
        if self.device.type != "cuda":
            offsets, qmin, info = cuda_kernels.records_scan(host, self.block_size)
            return host, offsets, info.numpy(), qmin.numpy()
        with self._on_stream():
            text = host.to(self.device, non_blocking=True)
            offsets, qmin, info = cuda_kernels.records_scan(text, self.block_size)
            info_h = torch.empty(info.shape, dtype=info.dtype, pin_memory=True)
            qmin_h = torch.empty(qmin.shape, dtype=qmin.dtype, pin_memory=True)
            info_h.copy_(info, non_blocking=True)
            qmin_h.copy_(qmin, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        done.synchronize()
        return text, offsets, info_h.numpy(), qmin_h.numpy()

    def _target(self, avg: int, have: int) -> int:
        """Window bytes for ``block_size`` records of ``avg`` bytes, at
        most 256 MiB (a window that holds too few records grows)."""
        return max(min(int(self.block_size * avg * 1.15) + 1024, 1 << 28), have)

    def blocks(self) -> Iterator[RecordBlock]:
        view = source_view(self.reader)
        if view is not None:
            source = _ViewWindows(np.frombuffer(view, np.uint8))
        else:
            source = _ReadWindows(self, pin=self.device.type == "cuda")
        avg = 512  # adaptive bytes-per-record estimate
        while True:
            window = source.window(self._target(avg, 0))
            if len(window) == 0:
                return
            while True:
                text, offsets, info, qmin = self._scan(window)
                err = int(info[recops.SCAN_ERROR])
                if err:
                    raise FastqParseError(SCAN_ERRORS[err])
                n = int(info[recops.SCAN_COUNT])
                if n >= self.block_size or source.eof:
                    break
                avg *= 2  # underestimated record size: a larger window
                window = source.window(max(self._target(avg, 0), 2 * len(window)))
            if n == 0:
                return  # EOF; the partial record's lines were validated
            consumed = int(info[recops.SCAN_CONSUMED])
            yield RecordBlock(n, window[:consumed], text, offsets[:n], info, qmin[:n])
            avg = max(64, consumed // n)
            source.advance(consumed)

    def _read_into(self, buf: np.ndarray, filled: int) -> int:
        """Fill ``buf[filled:]`` from the reader until full or EOF; one
        copy from the source, no intermediate bytes objects."""
        readinto = getattr(self.reader, "readinto", None)
        mv = memoryview(buf).cast("B")
        while not self._eof and filled < len(buf):
            if readinto is not None:
                try:
                    got = readinto(mv[filled:])
                except (NotImplementedError, io.UnsupportedOperation, AttributeError):
                    # e.g. the CLI's gzip-sniff peek wrapper only has read()
                    readinto = None
                    continue
                if not got:
                    self._eof = True
                    break
                filled += got
            else:
                chunk = self.reader.read(len(buf) - filled)
                if not chunk:
                    self._eof = True
                    break
                buf[filled : filled + len(chunk)] = np.frombuffer(chunk, np.uint8)
                filled += len(chunk)
        return filled


class _ViewWindows:
    """Windows of one view of an addressable source, without a copy."""

    def __init__(self, src: np.ndarray):
        self.src = src
        self.pos = 0
        self.shown = 0

    @property
    def eof(self) -> bool:
        return self.pos + self.shown >= len(self.src)

    def window(self, size: int) -> np.ndarray:
        """At least ``size`` bytes from the current position (or what is
        left), never fewer than the last window showed."""
        self.shown = max(size, self.shown)
        return self.src[self.pos : self.pos + self.shown]

    def advance(self, consumed: int) -> None:
        self.pos += consumed
        self.shown = 0


class _ReadWindows:
    """Windows read into buffers (page-locked with ``pin``); the bytes a
    block did not consume are carried into the next buffer. A buffer is
    never written once a block views it."""

    def __init__(self, parser: FastqStreamParser, pin: bool):
        self.parser = parser
        self.pin = pin
        self.carry = np.empty(0, np.uint8)
        self.buf = None
        self.filled = 0

    @property
    def eof(self) -> bool:
        return self.parser._eof

    def window(self, size: int) -> np.ndarray:
        size = max(size, len(self.carry), self.filled)
        if self.buf is None or size > len(self.buf):
            bigger = torch.empty(size, dtype=torch.uint8, pin_memory=self.pin).numpy()
            if self.buf is None:
                bigger[: len(self.carry)] = self.carry
                self.filled = len(self.carry)
            else:
                bigger[: self.filled] = self.buf[: self.filled]
            self.buf = bigger
        self.filled = self.parser._read_into(self.buf, self.filled)
        return self.buf[: self.filled]

    def advance(self, consumed: int) -> None:
        self.carry = self.buf[consumed : self.filled].copy()
        self.buf, self.filled = None, 0
