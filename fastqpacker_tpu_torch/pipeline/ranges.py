"""Random-access decompression of record sub-ranges.

The port of ``fastqpacker_tpu/pipeline/ranges.py``. Block headers carry the
compressed stream sizes and the per-block record count, so a container is
indexed by seek-skipping payloads (a few KB of reads per 100k records), and
any record range decodes by touching only its covering blocks, with the
device programs on the caller's device (the card unless told otherwise):
one dense decode per covered block, and for v3 the rANS / context-rANS
decode of each coded stream and the block CRC32.

Exposed as :func:`read_record_range` / :class:`FqzIndex` and the
``fqpack cat`` CLI subcommand.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import BinaryIO, Optional

import numpy as np

from ..entropy import zstd as zstd_entropy
from ..format import container
from ..ops import device as devops
from ..ops import reference as refops
from ..ops import sldm
from . import blocks as blockcodec
from . import native


@dataclass
class BlockEntry:
    """One block's location in the container and the record space."""

    offset: int  # file offset of the block header
    payload_size: int  # compressed stream bytes after the header
    num_records: int
    record_start: int  # index of the block's first record in the file


@dataclass
class FqzIndex:
    """Container index: file header + per-block locations."""

    file_header: container.FileHeader
    entries: list[BlockEntry]
    # v3 FLAG_SEQ_DICT: the decoded container sequence dictionary
    seq_dict: Optional[np.ndarray] = None

    @property
    def total_records(self) -> int:
        if not self.entries:
            return 0
        last = self.entries[-1]
        return last.record_start + last.num_records

    def covering(self, start: int, stop: int) -> list[BlockEntry]:
        """Blocks overlapping record range [start, stop)."""
        return [
            e
            for e in self.entries
            if e.record_start < stop and e.record_start + e.num_records > start
        ]


def build_index(r: BinaryIO) -> FqzIndex:
    """Index a container by walking block headers (payloads seek-skipped)."""
    fh = container.read_file_header(r)
    if fh.version not in (
        container.VERSION_1,
        container.VERSION_2,
        container.VERSION_3_NATIVE,
    ):
        raise container.FormatError(f"unsupported file version: {fh.version}")
    stream_version = (
        container.VERSION_2
        if fh.version == container.VERSION_3_NATIVE
        else fh.version
    )
    seq_dict = None
    if (
        fh.version == container.VERSION_3_NATIVE
        and fh.flags & container.FLAG_SEQ_DICT
    ):
        raw_len, comp = container.read_seq_dict_section(r)
        try:
            seq_dict = sldm.decompress_dict(comp, raw_len)
        except ValueError as e:
            raise container.FormatError(str(e)) from None
    entries: list[BlockEntry] = []
    record_start = 0
    while True:
        off = r.tell()
        hdr = container.read_block_header(r, fh.version)
        if hdr is None:
            break
        payload = sum(hdr.stream_sizes(stream_version))
        r.seek(payload, os.SEEK_CUR)
        entries.append(
            BlockEntry(
                offset=off,
                payload_size=payload,
                num_records=hdr.num_records,
                record_start=record_start,
            )
        )
        record_start += hdr.num_records
    return FqzIndex(file_header=fh, entries=entries, seq_dict=seq_dict)


def index_path(path: str) -> FqzIndex:
    with open(path, "rb") as f:
        return build_index(f)


def _decode_entry(
    f: BinaryIO,
    fh: container.FileHeader,
    entry: BlockEntry,
    qual_offset: int,
    seq_dict: Optional[np.ndarray] = None,
    device=None,
) -> bytes:
    """Decode one indexed block to FASTQ text on ``device``. A failing zstd
    frame keeps libzstd's name, as in the JAX package's per-block decode."""
    dev = devops.resolve_device(device)
    f.seek(entry.offset)
    hdr = container.read_block_header(f, fh.version)
    if hdr is None:
        raise container.FormatError("truncated block header")
    payload = f.read(entry.payload_size)
    if len(payload) < entry.payload_size:
        raise container.FormatError("truncated block payload")
    codec = zstd_entropy.get_codec()
    if fh.version == container.VERSION_3_NATIVE:
        return native.decode_block_payload(
            hdr=hdr, payload=payload, codec=codec, qual_offset=qual_offset,
            dev=dev, seq_dict=seq_dict,
            lossless=bool(fh.flags & container.FLAG_LOSSLESS),
        )
    ds = blockcodec.decode_streams(hdr, payload, fh.version, codec)
    return blockcodec.streams_to_fastq(ds, qual_offset, dev)


def _trim_records(text: bytes, first: int, count: int) -> bytes:
    """Slice records [first, first+count) out of a block's FASTQ text.

    Record boundaries are every 4th newline; positions come from one
    vectorized scan rather than a per-line Python loop.
    """
    if first == 0 and count >= text.count(b"\n") // 4:
        return text
    nl = np.flatnonzero(np.frombuffer(text, np.uint8) == 0x0A)
    nrec = len(nl) // 4
    first = min(first, nrec)
    last = min(first + count, nrec)
    start = 0 if first == 0 else int(nl[first * 4 - 1]) + 1
    end = int(nl[last * 4 - 1]) + 1 if last > 0 else 0
    return text[start:end]


def read_record_range(
    path: str,
    start: int,
    stop: Optional[int] = None,
    index: Optional[FqzIndex] = None,
    device=None,
) -> bytes:
    """FASTQ text of records [start, stop) from an FQZ container.

    Decodes only the blocks covering the range, with the device programs
    on ``device`` (default: the CUDA card); an existing :class:`FqzIndex`
    can be supplied to amortize indexing across calls.
    """
    dev = devops.resolve_device(device)
    idx = index if index is not None else index_path(path)
    fh = idx.file_header
    if start < 0:
        raise ValueError("record range start must be >= 0")
    if stop is None:
        stop = idx.total_records
    if stop < start:
        raise ValueError("record range stop must be >= start")
    qual_offset = (
        refops.PHRED64_OFFSET if fh.phred64 else refops.PHRED33_OFFSET
    )
    out = []
    with open(path, "rb") as f:
        for entry in idx.covering(start, stop):
            text = _decode_entry(f, fh, entry, qual_offset, idx.seq_dict, dev)
            first = max(0, start - entry.record_start)
            count = min(stop, entry.record_start + entry.num_records) - (
                entry.record_start + first
            )
            out.append(_trim_records(text, first, count))
    return b"".join(out)
