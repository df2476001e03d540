"""FQZ container format: file header and per-block headers.

The port's own copy of ``fastqpacker_tpu/format/container.py``: the
container is what carries between the two packages, so this module must
stay equivalent to that one.

Byte-exact implementation of the FQZ wire format defined by the Go
reference (``internal/fqformat/container.go``):

- File header (10 bytes): magic ``FQZ\\x00`` + version u8 + block_size u32le
  + flags u8 (container.go:35-45).
- Block header v1 (32 bytes) / v2 (36 bytes): little-endian u32 fields; v2
  adds ``plus_data_size`` between header and npositions sizes
  (container.go:83-113).
- Stream wire order after each block header: seq, qual, headers, plus (v2+),
  npos, lengths (compress.go:548).

This module additionally defines format version 3 ("FQZ native"), a
TPU-native extension in which each stream is entropy-coded with an
interleaved-lane rANS coder computed on-device instead of zstd, and the
block header carries a CRC32 of the uncompressed record text. Version 3 is
this framework's own format; versions 1 and 2 interoperate with the Go
reference.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Optional

MAGIC = b"FQZ\x00"

# Format flags (container.go:14-17).
FLAG_PAIRED_END = 1 << 0  # interleaved R1/R2 records (api.compress_paired)
FLAG_PHRED64 = 1 << 1
# v3 only: a sequence-dictionary section follows the file header — block 0's
# unpacked base codes, shared by every TAG_SLDM stream as an LDM prefix so
# coverage matches cross block boundaries (ops/sldm.py).
FLAG_SEQ_DICT = 1 << 2
# v3 only: strictly lossless mode — the npos slot additionally carries a
# per-base lowercase bitmask and the verbatim bytes of non-ACGTN symbols,
# so decode restores the exact input (the reference normalizes lowercase
# to uppercase and exotic symbols to N by design).
FLAG_LOSSLESS = 1 << 4

SEQ_DICT_MAX_RAW = 64 << 20  # bound attacker-declared dictionary sizes

# v3 per-stream codec tags (frozen wire values; the pick logic lives in
# pipeline/native.py)
TAG_RANS = 0
TAG_ZSTD = 1
TAG_TOK = 2  # header token-delta transform (ops/tokenize.py) + zstd
TAG_QCTX = 3  # order-1/2 context-modeled quality rANS (ops/qualctx.py)
TAG_SCTX = 4  # order-k context-modeled sequence rANS (ops/seqctx.py)
TAG_SLDM = 5  # unpacked base codes + long-distance-matching zstd (ops/sldm.py)
TAG_WCTX = 6  # wide-interleaved context-modeled rANS (the device-mesh
# entropy coder's format; ops/wctx.py)

VERSION_1 = 1
VERSION_2 = 2

# TPU-native format: rANS entropy coding + per-block CRC32. Not readable by
# the Go reference; our decoder reads all three versions.
VERSION_3_NATIVE = 3

CURRENT_VERSION = VERSION_2

FILE_HEADER_SIZE = 10
BLOCK_HEADER_SIZE_V1 = 32
BLOCK_HEADER_SIZE_V2 = 36
# v3: v2 fields + crc32 (u32) of the reconstructed FASTQ text of the block.
BLOCK_HEADER_SIZE_V3 = 40


class FormatError(ValueError):
    """Raised for invalid or unsupported FQZ container data."""


@dataclass
class FileHeader:
    """FQZ file header (container.go:28-45)."""

    version: int = CURRENT_VERSION
    block_size: int = 0
    flags: int = 0

    def to_bytes(self) -> bytes:
        return MAGIC + struct.pack(
            "<BIB", self.version, self.block_size, self.flags
        )

    def write(self, w: BinaryIO) -> None:
        w.write(self.to_bytes())

    @property
    def phred64(self) -> bool:
        return bool(self.flags & FLAG_PHRED64)

    @property
    def paired(self) -> bool:
        return bool(self.flags & FLAG_PAIRED_END)


def read_file_header(r: BinaryIO) -> FileHeader:
    """Read and validate a file header (container.go:48-67)."""
    magic = r.read(4)
    if len(magic) < 4:
        raise FormatError("truncated file header")
    if magic != MAGIC:
        raise FormatError("invalid magic bytes: not an FQZ file")
    rest = r.read(6)
    if len(rest) < 6:
        raise FormatError("truncated file header")
    version, block_size, flags = struct.unpack("<BIB", rest)
    return FileHeader(version=version, block_size=block_size, flags=flags)


def parse_file_header(buf: bytes) -> FileHeader:
    """A file header from the first ``FILE_HEADER_SIZE`` bytes of ``buf``."""
    if len(buf) < FILE_HEADER_SIZE:
        raise FormatError("truncated file header")
    if buf[:4] != MAGIC:
        raise FormatError("invalid magic bytes: not an FQZ file")
    version, block_size, flags = struct.unpack("<BIB", buf[4:10])
    return FileHeader(version=version, block_size=block_size, flags=flags)


def write_seq_dict_section(w: BinaryIO, comp: bytes, raw_len: int) -> None:
    """Sequence-dictionary section (v3, FLAG_SEQ_DICT): u32le raw size,
    u32le compressed size, then one zstd frame of the dictionary codes."""
    w.write(struct.pack("<II", raw_len, len(comp)))
    w.write(comp)


def read_seq_dict_section(r: BinaryIO) -> tuple[int, bytes]:
    head = r.read(8)
    if len(head) < 8:
        raise FormatError("truncated sequence dictionary section")
    raw_len, comp_len = struct.unpack("<II", head)
    if raw_len > SEQ_DICT_MAX_RAW or comp_len > SEQ_DICT_MAX_RAW:
        raise FormatError("sequence dictionary too large")
    comp = r.read(comp_len)
    if len(comp) < comp_len:
        raise FormatError("truncated sequence dictionary section")
    return raw_len, comp


@dataclass
class BlockHeader:
    """Per-block header (container.go:70-152).

    Sizes are of the entropy-coded streams; original_* are uncompressed
    sequence/quality byte totals for the block.
    """

    num_records: int = 0
    seq_data_size: int = 0
    qual_data_size: int = 0
    header_data_size: int = 0
    plus_data_size: int = 0  # v2+ only
    npositions_size: int = 0
    seq_lengths_size: int = 0
    original_seq_size: int = 0
    original_qual_size: int = 0
    crc32: int = 0  # v3 only: CRC32 of the block's reconstructed FASTQ text

    def to_bytes(self, version: int) -> bytes:
        if version == VERSION_1:
            return struct.pack(
                "<8I",
                self.num_records,
                self.seq_data_size,
                self.qual_data_size,
                self.header_data_size,
                self.npositions_size,
                self.seq_lengths_size,
                self.original_seq_size,
                self.original_qual_size,
            )
        if version == VERSION_2:
            return struct.pack(
                "<9I",
                self.num_records,
                self.seq_data_size,
                self.qual_data_size,
                self.header_data_size,
                self.plus_data_size,
                self.npositions_size,
                self.seq_lengths_size,
                self.original_seq_size,
                self.original_qual_size,
            )
        if version == VERSION_3_NATIVE:
            return struct.pack(
                "<10I",
                self.num_records,
                self.seq_data_size,
                self.qual_data_size,
                self.header_data_size,
                self.plus_data_size,
                self.npositions_size,
                self.seq_lengths_size,
                self.original_seq_size,
                self.original_qual_size,
                self.crc32,
            )
        raise FormatError(f"unsupported block header version: {version}")

    def stream_sizes(self, version: int) -> list[int]:
        """Entropy-coded stream sizes in wire order (compress.go:548,738-758)."""
        if version == VERSION_1:
            return [
                self.seq_data_size,
                self.qual_data_size,
                self.header_data_size,
                self.npositions_size,
                self.seq_lengths_size,
            ]
        return [
            self.seq_data_size,
            self.qual_data_size,
            self.header_data_size,
            self.plus_data_size,
            self.npositions_size,
            self.seq_lengths_size,
        ]


def block_header_size(version: int) -> int:
    if version == VERSION_1:
        return BLOCK_HEADER_SIZE_V1
    if version == VERSION_2:
        return BLOCK_HEADER_SIZE_V2
    if version == VERSION_3_NATIVE:
        return BLOCK_HEADER_SIZE_V3
    raise FormatError(f"unsupported block header version: {version}")


def parse_block_header(buf: bytes, version: int) -> BlockHeader:
    size = block_header_size(version)
    if len(buf) < size:
        raise FormatError("truncated block header")
    if version == VERSION_1:
        (nr, seq, qual, hdr, npos, lens, oseq, oqual) = struct.unpack(
            "<8I", buf[:32]
        )
        return BlockHeader(
            num_records=nr,
            seq_data_size=seq,
            qual_data_size=qual,
            header_data_size=hdr,
            npositions_size=npos,
            seq_lengths_size=lens,
            original_seq_size=oseq,
            original_qual_size=oqual,
        )
    if version == VERSION_2:
        (nr, seq, qual, hdr, plus, npos, lens, oseq, oqual) = struct.unpack(
            "<9I", buf[:36]
        )
        return BlockHeader(
            num_records=nr,
            seq_data_size=seq,
            qual_data_size=qual,
            header_data_size=hdr,
            plus_data_size=plus,
            npositions_size=npos,
            seq_lengths_size=lens,
            original_seq_size=oseq,
            original_qual_size=oqual,
        )
    (nr, seq, qual, hdr, plus, npos, lens, oseq, oqual, crc) = struct.unpack(
        "<10I", buf[:40]
    )
    return BlockHeader(
        num_records=nr,
        seq_data_size=seq,
        qual_data_size=qual,
        header_data_size=hdr,
        plus_data_size=plus,
        npositions_size=npos,
        seq_lengths_size=lens,
        original_seq_size=oseq,
        original_qual_size=oqual,
        crc32=crc,
    )


def read_block_header(r: BinaryIO, version: int) -> Optional[BlockHeader]:
    """Read the next block header; returns None on clean EOF."""
    size = block_header_size(version)
    buf = r.read(size)
    if len(buf) == 0:
        return None
    if len(buf) < size:
        raise FormatError("truncated block header")
    return parse_block_header(buf, version)
