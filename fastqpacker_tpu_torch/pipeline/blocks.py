"""Block-level encode/decode: dense arrays <-> FQZ v1/v2 wire streams.

The numpy paths of ``fastqpacker_tpu/pipeline/blocks.py``. The irregular
parts of the format (variable-length stream concatenation, u16 N-position
lists, length-prefixed header/plus payloads) stay on the host; the dense
transforms are pluggable (``encode_arrays`` / ``decode_arrays``).

Wire layout per block (reference: internal/compress/compress.go:471-555):
  block header, then zstd streams in order seq, qual, headers, plus (v2+),
  npos, lengths.
Stream encodings (compress.go:490-519):
  seq     = concat of ceil(len/4) packed bytes per record
  qual    = concat of normalized+delta bytes per record
  headers = u16le length + bytes per record ('@' stripped)
  plus    = u16le length + bytes per record ('+' stripped)
  npos    = u16le count + u16le positions per record
  lengths = u32le sequence length per record
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..format import container
from ..ops import reference as refops
from ..parser.fastq import RecordBlock
from ..utils import varlen


@dataclass
class RawStreams:
    """Uncompressed per-block streams in wire order."""

    seq: bytes
    qual: bytes
    headers: bytes
    plus: bytes
    npos: bytes
    lengths: bytes
    num_records: int
    original_seq_size: int
    original_qual_size: int

    def ordered(self, version: int) -> list[bytes]:
        if version == container.VERSION_1:
            return [self.seq, self.qual, self.headers, self.npos, self.lengths]
        return [
            self.seq,
            self.qual,
            self.headers,
            self.plus,
            self.npos,
            self.lengths,
        ]


def _exclusive_cumsum(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x), dtype=np.int64)
    if len(x) > 1:
        np.cumsum(x[:-1], out=out[1:])
    return out


def build_npos_stream(
    nmask_bits: np.ndarray, n_counts: np.ndarray, max_len: int
) -> bytes:
    """N-position stream: u16 count + u16 positions per record
    (compress.go:495-498)."""
    r = len(n_counts)
    counts = n_counts.astype(np.int64)
    total = r + int(counts.sum())
    out = np.zeros(total, dtype="<u2")
    if r == 0:
        return out.tobytes()
    count_pos = np.arange(r, dtype=np.int64) + _exclusive_cumsum(counts)
    out[count_pos] = counts.astype("<u2")
    nz = np.flatnonzero(counts > 0)
    if len(nz):
        bits = np.unpackbits(
            nmask_bits[nz], axis=1, bitorder="little", count=max_len
        )
        rows, cols = np.nonzero(bits)
        per_row = counts[nz]
        first = _exclusive_cumsum(per_row)
        rank = np.arange(len(rows), dtype=np.int64) - np.repeat(first, per_row)
        dst = count_pos[nz][rows] + 1 + rank
        out[dst] = cols.astype("<u2")
    return out.tobytes()


def parse_npos_stream(
    data: np.ndarray, count: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse npos stream -> (counts, flat_rows, flat_positions).

    Fast path: no N anywhere (stream is exactly `count` zero u16s).
    Otherwise a sequential walk (compress.go:1055-1078).
    """
    if len(data) % 2 != 0:
        raise container.FormatError("truncated N position data")
    u16 = data.view("<u2")
    if len(u16) < count:
        raise container.FormatError("truncated N position data")
    if len(u16) == count:
        counts = u16.astype(np.int64)
        if counts.sum() == 0:
            return counts, np.empty(0, np.int64), np.empty(0, np.int64)
    counts = np.zeros(count, dtype=np.int64)
    rows_list = []
    pos_list = []
    off = 0
    n = len(u16)
    for i in range(count):
        if off >= n:
            raise container.FormatError("truncated N position data")
        c = int(u16[off])
        off += 1
        counts[i] = c
        if c:
            if off + c > n:
                raise container.FormatError("truncated N position data")
            pos_list.append(u16[off : off + c].astype(np.int64))
            rows_list.append(np.full(c, i, dtype=np.int64))
            off += c
    if pos_list:
        return counts, np.concatenate(rows_list), np.concatenate(pos_list)
    return counts, np.empty(0, np.int64), np.empty(0, np.int64)


def parse_len16_stream(
    data: np.ndarray, count: int, what: str
) -> tuple[np.ndarray, np.ndarray]:
    """Parse u16-length-prefixed stream -> (starts, lengths).

    Fast path for uniform-length records (vectorized verify), sequential
    walk otherwise.
    """
    nd = len(data)
    if count == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    if nd >= 2 * count and (nd - 2 * count) % count == 0:
        uniform = (nd - 2 * count) // count
        if uniform <= 0xFFFF:
            stride = 2 + uniform
            offs = np.arange(count, dtype=np.int64) * stride
            lens = data[offs].astype(np.int64) | (
                data[offs + 1].astype(np.int64) << 8
            )
            if np.all(lens == uniform):
                return offs + 2, lens
    return varlen.parse_len16_stream(data, count, what)


def packed_lengths(lengths: np.ndarray) -> np.ndarray:
    return (lengths.astype(np.int64) + 3) >> 2


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

EncodeArraysFn = Callable[..., refops.EncodedArrays]


def encoded_to_raw_streams(
    block: RecordBlock, enc: refops.EncodedArrays
) -> RawStreams:
    """Host stream assembly from one block's dense encode outputs; rows
    past ``block.n`` (shape-bucket padding) are ignored."""
    n = block.n
    lengths = block.lengths.astype(np.int64)
    qual_delta = enc.qual_delta[:n]
    return RawStreams(
        seq=varlen.flatten_rows(enc.packed[:n], packed_lengths(lengths)).tobytes(),
        qual=varlen.flatten_rows(qual_delta, lengths).tobytes(),
        headers=block.header_stream(),
        plus=block.plus_stream(),
        npos=build_npos_stream(
            enc.nmask_bits[:n], enc.n_counts[:n], qual_delta.shape[1]
        ),
        lengths=lengths.astype("<u4").tobytes(),
        num_records=n,
        original_seq_size=int(lengths.sum()),
        original_qual_size=int(lengths.sum()),
    )


def block_to_raw_streams(
    block: RecordBlock, qual_offset: int, encode_arrays: EncodeArraysFn
) -> RawStreams:
    """Dense transforms (``encode_arrays``, numpy in and out) + host
    stream assembly for one block."""
    refops.check_ambiguous_overflow(block.seq, block.lengths.astype(np.int64))
    enc = encode_arrays(block.seq, block.qual, block.lengths, qual_offset)
    return encoded_to_raw_streams(block, enc)


def compress_raw_streams(
    raw: RawStreams, codec, version: int = container.CURRENT_VERSION
) -> bytes:
    """Entropy-code streams and serialize block header + payload."""
    comp = [codec.compress_adaptive(s) for s in raw.ordered(version)]
    hdr = container.BlockHeader(
        num_records=raw.num_records,
        original_seq_size=raw.original_seq_size,
        original_qual_size=raw.original_qual_size,
    )
    if version == container.VERSION_1:
        (
            hdr.seq_data_size,
            hdr.qual_data_size,
            hdr.header_data_size,
            hdr.npositions_size,
            hdr.seq_lengths_size,
        ) = [len(c) for c in comp]
    else:
        (
            hdr.seq_data_size,
            hdr.qual_data_size,
            hdr.header_data_size,
            hdr.plus_data_size,
            hdr.npositions_size,
            hdr.seq_lengths_size,
        ) = [len(c) for c in comp]
    return hdr.to_bytes(version) + b"".join(comp)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

DecodeArraysFn = Callable[..., tuple[np.ndarray, np.ndarray]]


@dataclass
class DecodedStreams:
    """Zstd-decoded raw streams of one block."""

    seq: np.ndarray
    qual: np.ndarray
    headers: np.ndarray
    plus: np.ndarray  # empty for v1
    npos: np.ndarray
    lengths: np.ndarray
    num_records: int


def decode_streams(
    header: container.BlockHeader,
    payload: bytes,
    version: int,
    codec,
) -> DecodedStreams:
    sizes = header.stream_sizes(version)
    offs = np.concatenate(([0], np.cumsum(sizes)))
    if offs[-1] != len(payload):
        raise container.FormatError("truncated block payload")
    parts = [
        np.frombuffer(codec.decompress(payload[offs[i] : offs[i + 1]]), np.uint8)
        for i in range(len(sizes))
    ]
    if version == container.VERSION_1:
        seq, qual, hdrs, npos, lens = parts
        plus = np.empty(0, np.uint8)
    else:
        seq, qual, hdrs, plus, npos, lens = parts
    return DecodedStreams(
        seq=seq,
        qual=qual,
        headers=hdrs,
        plus=plus,
        npos=npos,
        lengths=lens,
        num_records=header.num_records,
    )


def streams_to_fastq(
    ds: DecodedStreams, qual_offset: int, decode_arrays: DecodeArraysFn
) -> bytes:
    """Reconstruct the block's FASTQ text (compress.go:944-1078); the
    dense decode is ``decode_arrays`` (numpy in and out)."""
    r = ds.num_records
    if len(ds.lengths) < 4 * r:
        raise container.FormatError("truncated length data")
    lengths = ds.lengths[: 4 * r].view("<u4").astype(np.int64)

    plens = packed_lengths(lengths)
    if int(plens.sum()) > len(ds.seq):
        raise container.FormatError("truncated sequence data")
    if int(lengths.sum()) > len(ds.qual):
        raise container.FormatError("truncated quality data")

    n_counts, n_rows, n_pos = parse_npos_stream(ds.npos, r)

    max_len = int(lengths.max()) if r else 0
    packed = varlen.gather_rows(
        ds.seq, _exclusive_cumsum(plens), plens, pad_to=-(-max_len // 4)
    )
    qual_delta = varlen.gather_rows(
        ds.qual, _exclusive_cumsum(lengths), lengths, pad_to=max_len
    )

    seq_ascii, qual_ascii = decode_arrays(
        packed, qual_delta, lengths.astype(np.int32), qual_offset
    )
    if len(n_rows):
        if np.any(n_pos >= lengths[n_rows]):
            raise container.FormatError("invalid N position data")
        seq_ascii[n_rows, n_pos] = ord("N")

    hdr_starts, hdr_lens = parse_len16_stream(ds.headers, r, "header")
    if len(ds.plus):
        plus_starts, plus_lens = parse_len16_stream(
            ds.plus, r, "plus-line payload"
        )
    else:
        # v1 containers carry no plus payload: emit bare '+' (compress.go:995-998)
        plus_starts = np.zeros(r, dtype=np.int64)
        plus_lens = np.zeros(r, dtype=np.int64)

    # Assemble '@hdr\nseq\n+plus\nqual\n' per record with one scatter pass
    # per component.
    l_hdr = hdr_lens + 2  # '@' + '\n'
    l_seq = lengths + 1
    l_plus = plus_lens + 2  # '+' + '\n'
    rec_sizes = l_hdr + l_seq + l_plus + lengths + 1
    rec_offs = _exclusive_cumsum(rec_sizes)
    out = np.empty(int(rec_sizes.sum()), dtype=np.uint8)

    at_pos = rec_offs
    out[at_pos] = ord("@")
    varlen.scatter_rows(
        out,
        varlen.flatten_rows(
            varlen.gather_rows(ds.headers, hdr_starts, hdr_lens), hdr_lens
        ),
        at_pos + 1,
        hdr_lens,
    )
    out[at_pos + 1 + hdr_lens] = ord("\n")

    at_pos = rec_offs + l_hdr
    varlen.scatter_rows(
        out, varlen.flatten_rows(seq_ascii, lengths), at_pos, lengths
    )
    out[at_pos + lengths] = ord("\n")

    at_pos = rec_offs + l_hdr + l_seq
    out[at_pos] = ord("+")
    if len(ds.plus):
        varlen.scatter_rows(
            out,
            varlen.flatten_rows(
                varlen.gather_rows(ds.plus, plus_starts, plus_lens), plus_lens
            ),
            at_pos + 1,
            plus_lens,
        )
    out[at_pos + 1 + plus_lens] = ord("\n")

    at_pos = rec_offs + l_hdr + l_seq + l_plus
    varlen.scatter_rows(
        out, varlen.flatten_rows(qual_ascii, lengths), at_pos, lengths
    )
    out[at_pos + lengths] = ord("\n")

    return out.tobytes()
