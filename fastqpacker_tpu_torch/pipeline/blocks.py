"""Block-level encode/decode: dense arrays <-> FQZ wire streams.

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
FQZ v3 widens the npos stream to u32 counts and positions (``wide_npos``):
no 65,536 bp tracking cap and no overflow fail-fast.
"""

from __future__ import annotations

import contextlib
import struct
from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..entropy.zstd import ZstdError, frame_content_size
from ..format import container
from ..ops import reference as refops
from ..parser.fastq import RecordBlock
from ..utils import varlen


# What the JAX package's default decoder (its C++ runtime) says when a zstd
# frame of a block payload fails to decode, whatever libzstd names the
# failure (a checksum, corrupt data, a size).
PAYLOAD_ZSTD_ERROR = "corrupted zstd frame in block payload"

# v3 stream tags whose body is one zstd frame
_V3_ZSTD_TAGS = (container.TAG_ZSTD, container.TAG_TOK, container.TAG_SLDM)


def block_frames(header: container.BlockHeader, payload, version: int) -> list:
    """The zstd frames of one block payload: every stream of v1/v2; in v3
    the three untagged streams and the tagged streams that are one zstd
    frame after their tag byte."""
    sizes = header.stream_sizes(min(version, container.VERSION_2))
    frames, off = [], 0
    for i, size in enumerate(sizes):
        s = payload[off : off + size]
        off += size
        if version < container.VERSION_3_NATIVE or i > 2:
            frames.append(s)
        elif s[:1] and s[0] in _V3_ZSTD_TAGS:
            frames.append(s[1:])
    return frames


def frames_sized(header: container.BlockHeader, payload, version: int) -> bool:
    """True when every zstd frame of this block payload declares a content
    size of at most 2^34 bytes: the JAX package's runtime decodes such a
    v1/v2 block itself and hands any other to its Python decoder."""
    for f in block_frames(header, payload, version):
        if len(f) and ((z := frame_content_size(f)) is None or z > _MAX_STREAM_RAW):
            return False
    return True


@contextlib.contextmanager
def payload_zstd_errors(mapped: bool):
    """Raise a :class:`ZstdError` from decoding a block payload as
    ``ZstdError(PAYLOAD_ZSTD_ERROR)`` when ``mapped``, the JAX package's
    runtime's string; else keep libzstd's name, as its Python decoder and
    its ``decompress_mesh`` do. The caller decides ``mapped`` as the JAX
    package does: per file for v3 (:func:`runtime_walk`), per block for
    v1/v2 (:func:`frames_sized`)."""
    try:
        yield
    except ZstdError:
        if mapped:
            raise ZstdError(PAYLOAD_ZSTD_ERROR) from None
        raise


# The JAX package's whole-file decoder (its C++ runtime) first walks every
# block header of an addressable container body. Its limits:
_MAX_STREAM_RAW = 1 << 34  # a stream's declared decoded size
_QCTX_CHUNKS = 4  # ops/qualctx.py NUM_CHUNKS
# the tags it decodes in each tagged v3 slot (seq, qual, headers)
_RUNTIME_V3_TAGS = (
    (container.TAG_ZSTD, container.TAG_RANS, container.TAG_SCTX,
     container.TAG_SLDM, container.TAG_WCTX),
    (container.TAG_ZSTD, container.TAG_RANS, container.TAG_QCTX,
     container.TAG_WCTX),
    (container.TAG_ZSTD, container.TAG_TOK),
)


# What that decoder says when a tagged v3 stream fails to decode: one string
# per codec, whatever the fault (``runtime/bindings.py:_mt_raise_decompress``).
# A zstd frame that fails inside a TAG_TOK stream is PAYLOAD_ZSTD_ERROR there.
RUNTIME_STREAM_ERRORS = {
    container.TAG_RANS: "truncated or corrupted rANS stream",
    container.TAG_TOK: "corrupted tokenized header stream",
    container.TAG_QCTX: "corrupted qctx quality data",
    container.TAG_SCTX: "corrupted sctx sequence data",
    container.TAG_SLDM: "corrupted sldm sequence data",
    container.TAG_WCTX: "corrupted wctx stream",
}


def _fault(msg: str):
    raise container.FormatError(msg)


@contextlib.contextmanager
def runtime_stream_errors(tag: int, mapped: bool):
    """Raise a failure to decode a stream tagged ``tag`` as the JAX
    package's whole-file decoder names it (:data:`RUNTIME_STREAM_ERRORS`)
    when ``mapped``; else keep the per-block decoder's string. The caller
    decides ``mapped`` once per file (:func:`runtime_walk`)."""
    try:
        yield
    except (ValueError, ZstdError) as e:
        if (not mapped or tag not in RUNTIME_STREAM_ERRORS
                or (isinstance(e, ZstdError) and tag == container.TAG_TOK)):
            raise
        raise container.FormatError(RUNTIME_STREAM_ERRORS[tag]) from None


def v3_stream_raw_size(slot: int, tag: int, s, nrec: int):
    """The decoded size the runtime's walk gives one v3 stream (``s``
    after its tag), None where it hands the file back; raises the faults
    the walk names."""
    if tag == container.TAG_QCTX:
        if len(s) < 12 or s[4] != _QCTX_CHUNKS or s[5] > 1:
            _fault(RUNTIME_STREAM_ERRORS[tag])
        return struct.unpack_from("<I", s, 0)[0]
    if tag == container.TAG_SCTX:
        if len(s) < 12:
            _fault(RUNTIME_STREAM_ERRORS[tag])
        return struct.unpack_from("<I", s, 0)[0] // 4 + nrec
    if tag == container.TAG_WCTX:
        if len(s) < 8:
            _fault(RUNTIME_STREAM_ERRORS[tag])
        total = struct.unpack_from("<I", s, 4)[0]
        return total + total // 4 + nrec if slot == 0 else 2 * total
    if tag == container.TAG_RANS:
        if len(s) < 8:
            _fault(RUNTIME_STREAM_ERRORS[tag])
        return struct.unpack_from("<I", s, 0)[0]
    z = frame_content_size(s)  # zstd, TOK, SLDM: one zstd frame
    if z is not None and tag == container.TAG_SLDM:
        z += z // 4 + nrec
    return z


def runtime_walk(body, version: int) -> bool:
    """The first pass of the JAX package's whole-file decoder over a
    container ``body`` (its bytes after the file header and any dictionary
    section): ``fq_decompress_mt`` (v1/v2) and ``fq_decompress_mt_v3_ex``
    (v3) of ``fastqpacker_tpu/runtime/fqruntime.cpp``. It walks every block
    header before any block is decoded and raises what it meets there in
    that order: a truncated block, a stream header too short for its codec.
    False where the runtime hands the file to its per-block Python decoder
    (a zstd frame that declares no content size, a v3 tag it does not take,
    sizes past its limits); True where it decodes the file itself."""
    n = len(body)
    nfields = {container.VERSION_1: 8, container.VERSION_2: 9}.get(version, 10)
    hsize = 4 * nfields
    pos, total_bound = 0, 0
    while pos < n:
        if n - pos < hsize:
            _fault("truncated block header")
        f = struct.unpack_from(f"<{nfields}I", body, pos)
        comp = ([f[1], f[2], f[3], 0, f[4], f[5]] if version == container.VERSION_1
                else list(f[1:7]))
        pos += hsize
        if sum(comp) > n - pos:
            _fault("truncated block payload")
        nrec, raw, tok, off = f[0], [0] * 6, False, pos
        pos += sum(comp)
        for i, size in enumerate(comp):
            s = body[off : off + size]
            off += size
            if not size:
                continue
            if version < container.VERSION_3_NATIVE:
                z = frame_content_size(s)
            else:
                tag = s[0] if i <= 2 else container.TAG_ZSTD
                if i <= 2:
                    if tag not in _RUNTIME_V3_TAGS[i]:
                        return False
                    s = s[1:]
                tok |= tag == container.TAG_TOK
                z = v3_stream_raw_size(i, tag, s, nrec)
            if z is None or z > _MAX_STREAM_RAW:
                return False
            raw[i] = z
        per_record = 4 if version == container.VERSION_1 else 2
        total_bound += (8 * raw[2] if tok else raw[2]) + raw[3] + 2 * raw[1] + per_record * nrec
    return total_bound <= 64 * n + (1 << 30)


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
    nmask_bits: np.ndarray, n_counts: np.ndarray, max_len: int,
    wide: bool = False,
) -> bytes:
    """N-position stream: u16 count + u16 positions per record
    (compress.go:495-498); u32 both with ``wide`` (v3)."""
    dtype = "<u4" if wide else "<u2"
    r = len(n_counts)
    counts = n_counts.astype(np.int64)
    total = r + int(counts.sum())
    out = np.zeros(total, dtype=dtype)
    if r == 0:
        return out.tobytes()
    count_pos = np.arange(r, dtype=np.int64) + _exclusive_cumsum(counts)
    out[count_pos] = counts.astype(dtype)
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
        out[dst] = cols.astype(dtype)
    return out.tobytes()


def parse_npos_stream(
    data: np.ndarray, count: int, wide: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse npos stream -> (counts, flat_rows, flat_positions).

    Fast path: no N anywhere (stream is exactly `count` zero u16s).
    Otherwise a sequential walk (compress.go:1055-1078). ``wide`` parses
    the v3 u32 layout, where trailing bytes after the last record are
    tolerated: FLAG_LOSSLESS appends its side data to this slot, and the
    parse is self-delimiting.
    """
    if wide:
        u16 = data[: len(data) - len(data) % 4].view("<u4")
    else:
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
    block: RecordBlock, enc: refops.EncodedArrays, wide_npos: bool = False
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
            enc.nmask_bits[:n], enc.n_counts[:n], qual_delta.shape[1],
            wide=wide_npos,
        ),
        lengths=lengths.astype("<u4").tobytes(),
        num_records=n,
        original_seq_size=int(lengths.sum()),
        original_qual_size=int(lengths.sum()),
    )


def block_to_raw_streams(
    block: RecordBlock,
    qual_offset: int,
    encode_arrays: EncodeArraysFn,
    wide_npos: bool = False,
) -> RawStreams:
    """Dense transforms (``encode_arrays``, numpy in and out) + host
    stream assembly for one block. ``wide_npos`` selects the v3 u32
    N-position layout and lifts the tracking cap."""
    if wide_npos:
        enc = encode_arrays(
            block.seq, block.qual, block.lengths, qual_offset,
            npos_cap=refops.NPOS_CAP_WIDE,
        )
    else:
        refops.check_ambiguous_overflow(
            block.seq, block.lengths.astype(np.int64)
        )
        enc = encode_arrays(block.seq, block.qual, block.lengths, qual_offset)
    return encoded_to_raw_streams(block, enc, wide_npos)


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
    ds: DecodedStreams,
    qual_offset: int,
    decode_arrays: DecodeArraysFn,
    wide_npos: bool = False,
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

    n_counts, n_rows, n_pos = parse_npos_stream(ds.npos, r, wide=wide_npos)

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
