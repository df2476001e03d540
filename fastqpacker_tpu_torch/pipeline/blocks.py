"""Block-level encode/decode: dense arrays <-> FQZ wire streams.

The port of ``fastqpacker_tpu/pipeline/blocks.py``. A block's stream build
and its FASTQ assembly run on the block's device: the rows are gathered from
the scanned text, coded by the dense kernels, and the irregular parts of the
format (variable-length stream concatenation, N-position lists,
length-prefixed header/plus payloads) are written by the kernels of
``csrc/records.cu`` (:mod:`..ops.records`); one copy each way crosses to
the host. On the CPU the same route runs the kernels' plain versions.

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
from dataclasses import dataclass, field

import numpy as np
import torch

from ..entropy.zstd import ZstdError, frame_content_size
from ..format import container
from ..ops import records as recops
from ..ops import reference as refops
from ..parser.fastq import RecordBlock


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
    """Uncompressed per-block streams in wire order. ``device_buffer`` and
    ``device_offsets``: where the stream build left the six streams on the
    block's device (seq, qual, headers, plus, npos, lengths back to back;
    seven offsets), so a pass that reads a stream on the device reads it
    there, with no second copy up. ``header_lengths``: the records' header
    lengths the header stream was built from (a column of the record
    scan's offsets on that device), which the tokenizer takes its record
    starts from."""

    seq: bytes
    qual: bytes
    headers: bytes
    plus: bytes
    npos: bytes
    lengths: bytes
    num_records: int
    original_seq_size: int
    original_qual_size: int
    device_buffer: torch.Tensor = field(compare=False, repr=False)
    device_offsets: tuple = field(compare=False, repr=False)
    header_lengths: torch.Tensor | None = field(default=None, compare=False, repr=False)

    def device_view(self, i: int) -> torch.Tensor:
        """Stream ``i`` of the v2+ wire order (0 seq, 1 qual, 2 headers) as
        a view of the device buffer."""
        return self.device_buffer[self.device_offsets[i] : self.device_offsets[i + 1]]

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
    """Parse u16-length-prefixed stream -> (starts, lengths): the chain
    walk of the reference decoder (compress.go:977-1015) as
    :func:`..ops.records.chain_starts` resolves it; raises
    ``ValueError("truncated {what} data")``."""
    t = torch.from_numpy(np.ascontiguousarray(data, np.uint8).copy())
    s = recops.chain_starts(t, 1, 2, len(data), count)
    if int(s[count]) == len(data) + 1:
        raise ValueError(f"truncated {what} data")
    return (s[:count] + 2).numpy(), recops.chain_values(t, 1, 2, len(data), s[:count]).numpy()


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

LEN_BUCKET = 32  # row widths are padded to a multiple of this


def bucket_len(length: int) -> int:
    return max(LEN_BUCKET, -(-length // LEN_BUCKET) * LEN_BUCKET)


def _check_overflow(block: RecordBlock) -> None:
    """Fail-fast guard against silent N loss on very long reads
    (compress.go:477-488): a v1/v2 record longer than 65,536 bp with a
    non-ACGT byte past that position cannot be represented (u16 N
    positions). The scan found the first such record."""
    row = block.overflow_row
    if row is not None:
        raise refops.ambiguous_overflow_error(f"record {row}", int(block.dev_offsets[row, 3]))


class PendingStreams:
    """One block's raw streams on their way to the host: the buffer the
    stream build wrote, copied back after the work enqueued before it (the
    device buffer is kept for the passes that read a stream where it lies).
    :meth:`result` waits for the copy."""

    def __init__(self, block: RecordBlock, sizes: list[int], buf: torch.Tensor,
                 info: torch.Tensor):
        self.n = block.n
        self.bases = block.total_bases
        self.sizes = sizes
        self.device_buffer = buf
        self.header_lengths = block.dev_offsets[:, 1]
        cuda = buf.device.type == "cuda"
        self.buf = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=cuda)
        self.info = torch.empty(info.shape, dtype=info.dtype, pin_memory=cuda)
        self.buf.copy_(buf, non_blocking=True)
        self.info.copy_(info, non_blocking=True)
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def result(self) -> RawStreams:
        if self.event is not None:
            self.event.synchronize()
        npos_bytes, seq_bytes = (int(x) for x in self.info)
        if (npos_bytes, seq_bytes) != (self.sizes[4], self.sizes[0]):
            raise RuntimeError(
                f"stream build disagrees with the scan: npos {npos_bytes} / "
                f"{self.sizes[4]} bytes, seq {seq_bytes} / {self.sizes[0]}")
        host = self.buf.numpy()
        parts, offsets = [], [0]
        for size in self.sizes:
            parts.append(host[offsets[-1] : offsets[-1] + size].tobytes())
            offsets.append(offsets[-1] + size)
        return RawStreams(*parts, num_records=self.n, original_seq_size=self.bases,
                          original_qual_size=self.bases, device_buffer=self.device_buffer,
                          device_offsets=tuple(offsets), header_lengths=self.header_lengths)


def encoded_to_raw_streams(
    block: RecordBlock, enc, wide_npos: bool = False
) -> PendingStreams:
    """The stream build of one block from its dense encode outputs ``enc``
    (:class:`..ops.device.DenseEncoded`, on the block's device; rows past
    ``block.n`` are bucket padding and ignored): one kernel writes the six
    streams into one device buffer, which is copied back to the host."""
    from ..ops import cuda_kernels

    if block.max_field > 0xFFFF:
        raise ValueError("record field longer than 65535 bytes")
    sizes = recops.stream_sizes(block.info, wide_npos)
    buf, info = cuda_kernels.streams_build(
        block.dev_text, block.dev_offsets, enc.packed, enc.qual_delta,
        enc.nmask_bits, enc.n_counts, wide_npos, sizes,
    )
    return PendingStreams(block, sizes, buf, info)


def dispatch_raw_streams(
    block: RecordBlock, qual_offset: int, wide_npos: bool = False,
    rows: int | None = None,
) -> PendingStreams:
    """Enqueue one block's stream build on the current stream of its
    device: its sequences and qualities gathered into padded (``rows``,
    bucketed length) matrices from the scanned text, the dense encode, the
    stream build and the copy back. ``wide_npos`` selects the v3 u32
    N-position layout and lifts the v1/v2 tracking cap."""
    from ..ops import cuda_kernels

    if not wide_npos:
        _check_overflow(block)
    dev = block.device
    if dev.type == "cuda":  # the block's tensors are read on this stream
        stream = torch.cuda.current_stream(dev)
        block.dev_text.record_stream(stream)
        block.dev_offsets.record_stream(stream)
    rows = block.n if rows is None else rows
    width = bucket_len(block.max_len)
    lengths = torch.zeros((rows,), dtype=torch.int32, device=dev)
    lengths[: block.n] = block.dev_offsets[:, 3]
    enc = cuda_kernels.encode_arrays(
        block.rows("seq", rows, width), block.rows("qual", rows, width), lengths,
        qual_offset,
        npos_cap=refops.NPOS_CAP_WIDE if wide_npos else refops.MAX_SEQUENCE_LENGTH,
    )
    return encoded_to_raw_streams(block, enc, wide_npos)


def block_to_raw_streams(
    block: RecordBlock, qual_offset: int, wide_npos: bool = False
) -> RawStreams:
    """One block's uncompressed streams, built on its device (the stream
    build of :func:`dispatch_raw_streams`, waited for)."""
    return dispatch_raw_streams(block, qual_offset, wide_npos).result()


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
    device=None,
    wide_npos: bool = False,
) -> bytes:
    """Reconstruct the block's FASTQ text (compress.go:944-1078) on
    ``device`` (default: the CPU, the kernels' plain versions): the six
    streams go to the device in one copy, the packed and quality-delta rows
    are gathered there by one launch (:func:`..ops.cuda_kernels.rows_gather`), decoded by
    the dense kernel and assembled with N restored
    (:func:`..ops.cuda_kernels.fastq_assemble`); the text comes back in one
    copy. Faults are raised in the order of the reference's checks:
    truncated length, sequence, quality and N position data, invalid N
    positions, truncated header and plus-line payload data."""
    from ..ops import cuda_kernels

    dev = torch.device("cpu" if device is None else device)
    r = ds.num_records
    if len(ds.lengths) < 4 * r:
        raise container.FormatError("truncated length data")
    lengths = ds.lengths[: 4 * r].view("<u4").astype(np.int64)
    # the host holds the lengths already: checking them here bounds the
    # device matrices by the streams they come from
    if int(((lengths + 3) >> 2).sum()) > len(ds.seq):
        raise container.FormatError("truncated sequence data")
    if int(lengths.sum()) > len(ds.qual):
        raise container.FormatError("truncated quality data")
    if r == 0:
        return b""
    width = bucket_len(int(lengths.max()))
    parts = [ds.lengths[: 4 * r], ds.seq, ds.qual, ds.headers, ds.plus, ds.npos]
    cuda = dev.type == "cuda"
    staged = torch.empty(sum(len(p) for p in parts), dtype=torch.uint8, pin_memory=cuda)
    view, at, bounds = staged.numpy(), 0, []
    for p in parts:
        view[at : at + len(p)] = np.frombuffer(p, np.uint8)
        bounds.append((at, at + len(p)))
        at += len(p)
    on_dev = staged.to(dev, non_blocking=True)
    len_t, seq_t, qual_t, hdr_t, plus_t, npos_t = (on_dev[a:b] for a, b in bounds)
    lens = len_t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    # one launch: the quality deltas and, beside them, the packed bases
    deltas, packed = cuda_kernels.rows_gather(qual_t, None, lens, r, width, 0,
                                              quarter=(seq_t, width // 4))
    seq_rows, qual_rows = cuda_kernels.decode_arrays(
        packed, deltas, lens.to(torch.int32), qual_offset)
    out, info = cuda_kernels.fastq_assemble(
        seq_rows, qual_rows, lens, hdr_t, plus_t if len(ds.plus) else None, npos_t,
        wide_npos, len(ds.lengths), len(ds.seq), len(ds.qual),
    )
    out_h = torch.empty(out.shape, dtype=out.dtype, pin_memory=cuda)
    info_h = torch.empty(info.shape, dtype=info.dtype, pin_memory=cuda)
    out_h.copy_(out, non_blocking=True)
    info_h.copy_(info, non_blocking=True)
    if cuda:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    total, flags = (int(x) for x in info_h)
    fault = recops.fault_message(flags)
    if fault is not None:
        bit, msg = fault
        # the header and plus-line walks raise ValueError, the rest FormatError
        raise (ValueError if bit >= 5 else container.FormatError)(msg)
    return out_h.numpy()[:total].tobytes()
