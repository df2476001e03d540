"""FQZ v3 "native" pipeline: device-resident entropy coding + block CRC32.

The port of ``fastqpacker_tpu/pipeline/native.py`` (its per-block path; the
port has no C++ whole-file runtime). Container layout is the v2 layout plus
a CRC32 field in the block header (format/container.py). Each stream's
codec is picked by measured or estimated size and named by a 1-byte tag:

  seq      -> zstd / order-0 rANS / order-k context model / LDM zstd
              / device context model (TAG_WCTX, written by the mesh path)
  qual     -> zstd / order-0 rANS / order-1/2 context model / TAG_WCTX
  headers  -> token-delta + zstd / zstd
  plus, npos, lengths -> zstd, untagged

The CRC32 (IEEE, zlib polynomial) is computed over the concatenated
*uncompressed* streams in wire order and verified after entropy decode —
an explicit integrity field replacing the zstd frame checksums that v1/v2
inherit from the reference.

On ``device="cuda"`` the dense block transforms, the CRC32 of every stream
at or above ``crc32.MIN_DEVICE_BYTES`` and every picked order-0 rANS stream
run on the card; there is no transfer probe and no route to a host coder.
Blocks are coded on a pool of worker threads, each on its own CUDA stream
(:func:`..ops.device.worker_stream`).
"""

from __future__ import annotations

import io
from typing import BinaryIO, Optional

import numpy as np
import torch

from ..entropy import zstd as zstd_entropy
from ..format import container
from ..ops import crc32 as dcrc
from ..ops import device as devops
from ..ops import qualctx, rans, seqctx, sldm, tokenize, wctx
from ..ops import reference as refops
from ..parser.fastq import FastqStreamParser, RecordBlock
from ..utils import varlen
from ..utils.inmem import source_view
from . import api
from . import blocks as blockcodec

# Per-stream codec policy in v2+ wire order (seq, qual, headers, plus,
# npos, lengths): "seq"/"rans" streams carry a 1-byte tag choosing their
# codec empirically; "tok" streams choose token-delta+zstd or plain zstd;
# "zstd" streams are untagged zstd.
STREAM_CODECS = ("seq", "rans", "tok", "zstd", "zstd", "zstd")

# Below this size the rANS per-stream overhead (lane state table + freq
# table, ~1.5 KB at 256 lanes) dominates; fall back to zstd. Each
# rANS-eligible stream carries a 1-byte codec tag so the decoder knows.
RANS_MIN_BYTES = 16384
# wire tag values live in format/container.py
TAG_RANS = container.TAG_RANS
TAG_ZSTD = container.TAG_ZSTD
TAG_TOK = container.TAG_TOK
TAG_QCTX = container.TAG_QCTX
TAG_SCTX = container.TAG_SCTX
TAG_SLDM = container.TAG_SLDM
TAG_WCTX = container.TAG_WCTX


def _rans_size_estimate(view: torch.Tensor) -> tuple[int, np.ndarray]:
    """Exact order-0 rANS output size from the histogram (pre-encode), and
    the histogram.

    rANS emits sum(count_k * log2(PROB_SCALE / freq_k)) bits to within
    lane-padding noise; adding the table/state overhead gives a faithful
    estimate without running the coder. The histogram is ``fq_hist256``'s,
    on ``view``: the stream where the stream build left it. It is handed
    back so that a stream that picks rANS builds its table from it
    (``rans.encode_stream(..., view=, hist=)``) and is not counted again.
    """
    hist = rans.histogram(view)
    freq = rans.normalize_freqs(hist.copy()).astype(np.float64)
    nz = hist > 0
    bits = float(
        np.sum(hist[nz] * (np.log2(rans.PROB_SCALE) - np.log2(freq[nz])))
    )
    lanes = rans._pick_lanes(view.numel())
    overhead = 8 + 512 + 4 * lanes + 4  # header + freqs + states + total
    return int(bits / 8) + overhead, hist


def _zstd_candidate(codec, s) -> bytes:
    """The zstd candidate frame: adaptive (probe + stored raw-block frames
    for incompressible streams). Frames are self-describing, so decode is
    unaffected."""
    return codec.compress_adaptive(s)


# A context-coder pick must beat the cheap competition by this factor
# before its coder runs: on uncorrelated DNA sctx still "wins" by the
# pack's padding bits + zstd framing (<1%), which is not worth running
# a slower coder both directions. --max-ratio waives the margin.
SCTX_WIN_MARGIN = 0.98


class PickMemo:
    """Cross-block probe memoization.

    Blocks of one file share statistics: on structure-free data the
    sctx sampling probe and the coverage probe reach the same "skip"
    verdict on every block — pure per-block waste. After ``STREAK`` consecutive negative probes, later blocks skip the
    probe and only re-check every ``PROBE_EVERY``-th block, so a
    mid-file statistics change (e.g. coverage appearing) is detected at
    most ``PROBE_EVERY - 1`` blocks late; any positive probe resets the
    streak and probing resumes for every block. One instance per
    compress invocation, shared across the worker pool (counter updates
    are GIL-atomic; a lost increment only shifts WHICH block re-probes).
    ``None`` (the default everywhere) preserves probe-every-block
    behavior bit-for-bit.
    """

    PROBE_EVERY = 4
    STREAK = 2

    def __init__(self) -> None:
        self._sctx_miss = 0
        self._sctx_seen = 0
        self._cov_miss = 0
        self._cov_seen = 0

    def sctx_should_probe(self) -> bool:
        self._sctx_seen += 1
        if self._sctx_miss < self.STREAK:
            return True
        return self._sctx_seen % self.PROBE_EVERY == 0

    def sctx_outcome(self, hopeless: bool) -> None:
        self._sctx_miss = self._sctx_miss + 1 if hopeless else 0

    def cov_should_probe(self) -> bool:
        self._cov_seen += 1
        if self._cov_miss < self.STREAK:
            return True
        return self._cov_seen % self.PROBE_EVERY == 0

    def cov_outcome(self, hit: bool) -> None:
        self._cov_miss = 0 if hit else self._cov_miss + 1


def _encode_tagged_seq(
    s: bytes,
    view: torch.Tensor,
    lengths: np.ndarray,
    codec,
    dev: torch.device,
    max_ratio: bool = False,
    seq_dict: np.ndarray | None = None,
    memo: "PickMemo | None" = None,
) -> bytes:
    """Sequence-stream pick: zstd vs order-0 rANS vs order-k context
    model over the unpacked bases, by estimated-then-verified size
    (``view``: the stream on the device, for its histogram).

    The 2-bit pack makes packed bytes near-uniform, so the order-0
    candidates floor at ~2 bits/base; the context model is the only one
    that can go below on real (correlated) DNA. Its histogram pass is
    one cheap sweep, so it is always estimated; the coder only runs
    when the estimate beats the measured/estimated competition by
    :data:`SCTX_WIN_MARGIN` (or at all, under --max-ratio).
    """
    z = _zstd_candidate(codec, s)
    if len(s) < RANS_MIN_BYTES:
        return bytes([TAG_ZSTD]) + z
    r0, hist0 = _rans_size_estimate(view)
    bar = min(len(z), r0)
    margin = 1.0 if max_ratio else SCTX_WIN_MARGIN
    s_arr = np.frombuffer(s, np.uint8)
    best: Optional[bytes] = None
    bases = None
    est_s = None
    try:
        sctx_hopeless = False
        if not max_ratio:
            # sampled pre-gate: skip the full histogram pass when even
            # the optimistic sampled projection cannot reach the margin;
            # a streak of hopeless blocks skips the probe itself
            if memo is not None and not memo.sctx_should_probe():
                sctx_hopeless = True
            else:
                proj = seqctx.sample_estimate(s_arr, lengths, device=dev)
                sctx_hopeless = proj is not None and proj >= bar * margin
                if memo is not None:
                    memo.sctx_outcome(sctx_hopeless)
        if not sctx_hopeless:
            bases, hist6 = seqctx.prepare(s_arr, lengths, dev)
            _, est_s = seqctx.pick_order(hist6)
    except seqctx.SctxError:
        est_s = None
    if est_s is not None and est_s < bar * margin:
        q = seqctx.encode_prepared(bases, lengths, hist6)
        if len(q) < bar:
            best, bar = bytes([TAG_SCTX]) + q, len(q)
    # coverage-redundancy candidate: unpacked codes + zstd-LDM.
    # Always measured under --max-ratio; the default pipeline runs it
    # only when the sampled 16-mer duplicate probe sees block-local
    # coverage (so coverage-free data never pays the LDM pass).
    try:
        run_cov = seq_dict is not None or max_ratio
        if not run_cov and (memo is None or memo.cov_should_probe()):
            run_cov = sldm.coverage_probe(s_arr) >= sldm.DUP_THRESHOLD
            if memo is not None:
                memo.cov_outcome(run_cov)
        if run_cov:
            d = (
                sldm.encode_bases(bases.numpy(), prefix=seq_dict)
                if bases is not None
                else sldm.encode(s_arr, lengths, prefix=seq_dict)
            )
            if len(d) < bar:
                best, bar = bytes([TAG_SLDM]) + d, len(d)
    except ValueError:
        pass
    if best is not None:
        return best
    if r0 < len(z):
        r = rans.encode_stream(s, device=dev, view=view, hist=hist0)
        if len(r) < len(z):
            return bytes([TAG_RANS]) + r
    return bytes([TAG_ZSTD]) + z


def _encode_tagged_headers(
    s: bytes, view: torch.Tensor, count: int, codec, cost_gate: int = 0,
    lengths: torch.Tensor | None = None,
) -> bytes:
    """Header stream pick: token-delta transform vs raw, both zstd-coded.
    The transform runs where ``view``, the stream the stream build left on
    the device, lies (``fq_tok_encode``), its record starts from
    ``lengths``, the header lengths it was built from, when given.

    The transform wins whenever headers share structure between records
    (the overwhelmingly common case); degenerate inputs (every header
    unique noise) fall back to plain zstd by measured size.

    ``cost_gate``: skip the tokenizer when plain zstd already shrinks the
    stream below this byte count — the absolute saving is then immaterial
    next to the block's other streams.
    Only applies to streams big enough for the tokenizer pass to cost
    real CPU; small blocks always try. --max-ratio passes 0 to always
    try.
    """
    z = _zstd_candidate(codec, s)
    if cost_gate and len(z) <= cost_gate and len(s) > (256 << 10):
        return bytes([TAG_ZSTD]) + z
    try:
        # a malformed stream falls back to zstd; a kernel that fails to build
        # or launch raises RuntimeError
        tok = tokenize.encode(view, count, lengths=lengths)
    except ValueError:
        return bytes([TAG_ZSTD]) + z
    zt = _zstd_candidate(codec, tok)
    if len(zt) < len(z):
        return bytes([TAG_TOK]) + zt
    return bytes([TAG_ZSTD]) + z


def _decode_tagged(
    chunk: bytes,
    codec,
    dev: torch.device,
    count: int = 0,
    lengths=None,
    seq_dict=None,
    runtime: bool = False,
) -> bytes:
    """Decode one tagged stream; ``runtime``: with the qctx checks of the
    JAX package's whole-file decoder."""
    if len(chunk) == 0:
        raise container.FormatError("truncated block payload")
    tag, payload = chunk[0], chunk[1:]
    if tag == TAG_RANS:
        return rans.decode_stream(payload, device=dev)
    if tag == TAG_ZSTD:
        return codec.decompress(payload)
    if tag == TAG_TOK:
        try:
            return tokenize.decode(codec.decompress(payload), count, device=dev)
        except ValueError as e:
            raise container.FormatError(str(e)) from None
    if tag == TAG_QCTX:
        if lengths is None:
            raise container.FormatError(
                "qctx stream outside the quality slot"
            )
        try:
            return qualctx.decode(payload, lengths, runtime_checks=runtime, device=dev)
        except ValueError as e:
            raise container.FormatError(str(e)) from None
    if tag == TAG_SCTX:
        if lengths is None:
            raise container.FormatError(
                "sctx stream outside the sequence slot"
            )
        try:
            return seqctx.decode(payload, lengths, device=dev)
        except ValueError as e:
            raise container.FormatError(str(e)) from None
    if tag == TAG_SLDM:
        if lengths is None:
            raise container.FormatError(
                "sldm stream outside the sequence slot"
            )
        try:
            return sldm.decode(payload, lengths, prefix=seq_dict)
        except ValueError as e:
            raise container.FormatError(str(e)) from None
    if tag == TAG_WCTX:
        if lengths is None:
            raise container.FormatError(
                "wctx stream outside the sequence/quality slots"
            )
        try:
            # packed wire rows (sequence model) or the per-record delta
            # stream (qualities), built on the device from its decode
            return wctx.decode_wire(payload, lengths, device=dev)
        except ValueError as e:
            raise container.FormatError(str(e)) from None
    raise container.FormatError(f"unknown stream codec tag: {tag}")


def _encode_tagged_qual(
    s: bytes, view: torch.Tensor, lengths: np.ndarray, codec, order1: bool,
    dev: torch.device,
) -> bytes:
    """Quality-stream pick: zstd vs order-0 rANS vs order-1 context
    model, by estimated-then-verified size (``view``: the stream on the
    device, for its histogram).

    The order-1 candidate is always allowed to replace a would-be order-0
    rANS pick when it is smaller (its decode is a chain a chunk on the
    card, ``fq_qctx_decode``, slower than the order-0 decode's lanes);
    with ``order1`` (--max-ratio) it may also replace zstd on estimated
    size alone — the speed-for-ratio trade the user asked for.
    """
    z = _zstd_candidate(codec, s)
    if len(s) < RANS_MIN_BYTES:
        return bytes([TAG_ZSTD]) + z
    r0, hist0 = _rans_size_estimate(view)
    bar = min(len(z), r0)
    # The context model may also replace a winning zstd when it beats it
    # by the same margin policy as the seq pick (SCTX_WIN_MARGIN) —
    # momentum-shaped qualities (delta alphabet small but order-1/2
    # structure strong) lose badly otherwise. A sampled pre-gate
    # keeps the full histogram pass off streams with no structure.
    try_qctx = order1 or r0 < len(z)
    if not try_qctx:
        proj = qualctx.sample_estimate(np.frombuffer(s, np.uint8), lengths, device=dev)
        try_qctx = proj is None or proj < bar * SCTX_WIN_MARGIN
    if try_qctx:
        try:
            raw, hist2 = qualctx.prepare(np.frombuffer(s, np.uint8), lengths, dev)
            _, est1 = qualctx.pick_model(hist2)
        except qualctx.QctxError:
            est1 = None
        margin = 1.0 if (order1 or r0 < len(z)) else SCTX_WIN_MARGIN
        if est1 is not None and est1 < bar * margin:
            q = qualctx.encode_prepared(raw, lengths, hist2)
            if len(q) < bar:
                return bytes([TAG_QCTX]) + q
    if r0 < len(z):
        r = rans.encode_stream(s, device=dev, view=view, hist=hist0)
        if len(r) < len(z):
            return bytes([TAG_RANS]) + r
    return bytes([TAG_ZSTD]) + z


def _crc_streams(ordered: list[bytes], dev: torch.device) -> int:
    """CRC32 of the concatenated streams: each stream's CRC on ``dev``
    (chunk-parallel kernel; zlib below ``crc32.MIN_DEVICE_BYTES``), joined
    on the host with the GF(2) combine."""
    crc = 0
    for s in ordered:
        crc = dcrc.crc32_combine(crc, dcrc.crc32_device(s, dev), len(s))
    return crc & 0xFFFFFFFF


def _lossless_extra(blk: RecordBlock, lengths: np.ndarray) -> bytes:
    """FLAG_LOSSLESS payload appended to the npos slot:
    little-endian-packed per-base lowercase bits (record-concatenated,
    ceil(total/8) bytes) followed by one verbatim byte per npos entry
    (the original non-ACGT symbols, in npos order). Sizes are derivable
    from the lengths and npos streams, so the blob is self-locating."""
    seq = blk.seq
    w = seq.shape[1]
    col = np.arange(w, dtype=np.int64)[None, :]
    in_len = col < lengths[:, None]
    lower = (seq >= 97) & (seq <= 122) & in_len
    flat_bits = varlen.flatten_rows(
        lower.astype(np.uint8), lengths
    )
    case_bytes = np.packbits(flat_bits, bitorder="little").tobytes()
    amb = refops.ambiguity_mask(seq, lengths, refops.NPOS_CAP_WIDE)
    rows, cols = np.nonzero(amb)
    exotic = seq[rows, cols].tobytes()
    return case_bytes + exotic


def _apply_lossless_extra(
    text: bytearray,
    extra: np.ndarray,
    lengths: np.ndarray,
    hdr_lens: np.ndarray,
    plus_lens: np.ndarray,
    n_counts: np.ndarray,
    n_rows: np.ndarray,
    n_pos: np.ndarray,
) -> None:
    """Restore case and verbatim exotic bytes on assembled FASTQ text."""
    total = int(lengths.sum())
    case_len = -(-total // 8)
    n_exotic = int(n_counts.sum())
    if len(extra) != case_len + n_exotic:
        raise container.FormatError("truncated lossless side data")
    # absolute offset of each record's sequence line within the text
    rec_sizes = (
        (hdr_lens + 2) + (lengths + 1) + (plus_lens + 2) + (lengths + 1)
    )
    rec_offs = np.zeros(len(lengths), dtype=np.int64)
    if len(lengths) > 1:
        np.cumsum(rec_sizes[:-1], out=rec_offs[1:])
    seq_line = rec_offs + hdr_lens + 2
    buf = np.frombuffer(text, np.uint8)
    if n_exotic:
        dst = seq_line[n_rows] + n_pos
        buf[dst] = extra[case_len:]
    bits = np.unpackbits(extra[:case_len], bitorder="little", count=total)
    idx = np.flatnonzero(bits)
    if len(idx):
        # map flat base index -> (record, in-record position)
        starts = np.zeros(len(lengths), dtype=np.int64)
        if len(lengths) > 1:
            np.cumsum(lengths[:-1], out=starts[1:])
        rec = np.searchsorted(starts, idx, side="right") - 1
        pos = idx - starts[rec]
        dst = seq_line[rec] + pos
        buf[dst] |= 0x20


def _raw_streams(blk: RecordBlock, qual_offset: int) -> blockcodec.RawStreams:
    """One block's uncompressed v3 streams, built on the device the parser
    scanned the block on."""
    return blockcodec.block_to_raw_streams(blk, qual_offset, wide_npos=True)


def encode_block_native(
    blk: RecordBlock,
    qual_offset: int,
    dev: torch.device,
    order1_qual: bool = False,
    seq_dict: np.ndarray | None = None,
    raw=None,
    lossless: bool = False,
    memo: "PickMemo | None" = None,
) -> bytes:
    """Encode one record block to v3 wire bytes (header + tagged
    streams), with the device programs on ``dev``. ``raw``: precomputed
    RawStreams for this block (the dict probe already built block 0's;
    don't build them twice)."""
    # --max-ratio also buys a stronger zstd for whatever stays
    # zstd-coded (frames are self-describing; decode is unaffected)
    codec = (
        zstd_entropy.ZstdCodec(level=9)
        if order1_qual
        else zstd_entropy.get_codec()
    )
    if raw is None:
        raw = _raw_streams(blk, qual_offset)
    if lossless:
        lens64 = blk.lengths.astype(np.int64)
        raw.npos = np.concatenate(
            [
                np.frombuffer(raw.npos, np.uint8),
                np.frombuffer(_lossless_extra(blk, lens64), np.uint8),
            ]
        )
    ordered = raw.ordered(container.VERSION_2)
    crc = _crc_streams(ordered, dev)
    comp = []
    for i, (s, policy) in enumerate(zip(ordered, STREAM_CODECS)):
        if i == 1 and policy == "rans":
            lengths = np.frombuffer(ordered[5], "<u4").astype(np.int64)
            comp.append(
                _encode_tagged_qual(s, raw.device_view(1), lengths, codec,
                                    order1_qual, dev)
            )
        elif policy == "seq":
            lengths = np.frombuffer(ordered[5], "<u4").astype(np.int64)
            comp.append(
                _encode_tagged_seq(
                    s, raw.device_view(0), lengths, codec, dev, order1_qual,
                    seq_dict, memo,
                )
            )
        elif policy == "tok":
            # default pipeline: tokenizing is only worth its CPU when the
            # plain-zstd header stream is a visible fraction of the
            # block's OUTPUT (seq+qual, already coded in wire order,
            # carry almost all of it — ~0.8% threshold); --max-ratio
            # always tries
            gate = (
                0
                if order1_qual
                else max(4096, (len(comp[0]) + len(comp[1])) >> 7)
            )
            comp.append(
                _encode_tagged_headers(s, raw.device_view(2), raw.num_records,
                                       codec, gate, raw.header_lengths)
            )
        else:
            comp.append(_zstd_candidate(codec, s))
    hdr = container.BlockHeader(
        num_records=raw.num_records,
        seq_data_size=len(comp[0]),
        qual_data_size=len(comp[1]),
        header_data_size=len(comp[2]),
        plus_data_size=len(comp[3]),
        npositions_size=len(comp[4]),
        seq_lengths_size=len(comp[5]),
        original_seq_size=raw.original_seq_size,
        original_qual_size=raw.original_qual_size,
        crc32=crc,
    )
    return hdr.to_bytes(container.VERSION_3_NATIVE) + b"".join(comp)


def compress_native(
    r: BinaryIO,
    w: BinaryIO,
    opts: Optional[api.Options] = None,
    device=None,
) -> None:
    """Compress FASTQ from ``r`` into an FQZ v3 container on ``w`` with
    the device programs on ``device`` (default: the CUDA card)."""
    dev = devops.resolve_device(device)
    opts = opts or api.Options()
    block_size = api.resolve_block_size(opts)

    parser = FastqStreamParser(r, block_size=block_size, device=dev)
    block_iter = parser.blocks()
    # Phred detection from the reference's fixed min(100k, file)-record
    # window regardless of -b (compress.go:48-52,137-154).
    peeked, qual_offset = api.peek_detection(block_iter)
    first_block = peeked[0] if len(peeked) > 0 else None
    second_block: Optional[RecordBlock] = (
        peeked[1] if len(peeked) > 1 else None
    )
    if first_block is not None and second_block is None:
        # peek one more block (the reference's exact-one-block detect):
        # a single-block container gains nothing from a
        # cross-block dictionary — its window already spans everything
        for blk in block_iter:
            second_block = blk
            peeked.append(blk)
            break
    flags = opts.flags | (
        container.FLAG_PHRED64
        if qual_offset == refops.PHRED64_OFFSET
        else 0
    )
    if opts.lossless:
        flags |= container.FLAG_LOSSLESS

    # Cross-block sequence dictionary: when block 0's coverage
    # probe fires, its leading unpacked codes become a container-level
    # LDM prefix shared by every TAG_SLDM stream, so coverage matches
    # cross block boundaries (a per-block window forfeits them). Gated on
    # the probe in both modes: coverage-free data never pays the
    # section. Decided before the header write — the flag and
    # section precede the first block on the wire.
    seq_dict = None
    raw0 = None
    if (
        first_block is not None
        and first_block.n > 0
        and second_block is not None
    ):
        with devops.worker_stream(dev):
            raw0 = _raw_streams(first_block, qual_offset)
        packed0 = np.frombuffer(raw0.seq, np.uint8)
        if sldm.coverage_probe(packed0) >= sldm.DUP_THRESHOLD:
            lens0 = np.frombuffer(raw0.lengths, "<u4").astype(np.int64)
            try:
                seq_dict = sldm.build_dict(packed0, lens0)
                flags |= container.FLAG_SEQ_DICT
            except ValueError:
                seq_dict = None

    container.FileHeader(
        version=container.VERSION_3_NATIVE,
        block_size=block_size,
        flags=flags,
    ).write(w)
    if seq_dict is not None:
        container.write_seq_dict_section(
            w, sldm.compress_dict(seq_dict), len(seq_dict)
        )
    if first_block is None:
        return

    def all_blocks():
        yield from peeked
        yield from block_iter

    memo = PickMemo()

    def encode_one(blk: RecordBlock) -> bytes:
        with devops.worker_stream(dev):
            return encode_block_native(
                blk, qual_offset, dev, opts.order1_qual, seq_dict,
                raw=raw0 if blk is first_block else None,
                lossless=opts.lossless, memo=memo,
            )

    api.ordered_map_write(
        w, all_blocks(), encode_one, api._resolve_workers(opts.workers)
    )


def _declares_nothing(slot: int, chunk: bytes, nrec: int) -> bool:
    """Whether the JAX package's whole-file decoder leaves tagged stream
    ``chunk`` empty, for the block CRC to judge: an empty slot, or a stream
    header that declares no decoded bytes (bar TAG_TOK)."""
    return not chunk or (
        chunk[0] != TAG_TOK
        and blockcodec.v3_stream_raw_size(slot, chunk[0], chunk[1:], nrec) == 0
    )


def decode_block_payload(
    hdr: container.BlockHeader,
    payload: bytes,
    codec,
    qual_offset: int,
    dev: torch.device,
    seq_dict: np.ndarray | None = None,
    lossless: bool = False,
    predecoded: dict | None = None,
    runtime: bool = False,
) -> bytes:
    """Decode one v3 block payload (streams after the header) to FASTQ
    text, verifying the block CRC32, with the device programs on
    ``dev``. ``predecoded`` maps stream slots (0=seq, 1=qual) to raw bytes
    already entropy-decoded elsewhere (the batch decoder of
    pipeline/meshpipe.py); the CRC check below still covers them, so a
    wrong batched decode fails exactly like corrupt data. ``runtime``: a
    tagged stream fails as the JAX package's whole-file decoder says
    (:func:`.blocks.runtime_stream_errors`), decided for the file by the
    caller (:func:`.api.runtime_decodes`)."""
    sizes = hdr.stream_sizes(container.VERSION_2)
    if len(payload) < sum(sizes):
        raise container.FormatError("truncated block payload")
    offs = [0]
    for size in sizes:
        offs.append(offs[-1] + size)
    chunks = [payload[offs[i] : offs[i + 1]] for i in range(len(sizes))]
    # lengths (slot 5, plain zstd) decode first: the quality slot's
    # order-1 codec needs record boundaries
    lengths_bytes = codec.decompress(chunks[5])
    if len(lengths_bytes) % 4:
        raise container.FormatError("truncated sequence length data")
    lengths = np.frombuffer(lengths_bytes, "<u4").astype(np.int64)
    parts = []
    for i, (chunk, policy) in enumerate(zip(chunks, STREAM_CODECS)):
        if i == 5:
            parts.append(lengths_bytes)
        elif policy == "zstd":
            parts.append(codec.decompress(chunk))
        elif predecoded is not None and i in predecoded:
            parts.append(predecoded[i])
        elif runtime and _declares_nothing(i, chunk, hdr.num_records):
            parts.append(b"")
        else:
            # the sequence and quality context codecs need record
            # boundaries; the sequence slot may reference the dictionary
            with blockcodec.runtime_stream_errors(chunk[0] if chunk else -1, runtime):
                parts.append(_decode_tagged(
                    chunk, codec, dev, hdr.num_records,
                    lengths if i < 2 else None, seq_dict if i == 0 else None,
                    runtime,
                ))
    if _crc_streams(parts, dev) != hdr.crc32:
        raise container.FormatError("block CRC32 mismatch: corrupted data")
    npos_full = np.frombuffer(parts[4], np.uint8)
    extra = None
    n_counts = n_rows = n_pos = None
    if lossless:
        # FLAG_LOSSLESS: the npos slot carries [npos][case bits][exotic
        # bytes]; npos is self-delimiting, split after parsing it
        n_counts, n_rows, n_pos = blockcodec.parse_npos_stream(
            npos_full, hdr.num_records, wide=True
        )
        boundary = 4 * (hdr.num_records + int(n_counts.sum()))
        extra = npos_full[boundary:]
        npos_full = npos_full[:boundary]
    ds = blockcodec.DecodedStreams(
        seq=np.frombuffer(parts[0], np.uint8),
        qual=np.frombuffer(parts[1], np.uint8),
        headers=np.frombuffer(parts[2], np.uint8),
        plus=np.frombuffer(parts[3], np.uint8),
        npos=npos_full,
        lengths=np.frombuffer(parts[5], np.uint8),
        num_records=hdr.num_records,
    )
    text = blockcodec.streams_to_fastq(ds, qual_offset, dev, wide_npos=True)
    if lossless:
        hdr_starts, hdr_lens = blockcodec.parse_len16_stream(
            ds.headers, hdr.num_records, "header"
        )
        if len(ds.plus):
            _, plus_lens = blockcodec.parse_len16_stream(
                ds.plus, hdr.num_records, "plus-line payload"
            )
        else:
            plus_lens = np.zeros(hdr.num_records, np.int64)
        out = bytearray(text)
        _apply_lossless_extra(
            out, extra, lengths, hdr_lens, plus_lens,
            n_counts, n_rows, n_pos,
        )
        return bytes(out)
    return text


def decompress_native(
    r: BinaryIO,
    w: BinaryIO,
    fh: container.FileHeader,
    qual_offset: int,
    workers: int,
    device=None,
    seq_dict: np.ndarray | None = None,
    skip_sections: bool = False,
) -> None:
    """Decompress the blocks of a v3 container whose file header ``fh``
    has been read from ``r``, with the device programs on ``device``.
    ``skip_sections``: the caller has consumed the file's sections already
    (the multi-host stripe reader starts mid-file) and passes the decoded
    ``seq_dict`` itself."""
    dev = devops.resolve_device(device)
    if not skip_sections and fh.flags & container.FLAG_SEQ_DICT:
        raw_len, comp = container.read_seq_dict_section(r)
        try:
            seq_dict = sldm.decompress_dict(comp, raw_len)
        except ValueError as e:
            raise container.FormatError(str(e)) from None

    lossless = bool(fh.flags & container.FLAG_LOSSLESS)
    # A failing zstd frame or tagged stream is named as the JAX package's
    # default decoder names it, decided once for the file: its runtime takes
    # an addressable, non-lossless body whose first pass finds nothing to
    # hand back, and names the failure PAYLOAD_ZSTD_ERROR or its codec's
    # string; its Python decoder, which has the rest, keeps the per-block
    # decoders' strings.
    mapped = False
    if not lossless and (view := source_view(r)) is not None:
        r = io.BytesIO(view)
        mapped = api.runtime_decodes(view, w, fh.version)

    def read_jobs():
        while True:
            hdr = container.read_block_header(r, container.VERSION_3_NATIVE)
            if hdr is None:
                return
            payload_size = sum(hdr.stream_sizes(container.VERSION_2))
            payload = r.read(payload_size)
            yield hdr, payload

    def decode_one(job) -> bytes:
        hdr, payload = job
        codec = zstd_entropy.get_codec()
        with devops.worker_stream(dev), blockcodec.payload_zstd_errors(mapped):
            return decode_block_payload(
                hdr, payload, codec, qual_offset, dev, seq_dict,
                lossless=lossless, runtime=mapped,
            )

    api.ordered_map_write(w, read_jobs(), decode_one, workers)
