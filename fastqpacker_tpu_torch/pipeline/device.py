"""Device pipeline: FQZ v1/v2 compress and decompress on a torch device.

The port of ``fastqpacker_tpu/pipeline/device.py``. Compress: the main
thread parses a block, stages it padded in page-locked host memory, and
enqueues the host-to-device copy, the dense encode kernel and the copy
back on one CUDA stream; a thread pool waits for each block's copies and
does the host stream assembly and zstd. Decompress: the pool does zstd,
stream parsing, the dense decode on the same stream, N restore and FASTQ
assembly. An ordered in-flight window writes blocks in input order (the
reference's seqNum collector, compress.go:365-403).

Shapes are bucketed: records padded to the block size, read length to the
next multiple of ``LEN_BUCKET``. With ``device="cpu"`` the same pipeline
runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import contextlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import chain
from typing import BinaryIO, Optional

import numpy as np
import torch

from ..entropy import zstd as zstd_entropy
from ..format import container
from ..ops import cuda_kernels
from ..ops import device as devops
from ..ops import reference as refops
from ..parser.fastq import QUAL_PAD, SEQ_PAD, FastqStreamParser, RecordBlock
from . import api
from . import blocks as blockcodec

LEN_BUCKET = 32
V3_NOT_PORTED = "FQZ v3 is not yet ported"


def _bucket_len(l: int) -> int:
    return max(LEN_BUCKET, -(-l // LEN_BUCKET) * LEN_BUCKET)


class _Staging:
    """One pipeline run's device, its CUDA stream and host staging."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.stream = torch.cuda.Stream(dev) if self.cuda else None

    def host(self, shape, dtype, fill: int) -> torch.Tensor:
        """A filled host tensor, page-locked when the device is a card."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda).fill_(fill)

    def on_stream(self):
        if self.cuda:
            return torch.cuda.stream(self.stream)
        return contextlib.nullcontext()

    def to_device(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dev, non_blocking=True)

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        if not self.cuda:
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)

    def fence(self) -> Optional[torch.cuda.Event]:
        """An event after everything enqueued so far (None on the CPU)."""
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record(self.stream)
        return event


def _ordered_write(w: BinaryIO, tasks, workers: int) -> None:
    """Run each ``(fn, *args)`` of ``tasks`` on a pool of ``workers``
    threads and write the results in input order, with at most
    ``workers + 1`` in flight. ``tasks`` is consumed on the calling
    thread, so device work enqueued while producing it stays in order."""
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = deque()
        for fn, *args in tasks:
            pending.append(pool.submit(fn, *args))
            while len(pending) > workers:
                w.write(pending.popleft().result())
        while pending:
            w.write(pending.popleft().result())


def _dispatch_encode(
    st: _Staging, blk: RecordBlock, qual_offset: int, r_pad: int
):
    """Stage one block padded to ``(r_pad, bucketed length)`` and enqueue
    its copy in, the encode and the copies out; returns the host outputs
    and the event that says they have landed."""
    refops.check_ambiguous_overflow(blk.seq, blk.lengths.astype(np.int64))
    l_pad = _bucket_len(blk.max_len)
    seq = st.host((r_pad, l_pad), torch.uint8, SEQ_PAD)
    qual = st.host((r_pad, l_pad), torch.uint8, QUAL_PAD)
    lengths = st.host((r_pad,), torch.int32, 0)
    seq.numpy()[: blk.n, : blk.max_len] = blk.seq
    qual.numpy()[: blk.n, : blk.max_len] = blk.qual
    lengths.numpy()[: blk.n] = blk.lengths
    with st.on_stream():
        enc = cuda_kernels.encode_arrays(
            st.to_device(seq), st.to_device(qual), st.to_device(lengths),
            qual_offset,
        )
        return [st.to_host(x[: blk.n]) for x in enc], st.fence()


def _finish_block(blk: RecordBlock, staged, version: int) -> bytes:
    outs, event = staged
    if event is not None:
        event.synchronize()
    enc = refops.EncodedArrays(*(t.numpy() for t in outs))
    raw = blockcodec.encoded_to_raw_streams(blk, enc)
    return blockcodec.compress_raw_streams(
        raw, zstd_entropy.get_codec(), version
    )


def compress_device(
    r: BinaryIO,
    w: BinaryIO,
    opts: Optional[api.Options] = None,
    device=None,
) -> None:
    """Compress FASTQ from ``r`` into an FQZ v1/v2 container on ``w`` with
    the dense block encode on ``device`` (default: the CUDA card)."""
    dev = devops.resolve_device(device)
    opts = opts or api.Options()
    if opts.version == container.VERSION_3_NATIVE:
        raise NotImplementedError(V3_NOT_PORTED)
    block_size = api.resolve_block_size(opts)
    block_iter = FastqStreamParser(r, block_size=block_size).blocks()

    # Phred detection from the reference's fixed min(100k, file)-record
    # window regardless of -b (compress.go:48-52,137-154).
    peeked, qual_offset = api.peek_detection(block_iter)
    flags = container.FLAG_PHRED64 if qual_offset == refops.PHRED64_OFFSET else 0
    container.FileHeader(
        version=opts.version, block_size=block_size, flags=flags
    ).write(w)
    if not peeked:
        return

    st = _Staging(dev)
    tasks = (
        (
            _finish_block,
            blk,
            _dispatch_encode(st, blk, qual_offset, block_size),
            opts.version,
        )
        for blk in chain(peeked, block_iter)
    )
    _ordered_write(w, tasks, api._resolve_workers(opts.workers))


def _padded_decoder(st: _Staging, r_pad: int) -> blockcodec.DecodeArraysFn:
    """The numpy-facing dense decode on ``st``'s device, with shape
    bucketing (R padded to the block size, L to ``LEN_BUCKET``)."""

    def decode(packed, qual_delta, lengths, qual_offset):
        n, l = qual_delta.shape
        l_pad = _bucket_len(l)
        rp = max(r_pad, n)
        pk = st.host((rp, l_pad // 4), torch.uint8, 0)
        qd = st.host((rp, l_pad), torch.uint8, 0)
        ln = st.host((rp,), torch.int32, 0)
        pk.numpy()[:n, : packed.shape[1]] = packed
        qd.numpy()[:n, :l] = qual_delta
        ln.numpy()[:n] = lengths
        with st.on_stream():
            seq, qual = cuda_kernels.decode_arrays(
                st.to_device(pk), st.to_device(qd), st.to_device(ln),
                qual_offset,
            )
            seq_h, qual_h = st.to_host(seq[:n]), st.to_host(qual[:n])
            event = st.fence()
        if event is not None:
            event.synchronize()
        return seq_h.numpy()[:, :l], qual_h.numpy()[:, :l]

    return decode


def _read_blocks(r: BinaryIO, version: int):
    while True:
        hdr = container.read_block_header(r, version)
        if hdr is None:
            return
        payload_size = sum(hdr.stream_sizes(version))
        payload = r.read(payload_size)
        if len(payload) < payload_size:
            raise container.FormatError("truncated block payload")
        yield hdr, payload


def decompress_device(
    r: BinaryIO,
    w: BinaryIO,
    opts: Optional[api.DecompressOptions] = None,
    device=None,
) -> None:
    """Decompress an FQZ v1/v2 container from ``r`` into FASTQ text on
    ``w`` with the dense block decode on ``device`` (default: the card)."""
    dev = devops.resolve_device(device)
    opts = opts or api.DecompressOptions()
    fh = container.read_file_header(r)
    if fh.version == container.VERSION_3_NATIVE:
        raise NotImplementedError(V3_NOT_PORTED)
    if fh.version not in (container.VERSION_1, container.VERSION_2):
        raise container.FormatError(f"unsupported file version: {fh.version}")
    qual_offset = (
        refops.PHRED64_OFFSET if fh.phred64 else refops.PHRED33_OFFSET
    )
    decoder = _padded_decoder(_Staging(dev), max(int(fh.block_size), 1))

    def decode_one(hdr, payload) -> bytes:
        ds = blockcodec.decode_streams(
            hdr, payload, fh.version, zstd_entropy.get_codec()
        )
        return blockcodec.streams_to_fastq(ds, qual_offset, decoder)

    tasks = ((decode_one, hdr, payload) for hdr, payload in _read_blocks(r, fh.version))
    _ordered_write(w, tasks, api._resolve_workers(opts.workers))
