"""Device pipeline: FQZ compress and decompress on a torch device.

The port of ``fastqpacker_tpu/pipeline/device.py``. FQZ v3 routes to
:mod:`.native` (and, for a container with ``TAG_WCTX`` streams read on the
card, to :mod:`.meshpipe`); the rest of this module is the v1/v2 path, which
runs end to end on the card. Compress: the main thread copies each block's
FASTQ text to the card and scans it there (:mod:`..parser.fastq`), then
enqueues on one CUDA stream the row gathers, the dense encode, the stream
build and one copy of the six raw streams back; a thread pool waits for
each block's copy and runs zstd. Decompress: the pool runs zstd, copies a
block's six streams to the card in one copy, gathers the rows, decodes and
assembles the FASTQ text there and copies it back. An ordered in-flight
window writes blocks in input order (the reference's seqNum collector,
compress.go:365-403).

Records are padded to the block size and read lengths to the next multiple
of ``blocks.LEN_BUCKET``. With ``device="cpu"`` the same pipeline runs the
kernels' plain PyTorch versions.
"""

from __future__ import annotations

import contextlib
import io
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import chain
from typing import BinaryIO, Optional

import torch

from ..entropy import zstd as zstd_entropy
from ..format import container
from ..ops import device as devops
from ..ops import reference as refops
from ..parser.fastq import FastqStreamParser, RecordBlock
from ..utils.inmem import source_view
from . import api
from . import blocks as blockcodec
from . import meshpipe
from . import native


def _dispatch_stream(dev: torch.device):
    """A CUDA stream of its own for one compress run (None on the CPU)."""
    return torch.cuda.Stream(dev) if dev.type == "cuda" else None


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


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


def _finish_block(pending: blockcodec.PendingStreams, version: int) -> bytes:
    return blockcodec.compress_raw_streams(
        pending.result(), zstd_entropy.get_codec(), version
    )


def compress_device(
    r: BinaryIO,
    w: BinaryIO,
    opts: Optional[api.Options] = None,
    device=None,
) -> None:
    """Compress FASTQ from ``r`` into an FQZ container on ``w`` with the
    device programs on ``device`` (default: the CUDA card)."""
    dev = devops.resolve_device(device)
    opts = opts or api.Options()
    if opts.lossless and opts.version != container.VERSION_3_NATIVE:
        # a flag whose whole contract is "do not lose data" must never
        # be silently ignored (the v1/v2 wire has nowhere to put it)
        raise ValueError(
            "lossless mode requires the v3 native container "
            "(Options(version=VERSION_3_NATIVE) / --format native)"
        )
    if opts.version == container.VERSION_3_NATIVE:
        native.compress_native(r, w, opts, dev)
        return
    block_size = api.resolve_block_size(opts)
    stream = _dispatch_stream(dev)
    block_iter = FastqStreamParser(r, block_size=block_size, device=dev,
                                   stream=stream).blocks()

    # Phred detection from the reference's fixed min(100k, file)-record
    # window regardless of -b (compress.go:48-52,137-154).
    peeked, qual_offset = api.peek_detection(block_iter)
    flags = opts.flags | (
        container.FLAG_PHRED64 if qual_offset == refops.PHRED64_OFFSET else 0
    )
    container.FileHeader(
        version=opts.version, block_size=block_size, flags=flags
    ).write(w)
    if not peeked:
        return
    encode_blocks(w, chain(peeked, block_iter), qual_offset, opts, stream)


def encode_blocks(
    w: BinaryIO, blocks, qual_offset: int, opts: api.Options, stream=None
) -> None:
    """Encode v1/v2 ``blocks`` (no file header) onto ``w`` in order: the
    stream build on each block's device, enqueued on ``stream`` (the
    current one if None), zstd on a pool of ``opts.workers`` threads."""
    r_pad = api.resolve_block_size(opts)

    def dispatch(blk: RecordBlock) -> blockcodec.PendingStreams:
        with _on(stream):
            return blockcodec.dispatch_raw_streams(blk, qual_offset, rows=r_pad)

    tasks = ((_finish_block, dispatch(blk), opts.version) for blk in blocks)
    _ordered_write(w, tasks, api._resolve_workers(opts.workers))


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


def _first_block_wctx(view) -> bool:
    """True when the first block's seq or qual stream is TAG_WCTX — the
    cheap sniff behind the batched decode routing. Any parse trouble
    answers False (the ordinary decoder owns error semantics)."""
    rr = io.BytesIO(view)
    try:
        hdr = container.read_block_header(rr, container.VERSION_3_NATIVE)
    except container.FormatError:
        return False
    if hdr is None:
        return False
    sizes = hdr.stream_sizes(container.VERSION_2)
    base = rr.tell()
    wt = native.TAG_WCTX
    t0 = view[base] if sizes[0] > 0 and len(view) > base else -1
    o1 = base + sizes[0]
    t1 = view[o1] if sizes[1] > 0 and len(view) > o1 else -1
    return t0 == wt or t1 == wt


def decompress_device(
    r: BinaryIO,
    w: BinaryIO,
    opts: Optional[api.DecompressOptions] = None,
    device=None,
) -> None:
    """Decompress an FQZ container from ``r`` into FASTQ text on ``w``
    with the device programs on ``device`` (default: the card)."""
    dev = devops.resolve_device(device)
    opts = opts or api.DecompressOptions()
    fh = container.read_file_header(r)
    qual_offset = (
        refops.PHRED64_OFFSET if fh.phred64 else refops.PHRED33_OFFSET
    )
    if fh.version == container.VERSION_3_NATIVE:
        # Context-coded (TAG_WCTX) containers carry the mesh coder's
        # streams: on the card they go to the batched decoder of
        # pipeline/meshpipe.py, on the CPU to the per-block decoder. The
        # route follows the device the caller gave (there is no transfer
        # probe); both give the same bytes. Dict/lossless containers and
        # non-addressable sources keep the per-block path. Both name a
        # failing zstd frame or tagged stream as the JAX package's default
        # decoder does for the whole file (api.runtime_decodes).
        if dev.type == "cuda" and not (
            fh.flags & (container.FLAG_SEQ_DICT | container.FLAG_LOSSLESS)
        ):
            view = source_view(r)
            if view is not None:
                r = io.BytesIO(view)
                if _first_block_wctx(view):
                    mapped = api.runtime_decodes(view, w, fh.version)
                    meshpipe.decompress_mesh(r, w, mesh=[dev], fh=fh,
                                             runtime_errors=mapped)
                    return
        native.decompress_native(
            r, w, fh, qual_offset, api._resolve_workers(opts.workers), dev
        )
        return
    if fh.version not in (container.VERSION_1, container.VERSION_2):
        raise container.FormatError(f"unsupported file version: {fh.version}")
    view = source_view(r)
    if view is not None:
        r = io.BytesIO(view)
        # v1/v2 name a failing frame per block either way; the JAX
        # runtime's first pass raises its faults before any block decodes
        api.runtime_decodes(view, w, fh.version)

    def decode_one(hdr, payload) -> bytes:
        mapped = blockcodec.frames_sized(hdr, payload, fh.version)
        with blockcodec.payload_zstd_errors(mapped):
            ds = blockcodec.decode_streams(
                hdr, payload, fh.version, zstd_entropy.get_codec()
            )
        with devops.worker_stream(dev):
            return blockcodec.streams_to_fastq(ds, qual_offset, dev)

    tasks = ((decode_one, hdr, payload) for hdr, payload in _read_blocks(r, fh.version))
    _ordered_write(w, tasks, api._resolve_workers(opts.workers))
