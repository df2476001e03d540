"""Pipeline options and the settings every direction shares.

The port's copy of the option surface of ``fastqpacker_tpu/pipeline/api.py``
(the reference pipeline shape, internal/compress/compress.go:125-288):
quality encoding is detected from a fixed leading window and recorded as
a file-wide flag, then blocks are encoded independently and written in
input order. The pipelines themselves are in :mod:`.device` (v1/v2) and
:mod:`.native` (v3); :func:`compress_paired` / :func:`decompress_paired`
run them on R1/R2 mate files.
"""

from __future__ import annotations

import io
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import BinaryIO, Optional

from ..format import container
from ..ops import reference as refops
from . import blocks

DEFAULT_BLOCK_SIZE = 100000  # compress.go:71

# Block size of the v1/v2 zstd speed path: 37.5k-record blocks (~13 MB of
# 151 bp text) keep the parse->build->zstd working set near the host's
# last-level cache. v3 keeps the reference's 100k blocks.
SPEED_BLOCK_SIZE = 37500


def peek_detection(block_iter) -> tuple[list, int]:
    """Consume leading blocks until the reference's fixed Phred-detection
    window is covered and return ``(peeked_blocks, qual_offset)``.

    The Go tool always detects from the first min(DefaultBlockSize, file)
    records regardless of ``-b`` (compress.go:48-52,137-154), so with a
    small block size the window spans several blocks. Detection needs only
    the window's minimum quality byte, which each block's scan brought back
    per record (``RecordBlock.qual_min``); the peeked blocks are handed
    back for normal encoding. Parse errors inside the window surface here,
    before any output is written.
    """
    peeked: list = []
    seen = 0
    qmin = 256
    for blk in block_iter:
        peeked.append(blk)
        take = min(blk.n, DEFAULT_BLOCK_SIZE - seen)
        if take > 0:
            qmin = min(qmin, blk.qual_min(take))
        seen += blk.n
        if seen >= DEFAULT_BLOCK_SIZE:
            break
    if qmin > 255:  # no quality bytes in the window
        return peeked, refops.PHRED33_OFFSET
    return peeked, refops.detect_offset_from_min(qmin)


def resolve_block_size(opts: "Options") -> int:
    """Explicit block size if set, else the per-version default."""
    if opts.block_size > 0:
        return opts.block_size
    if opts.version == container.VERSION_3_NATIVE:
        return DEFAULT_BLOCK_SIZE
    return SPEED_BLOCK_SIZE


@dataclass
class Options:
    """Compression options (compress.go:74-77).

    ``block_size=0`` means auto (:func:`resolve_block_size`): the
    cache-tuned :data:`SPEED_BLOCK_SIZE` for v1/v2, the reference's
    :data:`DEFAULT_BLOCK_SIZE` for v3."""

    block_size: int = 0
    workers: int = 0  # 0 -> os.cpu_count()
    version: int = container.CURRENT_VERSION
    # Extra file-header flags OR'd with the detected ones (e.g.
    # FLAG_PAIRED_END for interleaved mate input).
    flags: int = 0
    # v3 only: allow the context-modeled quality coder (ops/qualctx.py)
    # on estimated size alone and code zstd streams at level 9. Slower
    # compress, better ratio (CLI: --max-ratio).
    order1_qual: bool = False
    # v3 only: strictly lossless mode (CLI --lossless): preserve
    # lowercase bases and exotic symbols verbatim instead of the
    # reference's normalization (acgt -> ACGT, non-ACGTN -> N).
    lossless: bool = False


@dataclass
class DecompressOptions:
    workers: int = 0


def _resolve_workers(workers: int) -> int:
    """Explicit count wins; default is NumCPU (compress.go:132-134)."""
    return workers if workers > 0 else (os.cpu_count() or 1)


def _sink_fd(w) -> int:
    """OS fd of ``w`` when writing to the fd IS writing to ``w`` (plain
    FileIO or a buffered wrapper directly over one, flushed first), else
    -1 (a copy of the JAX package's ``api._sink_fd``)."""
    raw = w
    if isinstance(w, (io.BufferedWriter, io.BufferedRandom)):
        raw = getattr(w, "raw", None)
    if not isinstance(raw, io.FileIO) or not raw.writable():
        return -1
    try:
        fd = w.fileno()
        w.flush()
    except (AttributeError, OSError, ValueError, io.UnsupportedOperation):
        return -1
    return fd


# Without an output fd the JAX package's whole-file decoder buffers its
# whole result, so it takes only container bodies up to this size then.
_MT_BUFFER_CAP_DECODE = 256 << 20


def runtime_decodes(body, w, version: int) -> bool:
    """Whether the JAX package's default decoder hands this addressable
    container ``body`` (after the file header and any dictionary section)
    to its whole-file runtime: a file sink or a body of at most 256 MiB,
    and a first pass over the block headers that finds nothing to hand
    back (:func:`.blocks.runtime_walk`, which raises the faults that pass
    meets, before any block is decoded)."""
    if _sink_fd(w) < 0 and len(body) > _MT_BUFFER_CAP_DECODE:
        return False
    return blocks.runtime_walk(body, version)


def ordered_map_write(w, jobs, fn, workers: int) -> None:
    """Run ``fn`` over ``jobs`` on a bounded thread pool and write the
    results to ``w`` in input order — the collector of the v3 pipeline
    (the reference's buffered channels + seqNum collector,
    compress.go:241-242,365-403). ``workers <= 1`` runs inline with no
    pool."""
    if workers <= 1:
        for job in jobs:
            w.write(fn(job))
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = []
        max_inflight = workers * 2
        for job in jobs:
            pending.append(pool.submit(fn, job))
            while len(pending) >= max_inflight:
                w.write(pending.pop(0).result())
        for fut in pending:
            w.write(fut.result())


class _ChainedReader:
    """Replays already-consumed head bytes, then continues on the stream."""

    def __init__(self, head: bytes, rest: BinaryIO):
        self._head = head
        self._rest = rest

    def read(self, n: int = -1) -> bytes:
        if self._head:
            if n < 0 or n >= len(self._head):
                data, self._head = self._head, b""
                if n < 0 or n > len(data):
                    rem = self._rest.read(-1 if n < 0 else n - len(data))
                    return data + rem
                return data
            data, self._head = self._head[:n], self._head[n:]
            return data
        return self._rest.read(n)


def compress_paired(
    r1: BinaryIO,
    r2: BinaryIO,
    w: BinaryIO,
    opts: Optional[Options] = None,
    device=None,
) -> None:
    """Compress R1/R2 mate files as one record-interleaved container
    (R1[0], R2[0], R1[1], ...) with FLAG_PAIRED_END set, with the device
    programs on ``device`` (default: the CUDA card). The interleaving
    reader is not addressable, so the input streams."""
    from ..utils import pairing
    from . import device as pdevice

    opts = opts or Options()
    opts = replace(opts, flags=opts.flags | container.FLAG_PAIRED_END)
    pdevice.compress_device(
        pairing.InterleavedPairReader(r1, r2), w, opts, device=device
    )


def decompress_paired(
    r: BinaryIO,
    w1: BinaryIO,
    w2: BinaryIO,
    opts: Optional[DecompressOptions] = None,
    device=None,
) -> None:
    """Split a paired-end container back into R1/R2 mate outputs, with the
    device programs on ``device`` (default: the CUDA card). The container
    is read through a reader that is not addressable, so its blocks take
    the per-block routes (a failing zstd frame keeps libzstd's name where
    the JAX package's per-block decoders keep it)."""
    from ..ops.device import resolve_device
    from ..utils import pairing
    from . import device as pdevice

    dev = resolve_device(device)
    head = r.read(container.FILE_HEADER_SIZE)
    fh = container.parse_file_header(head)
    if not fh.paired:
        raise container.FormatError(
            "container is not paired-end (FlagPairedEnd not set)"
        )
    dw = pairing.DeinterleavingWriter(w1, w2)
    pdevice.decompress_device(_ChainedReader(head, r), dw, opts, device=dev)
    dw.close()
