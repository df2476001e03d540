"""Pipeline options and the settings every direction shares.

The port's copy of the option surface of ``fastqpacker_tpu/pipeline/api.py``
(the reference pipeline shape, internal/compress/compress.go:125-288):
quality encoding is detected from a fixed leading window and recorded as
a file-wide flag, then blocks are encoded independently and written in
input order. The pipelines themselves are in :mod:`.device`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..format import container
from ..ops import reference as refops

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
    the window's minimum quality byte; the peeked blocks are handed back
    for normal encoding. Parse errors inside the window surface here,
    before any output is written.
    """
    peeked: list = []
    seen = 0
    qmin = 256
    for blk in block_iter:
        peeked.append(blk)
        take = min(blk.n, DEFAULT_BLOCK_SIZE - seen)
        if take > 0 and int(blk.lengths[:take].sum()) > 0:
            qmin = min(qmin, int(blk.qual[:take].min()))
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

    ``block_size=0`` means auto (:func:`resolve_block_size`). The JAX
    package's v3-only options (``order1_qual``, ``lossless``) and extra
    header ``flags`` (for paired input) come with the slices that use
    them."""

    block_size: int = 0
    workers: int = 0  # 0 -> os.cpu_count()
    version: int = container.CURRENT_VERSION


@dataclass
class DecompressOptions:
    workers: int = 0


def _resolve_workers(workers: int) -> int:
    """Explicit count wins; default is NumCPU (compress.go:132-134)."""
    return workers if workers > 0 else (os.cpu_count() or 1)
