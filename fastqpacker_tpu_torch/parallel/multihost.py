"""Several hosts: per-host input ranges, one section each, ordered output.

The port of ``fastqpacker_tpu/parallel/multihost.py``. A compress of a big
FASTQ across hosts needs three pieces:

1. A process group (:func:`init_distributed`): ``torch.distributed`` with
   the gloo backend, one process per host. Every exchange is one integer
   per host, so gloo is enough, also between hosts whose cards share one
   machine.
2. **Record-aligned input ranges**: each host seeks to ``file_size * k / H``
   and scans forward for a true FASTQ record start. A bare ``'@'`` at a
   line start is not enough (``'@'`` is a legal quality byte), so each
   candidate is checked by parsing the records that follow it.
3. **Ordered writes of variable-size sections**: the hosts' section sizes
   are all-gathered, every host takes the exclusive prefix as its offset
   and ``pwrite``\\ s its own bytes there; nothing goes through host 0.

Each host compresses and decompresses its section on its card: the v1/v2
blocks scanned, coded and assembled by the card's kernels
(:func:`..pipeline.device.encode_blocks`,
:func:`..pipeline.blocks.streams_to_fastq`), v3 blocks through
:func:`..pipeline.native.encode_block_native` and
:func:`..pipeline.native.decompress_native` (rANS, compaction and CRC32
kernels). A process's card is ``cuda:(rank % device_count)`` unless the
caller names a device. The sections, and so the file, are byte for byte the
JAX package's. :func:`simulate_multihost` and
:func:`simulate_multihost_decompress` run every host's part in one process.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import BinaryIO, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..entropy import zstd as zstd_entropy
from ..format import container
from ..ops import device as devops
from ..ops import reference as refops
from ..ops import sldm
from ..parser.fastq import FastqStreamParser
from ..pipeline import api
from ..pipeline import blocks as blockcodec
from ..pipeline import device as pdevice
from ..pipeline import native


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout: float = 300.0,
) -> tuple[int, int]:
    """Join the process group when more than one process is asked for:
    ``torch.distributed`` with gloo at ``tcp://coordinator_address``
    (``host:port``), ``num_processes`` ranks, this one ``process_id``. A
    group that cannot be joined within ``timeout`` seconds raises. Makes
    this process's card (:func:`process_device`) its current device.
    Returns ``(rank, world_size)``."""
    dev = process_device(device, rank=process_id or 0)
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("a group of several processes needs an address and a rank")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}", world_size=num_processes,
            rank=process_id, timeout=timedelta(seconds=timeout),
        )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return _rank_and_size()


def _rank_and_size() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_device(device=None, rank: Optional[int] = None) -> torch.device:
    """The device this process codes on: ``device`` if it names one; else
    ``cuda:(rank % device_count)`` (``rank`` default: this process's rank
    in the group), so processes that share a machine spread over its cards.
    Raises without a card unless the CPU is named."""
    dev = devops.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = _rank_and_size()[0] if rank is None else rank
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


# ---------------------------------------------------------------------------
# Record-aligned byte ranges
# ---------------------------------------------------------------------------

PROBE_BYTES = 1 << 20  # window scanned for an alignment candidate


def _is_record_start(buf: bytes, pos: int) -> bool:
    """Structurally verify that ``buf[pos:]`` starts a FASTQ record.

    Checks up to two consecutive records for the 4-line invariants
    (header '@', separator '+', len(seq) == len(qual)); one record
    suffices at end-of-buffer.
    """
    checked = 0
    while checked < 2:
        if pos >= len(buf):
            return checked > 0
        if buf[pos : pos + 1] != b"@":
            return False
        lines = []
        p = pos
        for _ in range(4):
            nl = buf.find(b"\n", p)
            if nl < 0:
                # ran off the probe window: accept if at least one full
                # record validated
                return checked > 0
            line = buf[p:nl]
            if line.endswith(b"\r"):
                line = line[:-1]
            lines.append(line)
            p = nl + 1
        if not lines[2].startswith(b"+"):
            return False
        if len(lines[1]) != len(lines[3]):
            return False
        pos = p
        checked += 1
    return True


def align_to_record(f: BinaryIO, start: int, file_size: int) -> int:
    """Smallest record-start offset >= ``start`` (or ``file_size``)."""
    if start == 0:
        return 0
    if start >= file_size:
        return file_size
    f.seek(start)
    buf = f.read(min(PROBE_BYTES, file_size - start))
    # candidate positions: character after every newline
    pos = 0
    while True:
        nl = buf.find(b"\n", pos)
        if nl < 0:
            return file_size
        cand = nl + 1
        if cand >= len(buf):
            return file_size
        if _is_record_start(buf, cand):
            return start + cand
        pos = cand


def host_ranges(path: str, num_hosts: int) -> list[tuple[int, int]]:
    """Record-aligned [start, end) input ranges, one per host."""
    file_size = os.path.getsize(path)
    bounds = [0]
    with open(path, "rb") as f:
        for k in range(1, num_hosts):
            raw = file_size * k // num_hosts
            bounds.append(max(align_to_record(f, raw, file_size), bounds[-1]))
    bounds.append(file_size)
    return [(bounds[i], bounds[i + 1]) for i in range(num_hosts)]


# ---------------------------------------------------------------------------
# Sharded compression with parallel ordered writes
# ---------------------------------------------------------------------------


class _RangeReader:
    """Reads a [start, end) window of a file as a stream."""

    def __init__(self, f: BinaryIO, start: int, end: int):
        self.f = f
        self.f.seek(start)
        self.remaining = end - start

    def read(self, n: int = -1) -> bytes:
        if self.remaining <= 0:
            return b""
        if n is None or n < 0 or n > self.remaining:
            n = self.remaining
        data = self.f.read(n)
        self.remaining -= len(data)
        return data


@dataclass
class HostSection:
    """One host's compressed output section."""

    host_id: int
    payload: bytes  # concatenated blocks (no file header)
    qual_offset: int


def compress_host_section(
    path: str,
    start: int,
    end: int,
    host_id: int,
    opts: Optional[api.Options] = None,
    qual_offset: Optional[int] = None,
    device=None,
) -> HostSection:
    """Compress one host's record range into container blocks, with the
    device programs on ``device`` (default: this process's card).

    The file header is emitted only by host 0 at offset 0; every other
    host contributes bare blocks. The quality-encoding flag is detected by
    host 0 (first block of the file, compress.go:137-154) and broadcast;
    non-zero hosts must receive it via ``qual_offset``.
    """
    dev = process_device(device)
    opts = opts or api.Options()
    block_size = api.resolve_block_size(opts)
    out = io.BytesIO()

    with open(path, "rb") as f:
        blocks_iter = FastqStreamParser(_RangeReader(f, start, end), block_size=block_size,
                                        device=dev).blocks()
        first = next(blocks_iter, None)
        if qual_offset is None:
            qual_offset = refops.PHRED33_OFFSET
            if first is not None and (qmin := first.qual_min(first.n)) < 256:
                qual_offset = refops.detect_offset_from_min(qmin)

        def all_blocks():
            if first is not None:
                yield first
            yield from blocks_iter

        if opts.version == container.VERSION_3_NATIVE:
            def encode_one(blk) -> bytes:
                with devops.worker_stream(dev):
                    return native.encode_block_native(
                        blk, qual_offset, dev, opts.order1_qual, lossless=opts.lossless)

            api.ordered_map_write(
                out, all_blocks(), encode_one, api._resolve_workers(opts.workers))
        else:
            pdevice.encode_blocks(out, all_blocks(), qual_offset, opts)

    return HostSection(host_id=host_id, payload=out.getvalue(), qual_offset=qual_offset)


def exchange_section_sizes(local_size: int) -> np.ndarray:
    """All-gather the hosts' section sizes (int64, gloo); the local size
    alone in a single process."""
    rank, size = _rank_and_size()
    if size == 1:
        return np.array([local_size], dtype=np.int64)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(size)]
    dist.all_gather(sizes, torch.tensor([local_size], dtype=torch.int64))
    return torch.cat(sizes).numpy()


def _broadcast_from_host0(value: int) -> int:
    t = torch.tensor([value], dtype=torch.int64)
    dist.broadcast(t, src=0)
    return int(t.item())


def _section_bytes(section: HostSection, opts: api.Options) -> bytes:
    """Host 0 prepends the file header; other hosts emit bare blocks."""
    if section.host_id != 0:
        return section.payload
    flags = opts.flags | (container.FLAG_PHRED64 if section.qual_offset == 64 else 0)
    if opts.version == container.VERSION_3_NATIVE and opts.lossless:
        # blocks were encoded with the lossless side data; the header
        # must say so or decode silently normalizes
        flags |= container.FLAG_LOSSLESS
    header = container.FileHeader(
        version=opts.version,
        block_size=api.resolve_block_size(opts),
        flags=flags,
    ).to_bytes()
    return header + section.payload


def _pwrite_section(out_path: str, data: bytes, offset: int) -> None:
    fd = os.open(out_path, os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        os.pwrite(fd, data, offset)
    finally:
        os.close(fd)


def _detect_file_qual_offset(in_path: str, opts: api.Options, dev=None) -> int:
    """Phred offset from the FILE's fixed min(100k, file)-record window
    (compress.go:48-52,137-164): the file-wide header flag must come from
    the reference's detection window, never from whatever block happens to
    start a host's byte range."""
    with open(in_path, "rb") as r:
        parser = FastqStreamParser(r, block_size=api.resolve_block_size(opts), device=dev)
        _, qual_offset = api.peek_detection(parser.blocks())
        return qual_offset


def compress_multihost(
    in_path: str,
    out_path: str,
    opts: Optional[api.Options] = None,
    qual_offset: Optional[int] = None,
    device=None,
) -> None:
    """This process's share of a multi-host compress: with the process
    group joined (:func:`init_distributed`), every host calls this; section
    sizes are all-gathered and each host pwrites its own byte range of the
    output. It returns after its own write, not its peers': a reader of
    ``out_path`` waits for every host (a barrier).

    The quality-encoding flag is a file-level header bit detected from the
    file's first records (compress.go:137-164). Without ``qual_offset``,
    host 0 detects it and broadcasts it to every host: per-host detection
    would let a host whose range lacks the detection window encode against
    the wrong file-wide flag.
    """
    opts = opts or api.Options()
    h, n = _rank_and_size()
    dev = process_device(device)
    if qual_offset is None:
        local = _detect_file_qual_offset(in_path, opts, dev) if h == 0 else 0
        qual_offset = _broadcast_from_host0(local) if n > 1 else local

    start, end = host_ranges(in_path, n)[h]
    section = compress_host_section(in_path, start, end, h, opts, qual_offset, dev)
    data = _section_bytes(section, opts)
    sizes = exchange_section_sizes(len(data))
    _pwrite_section(out_path, data, int(sizes[:h].sum()))


def simulate_multihost(
    in_path: str,
    out_path: str,
    num_hosts: int,
    opts: Optional[api.Options] = None,
    device=None,
) -> None:
    """Every host's compress in one process, one after another (tests, and
    more hosts than cards): the same sections, offsets and pwrites."""
    opts = opts or api.Options()
    dev = process_device(device)
    sections = []
    qual_offset = None
    for h, (start, end) in enumerate(host_ranges(in_path, num_hosts)):
        sec = compress_host_section(in_path, start, end, h, opts, qual_offset, dev)
        if h == 0:
            qual_offset = sec.qual_offset  # host 0 broadcast
        sections.append(sec)

    datas = [_section_bytes(s, opts) for s in sections]
    sizes = np.array([len(d) for d in datas], dtype=np.int64)
    offsets = np.concatenate(([0], np.cumsum(sizes[:-1])))
    for d, off in zip(datas, offsets):
        _pwrite_section(out_path, d, int(off))


# ---------------------------------------------------------------------------
# Multi-host decompress: block-stripe sharding
# ---------------------------------------------------------------------------


def index_blocks(path: str) -> tuple[container.FileHeader, list[tuple[int, int]]]:
    """Walk block headers -> [(file_offset, total_block_bytes)].

    Headers are tiny; payloads are seek-skipped, so indexing a multi-GB
    container reads only a few KB per 100k records. Every host can index
    independently (read-only).
    """
    blocks = []
    with open(path, "rb") as f:
        fh = container.read_file_header(f)
        if fh.version == container.VERSION_3_NATIVE and fh.flags & container.FLAG_SEQ_DICT:
            container.read_seq_dict_section(f)  # skip the dict section
        stream_version = (
            container.VERSION_2 if fh.version == container.VERSION_3_NATIVE else fh.version
        )
        hdr_size = container.block_header_size(fh.version)
        while True:
            off = f.tell()
            hdr = container.read_block_header(f, fh.version)
            if hdr is None:
                break
            payload = sum(hdr.stream_sizes(stream_version))
            f.seek(payload, os.SEEK_CUR)
            blocks.append((off, hdr_size + payload))
    return fh, blocks


def _stripe(blocks: list[tuple[int, int]], num_hosts: int, host_id: int):
    """Contiguous block stripes balanced by compressed bytes."""
    total = sum(b[1] for b in blocks) or 1
    bounds = [0]
    acc = 0
    target_idx = 1
    for i, (_, size) in enumerate(blocks):
        acc += size
        while target_idx < num_hosts and acc >= total * target_idx / num_hosts:
            bounds.append(i + 1)
            target_idx += 1
    while len(bounds) < num_hosts:
        bounds.append(len(blocks))
    bounds.append(len(blocks))
    return blocks[bounds[host_id] : bounds[host_id + 1]]


def decompress_host_section(
    in_path: str,
    fh: container.FileHeader,
    my_blocks: list[tuple[int, int]],
    device=None,
    workers: int = 0,
) -> bytes:
    """Decode this host's stripe of blocks to FASTQ text (in order), with
    the device programs on ``device`` (default: this process's card) and
    ``workers`` threads (0: one per CPU). A fault is named by the per-block
    decoders, as in the JAX package: the stripe reader starts mid-file."""
    dev = process_device(device)
    qual_offset = refops.PHRED64_OFFSET if fh.phred64 else refops.PHRED33_OFFSET
    if not my_blocks:
        return b""
    workers = api._resolve_workers(workers)
    out = io.BytesIO()
    with open(in_path, "rb") as f:
        if fh.version == container.VERSION_3_NATIVE:
            seq_dict = None
            if fh.flags & container.FLAG_SEQ_DICT:
                f.seek(container.FILE_HEADER_SIZE)
                raw_len, comp = container.read_seq_dict_section(f)
                try:
                    seq_dict = sldm.decompress_dict(comp, raw_len)
                except ValueError as e:
                    raise container.FormatError(str(e)) from None
            start = my_blocks[0][0]
            end = my_blocks[-1][0] + my_blocks[-1][1]
            native.decompress_native(
                _RangeReader(f, start, end), out, fh, qual_offset, workers, dev,
                seq_dict=seq_dict, skip_sections=True,
            )
        else:
            hdr_size = container.block_header_size(fh.version)
            def read_blocks():
                for off, size in my_blocks:
                    f.seek(off)
                    yield f.read(size)

            def decode_one(raw: bytes) -> bytes:
                hdr = container.parse_block_header(raw[:hdr_size], fh.version)
                ds = blockcodec.decode_streams(
                    hdr, raw[hdr_size:], fh.version, zstd_entropy.get_codec())
                with devops.worker_stream(dev):
                    return blockcodec.streams_to_fastq(ds, qual_offset, dev)

            api.ordered_map_write(out, read_blocks(), decode_one, workers)
    return out.getvalue()


def decompress_multihost(in_path: str, out_path: str, device=None) -> None:
    """This process's share of a multi-host decompress: its stripe of
    blocks, written at the exclusive prefix of the gathered text sizes."""
    h, n = _rank_and_size()
    fh, blocks = index_blocks(in_path)
    text = decompress_host_section(in_path, fh, _stripe(blocks, n, h), device)
    sizes = exchange_section_sizes(len(text))
    _pwrite_section(out_path, text, int(sizes[:h].sum()))


def simulate_multihost_decompress(
    in_path: str, out_path: str, num_hosts: int, device=None
) -> None:
    """Every host's decompress in one process, one after another."""
    dev = process_device(device)
    fh, blocks = index_blocks(in_path)
    texts = [
        decompress_host_section(in_path, fh, _stripe(blocks, num_hosts, h), dev)
        for h in range(num_hosts)
    ]
    sizes = np.array([len(t) for t in texts], dtype=np.int64)
    offsets = np.concatenate(([0], np.cumsum(sizes[:-1])))
    for t, off in zip(texts, offsets):
        _pwrite_section(out_path, t, int(off))
