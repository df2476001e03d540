"""fqpack info / check: container introspection and integrity verification.

The port of ``fastqpacker_tpu/cli/inspect.py``:

- ``info``: file header fields + per-block stream-size accounting; it reads
  headers only (no device, no kernel).
- ``check``: full decode of every block (zstd frame checksums and, for v3,
  the explicit block CRC32 are verified on the way) without writing the
  FASTQ text anywhere, with the device programs on the caller's device
  (the card unless told otherwise).
"""

from __future__ import annotations

import sys
from typing import BinaryIO

from ..entropy.zstd import ZstdError
from ..format import container


def _open(path: str) -> BinaryIO:
    if path in ("", "-"):
        return sys.stdin.buffer
    return open(path, "rb")


def _iter_blocks(r: BinaryIO, fh: container.FileHeader):
    hdr_version = fh.version
    stream_version = (
        container.VERSION_2
        if fh.version == container.VERSION_3_NATIVE
        else fh.version
    )
    while True:
        hdr = container.read_block_header(r, hdr_version)
        if hdr is None:
            return
        size = sum(hdr.stream_sizes(stream_version))
        payload = r.read(size)
        if len(payload) < size:
            raise container.FormatError("truncated block payload")
        yield hdr, payload


def _skip_seq_dict(r, fh, out=None):
    """Consume the v3 sequence-dictionary section if present; returns
    its on-wire byte size (0 when absent). Prints a summary line when
    ``out`` is given."""
    if (
        fh.version == container.VERSION_3_NATIVE
        and fh.flags & container.FLAG_SEQ_DICT
    ):
        raw_len, comp = container.read_seq_dict_section(r)
        if out is not None:
            print(
                f"  seq dict:    {len(comp):,} bytes "
                f"({raw_len:,} codes)",
                file=out,
            )
        return 8 + len(comp)
    return 0


def info(path: str, out=None) -> int:
    out = out or sys.stdout
    with _open(path) as r:
        fh = container.read_file_header(r)
        names = {1: "v1", 2: "v2 (zstd)", 3: "v3 (native rANS + CRC32)"}
        print(f"FQZ container: {names.get(fh.version, fh.version)}", file=out)
        print(f"  block size:  {fh.block_size} records", file=out)
        print(
            f"  quality:     Phred+{'64' if fh.phred64 else '33'}",
            file=out,
        )
        flags = []
        if fh.flags & container.FLAG_PAIRED_END:
            flags.append("paired-end")
        if fh.phred64:
            flags.append("phred64")
        if fh.flags & container.FLAG_SEQ_DICT:
            flags.append("seq-dict")
        if fh.flags & container.FLAG_LOSSLESS:
            flags.append("lossless")
        print(f"  flags:       {', '.join(flags) or '(none)'}", file=out)

        nblocks = 0
        records = 0
        comp_bytes = container.FILE_HEADER_SIZE + _skip_seq_dict(r, fh, out)
        orig_seq = orig_qual = 0
        per_stream = [0] * 6
        tag_counts: list[dict] = [dict() for _ in range(6)]
        for hdr, payload in _iter_blocks(r, fh):
            nblocks += 1
            records += hdr.num_records
            comp_bytes += len(payload) + container.block_header_size(
                fh.version
            )
            orig_seq += hdr.original_seq_size
            orig_qual += hdr.original_qual_size
            sizes = hdr.stream_sizes(
                container.VERSION_2
                if fh.version >= container.VERSION_2
                else container.VERSION_1
            )
            off = 0
            for i, s in enumerate(sizes):
                per_stream[i] += s
                if fh.version == container.VERSION_3_NATIVE and s:
                    tag = _v3_tag_name(i, payload[off])
                    if tag:
                        tag_counts[i][tag] = tag_counts[i].get(tag, 0) + 1
                off += s
        print(f"  blocks:      {nblocks}", file=out)
        print(f"  records:     {records}", file=out)
        print(f"  compressed:  {comp_bytes:,} bytes", file=out)
        print(
            f"  bases:       {orig_seq:,} (quality bytes: {orig_qual:,})",
            file=out,
        )
        labels = ["seq", "qual", "headers", "plus", "npos", "lengths"]
        if fh.version == container.VERSION_1:
            labels = ["seq", "qual", "headers", "npos", "lengths"]
        for i, (lbl, size) in enumerate(zip(labels, per_stream)):
            codecs = ""
            if tag_counts[i]:
                parts = [
                    f"{name} x{cnt}" if len(tag_counts[i]) > 1 or cnt > 1
                    else name
                    for name, cnt in sorted(tag_counts[i].items())
                ]
                codecs = f"  [{', '.join(parts)}]"
            print(f"    stream {lbl:<8} {size:,} bytes{codecs}", file=out)
    return 0


# v2+ wire-order slots that carry a codec tag byte in v3 (mirrors
# pipeline/native.STREAM_CODECS without importing the device stack)
_V3_TAGGED_SLOTS = (0, 1, 2)


def _v3_tag_name(slot: int, tag: int) -> str:
    """Human name of a v3 per-stream codec tag ('' for untagged slots)."""
    if slot not in _V3_TAGGED_SLOTS:
        return ""  # untagged plain-zstd slot; first byte is frame data
    return {
        container.TAG_RANS: "rans",
        container.TAG_ZSTD: "zstd",
        container.TAG_TOK: "tok+zstd",
        container.TAG_QCTX: "qctx",
        container.TAG_SCTX: "sctx",
        container.TAG_SLDM: "sldm",
        container.TAG_WCTX: "wctx",
    }.get(tag, f"tag{tag}")


class _NullSink:
    def __init__(self):
        self.nbytes = 0

    def write(self, b) -> int:
        self.nbytes += len(b)
        return len(b)


def check(path: str, out=None, device=None) -> int:
    out = out or sys.stdout
    sink = _NullSink()
    # the decode stack (torch) loads only here, keeping `info` light
    from ..ops.device import resolve_device
    from ..pipeline.device import decompress_device

    dev = resolve_device(device)
    try:
        with _open(path) as r:
            decompress_device(r, sink, device=dev)
    except (container.FormatError, ZstdError, ValueError, OSError) as e:
        print(f"check FAILED: {e}", file=out)
        return 1
    print(f"OK: decoded {sink.nbytes:,} bytes of FASTQ", file=out)
    return 0
