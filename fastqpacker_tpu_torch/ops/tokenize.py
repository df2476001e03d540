"""Header token-delta codec (FQZ v3 header stream transform).

FASTQ headers are highly structured: a mostly-constant instrument/run
prefix with a few numeric fields (tile, x, y, read index) that change —
often by +1 — between consecutive records. Generic LZ (zstd) captures the
constant prefix but spends bytes on every changing digit field. This
transform tokenizes each header into maximal digit / non-digit runs and
codes each token against the same-index token of the *previous* record:

  - identical token        -> 1-byte MATCH
  - numeric token          -> DELTA op + zigzag-varint of (value - prev)
  - anything else          -> LITERAL op + varint length + bytes

The tokenized stream is then zstd-coded like any other stream; the
match/delta structure turns per-record entropy into near-zero bytes.

This is a capability beyond the Go reference (which stores headers as raw
u16-length-prefixed bytes, internal/compress/compress.go:514-519). The
transform is exactly invertible on the *wire stream* level: encode takes
the u16-length-prefixed headers stream and decode reproduces it
byte-identically, so the v3 block CRC (computed over raw streams) also
verifies the transform.

Wire layout of the tokenized stream:

  varint(original_stream_length)
  per record: ops... then OP_END
    OP_MATCH                      token identical to prev record's token i
    OP_DELTA    zigzag-varint     numeric: token == str(prev_val + d)
    OP_DELTA_PAD zigzag-varint    numeric, fixed width: token ==
                                  str(prev_val + d).zfill(len(prev_token))
    OP_LIT      varint(len) bytes anything else

Numeric eligibility: all-ASCII-digits and <= 18 digits (fits int64).
The last record's tokens become "prev" for the next record; the first
record has no prev, so all its tokens are literals.

The port's copy of ``fastqpacker_tpu/ops/tokenize.py``: its pure Python is
:func:`encode_plain` / :func:`decode_plain` here, the specification of the
transform and the plain versions of the card's kernels ``fq_tok_encode`` /
``fq_tok_decode`` (``csrc/tokens.cu``, wrappers ``cuda_kernels.tok_encode`` /
``tok_decode``). :func:`encode` and :func:`decode` run on a device: a tensor
where it lies, host bytes on ``device`` (default: the CUDA card); the CPU
takes the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device, to_device

OP_END = 0x00
OP_MATCH = 0x01
OP_DELTA = 0x02
OP_DELTA_PAD = 0x03
OP_LIT = 0x04

_MAX_NUM_DIGITS = 18


def _write_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _read_varint(data: bytes, off: int) -> tuple[int, int]:
    v = 0
    shift = 0
    while True:
        if off >= len(data) or shift > 63:
            raise ValueError("truncated varint in tokenized header data")
        b = data[off]
        off += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, off
        shift += 7


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _split_tokens(h: bytes) -> list[bytes]:
    """Maximal runs of ASCII digits vs non-digits."""
    toks: list[bytes] = []
    i, n = 0, len(h)
    while i < n:
        j = i + 1
        is_digit = 0x30 <= h[i] <= 0x39
        while j < n and (0x30 <= h[j] <= 0x39) == is_digit:
            j += 1
        toks.append(h[i:j])
        i = j
    return toks


def _is_numeric(tok: bytes) -> bool:
    return 0 < len(tok) <= _MAX_NUM_DIGITS and all(
        0x30 <= b <= 0x39 for b in tok
    )


def encode_plain(stream: bytes, count: int) -> bytes:
    """u16-length-prefixed headers stream -> tokenized stream."""
    out = bytearray()
    _write_varint(out, len(stream))
    prev: list[bytes] = []
    off = 0
    for _ in range(count):
        if off + 2 > len(stream):
            raise ValueError("truncated header data")
        hlen = stream[off] | (stream[off + 1] << 8)
        off += 2
        if off + hlen > len(stream):
            raise ValueError("truncated header data")
        toks = _split_tokens(stream[off : off + hlen])
        off += hlen
        for i, tok in enumerate(toks):
            p = prev[i] if i < len(prev) else None
            if p is not None and tok == p:
                out.append(OP_MATCH)
            elif p is not None and _is_numeric(tok) and _is_numeric(p):
                pv, tv = int(p), int(tok)
                d = _zigzag(tv - pv)
                s = str(tv).encode()
                if s == tok:
                    out.append(OP_DELTA)
                    _write_varint(out, d)
                elif len(tok) == len(p) and s.rjust(len(tok), b"0") == tok:
                    out.append(OP_DELTA_PAD)
                    _write_varint(out, d)
                else:
                    out.append(OP_LIT)
                    _write_varint(out, len(tok))
                    out.extend(tok)
            else:
                out.append(OP_LIT)
                _write_varint(out, len(tok))
                out.extend(tok)
        out.append(OP_END)
        prev = toks
    if off != len(stream):
        raise ValueError("trailing bytes after last header record")
    return bytes(out)


def decode_plain(data: bytes, count: int) -> bytes:
    """Tokenized stream -> the original u16-length-prefixed headers stream."""
    total, off = _read_varint(data, 0)
    out = bytearray()
    prev: list[bytes] = []
    for _ in range(count):
        toks: list[bytes] = []
        while True:
            if off >= len(data):
                raise ValueError("truncated tokenized header data")
            op = data[off]
            off += 1
            if op == OP_END:
                break
            i = len(toks)
            if op == OP_MATCH:
                if i >= len(prev):
                    raise ValueError("header token match without predecessor")
                toks.append(prev[i])
            elif op in (OP_DELTA, OP_DELTA_PAD):
                if i >= len(prev) or not _is_numeric(prev[i]):
                    raise ValueError("header token delta without numeric predecessor")
                d, off = _read_varint(data, off)
                v = int(prev[i]) + _unzigzag(d)
                if v < 0:
                    raise ValueError("negative header token value")
                s = str(v).encode()
                if op == OP_DELTA_PAD:
                    if len(s) > len(prev[i]):
                        raise ValueError("header token wider than its field")
                    s = s.rjust(len(prev[i]), b"0")
                toks.append(s)
            elif op == OP_LIT:
                ln, off = _read_varint(data, off)
                if off + ln > len(data):
                    raise ValueError("truncated tokenized header data")
                toks.append(data[off : off + ln])
                off += ln
            else:
                raise ValueError(f"unknown header token op: {op}")
        h = b"".join(toks)
        if len(h) > 0xFFFF:
            raise ValueError("header exceeds 65535 bytes")
        out.append(len(h) & 0xFF)
        out.append(len(h) >> 8)
        out.extend(h)
        prev = toks
    if len(out) != total:
        raise ValueError("tokenized header size mismatch")
    return bytes(out)


def encode_bound(stream_len: int, count: int) -> int:
    """Worst-case output size: every byte its own literal token."""
    return 10 + 3 * stream_len + count + 16


# The decode's faults by the code the kernel reports (csrc/tokens.cu
# kFault*), each the plain version's string; 7 takes the op byte.
TOK_FAULTS = {
    1: "truncated varint in tokenized header data",
    2: "truncated tokenized header data",
    3: "header token match without predecessor",
    4: "header token delta without numeric predecessor",
    5: "negative header token value",
    6: "header token wider than its field",
    7: "unknown header token op: {op}",
    8: "header exceeds 65535 bytes",
    9: "tokenized header size mismatch",
}
TOK_NO_FAULT = (1 << 63) - 1
# the kernels' info slots (csrc/tokens.cu kInfo*)
(TOK_INFO_NODES, TOK_INFO_EXIT, TOK_INFO_ENDS, TOK_INFO_FAULT, TOK_INFO_SIZE,
 TOK_INFO_MISMATCH) = range(6)
TOK_INFO_SLOTS = 8
# the encode's faults; TOK_ENCODE_LENGTHS: the header lengths given are not
# the stream's (not a malformed stream: the wrapper raises RuntimeError)
TOK_ENCODE_FAULTS = {1: "truncated header data", 2: "trailing bytes after last header record"}
TOK_ENCODE_LENGTHS = 3


def _tensor(b: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(b, np.uint8).copy())


def tok_encode_plain(stream: torch.Tensor, count: int) -> torch.Tensor:
    """:func:`encode_plain` of a (n,) uint8 CPU tensor -> uint8 tensor."""
    return _tensor(encode_plain(stream.numpy().tobytes(), count))


def tok_decode_plain(data: torch.Tensor, count: int) -> torch.Tensor:
    """:func:`decode_plain` of a (n,) uint8 CPU tensor -> uint8 tensor."""
    return _tensor(decode_plain(data.numpy().tobytes(), count))


def _on_device(data, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data
    return to_device(resolve_device(device), np.frombuffer(data, np.uint8))


def encode(stream, count: int, device=None, lengths=None) -> bytes:
    """u16-length-prefixed headers stream -> tokenized stream, on a device:
    ``stream`` a (n,) uint8 tensor (where it lies) or host bytes (copied to
    ``device``, default the CUDA card); ``lengths``, the records' header
    lengths beside a tensor the stream build wrote (1-D int64 on its
    device), spares the card the walk of the record chain. Raises
    ``ValueError`` with the plain version's string for a malformed
    stream."""
    from . import cuda_kernels

    t = _on_device(stream, device)
    return cuda_kernels.tok_encode(t, count, lengths).cpu().numpy().tobytes()


def decode(data, count: int, device=None) -> bytes:
    """Tokenized stream -> the u16-length-prefixed headers stream, on a
    device, as :func:`encode`. Raises ``ValueError`` with the plain
    version's string (the first fault in stream order)."""
    from . import cuda_kernels

    return cuda_kernels.tok_decode(_on_device(data, device), count).cpu().numpy().tobytes()
