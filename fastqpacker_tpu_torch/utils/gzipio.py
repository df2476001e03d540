"""Transparent gzip input handling for the CLI layer.

Mirrors the reference behavior (cmd/fqpack/main.go:123-174): on *compress*
input, gunzip transparently when the path ends in ``.gz`` (any case) OR the
stream starts with the gzip magic ``1f 8b``; decompress mode never
auto-gunzips its input.
"""

from __future__ import annotations

import gzip
import io
from typing import BinaryIO

GZIP_MAGIC = b"\x1f\x8b"


class PeekableReader(io.RawIOBase):
    """Buffered reader supporting a 2-byte peek over any binary stream."""

    def __init__(self, raw: BinaryIO):
        self._raw = raw
        self._buf = b""

    def peek(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._raw.read(n - len(self._buf))
            if not chunk:
                break
            self._buf += chunk
        return self._buf[:n]

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            out = self._buf + self._raw.read()
            self._buf = b""
            return out
        if self._buf:
            out, self._buf = self._buf[:n], self._buf[n:]
            if len(out) < n:
                out += self._raw.read(n - len(out))
            return out
        return self._raw.read(n)

    def readable(self) -> bool:
        return True


def has_gzip_magic(reader: PeekableReader) -> bool:
    return reader.peek(2) == GZIP_MAGIC


def wrap_input_maybe_gzip(path: str, raw: BinaryIO) -> BinaryIO:
    """Wrap a compress-mode input with gzip decoding when appropriate.

    Seekable plain sources are sniffed in place and rewound so the
    unwrapped reader comes back — a PeekableReader veil would hide the
    file from the whole-file mmap pipeline (E043) and every plain-file
    compress would silently take the streaming fallback.
    """
    if not path.lower().endswith(".gz"):
        # prove seekability BEFORE consuming bytes: a reader whose
        # tell()/read() work but whose seek() throws would otherwise
        # lose the 2 sniffed bytes on the fallback path
        try:
            pos = raw.tell()
            raw.seek(pos)
        except (OSError, AttributeError, ValueError):
            pr = PeekableReader(raw)
            if has_gzip_magic(pr):
                return gzip.GzipFile(fileobj=pr, mode="rb")  # type: ignore[return-value]
            return pr  # type: ignore[return-value]
        magic = raw.read(2)
        try:
            raw.seek(pos)
        except OSError:
            # seek regressed between probe and rewind: replay the bytes
            pr = PeekableReader(raw)
            pr._buf = bytes(magic) + pr._buf
            if has_gzip_magic(pr):
                return gzip.GzipFile(fileobj=pr, mode="rb")  # type: ignore[return-value]
            return pr  # type: ignore[return-value]
        if magic != GZIP_MAGIC:
            return raw
        return gzip.GzipFile(fileobj=raw, mode="rb")  # type: ignore[return-value]
    return gzip.GzipFile(
        fileobj=PeekableReader(raw), mode="rb"
    )  # type: ignore[return-value]
