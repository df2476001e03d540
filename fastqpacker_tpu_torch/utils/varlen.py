"""Vectorized variable-length <-> padded-rectangular conversions.

The device wants dense ``(records, max_len)`` rectangles; the FQZ wire
format wants tightly concatenated per-record byte runs. These helpers
convert between the two with whole-array numpy ops (the numpy paths of
``fastqpacker_tpu/utils/varlen.py``; the port has no C++ host runtime).
"""

from __future__ import annotations

import numpy as np


def gather_rows(
    data: np.ndarray,
    starts: np.ndarray,
    lengths: np.ndarray,
    pad_to: int | None = None,
    fill: int = 0,
) -> np.ndarray:
    """Gather variable-length byte runs from ``data`` into a padded matrix.

    Row i of the result is ``data[starts[i] : starts[i]+lengths[i]]`` padded
    with ``fill`` to ``pad_to`` (default: max length) columns.
    """
    n = len(starts)
    max_len = int(lengths.max()) if n else 0
    width = max_len if pad_to is None else pad_to
    if n == 0 or width == 0:
        return np.full((n, width), fill, dtype=data.dtype)
    lengths = lengths.astype(np.int64, copy=False)
    starts = starts.astype(np.int64, copy=False)
    col = np.arange(width, dtype=np.int64)
    mask = col[None, :] < lengths[:, None]
    out = np.full((n, width), fill, dtype=data.dtype)
    src = starts[:, None] + col[None, :]
    out[mask] = data[src[mask]]
    return out


def flatten_rows(padded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenate the first ``lengths[i]`` elements of each row (row-major)."""
    if padded.shape[0] == 0 or padded.shape[1] == 0:
        return np.empty(0, dtype=padded.dtype)
    col = np.arange(padded.shape[1], dtype=np.int64)
    mask = col[None, :] < lengths[:, None].astype(np.int64)
    return padded[mask]


def scatter_rows(
    out: np.ndarray,
    flat: np.ndarray,
    dst_starts: np.ndarray,
    lengths: np.ndarray,
) -> None:
    """Scatter concatenated per-row runs in ``flat`` to ``dst_starts`` offsets.

    Inverse of :func:`flatten_rows` into an existing 1-D buffer: row i's
    ``lengths[i]`` elements are copied to ``out[dst_starts[i]:...]``.
    """
    n = len(dst_starts)
    if n == 0:
        return
    lengths = lengths.astype(np.int64, copy=False)
    width = int(lengths.max())
    if width == 0:
        return
    col = np.arange(width, dtype=np.int64)
    mask = col[None, :] < lengths[:, None]
    dst = dst_starts.astype(np.int64)[:, None] + col[None, :]
    out[dst[mask]] = flat


def build_len16_stream(
    data: np.ndarray, starts: np.ndarray, lengths: np.ndarray
) -> bytes:
    """Build the u16-length-prefixed concatenated stream used for the header
    and plus-line payloads (reference: compress.go:514-519).
    """
    n = len(starts)
    lengths = lengths.astype(np.int64, copy=False)
    if np.any(lengths > 0xFFFF):
        raise ValueError("record field longer than 65535 bytes")
    total = int(2 * n + lengths.sum())
    out = np.zeros(total, dtype=np.uint8)
    if n == 0:
        return out.tobytes()
    prefix_off = 2 * np.arange(n, dtype=np.int64) + np.concatenate(
        ([0], np.cumsum(lengths[:-1]))
    )
    lens16 = lengths.astype(np.uint16)
    out[prefix_off] = (lens16 & 0xFF).astype(np.uint8)
    out[prefix_off + 1] = (lens16 >> 8).astype(np.uint8)
    scatter_rows(out, flatten_rows(
        gather_rows(data, starts, lengths), lengths
    ), prefix_off + 2, lengths)
    return out.tobytes()


def parse_len16_stream(
    data: np.ndarray, count: int, what: str = "data"
) -> tuple[np.ndarray, np.ndarray]:
    """Parse a u16-length-prefixed stream into (starts, lengths) arrays.

    Mirrors the per-record offset walk of the reference decoder
    (compress.go:977-1015); the prefix chain is inherently sequential, so
    each record is one O(1) step.
    """
    starts = np.empty(count, dtype=np.int64)
    lengths = np.empty(count, dtype=np.int64)
    off = 0
    nd = len(data)
    for i in range(count):
        if off + 2 > nd:
            raise ValueError(f"truncated {what} data")
        ln = int(data[off]) | (int(data[off + 1]) << 8)
        off += 2
        if off + ln > nd:
            raise ValueError(f"truncated {what} data")
        starts[i] = off
        lengths[i] = ln
        off += ln
    return starts, lengths
