"""Vectorized variable-length <-> padded-rectangular conversions on the host.

The numpy helpers of ``fastqpacker_tpu/utils/varlen.py`` that host-only code
of the port still calls (the lossless side data, the ``--pair`` splicing).
The block stages that move a block's rows and runs on the card are
:mod:`..ops.records`.
"""

from __future__ import annotations

import numpy as np


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
