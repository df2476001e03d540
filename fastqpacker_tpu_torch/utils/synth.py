"""Seeded synthetic Illumina-style FASTQ (numpy only).

The shape of the repo benchmark's default fixture (``bench.py``
``synth_fastq``): IID uniform bases, about 0.1% N, qualities tiled from a
pool of 512 correlated random-walk rows, and fixed-width headers
``@SIM0.<9-digit id> <k>:N:0:ACGTACGT length=<L>``. ``min_len`` turns on
variable read lengths, uniform in ``[min_len, read_len]``.
"""

from __future__ import annotations

import numpy as np

_QUAL_POOL = 512
_ID_DIGITS = 9


def _headers(n: int, read_len: int) -> np.ndarray:
    """(n, width) header lines with '@' and fixed-width zero-padded ids."""
    tmpl = f"@SIM0.{'0' * _ID_DIGITS} 0:N:0:ACGTACGT length={read_len}"
    hmat = np.tile(np.frombuffer(tmpl.encode(), np.uint8), (n, 1))
    ids = np.arange(n, dtype=np.int64)
    col0 = 6  # first id digit
    for d in range(_ID_DIGITS):
        hmat[:, col0 + _ID_DIGITS - 1 - d] = (ids // 10**d) % 10 + ord("0")
    hmat[:, col0 + _ID_DIGITS + 1] = (ids % 4).astype(np.uint8) + ord("0")
    return hmat


def synth_fastq(
    target_mb: float,
    read_len: int = 151,
    seed: int = 0,
    min_len: int | None = None,
) -> bytes:
    """About ``target_mb`` MiB of FASTQ text, reproducible from ``seed``."""
    rng = np.random.default_rng(seed)
    mean_len = read_len if min_len is None else (min_len + read_len) / 2
    hw = _headers(1, read_len).shape[1]
    n = max(1, int((target_mb * (1 << 20)) // (hw + 2 * mean_len + 5)))

    if min_len is None:
        lengths = np.full(n, read_len, dtype=np.int64)
    else:
        lengths = rng.integers(min_len, read_len + 1, size=n)
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq = bases[rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)]
    nn = max(1, n * read_len // 1000)  # sparse N positions (~0.1%)
    seq[rng.integers(0, n, nn), rng.integers(0, read_len, nn)] = ord("N")
    steps = rng.integers(-2, 3, size=(_QUAL_POOL, read_len)).astype(np.int32)
    qrows = np.clip(33 + 30 + np.cumsum(steps, axis=1) // 3, 33, 74).astype(
        np.uint8
    )
    qual = qrows[np.arange(n) % _QUAL_POOL]

    def col(ch: bytes) -> np.ndarray:
        return np.full((n, len(ch)), np.frombuffer(ch, np.uint8))

    # fixed column layout per record; padding columns past a record's
    # length are dropped by the mask
    rows = np.concatenate(
        [_headers(n, read_len), col(b"\n"), seq, col(b"\n+\n"), qual, col(b"\n")],
        axis=1,
    )
    if min_len is None:
        return rows.tobytes()
    keep = np.ones(rows.shape, dtype=bool)
    pad = np.arange(read_len)[None, :] >= lengths[:, None]
    keep[:, hw + 1 : hw + 1 + read_len] = ~pad
    keep[:, hw + 4 + read_len : hw + 4 + 2 * read_len] = ~pad
    return rows[keep].tobytes()
