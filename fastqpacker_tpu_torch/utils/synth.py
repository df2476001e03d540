"""Seeded synthetic Illumina-style FASTQ (numpy only).

The shape of the repo benchmark's default fixture (``bench.py``
``synth_fastq``): IID uniform bases, about 0.1% N, qualities tiled from a
pool of 512 correlated random-walk rows, and fixed-width headers
``@SIM0.<9-digit id> <k>:N:0:ACGTACGT length=<L>``. ``min_len`` turns on
variable read lengths, uniform in ``[min_len, read_len]``.

``qual_model="walk"`` gives every record its own quality random walk with
IID skewed steps (72% 0, 10% each +-1, 4% each +-2) at high levels (ASCII
83-122), and '#' at N bases. Nothing repeats, so zstd finds no matches, the
delta stream is IID with ~1.4 bits per symbol, and the levels lie above the
context model's bins: FQZ v3 codes such a quality stream with order-0 rANS
(``TAG_RANS``), which the tiled default never does.

``seq_model="markov"`` draws every read from an order-1 Markov chain over
ACGT (no N, nothing an LZ matcher finds), and ``qual_model="phredwalk"``
gives every record its own walk in Phred 0-41 (ASCII 33-74: uniform steps
in -2..2, summed and divided by 3, from Phred 30). Together they are the
context-model corpus: the context coders beat zstd and order-0 rANS on both
streams, so the ``--mesh`` path codes them ``TAG_WCTX``.

:func:`illumina_fastq` writes a block of records whose read names vary in
width as real Illumina names do, so that a header stream is not one record
length throughout. :func:`ordered_illumina_fastq` writes names in the order
bcl2fastq writes one lane (tiles in order, y ascending within a tile), on
which FQZ v3 picks the header tokenizer (``TAG_TOK``).
"""

from __future__ import annotations

import numpy as np

_QUAL_POOL = 512
_ID_DIGITS = 9

# byte -> quality step of the "walk" model: 184/256 zeros, 26/256 each of
# +-1, 10/256 each of +-2
_WALK_STEPS = np.repeat(
    np.array([0, 1, -1, 2, -2], dtype=np.int8), [184, 26, 26, 10, 10]
)
_WALK_LO, _WALK_HI = 83, 122

# order-1 transition probabilities of the "markov" bases, row = previous base
_MARKOV = np.array(
    [
        [0.17, 0.45, 0.25, 0.13],
        [0.13, 0.17, 0.45, 0.25],
        [0.45, 0.25, 0.13, 0.17],
        [0.25, 0.13, 0.17, 0.45],
    ]
)


def walk_steps(rng: np.random.Generator, shape) -> np.ndarray:
    """IID quality steps of the "walk" model, int8 of ``shape``."""
    return _WALK_STEPS[rng.integers(0, 256, size=shape, dtype=np.uint8)]


def markov_codes(rng: np.random.Generator, n: int, read_len: int) -> np.ndarray:
    """(n, read_len) base codes, every row its own order-1 Markov chain
    from base 0; one vector step per position."""
    cum = np.cumsum(_MARKOV, axis=1)
    codes = np.empty((n, read_len), dtype=np.uint8)
    prev = np.zeros(n, dtype=np.int64)
    for j in range(read_len):
        u = rng.random(n)
        prev = np.minimum((u[:, None] >= cum[prev]).sum(axis=1), 3)
        codes[:, j] = prev
    return codes


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
    qual_model: str = "tiled",
    seq_model: str = "iid",
) -> bytes:
    """About ``target_mb`` MiB of FASTQ text, reproducible from ``seed``.
    ``qual_model``: "tiled" (512 pooled rows), "walk" or "phredwalk";
    ``seq_model``: "iid" or "markov" (see the module docstring)."""
    if qual_model not in ("tiled", "walk", "phredwalk"):
        raise ValueError(f"unknown qual_model: {qual_model}")
    if seq_model not in ("iid", "markov"):
        raise ValueError(f"unknown seq_model: {seq_model}")
    rng = np.random.default_rng(seed)
    mean_len = read_len if min_len is None else (min_len + read_len) / 2
    hw = _headers(1, read_len).shape[1]
    n = max(1, int((target_mb * (1 << 20)) // (hw + 2 * mean_len + 5)))

    if min_len is None:
        lengths = np.full(n, read_len, dtype=np.int64)
    else:
        lengths = rng.integers(min_len, read_len + 1, size=n)
    bases = np.frombuffer(b"ACGT", np.uint8)
    if seq_model == "markov":
        seq = bases[markov_codes(rng, n, read_len)]
    else:
        seq = bases[rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)]
        nn = max(1, n * read_len // 1000)  # sparse N positions (~0.1%)
        seq[rng.integers(0, n, nn), rng.integers(0, read_len, nn)] = ord("N")
    if qual_model == "phredwalk":
        steps = rng.integers(-2, 3, size=(n, read_len)).astype(np.int32)
        qual = np.clip(
            33 + 30 + np.cumsum(steps, axis=1) // 3, 33, 74
        ).astype(np.uint8)
    elif qual_model == "walk":
        steps = walk_steps(rng, (n, read_len))
        walk = np.cumsum(steps, axis=1, dtype=np.int16)
        walk += rng.integers(95, 111, size=(n, 1), dtype=np.int16)
        qual = np.clip(walk, _WALK_LO, _WALK_HI).astype(np.uint8)
        qual[seq == ord("N")] = ord("#")
    else:
        steps = rng.integers(-2, 3, size=(_QUAL_POOL, read_len)).astype(np.int32)
        qrows = np.clip(
            33 + 30 + np.cumsum(steps, axis=1) // 3, 33, 74
        ).astype(np.uint8)
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


def illumina_fastq(records: int, read_len: int = 151, seed: int = 0) -> bytes:
    """``records`` records with Illumina-style read names of varying width,
    ``@<instrument>:<run>:<flowcell>:<lane>:<tile>:<x>:<y> <read>:N:0:<index>``
    (tile, x and y of 1-5 digits each, the digit count and the value drawn
    per record), IID bases with about 0.1% N and qualities tiled from the
    default pool, all reproducible from ``seed``."""
    rng = np.random.default_rng(seed)
    n = records
    digits = rng.integers(1, 6, size=(n, 3))
    coords = rng.integers(0, 10**digits, dtype=np.int64)  # below 10 ** digits
    lanes = rng.integers(1, 5, size=n)
    reads = rng.integers(1, 3, size=n)
    index = "".join("ACGT"[k] for k in rng.integers(0, 4, size=8))
    names = [
        f"@A00953:{217 + seed % 100}:HFWLKDSXY:{lane}:{t}:{x}:{y} {rd}:N:0:{index}\n".encode()
        for lane, (t, x, y), rd in zip(lanes.tolist(), coords.tolist(), reads.tolist())
    ]
    return _records(rng, names, read_len)


# records per tile of ordered_illumina_fastq, and its tiles in the order a
# NovaSeq flow cell lane is written: surface, swath, tile
_TILE_RECORDS = 4000
_TILES = [s * 1000 + w * 100 + t for s in (1, 2) for w in (1, 2, 3, 4) for t in range(1, 79)]


def ordered_illumina_fastq(records: int, read_len: int = 151, seed: int = 0) -> bytes:
    """``records`` records of one lane with read names in instrument order,
    ``@<instrument>:<run>:<flowcell>:<lane>:<tile>:<x>:<y> <read>:N:0:<index>``
    as bcl2fastq writes a lane: tiles in order (1101, 1102, ...; 4,000
    records each), y ascending within a tile (steps of 0-8 from 1,000), x
    random of 4-5 digits (1,000-32,999), read 1, one index; bases and
    qualities as :func:`illumina_fastq`'s, all reproducible from ``seed``."""
    rng = np.random.default_rng(seed)
    n = records
    k = np.arange(n)
    tiles = np.array(_TILES, np.int64)[(k // _TILE_RECORDS) % len(_TILES)]
    steps = rng.integers(0, 9, size=n)
    first = k % _TILE_RECORDS == 0
    ys = np.cumsum(steps)
    ys = 1000 + ys - np.maximum.accumulate(np.where(first, ys, 0))
    xs = rng.integers(1000, 33000, size=n)
    index = "".join("ACGT"[j] for j in rng.integers(0, 4, size=8))
    names = [
        f"@A00953:{217 + seed % 100}:HFWLKDSXY:1:{t}:{x}:{y} 1:N:0:{index}\n".encode()
        for t, x, y in zip(tiles.tolist(), xs.tolist(), ys.tolist())
    ]
    return _records(rng, names, read_len)


def _records(rng: np.random.Generator, names: list, read_len: int) -> bytes:
    """FASTQ records of the header lines ``names``: IID bases with about
    0.1% N and qualities tiled from the default pool."""
    n = len(names)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)]
    nn = max(1, n * read_len // 1000)
    seq[rng.integers(0, n, nn), rng.integers(0, read_len, nn)] = ord("N")
    steps = rng.integers(-2, 3, size=(_QUAL_POOL, read_len)).astype(np.int32)
    qrows = np.clip(33 + 30 + np.cumsum(steps, axis=1) // 3, 33, 74).astype(np.uint8)
    body = np.concatenate(
        [seq, np.full((n, 3), np.frombuffer(b"\n+\n", np.uint8)),
         qrows[np.arange(n) % _QUAL_POOL], np.full((n, 1), 0x0A, np.uint8)], axis=1)
    return b"".join(h + b for h, b in zip(names, map(bytes, body)))
