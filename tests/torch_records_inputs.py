"""Seeded FASTQ inputs for the block-stage tests (``test_torch_records.py``
on the CPU, ``test_torch_cuda.py`` on the card): records whose header, plus
and N-position streams end at, and one unit either side of, the tile edges
of the assembly's chain kernel, blocks at the write kernel's tile edges,
read names that break the chain kernel's fast path, a 65,535-byte header
and plus line beside short ones, and row-gather inputs.
"""

import numpy as np

from fastqpacker_tpu_torch.ops import records as recops

# the chain kernel's tile at the sizes below (streams of < 16 tiles of the
# least tile): every edge case lands on a multiple of it
EDGE_TILE = recops.CHAIN_MIN_TILE
EDGES = (-1, 0, 1)


def _split(rng, total: int, parts: int, hi: int) -> np.ndarray:
    """``parts`` seeded ints in [0, hi] that sum to ``total``."""
    if not 0 <= total <= parts * hi:
        raise ValueError(f"cannot split {total} into {parts} parts of <= {hi}")
    out = np.full(parts, total // parts, dtype=np.int64)
    out[: total % parts] += 1
    for _ in range(4 * parts):  # move a few units between random parts
        a, b = rng.integers(0, parts, 2)
        k = min(int(rng.integers(0, 8)), int(out[a]), hi - int(out[b]))
        out[a] -= k
        out[b] += k
    return out


def fastq(r: int, seed: int, *, hdr_bytes=None, plus_bytes=None, n_total=None,
          read_len=(0, 60), hdr_widths=None, plus_widths=None, n_counts=None) -> bytes:
    """``r`` records. ``hdr_bytes`` / ``plus_bytes``: the byte size of the
    header / plus stream (2 + payload per record), or ``*_widths``: the
    payload widths; ``n_total``: the N-position stream's units (1 + Ns per
    record) or ``n_counts``: Ns per record. Unset: random widths of 0-40,
    no plus payload, ~2% N."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(read_len[0], read_len[1] + 1, r)
    if hdr_widths is None:
        hdr_widths = (rng.integers(0, 41, r) if hdr_bytes is None
                      else _split(rng, hdr_bytes - 2 * r, r, 60))
    if plus_widths is None:
        plus_widths = (np.zeros(r, np.int64) if plus_bytes is None
                       else _split(rng, plus_bytes - 2 * r, r, 60))
    if n_counts is None:
        if n_total is None:
            n_counts = np.array([int((rng.random(int(n)) < 0.02).sum()) for n in lens])
        else:
            lens = np.maximum(lens, 40)
            n_counts = _split(rng, n_total - r, r, 40)
    recs = []
    for i in range(r):
        ln = int(max(lens[i], n_counts[i]))
        seq = bytearray(b"ACGT"[k] for k in rng.integers(0, 4, ln))
        for p in rng.choice(ln, int(n_counts[i]), replace=False) if n_counts[i] else ():
            seq[p] = ord("N")
        qual = bytes(int(q) for q in rng.integers(33, 75, ln))
        hdr = bytes(rng.integers(33, 127, int(hdr_widths[i])).astype(np.uint8))
        plus = bytes(rng.integers(33, 127, int(plus_widths[i])).astype(np.uint8))
        hdr = hdr.replace(b"@", b"A").replace(b"+", b"B")
        recs.append(b"@" + hdr + b"\n" + bytes(seq) + b"\n+" + plus + b"\n" + qual + b"\n")
    return b"".join(recs)


def edge_cases() -> dict:
    """name -> FASTQ text whose chained streams end at a chain tile edge,
    one unit before it or one past it (and cross the edges before)."""
    cases = {}
    for d in EDGES:
        t = EDGE_TILE
        cases[f"headers_{2 * t + d}"] = fastq(60, 10 + d, hdr_bytes=2 * t + d)
        cases[f"plus_{t + d}"] = fastq(30, 20 + d, plus_bytes=t + d)
        cases[f"npos_{2 * t + d}"] = fastq(70, 30 + d, n_total=2 * t + d)
    # blocks of one record short of, at and one past a tile of the write
    # kernel (reads up to 60 bp: rows of 64 bytes)
    for d in EDGES:
        n = recops.assemble_tile_records(64) + d
        cases[f"records_{n}"] = fastq(n, 50 + d)
    # a stream whose size fits one record length, which only the last
    # records break (the uniform check fails late)
    cases["headers_one_off"] = fastq(500, 40, hdr_widths=np.r_[np.full(498, 20), 19, 21])
    # records of 32 bytes but the last two: a record starts on every tile
    # edge
    cases["headers_on_edges"] = fastq(300, 42, hdr_widths=np.r_[np.full(298, 30), 29, 31])
    # read names that a record start can be told from by the 0 byte after
    # it, but for one record in the middle (an empty name, a name of 300
    # bytes, a name with a NUL byte) or the first: the chain is resolved by
    # candidates up to that record's tile and by doubling from there
    widths = np.random.default_rng(43).integers(40, 61, 600)
    for name, at, w in (("empty", 300, 0), ("long", 300, 300), ("first_long", 0, 300)):
        cases[f"names_{name}"] = fastq(600, 44, hdr_widths=np.r_[widths[:at], w, widths[at + 1 :]])
    lines = fastq(600, 45, hdr_widths=widths).split(b"\n")
    lines[4 * 350] = lines[4 * 350][:3] + b"\0" + lines[4 * 350][4:]
    cases["names_nul"] = b"\n".join(lines)
    # a 65,535-byte header and plus line beside short ones
    widths = np.full(40, 7)
    widths[[3, 30]] = 65535
    cases["long_fields"] = fastq(40, 41, hdr_widths=widths, plus_widths=widths[::-1].copy())
    return cases


def gather_case(rng, r: int, data_n: int, lo=0, hi=60):
    """Seeded bytes, ascending and scattered starts and lengths for row
    gathers: some rows empty, some past the data's end, some negative."""
    data = rng.integers(0, 256, data_n).astype(np.uint8)
    lens = rng.integers(lo, hi + 1, r).astype(np.int64)
    lens[:: 7] = 0
    starts = np.sort(rng.integers(0, data_n, r)).astype(np.int64)
    scattered = rng.integers(-20, data_n + 20, r).astype(np.int64)
    return data, starts, scattered, lens
