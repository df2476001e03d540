"""Seeded FASTQ inputs for the block-stage tests (``test_torch_records.py``
on the CPU, ``test_torch_cuda.py`` on the card): records whose header, plus
and N-position streams end at, and one unit either side of, the tile edges
of the assembly's chain kernel, blocks at the write kernel's tile edges,
read names that break the chain kernel's fast path, a 65,535-byte header
and plus line beside short ones, row-gather inputs, texts cut at the scan's
tile edges (:func:`scan_edge_cases`) and blocks cut at the stream build's
(:func:`streams_edge_cases`).
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


# ---------------------------------------------------------------------------
# the scan's and the stream build's tile edges
# ---------------------------------------------------------------------------

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def record(rng, hdr_width: int, read_len: int, nl: bytes = b"\n", n_at=(), n_all=False) -> bytes:
    """One record: a name of ``hdr_width`` digits, random ACGT bases (N at
    the positions ``n_at``, or everywhere with ``n_all``), qualities 33-74,
    a bare '+', lines ended by ``nl``."""
    seq = _ACGT[rng.integers(0, 4, read_len)]
    seq[list(n_at)] = ord("N")
    if n_all:
        seq[:] = ord("N")
    qual = rng.integers(33, 75, read_len).astype(np.uint8).tobytes()
    name = (48 + rng.integers(0, 10, hdr_width)).astype(np.uint8).tobytes()
    return b"@" + name + nl + seq.tobytes() + nl + b"+" + nl + qual + nl


def newline_at(pos: int, seed: int, crlf: bool = False) -> bytes:
    """Records of 50-150 bp whose text has the newline of a header line at
    byte ``pos`` (with ``crlf``, its '\r' at ``pos - 1``), then three more."""
    rng = np.random.default_rng(seed)
    nl = b"\r\n" if crlf else b"\n"
    parts, size = [], 0
    while size + 800 < pos:
        parts.append(record(rng, int(rng.integers(5, 30)), int(rng.integers(50, 151)), nl))
        size += len(parts[-1])
    # '@' at size, the name, then the line's end: its '\n' at pos
    parts.append(record(rng, pos - size - len(nl), 100, nl))
    parts += [record(rng, 12, int(rng.integers(50, 151)), nl) for _ in range(3)]
    text = b"".join(parts)
    assert text[pos] == 0x0A and (not crlf or text[pos - 1] == 0x0D)
    return text


def _bad_line(text: bytes, line: int, how: str) -> bytes:
    """``text`` with line ``line`` broken: a header without '@', a plus line
    without '+', or a quality line one byte short."""
    lines = text.split(b"\n")
    if how == "header":
        lines[line] = b"x" + lines[line][1:]
    elif how == "plus":
        lines[line] = b"-" + lines[line][1:]
    else:
        lines[line] = lines[line][:-1]
    return b"\n".join(lines)


def _line_in_tile(text: bytes, tile: int, kind: int) -> int:
    """The index of the first line of kind ``kind`` (0 header .. 3 quality)
    that starts inside scan tile ``tile``."""
    ends = np.flatnonzero(np.frombuffer(text, np.uint8) == 0x0A)
    starts = np.r_[0, ends[:-1] + 1]
    lines = np.flatnonzero((starts // recops.SCAN_TILE == tile) & (np.arange(len(starts)) % 4 == kind))
    return int(lines[0])


def scan_edge_cases() -> dict:
    """name -> (text, max_records): texts cut at the scan's 32 KiB tiles. A
    newline at a tile edge and one byte either side; a CRLF whose '\r' and
    '\n' lie in two tiles; a 70,000-bp read (five tiles) with an N past
    65,536 (the v2 overflow row); malformed lines in two tiles (the lower
    line index wins); a malformed line past 4 * max_records (never looked
    at); max_records reached mid-tile; empty text; no trailing newline."""
    t = recops.SCAN_TILE
    cases = {}
    for d in EDGES:
        cases[f"newline_{t + d}"] = (newline_at(t + d, 60 + d), 1000)
    cases["crlf_split"] = (newline_at(2 * t, 63, crlf=True), 1000)
    rng = np.random.default_rng(64)
    cases["read_70000_n_past_65536"] = (
        record(rng, 8, 151) + record(rng, 9, 70_000, n_at=(10, 65_636)) + record(rng, 8, 151), 10)
    body = b"".join(record(rng, int(rng.integers(5, 30)), int(rng.integers(50, 151)))
                    for _ in range(800))
    text = _bad_line(body, _line_in_tile(body, 5, 2), "plus")
    cases["bad_plus_tile5_bad_header_tile1"] = (
        _bad_line(text, _line_in_tile(text, 1, 0), "header"), 1000)
    text = _bad_line(body, _line_in_tile(body, 4, 0), "header")
    cases["bad_header_tile4_bad_length_tile2"] = (
        _bad_line(text, _line_in_tile(text, 2, 3), "length"), 1000)
    ends = np.flatnonzero(np.frombuffer(body, np.uint8) == 0x0A)[3::4]
    mid = int(np.argmin(np.abs(ends - int(2.5 * t)))) + 1  # records ending mid tile 2
    cases["max_records_mid_tile"] = (body, mid)
    cases["bad_line_past_max_records"] = (
        _bad_line(body, 4 * mid + 2, "plus"), mid)
    cases["empty"] = (b"", 10)
    cases["no_trailing_newline"] = (body[:-1], 1000)
    return cases


def streams_edge_cases() -> dict:
    """name -> FASTQ text for the stream build: blocks of one record short
    of, at and one past a tile of records; three tiles and a few records
    whose six stream ranges start and end inside 16-byte units; reads with
    no N and with every base N, narrow (10-40 bp) and wide (300-600 bp: N
    positions past one shared-memory window); a 70,000-bp read (its quality
    range past one window) between short ones."""
    tile = recops.STREAM_TILE_RECORDS
    cases = {}
    for d in EDGES:
        cases[f"records_{tile + d}"] = fastq(tile + d, 70 + d)
    cases["three_tiles_unaligned"] = fastq(3 * tile + 5, 73, read_len=(0, 90),
                                           plus_widths=np.random.default_rng(74).integers(0, 9, 3 * tile + 5))
    rng = np.random.default_rng(75)
    for name, lo, hi in (("narrow", 10, 40), ("wide", 300, 600)):
        cases[f"no_n_{name}"] = b"".join(
            record(rng, int(rng.integers(3, 20)), int(rng.integers(lo, hi + 1))) for _ in range(300))
        cases[f"all_n_{name}"] = b"".join(
            record(rng, int(rng.integers(3, 20)), int(rng.integers(lo, hi + 1)), n_all=True)
            for _ in range(300))
    cases["read_70000"] = (b"".join(record(rng, 8, 151, n_at=(3,)) for _ in range(40))
                           + record(rng, 9, 70_000, n_at=(5, 40_000, 65_535))
                           + b"".join(record(rng, 8, 151) for _ in range(40)))
    return cases
