"""The C++ runtime's block stages as tensor functions: record scan, row
gather, v1/v2 stream build and FASTQ assembly.

The port's counterpart of the block functions of
``fastqpacker_tpu/runtime/fqruntime.cpp``: ``fq_scan_records_ex`` (with its
``qmin_io``), ``fq_gather_rows``, ``fq_build_streams`` / ``fq_build_len16`` /
``fq_build_npos(32)`` and ``fq_decode_block_full`` / ``fq_assemble`` /
``fq_parse_len16`` / ``fq_parse_npos(32)``. The runtime walks a block record
by record on one host thread; here each stage is one kernel of
``csrc/records.cu`` over the whole block on the card, and the block's text,
rows and streams stay there between the stages.

Each ``*_plain`` function is the plain PyTorch version of one kernel: what
the wrappers of :mod:`.cuda_kernels` run on CPU tensors and what the kernels
are held against on the card. They compute the same values, so the two agree
byte for byte on every input. Both recognise a uniform length-prefixed chain
first; past that the plain version resolves a chain by pointer doubling over
the whole stream and the kernel by tiles of the stream chained in order
(``csrc/records.cu``), to the same nodes.

The kernels' geometry lives here (the wrappers pass it to the launchers, and
``tests/test_torch_records.py`` holds the constants equal to the source), so
the tests can cut their inputs at the kernels' tile edges.
"""

from __future__ import annotations

import torch

# fq_records_scan's info vector (csrc/records.cu has the same slots)
SCAN_COUNT = 0  # complete records found, at most max_records
SCAN_CONSUMED = 1  # bytes up to the end of the last of them
SCAN_ERROR = 2  # 0, or the code of the first malformed line (1 header, 2 plus, 3 lengths)
SCAN_ERROR_LINE = 3  # its line index (NONE if none)
SCAN_LINES = 4  # complete lines looked at: min(newlines, 4 * max_records)
SCAN_SEQ_SUM = 5  # over the complete records: sequence bytes,
SCAN_SEQ_MAX = 6  # the longest read,
SCAN_PACKED_SUM = 7  # packed sequence bytes, sum of (len + 3) // 4,
SCAN_HDR_SUM = 8  # header payload bytes,
SCAN_HDR_MAX = 9  # the longest header payload,
SCAN_PLUS_SUM = 10  # plus-line payload bytes,
SCAN_PLUS_MAX = 11  # the longest plus-line payload,
SCAN_AMBIG = 12  # non-ACGT bases (upper or lower case) within the reads,
SCAN_OVERFLOW_ROW = 13  # the first record with one at position >= 65,536 (NONE if none)
SCAN_INFO = 16
NONE = (1 << 63) - 1
EMPTY_QMIN = 256  # the quality minimum of a record with an empty quality line
V2_NPOS_LIMIT = 1 << 16  # u16 N positions (sequence.go:11)

# fq_fastq_assemble's fault flags, in the order the decoder reports them
# (pipeline/blocks.py: streams_to_fastq)
ASSEMBLE_FAULTS = (
    "truncated length data",
    "truncated sequence data",
    "truncated quality data",
    "truncated N position data",
    "invalid N position data",
    "truncated header data",
    "truncated plus-line payload data",
)
FAULT_INVALID_NPOS = 1 << 4

_NL, _CR = 0x0A, 0x0D
_I64 = torch.int64

# csrc/records.cu's geometry
SCAN_TILE = 32768  # text bytes per CTA of the scan's newline pass (kTile)
SCAN_CTA_RECORDS = 64  # records a CTA of the scan's records pass takes at once (kWarps *
#                        kRecordsPerWarp: a group of 4 lanes each)
SCAN_CTAS_PER_SM = 8  # the records pass's CTAs at most, per SM (kScanCtasPerSm)
SCAN_PARTS = 10  # int64 partials per CTA of the records pass (kParts)
STREAM_TILE_RECORDS = 128  # records per CTA of the stream build at most (kStreamMaxRecords)
STREAM_WINDOW = 40960  # shared bytes of a stream build tile's output (kStreamWindow)
GATHER_MAX_ROWS = 256  # rows per tile of the gather at most (kGatherMaxRows)
GATHER_TILE_BYTES = 8192  # output bytes a gather tile aims at: from the text,
GATHER_CHAINED_TILE_BYTES = 32768  # and back to back (fewer tiles to look back over)
CHAIN_MIN_TILE = 1024  # nodes per tile of the chain kernel (kChainMinTile ..
CHAIN_MAX_TILE = 16384  # kChainMaxTile, a power of two)
CHAIN_TILES = 16  # tiles a chain's stream is cut into where the sizes allow
ASSEMBLE_MAX_RECORDS = 64  # records per tile of the write kernel at most (kWriteMaxRecords)
ASSEMBLE_ROW_BYTES = 8192  # row bytes (bases or qualities) a write tile aims at
CHECK_THREADS = 256  # records a check CTA takes at a time (kCheckThreads)
SLOT_WORDS = 4  # int64 per check CTA in the assembly's scratch (kSlotWords)
STATUS_WORDS = 16  # int64 per tile of the look-back status buffer (kStatusWords)
NODE_LIMIT = (1 << 31) - 2  # nodes of a chained stream, records of a block (kNodeLimit)


def _align256(b: int) -> int:
    return (b + 255) & ~255


def gather_tile_rows(width: int, back_to_back: bool) -> int:
    """Rows per CTA of the gather for rows of ``width`` bytes in all (both
    matrices of a pair), from the text or back to back."""
    target = GATHER_CHAINED_TILE_BYTES if back_to_back else GATHER_TILE_BYTES
    return max(1, min(GATHER_MAX_ROWS, target // max(width, 1)))


def chain_tile_nodes(n: int) -> int:
    """Nodes per tile of the chain kernel for a stream of ``n`` nodes: the
    least power of two from :data:`CHAIN_MIN_TILE` that cuts it into at
    most :data:`CHAIN_TILES` tiles, at most :data:`CHAIN_MAX_TILE`."""
    tile = CHAIN_MIN_TILE
    while tile < CHAIN_MAX_TILE and tile * CHAIN_TILES < n + 1:
        tile *= 2
    return tile


def assemble_tile_records(pitch: int) -> int:
    """Records per CTA of the assembly's write kernel for rows of ``pitch``
    bytes (it stages both rows of its tile in shared memory up to 16 KiB)."""
    return max(1, min(ASSEMBLE_MAX_RECORDS, ASSEMBLE_ROW_BYTES // max(pitch, 1)))


def stream_tile_records(sizes: list[int], n: int) -> int:
    """Records per CTA of the stream build for ``n`` records and the six
    stream ``sizes``: the largest power of two up to
    :data:`STREAM_TILE_RECORDS` whose average output fills at most three
    quarters of the shared-memory window (a tile that still overflows it
    writes the buffer directly)."""
    avg = sum(sizes) / max(n, 1)
    tile = STREAM_TILE_RECORDS
    while tile > 8 and tile * avg > 0.75 * STREAM_WINDOW:
        tile //= 2
    return tile


def scan_tiles(n: int) -> int:
    """Tiles of the scan's newline pass over ``n`` bytes of text (one for
    empty text): the status words it takes."""
    return max(1, -(-n // SCAN_TILE))


def scan_ctas(max_records: int, sms: int) -> int:
    """CTAs of the scan's records pass at most (:data:`SCAN_CTA_RECORDS`
    records a CTA at once, at most :data:`SCAN_CTAS_PER_SM` per SM): the room
    for their partials."""
    return max(1, min(-(-max_records // SCAN_CTA_RECORDS), SCAN_CTAS_PER_SM * sms))


def records_scan_scratch(max_records: int, ctas: int) -> int:
    """Scratch bytes of ``fq_records_scan``: the text's line count, the
    records pass's partials of up to ``ctas`` CTAs and each line's newline
    position."""
    return 256 + _align256(8 * SCAN_PARTS * ctas) + _align256(8 * 4 * max_records)


def assemble_scratch(r: int, checks: int) -> int:
    """Scratch bytes of ``fq_fastq_assemble``: the check CTAs' slots, then
    s_0 .. s_r (int32) of each of the three chains."""
    return _align256(8 * SLOT_WORDS * checks) + 3 * _align256(4 * (r + 1))


def _excl(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of a 1-D int64 tensor, with the total appended."""
    out = torch.zeros(x.numel() + 1, dtype=_I64, device=x.device)
    torch.cumsum(x, 0, out=out[1:])
    return out


def _segments(starts: torch.Tensor, lens: torch.Tensor):
    """(segment index, absolute position) of every byte of the runs
    ``[starts[i], starts[i] + lens[i])``, in order."""
    lens = lens.clamp(min=0)
    seg = torch.repeat_interleave(torch.arange(lens.numel(), device=lens.device), lens)
    first = _excl(lens)[:-1]
    pos = starts[seg] + torch.arange(seg.numel(), dtype=_I64, device=lens.device) - first[seg]
    return seg, pos


def _ambiguous(b: torch.Tensor) -> torch.Tensor:
    u = b & 0xDF
    return ~((u == 65) | (u == 67) | (u == 71) | (u == 84))


# ---------------------------------------------------------------------------
# 1. record scan (fq_scan_records_ex)
# ---------------------------------------------------------------------------


def records_scan_plain(text: torch.Tensor, max_records: int):
    """Scan up to ``max_records`` complete 4-line FASTQ records of ``text``.

    Returns ``(offsets, qmin, info)``: ``offsets`` (max_records, 8) int64
    ``{hdr_start, hdr_len, seq_start, seq_len, plus_start, plus_len,
    qual_start, qual_len}`` per record ('@' / '+' stripped, a '\\r' before
    '\\n' stripped), ``qmin`` (max_records,) int16, each record's least
    quality byte (:data:`EMPTY_QMIN` for an empty line), and ``info``
    (:data:`SCAN_INFO`,) int64 at the ``SCAN_*`` slots. Rows past the count
    are zero here and unwritten by the kernel. Only lines below
    ``4 * max_records`` are looked at; the complete lines of a trailing
    partial record are validated, unterminated bytes never are; the first
    malformed line by index wins, as in the runtime's record-at-a-time walk.
    """
    dev = text.device
    info = torch.zeros(SCAN_INFO, dtype=_I64, device=dev)
    info[SCAN_ERROR_LINE] = NONE
    info[SCAN_OVERFLOW_ROW] = NONE
    offsets = torch.zeros((max_records, 8), dtype=_I64, device=dev)
    qmin = torch.zeros(max_records, dtype=torch.int16, device=dev)
    nl = torch.nonzero(text == _NL).squeeze(1)[: 4 * max_records]
    lines = nl.numel()
    info[SCAN_LINES] = lines
    if lines == 0:
        return offsets, qmin, info
    starts = torch.zeros_like(nl)
    starts[1:] = nl[:-1] + 1
    ends = nl - ((nl > starts) & (text[(nl - 1).clamp(min=0)] == _CR)).to(_I64)
    lens = ends - starts
    first = text[starts].to(_I64)
    kind = torch.arange(lines, device=dev) % 4
    bad = ((kind == 0) & ((lens == 0) | (first != ord("@"))))
    bad |= (kind == 2) & ((lens == 0) | (first != ord("+")))
    seq_of = (torch.arange(lines, device=dev) - 2).clamp(min=0)
    bad |= (kind == 3) & (lens[seq_of] != lens)
    where = torch.nonzero(bad).squeeze(1)
    if where.numel():
        line = int(where[0])
        info[SCAN_ERROR_LINE] = line
        info[SCAN_ERROR] = {0: 1, 2: 2, 3: 3}[line % 4]
    count = lines // 4
    info[SCAN_COUNT] = count
    if count == 0:
        return offsets, qmin, info
    info[SCAN_CONSUMED] = nl[4 * count - 1] + 1
    s = starts[: 4 * count].view(count, 4)
    ln = lens[: 4 * count].view(count, 4)
    o = offsets[:count]
    o[:, 0], o[:, 1] = s[:, 0] + 1, ln[:, 0] - 1
    o[:, 2], o[:, 3] = s[:, 1], ln[:, 1]
    o[:, 4], o[:, 5] = s[:, 2] + 1, ln[:, 2] - 1
    o[:, 6], o[:, 7] = s[:, 3], ln[:, 3]
    seq_len, hdr_len, plus_len = ln[:, 1], (ln[:, 0] - 1).clamp(min=0), (ln[:, 2] - 1).clamp(min=0)
    info[SCAN_SEQ_SUM], info[SCAN_SEQ_MAX] = seq_len.sum(), seq_len.max()
    info[SCAN_PACKED_SUM] = ((seq_len + 3) >> 2).sum()
    info[SCAN_HDR_SUM], info[SCAN_HDR_MAX] = hdr_len.sum(), hdr_len.max()
    info[SCAN_PLUS_SUM], info[SCAN_PLUS_MAX] = plus_len.sum(), plus_len.max()
    # per-record quality minimum, over the rows padded with 0xFF (the
    # encode's rows are as wide)
    width = int(seq_len.max())
    q = rows_gather_plain(text, s[:, 3], ln[:, 3], count, width, 0xFF).to(torch.int16)
    qmin[:count] = torch.where(ln[:, 3] > 0, q.amin(1) if width else q.sum(1),
                               torch.full_like(qmin[:count], EMPTY_QMIN))
    # ambiguous bases (rows padded with 'A'), and the first record with one
    # past the u16 positions
    amb = _ambiguous(rows_gather_plain(text, s[:, 1], seq_len, count, width, ord("A")))
    info[SCAN_AMBIG] = amb.sum()
    if width > V2_NPOS_LIMIT:
        over = torch.nonzero(amb[:, V2_NPOS_LIMIT:].any(1)).squeeze(1)
        if over.numel():
            info[SCAN_OVERFLOW_ROW] = over[0]
    return offsets, qmin, info


# ---------------------------------------------------------------------------
# 2. row gather (fq_gather_rows)
# ---------------------------------------------------------------------------


def rows_gather_plain(
    data: torch.Tensor,
    starts: torch.Tensor | None,
    lens: torch.Tensor,
    rows: int,
    width: int,
    fill: int,
    quarter: tuple[torch.Tensor, int] | None = None,
):
    """(rows, width) uint8: row i < len(lens) is ``data[starts[i] :
    starts[i] + lens[i]]``, cut at ``width``, then ``fill``; rows past
    len(lens) are all ``fill``, and so is every byte past the end of
    ``data``. ``starts=None`` means the runs lie back to back from 0 (the
    exclusive prefix sum of ``lens``). ``quarter=(data2, width2)`` (back to
    back only) also gathers the runs of ``(lens + 3) >> 2`` bytes of
    ``data2`` into a (rows, width2) matrix and returns both."""
    if quarter is not None:
        if starts is not None:
            raise ValueError("rows_gather: a quarter gather takes runs back to back")
        data2, width2 = quarter
        return (rows_gather_plain(data, None, lens, rows, width, fill),
                rows_gather_plain(data2, None, (lens.to(_I64) + 3) >> 2, rows, width2, fill))
    r = lens.numel()
    out = torch.full((rows, width), fill, dtype=torch.uint8, device=data.device)
    n = data.numel()
    if r == 0 or width == 0 or n == 0:
        return out
    lens = lens.to(_I64)
    starts = _excl(lens)[:-1] if starts is None else starts.to(_I64)
    col = torch.arange(width, dtype=_I64, device=data.device)
    src = starts[:, None] + col[None, :]
    ok = (col[None, :] < lens.clamp(0, width)[:, None]) & (src >= 0) & (src < n)
    out[:r] = torch.where(ok, data[src.clamp_(0, n - 1)], fill)
    return out


# ---------------------------------------------------------------------------
# 3. v1/v2 stream build (fq_build_streams, fq_build_len16, fq_build_npos)
# ---------------------------------------------------------------------------


def stream_sizes(info, wide: bool) -> list[int]:
    """Bytes of the six raw streams (seq, qual, headers, plus, npos,
    lengths) of a scanned block, from its scan ``info``."""
    n = int(info[SCAN_COUNT])
    unit = 4 if wide else 2
    return [
        int(info[SCAN_PACKED_SUM]),
        int(info[SCAN_SEQ_SUM]),
        2 * n + int(info[SCAN_HDR_SUM]),
        2 * n + int(info[SCAN_PLUS_SUM]),
        unit * (n + int(info[SCAN_AMBIG])),
        4 * n,
    ]


def _put(out: torch.Tensor, at: torch.Tensor, values: torch.Tensor, unit: int) -> None:
    """Write ``values`` as little-endian ``unit``-byte integers at byte
    offsets ``at``."""
    v = values.to(_I64)
    for k in range(unit):
        out[at + k] = ((v >> (8 * k)) & 0xFF).to(torch.uint8)


def streams_build_plain(
    text: torch.Tensor,
    offsets: torch.Tensor,
    packed: torch.Tensor,
    qual_delta: torch.Tensor,
    nmask: torch.Tensor,
    n_counts: torch.Tensor,
    wide: bool,
    sizes: list[int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """The six raw streams of ``n = len(offsets)`` records in one uint8
    buffer, back to back in wire order (seq, qual, headers, plus, npos,
    lengths) at the byte ``sizes`` of :func:`stream_sizes`: packed rows cut
    to ``(len + 3) // 4``, quality deltas cut to ``len``, header and plus
    payloads from ``text`` each after a u16 length, per record the N count
    and the positions of ``nmask``'s bits (u16, or u32 with ``wide``), and
    the lengths as u32. Rows of the dense outputs past ``n`` are ignored.
    Returns ``(buffer, info)``, ``info`` (2,) int64: the npos and seq bytes
    written, which equal ``sizes[4]`` and ``sizes[0]`` when the scan and the
    encode agree."""
    dev = text.device
    n = offsets.shape[0]
    out = torch.zeros(sum(sizes), dtype=torch.uint8, device=dev)
    base = [0]
    for s in sizes[:-1]:
        base.append(base[-1] + s)
    lens = offsets[:, 3]
    plens = (lens + 3) >> 2
    unit = 4 if wide else 2
    counts = n_counts[:n].to(_I64)
    info = torch.stack([unit * (n + counts.sum()), plens.sum()]).to(_I64)
    if n == 0:
        return out, info
    seg, pos = _segments(torch.zeros_like(plens), plens)
    out[base[0] + torch.arange(seg.numel(), device=dev)] = packed[:n][seg, pos]
    seg, pos = _segments(torch.zeros_like(lens), lens)
    out[base[1] + torch.arange(seg.numel(), device=dev)] = qual_delta[:n][seg, pos]
    for b, col in ((base[2], 0), (base[3], 4)):
        ln = offsets[:, col + 1]
        at = b + _excl(2 + ln)[:-1]
        _put(out, at, ln, 2)
        seg, src = _segments(offsets[:, col], ln)
        out[at[seg] + 2 + (src - offsets[:, col][seg])] = text[src]
    at_count = base[4] + unit * (torch.arange(n, device=dev) + _excl(counts)[:-1])
    _put(out, at_count, counts, unit)
    width = qual_delta.shape[1]
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)
    bits = ((nmask[:n, :, None] >> shifts) & 1).reshape(n, -1)[:, :width].bool()
    rows, cols = torch.nonzero(bits, as_tuple=True)
    rank = torch.arange(rows.numel(), device=dev) - _excl(counts)[:-1][rows]
    _put(out, at_count[rows] + unit * (1 + rank), cols, unit)
    _put(out, base[5] + 4 * torch.arange(n, device=dev), lens, 4)
    return out, info


# ---------------------------------------------------------------------------
# 4. FASTQ assembly (fq_decode_block_full, fq_assemble, fq_parse_len16,
#    fq_parse_npos / fq_parse_npos32)
# ---------------------------------------------------------------------------


def chain_values(data: torch.Tensor, unit: int, w: int, n_units: int, p: torch.Tensor) -> torch.Tensor:
    """The prefix value at node ``p`` of a chain (0 where it does not fit):
    a u16 over bytes p, p + 1 (``unit`` 1, ``w`` 2), or the ``unit``-byte
    integer at unit p (``w`` 1)."""
    ok = (p >= 0) & (p + w <= n_units)
    q = torch.where(ok, p, torch.zeros_like(p))
    if unit == 1:
        b = data.to(_I64)
        if b.numel() < 2:
            return torch.zeros_like(p)
        v = b[q] | (b[(q + 1).clamp(max=b.numel() - 1)] << 8)
    else:
        b = data[: n_units * unit].to(_I64).view(-1, unit) if n_units else None
        if b is None:
            return torch.zeros_like(p)
        v = torch.zeros_like(p)
        for k in range(unit):
            v |= b[q.clamp(max=n_units - 1), k] << (8 * k)
    return torch.where(ok, v, torch.zeros_like(v))


def chain_starts(data: torch.Tensor, unit: int, w: int, n_units: int, r: int) -> torch.Tensor:
    """Nodes s_0 .. s_r of a length-prefixed chain (s_0 = 0, s_(i+1) =
    s_i + w + value(s_i)), every step checked against ``n_units``: a step
    that leaves the stream goes to the absorbing node n_units + 1, so the
    chain is truncated iff s_r == n_units + 1. Pointer doubling: log2(r)
    rounds over the n_units + 2 nodes; the kernel reaches the same nodes by
    tiles of the stream (``csrc/records.cu`` ``chain_kernel``)."""
    dev = data.device
    if r > 0 and n_units >= w * r and (n_units - w * r) % r == 0:
        # every record of one length (the fixed-width header): the kernel's
        # check kernel, s_i = i * stride
        stride = w + (n_units - w * r) // r
        at = torch.arange(r + 1, dtype=_I64, device=dev) * stride
        if bool((chain_values(data, unit, w, n_units, at[:r]) == stride - w).all()):
            return at
    p = torch.arange(n_units + 2, dtype=_I64, device=dev)
    nxt = p + w + chain_values(data, unit, w, n_units, p)
    trunc = n_units + 1
    nxt = torch.where((p + w <= n_units) & (nxt <= n_units), nxt, torch.full_like(nxt, trunc))
    idx = torch.arange(r + 1, dtype=_I64, device=dev)
    cur = torch.zeros(r + 1, dtype=_I64, device=dev)
    jump = nxt
    for k in range(max(r, 1).bit_length()):
        sel = ((idx >> k) & 1).bool()
        cur[sel] = jump[cur[sel]]
        jump = jump[jump]
    return cur


def assemble_capacity(r: int, hdr_n: int, plus_n: int, qual_n: int, has_plus: bool) -> int:
    """Bytes that hold a block's FASTQ text when its streams are whole:
    6 + header + plus + 2 * length per record, with the payloads bounded by
    their streams less the u16 prefixes and the lengths by the quality
    stream."""
    return max(0, (2 * r + plus_n if has_plus else 4 * r) + hdr_n + 2 * qual_n)


def fastq_assemble_plain(
    seq_rows: torch.Tensor,
    qual_rows: torch.Tensor,
    lengths: torch.Tensor,
    headers: torch.Tensor,
    plus: torch.Tensor | None,
    npos: torch.Tensor,
    wide: bool,
    len_n: int,
    seq_n: int,
    qual_n: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``@hdr\\nseq\\n+plus\\nqual\\n`` per record into a buffer of
    :func:`assemble_capacity` bytes: the header, plus and npos chains
    resolved, N restored at each recorded position, bases and qualities from
    the dense decode's (r, L) rows; ``plus=None`` writes a bare '+' (v1).
    ``len_n``, ``seq_n`` and ``qual_n`` are the byte sizes of the lengths,
    sequence and quality streams. Returns ``(buffer, info)``, ``info`` (2,)
    int64: the text's bytes and the fault flags (bit k set for
    :data:`ASSEMBLE_FAULTS` [k]; the N positions are checked for one past
    the read whenever the lengths, sequence, quality and N position streams
    are whole, as the decoder checks them before the header and plus
    streams); with any fault but an invalid N position nothing is written."""
    dev = seq_rows.device
    r = lengths.numel()
    has_plus = plus is not None
    cap = assemble_capacity(r, headers.numel(), plus.numel() if has_plus else 0, qual_n, has_plus)
    out = torch.zeros(cap, dtype=torch.uint8, device=dev)
    lengths = lengths.to(_I64)
    hn = headers.numel()
    hs = chain_starts(headers, 1, 2, hn, r)
    hl = chain_values(headers, 1, 2, hn, hs[:r])
    if has_plus:
        pn = plus.numel()
        ps = chain_starts(plus, 1, 2, pn, r)
        pl = chain_values(plus, 1, 2, pn, ps[:r])
    else:
        pl = torch.zeros(r, dtype=_I64, device=dev)
    unit = 4 if wide else 2
    nn = npos.numel() // unit
    ns = chain_starts(npos, unit, 1, nn, r)
    flags = 0
    flags |= int(len_n < 4 * r) << 0
    flags |= int(int(((lengths + 3) >> 2).sum()) > seq_n) << 1
    flags |= int(int(lengths.sum()) > qual_n) << 2
    flags |= int(bool(ns[r] == nn + 1) or (not wide and npos.numel() % 2 == 1)) << 3
    flags |= int(bool(hs[r] == hn + 1)) << 5
    if has_plus:
        flags |= int(bool(ps[r] == pn + 1)) << 6
    size = 6 + hl + pl + 2 * lengths
    offs = _excl(size)
    total = int(offs[-1])
    if not flags & (FAULT_INVALID_NPOS - 1):
        # the N positions are whole: the decoder checks them before it walks
        # the header and plus streams
        counts = chain_values(npos, unit, 1, nn, ns[:r])
        n_rec, unit_at = _segments(ns[:r] + 1, counts)
        n_pos = chain_values(npos, unit, 1, nn, unit_at)
        bad = n_pos >= lengths[n_rec]
        if bool(bad.any()):
            flags |= FAULT_INVALID_NPOS
        good = ~bad
    if flags & ~FAULT_INVALID_NPOS:
        return out, torch.tensor([total, flags], dtype=_I64, device=dev)
    o = offs[:-1]
    out[o] = ord("@")
    seg, src = _segments(hs[:r] + 2, hl)
    out[o[seg] + 1 + (src - hs[:r][seg] - 2)] = headers[src]
    seq_at = o + 2 + hl
    out[seq_at - 1] = _NL
    seg, col = _segments(torch.zeros_like(lengths), lengths)
    out[seq_at[seg] + col] = seq_rows[seg, col]
    plus_at = seq_at + lengths + 1
    out[plus_at - 1] = _NL
    out[plus_at] = ord("+")
    if has_plus:
        seg, src = _segments(ps[:r] + 2, pl)
        out[plus_at[seg] + 1 + (src - ps[:r][seg] - 2)] = plus[src]
    qual_at = plus_at + pl + 2
    out[qual_at - 1] = _NL
    seg, col = _segments(torch.zeros_like(lengths), lengths)
    out[qual_at[seg] + col] = qual_rows[seg, col]
    out[qual_at + lengths] = _NL
    out[seq_at[n_rec[good]] + n_pos[good]] = ord("N")
    return out, torch.tensor([total, flags], dtype=_I64, device=dev)


def fault_message(flags: int) -> tuple[int, str] | None:
    """The first fault of ``flags`` in the decoder's order, as (bit, string)."""
    for bit, msg in enumerate(ASSEMBLE_FAULTS):
        if flags >> bit & 1:
            return bit, msg
    return None
