"""Seeded inputs for the byte histogram and the header tokenizer
(``test_torch_hist256.py`` and ``test_torch_tokens.py`` on the CPU,
``test_torch_cuda.py`` and ``chip_smoke.py``'s ``phase=tokens`` on the card).

:func:`hist_edge_cases`: streams of 0, 1, 15, 16 and 17 bytes, views that
start at each of the offsets 1-15 of a buffer, one-symbol and 256-symbol
streams, and streams that span several CTAs; cut to the kernel's grid: two
bytes in turn (every byte a new run, every lane on two slots), the walk
model's quality steps (72% zeros in short runs), uniform bytes, and lengths
of one wave (a unit a thread of a full grid on an H100's 132 SMs: one step of
the grid's loop) and of the shortest stream that fills the grid (kMinUnits
waves) less or more one, at offsets 0 and 9.

:func:`header_edge_cases`: header lists (each record's name without '@'):
no record, empty headers, tokens of 18 and 19 digits, leading zeros
(DELTA_PAD), a token count that changes between records, record counts
around the kernels' tiles of 128 records, headers across the chain's tiles
of 8,192 bytes, the longest header, and the three corpora (SIM names,
Illumina names of random width, names in instrument order). Cut to the
kernels' tiling: columns of MATCH / DELTA / DELTA_PAD through five record
tiles back to one literal, token counts that change on a tile's first and
last record, records of more tokens than a tile stages at a time (24
columns), 18-digit values that swing by ~10^18 from record to record, and
literals longer than the chain's window (64 bytes) across its tiles.

:func:`decode_fault_cases`: tokenized streams that the plain decoder
refuses, one or more for each of its nine strings, and streams whose bytes
after the last record would fault but are never read; and, across record
tiles, two faults in different tiles (the first in stream order wins),
faults deep in a column, a value past 2^64 matched down five tiles, and a
count below the chain's records.
"""

import numpy as np

from fastqpacker_tpu_torch.utils import synth

OP_END, OP_MATCH, OP_DELTA, OP_PAD, OP_LIT = 0, 1, 2, 3, 4
ENCODE_TILE_RECORDS = 256  # csrc/tokens.cu kEncRecords
TILE_RECORDS = 128  # csrc/tokens.cu kTokRecords: the resolve's and write's tiles
TILE_COLUMNS = 24  # kTokCols: the columns a resolve tile stages at a time
CHAIN_TILE = 8192  # kChainTile
CHAIN_WINDOW = 64  # kWindow: the candidate entries a chain tile publishes
HIST_THREADS = 512  # csrc/hist256.cu kThreads: a CTA's threads
HIST_CTAS_PER_SM = 2  # kCtasPerSm: the CTAs of a full wave, an SM
HIST_MIN_UNITS = 4  # kMinUnits: units a thread takes before the grid adds a CTA
HIST_FLUSH_UNITS = 4000  # kFlushUnits: units a column (every warp of a CTA) counts between flushes
H100_SMS = 132


def hist_flush_bytes(sms: int) -> int:
    """Bytes past which every thread of a full wave on ``sms`` SMs has
    flushed its column at least once (two units a thread more)."""
    per_thread = HIST_FLUSH_UNITS // (HIST_THREADS // 32)
    threads = sms * HIST_CTAS_PER_SM * HIST_THREADS
    return threads * 16 * (per_thread + 2) + 21


def varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def zigzag(v: int) -> int:
    return 2 * v if v >= 0 else -2 * v - 1


def stream_of(headers) -> bytes:
    """The u16-length-prefixed header stream of ``headers``."""
    return b"".join(len(h).to_bytes(2, "little") + h for h in headers)


def headers_of(fastq: bytes) -> list:
    """The header lines of a FASTQ text, '@' stripped."""
    return [line[1:] for line in fastq.split(b"\n")[0::4] if line]


def hist_edge_cases() -> dict:
    """name -> (buffer bytes, view offset, view length)."""
    rng = np.random.default_rng(41)
    buf = rng.integers(0, 256, size=(1 << 20) + 64, dtype=np.uint8).tobytes()
    cases = {}
    for n in (0, 1, 15, 16, 17, 4095, 65537, (1 << 20) + 3):
        cases[f"len{n}"] = (buf, 0, n)
    for off in range(1, 16):
        cases[f"off{off}_len1000"] = (buf, off, 1000)
    for off in (1, 7, 15):
        cases[f"off{off}_len300001"] = (buf, off, 300_001)
        cases[f"off{off}_len14"] = (buf, off, 14)
    cases["one_symbol"] = (bytes([7]) * 200_003, 0, 200_003)
    cases["one_symbol_off3"] = (bytes([0]) * 100_000, 3, 99_990)
    cases["all_256"] = (bytes(range(256)) * 1000, 5, 255_990)
    # quality deltas: nearly all one symbol, a few others
    skew = rng.choice(np.array([0, 1, 255, 2, 254], np.uint8), p=[0.9, 0.04, 0.04, 0.01, 0.01],
                      size=500_009).astype(np.uint8).tobytes()
    cases["skewed_off9"] = (skew, 9, 500_000)
    cases["alternating_two"] = (bytes([3, 200]) * 150_001, 0, 300_002)
    walk = synth.walk_steps(rng, 600_011).view(np.uint8).tobytes()
    cases["walk_deltas_off5"] = (walk, 5, 600_000)
    wave = H100_SMS * HIST_CTAS_PER_SM * HIST_THREADS * 16
    full = wave * HIST_MIN_UNITS
    big = rng.integers(0, 256, size=full + 32, dtype=np.uint8).tobytes()
    cases["uniform_off11"] = (big, 11, 2_000_003)
    for name, n in (("wave", wave), ("full_grid", full)):
        for d in (-1, 0, 1):
            for off in (0, 9):
                cases[f"{name}{d:+d}_off{off}"] = (big, off, n + d)
    return cases


def header_edge_cases() -> dict:
    """name -> list of headers (bytes)."""
    rng = np.random.default_rng(43)
    cases = {
        "count0": [],
        "one_empty": [b""],
        "empty_headers": [b"", b"", b""],
        "empty_between": [b"r:1", b"", b"r:2", b""],
        "no_digits": [b"plain text no digits"] * 3,
        "all_match": [b"a1b2c3"] * 5,
        "plus_one": [b"read.%d" % i for i in range(1, 40)],
        "pad": [b"read.%04d" % i for i in range(990, 1010)],
        "pad_to_plain": [b"x.0001", b"x.10002", b"x.0003", b"x.7", b"x.007"],
        "natural_growth": [b"x.9", b"x.10", b"x.99", b"x.100", b"x.9"],
        "digits18": [b"id " + b"9" * 18 + b" x", b"id " + b"1" * 18 + b" x",
                     b"id " + b"0" * 18 + b" x"],
        "digits19": [b"id " + b"9" * 19 + b" x", b"id " + b"9" * 18 + b"8 x",
                     b"id " + b"1" * 19 + b" x"],
        "digits18_19": [b"a" + b"5" * 18, b"a" + b"5" * 19, b"a" + b"4" * 18],
        "leading_zeros": [b"007", b"7", b"0", b"00", b"000", b"0100", b"0099"],
        "token_count_changes": [b"a:1:2", b"a:1", b"a:1:2:3", b"", b"b", b"a:1:2:3:4:5"],
        "binary": [b"\xff\xfe binary \x00 bytes 7", b"\xff\xfe binary \x00 bytes 8"],
        "one_digit_runs": [bytes([0x30 + (i % 10)]) * 3 for i in range(30)],
        "negative_deltas": [b"t:%d" % (10**17 - 7 * i) for i in range(50)],
        "longest": [b"h" * 65535, b"h" * 65534 + b"1", b"1" + b"h" * 65534],
    }
    for n in (15, 16, 17, 127, 128, 129, 255, 256, 257, 513):
        cases[f"records{n}"] = [b"A1:%d:%d" % (i // 7, i) for i in range(n)]
    r = TILE_RECORDS
    cases["columns_5_tiles"] = [b"run7:A:%d:%06d x" % (1000 + 3 * i, 2 * i)
                                for i in range(5 * r + 3)]
    heads = []
    for i in range(4 * r + 1):
        j = i % r
        heads.append(b"a:%d:%d:x" % (i, i) if j == 0 else b"a:%d" % i if j == r - 1
                     else b"a" if j == 1 else b"a:%d:q" % i)
    cases["token_counts_at_tile_edges"] = heads
    # 79 and 160 tokens a record: several chunks of TILE_COLUMNS columns
    cases["wide_records"] = [b":".join(b"%d" % (i + j) for j in range(40))
                             for i in range(2 * r + 5)]
    cases["wider_records"] = [b"-".join(b"f%d" % ((i * j) % 97) for j in range(80))
                              for i in range(r + 7)]
    cases["digits18_swing"] = [
        b"v" + (b"9" * 18 if i % 2 else b"1" + b"0" * 17) + b".%018d" % (i * 7919 * 10**9)
        for i in range(3 * r)]
    letters = rng.integers(ord("a"), ord("z") + 1, size=(320, 200), dtype=np.uint8)
    cases["long_literals_across_chain_tiles"] = [b"ID_" + bytes(row) for row in letters]
    # headers across the chain's tiles: records of ~3-20 KB
    lens = rng.integers(3000, 20000, size=12)
    cases["chain_tiles"] = [b"x" * int(k - 6) + b":%05d" % i for i, k in enumerate(lens)]
    for name, fn in (("sim", synth.synth_fastq), ("illumina", synth.illumina_fastq),
                     ("ordered", synth.ordered_illumina_fastq)):
        if fn is synth.synth_fastq:
            text = fn(0.05, seed=3)
        else:
            text = fn(600, seed=3)
        cases[f"corpus_{name}"] = headers_of(text)
    return cases


def _lit(b: bytes) -> bytes:
    return bytes([OP_LIT]) + varint(len(b)) + b


def _tok(records, total=None) -> bytes:
    """A tokenized stream of op lists (each record's ops, OP_END added);
    ``total`` the declared size (default: computed by the caller)."""
    body = b"".join(b"".join(ops) + bytes([OP_END]) for ops in records)
    return varint(0 if total is None else total) + body


def decode_fault_cases() -> dict:
    """name -> (tokenized bytes, count). Each one's plain decode raises (or,
    for the ``ok_`` cases, returns)."""
    d = bytes([OP_DELTA])
    p = bytes([OP_PAD])
    m = bytes([OP_MATCH])
    cases = {
        "varint_total": (b"\x80", 1),
        "varint_total_11_bytes": (b"\xff" * 10 + b"\x01", 1),
        "varint_delta": (varint(8) + _lit(b"5") + bytes([OP_END]) + d + b"\x80", 2),
        "varint_lit": (varint(4) + bytes([OP_LIT]) + b"\xff\xff", 1),
        "varint_delta_10th_continues": (
            varint(8) + _lit(b"5") + bytes([OP_END]) + d + b"\xff" * 10 + b"\x00", 2),
        "trunc_no_ops": (varint(3), 1),
        "trunc_no_end": (varint(3) + _lit(b"a"), 1),
        "trunc_lit": (varint(3) + bytes([OP_LIT]) + varint(50) + b"abc", 1),
        "trunc_records": (_tok([[_lit(b"a")], [m]], 6), 3),
        "match_first": (_tok([[m]], 2), 1),
        "match_past_pred": (_tok([[_lit(b"a")], [m, m]], 6), 2),
        "delta_first": (_tok([[d + varint(2)]], 2), 1),
        "delta_non_numeric": (_tok([[_lit(b"ab")], [d + varint(2)]], 6), 2),
        "delta_19_digits": (_tok([[_lit(b"1" * 19)], [d + varint(2)]], 42), 2),
        "delta_empty_pred": (_tok([[_lit(b"")], [d + varint(2)]], 4), 2),
        "delta_past_pred": (_tok([[_lit(b"1")], [m, d + varint(2)]], 6), 2),
        "negative": (_tok([[_lit(b"5")], [d + varint(zigzag(-10))]], 6), 2),
        "negative_after_chain": (
            _tok([[_lit(b"100")]] + [[d + varint(zigzag(-30))]] * 5, 20), 6),
        "wider": (_tok([[_lit(b"05")], [p + varint(zigzag(200))]], 8), 2),
        "wider_after_chain": (
            _tok([[_lit(b"0001")]] + [[p + varint(zigzag(4000))]] * 3, 24), 4),
        "unknown_op": (_tok([[b"\x09"]], 2), 1),
        "unknown_op_255": (_tok([[_lit(b"a")], [b"\xff"]], 6), 2),
        "header_too_long": (_tok([[_lit(b"h" * 40000)], [m, _lit(b"g" * 30000)]], 110004), 2),
        "size_mismatch": (_tok([[_lit(b"abc")]], 4), 1),
        "size_mismatch_huge_total": (varint(1 << 62) + _lit(b"abc") + bytes([OP_END]), 1),
        "size_mismatch_count0": (varint(7), 0),
        "first_of_two_faults": (_tok([[_lit(b"ab")], [d + varint(2), b"\x09"]], 6), 2),
        "ok_fault_after_last_record": (_tok([[_lit(b"ab")]], 4) + b"\x09\x80", 1),
        "delta_2_70": (
            _tok([[_lit(b"7")], [d + b"\xfe" + b"\xff" * 8 + b"\x7f"],
                  [d + varint(2)]], 0), 3),
        "ok_delta_2_70": (
            _tok([[_lit(b"7")], [d + b"\xfe" + b"\xff" * 8 + b"\x7f"]],
                 3 + 2 + len(str(7 + (((1 << 70) - 2) >> 1)))), 2),
        "ok_trailing_garbage": (_tok([[_lit(b"ab")]], 4) + b"\x09\x80\xff", 1),
        "ok_count0": (varint(0) + b"\x09", 0),
    }
    # across the record tiles: "id:5", "id:6", ... (a MATCH and a DELTA a
    # record), with faults put in
    r = TILE_RECORDS
    one = d + varint(zigzag(1))

    def column(count, bad=None):
        recs = [[_lit(b"id:"), _lit(b"5")]] + [[m, one] for _ in range(count - 1)]
        for k, ops in (bad or {}).items():
            recs[k] = ops
        return _tok(recs)

    cases["two_faults_in_two_tiles"] = (column(3 * r, {r + 12: [m, m, m], 2 * r + 44: [m, b"\x09"]}),
                                        3 * r)
    cases["two_faults_in_two_tiles_other_codes"] = (
        column(3 * r, {r + 12: [m, b"\x0a"], 2 * r + 44: [m, d + varint(zigzag(-10**6))]}), 3 * r)
    cases["long_header_then_op_fault"] = (
        _tok([[_lit(b"h" * 40000)], [m, _lit(b"g" * 30000)]] + [[m]] * (2 * r) + [[b"\x09"]]),
        2 * r + 3)
    cases["negative_deep_in_a_column"] = (
        _tok([[_lit(b"1000")]] + [[d + varint(zigzag(-1))]] * 1001), 1002)
    cases["wider_deep_in_a_column"] = (
        _tok([[_lit(b"0000")]] + [[p + varint(zigzag(7))]] * 1500), 1501)
    cases["trunc_records_over_tiles"] = (_tok([[_lit(b"a")]] + [[m]] * (3 * r - 1)), 3 * r + 7)
    big = d + b"\xfe" + b"\xff" * 8 + b"\x7f"  # + (2^70 - 2) / 2
    wide = len(str(7 + (((1 << 70) - 2) >> 1)))
    cases["ok_value_past_2_64_down_5_tiles"] = (
        _tok([[_lit(b"7")], [big]] + [[m]] * (5 * r), 3 + (5 * r + 1) * (2 + wide)), 5 * r + 2)
    cases["value_past_2_64_then_delta"] = (
        _tok([[_lit(b"7")], [big]] + [[m]] * (5 * r) + [[one]]), 5 * r + 3)
    # count below the chain's records: the rest is never read, a fault there
    # neither
    heads = [b"id:%d" % (5 + i) for i in range(5 * r)]
    body = column(5 * r, {4 * r + 9: [b"\x09"]})[1:]  # no varint(0)
    cases["ok_count_below_the_chain"] = (varint(len(stream_of(heads[: 3 * r + 1]))) + body,
                                         3 * r + 1)
    return cases
