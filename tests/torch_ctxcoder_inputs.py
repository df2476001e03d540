"""Seeded inputs of the context coders' tests (``csrc/ctxcoder.cu``): the
JAX coder tests' cases (``tests/test_qualctx.py:41``,
``tests/test_seqctx.py:37``) plus chunks with no record, one-symbol
streams and the card decodes' tile edges (``TILE_CASES``), and payloads with
each decode fault (``tile_fault_payloads``: one at a tile's last symbol).
numpy and the port only (the
``cuda`` tests and ``chip_smoke.py`` import it without JAX); the faulty
payloads are cut from the port's CPU encodes, which
``tests/test_torch_ctxcoder.py`` holds equal to the JAX package's."""

from __future__ import annotations

import inspect
import struct

import numpy as np

from fastqpacker_tpu_torch.entropy import zstd
from fastqpacker_tpu_torch.ops import ctxcoder, qualctx, seqctx


def walk(rng, lengths, lo=2, hi=41):
    steps = rng.integers(-2, 3, int(lengths.sum()))
    return np.clip(np.cumsum(steps) + 30, lo, hi).astype(np.uint8)


def record_walk(rng, lengths, lo=2, hi=41):
    """A Phred walk from 30 in each record (the mesh corpus's qualities):
    the symbols of a long stream stay spread, so its words stay dense."""
    lengths = np.asarray(lengths, np.int64)
    steps = rng.integers(-2, 3, int(lengths.sum()))
    run = np.cumsum(steps)
    starts = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    nz = lengths > 0
    base = np.repeat(np.concatenate(([0], run))[starts[nz]], lengths[nz])
    return np.clip(run - base + 30, lo, hi).astype(np.uint8)


def binned(rng, lengths):
    """Illumina RTA3-style levels 2 / 12 / 23 / 37 with sticky runs: far
    fewer words than symbols (the decode's word bound)."""
    total = int(lengths.sum())
    levels = np.array([2, 12, 23, 37], np.uint8)
    state = rng.integers(0, 4, total)
    sticky = rng.random(total) < 0.9
    idx = np.arange(total)
    idx[sticky] = 0
    np.maximum.accumulate(idx, out=idx)  # each sticky symbol takes the last fresh one's
    return levels[state[idx]]


def markov(rng, nrec, length, sticky=0.6):
    cur = rng.integers(0, 4, nrec)
    m = np.empty((nrec, length), np.uint8)
    for p in range(length):
        stay = rng.random(nrec) < sticky
        cur = np.where(stay, cur, rng.integers(0, 4, nrec))
        m[:, p] = cur
    return m.reshape(-1)


def tile_edge_lengths() -> np.ndarray:
    """Records of 128 symbols with three zero-length records after every
    eighth: every 1,024 symbols of each chunk (32,768 symbols, chunks of
    8,192 starting at a multiple of 1,024) a tile of the card's decodes ends
    on a record end followed by empty records."""
    block = np.concatenate([np.full(8, 128), np.zeros(3)]).astype(np.int64)
    return np.tile(block, 32)


# the card's decodes cut a chunk into tiles (qctx: the dense layout's 4,096 or
# 1,024 symbols at the walk qualities; sctx: 4,096): records of 151 straddle
# every tile edge, four records of 100 give chunks shorter than a tile
TILE_CASES = {
    "tile-straddle": np.full(330, 151, np.int64),
    "short-chunks": np.full(4, 100, np.int64),
    "empties-at-tile-edges": tile_edge_lengths(),
}

QCTX_CASES = {
    "empty": (np.zeros(0, np.int64), None),
    "all-zero-lengths": (np.zeros(7, np.int64), None),
    "single-record": (np.array([151], np.int64), "walk"),
    "varlen": (None, "walk"),
    "varlen-binned": (None, "binned"),
    "uniform-random": (None, "uniform"),
    "two-records": (np.array([40, 9], np.int64), "walk"),
    "three-records-and-empties": (np.array([0, 30, 0, 12, 25, 0], np.int64), "walk"),
    "one-symbol": (np.array([1], np.int64), "walk"),
    **{name: (lengths, "record-walk") for name, lengths in TILE_CASES.items()},
}


def qctx_case(name: str):
    """-> (raw qualities, lengths, the delta stream's bytes)."""
    lengths, kind = QCTX_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if lengths is None:
        lengths = rng.integers(0, 200, size=333).astype(np.int64)
    if kind == "uniform":
        raw = rng.integers(0, 94, int(lengths.sum())).astype(np.uint8)
    elif kind == "binned":
        raw = binned(rng, lengths)
    elif kind == "walk":
        raw = walk(rng, lengths)
    elif kind == "record-walk":
        raw = record_walk(rng, lengths)
    else:
        raw = np.zeros(0, np.uint8)
    return raw, lengths, qualctx.deintegrate(raw, lengths)


def sctx_cases() -> dict:
    """name -> (bases, lengths, packed rows' bytes)."""
    rng = np.random.default_rng(42)
    varlens = rng.integers(0, 90, 100).astype(np.int64)
    cases = {
        "three-records": ([7, 3, 4], rng.integers(0, 4, 14)),
        "empties": ([0, 5, 0, 1], rng.integers(0, 4, 6)),
        "markov-40x151": ([151] * 40, markov(rng, 40, 151)),
        "varlen": (varlens, rng.integers(0, 4, int(varlens.sum()))),
        "one-record": ([37], markov(rng, 1, 37)),
        "two-records": ([20, 0, 9], rng.integers(0, 4, 29)),
        "one-base": ([1], np.array([2])),
    }
    for name, lengths in TILE_CASES.items():
        cases[name] = (lengths, markov(rng, 1, int(lengths.sum())))
    out = {}
    for name, (lengths, bases) in cases.items():
        lengths = np.asarray(lengths, np.int64)
        bases = np.asarray(bases, np.uint8)
        out[name] = (bases, lengths, seqctx.pack_stream(bases, lengths).tobytes())
    return out


def split_payload(payload: bytes):
    """(the header and table blob, each chunk's 16 state bytes, each chunk's
    word run's bytes)."""
    blob_size = struct.unpack_from("<I", payload, 8)[0]
    off = 12 + blob_size
    head = payload[:off]
    states, counts = [], []
    for _ in range(4):
        states.append(payload[off : off + 16])
        counts.append(struct.unpack_from("<I", payload, off + 16)[0])
        off += 20
    runs = []
    for nw in counts:
        runs.append(payload[off : off + 2 * nw])
        off += 2 * nw
    return head, states, runs


def join_payload(head: bytes, states, runs) -> bytes:
    out = bytearray(head)
    for st, run in zip(states, runs):
        out += st + struct.pack("<I", len(run) // 2)
    for run in runs:
        out += run
    return bytes(out)


def _with_blob(head: bytes, blob: bytes) -> bytes:
    return head[:8] + struct.pack("<I", len(blob)) + blob


def qctx_fault_payloads() -> tuple[dict, np.ndarray]:
    """name -> payload of the "varlen" case's stream with a chunk that runs
    out of words, a word left over, faults in two chunks at once, a used
    context row emptied in the table blob; and the lengths."""
    raw, lengths, delta = qctx_case("varlen")
    payload = qualctx.encode(delta, lengths, device="cpu")
    head, states, runs = split_payload(payload)
    out = {
        "chunk 1 runs out of words": join_payload(head, states, [runs[0], runs[1][:-2], *runs[2:]]),
        "chunk 2 has a word left over": join_payload(
            head, states, [*runs[:2], runs[2] + b"\x34\x12", runs[3]]),
        "chunk 3 short, chunk 1 long": join_payload(
            head, states, [runs[0], runs[1] + b"\x00\x00", runs[2], runs[3][:-2]]),
    }
    model = payload[5]
    nctx = qualctx.NUM_CTX2 if model else qualctx.NUM_CTX
    freq = qualctx.deserialize_tables(zstd.get_codec().decompress(head[12:]), nctx)
    ctx = qualctx.contexts(raw, lengths, model)
    first = int(np.flatnonzero(lengths)[0])
    freq[ctx[int(lengths[:first].sum()) + 1]] = 0  # the first record's second symbol's
    blob = zstd.get_codec().compress(qualctx.serialize_tables(freq))
    out["an empty context row"] = join_payload(_with_blob(head, blob), states, runs)
    return out, lengths


def sctx_fault_payloads() -> tuple[dict, np.ndarray]:
    """As :func:`qctx_fault_payloads` for the "markov-40x151" bases, the
    zeroed row the context of every record's first base."""
    _, lengths, packed = sctx_cases()["markov-40x151"]
    payload = seqctx.encode(packed, lengths, device="cpu")
    head, states, runs = split_payload(payload)
    out = {
        "chunk 0 runs out of words": join_payload(head, states, [runs[0][:-2], *runs[1:]]),
        "chunk 3 has a word left over": join_payload(head, states, [*runs[:3], runs[3] + b"\0\0"]),
        "chunk 2 short, chunk 1 long": join_payload(
            head, states, [runs[0], runs[1] + b"\0\0", runs[2][:-2], runs[3]]),
    }
    order = payload[4]
    freq = seqctx.deserialize_tables(zstd.get_codec().decompress(head[12:]), order).copy()
    freq[0] = 0
    blob = zstd.get_codec().compress(seqctx.serialize_tables(freq))
    out["an empty context row"] = join_payload(_with_blob(head, blob), states, runs)
    return out, lengths


def decode_tile(stream: str, freq: np.ndarray, arg: int) -> int:
    """The symbols a tile of the card's decode of a table: sctx a constant,
    qctx the dense layout's (0 on the L2 route, which has no tiles)."""
    if stream == "sctx":
        return seqctx.DECODE_TILE
    layout = qualctx.dense_layout(qualctx.table_alphabet(freq), arg)
    return 0 if layout is None else layout.tile


def tile_last_renorms(stream: str, inp: dict, flags: np.ndarray) -> list:
    """(chunk, symbol) of every tile's last symbol that takes a renorm word
    in the decode (the encode flagged a word there), for the table of
    :func:`coder_inputs` ``inp`` and its encode's ``flags``."""
    tile = decode_tile(stream, inp["freq"], inp["arg"])
    if not tile:
        return []
    sb = inp["plan"].numpy()[ctxcoder.PLAN_SB : ctxcoder.PLAN_SB + 5]
    return [(k, j) for k in range(4) for j in range(int(sb[k]) + tile - 1, int(sb[k + 1]), tile)
            if flags[j]]


def tile_fault_payloads() -> dict:
    """stream -> (payload, lengths, chunk, symbol): the "tile-straddle"
    case's stream with the first chunk that takes a renorm word at a tile's
    last symbol cut to the words before it: the decode runs out of words at
    that symbol, the last of its tile."""
    out = {}
    for stream in ("qctx", "sctx"):
        if stream == "qctx":
            _, lengths, syms_in = qctx_case("tile-straddle")
        else:
            _, lengths, syms_in = sctx_cases()["tile-straddle"]
        inp = coder_inputs(stream, syms_in, lengths, "cpu")  # the v3 pick's model or order
        flags = coder_encode(stream, inp)[1].numpy()
        k, j = tile_last_renorms(stream, inp, flags)[0]
        sb = inp["plan"].numpy()[ctxcoder.PLAN_SB : ctxcoder.PLAN_SB + 5]
        head, states, runs = split_payload(
            (qualctx if stream == "qctx" else seqctx).encode(syms_in, lengths, device="cpu"))
        runs[k] = runs[k][: 2 * int(flags[int(sb[k]) : j].sum())]
        out[stream] = (join_payload(head, states, runs), lengths, k, j)
    return out


def payload_decode_args(stream: str, payload: bytes, lengths, dev, checks: bool = False):
    """The decode wrapper's arguments on ``dev`` from a payload (its table,
    states and word runs)."""
    import torch

    from fastqpacker_tpu_torch.ops import ctxprep

    lengths = np.asarray(lengths, np.int64)
    head, states, runs = split_payload(payload)
    blob = zstd.get_codec().decompress(head[12:])
    counts = [len(r) // 2 for r in runs]
    plan = ctxcoder.coder_plan(lengths, counts,
                               np.frombuffer(b"".join(states), "<u4").reshape(4, 4))
    words = torch.from_numpy(np.frombuffer(b"".join(runs), np.int16).copy()).to(dev)
    starts = torch.from_numpy(ctxprep.record_bounds(lengths)).to(dev)
    if stream == "qctx":
        model = payload[5]
        freq = qualctx.deserialize_tables(blob, qualctx.NUM_CTX2 if model else qualctx.NUM_CTX)
        fcum = torch.from_numpy(ctxcoder.entry_table(freq).view(np.int32)).to(dev)
        return words, starts, plan, fcum, model, checks, qualctx.table_alphabet(freq)
    order = payload[4]
    freq = seqctx.deserialize_tables(blob, order)
    return words, starts, plan, torch.from_numpy(freq.view(np.int16).copy()).to(dev), order


def block_lengths(records: int, read_len: int = 151) -> np.ndarray:
    return np.full(records, read_len, np.int64)


# ---------------------------------------------------------------------------
# the wrappers' arguments (the cuda tests, chip_smoke.py, scripts/ctxcoder_ab.py)
# ---------------------------------------------------------------------------


def coder_inputs(stream: str, syms_in, lengths, dev, arg=None) -> dict:
    """One stream's encode arguments on ``dev`` (``stream`` "qctx": host
    deltas, "sctx": packed rows): the prepared symbols, the record starts,
    the host plan, the encode table at ``arg`` (the model or order the v3
    pick takes where None), its frequencies and the decode's table."""
    import torch

    from fastqpacker_tpu_torch.ops import ctxprep

    lengths = np.asarray(lengths, np.int64)
    syms_in = np.frombuffer(syms_in, np.uint8) if isinstance(syms_in, bytes) else syms_in
    mod = qualctx if stream == "qctx" else seqctx
    syms, hist = mod.prepare(syms_in, lengths, dev)
    if stream == "qctx":
        arg = qualctx.pick_model(hist)[0] if arg is None else arg
        freq = qualctx.normalize_tables(qualctx.hist_for_model(hist, arg))
        dtab = ctxcoder.entry_table(freq).view(np.int32)
    else:
        arg = seqctx.pick_order(hist)[0] if arg is None else arg
        freq = seqctx.normalize_tables(seqctx.marginalize(hist, arg) if arg < 6 else hist)
        dtab = freq.view(np.int16)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return {"syms": syms.on(torch.device(dev)), "starts": t(ctxprep.record_bounds(lengths)),
            "plan": ctxcoder.coder_plan(lengths),
            "tab": t(ctxcoder.encode_table(freq).view(np.int64)), "dtab": t(dtab), "arg": arg,
            "freq": freq, "lengths": lengths,
            # the qctx decode's route on the card (qualctx.table_alphabet)
            "alphabet": np.flatnonzero(freq.any(axis=0)).astype(np.uint8)}


def coder_encode(stream: str, inp: dict):
    """The encode wrapper on :func:`coder_inputs` -> (words, flags, states,
    counts)."""
    from fastqpacker_tpu_torch.ops import cuda_kernels

    fn = cuda_kernels.qctx_encode if stream == "qctx" else cuda_kernels.sctx_encode
    return fn(inp["syms"], inp["starts"], inp["plan"], inp["tab"], inp["arg"])


def coder_decode_args(stream: str, inp: dict, enc, dev, checks: bool = False) -> tuple:
    """The decode wrapper's arguments on ``dev`` from an encode's (words,
    flags, states, counts): the payload's words in flat order, the plan with
    the chunks' word counts and states."""
    import torch

    words, flags, states, counts = (x.cpu().numpy() for x in enc)
    plan = ctxcoder.coder_plan(inp["lengths"], counts.reshape(4, 4).sum(axis=1),
                              states.view(np.uint32).reshape(4, 4))
    args = (torch.from_numpy(words[flags.astype(bool)].copy()).to(dev), inp["starts"].to(dev),
            plan, inp["dtab"].to(dev), inp["arg"])
    if stream != "qctx":
        return args
    # a checkout before the dense route (scripts/ctxcoder_ab.py's parent) takes no alphabet
    from fastqpacker_tpu_torch.ops import cuda_kernels

    takes = "alphabet" in inspect.signature(cuda_kernels.qctx_decode).parameters
    return args + ((checks, inp["alphabet"]) if takes else (checks,))


def coder_decode(stream: str, args: tuple):
    """The decode wrapper -> (output, info)."""
    from fastqpacker_tpu_torch.ops import cuda_kernels

    return (cuda_kernels.qctx_decode if stream == "qctx" else cuda_kernels.sctx_decode)(*args)


def empty_encode():
    """The encode outputs of a stream of no symbols (nothing is launched)."""
    import torch

    return (torch.zeros(0, dtype=torch.int16), torch.zeros(0, dtype=torch.uint8),
            torch.full((16,), qualctx.RANS_L, dtype=torch.int32),
            torch.zeros(16, dtype=torch.int64))


def coder_cases() -> list:
    """(stream, name, syms_in, lengths, model or order) of every edge case:
    the qctx cases at models 0 and 1, the sctx cases at orders 2, 4 and 6."""
    out = []
    for name in QCTX_CASES:
        _, lengths, delta = qctx_case(name)
        out += [("qctx", name, delta, lengths, m) for m in qualctx.MODELS]
    for name, (_, lengths, packed) in sctx_cases().items():
        out += [("sctx", name, packed, lengths, o) for o in seqctx.ORDERS]
    return out
