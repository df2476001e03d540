"""The port's v3 context coders (``fq_qctx_encode`` / ``fq_qctx_decode`` /
``fq_sctx_encode`` / ``fq_sctx_decode``, ``csrc/ctxcoder.cu``) against the
JAX package's, on the CPU.

Seeded inputs (the JAX coder tests' cases, chunks with no record, a
one-symbol stream) go through the port's ``qualctx`` / ``seqctx`` on
``device="cpu"``, where ``cuda_kernels.qctx_encode`` and the other wrappers
run their plain versions (the Python walks), and through the JAX package's
pure Python references; where its C++ runtime is built, also through its
``fq_qctx_encode`` / ``fq_sctx_encode`` (compared per chunk: states and word
runs) and its decodes. Every decode fault gives the JAX route's string: the
references' per-block strings, and with ``runtime_checks`` the whole-file
decoder's. A v3 container of two blocks of the context-model corpus equals
the JAX package's, its streams ``TAG_SCTX`` / ``TAG_QCTX``. All comparisons
are exact.
"""

import io
import re
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import fastqpacker_tpu as jfq
import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu.ops import qualctx as jq
from fastqpacker_tpu.ops import seqctx as js
from fastqpacker_tpu.runtime import bindings
from fastqpacker_tpu_torch.format import container
from fastqpacker_tpu_torch.ops import ctxcoder, ctxprep, cuda_kernels
from fastqpacker_tpu_torch.ops import qualctx as tq
from fastqpacker_tpu_torch.ops import seqctx as ts
from fastqpacker_tpu_torch.pipeline import blocks
from fastqpacker_tpu_torch.utils.synth import synth_fastq
import torch_ctxcoder_inputs as cci
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

SRC = Path(__file__).resolve().parent.parent / "fastqpacker_tpu_torch" / "csrc" / "ctxcoder.cu"

# tests/test_qualctx.py:41 CASES and tests/test_seqctx.py:37 CASES, then
# chunks with no record and one-symbol streams
QCTX_CASES = cci.QCTX_CASES
SCTX_CASES = cci.sctx_cases()
ORDERS = (2, 4, 6)


def _qctx_case(name):
    raw, lengths, delta = cci.qctx_case(name)
    assert delta == jq.deintegrate(raw, lengths)
    return raw, lengths, delta


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("error", str(e))


def _symbols(syms) -> ctxprep.Symbols:
    """Host symbols as a prepare pass's result on the CPU."""
    return ctxprep.Symbols(torch.from_numpy(np.ascontiguousarray(syms, np.uint8)))


def _chunks(kernel, syms, lengths, freq, arg):
    """The port's encode at a given model or order (plain versions):
    ((4, 4) states, word runs)."""
    return ctxcoder.launch_encode(kernel, _symbols(syms), lengths, freq, arg,
                            ValueError("invalid")).result()


# ---------------------------------------------------------------------------
# qctx
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(QCTX_CASES))
def test_qctx_round_trip_equals_the_jax_reference(name):
    raw, lengths, delta = _qctx_case(name)
    port = tq.encode(delta, lengths, device="cpu")
    assert port == jq.encode_reference(delta, lengths)
    assert tq.decode(port, lengths, device="cpu") == jq.decode_reference(port, lengths) == delta
    assert tq.decode(port, lengths, runtime_checks=True, device="cpu") == delta


@pytest.mark.parametrize("model", [0, 1])
@pytest.mark.parametrize("name", [n for n in QCTX_CASES if n not in ("empty", "all-zero-lengths")])
def test_qctx_chunks_equal_the_jax_runtime(name, model):
    """Per chunk, states and word runs equal the JAX runtime's
    ``fq_qctx_encode`` at each model, and its ``fq_qctx_decode`` reads them
    back to the port's decode."""
    if not bindings.available():
        pytest.skip("the JAX package's C++ runtime is not built here")
    raw, lengths, delta = _qctx_case(name)
    hist = jq.hist_for_model(jq.histogram(raw, jq.contexts(raw, lengths, 1)), model)
    freq = jq.normalize_tables(hist)
    cum = np.zeros_like(freq, dtype=np.uint32)
    np.cumsum(freq[:, :-1], axis=1, out=cum[:, 1:])
    states, runs = _chunks(cuda_kernels.qctx_encode, raw, lengths, freq, model)
    jstates, jruns = bindings.qctx_encode_chunks(raw, lengths, freq, cum, model)
    assert np.array_equal(states, jstates)
    assert [r.tobytes() for r in runs] == [r.tobytes() for r in jruns]
    payload = tq._assemble_payload(len(raw), jfq_zstd(tq.serialize_tables(freq)), states, runs,
                                   model)
    back = tq.decode(payload, lengths, runtime_checks=True, device="cpu")
    assert back == bindings.qctx_decode(np.concatenate(runs), np.array([len(r) for r in runs]),
                                        states.reshape(-1), len(raw), lengths, freq, model)
    assert back == delta


def jfq_zstd(blob: bytes) -> bytes:
    from fastqpacker_tpu_torch.entropy import zstd

    return zstd.get_codec().compress(blob)


_split_payload = cci.split_payload


QCTX_FAULTS, QCTX_FAULT_LENGTHS = cci.qctx_fault_payloads()


def test_fault_payloads_are_cut_from_the_jax_references_encodes():
    """The faulty payloads start from streams the port's CPU encode codes as
    the JAX references do."""
    _, lengths, delta = _qctx_case("varlen")
    assert tq.encode(delta, lengths, device="cpu") == jq.encode_reference(delta, lengths)
    _, lengths, packed = SCTX_CASES["markov-40x151"]
    assert ts.encode(packed, lengths, device="cpu") == js.encode_reference(packed, lengths)


@pytest.mark.parametrize("name", list(QCTX_FAULTS))
def test_qctx_faults_give_the_jax_strings(name):
    payload, lengths = QCTX_FAULTS[name], QCTX_FAULT_LENGTHS
    # per block: the JAX reference's outcome (its string, or its bytes)
    assert _outcome(tq.decode, payload, lengths, device="cpu") == _outcome(
        jq.decode_reference, payload, lengths)
    # the whole-file route: the port raises where the JAX runtime does, with
    # its string once mapped (blocks.RUNTIME_STREAM_ERRORS)
    got = _outcome(tq.decode, payload, lengths, runtime_checks=True, device="cpu")
    assert got[0] == "error" and got[1] in tq.QCTX_FAULTS.values()
    with pytest.raises(ValueError) as mapped:
        with blocks.runtime_stream_errors(container.TAG_QCTX, True):
            tq.decode(payload, lengths, runtime_checks=True, device="cpu")
    assert str(mapped.value) == "corrupted qctx quality data"
    if bindings.available():
        _, states, runs = _split_payload(payload)
        model = payload[5]
        from fastqpacker_tpu_torch.entropy import zstd

        blob_size = struct.unpack_from("<I", payload, 8)[0]
        freq = jq.deserialize_tables(zstd.get_codec().decompress(payload[12 : 12 + blob_size]),
                                     jq.NUM_CTX2 if model else jq.NUM_CTX)
        with pytest.raises(ValueError, match="^corrupted qctx quality data$"):
            bindings.qctx_decode(
                np.frombuffer(b"".join(runs), "<u2").copy(),
                np.array([len(r) // 2 for r in runs], np.int64),
                np.frombuffer(b"".join(states), "<u4").copy(),
                int(lengths.sum()), lengths, freq, model)


def test_qctx_fault_strings_name_the_first_chunk():
    """Faults in chunks 1 and 3: the per-block decoders name chunk 1's (a
    word left over is no fault there), the whole-file checks chunk 1's too."""
    payload = QCTX_FAULTS["chunk 3 short, chunk 1 long"]
    lengths = QCTX_FAULT_LENGTHS
    assert _outcome(tq.decode, payload, lengths, device="cpu") == (
        "error", "truncated qctx words") == _outcome(jq.decode_reference, payload, lengths)
    assert _outcome(tq.decode, payload, lengths, runtime_checks=True, device="cpu") == (
        "error", "trailing qctx words")


# ---------------------------------------------------------------------------
# sctx
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCTX_CASES))
def test_sctx_round_trip_equals_the_jax_reference(name):
    _, lengths, packed = SCTX_CASES[name]
    port = ts.encode(packed, lengths, device="cpu")
    assert port == js.encode_reference(packed, lengths)
    assert ts.decode(port, lengths, device="cpu") == js.decode_reference(port, lengths) == packed


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", list(SCTX_CASES))
def test_sctx_chunks_equal_the_jax_runtime(name, order):
    """Per chunk at orders 2, 4 and 6: states and word runs equal the JAX
    runtime's ``fq_sctx_encode``; its ``fq_sctx_decode`` and the port's give
    the packed rows back."""
    if not bindings.sctx_available():
        pytest.skip("the JAX package's C++ runtime is not built here")
    bases, lengths, packed = SCTX_CASES[name]
    hist = js.marginalize(js.histogram(bases, lengths), order) if order < 6 else \
        js.histogram(bases, lengths)
    freq = js.normalize_tables(hist)
    cum = np.zeros_like(freq, dtype=np.uint32)
    np.cumsum(freq[:, :-1], axis=1, out=cum[:, 1:])
    states, runs = _chunks(cuda_kernels.sctx_encode, bases, lengths, freq, order)
    jstates, jruns = bindings.sctx_encode_chunks(bases, lengths, order, freq, cum)
    assert np.array_equal(states, jstates)
    assert [r.tobytes() for r in runs] == [r.tobytes() for r in jruns]
    words = np.concatenate(runs)
    counts = np.array([len(r) for r in runs], np.int64)
    plan = ctxcoder.coder_plan(lengths, counts, states)
    starts = torch.from_numpy(np.concatenate(([0], np.cumsum(lengths))).astype(np.int64))
    got, info = cuda_kernels.sctx_decode(torch.from_numpy(words.view(np.int16)), starts, plan,
                                         torch.from_numpy(freq.view(np.int16)), order)
    assert not info[:, 0].any()
    assert got.numpy().tobytes() == packed == bindings.sctx_decode(
        words, counts, states.reshape(-1), len(bases), lengths, order, freq)


SCTX_FAULTS, SCTX_FAULT_LENGTHS = cci.sctx_fault_payloads()


@pytest.mark.parametrize("name", list(SCTX_FAULTS))
def test_sctx_faults_give_the_jax_strings(name):
    payload, lengths = SCTX_FAULTS[name], SCTX_FAULT_LENGTHS
    got = _outcome(ts.decode, payload, lengths, device="cpu")
    assert got == _outcome(js.decode_reference, payload, lengths)
    assert got[0] == "error" and got[1] in ts.SCTX_FAULTS.values()
    with pytest.raises(ValueError) as mapped:
        with blocks.runtime_stream_errors(container.TAG_SCTX, True):
            ts.decode(payload, lengths, device="cpu")
    assert str(mapped.value) == "corrupted sctx sequence data"


def test_sctx_fault_strings_name_the_first_chunk():
    payload = SCTX_FAULTS["chunk 2 short, chunk 1 long"]
    assert _outcome(ts.decode, payload, SCTX_FAULT_LENGTHS, device="cpu") == (
        "error", "trailing sctx words")


# ---------------------------------------------------------------------------
# the kernels' plans and plain versions
# ---------------------------------------------------------------------------


def test_plan_layout_equals_the_source():
    """``ctxcoder.PLAN_*`` are the offsets ``csrc/ctxcoder.cu`` reads."""
    text = SRC.read_text()
    for name, value in (("Rb", ctxcoder.PLAN_RB), ("Sb", ctxcoder.PLAN_SB), ("Wstart", ctxcoder.PLAN_WSTART),
                        ("Wcount", ctxcoder.PLAN_WCOUNT), ("States", ctxcoder.PLAN_STATES),
                        ("Pstart", ctxcoder.PLAN_PSTART), ("Words", ctxcoder.PLAN_WORDS)):
        assert re.search(rf"kPlan{name} = {value}\b", text), name


@pytest.mark.parametrize("name", ["varlen", "three-records-and-empties", "one-symbol"])
def test_encode_plain_outputs_flag_each_chunks_words(name):
    """The plain encode's words and flags in flat order are the payload's
    runs, its counts each chain's flags; a present symbol with no frequency
    sets its chain's count to -1 and raises the JAX runtime's string."""
    raw, lengths, delta = _qctx_case(name)
    hist = jq.hist_for_model(jq.histogram(raw, jq.contexts(raw, lengths, 1)), 0)
    freq = jq.normalize_tables(hist)
    plan = ctxcoder.coder_plan(lengths)
    starts = torch.from_numpy(np.concatenate(([0], np.cumsum(lengths))).astype(np.int64))
    tab = torch.from_numpy(ctxcoder.encode_table(freq).view(np.int64))
    words, flags, states, counts = cuda_kernels.qctx_encode(
        torch.from_numpy(raw), starts, plan, tab, 0)
    f = flags.numpy()
    assert int(counts.sum()) == int(f.sum()) and set(np.unique(f)) <= {0, 1}
    assert not words.numpy()[f == 0].any()
    ref = jq.encode_reference(delta, lengths)
    _, _, runs = _split_payload(ref)
    assert words.numpy()[f == 1].tobytes() == b"".join(runs)
    freq[jq.contexts(raw, lengths, 0)[0]] = 0
    bad = ctxcoder.launch_encode(cuda_kernels.qctx_encode, _symbols(raw), lengths,
                           freq, 0, tq.QctxError("invalid qctx frequency table"))
    with pytest.raises(tq.QctxError, match="^invalid qctx frequency table$"):
        bad.result()


def test_sctx_encode_zero_frequency_raises_the_runtime_string():
    bases, lengths, _ = SCTX_CASES["markov-40x151"]
    freq = js.normalize_tables(js.marginalize(js.histogram(bases, lengths), 2))
    freq[0] = 0
    with pytest.raises(ts.SctxError, match="^invalid sctx frequency table$"):
        ctxcoder.launch_encode(cuda_kernels.sctx_encode, _symbols(bases), lengths,
                         freq, 2, ts.SctxError("invalid sctx frequency table")
                         ).result()


# ---------------------------------------------------------------------------
# the v3 container
# ---------------------------------------------------------------------------


def _tags(comp: bytes) -> list:
    r = io.BytesIO(comp)
    fh = container.read_file_header(r)
    out = []
    while (hdr := container.read_block_header(r, fh.version)) is not None:
        sizes = hdr.stream_sizes(container.VERSION_2)
        payload = r.read(sum(sizes))
        out.append((payload[0], payload[sizes[0]]))
    return out


def test_v3_container_of_the_context_corpus_equals_the_jax_package():
    """Two blocks of the context-model corpus (Markov bases, Phred walks):
    the port's v3 container on the CPU equals the JAX package's, every
    block's sequence stream TAG_SCTX and quality stream TAG_QCTX, and it
    decodes on the CPU."""
    data = synth_fastq(0.9, seed=5, qual_model="phredwalk", seq_model="markov")
    nrec = data.count(b"\n") // 4
    opts = dict(version=3, block_size=-(-nrec // 2), workers=1)
    comp = tfq.compress_bytes(data, tfq.Options(**opts), device="cpu")
    assert comp == jfq.compress_bytes(data, jfq.Options(**opts))
    assert _tags(comp) == [(container.TAG_SCTX, container.TAG_QCTX)] * 2
    assert tfq.decompress_bytes(comp, device="cpu") == data


def test_encode_table_reciprocals_divide_exactly():
    """The encode table's reciprocals give ``floor(x / f)`` as the kernels
    compute it, ``(x + umulhi(x, m)) >> ceil(log2 f)``, for every f of a
    12-bit table and x across the 32-bit states (edges and a seeded
    sample), as the JAX runtime's reciprocal division does."""
    freq = np.arange(tq.PROB_SCALE + 1, dtype=np.uint16).reshape(-1, 1)  # a row a frequency
    tab = ctxcoder.encode_table(freq)[:, 0]
    f = np.arange(1, tq.PROB_SCALE + 1, dtype=np.uint64)
    m = tab[1:] >> np.uint64(32)
    assert int(tab[0]) == 0 and np.array_equal(tab[1:] & 0xFFFFFFFF, f << np.uint64(16))
    s = np.array([(int(v) - 1).bit_length() for v in f], np.uint64)
    rng = np.random.default_rng(32)
    edges = np.array([0, 1, (1 << 16) - 1, 1 << 16, (1 << 31), (1 << 32) - 1], np.uint64)
    for x in (*edges, *rng.integers(0, 1 << 32, 64, dtype=np.uint64)):
        x = np.full(f.shape, x, np.uint64)
        for xs in (x, np.minimum(x // f * f, (1 << 32) - 1), np.maximum(x // f * f, 1) - 1):
            q = (xs + ((xs * m) >> np.uint64(32))) >> s
            assert np.array_equal(q, xs // f)


# ---------------------------------------------------------------------------
# the card's tiled decodes: the qctx dense route's host half, the tile edges
# ---------------------------------------------------------------------------


def _table(name, model):
    raw, lengths, _ = _qctx_case(name)
    hist = jq.hist_for_model(jq.histogram(raw, jq.contexts(raw, lengths, 1)), model)
    return jq.normalize_tables(hist)


@pytest.mark.parametrize("model", [0, 1])
@pytest.mark.parametrize("name", ["varlen-binned", "varlen", "tile-straddle", "absent-rows"])
def test_dense_rows_give_the_slot_tables_symbol_f_and_cum(name, model):
    """Every dense row at every slot: the count of its columns <= the slot
    (the kernel's two ballots) names the symbol, and the next column less
    this one, masked, its f; both and the cum equal the JAX package's slot
    table (``ops/qualctx.py:352 _slot_syms``) and cumulative frequencies for
    the context the row copies. Binned (5 symbols with 0), walk (41), Phred
    walks per record (symbol 0 absent: the route adds it); "absent-rows"
    empties the contexts of one previous symbol, which decode to symbol 0
    with f = cum = 0 as the slot table's 0 does. Every context the dense
    route can reach (previous symbol in the alphabet or the record start)
    has a row."""
    freq = _table("tile-straddle" if name == "absent-rows" else name, model).copy()
    if name == "absent-rows":
        ctx = np.arange(freq.shape[0])
        qbin = (ctx // jq.NUM_Q2B if model else ctx) % jq.NUM_QBINS
        freq[qbin == 30] = 0
    layout = tq.dense_layout(tq.table_alphabet(freq), model)
    assert layout is not None and layout.shared <= tq.SHARED_OPTIN
    assert layout.symbols[0] == 0 and set(tq.table_alphabet(freq)) <= set(layout.symbols)
    rows = tq.dense_rows(freq, model, layout)
    slot_sym = jq._slot_syms(freq)
    cum = np.zeros(freq.shape, np.int64)
    np.cumsum(freq[:, :-1].astype(np.int64), axis=1, out=cum[:, 1:])
    slots = np.arange(tq.PROB_SCALE)
    seen = set()
    for r in range(layout.rows):
        c = tq.dense_row_context(layout, r, model)
        seen.add(c)
        cnt = np.searchsorted(rows[r], slots, side="right")
        sym = layout.symbols[cnt - 1]
        f = (rows[r][np.minimum(cnt, layout.width - 1)].astype(np.int64) - rows[r][cnt - 1]) & 0x1FFF
        want = slot_sym[c]
        assert np.array_equal(sym, want), (r, c)
        assert np.array_equal(f, freq[c, want]) and np.array_equal(rows[r][cnt - 1], cum[c, want])
        assert tq.dense_lookup(rows[r], 4095) == (int(cnt[-1]), int(f[-1]), int(cum[c, want[-1]]))
    prevs = {jq.NUM_QBINS - 1} | {min(int(s), 46) for s in layout.symbols}
    reach = {c for c in range(freq.shape[0])
             if ((c // jq.NUM_Q2B if model else c) % jq.NUM_QBINS) in prevs
             and (not model or c % jq.NUM_Q2B != 6)}
    assert reach == seen
    if name == "absent-rows":
        assert (rows[:, 0] == 0).all() and (rows == tq.DENSE_ABSENT).any()


@pytest.mark.parametrize("model", [0, 1])
def test_dense_route_is_taken_by_the_table_size_alone(model):
    """The route: the dense rows where the alphabet (0 added) and the
    sentinel column fit a warp's 64 and a tile fits the shared memory, else
    the L2 slot table (``uniform-random``'s 94 symbols); the largest tile
    that fits; the same for any table of the same alphabet."""
    assert tq.dense_layout(tq.table_alphabet(_table("uniform-random", model)), model) is None
    assert tq.dense_layout(tq.table_alphabet(_table("varlen-binned", model)), model).tile == 4096
    assert tq.dense_layout(tq.table_alphabet(_table("varlen", model)), model).tile == \
        (1024 if model else 4096)
    limit = 43 if model else 63  # symbols a dense table may have (0 among them)
    for n in (limit - 1, limit):
        lay = tq.dense_layout(np.arange(n), model)
        assert lay is not None and lay.shared <= tq.SHARED_OPTIN
        assert lay.shared == tq.dense_shared_bytes(n, model, lay.tile)
    assert tq.dense_layout(np.arange(1, limit + 1), model) is None  # 0 added: one more
    assert tq.dense_layout(np.arange(limit + 1), model) is None


def test_dense_geometry_equals_the_source():
    """The host's layout constants are ``csrc/ctxcoder.cu``'s."""
    text = SRC.read_text()
    for name, value in (("kHead", tq.DENSE_HEAD), ("kMetaPad", tq.DENSE_META_PAD),
                        ("kMaxDense", tq.DENSE_MAX_COLUMNS), ("kSctxTile", ts.DECODE_TILE),
                        ("kAbsent", tq.DENSE_ABSENT)):
        assert re.search(rf"\b{name} = {value}\b", text), name


@pytest.mark.parametrize("stream", ["qctx", "sctx"])
@pytest.mark.parametrize("name", list(cci.TILE_CASES))
def test_tile_edge_cases_take_renorms_at_tile_ends(stream, name):
    """The tile-edge inputs do what they are for: records straddle the
    tiles of every route (a renorm word at some tile's last symbol), the
    short chunks lie inside one tile, the empty records sit on tile edges."""
    case = next(c for c in cci.coder_cases() if c[0] == stream and c[1] == name)
    inp = cci.coder_inputs(stream, case[2], case[3], "cpu", case[4])
    flags = cci.coder_encode(stream, inp)[1].numpy()
    tile = cci.decode_tile(stream, inp["freq"], inp["arg"])
    sb = inp["plan"].numpy()[ctxcoder.PLAN_SB : ctxcoder.PLAN_SB + 5]
    if name == "tile-straddle":
        assert cci.tile_last_renorms(stream, inp, flags)
        assert all((sb[k] + tile) % 151 for k in range(4))
    elif name == "short-chunks":
        assert (np.diff(sb) < tile).all() and (np.diff(sb) > 0).all()
    else:
        ends = np.cumsum(case[3])
        assert all(((ends == sb[k] + tile) & (case[3] == 0)).any() for k in range(3))


TILE_FAULTS = cci.tile_fault_payloads()


@pytest.mark.parametrize("stream", ["qctx", "sctx"])
def test_tile_edge_faults_give_the_jax_strings(stream):
    """A chunk that runs out of words at the last symbol of a tile: the
    JAX reference's string, and the plain version's fault at that symbol."""
    payload, lengths, k, j = TILE_FAULTS[stream]
    mod, ref = (tq, jq) if stream == "qctx" else (ts, js)
    got = _outcome(mod.decode, payload, lengths, device="cpu")
    assert got == _outcome(ref.decode_reference, payload, lengths)
    assert got == ("error", f"truncated {stream} words")
    info = cci.coder_decode(stream, cci.payload_decode_args(stream, payload, lengths, "cpu"))[1]
    assert info[k].tolist() == [2, j] and not info[:k, 0].any()
