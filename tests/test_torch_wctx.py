"""Port vs JAX package: the wide-interleaved context rANS coder (TAG_WCTX).

Seeded numpy inputs go through ``fastqpacker_tpu/ops/wctx.py`` and the
port's ``fastqpacker_tpu_torch/ops/wctx.py`` (``device="cpu"``, i.e. the
kernels' plain PyTorch versions). Everything is integer or bytes: every
comparison is exact (tolerance 0).

The JAX side runs mostly through its numpy definition of the semantics
(``encode_reference`` / ``decode_reference``) and its C++ twin decoder,
which need no XLA compile; two cases go through the XLA programs
themselves (``encode_stream`` / ``decode_stream(use_native=False)``).
"""

import struct

import numpy as np
import pytest
import torch

import torch_wctx_inputs as wi
from fastqpacker_tpu.entropy import zstd as jzstd
from fastqpacker_tpu.ops import wctx as jwctx
from fastqpacker_tpu.runtime import bindings
from fastqpacker_tpu_torch.ops import wctx as pwctx
from torch_wctx_inputs import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

CPU = "cpu"


def _jax_prep(syms, lengths, model, order, lanes):
    """The JAX package's host prep of one stream (its numpy functions)."""
    C, _, _ = jwctx.model_geometry(model, order)
    sb, S = jwctx.lane_bounds(lengths, lanes)
    seg = (sb[1:] - sb[:-1]).astype(np.int32)
    startm = jwctx.start_matrix(lengths, sb, S)
    pad = int(np.argmax(np.bincount(syms, minlength=256)))
    symm = jwctx.to_matrix(syms, sb, S, pad)
    ctxm = jwctx.context_matrix(symm, startm, model, order)
    present, freq_p = jwctx.build_tables(symm, ctxm, C, seg)
    return dict(sb=sb, S=S, seg=seg, startm=startm, symm=symm, ctxm=ctxm,
                present=present, freq_p=freq_p)


def _jax_reference_payload(syms, lengths, model, order, lanes):
    """The wire payload by the JAX package's numpy reference encoder."""
    p = _jax_prep(syms, lengths, model, order, lanes)
    freq, cum = wi.full_tables(p["freq_p"], p["present"])
    words, states = jwctx.encode_reference(
        p["symm"], p["ctxm"], freq, cum, p["seg"]
    )
    blob = jzstd.get_codec().compress(p["freq_p"].astype("<u2").tobytes())
    out = struct.pack(jwctx.HEADER_FMT, model, order, lanes.bit_length() - 1,
                      len(syms))
    out += struct.pack("<H", len(p["present"]))
    out += p["present"].astype(np.uint8).tobytes()
    out += struct.pack("<I", len(blob)) + blob
    out += struct.pack("<I", len(words))
    out += states.astype("<u4").tobytes() + words.astype("<u2").tobytes()
    return out


@pytest.mark.parametrize("lanes", [256, 1024])
@pytest.mark.parametrize("model,order", wi.MODELS)
def test_encode_stream_payload_equals_jax_reference(model, order, lanes):
    rng = np.random.default_rng(100 * model + order + lanes)
    lengths = wi.rand_lengths(rng, 900 if lanes == 1024 else 400)
    syms = wi.symbols(rng, model, lengths)
    want = _jax_reference_payload(syms, lengths, model, order, lanes)
    got = pwctx.encode_stream(syms, lengths, model, order, lanes=lanes, device=CPU)
    assert got == want
    # each package decodes the other's payload
    assert np.array_equal(pwctx.decode_stream(want, lengths, device=CPU), syms)
    assert bindings.wctx_available()
    assert np.array_equal(jwctx.decode_stream(got, lengths, use_native=True), syms)


@pytest.mark.parametrize("model,order", [(0, 2), (1, 0)])
def test_encode_stream_payload_equals_jax_xla_program(model, order):
    """The same through the JAX package's XLA encode and decode programs."""
    rng = np.random.default_rng(7 + model)
    lengths = wi.rand_lengths(rng, 300, 1, 40)
    syms = wi.symbols(rng, model, lengths)
    want = jwctx.encode_stream(syms, lengths, model, order, lanes=256)
    got = pwctx.encode_stream(syms, lengths, model, order, lanes=256, device=CPU)
    assert got == want
    assert np.array_equal(jwctx.decode_stream(got, lengths, use_native=False), syms)


@pytest.mark.parametrize("model,order", wi.MODELS)
def test_plain_versions_equal_reference_walks(model, order):
    """``wctx_encode_plain`` / ``wctx_decode_plain`` on the JAX package's
    arrays against ``encode_reference`` / ``decode_reference``."""
    rng = np.random.default_rng(40 + 10 * model + order)
    lengths = wi.rand_lengths(rng, 350)
    lengths[5] = 300  # one record longer than a lane
    lengths[20:80] = 0  # lanes with no symbols
    syms = wi.symbols(rng, model, lengths)
    p = _jax_prep(syms, lengths, model, order, 256)
    assert (p["seg"] == 0).any()
    freq, cum = wi.full_tables(p["freq_p"], p["present"])
    words, states = jwctx.encode_reference(p["symm"], p["ctxm"], freq, cum, p["seg"])
    w, f, s, status = pwctx.wctx_encode_plain(
        *wi.encode_tensors(p["symm"], p["ctxm"], p["seg"], p["freq_p"], p["present"])
    )
    assert int(status) == 0
    assert np.array_equal(w[f.bool()].numpy().view(np.uint16), words)
    assert np.array_equal(s.numpy().view(np.uint32), states)
    # padding cells carry nothing
    live = np.arange(p["S"])[:, None] < p["seg"][None, :]
    assert not f.numpy().reshape(p["S"], -1)[~live].any()

    want = jwctx.decode_reference(
        words, states, p["startm"], freq, cum, model, order, p["seg"]
    )
    out, info = pwctx.wctx_decode_plain(
        *wi.decode_tensors(words, states, p["startm"], p["seg"], p["freq_p"],
                           p["present"]),
        model, order,
    )
    assert info.tolist() == [len(words), 0]
    assert np.array_equal(p["present"].astype(np.uint8)[out.numpy()][live], want[live])
    assert not out.numpy()[~live].any()
    assert np.array_equal(pwctx.from_matrix(want, p["sb"]), syms)


@pytest.mark.parametrize("model,order", wi.MODELS)
@pytest.mark.parametrize("lanes", [256, 1024])
def test_host_layout_and_tables_equal(model, order, lanes):
    rng = np.random.default_rng(lanes + 3 * model + order)
    lengths = wi.rand_lengths(rng, 700)
    syms = wi.symbols(rng, model, lengths)
    assert pwctx.model_geometry(model, order) == jwctx.model_geometry(model, order)
    j = _jax_prep(syms, lengths, model, order, lanes)
    C = jwctx.model_geometry(model, order)[0]
    sb, S = pwctx.lane_bounds(lengths, lanes)
    assert S == j["S"] and np.array_equal(sb, j["sb"])
    startm = pwctx.start_matrix(lengths, sb, S)
    assert np.array_equal(startm, j["startm"])
    pad = int(np.argmax(np.bincount(syms, minlength=256)))
    symm = pwctx.to_matrix(syms, sb, S, pad)
    assert np.array_equal(symm, j["symm"])
    assert np.array_equal(pwctx.from_matrix(symm, sb), syms)
    assert np.array_equal(pwctx.position_matrix(startm), jwctx.position_matrix(startm))
    ctxm = pwctx.context_matrix(symm, startm, model, order)
    assert ctxm.dtype == j["ctxm"].dtype and np.array_equal(ctxm, j["ctxm"])
    hist = pwctx.matrix_histogram(symm, ctxm, C, j["seg"])
    assert np.array_equal(hist, jwctx.matrix_histogram(symm, ctxm, C, j["seg"]))
    assert np.array_equal(
        pwctx.matrix_histogram(symm, ctxm, C), jwctx.matrix_histogram(symm, ctxm, C)
    )
    assert np.array_equal(pwctx.normalize_tables(hist), jwctx.normalize_tables(hist))
    present, freq_p = pwctx.build_tables(symm, ctxm, C, j["seg"])
    assert np.array_equal(present, j["present"]) and np.array_equal(freq_p, j["freq_p"])
    assert np.array_equal(pwctx._pcum_from_freq(freq_p), jwctx._pcum_from_freq(freq_p))
    assert np.array_equal(pwctx._sym_to_idx(present), jwctx._sym_to_idx(present))
    assert np.array_equal(pwctx.device_table(freq_p), wi.device_table(freq_p))
    # the size estimate compresses the table with zstd: same bytes, same size
    assert pwctx.estimate_size(hist, lanes) == jwctx.estimate_size(hist, lanes)
    n = len(syms)
    assert pwctx.pick_lanes_for(hist, n) == jwctx.pick_lanes_for(hist, n)


def test_normalize_tables_scalar_redo_rows_equal():
    """Rows whose bumps of 1 outweigh the largest bucket take the scalar
    ``rans.normalize_freqs`` path in both packages."""
    hist = np.zeros((3, 256), np.int64)
    hist[0, :] = 1  # 256 symbols, all equal
    hist[1, :200] = 1
    hist[1, 3] = 30
    hist[2, 7] = 9
    got = pwctx.normalize_tables(hist)
    assert np.array_equal(got, jwctx.normalize_tables(hist))
    assert got.sum(axis=1).tolist() == [4096, 4096, 4096]


@pytest.mark.parametrize("n", [0, 1, 256 << 10, (2 << 20) - 1, 2 << 20, 8 << 20, 1 << 30])
def test_pick_lanes_tiers_equal(n):
    assert pwctx.pick_lanes(n) == jwctx.pick_lanes(n)


def test_pick_lanes_for_halves_on_high_ratio_streams():
    C = pwctx.QUAL_NUM_CTX
    n = 16 << 20
    hist_flat = np.zeros((C, 256), np.int64)
    hist_flat[:, :46] = n // (C * 46)
    hist_skew = np.zeros((C, 256), np.int64)
    hist_skew[:, 40] = n // C
    for hist in (hist_flat, hist_skew):
        assert pwctx.pick_lanes_for(hist, n) == jwctx.pick_lanes_for(hist, n)
    assert pwctx.pick_lanes_for(hist_flat, n) == 8192
    assert 1024 <= pwctx.pick_lanes_for(hist_skew, n) < 8192


EDGE_LENGTHS = {
    "single_record": np.array([37], np.int64),
    "mostly_empty": np.array([0, 0, 0, 5, 0, 0], np.int64),
    "record_longer_than_lane": np.concatenate(
        [np.zeros(50, np.int64), [700], np.zeros(50, np.int64), [3]]
    ),
}


@pytest.mark.parametrize("model,order", [(0, 4), (1, 0), (1, 1)])
@pytest.mark.parametrize("shape", list(EDGE_LENGTHS))
def test_edge_shapes(shape, model, order):
    rng = np.random.default_rng(12)
    lens = EDGE_LENGTHS[shape]
    syms = wi.symbols(rng, model, lens)
    got = pwctx.encode_stream(syms, lens, model, order, lanes=256, device=CPU)
    assert got == _jax_reference_payload(syms, lens, model, order, 256)
    assert np.array_equal(pwctx.decode_stream(got, lens, device=CPU), syms)
    assert np.array_equal(jwctx.decode_stream(got, lens, use_native=True), syms)


def test_sparse_present_alphabet():
    """Contexts see RAW symbol values, not present indices."""
    rng = np.random.default_rng(13)
    lengths = wi.rand_lengths(rng, 300, 1, 40)
    vals = np.frombuffer(b"\x05\x1f\x33", np.uint8)[
        rng.integers(0, 3, int(lengths.sum()))
    ]
    for order in (0, 1):
        got = pwctx.encode_stream(vals, lengths, 1, order, lanes=256, device=CPU)
        assert got == _jax_reference_payload(vals, lengths, 1, order, 256)
        assert np.array_equal(pwctx.decode_stream(got, lengths, device=CPU), vals)
        assert np.array_equal(jwctx.decode_stream(got, lengths, use_native=True), vals)


def _payload(seed=16, model=0, order=2):
    rng = np.random.default_rng(seed)
    lengths = wi.rand_lengths(rng, 100, 1, 30)
    syms = wi.symbols(rng, model, lengths)
    return pwctx.encode_stream(syms, lengths, model, order, lanes=256, device=CPU), lengths


def _mutations():
    payload, lengths = _payload()
    npres = struct.unpack_from("<H", payload, 8)[0]
    blob_at = 10 + npres
    blob_len = struct.unpack_from("<I", payload, blob_at)[0]
    out = {f"cut_{c}": payload[:c] for c in (0, 3, 7, 9, 11, 20)}
    out["cut_blob"] = payload[: blob_at + 6]
    out["cut_half"] = payload[: len(payload) // 2]
    out["cut_last"] = payload[:-1]
    for name, at, val in (("model", 0, 9), ("seq_order", 1, 3), ("npres_zero", 8, 0)):
        b = bytearray(payload)
        b[at] = val
        out[name] = bytes(b)
    b = bytearray(payload)
    b[10], b[11] = b[11], b[10]
    out["present_not_ascending"] = bytes(b)
    b = bytearray(payload)
    b[blob_at + 4 + blob_len // 2] ^= 0x55
    out["blob_flipped"] = bytes(b)
    bad_blob = jzstd.get_codec().compress(bytes(10))
    out["blob_wrong_size"] = (
        payload[:blob_at] + struct.pack("<I", len(bad_blob)) + bad_blob
        + payload[blob_at + 4 + blob_len:]
    )
    p = pwctx.parse_stream(payload)
    freq = p["freq_p"].copy()
    used = np.flatnonzero(freq.sum(axis=1))[0]
    freq[used, int(np.argmax(freq[used]))] -= 1
    sum_blob = jzstd.get_codec().compress(freq.astype("<u2").tobytes())
    out["table_sum"] = (
        payload[:blob_at] + struct.pack("<I", len(sum_blob)) + sum_blob
        + payload[blob_at + 4 + blob_len:]
    )
    return out, lengths


_MUTATIONS, _MUT_LENGTHS = None, None


@pytest.mark.parametrize("name", [
    "cut_0", "cut_3", "cut_7", "cut_9", "cut_11", "cut_20", "cut_blob", "cut_half",
    "cut_last", "model", "seq_order", "npres_zero", "present_not_ascending",
    "blob_flipped", "blob_wrong_size", "table_sum",
])
def test_parse_stream_errors_equal(name):
    """Every ``WctxError`` of the wire parse: same type name, same string."""
    global _MUTATIONS, _MUT_LENGTHS
    if _MUTATIONS is None:
        _MUTATIONS, _MUT_LENGTHS = _mutations()
    bad = _MUTATIONS[name]
    with pytest.raises(jwctx.WctxError) as want:
        jwctx.parse_stream(bad)
    with pytest.raises(pwctx.WctxError) as got:
        pwctx.parse_stream(bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(pwctx.WctxError) as got2:
        pwctx.decode_stream(bad, _MUT_LENGTHS, device=CPU)
    assert str(got2.value) == str(want.value)


def test_decode_stream_length_and_empty_checks_equal():
    payload, lengths = _payload()
    for pkg, kw in ((jwctx, {}), (pwctx, {"device": CPU})):
        with pytest.raises(pkg.WctxError, match="wctx total does not match record lengths"):
            pkg.decode_stream(payload, lengths[:-1], **kw)
    for pkg, kw in ((jwctx, {}), (pwctx, {"device": CPU})):
        with pytest.raises(pkg.WctxError, match="wctx stream length does not match records"):
            pkg.encode_stream(np.zeros(0, np.uint8), lengths[:0], 0, 2, **kw)
        with pytest.raises(pkg.WctxError, match="wctx stream length does not match records"):
            pkg.encode_stream(np.zeros(5, np.uint8), lengths, 0, 2, **kw)
    with pytest.raises(ValueError, match="power of two"):
        pwctx.encode_stream(np.zeros(5, np.uint8), np.array([5]), 0, 2, lanes=100, device=CPU)


def test_wide_quality_alphabet_refused_like_jax():
    lengths = np.full(40, 50, np.int64)
    syms = (np.arange(2000) % 70).astype(np.uint8)
    for pkg, kw in ((jwctx, {}), (pwctx, {"device": CPU})):
        with pytest.raises(pkg.WctxError, match="wctx present alphabet 70 exceeds 64"):
            pkg.encode_stream(syms, lengths, 1, 0, lanes=256, **kw)


def test_corrupt_words_strings():
    """A stream that lost words. The port reads zeros past the buffer and
    reports by the consumed count: "trailing wctx words", the string of
    the JAX package's XLA path (``decode_stream(use_native=False)``,
    ``ops/wctx.py:909``). The JAX numpy reference and the C++ twin say
    "truncated wctx words" for the same stream. A stream with words left
    over is "trailing wctx words" everywhere."""
    payload, lengths = _payload(seed=17, model=1, order=0)
    p = pwctx.parse_stream(payload)
    nwords = len(p["words"])
    at = len(payload) - 2 * nwords - 4 * p["N"] - 4
    lost = payload[:at] + struct.pack("<I", nwords - 40) + payload[at + 4 : -80]
    with pytest.raises(pwctx.WctxError) as e:
        pwctx.decode_stream(lost, lengths, device=CPU)
    assert str(e.value) == "trailing wctx words"
    with pytest.raises(jwctx.WctxError) as e:
        jwctx.decode_stream(lost, lengths, use_native=True)
    assert str(e.value) == "truncated wctx words"
    extra = payload[:at] + struct.pack("<I", nwords + 3) + payload[at + 4 :] + bytes(6)
    for pkg, kw in ((jwctx, {"use_native": True}), (pwctx, {"device": CPU})):
        with pytest.raises(pkg.WctxError) as e:
            pkg.decode_stream(extra, lengths, **kw)
        assert str(e.value) == "trailing wctx words"


def test_flipped_bytes_fail_typed_or_decode_never_crash():
    rng = np.random.default_rng(18)
    payload, lengths = _payload(seed=18, model=1, order=1)
    n = int(lengths.sum())
    for _ in range(12):
        b = bytearray(payload)
        b[int(rng.integers(12, len(b)))] ^= int(rng.integers(1, 256))
        try:
            out = pwctx.decode_stream(bytes(b), lengths, device=CPU)
            assert len(out) == n  # wrong data is the block CRC's to catch
        except pwctx.WctxError:
            pass


def test_empty_context_row_is_a_corrupted_stream():
    """States that land in a context the table does not hold: the JAX
    reference walk raises "corrupted wctx stream" (``ops/wctx.py:426``);
    so does the port, through the flag its device program returns."""
    payload, lengths = _payload(seed=19, model=0, order=6)
    p = pwctx.parse_stream(payload)
    sb, S, seg = pwctx.stream_layout(lengths, p["N"])
    startm = pwctx.start_matrix(lengths, sb, S)
    freq_p = p["freq_p"].copy()
    freq_p[0] = 0  # context 0: every record's first base
    freq, cum = wi.full_tables(freq_p, p["present"])
    with pytest.raises(jwctx.WctxError, match="corrupted wctx stream"):
        jwctx.decode_reference(p["words"], p["states"], startm, freq, cum, 0, 6, seg)
    out, info = pwctx.wctx_decode_plain(
        *wi.decode_tensors(p["words"], p["states"], startm, seg, freq_p, p["present"]),
        0, 6,
    )
    assert int(info[1]) == 1
    p2 = dict(p, freq_p=freq_p)
    with pytest.raises(pwctx.WctxError, match="corrupted wctx stream|trailing wctx words"):
        pwctx.fetch_decoded(pwctx.launch_decode(torch.device(CPU), p2, lengths))


def test_zero_frequency_on_a_live_cell_is_an_invalid_table():
    """``encode_reference`` raises "invalid wctx frequency table" when a
    live cell's frequency is 0 (``ops/wctx.py:378``); the port's encode
    reports it through its status flag and the stream API raises the same."""
    rng = np.random.default_rng(20)
    lengths = wi.rand_lengths(rng, 200, 1, 40)
    syms = wi.symbols(rng, 0, lengths)
    p = _jax_prep(syms, lengths, 0, 2, 256)
    freq_p = p["freq_p"].copy()
    c = int(p["ctxm"][1, 0])
    s = int(np.flatnonzero(p["present"] == p["symm"][1, 0])[0])
    freq_p[c, (s + 1) % 4] += freq_p[c, s]
    freq_p[c, s] = 0
    freq, cum = wi.full_tables(freq_p, p["present"])
    with pytest.raises(jwctx.WctxError, match="invalid wctx frequency table"):
        jwctx.encode_reference(p["symm"], p["ctxm"], freq, cum, p["seg"])
    sym_idx = pwctx._sym_to_idx(p["present"])[p["symm"]]
    with pytest.raises(pwctx.WctxError, match="invalid wctx frequency table"):
        pwctx.fetch_encoded(
            pwctx.launch_encode(torch.device(CPU), sym_idx, p["ctxm"], p["seg"], freq_p)
        )


def test_estimate_tracks_actual_size():
    rng = np.random.default_rng(18)
    lengths = np.full(2000, 100, np.int64)
    syms = wi.walk_quals(rng, int(lengths.sum()))
    N = 256
    p = _jax_prep(syms, lengths, 1, 0, N)
    hist = pwctx.matrix_histogram(p["symm"], p["ctxm"], pwctx.QUAL_NUM_CTX, p["seg"])
    est = pwctx.estimate_size(hist, N)
    actual = len(pwctx.encode_stream(syms, lengths, 1, 0, lanes=N, device=CPU))
    assert abs(est - actual) / actual < 0.05, (est, actual)


@pytest.mark.parametrize("lanes", [2, 8, 16])
@pytest.mark.parametrize("model,order", wi.MODELS)
def test_narrow_streams_equal_the_reference_walks(lanes, model, order):
    """Streams narrower than a warp, which the card's wrappers pad with
    empty lanes: the plain versions equal the JAX package's reference walks
    (so the padded kernel launch has a fixed answer to meet)."""
    rng = np.random.default_rng(lanes + 7 * model)
    lengths = wi.rand_lengths(rng, 40, 0, 30)
    syms = wi.symbols(rng, model, lengths)
    p = _jax_prep(syms, lengths, model, order, lanes)
    freq, cum = wi.full_tables(p["freq_p"], p["present"])
    jw, js = jwctx.encode_reference(p["symm"], p["ctxm"], freq, cum, p["seg"])
    enc = wi.encode_tensors(p["symm"], p["ctxm"], p["seg"], p["freq_p"], p["present"])
    words, flags, states, status = pwctx.wctx_encode_plain(*enc)
    f = flags.numpy().astype(bool)
    assert int(status) == 0
    assert np.array_equal(words.numpy().view(np.uint16)[f], jw)
    assert np.array_equal(states.numpy().view(np.uint32), js)
    dec = wi.decode_tensors(jw, js, p["startm"], p["seg"], p["freq_p"], p["present"])
    out, info = pwctx.wctx_decode_plain(*dec, model, order)
    assert info.tolist() == [len(jw), 0]
    idx = pwctx.from_matrix(out.numpy(), p["sb"])
    assert np.array_equal(p["present"].astype(np.uint8)[idx], syms)
