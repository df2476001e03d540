"""The port's order-0 rANS coder against the JAX package's, byte for byte.

Seeded numpy inputs go to ``fastqpacker_tpu.ops.rans`` and to
``fastqpacker_tpu_torch.ops.rans`` (``device="cpu"``, where the kernel
wrappers run the plain PyTorch versions). Streams must be identical, each
package must decode the other's, and the plain versions must equal the JAX
package's XLA device programs cell for cell. All comparisons are exact.

On the CPU the JAX package codes streams with its sequential C++ twin
(byte-identical to its XLA programs); ``FQZ_RANS_BACKEND=device`` selects
the XLA programs, used here at the 256-lane tier and at toy shapes.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastqpacker_tpu.ops import rans as jrans
from fastqpacker_tpu_torch.ops import cuda_kernels
from fastqpacker_tpu_torch.ops import rans as trans
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _jax_codes_rans_with_its_sequential_twin(monkeypatch):
    """Which rANS backend the JAX package picks on the CPU is process state
    (a memoized transfer probe that other test files may have set). Pin it:
    the sequential twin writes the same streams as the XLA programs, and
    only it reports a stream whose word count does not fit."""
    monkeypatch.setenv("FQZ_RANS_BACKEND", "host")


def _stream(n, seed, alphabet=40):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(alphabet / 2, alphabet / 8, n), 0, 255).astype(np.uint8)


def _hist(seed):
    rng = np.random.default_rng(seed)
    hist = np.zeros(256, np.int64)
    k = int(rng.integers(1, 257))
    hist[rng.choice(256, k, replace=False)] = rng.integers(1, 1 << int(rng.integers(1, 20)), k)
    return hist


@pytest.mark.parametrize("seed", range(8))
def test_tables_match_jax(seed):
    hist = _hist(seed)
    freq = trans.normalize_freqs(hist.copy())
    assert np.array_equal(freq, jrans.normalize_freqs(hist.copy()))
    assert freq.dtype == np.uint16 and int(freq.sum()) == trans.PROB_SCALE
    assert np.array_equal(trans.cumulative(freq), jrans.cumulative(freq))
    for a, b in zip(trans.slot_tables(freq), jrans.slot_tables(freq)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(trans.pack_slot_table(freq), jrans.pack_slot_table(freq))


def test_empty_histogram_error_matches():
    with pytest.raises(jrans.RansError) as want:
        jrans.normalize_freqs(np.zeros(256, np.int64))
    with pytest.raises(trans.RansError) as got:
        trans.normalize_freqs(np.zeros(256, np.int64))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "n", [0, 1, 16383, 16384, (2 << 20) - 1, 2 << 20, (8 << 20) - 1, 8 << 20]
)
def test_lane_tier_matches_jax(n):
    assert trans._pick_lanes(n) == jrans._pick_lanes(n)


def _edge_cases():
    for lanes in (256, 4096, 16384):
        for n in (1, lanes - 1, lanes, lanes + 1, 3 * lanes + 7):
            yield lanes, n


@pytest.mark.parametrize("lanes,n", list(_edge_cases()))
def test_stream_identical_and_cross_decodes(lanes, n):
    """Each lane tier at the length edges: ragged and full last rows."""
    data = _stream(n, seed=lanes + n)
    got = trans.encode_stream(data, lanes=lanes, device="cpu")
    want = jrans.encode_stream(data, lanes=lanes)
    assert got == want
    assert trans.decode_stream(want, device="cpu") == data.tobytes()
    assert jrans.decode_stream(got) == data.tobytes()


@pytest.mark.parametrize(
    "n,lanes", [(100_000, 256), ((2 << 20) + 5, 4096), ((8 << 20) + 3, 16384)]
)
def test_stream_identical_at_the_picked_tier(n, lanes):
    data = _stream(n, seed=n)
    got = trans.encode_stream(data, device="cpu")
    assert got[4] == lanes.bit_length() - 1
    assert got == jrans.encode_stream(data)
    assert trans.decode_stream(got, device="cpu") == data.tobytes()


@pytest.mark.parametrize("kind", ["single_symbol", "all_256", "bytes_input"])
def test_stream_alphabet_extremes(kind):
    if kind == "single_symbol":
        data = np.full(5000, 7, np.uint8)
    elif kind == "all_256":
        data = np.random.default_rng(3).integers(0, 256, 70_000).astype(np.uint8)
    else:
        data = _stream(3000, seed=9).tobytes()
    got = trans.encode_stream(data, device="cpu")
    assert got == jrans.encode_stream(data)
    raw = data if isinstance(data, bytes) else data.tobytes()
    assert trans.decode_stream(got, device="cpu") == raw


def test_empty_stream():
    got = trans.encode_stream(b"", device="cpu")
    assert got == jrans.encode_stream(b"") == struct.pack("<IB3x", 0, 0)
    assert trans.decode_stream(got, device="cpu") == b""


def test_pad_symbol_is_the_argmax_before_padding():
    """Ties resolve to the first maximum, and the padding does not move
    it: 3 x 5, 3 x 9 and one row's worth of padding."""
    data = np.array([9, 5, 9, 5, 9, 5], np.uint8)
    got = trans.encode_stream(data, lanes=4, device="cpu")
    assert got == jrans.encode_stream(data, lanes=4)
    freq = np.frombuffer(got[8 : 8 + 512], "<u2")
    assert freq[5] > freq[9]  # the two pad cells were counted as 5s


@pytest.mark.parametrize("n", [300, 256 * 40 + 17])
def test_xla_device_programs_write_the_same_stream(n, monkeypatch):
    """Against the XLA programs themselves (encode, compact, decode),
    not the C++ twin, at the 256-lane tier."""
    monkeypatch.setenv("FQZ_RANS_BACKEND", "device")
    data = _stream(n, seed=n)
    got = trans.encode_stream(data, device="cpu")
    assert got == jrans.encode_stream(data)
    assert jrans.decode_stream(got) == data.tobytes()
    monkeypatch.setenv("FQZ_RANS_DECODE", "take")
    assert jrans.decode_stream(got) == data.tobytes()


def _toy(seed, steps, lanes, n):
    data = _stream(n, seed, alphabet=12)
    hist = np.bincount(data, minlength=256).astype(np.int64)
    pad = int(np.argmax(hist))
    hist[pad] += steps * lanes - n
    freq = trans.normalize_freqs(hist)
    cum = trans.cumulative(freq)
    return data, pad, freq, cum


@pytest.mark.parametrize("seed,steps,lanes,n", [(0, 8, 16, 128), (1, 7, 32, 200), (2, 3, 4, 9)])
def test_plain_versions_equal_the_xla_programs(seed, steps, lanes, n):
    """Module level: ``rans_encode`` / ``rans_compact`` / ``rans_decode``
    on CPU tensors against ``_encode_kernel`` / ``_compact_global`` /
    ``_decode_kernel`` / ``_decode_kernel_nogather``, every cell."""
    data, pad, freq, cum = _toy(seed, steps, lanes, n)
    S = 8
    padded = np.zeros((S, lanes), np.uint8)
    padded.reshape(-1)[: steps * lanes] = pad
    padded.reshape(-1)[:n] = data
    freq_cum = np.stack([freq.astype(np.uint32), cum.astype(np.uint32)])
    emits, emask, jstates = jrans._encode_kernel(
        jnp.asarray(padded), jnp.int32(steps), jnp.asarray(freq_cum), S, lanes
    )
    jflat, jtotal = jrans._compact_global(emits, emask, S, lanes)
    jtotal = int(jtotal)

    words, flags, states = cuda_kernels.rans_encode(
        torch.from_numpy(data), steps, lanes, pad,
        torch.from_numpy(freq_cum.astype(np.int32)),
    )
    m = steps * lanes
    assert np.array_equal(flags.numpy().astype(bool), np.asarray(emask).reshape(-1)[:m])
    assert np.array_equal(
        words.numpy().view(np.uint16)[flags.numpy() > 0],
        np.asarray(emits).reshape(-1)[:m][flags.numpy() > 0],
    )
    assert np.array_equal(states.numpy().view(np.uint32), np.asarray(jstates))
    flat, total = cuda_kernels.rans_compact(words, flags)
    assert int(total) == jtotal
    assert np.array_equal(
        flat.numpy().view(np.uint16)[:jtotal], np.asarray(jflat)[:jtotal]
    )

    wpad = np.zeros(jtotal + 2 * lanes, np.uint16)
    wpad[:jtotal] = np.asarray(jflat)[:jtotal]
    slot_tab = jrans.pack_slot_table(freq)
    jout, _, jbase = jrans._decode_kernel(
        jnp.asarray(wpad), jstates, jnp.int32(steps),
        jnp.asarray(slot_tab.reshape(16, 256)), S, lanes,
    )
    tabs = jrans.compact_tables(freq)
    nout, _, nbase = jrans._decode_kernel_nogather(
        jnp.asarray(wpad), jstates, jnp.int32(steps), jnp.asarray(tabs),
        S, lanes, tabs.shape[1],
    )
    out, consumed = cuda_kernels.rans_decode(
        flat[:jtotal].contiguous(), states,
        torch.from_numpy(trans.pack_slot_table(freq).view(np.int32)),
        steps, lanes,
    )
    assert int(consumed) == int(jbase) == int(nbase) == jtotal
    assert np.array_equal(out.numpy(), np.asarray(jout)[:steps].reshape(-1))
    assert np.array_equal(out.numpy(), np.asarray(nout)[:steps].reshape(-1))
    assert out.numpy()[:n].tobytes() == data.tobytes()


COMPACT_SHAPES = [(1, 1), (3, 7), (37, 256), (9, 4096)]


def _compact_inputs(seed, steps, lanes, flag_bytes):
    """Seeded (steps, lanes) u16 words and u8 flags drawn from ``flag_bytes``
    with their probabilities (a dict byte -> probability)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 16, (steps, lanes)).astype(np.uint16)
    values = np.array(list(flag_bytes), np.uint8)
    flags = rng.choice(values, (steps, lanes), p=list(flag_bytes.values()))
    return words, flags


@pytest.mark.parametrize("steps,lanes", COMPACT_SHAPES)
@pytest.mark.parametrize("density", [0, 0.001, 0.11, 0.5, 1])
def test_plain_compact_equals_compact_global(density, steps, lanes):
    """``rans_compact`` on CPU tensors (the plain version) against the XLA
    program ``_compact_global`` on the same words and mask: the kept words
    in flat order and their total, both exact."""
    words, flags = _compact_inputs(
        int(density * 1000) + steps, steps, lanes, {0: 1 - density, 1: density})
    jflat, jtotal = jrans._compact_global(
        jnp.asarray(words), jnp.asarray(flags.astype(bool)), steps, lanes)
    flat, total = cuda_kernels.rans_compact(
        torch.from_numpy(words.view(np.int16).reshape(-1)),
        torch.from_numpy(flags.reshape(-1)))
    k = int(total)
    assert k == int(jtotal) == int(flags.sum())
    assert np.array_equal(flat.numpy().view(np.uint16)[:k], np.asarray(jflat)[:k])
    assert np.array_equal(flat.numpy().view(np.uint16)[:k], words[flags > 0])


@pytest.mark.parametrize("steps,lanes", COMPACT_SHAPES + [(1, 8)])
def test_plain_compact_keeps_every_nonzero_flag_byte(steps, lanes):
    """A flag byte is kept when it is not 0 (the rule of ``flags.bool()``
    and of the JAX program's bool mask), so bytes of 2 and 255 count as
    kept: the plain version equals ``torch.masked_select`` and
    ``_compact_global`` on ``flags != 0``."""
    if (steps, lanes) == (1, 8):
        words = np.arange(1000, 1008, dtype=np.uint16).reshape(1, 8)
        flags = np.array([[0, 2, 1, 0, 255, 1, 0, 1]], np.uint8)
    else:
        words, flags = _compact_inputs(
            steps * lanes, steps, lanes, {0: 0.4, 1: 0.2, 2: 0.2, 255: 0.2})
    w = torch.from_numpy(words.view(np.int16).reshape(-1))
    f = torch.from_numpy(flags.reshape(-1))
    flat, total = cuda_kernels.rans_compact(w, f)
    want = torch.masked_select(w, f.bool())
    assert int(total) == want.numel()
    assert torch.equal(flat[: want.numel()], want)
    jflat, jtotal = jrans._compact_global(
        jnp.asarray(words), jnp.asarray(flags != 0), steps, lanes)
    assert int(jtotal) == want.numel()
    assert np.array_equal(np.asarray(jflat)[: int(jtotal)], want.numpy().view(np.uint16))


@pytest.mark.parametrize("lanes", [256, 4096, 16384])
def test_plain_encode_equals_the_xla_program_at_each_lane_tier(lanes):
    """The encode at the lane tiers the v3 path picks, with a ragged last
    row (cells past n code the pad symbol): words where emitted, flags and
    states against ``_encode_kernel``."""
    steps, S = 5, 8
    n = (steps - 1) * lanes + lanes // 3 + 1
    data, pad, freq, cum = _toy(lanes, steps, lanes, n)
    padded = np.full((S, lanes), pad, np.uint8)
    padded.reshape(-1)[:n] = data
    freq_cum = np.stack([freq.astype(np.uint32), cum.astype(np.uint32)])
    emits, emask, jstates = jrans._encode_kernel(
        jnp.asarray(padded), jnp.int32(steps), jnp.asarray(freq_cum), S, lanes
    )
    words, flags, states = cuda_kernels.rans_encode(
        torch.from_numpy(data), steps, lanes, pad,
        torch.from_numpy(freq_cum.astype(np.int32)),
    )
    m = steps * lanes
    emitted = flags.numpy() > 0
    assert np.array_equal(emitted, np.asarray(emask).reshape(-1)[:m])
    assert np.array_equal(
        words.numpy().view(np.uint16)[emitted], np.asarray(emits).reshape(-1)[:m][emitted]
    )
    assert np.array_equal(states.numpy().view(np.uint32), np.asarray(jstates))


def _reachable(f):
    """Dividends of the encode's division at frequency f: after the
    renormalisation, x lies in [min(2^16, 16 f), f 2^20)."""
    return np.minimum(np.uint64(1 << 16), f << np.uint64(4)), f << np.uint64(20)


@pytest.mark.parametrize("where", ["k_f_minus_1", "k_f", "range_ends", "random"])
def test_reciprocal_division_is_exact_for_every_frequency(where):
    """The encode kernel divides the state by a frequency with a per-symbol
    reciprocal (``ops/rans.py:reciprocals``): for every f in 1-4096 the
    quotient and remainder equal ``//`` and ``%`` at multiples of f, one
    below them, the ends of the reachable range and the 32-bit end."""
    f = np.arange(1, 4097, dtype=np.uint64)
    m, l = trans.reciprocals(f)
    assert (m < np.uint64(1 << 32)).all() and (l <= 12).all()
    lo, hi = _reachable(f)
    if where == "random":
        rng = np.random.default_rng(3)
        xs = [lo + (rng.integers(0, 1 << 62, f.size).astype(np.uint64) % (hi - lo))
              for _ in range(64)]
    elif where == "range_ends":
        xs = [lo, lo + np.uint64(1), hi - np.uint64(2), hi - np.uint64(1),
              np.full_like(f, (1 << 32) - 1)]
    else:
        ks = [1, 2, 3, 17, 4095, 1 << 16, (1 << 20) - 1, 1 << 20]
        d = 1 if where == "k_f_minus_1" else 0
        xs = [np.minimum(np.uint64(k) * f - np.uint64(d), np.uint64((1 << 32) - 1))
              for k in ks]
    for x in xs:
        q = trans.reciprocal_div(x, m, l)
        assert np.array_equal(q, x // f)
        assert np.array_equal(x - q * f, x % f)


def test_u32_state_arithmetic_matches_numpy_uint32():
    """The plain versions compute the 32-bit state in int64 and mask:
    ``f*(x>>12)+slot-c`` and ``(x<<16)|w`` against numpy ``uint32`` at
    states up to 2^32-1, one decode step and one encode step."""
    rng = np.random.default_rng(5)
    lanes = 64
    freq = trans.normalize_freqs(_hist(11))
    tab = trans.pack_slot_table(freq)
    x = rng.integers(0, 1 << 32, lanes, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0xFFFFFFFF, 0, 0xFFFF, 0x10000]
    words = rng.integers(0, 1 << 16, lanes, dtype=np.uint32).astype(np.uint16)
    words[0] = 0xFFFF

    slot = x & np.uint32(4095)
    e = tab[slot]
    f, c, sym = (e & 0xFFF) + 1, (e >> 12) & 0xFFF, (e >> 24).astype(np.uint8)
    x1 = (f * (x >> np.uint32(12)) + slot - c).astype(np.uint32)
    need = x1 < 65536
    rank = np.cumsum(need) - need
    want = np.where(need, (x1 << np.uint32(16)) | words[rank].astype(np.uint32), x1)

    out, consumed = trans.rans_decode_plain(
        torch.from_numpy(words.view(np.int16)),
        torch.from_numpy(x.view(np.int32)),
        torch.from_numpy(tab.view(np.int32)), 1, lanes,
    )
    assert np.array_equal(out.numpy(), sym)
    assert int(consumed) == int(need.sum())
    # a second step from the first's states would hide nothing: read the
    # states back through a one-step encode of a symbol with freq f
    data = np.full(lanes, int(np.argmax(freq)), np.uint8)
    fc = np.stack([freq.astype(np.int32), trans.cumulative(freq).astype(np.int32)])
    w, fl, st = trans.rans_encode_plain(
        torch.from_numpy(data), 1, lanes, 0, torch.from_numpy(fc)
    )
    fmax, cmax = np.uint32(freq.max()), np.uint32(trans.cumulative(freq)[np.argmax(freq)])
    x0 = np.full(lanes, 65536, np.uint32)
    assert np.array_equal(
        st.numpy().view(np.uint32), ((x0 // fmax) << np.uint32(12)) + x0 % fmax + cmax
    )
    assert not fl.numpy().any() and np.array_equal(w.numpy(), np.zeros(lanes, np.int16))
    assert want.dtype == np.uint32  # the reference itself stayed in 32 bits


def _corrupt_cases():
    data = _stream(5000, seed=21)
    good = jrans.encode_stream(data)
    tables_end = 8 + 512 + 4 * 256
    (total,) = struct.unpack("<I", good[tables_end : tables_end + 4])
    bad_freq = bytearray(good)
    bad_freq[8:10] = struct.pack("<H", 4095)
    fewer = good[:tables_end] + struct.pack("<I", total - 3) + good[tables_end + 4 : -6]
    more = good[:tables_end] + struct.pack("<I", total + 2) + good[tables_end + 4 :] + bytes(4)
    return {
        "short_header": good[:5],
        "short_tables": good[:600],
        "short_words": good[:-3],
        "bad_freq_sum": bytes(bad_freq),
        "words_missing": fewer,
        "words_left_over": more,
    }


@pytest.mark.parametrize(
    "case", ["short_header", "short_tables", "short_words", "bad_freq_sum",
             "words_missing", "words_left_over"]
)
def test_error_strings_match_jax(case):
    payload = _corrupt_cases()[case]
    with pytest.raises(jrans.RansError) as want:
        jrans.decode_stream(payload)
    with pytest.raises(trans.RansError) as got:
        trans.decode_stream(payload, device="cpu")
    assert str(got.value) == str(want.value)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    data = torch.zeros(10, dtype=torch.uint8)
    fc = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        cuda_kernels.rans_encode(data, 4, 3, 0, fc)
    with pytest.raises(ValueError, match="do not fill"):
        cuda_kernels.rans_encode(data, 1, 4, 0, fc)
    with pytest.raises(TypeError):
        cuda_kernels.rans_compact(data, data)
    with pytest.raises(ValueError, match="lanes"):
        trans.encode_stream(b"abc", lanes=3, device="cpu")
