"""The context-model passes of the port (``ops/ctxprep.py``: the plain
versions of ``fq_qctx_prepare``, ``fq_sctx_prepare``, ``fq_wctx_layout`` and
``fq_wctx_unlayout``) against the JAX package, byte for byte.

The same seeded numpy inputs go to the JAX package's functions (its C++
runtime's prepare passes where the runtime is built, and its numpy
references; its ``wctx`` lane matrices; ``seqctx.pack_stream`` and the
quality delta transform) and to the port's plain versions, which the kernel
wrappers run on CPU tensors. Then whole containers: the port's v3 and
``--mesh`` compress on the CPU, which now run these passes, against the JAX
package's. Every comparison is exact.
"""

import io

import numpy as np
import pytest
import torch

import fastqpacker_tpu as jfq
import fastqpacker_tpu_torch as tfq
from fastqpacker_tpu.ops import qualctx as jqualctx
from fastqpacker_tpu.ops import seqctx as jseqctx
from fastqpacker_tpu.ops import wctx as jwctx
from fastqpacker_tpu.pipeline import native as jnative
from fastqpacker_tpu.runtime import bindings
from fastqpacker_tpu_torch.ops import ctxprep, cuda_kernels
from fastqpacker_tpu_torch.ops import qualctx as pqualctx
from fastqpacker_tpu_torch.ops import seqctx as pseqctx
from fastqpacker_tpu_torch.ops import wctx as pwctx
from torch_ctxprep_inputs import (LL, LT, S, T, layout_edge_cases, layout_stream,
                                  prepare_edge_cases, prepare_stream, run_edges,
                                  sctx_prepare_edge_cases, sctx_prepare_stream,
                                  unlayout_edge_cases, unlayout_stream)
from torch_wctx_inputs import MODELS, one_torch_thread  # noqa: F401  (autouse fixture)
from torch_jax_runtime import jax_runtime_loaded  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# Record lengths of the cases: zero-length reads among others, one record,
# a record longer than 65,536, all empty.
def _lengths(case: str, rng) -> np.ndarray:
    if case == "varlen_with_empty":
        lens = rng.integers(0, 160, 300)
        lens[rng.random(300) < 0.15] = 0
        return lens.astype(np.int64)
    if case == "one_record":
        return np.array([151], np.int64)
    if case == "long_read":
        return np.array([37, 70_001, 0, 5, 151], np.int64)
    if case == "all_empty":
        return np.zeros(7, np.int64)
    raise KeyError(case)


CASES = ["varlen_with_empty", "one_record", "long_read", "all_empty"]


def _prepare_refs(module, stream, lengths):
    """The JAX package's prepare through its runtime (where built) and its
    numpy reference; both must agree."""
    refs = [module.prepare(stream, lengths, use_native=False)]
    if bindings.available():
        refs.append(module.prepare(stream, lengths, use_native=True))
    for raw, hist in refs[1:]:
        assert np.array_equal(raw, refs[0][0]) and np.array_equal(hist, refs[0][1])
    return refs[0]


@pytest.mark.parametrize("case", CASES)
def test_qctx_prepare_equals_jax(case):
    rng = np.random.default_rng(CASES.index(case))
    lengths = _lengths(case, rng)
    delta = rng.integers(0, 256, int(lengths.sum())).astype(np.uint8)
    want_raw, want_hist = _prepare_refs(jqualctx, delta, lengths)
    raw, hist = cuda_kernels.qctx_prepare(_t(delta), _t(ctxprep.record_bounds(lengths)))
    assert hist.dtype == torch.int32 and tuple(hist.shape) == (3072, 256)
    assert np.array_equal(raw.numpy(), want_raw)
    assert np.array_equal(hist.numpy(), want_hist)
    # the stream API on a device: Symbols and the int64 host histogram
    syms, h = pqualctx.prepare(delta, lengths, CPU)
    assert isinstance(syms, ctxprep.Symbols) and len(syms) == len(delta)
    assert np.array_equal(syms.numpy(), want_raw) and np.array_equal(h, want_hist)
    assert h.dtype == np.int64


@pytest.mark.parametrize("case", CASES)
def test_sctx_prepare_equals_jax(case):
    rng = np.random.default_rng(10 + CASES.index(case))
    lengths = _lengths(case, rng)
    packed = rng.integers(0, 256, int(pseqctx.packed_row_lengths(lengths).sum())).astype(np.uint8)
    want_bases, want_hist = _prepare_refs(jseqctx, packed, lengths)
    bases, hist = cuda_kernels.sctx_prepare(
        _t(packed), _t(ctxprep.record_bounds(lengths, True)), int(lengths.sum()))
    assert hist.dtype == torch.int32 and tuple(hist.shape) == (4096, 4)
    assert np.array_equal(bases.numpy(), want_bases)
    assert np.array_equal(hist.numpy(), want_hist)
    syms, h = pseqctx.prepare(packed, lengths, CPU)
    assert np.array_equal(syms.numpy(), want_bases) and np.array_equal(h, want_hist)


def test_prepare_length_mismatches_raise_the_jax_strings():
    lengths = np.array([10, 0, 7], np.int64)
    with pytest.raises(jqualctx.QctxError) as want:
        jqualctx.prepare(np.zeros(16, np.uint8), lengths, use_native=False)
    with pytest.raises(pqualctx.QctxError, match=f"^{want.value}$"):
        pqualctx.prepare(np.zeros(16, np.uint8), lengths, CPU)
    with pytest.raises(jseqctx.SctxError) as want:
        jseqctx.prepare(np.zeros(6, np.uint8), lengths, use_native=False)
    with pytest.raises(pseqctx.SctxError, match=f"^{want.value}$"):
        pseqctx.prepare(np.zeros(6, np.uint8), lengths, CPU)
    if bindings.available():  # the runtime's own strings are the same
        with pytest.raises(ValueError, match=f"^{want.value}$"):
            jseqctx.prepare(np.zeros(6, np.uint8), lengths, use_native=True)
    # no records' worth of bases: the numpy reference does not look at the
    # packed bytes, nor does the device route
    bases, hist = pseqctx.prepare(np.zeros(3, np.uint8), np.zeros(4, np.int64), CPU)
    assert len(bases) == 0 and not hist.any()


@pytest.mark.parametrize("which", ["qual", "seq"])
def test_sample_estimates_on_a_device_equal_the_host_ones(which, monkeypatch):
    """The pre-gates run their prefix through the prepare pass on the
    device; the model-0 histogram is the max model's marginal. Held against
    the JAX package's numpy reference (its runtime's sampled bits are summed
    in another order and may differ in the last unit)."""
    monkeypatch.setattr(bindings, "available", lambda: False)
    rng = np.random.default_rng(21)
    lengths = np.full(3000, 151, np.int64)
    if which == "qual":
        q = np.clip(30 + np.cumsum(rng.integers(-2, 3, int(lengths.sum()))) // 3, 0, 41)
        d = q.reshape(-1, 151).astype(np.int16)
        delta = np.concatenate([d[:, :1], np.diff(d, axis=1) % 256], axis=1)
        delta = delta.astype(np.uint8).reshape(-1)
        kw = dict(max_syms=1 << 16)
        want = jqualctx.sample_estimate(delta, lengths, **kw)
        assert want is not None
        assert pqualctx.sample_estimate(delta, lengths, device=CPU, **kw) == want
    else:
        packed = rng.integers(0, 256, int(pseqctx.packed_row_lengths(lengths).sum()))
        packed = packed.astype(np.uint8)
        kw = dict(max_bases=1 << 17)
        want = jseqctx.sample_estimate(packed, lengths, **kw)
        assert want is not None
        assert pseqctx.sample_estimate(packed, lengths, device=CPU, **kw) == want


def _stream(rng, model, lengths):
    total = int(lengths.sum())
    if model == 0:
        return (np.cumsum(rng.integers(0, 3, total)) % 4).astype(np.uint8)
    return np.clip(30 + np.cumsum(rng.integers(-2, 3, total)) // 2, 0, 60).astype(np.uint8)


@pytest.mark.parametrize("model,order", MODELS)
@pytest.mark.parametrize("lanes", [256, 2048, 8192])
def test_layout_equals_the_jax_lane_matrices(model, order, lanes):
    """Encode: the present-index and context matrices equal
    ``_sym_to_idx(present)[to_matrix(...)]`` and ``context_matrix``, pad
    cells included; decode: the start matrix equals ``start_matrix``. The
    inputs hold zero-length reads, and at 2,048 and 8,192 lanes more lanes
    than records (lanes with no data)."""
    rng = np.random.default_rng(100 * model + 10 * order + lanes % 97)
    lengths = rng.integers(0, 120, 1500).astype(np.int64)
    lengths[rng.random(1500) < 0.1] = 0
    syms = _stream(rng, model, lengths)
    sb, S = jwctx.lane_bounds(lengths, lanes)
    tab, S2, seg = ctxprep.lane_layout(lengths, lanes)
    assert S2 == S and np.array_equal(tab[0], sb) and np.array_equal(seg, np.diff(sb))
    startm = jwctx.start_matrix(lengths, sb, S)
    counts = np.bincount(syms, minlength=256)
    pad = int(np.argmax(counts))
    present = np.flatnonzero(counts > 0)
    symm = jwctx.to_matrix(syms, sb, S, pad)
    ctxm = jwctx.context_matrix(symm, startm, model, order)
    idx = jwctx._sym_to_idx(present)
    bounds = _t(ctxprep.record_bounds(lengths))
    sym_idx, ctx = cuda_kernels.wctx_layout(
        _t(syms), bounds, _t(tab), S, model, order, _t(idx), pad)
    assert np.array_equal(sym_idx.numpy(), idx[symm])
    assert ctx.dtype == torch.int16 and np.array_equal(ctx.numpy(), ctxm)
    start = cuda_kernels.wctx_layout(None, bounds, _t(tab), S, model, order)
    assert np.array_equal(start.numpy(), startm.view(np.uint8))
    if lanes > 256:
        assert (seg == 0).any()  # lanes with no data


@pytest.mark.parametrize("model,order", [(0, 2), (1, 1)])
@pytest.mark.parametrize("lanes", [256, 4096])
def test_unlayout_equals_the_jax_inverse_passes(model, order, lanes):
    """A decoded matrix back in record order: the symbols
    (``present[from_matrix(...)]``), packed rows (``seqctx.pack_stream``) or
    quality deltas (``native._raw_to_delta``); an index >= npres on a data
    cell sets the fault flag, one on a pad cell does not."""
    rng = np.random.default_rng(7 * lanes + model)
    lengths = rng.integers(0, 200, 800).astype(np.int64)
    lengths[::13] = 0
    if lanes == 256:
        lengths[5] = 70_000  # longer than 65,536 (a lane of its own, S = 70,000)
    syms = _stream(rng, model, lengths)
    sb, S = jwctx.lane_bounds(lengths, lanes)
    tab, _, seg = ctxprep.lane_layout(lengths, lanes)
    present = np.flatnonzero(np.bincount(syms, minlength=256) > 0)
    mat = jwctx._sym_to_idx(present)[jwctx.to_matrix(syms, sb, S, int(present[0]))]
    pad_cells = ~(np.arange(S)[:, None] < seg[None, :])
    mat[pad_cells] = 0  # the decoder leaves padding 0
    pres = _t(present.astype(np.uint8))
    args = (_t(ctxprep.record_bounds(lengths)), _t(tab), pres)
    flat, fault = cuda_kernels.wctx_unlayout(_t(mat), *args, ctxprep.UNLAYOUT_FLAT, len(syms))
    assert np.array_equal(flat.numpy(), present.astype(np.uint8)[jwctx.from_matrix(mat, sb)])
    assert np.array_equal(flat.numpy(), syms) and int(fault) == 0
    if model == 0:
        packed, fault = cuda_kernels.wctx_unlayout(
            _t(mat), _t(ctxprep.record_bounds(lengths, True)), _t(tab), pres,
            ctxprep.UNLAYOUT_PACKED, int(pseqctx.packed_row_lengths(lengths).sum()))
        assert packed.numpy().tobytes() == jseqctx.pack_stream(syms, lengths).tobytes()
    else:
        delta, fault = cuda_kernels.wctx_unlayout(
            _t(mat), *args, ctxprep.UNLAYOUT_DELTA, len(syms))
        assert delta.numpy().tobytes() == jnative._raw_to_delta(syms, lengths)
    assert int(fault) == 0
    # a flipped index past the present symbols
    bad = mat.copy()
    t, l = np.argwhere(~pad_cells)[len(syms) // 2]
    bad[t, l] = len(present)
    _, fault = cuda_kernels.wctx_unlayout(_t(bad), *args, ctxprep.UNLAYOUT_FLAT, len(syms))
    assert int(fault) == 1
    if pad_cells.any():
        bad = mat.copy()
        bad[pad_cells] = 255
        _, fault = cuda_kernels.wctx_unlayout(_t(bad), *args, ctxprep.UNLAYOUT_FLAT, len(syms))
        assert int(fault) == 0


def test_flipped_index_raises_corrupted_wctx_stream():
    """The stream API reads the unlayout's fault flag after the decode's
    own checks, with the JAX decoder's string for an index >= npres."""
    rng = np.random.default_rng(5)
    lengths = rng.integers(1, 60, 300).astype(np.int64)
    syms = _stream(rng, 1, lengths)
    payload = pwctx.encode_stream(syms, lengths, 1, 0, lanes=256, device=CPU)
    assert payload == jwctx.encode_stream(syms, lengths, 1, 0, lanes=256)
    p = pwctx.parse_stream(payload)
    wire, info, fault, _ = pwctx.launch_decode(CPU, p, lengths, ctxprep.UNLAYOUT_DELTA)
    assert wire.numpy().tobytes() == jnative._raw_to_delta(syms, lengths) and int(fault) == 0
    assert pwctx.decode_wire(payload, lengths, device=CPU) == jnative._raw_to_delta(syms, lengths)
    real = cuda_kernels.wctx_unlayout

    def flipped(mat, *args):
        mat = mat.clone()
        mat[0, 0] = len(p["present"])
        return real(mat, *args)

    cuda_kernels.wctx_unlayout = flipped
    try:
        with pytest.raises(pwctx.WctxError, match="^corrupted wctx stream$"):
            pwctx.decode_wire(payload, lengths, device=CPU)
    finally:
        cuda_kernels.wctx_unlayout = real


@pytest.mark.parametrize("case", sorted(prepare_edge_cases()))
def test_qctx_prepare_at_tile_edges_equals_jax(case):
    """The qctx prepare's plain version at the kernel's tile edges (record
    starts on and beside them, a tile with no start, all-zero and uniform
    deltas) against the JAX package's prepare."""
    lengths, delta = prepare_stream(case, seed=40 + sorted(prepare_edge_cases()).index(case))
    want_raw, want_hist = _prepare_refs(jqualctx, delta, lengths)
    raw, hist = cuda_kernels.qctx_prepare(_t(delta), _t(ctxprep.record_bounds(lengths)))
    assert np.array_equal(raw.numpy(), want_raw)
    assert np.array_equal(hist.numpy(), want_hist)


@pytest.mark.parametrize("case", sorted(sctx_prepare_edge_cases()))
def test_sctx_prepare_at_tile_edges_equals_jax(case):
    """The sctx prepare's plain version at the kernel's tiles (records of
    0-7 bases, starts 1-15 bases before a thread's 16 bases and a tile
    edge, a 70,001-bp read, pad bits set, a tile of 1-base records)
    against the JAX package's prepare."""
    lengths, packed = sctx_prepare_stream(case, 50 + sorted(sctx_prepare_edge_cases()).index(case))
    want_bases, want_hist = _prepare_refs(jseqctx, packed, lengths)
    bases, hist = cuda_kernels.sctx_prepare(
        _t(packed), _t(ctxprep.record_bounds(lengths, True)), int(lengths.sum()))
    assert np.array_equal(bases.numpy(), want_bases)
    assert np.array_equal(hist.numpy(), want_hist)


@pytest.mark.parametrize("model,order", MODELS)
@pytest.mark.parametrize("case", sorted(layout_edge_cases()))
def test_layout_at_tile_edges_equals_jax(case, model, order):
    """The layout's plain version at the kernel's tiles (2,047 lanes, steps
    one past a tile, segments shorter than a tile, records that start at a
    tile's first step, positions past 112) against the JAX lane matrices:
    ``_sym_to_idx(present)[to_matrix(...)]``, ``context_matrix`` and
    ``start_matrix``, pad cells included."""
    lengths, lanes, syms = layout_stream(case, model, 30 + 10 * model + order)
    sb, steps = jwctx.lane_bounds(lengths, lanes)
    tab, steps2, _ = ctxprep.lane_layout(lengths, lanes)
    assert steps2 == steps and np.array_equal(tab[0], sb)
    startm = jwctx.start_matrix(lengths, sb, steps)
    counts = np.bincount(syms, minlength=256)
    pad = int(np.argmax(counts))
    symm = jwctx.to_matrix(syms, sb, steps, pad)
    idx = jwctx._sym_to_idx(np.flatnonzero(counts > 0))
    bounds = _t(ctxprep.record_bounds(lengths))
    sym_idx, ctx = cuda_kernels.wctx_layout(
        _t(syms), bounds, _t(tab), steps, model, order, _t(idx), pad)
    assert np.array_equal(sym_idx.numpy(), idx[symm])
    assert np.array_equal(ctx.numpy(), jwctx.context_matrix(symm, startm, model, order))
    start = cuda_kernels.wctx_layout(None, bounds, _t(tab), steps, model, order)
    assert np.array_equal(start.numpy(), startm.view(np.uint8))


def _edge_matrix(lengths, lanes, syms):
    """(sb, S, seg, present, decoded matrix): the symbols' present indices
    in their lane cells, 255 (past every present symbol) on the pad cells."""
    sb, S = jwctx.lane_bounds(lengths, lanes)
    tab, S2, seg = ctxprep.lane_layout(lengths, lanes)
    assert S2 == S and np.array_equal(tab[0], sb)
    present = np.flatnonzero(np.bincount(syms, minlength=256) > 0)
    mat = jwctx._sym_to_idx(present)[jwctx.to_matrix(syms, sb, S, int(present[0]))]
    mat[np.arange(S)[:, None] >= seg[None, :]] = 255
    return tab, S, seg, present, mat


@pytest.mark.parametrize("model", [0, 1])
@pytest.mark.parametrize("case", sorted(unlayout_edge_cases()))
def test_unlayout_at_tile_edges_equals_jax(case, model):
    """The unlayout's plain version at the kernel's tile edges against the
    JAX inverse passes: ``present[from_matrix(...)]``, then
    ``seqctx.pack_stream`` (bases) or ``native._raw_to_delta`` (qualities);
    pad cells past the present symbols never fault, an index past them on
    the first or last data cell of a run does."""
    lengths, lanes, syms = unlayout_stream(case, model, 60 + model)
    tab, S, seg, present, mat = _edge_matrix(lengths, lanes, syms)
    pres = _t(present.astype(np.uint8))
    args = (_t(ctxprep.record_bounds(lengths)), _t(tab), pres)
    flat, fault = cuda_kernels.wctx_unlayout(_t(mat), *args, ctxprep.UNLAYOUT_FLAT, len(syms))
    assert np.array_equal(flat.numpy(), present.astype(np.uint8)[jwctx.from_matrix(mat, tab[0])])
    assert np.array_equal(flat.numpy(), syms) and int(fault) == 0
    if model == 0:
        out, fault = cuda_kernels.wctx_unlayout(
            _t(mat), _t(ctxprep.record_bounds(lengths, True)), _t(tab), pres,
            ctxprep.UNLAYOUT_PACKED, int(pseqctx.packed_row_lengths(lengths).sum()))
        assert out.numpy().tobytes() == jseqctx.pack_stream(syms, lengths).tobytes()
    else:
        out, fault = cuda_kernels.wctx_unlayout(
            _t(mat), *args, ctxprep.UNLAYOUT_DELTA, len(syms))
        assert out.numpy().tobytes() == jnative._raw_to_delta(syms, lengths)
    assert int(fault) == 0
    for t, lane in run_edges(lengths, lanes):
        bad = mat.copy()
        bad[t, lane] = len(present)
        _, fault = cuda_kernels.wctx_unlayout(_t(bad), *args, ctxprep.UNLAYOUT_FLAT, len(syms))
        assert int(fault) == 1


def test_edge_inputs_reach_the_tile_edges():
    """The edge cases cut where their names say, at the kernels' tiles."""
    shapes = {}
    for case, (lengths, lanes) in unlayout_edge_cases().items():
        shapes[case] = ctxprep.lane_layout(np.asarray(lengths, np.int64), lanes)
    assert shapes["segments_shorter_than_a_tile"][1] < T
    assert shapes["steps_one_past_a_tile"][1] % T == 1
    assert unlayout_edge_cases()["lanes_not_a_multiple"][1] % ctxprep.UNLAYOUT_TILE_LANES
    assert shapes["long_read"][1] > 200 * T
    q = ctxprep.QCTX_TILE
    starts = ctxprep.record_bounds(prepare_edge_cases()["starts_at_tile_edges"][0])
    assert {q - 1, q, q + 1} <= set(starts.tolist())
    starts = ctxprep.record_bounds(prepare_edge_cases()["tile_without_a_start"][0])
    assert not ((starts >= q) & (starts < 2 * q)).any()
    lengths, delta = prepare_stream("uniform_random_deltas", 0)
    keys = ctxprep.qctx_keys(_t(delta), _t(ctxprep.record_bounds(lengths)))[1]
    assert len(torch.unique(keys)) > 2 * ctxprep.QCTX_TABLE_SLOTS  # the spill path
    # the sctx prepare's tiles: starts 1-15 bases before a 16-base unit and
    # a tile edge, a read over more than four tiles, 1-base records over a tile
    cases = sctx_prepare_edge_cases()
    assert cases["short_records"][0].max() == 7 and not cases["short_records"][0].min()
    starts = set(ctxprep.record_bounds(cases["starts_before_units_and_tiles"][0]).tolist())
    assert {S - d for d in range(1, 16)} | {S, 16 * 37 - 1, 16 * 37 - 15} <= starts
    assert cases["long_read"][0].max() > 4 * S
    assert (cases["pad_bits_set"][0] % 4).any() and cases["pad_bits_set"][1] == "ones"
    assert 3 * (cases["one_base_records"][0] == 1).sum() > 1 << 16
    # the layout's tiles
    layout = {}
    for case, (lengths, lanes) in layout_edge_cases().items():
        layout[case] = ctxprep.lane_layout(np.asarray(lengths, np.int64), lanes)
    assert layout_edge_cases()["lanes_not_a_multiple"][1] % LL
    assert layout["steps_one_past_a_tile"][1] % LT == 1
    assert layout["segments_shorter_than_a_tile"][1] < LT
    starts = ctxprep.record_bounds(layout_edge_cases()["starts_at_a_tile_step"][0])
    assert {LT, 2 * LT, 4 * LT} <= set(starts.tolist())
    assert layout_edge_cases()["positions_past_112"][0].min() > ctxprep.LAYOUT_POSITION_CAP


def test_kernel_geometry_equals_the_source():
    """The tiles the tests cut their inputs at are the kernel source's
    (``csrc/ctxprep.cu``)."""
    import re
    from pathlib import Path

    src = (Path(ctxprep.__file__).parent.parent / "csrc" / "ctxprep.cu").read_text()

    ints = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}

    def const(name):
        m = re.search(rf"constexpr (?:long long|int) {name} = ([^;]+);", src)
        return eval(m.group(1).replace("LL", ""), dict(ints))  # noqa: S307 (the repo's own source)

    assert const("kQTile") == ctxprep.QCTX_TILE
    assert const("kSTile") == ctxprep.SCTX_TILE
    assert const("kLSteps") == ctxprep.LAYOUT_TILE_STEPS
    assert const("kLLanes") == ctxprep.LAYOUT_TILE_LANES
    assert const("kLPosCap") == ctxprep.LAYOUT_POSITION_CAP
    assert const("kUSteps") == ctxprep.UNLAYOUT_TILE_STEPS
    assert const("kULanes") == ctxprep.UNLAYOUT_TILE_LANES
    assert 1 << const("kSlotBits") == ctxprep.QCTX_TABLE_SLOTS


def test_chunk_bounds_equal_jax():
    rng = np.random.default_rng(3)
    for _ in range(200):
        lengths = rng.integers(0, 50, int(rng.integers(0, 40))).astype(np.int64)
        for k in (1, 4, 32, 256):
            assert pqualctx.chunk_bounds(lengths, k) == jqualctx.chunk_bounds(lengths, k)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


def _ctx_fastq(nrec: int, seed: int) -> bytes:
    """Correlated bases and sticky binned qualities: the JAX package codes
    them TAG_SCTX and TAG_QCTX."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 4, nrec)
    m = np.empty((nrec, 151), np.uint8)
    for p in range(151):
        cur = np.where(rng.random(nrec) < 0.62, cur, rng.integers(0, 4, nrec))
        m[:, p] = cur
    levels = np.array([2, 12, 23, 37], np.uint8)
    q = levels[np.clip((np.cumsum(rng.integers(-1, 2, (nrec, 151)), axis=1) // 6) % 4, 0, 3)] + 33
    sym = np.frombuffer(b"ACGT", np.uint8)
    return b"".join(b"@c.%d\n" % i + sym[m[i]].tobytes() + b"\n+\n" + q[i].tobytes() + b"\n"
                    for i in range(nrec))


def _tags(comp: bytes) -> set:
    c = tfq.container
    r = io.BytesIO(comp)
    c.read_file_header(r)
    tags = set()
    while (hdr := c.read_block_header(r, 3)) is not None:
        sizes = hdr.stream_sizes(2)
        p = r.read(sum(sizes))
        tags |= {p[0], p[sizes[0]]}
    return tags


def test_v3_context_coded_container_equals_jax():
    from fastqpacker_tpu.ops import reference as jrefops

    data = _ctx_fastq(700, 1)
    got = tfq.compress_bytes(data, tfq.Options(version=3, workers=1), device="cpu")
    out = io.BytesIO()
    jnative.compress_native(io.BytesIO(data), out, jfq.Options(version=3, workers=1),
                            encode_arrays=jrefops.encode_block_arrays)
    assert got == out.getvalue()
    assert {tfq.container.TAG_SCTX, tfq.container.TAG_QCTX} <= _tags(got)
    assert tfq.decompress_bytes(got, device="cpu") == data


def test_mesh_container_equals_jax_and_decodes_both_ways():
    """``--mesh`` on one CPU entry: the plan's prepare passes, the lane
    matrices of the TAG_WCTX encode and the batched decode's start matrices
    and wire bytes all run the plain versions."""
    from fastqpacker_tpu.parallel import mesh as jmesh
    from fastqpacker_tpu.pipeline import meshpipe as jmeshpipe
    from fastqpacker_tpu_torch.parallel import mesh as pmesh
    from fastqpacker_tpu_torch.pipeline import meshpipe as pmeshpipe
    from fastqpacker_tpu_torch.utils.synth import synth_fastq

    one = len(synth_fastq(0, read_len=100))
    data = synth_fastq(3600 * one / (1 << 20), read_len=100, seed=8,
                       qual_model="phredwalk", seq_model="markov")
    want = jmeshpipe.compress_mesh_bytes(data, jfq.Options(block_size=1800),
                                         jmesh.make_mesh(1))
    mesh = pmesh.make_mesh(1, device="cpu")
    cuda_kernels.reset_launches()
    got = pmeshpipe.compress_mesh_bytes(data, tfq.Options(block_size=1800), mesh)
    assert got == want
    assert tfq.container.TAG_WCTX in _tags(got)
    counts = cuda_kernels.launches.as_dict()
    assert not any(counts.values())  # plain versions: nothing launched on the CPU
    out = io.BytesIO()
    pmeshpipe.decompress_mesh(io.BytesIO(got), out, mesh)
    assert out.getvalue() == data
    assert tfq.decompress_bytes(got, device="cpu") == data  # the per-block route
