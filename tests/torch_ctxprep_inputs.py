"""Seeded inputs for the context-pass tests (``test_torch_ctxprep.py`` on the
CPU, ``test_torch_cuda.py`` and ``chip_smoke.py`` on the card) cut at the
tiles of the qctx prepare (:func:`prepare_edge_cases`: runs of
``QCTX_TILE`` delta bytes), of the sctx prepare
(:func:`sctx_prepare_edge_cases`: ``SCTX_TILE`` bases, 16 a thread), of the
layout (:func:`layout_edge_cases`: ``LAYOUT_TILE_STEPS`` steps x
``LAYOUT_TILE_LANES`` lanes) and of the unlayout
(:func:`unlayout_edge_cases`: ``UNLAYOUT_TILE_STEPS`` steps x
``UNLAYOUT_TILE_LANES`` lanes of the decoded matrix).
"""

import numpy as np

from fastqpacker_tpu_torch.ops import ctxprep

Q = ctxprep.QCTX_TILE
S = ctxprep.SCTX_TILE
T = ctxprep.UNLAYOUT_TILE_STEPS
L = ctxprep.UNLAYOUT_TILE_LANES
LT = ctxprep.LAYOUT_TILE_STEPS
LL = ctxprep.LAYOUT_TILE_LANES


def prepare_edge_cases() -> dict:
    """name -> (record lengths, deltas: "zeros" or "uniform"). Records whose
    starts land on a tile edge and one byte either side of it, a record that
    covers a whole tile (a tile with no record start) and records that cross
    tiles, zero-length records at a tile edge, all-zero deltas (every symbol
    of a position bucket on one key) and uniform deltas (more keys than a
    CTA's table holds)."""
    starts = np.array([Q - 1, Q, Q + 1, 3 * Q - 1, 3 * Q + 1], np.int64)
    return {
        "starts_at_tile_edges": (np.diff(np.concatenate([[0], starts, [4 * Q + 40]])), "uniform"),
        "tile_without_a_start": (np.array([5, 2 * Q + 3, 0, 0, Q - 8, 151, 0]), "uniform"),
        "empty_records_at_an_edge": (np.array([Q, 0, 0, 7, Q - 7, 0, 1, 300]), "uniform"),
        "all_zero_deltas": (np.full(3 * Q // 151 + 5, 151), "zeros"),
        "uniform_random_deltas": (np.full(800, 151), "uniform"),
        "long_read": (np.array([37, 70_001, 0, 5, 151]), "uniform"),
        "short_reads": (np.arange(3 * Q // 3) % 5 + 1, "uniform"),
    }


def prepare_stream(case: str, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(lengths int64, delta uint8) of one :func:`prepare_edge_cases` case."""
    lengths, kind = prepare_edge_cases()[case]
    lengths = np.asarray(lengths, np.int64)
    n = int(lengths.sum())
    rng = np.random.default_rng(seed)
    delta = np.zeros(n, np.uint8) if kind == "zeros" else rng.integers(0, 256, n).astype(np.uint8)
    return lengths, delta


def unlayout_edge_cases() -> dict:
    """name -> (record lengths, lanes). Every lane's segment shorter than a
    tile's steps; the longest lane one step past a multiple of them; a lane
    count that is not a multiple of a tile's lanes; a 70,001-bp read (a lane
    of its own over hundreds of tiles); packed bytes whose first base lies
    in one tile and last in the next (records that start 1-3 steps past a
    multiple of 4 before an edge); records of 1-3 bases (more packed bytes
    than a quarter of the steps)."""
    return {
        "segments_shorter_than_a_tile": (np.full(300, 100), 160),
        "steps_one_past_a_tile": (np.array([2 * T + 1] + [60] * 40), 48),
        "lanes_not_a_multiple": (np.tile([20, 41, 0, 33], 1200), 2047),
        "long_read": (np.array([37, 70_001, 0, 5, 151]), 4),
        "packed_bytes_across_tiles": (np.array([1, 2 * T + 9, 2, T - 3, 6, 3, T + 2, 0, 5]), 1),
        "short_records": (np.arange(3000) % 3 + 1, 8),
    }


def unlayout_stream(case: str, model: int, seed: int):
    """(lengths, lanes, symbols uint8) of one :func:`unlayout_edge_cases`
    case: bases 0-3 (model 0) or qualities 0-41 (model 1)."""
    lengths, lanes = unlayout_edge_cases()[case]
    lengths = np.asarray(lengths, np.int64)
    rng = np.random.default_rng(seed)
    n = int(lengths.sum())
    syms = rng.integers(0, 4 if model == 0 else 42, n).astype(np.uint8)
    return lengths, lanes, syms


def run_edges(lengths: np.ndarray, lanes: int) -> list:
    """(t, lane) of the first and the last data cell of a run of the
    longest lane (its first tile) and of the last lane with data: the cells
    a fault is planted on."""
    tab, _, seg = ctxprep.lane_layout(lengths, lanes)
    longest = int(np.argmax(seg))
    last = int(np.flatnonzero(seg)[-1])
    return [(0, longest), (min(T, int(seg[longest])) - 1, longest), (int(seg[last]) - 1, last)]


def sctx_prepare_edge_cases() -> dict:
    """name -> (record lengths, packed bytes: "uniform" or "ones"). Records
    of 0-7 bases (contexts shorter than six bases); records whose first base
    lies 1-15 bases before a thread's 16-base unit and before a tile edge
    (and on them); a 70,001-bp read over several tiles; packed rows whose
    pad bits are all set; two tiles of records of 1 base (the packed shift
    grows by 3 a base, past 2^16)."""
    before = [S - d for d in range(1, 16)] + [16 * 37 - d for d in (1, 7, 15)]
    starts = np.unique(np.array(before + [S, 16 * 37, 2 * S - 9, 2 * S + 1, 3 * S - 15], np.int64))
    return {
        "short_records": (np.arange(9000) % 8, "uniform"),
        "starts_before_units_and_tiles": (np.diff(np.concatenate([[0], starts, [3 * S + 600]])),
                                          "uniform"),
        "long_read": (np.array([37, 70_001, 0, 5, 151]), "uniform"),
        "pad_bits_set": (np.tile([151, 1, 2, 3, 149, 0, 6], 300), "ones"),
        "one_base_records": (np.concatenate([np.full(50, 151), np.ones(2 * S + 40, np.int64),
                                             np.full(20, 33)]), "uniform"),
    }


def sctx_prepare_stream(case: str, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(lengths int64, packed uint8) of one :func:`sctx_prepare_edge_cases`
    case: each record's row from a fresh byte, pad bits random or set."""
    lengths, kind = sctx_prepare_edge_cases()[case]
    lengths = np.asarray(lengths, np.int64)
    m = int(((lengths + 3) >> 2).sum())
    rng = np.random.default_rng(seed)
    if kind == "ones":
        return lengths, np.full(m, 0xFF, np.uint8)
    return lengths, rng.integers(0, 256, m).astype(np.uint8)


def layout_edge_cases() -> dict:
    """name -> (record lengths, lanes). A lane count that is not a multiple
    of a tile's lanes; the longest lane one step past a multiple of a tile's
    steps; every lane's segment shorter than a tile; records that start at a
    tile's first step (one lane of records of a tile's steps, and a lane
    whose second record starts there); reads of 300 bases (model 1 positions
    past the last position bucket, 112)."""
    return {
        "lanes_not_a_multiple": (np.tile([20, 41, 0, 33], 1200), 2047),
        "steps_one_past_a_tile": (np.array([2 * LT + 1] + [60] * 40), 48),
        "segments_shorter_than_a_tile": (np.full(300, 100), 160),
        "starts_at_a_tile_step": (np.array([LT, LT, 2 * LT, 7, LT - 7, LT, 0, 1, 5]), 1),
        "positions_past_112": (np.full(400, 300), 96),
    }


def layout_stream(case: str, model: int, seed: int):
    """(lengths, lanes, symbols uint8) of one :func:`layout_edge_cases`
    case: bases 0-3 (model 0) or qualities 0-60 (model 1)."""
    lengths, lanes = layout_edge_cases()[case]
    lengths = np.asarray(lengths, np.int64)
    rng = np.random.default_rng(seed)
    n = int(lengths.sum())
    syms = rng.integers(0, 4 if model == 0 else 61, n).astype(np.uint8)
    return lengths, lanes, syms
