"""What the v3 context coders (:mod:`.qualctx`, :mod:`.seqctx`) share with
their kernels (``csrc/ctxcoder.cu``): the chunking of a stream, the host
plan a coder call passes, the coders' table entries, the shape of the
kernels' outputs and the host steps around a launch.

A stream is :data:`NUM_CHUNKS` record-aligned chunks
(:func:`chunk_bounds_arrays`), each coded by :data:`NUM_STATES` interleaved
32-bit rANS states (symbol t of a chunk belongs to state t % 4): 16 encode
chains, 4 decode chains. The plan (:func:`coder_plan`) is the int64 layout
the kernels' ``EncodePlan`` / ``DecodePlan`` read; ``PLAN_*`` are its
offsets, the source's ``kPlan*``.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import rans
from .device import to_device

NUM_CHUNKS = 4
NUM_STATES = 4
CHAINS = NUM_CHUNKS * NUM_STATES
RANS_L = rans.RANS_L
PROB_SCALE = rans.PROB_SCALE

# The plan's int64 words: the chunks' record and symbol bounds, each chunk's
# first word and word count, the 16 states, each chunk's first packed byte
# (sctx).
PLAN_RB, PLAN_SB, PLAN_WSTART, PLAN_WCOUNT, PLAN_STATES, PLAN_PSTART = 0, 5, 10, 14, 18, 34
PLAN_WORDS = 39


def chunk_bounds_arrays(
    lengths: np.ndarray, num_chunks: int = NUM_CHUNKS
) -> tuple[np.ndarray, np.ndarray]:
    """Record-aligned chunk boundaries balanced by symbol count, as two
    int64 arrays (records, symbols) of ``num_chunks + 1``, computed without a
    loop over the chunks (a wctx stream has up to 8,192 lanes): each boundary
    is the record after the one that holds symbol ``total * k // num_chunks``,
    clamped to the record count and to the boundary before it."""
    lengths = lengths.astype(np.int64)
    csum = np.cumsum(lengths)
    total = int(csum[-1]) if len(csum) else 0
    n = len(lengths)
    if total:
        targets = total * np.arange(1, num_chunks, dtype=np.int64) // num_chunks
        b = np.searchsorted(csum, targets, side="left") + 1
    else:
        b = np.zeros(num_chunks - 1, np.int64)
    rb = np.empty(num_chunks + 1, np.int64)
    rb[0] = 0
    rb[1:-1] = np.maximum.accumulate(np.minimum(b, n))
    rb[-1] = n
    sb = np.concatenate(([0], csum))[rb]
    return rb, sb


def coder_plan(lengths: np.ndarray, counts=None, states=None) -> torch.Tensor:
    """The host plan of a stream of records of ``lengths``: with the
    payload's per-chunk word ``counts`` and (4, 4) ``states`` for a decode.
    A CPU int64 tensor (the launchers read it on the host)."""
    lengths = np.asarray(lengths, np.int64)
    rb, sb = chunk_bounds_arrays(lengths)
    plan = np.zeros(PLAN_WORDS, np.int64)
    plan[PLAN_RB : PLAN_RB + 5] = rb
    plan[PLAN_SB : PLAN_SB + 5] = sb
    if counts is not None:
        counts = np.asarray(counts, np.int64)
        plan[PLAN_WSTART + 1 : PLAN_WSTART + 4] = np.cumsum(counts[:-1])
        plan[PLAN_WCOUNT : PLAN_WCOUNT + 4] = counts
        plan[PLAN_STATES : PLAN_STATES + CHAINS] = np.asarray(states, np.uint32).reshape(-1)
    pcum = np.concatenate(([0], np.cumsum((lengths + 3) >> 2)))
    plan[PLAN_PSTART : PLAN_PSTART + 5] = pcum[rb]
    return torch.from_numpy(plan).clone()


# ---------------------------------------------------------------------------
# table entries
# ---------------------------------------------------------------------------


def entry_table(freq: np.ndarray) -> np.ndarray:
    """(contexts, symbols) uint32 coder entries ``f << 16 | cum`` (the qctx
    decode's table)."""
    f = freq.astype(np.uint32)
    cum = np.zeros_like(f)
    np.cumsum(f[:, :-1], axis=1, out=cum[:, 1:])
    return (f << 16) | cum


def _reciprocals() -> np.ndarray:
    """m of ``floor(x / f) = (x + umulhi(x, m)) >> s`` for f = 0..4096 (0 at
    f = 0): ``m = ceil(2**(32 + s) / f) - 2**32``, ``s = ceil(log2 f)``
    (``fqruntime.cpp:1659-1672``, exact for x < 2**32)."""
    m = [0] + [((1 << (32 + (f - 1).bit_length())) + f - 1) // f - (1 << 32)
               for f in range(1, PROB_SCALE + 1)]
    return np.array(m, np.uint64)


_RECIPROCALS = _reciprocals()


def encode_table(freq: np.ndarray) -> np.ndarray:
    """(contexts, symbols) uint64 encode entries: :func:`entry_table`'s
    ``f << 16 | cum`` below and the reciprocal of f above (the encode
    kernels' one load a symbol)."""
    return (_RECIPROCALS[freq] << np.uint64(32)) | entry_table(freq).astype(np.uint64)


def _f_cum(entries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (entries >> 16).astype(np.uint16), (entries & 0xFFFF).astype(np.uint32)


def split_encode_table(tab: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(f, cum) of an :func:`encode_table` as an int64 tensor."""
    return _f_cum(tab.numpy().view(np.uint64) & 0xFFFFFFFF)


def split_entry_table(tab: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(f, cum) of an :func:`entry_table` as an int32 tensor."""
    return _f_cum(tab.numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# the kernels' outputs from the plain versions' per-chunk walks
# ---------------------------------------------------------------------------


def chain_outputs(n: int, plan: torch.Tensor, walk) -> tuple:
    """The encode kernels' outputs from a per-chunk ``walk(k, lo, hi,
    words, flags)`` -> states or None: (words int16 (n,), flags uint8 (n,),
    states int32 (16,), counts int64 (16,), a chain's count -1 at a fault)."""
    sb = plan.numpy()[PLAN_SB : PLAN_SB + 5]
    words = np.zeros(n, np.uint16)
    flags = np.zeros(n, np.uint8)
    states = np.full(CHAINS, RANS_L, np.uint32)
    counts = np.zeros(CHAINS, np.int64)
    for k in range(NUM_CHUNKS):
        lo, hi = int(sb[k]), int(sb[k + 1])
        xs = walk(k, lo, hi, words, flags)
        if xs is None:
            counts[NUM_STATES * k : NUM_STATES * (k + 1)] = -1
            break
        states[NUM_STATES * k : NUM_STATES * (k + 1)] = xs
        for si in range(NUM_STATES):
            counts[NUM_STATES * k + si] = int(flags[lo + si : hi : NUM_STATES].sum())
    return (torch.from_numpy(words.view(np.int16)), torch.from_numpy(flags),
            torch.from_numpy(states.view(np.int32)), torch.from_numpy(counts))


def decode_chunks(plan: torch.Tensor, words: torch.Tensor, walk, trailing) -> torch.Tensor:
    """The decode kernels' (4, 2) int64 info from a per-chunk ``walk(k,
    state, words) -> (used, code, j)``: each chunk's first fault (code,
    symbol index), a trailing fault (code 3) where ``trailing`` and words
    are left over. Chunks after a faulting one are not walked (their info
    stays 0)."""
    p = plan.numpy()
    w = words.numpy().view(np.uint16)
    info = np.zeros((NUM_CHUNKS, 2), np.int64)
    for k in range(NUM_CHUNKS):
        a, nw = int(p[PLAN_WSTART + k]), int(p[PLAN_WCOUNT + k])
        state = p[PLAN_STATES + 4 * k : PLAN_STATES + 4 * k + 4]
        used, code, j = walk(k, state, w[a : a + nw])
        if not code and trailing and used != nw:
            code = 3
        info[k] = code, j
        if code:
            break
    return torch.from_numpy(info)


# ---------------------------------------------------------------------------
# the host steps around a launch
# ---------------------------------------------------------------------------


class PendingEncode:
    """An encode launched on its device (the kernel, then the compaction):
    :meth:`result` reads it back -> ((4, 4) states, the chunks' word runs),
    or raises ``error`` where a present symbol has no frequency."""

    def __init__(self, out: tuple | None, total: torch.Tensor | None, error):
        self.out, self.total, self.error = out, total, error

    def result(self) -> tuple[np.ndarray, list[np.ndarray]]:
        if self.out is None:  # no symbols: nothing was launched
            return (np.full((NUM_CHUNKS, NUM_STATES), RANS_L, np.uint32),
                    [np.zeros(0, np.uint16)] * NUM_CHUNKS)
        words, states, counts = self.out
        head = torch.cat([states.to(torch.int64), counts, self.total]).cpu().numpy()
        counts = head[CHAINS : 2 * CHAINS]
        if (counts < 0).any():
            raise self.error
        total = int(head[-1])
        flat = words[:total].cpu().numpy().view(np.uint16)
        per = counts.reshape(NUM_CHUNKS, NUM_STATES).sum(axis=1)
        runs = np.split(flat, np.cumsum(per)[:-1])
        states = (head[:CHAINS] & 0xFFFFFFFF).astype(np.uint32)
        return states.reshape(NUM_CHUNKS, NUM_STATES), runs


def launch_encode(kernel, syms, lengths: np.ndarray, freq: np.ndarray, arg: int,
                  error) -> PendingEncode:
    """Launch ``kernel`` (``cuda_kernels.qctx_encode`` / ``sctx_encode``) on
    the prepared :class:`.ctxprep.Symbols` where they lie, with the
    :func:`encode_table` of ``freq``, then ``fq_rans_compact`` on its words
    and flags; reads nothing back."""
    from . import cuda_kernels

    if len(syms) == 0:
        return PendingEncode(None, None, error)
    dev = syms.tensor.device
    words, flags, states, counts = kernel(
        syms.on(dev), syms.starts_on(dev, lengths), coder_plan(lengths),
        to_device(dev, encode_table(freq).view(np.int64)), arg)
    out, total = cuda_kernels.rans_compact(words, flags)
    return PendingEncode((out, states, counts), total, error)


def raise_fault(info: torch.Tensor, faults: dict, error) -> None:
    """Raise the fault of the lowest chunk that has one (the references
    decode chunk 0 to its end before chunk 1)."""
    for code, _ in info.cpu().numpy().reshape(-1, 2):
        if code:
            raise error(faults[int(code)])


def read_chunk_heads(buf: memoryview, off: int, nchunks: int, truncated) -> tuple:
    """The payload's per-chunk states and word counts at ``off`` -> ((4, 4)
    uint32 states, word counts, the offset past them)."""
    states, counts = [], []
    step = 4 * NUM_STATES + 4
    for _ in range(nchunks):
        if len(buf) < off + step:
            raise truncated
        states.append(np.frombuffer(buf[off : off + 4 * NUM_STATES], "<u4").astype(np.uint32))
        (nw,) = struct.unpack_from("<I", buf, off + 4 * NUM_STATES)
        counts.append(nw)
        off += step
    return np.stack(states), counts, off
