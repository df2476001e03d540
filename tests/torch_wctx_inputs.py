"""Shared inputs of the port's context-coder tests (numpy only).

Seeded symbol streams, and the function that carries the JAX package's
arrays (``symm``, ``ctxm`` or ``startm``, ``seg``, ``freq_p``, ``present``)
across to the tensors that the port's plain versions and kernels take, so
that both packages run on the same arrays.
"""

import numpy as np
import pytest
import torch

MODELS = [(0, 2), (0, 4), (0, 6), (1, 0), (1, 1)]  # (model, order)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions are loops of small tensor operations: torch's
    thread pool only adds hand-offs, and beside other test processes it
    oversubscribes the cores. Test files import this fixture."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rand_lengths(rng, n, lo=0, hi=80):
    return rng.integers(lo, hi, n).astype(np.int64)


def seq_syms(rng, total):
    """Order-1 Markov base codes (a context model has something to find)."""
    u = rng.random(total)
    step = np.searchsorted(np.cumsum([0.45, 0.25, 0.17, 0.13]), u)
    return (np.cumsum(np.minimum(step, 3)) % 4).astype(np.uint8)


def walk_quals(rng, total, hi=50):
    return np.clip(
        30 + np.cumsum(rng.integers(-2, 3, total)) // 2, 0, hi
    ).astype(np.uint8)


def symbols(rng, model, lengths):
    total = int(lengths.sum())
    return seq_syms(rng, total) if model == 0 else walk_quals(rng, total)


def device_table(freq_p: np.ndarray) -> np.ndarray:
    """(C, npres) u16 freqs -> (C, npres + 1) int16 cumulative table with
    the row total in the last column (written out here, independent of the
    port's ``wctx.device_table``)."""
    C, npres = freq_p.shape
    tab = np.zeros((C, npres + 1), np.int64)
    for j in range(npres):
        tab[:, j + 1] = tab[:, j] + freq_p[:, j]
    return tab.astype(np.int16)


def encode_tensors(symm, ctxm, seg, freq_p, present, device="cpu"):
    """JAX-side encode inputs (raw-valued ``symm``) -> the port's
    ``(sym, ctx, seg, tab)`` tensors."""
    idx = np.zeros(256, np.uint8)
    idx[present] = np.arange(len(present), dtype=np.uint8)
    return (
        torch.from_numpy(np.ascontiguousarray(idx[symm])).to(device),
        torch.from_numpy(ctxm.astype(np.int16)).to(device),
        torch.from_numpy(np.asarray(seg, np.int32)).to(device),
        torch.from_numpy(device_table(freq_p)).to(device),
    )


def decode_tensors(words, states, startm, seg, freq_p, present, device="cpu"):
    """JAX-side decode inputs -> the port's ``(words, states, startm, seg,
    tab, present)`` tensors."""
    return (
        torch.from_numpy(np.asarray(words).astype("<u2").view(np.int16)).to(device),
        torch.from_numpy(np.asarray(states).astype(np.uint32).view(np.int32)).to(device),
        torch.from_numpy(np.ascontiguousarray(startm).view(np.uint8)).to(device),
        torch.from_numpy(np.asarray(seg, np.int32)).to(device),
        torch.from_numpy(device_table(freq_p)).to(device),
        torch.from_numpy(np.asarray(present).astype(np.uint8)).to(device),
    )


def full_tables(freq_p, present):
    """(C, 256) u32 freq and exclusive cum, as the JAX package's numpy
    reference walks take them."""
    freq = np.zeros((freq_p.shape[0], 256), np.uint32)
    freq[:, present] = freq_p
    cum = np.zeros_like(freq)
    np.cumsum(freq[:, :-1], axis=1, out=cum[:, 1:])
    return freq, cum
