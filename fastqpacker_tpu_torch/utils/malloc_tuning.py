"""glibc malloc tuning for high-throughput buffer churn.

The port's copy of ``fastqpacker_tpu/utils/malloc_tuning.py``. On hosts
where first-touch page faults are expensive (virtualized or
memory-encrypted machines), glibc's default behavior — serving every large
allocation from a fresh ``mmap`` and returning it to the OS on free — makes
each per-block buffer allocation cost orders of magnitude more than the
compute on it. Raising ``M_MMAP_THRESHOLD`` and ``M_TRIM_THRESHOLD`` keeps
large buffers on the (warm, reused) heap: the allocator-level equivalent of
the reference's ``sync.Pool`` block-buffer reuse
(internal/compress/compress.go:42-52).

Idempotent; call :func:`tune` before the pipeline allocates.
"""

from __future__ import annotations

import ctypes

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_ARENA_MAX = -8

_done = False


def tune(threshold_bytes: int = 1 << 30) -> bool:
    """Apply mallopt tuning once; returns True if it took effect."""
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, threshold_bytes)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, threshold_bytes)
        # One arena: per-thread arenas would mmap fresh (cold) regions,
        # defeating heap reuse for worker threads.
        libc.mallopt(_M_ARENA_MAX, 1)
        _done = bool(ok1 and ok2)
    except OSError:
        _done = False
    return _done


def warm_heap(nbytes: int, threads: int | None = None) -> None:
    """Pre-fault a contiguous heap region so later allocations reuse it.

    First-touch faults are kernel page-zeroing work charged to the
    faulting core (it can fall to tens of MB/s per core when transparent
    huge pages hand out 2 MB folios), so the touch loop is fanned out over
    ``threads`` GIL-releasing ``memset`` calls — one per core — instead
    of a single serial numpy stride write.
    """
    import os

    import numpy as np

    buf = np.empty(nbytes, dtype=np.uint8)
    if threads is None:
        threads = min(os.cpu_count() or 1, 4)
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        buf[::4096] = 1
        return
    base = buf.ctypes.data
    if threads <= 1 or nbytes < (16 << 20):
        libc.memset(ctypes.c_void_p(base), 0, ctypes.c_size_t(nbytes))
        return
    from concurrent.futures import ThreadPoolExecutor

    chunk = -(-nbytes // threads) & ~0xFFF  # page-aligned split
    spans = [
        (base + off, min(chunk, nbytes - off))
        for off in range(0, nbytes, chunk)
    ]
    with ThreadPoolExecutor(len(spans)) as pool:
        list(
            pool.map(
                lambda s: libc.memset(
                    ctypes.c_void_p(s[0]), 0, ctypes.c_size_t(s[1])
                ),
                spans,
            )
        )
