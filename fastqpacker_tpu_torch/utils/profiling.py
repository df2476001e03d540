"""Profiling hooks: ``torch.profiler`` traces + wall-clock stage timing.

The port's twin of ``fastqpacker_tpu/utils/profiling.py``:

- :func:`trace`: context manager around ``torch.profiler.profile`` (CPU
  activity, and CUDA activity when a card is in use) writing a
  TensorBoard-loadable trace (``fqpack bench --profile DIR``). Every kernel
  wrapper names its launch with ``record_function`` (``fq_dense_encode``,
  ...), so the trace shows which wrapper launched each device kernel.
- :class:`StageTimer`: lightweight accumulating wall-clock timer for
  pipeline stages, printed as a journal-ready table.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict


@contextlib.contextmanager
def trace(log_dir: str | None, cuda: bool | None = None):
    """``torch.profiler`` trace into ``log_dir`` (no-op when None). CUDA
    activity is traced when ``cuda`` is true (default: when a card is
    present)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    print(f"profile trace written to {log_dir}", file=sys.stderr)


class StageTimer:
    """Accumulate wall-clock per named stage; print a summary table."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, out=None) -> None:
        out = out or sys.stderr
        total = sum(self.totals.values()) or 1.0
        print("stage timing:", file=out)
        for name, t in sorted(
            self.totals.items(), key=lambda kv: -kv[1]
        ):
            print(
                f"  {name:<24} {t:8.3f}s  {100 * t / total:5.1f}%  "
                f"x{self.counts[name]}",
                file=out,
            )
