#!/usr/bin/env python3
"""Time the order-0 word compaction and variants of its design on one GPU.

Builds ``scripts/compact_variants.cu`` with the package's nvcc flags into
``fastqpacker_tpu_torch/_build/`` (git-ignored) and times, at
``scripts/rans_ab.py --kernel compact``'s streams (the words and flags of
the package's own encodes: the v3 quality and sequence streams, and the
``--mesh`` path's sequence order 2 and quality order 1 streams):

- ``package``: ``fq_rans_compact`` through its wrapper;
- ``single``: one single-pass kernel with decoupled look-back (see the
  source), held against ``torch.masked_select``;
- ``two_pass``: reduce, then scan: the flags read twice, no look-back,
  held against ``torch.masked_select``;
- ``floor``: the single pass without its look-back, each tile's run stored
  at the tile's own first cell (not the compaction): its memory traffic
  alone;
- ``copy``: one PyTorch ``copy_`` moving the same bytes (3 per cell and 2
  per kept word), a yardstick of the memory.

With ``--trace`` each row also carries the timeline of one launch of the
single pass (after the L2 is flushed): per tile the times from its CTA's
start to its ticket, from there to its count (loads and scan), to its
prefix (the look-back, which runs beside the loads) and to its last store,
as percentiles and by tenth of the tiles, and the CTAs in flight.

Inputs, checks and timing are ``chip_smoke.py``'s (CUDA events over calls
queued behind a sleep kernel, inputs rotated past the L2 cache). Prints one
JSON line.

Usage: python3 scripts/compact_variants.py [--trace] [--stream qual|seq|mesh_seq|mesh_qual]
       [--label NAME] [--seed 0] [--iters 200]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import rans_ab

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "scripts/compact_variants.cu"
VARIANTS = {"single": 0, "floor": 1, "two_pass": 2}
TRACE = 3


def load_variants(build) -> ctypes.CDLL:
    """``compact_variants.cu``, built on first use."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(build.NVCC_FLAGS).encode())
    out = build.BUILD_DIR / f"libcompact_variants_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fq_compact_variant.argtypes = [i, p, p, ll, p, p, i, p, p, p, p, p]
    lib.fq_compact_variant.restype = ctypes.c_int
    lib.fq_compact_variant_tile.restype = ctypes.c_int
    return lib


class Variants:
    """Launches of the variants on one stream's inputs, with their scratch:
    the ticket, the status words (one epoch per launch) and the counts."""

    def __init__(self, lib, m: int, dev):
        import torch

        self.lib, self.m = lib, m
        tiles = -(-m // lib.fq_compact_variant_tile())
        self.tiles = tiles
        self.ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.status = torch.zeros((tiles + -(-tiles // 32),), dtype=torch.int64, device=dev)
        self.counts = torch.empty((tiles,), dtype=torch.int32, device=dev)
        self.epoch = 0

    def run(self, variant: int, trace=None):
        import torch

        def call(w, f):
            out = torch.empty_like(w)
            total = torch.empty((1,), dtype=torch.int64, device=w.device)
            self.epoch += 1
            rc = self.lib.fq_compact_variant(
                variant, w.data_ptr(), f.data_ptr(), self.m, self.ticket.data_ptr(),
                self.status.data_ptr(), self.epoch, self.counts.data_ptr(), out.data_ptr(),
                total.data_ptr(), None if trace is None else trace.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"fq_compact_variant({variant}) failed: cudaError_t {rc}")
            return out, total
        return call


def trace_launch(v: Variants, words, flags, want) -> dict:
    """One traced launch of the single pass on a flushed L2, checked against
    ``want``, summarised."""
    import torch

    trace = torch.zeros((v.tiles, 6), dtype=torch.int64, device=words.device)
    flush = torch.empty((150_000_000,), dtype=torch.uint8, device=words.device)
    for _ in range(3):  # the last one counts
        flush.zero_()
        out, total = v.run(TRACE, trace)(words, flags)
    k = want.numel()
    if int(total) != k or not torch.equal(out[:k], want):
        raise RuntimeError("the traced single pass != masked_select")
    tr = trace.cpu().numpy()
    first = tr[:, 5].min()
    parts = {"ticket": tr[:, 0] - tr[:, 5], "count": tr[:, 1] - tr[:, 0],
             "prefix_after_count": tr[:, 2] - tr[:, 1], "store": tr[:, 3] - tr[:, 2],
             "life": tr[:, 3] - tr[:, 5], "start": tr[:, 5] - first}
    span = int(tr[:, 3].max() - first)
    tenths = np.array_split(np.arange(v.tiles), 10)
    return {
        "span_ns": span, "tiles": v.tiles, "sms": int(len(np.unique(tr[:, 4]))),
        "in_flight": float(parts["life"].sum() / span),
        "percentiles_10_50_90_100": {
            name: [float(np.percentile(a, q)) for q in (10, 50, 90, 100)]
            for name, a in parts.items()},
        "by_tenth_mean": {name: [float(a[ix].mean()) for ix in tenths]
                          for name, a in parts.items()},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stream", action="append",
                    choices=sorted({**rans_ab.STREAMS, **rans_ab.MESH_STREAMS}))
    ap.add_argument("--label", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("compact_variants: no CUDA device", file=sys.stderr)
        return 1
    from fastqpacker_tpu_torch.ops import build
    from fastqpacker_tpu_torch.ops import cuda_kernels as ck
    from fastqpacker_tpu_torch.ops import rans, wctx

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    build.load("rans_codec")
    lib = load_variants(build)
    rows = []
    labels = [*rans_ab.STREAMS, *rans_ab.MESH_STREAMS]
    for n, label in enumerate(labels):
        if args.stream and label not in args.stream:
            continue
        rng = np.random.default_rng(args.seed + n)
        words, flags, lanes, steps = rans_ab.compact_inputs(cs, ck, rans, wctx, label, rng)
        m = words.numel()
        v = Variants(lib, m, words.device)
        want = cs.library_compact(words, flags)
        k = want.numel()
        for name in ("single", "two_pass"):
            flat, total = v.run(VARIANTS[name])(words, flags)
            if int(total) != k or not torch.equal(flat[:k], want):
                raise RuntimeError(f"{name} != masked_select at {label}")
        sets = cs.rotations((words, flags), 3 * m + 2 * k)
        times = {"package": cs.gpu_ms(ck.rans_compact, sets, args.iters)}
        for name, variant in VARIANTS.items():
            times[name] = cs.gpu_ms(v.run(variant), sets, args.iters)
        times["copy"] = cs.copy_ms(3 * m + 2 * k, args.iters)
        bound_ms, _ = cs.bound(3 * m + 2 * k + 8, 4 * m)
        rows.append({"stream": label, "lanes": lanes, "steps": steps, "cells": m, "words": k,
                     "tile": lib.fq_compact_variant_tile(), "bound_ms": bound_ms,
                     **{f"{name}_ms": ms for name, ms in times.items()}})
        if args.trace:
            rows[-1]["trace"] = trace_launch(v, words, flags, want)
        del words, flags, sets, want, flat
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label or "compact_variants", "card": cs.nvidia_smi(),
                      "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
