#!/usr/bin/env python3
"""Time the order-0 rANS kernels or the CRC32 kernel of one checkout of the port on one GPU.

Imports ``fastqpacker_tpu_torch`` from ``--root`` (a checkout of the repo,
for example the parent commit unpacked with ``git archive`` into a
git-ignored directory), builds the source of ``--kernel`` and times it at
the FQZ v3 path's shapes: a block's quality stream (15.1 MB of walk-like
deltas, 16,384 lanes) and its packed sequence stream (3.8 MB, 4,096 lanes).

- ``--kernel decode`` (the default): ``fq_rans_decode`` of
  ``csrc/rans_codec.cu``. The streams come from ``--seed`` and are encoded
  by the checkout's own kernels, so two checkouts decode the same words;
  each run holds the kernels against the plain versions and checks
  decode(encode(x)) == x.
- ``--kernel encode``: ``fq_rans_encode`` on the same streams, held against
  the plain version; each row carries the per-step time and a SHA-256 of
  the kernel's words (where flagged), flags and states, so two checkouts'
  outputs can be compared byte for byte.
- ``--kernel crc32``: ``fq_crc32_chunks`` of ``csrc/crc32.cu`` on seeded
  random bytes of the two streams' lengths, held against ``zlib.crc32``.
- ``--kernel compact``: ``fq_rans_compact`` on the words and flags of the
  checkout's own encodes: the two streams above (``fq_rans_encode``) and the
  ``--mesh`` path's two (``fq_wctx_encode`` of 100,000 records of 151 bp:
  ``mesh_seq``, sequence order 2 on 4,096 lanes, and ``mesh_qual``, quality
  order 1 on 2,048 lanes). Each row holds the kernel against
  ``torch.masked_select``, carries a SHA-256 of ``out[:total]`` and
  ``total`` (equal for two checkouts), the device operations of one call
  (``torch.profiler``), the bound and ``masked_select``'s time.

The inputs and the timing are ``chip_smoke.py``'s phase kernels (CUDA
events over launches queued behind a sleep kernel, inputs rotated past the
L2 cache).

Compare two designs inside one call, in turns: parent, change, change,
parent. ``--set NAME=VALUE`` first rewrites ``constexpr int NAME = ...;`` in
the checkout's kernel source, so a copy of the tree times a variant of one
constant: for the decode ``kCtaThreads=1024`` gives 16 CTAs x 1,024 threads
with one lane each at 16,384 lanes, and adding ``kMaxCluster=1`` one CTA of
1,024 threads with 16 lanes each (the staged word ring without a cluster);
for the CRC ``kChunk`` or ``kThreads``. It refuses to edit this repository's
own source. ``--stream`` picks the streams (both by default). Prints one JSON
line per run, with the decode's launch geometry and registers where the
checkout reports them.

Usage: python3 scripts/rans_ab.py --root DIR [--kernel decode|encode|crc32|compact]
       [--set NAME=VALUE] [--stream qual|seq|mesh_seq|mesh_qual] [--label NAME]
       [--seed 0] [--iters 20]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
from wctx_ab import set_constants

REPO = Path(__file__).resolve().parent.parent
STREAMS = {"qual": 16384, "seq": 4096}  # lanes of each stream
# the compaction's streams from the --mesh path: (model, order) of the
# wctx encode (its lanes are the ones the mesh path picks)
MESH_STREAMS = {"mesh_seq": (0, 2), "mesh_qual": (1, 1)}


def compact_inputs(cs, ck, rans, wctx, label: str, rng):
    """One stream's (words, flags, lanes, steps) from the checkout's own
    encode on the card."""
    if label in MESH_STREAMS:
        model, order = MESH_STREAMS[label]
        syms = cs.corpus_symbols(rng, model, cs.BLOCK_RECORDS, cs.READ_LEN)
        lengths = np.full(cs.BLOCK_RECORDS, cs.READ_LEN, np.int64)
        prep = cs.wctx_prep(wctx, syms, lengths, model, order)
        words, flags, _, status = ck.wctx_encode(*prep["enc"])
        if int(status) != 0:
            raise RuntimeError(f"wctx encode status {int(status)} at {label}")
        lanes, steps = prep["lanes"], prep["S"]
    else:
        lanes = STREAMS[label]
        data = (cs.walk_deltas(rng, cs.QUAL_STREAM) if label == "qual"
                else rng.integers(0, 256, cs.SEQ_STREAM).astype(np.uint8))
        case = cs.rans_case(ck, rans, data, lanes)  # kernels == plain, round trip
        words, flags = case["cmp"]
        steps = case["steps"]
    return words, flags, lanes, steps


def compact_row(cs, ck, rans, wctx, label: str, rng, iters: int) -> dict:
    """One stream's words and flags from the checkout's encode, compacted
    and timed (see the module docstring)."""
    import torch

    words, flags, lanes, steps = compact_inputs(cs, ck, rans, wctx, label, rng)
    flat, total = ck.rans_compact(words, flags)
    k = int(total)
    if not torch.equal(flat[:k], cs.library_compact(words, flags)):
        raise RuntimeError(f"compact kernel != masked_select at {label}")
    digest = hashlib.sha256(flat[:k].cpu().numpy().tobytes())
    digest.update(total.cpu().numpy().tobytes())
    m = words.numel()
    ops = cs.device_ops(lambda: ck.rans_compact(words, flags))
    sets = cs.rotations((words, flags), 3 * m + 2 * k)
    ms = cs.gpu_ms(ck.rans_compact, sets, iters)
    lib_ms = cs.gpu_ms(cs.library_compact, sets, iters)
    bound_ms, bound_by = cs.bound(3 * m + 2 * k + 8, 4 * m)
    return {"stream": label, "lanes": lanes, "steps": steps, "cells": m, "words": k,
            "compact_ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / ms, "masked_select_ms": lib_ms,
            "device_ops_per_call": len(ops), "op_names": ops,
            "outputs_sha256": digest.hexdigest()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--kernel", choices=["decode", "encode", "crc32", "compact"],
                    default="decode")
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    ap.add_argument("--stream", action="append", choices=sorted({**STREAMS, **MESH_STREAMS}))
    ap.add_argument("--label", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    source = "crc32" if args.kernel == "crc32" else "rans_codec"
    if args.set:
        set_constants(root / f"fastqpacker_tpu_torch/csrc/{source}.cu", args.set)
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("rans_ab: no CUDA device", file=sys.stderr)
        return 1
    from fastqpacker_tpu_torch.ops import build
    from fastqpacker_tpu_torch.ops import cuda_kernels as ck
    from fastqpacker_tpu_torch.ops import rans, wctx

    imported = Path(build.__file__).resolve()
    if root not in imported.parents:
        raise RuntimeError(f"imported {imported}, not the checkout under {root}")
    # chip_smoke.py of this checkout: inputs, checks and timing
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    build.load(source)
    registers = cs.rans_decode_registers(build.builds["rans_codec"].log) if source == "rans_codec" else {}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    geometry = getattr(ck, "rans_decode_geometry", None)
    rows = []
    labels = [*STREAMS, *MESH_STREAMS] if args.kernel == "compact" else list(STREAMS)
    for i, label in enumerate(labels):
        if args.stream and label not in args.stream:
            continue
        rng = np.random.default_rng(args.seed + i)
        if args.kernel == "compact":
            rows.append(compact_row(cs, ck, rans, wctx, label, rng, args.iters))
            torch.cuda.empty_cache()
            continue
        lanes = STREAMS[label]
        if args.kernel == "crc32":
            n = cs.QUAL_STREAM if label == "qual" else cs.SEQ_STREAM
            data = rng.integers(0, 256, n).astype(np.uint8)
            t = torch.from_numpy(data).to("cuda")
            got = int(ck.crc32_chunks(t).item()) & 0xFFFFFFFF
            if got != zlib.crc32(data.tobytes()):
                raise RuntimeError(f"CRC32 kernel != zlib at n={n}")
            ms = cs.gpu_ms(ck.crc32_chunks, cs.rotations((t,), n), args.iters)
            rows.append({"stream": label, "bytes": n, "crc32_ms": ms})
            del t
            continue
        data = (cs.walk_deltas(rng, cs.QUAL_STREAM) if label == "qual"
                else rng.integers(0, 256, cs.SEQ_STREAM).astype(np.uint8))
        case = cs.rans_case(ck, rans, data, lanes)  # kernels == plain, round trip
        steps, k = case["steps"], case["total"]
        if args.kernel == "encode":
            d, *rest = case["enc"]
            words, flags, states = ck.rans_encode(d, *rest)
            digest = hashlib.sha256()
            for a in (words[flags.bool()], flags, states):
                digest.update(a.cpu().numpy().tobytes())
            sets = [(x, *rest) for (x,) in cs.rotations((d,), len(data) + 3 * steps * lanes)]
            ms = cs.gpu_ms(ck.rans_encode, sets, args.iters)
            rows.append({"stream": label, "lanes": lanes, "steps": steps,
                         "encode_ms": ms, "step_us": ms * 1e3 / steps,
                         "outputs_sha256": digest.hexdigest()})
            del case, sets, d, words, flags, states
            torch.cuda.empty_cache()
            continue
        stream, *rest = case["dec"]
        sets = [(x, *rest) for (x,) in cs.rotations((stream,), 2 * k + steps * lanes)]
        ms = cs.gpu_ms(ck.rans_decode, sets, args.iters)
        g = geometry(lanes) if geometry else None
        rows.append({"stream": label, "lanes": lanes, "steps": steps, "words": k,
                     "decode_ms": ms, "step_us": ms * 1e3 / steps,
                     "geometry": g._asdict() if g else None,
                     "registers": registers.get(g.lanes_per_thread) if g else None})
        del case, sets, stream
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label or str(root), "kernel": args.kernel,
                      "set": args.set, "card": smi, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
