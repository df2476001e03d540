#!/usr/bin/env python3
"""Time the order-0 rANS decode kernel of one checkout of the port on one GPU.

Imports ``fastqpacker_tpu_torch`` from ``--root`` (a checkout of the repo,
for example the parent commit unpacked with ``git archive`` into a
git-ignored directory), builds its ``csrc/rans_codec.cu``, and times
``fq_rans_decode`` at the FQZ v3 path's shapes: a block's quality stream
(15.1 MB of walk-like deltas, 16,384 lanes) and its packed sequence stream
(3.8 MB, 4,096 lanes). The streams come from ``--seed`` and are encoded by
the checkout's own kernels, so two checkouts decode the same words; each run
holds the decode against the plain version and checks decode(encode(x)) ==
x. The inputs and the timing are ``chip_smoke.py``'s phase kernels (CUDA
events over launches queued behind a sleep kernel, inputs rotated past the
L2 cache).

Compare two designs inside one call, in turns: parent, change, change,
parent. ``--set NAME=VALUE`` first rewrites ``constexpr int NAME = ...;`` in
the checkout's ``csrc/rans_codec.cu``, so a copy of the tree times a variant
of the decode's geometry: ``kCtaThreads=1024`` gives 16 CTAs x 1,024 threads
with one lane each at 16,384 lanes, and adding ``kMaxCluster=1`` one CTA of
1,024 threads with 16 lanes each (the staged word ring without a cluster).
It refuses to edit this repository's own source. ``--stream`` picks the streams
(both by default). Prints one JSON line per run, with the launch geometry
and the decode's registers where the checkout reports them.

Usage: python3 scripts/rans_ab.py --root DIR [--set NAME=VALUE] [--stream qual|seq]
       [--label NAME] [--seed 0] [--iters 20]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
from wctx_ab import set_constants

REPO = Path(__file__).resolve().parent.parent
STREAMS = {"qual": 16384, "seq": 4096}  # lanes of each stream


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    ap.add_argument("--stream", action="append", choices=sorted(STREAMS))
    ap.add_argument("--label", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if args.set:
        set_constants(root / "fastqpacker_tpu_torch/csrc/rans_codec.cu", args.set)
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("rans_ab: no CUDA device", file=sys.stderr)
        return 1
    from fastqpacker_tpu_torch.ops import build
    from fastqpacker_tpu_torch.ops import cuda_kernels as ck
    from fastqpacker_tpu_torch.ops import rans

    imported = Path(build.__file__).resolve()
    if root not in imported.parents:
        raise RuntimeError(f"imported {imported}, not the checkout under {root}")
    # chip_smoke.py of this checkout: inputs, checks and timing
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    build.load("rans_codec")
    registers = cs.rans_decode_registers(build.builds["rans_codec"].log)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    geometry = getattr(ck, "rans_decode_geometry", None)
    rows = []
    for i, (label, lanes) in enumerate(STREAMS.items()):
        if args.stream and label not in args.stream:
            continue
        rng = np.random.default_rng(args.seed + i)
        data = (cs.walk_deltas(rng, cs.QUAL_STREAM) if label == "qual"
                else rng.integers(0, 256, cs.SEQ_STREAM).astype(np.uint8))
        case = cs.rans_case(ck, rans, data, lanes)  # kernels == plain, round trip
        stream, *rest = case["dec"]
        steps, k = case["steps"], case["total"]
        sets = [(x, *rest) for (x,) in cs.rotations((stream,), 2 * k + steps * lanes)]
        ms = cs.gpu_ms(ck.rans_decode, sets, args.iters)
        g = geometry(lanes) if geometry else None
        rows.append({"stream": label, "lanes": lanes, "steps": steps, "words": k,
                     "decode_ms": ms, "step_us": ms * 1e3 / steps,
                     "geometry": g._asdict() if g else None,
                     "registers": registers.get(g.lanes_per_thread) if g else None})
        del case, sets, stream
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label or str(root), "set": args.set, "card": smi,
                      "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
