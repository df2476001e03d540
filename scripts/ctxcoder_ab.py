#!/usr/bin/env python3
"""Time the context coders (``fq_qctx_encode``, ``fq_qctx_decode``,
``fq_sctx_encode``, ``fq_sctx_decode``, ``csrc/ctxcoder.cu``) of one checkout
of the port on one GPU.

Imports ``fastqpacker_tpu_torch`` from ``--root`` (a checkout of the repo,
for example the parent commit unpacked with ``git archive`` into a
git-ignored directory), builds ``csrc/ctxcoder.cu`` and runs, through the
checkout's wrappers, the quality (deltas) and sequence (packed rows) streams
of the first ``--records`` records of ``chip_smoke.py``'s context-model
corpus (``synth_fastq(qual_model="phredwalk", seq_model="markov")``), the
tables at the model and order the v3 pick takes. Each kernel is held against
its plain version on the first 10,000 records and timed at the whole block
(``chip_smoke.py``'s ``ctxcoder_timed``: device ms, the bound, µs a step of
the longest chain, ``chain_bound_ms`` from ``scripts/ctx_step_probe.py`` run in
the same process, host µs a wrapper call, the qctx decode's route), then the
qctx pair at a binned 15.1 M-symbol quality stream (``binned_timed``).
``--ops-only`` times nothing and counts the device operations of one wrapper
call of each route, the qctx decode also at a stream of 94 quality symbols
(its L2 route) (``torch.profiler``; the ``cuda`` tests and ``chip_smoke.py``
take them so, from a fresh process: in a long one the profiler can miss
kernels). Prints one JSON line.

Usage: python3 scripts/ctxcoder_ab.py --root DIR [--records 100000] [--seed 23]
       [--iters 3] [--ops-only] [--label NAME]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--records", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--ops-only", action="store_true",
                    help="count the device operations of one call of each route, time nothing")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("ctxcoder_ab: no CUDA device", file=sys.stderr)
        return 1
    from fastqpacker_tpu_torch.ops import build
    from fastqpacker_tpu_torch.ops import cuda_kernels as ck

    imported = Path(build.__file__).resolve()
    if root not in imported.parents:
        raise RuntimeError(f"imported {imported}, not the checkout under {root}")
    # this checkout's helpers and the wrappers' arguments (tests/torch_ctxcoder_inputs.py)
    cs = load("chip_smoke", REPO / "chip_smoke.py")
    ci = load("ctxcoder_ab_inputs", REPO / "tests" / "torch_ctxcoder_inputs.py")
    build.load("ctxcoder")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    data = cs.context_corpus(args.records, args.seed)
    packed, delta, lengths = cs.corpus_block(data, args.records)
    streams = {"qctx": (delta, lengths), "sctx": (packed, lengths)}
    label = args.label or str(root)
    if args.ops_only:
        cases = []
        # a quality stream of 94 symbols: the qctx decode's L2 route
        rng = np.random.default_rng(args.seed)
        l2_lengths = np.full(args.records // 10, 151, np.int64)
        l2 = ci.qualctx.deintegrate(rng.integers(0, 94, int(l2_lengths.sum())).astype(np.uint8),
                                    l2_lengths)
        for stream, (syms_in, lens), suffix in (*((k, v, "") for k, v in streams.items()),
                                                ("qctx", (l2, l2_lengths), "_l2")):
            inp = ci.coder_inputs(stream, syms_in, lens, cs.DEV, 0 if suffix else None)
            enc = ci.coder_encode(stream, inp)
            dargs = ci.coder_decode_args(stream, inp, enc, cs.DEV)
            calls = ((f"{stream}_decode{suffix}", lambda: ci.coder_decode(stream, dargs)),)
            if not suffix:
                calls = ((f"{stream}_encode", lambda: ci.coder_encode(stream, inp)), *calls)
            for route, call in calls:
                ops = cs.device_ops(call)
                cases.append({"route": route, "device_ops_per_call": len(ops),
                              "device_ops": ops})
        print(json.dumps({"label": label, "card": smi, "records": args.records,
                          "cases": cases}))
        return 0
    ops = dict.fromkeys(cs.CTX_ROUTES, [])  # counted by --ops-only, in a process of its own
    probe = cs.ctx_probe()
    rows = cs.ctxcoder_timed(ck, ci, f"markov151x{args.records}",
                             streams, ops, args.iters, probe=probe)
    binned = cs.binned_timed(ck, ci, args.seed + 1, args.iters, probe=probe)
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    cases = [{"route": route, **dict(zip(fields, row[:5])), **row[5]}
             for route, row in rows.items()]
    print(json.dumps({"label": label, "card": smi, "records": args.records, "cases": cases,
                      "binned_qual": binned}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
