#!/usr/bin/env python3
"""Time the context-rANS kernels of one checkout of the port on one GPU.

Imports ``fastqpacker_tpu_torch`` from ``--root`` (a checkout of the repo,
for example the parent commit unpacked with ``git archive`` into a
git-ignored directory), builds its ``csrc/wctx_codec.cu``, and times
``fq_wctx_encode`` and ``fq_wctx_decode`` at the ``--mesh`` path's shapes:
one 100,000-record block of the context-model corpus (151 bp), the sequence
stream at order 2 and the quality stream at order 1 on the lanes the mesh
path picks, and the sequence stream on 8,192 lanes. Inputs come from
``--seed``, so two checkouts time the same streams; each run checks
decode(encode(x)) == x. The timing is ``chip_smoke.py``'s (CUDA events over
launches queued behind a sleep kernel, inputs rotated past the L2 cache).

Compare two designs inside one call, in turns: parent, change, change,
parent. ``--set NAME=VALUE`` first rewrites ``constexpr int NAME = ...;`` in
the checkout's ``csrc/wctx_codec.cu`` (for example ``kCtaThreads=512``, the
decode's threads per CTA), so a copy of the tree times a variant of one
constant; it refuses to edit this repository's own source. Prints one JSON
line per run, with the decode's launch geometry where the checkout reports it.

Usage: python3 scripts/wctx_ab.py --root DIR [--set NAME=VALUE] [--label NAME]
       [--seed 0] [--iters 10]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
CASES = [(0, 2, None), (1, 1, None), (0, 2, 8192)]  # (model, order, lanes)
RECORDS, READ_LEN = 100_000, 151


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    ap.add_argument("--label", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if args.set:
        set_constants(root / "fastqpacker_tpu_torch/csrc/wctx_codec.cu", args.set)
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("wctx_ab: no CUDA device", file=sys.stderr)
        return 1
    from fastqpacker_tpu_torch.ops import build
    from fastqpacker_tpu_torch.ops import cuda_kernels as ck
    from fastqpacker_tpu_torch.ops import wctx

    check = Path(build.__file__).resolve()
    if root not in check.parents:
        raise RuntimeError(f"imported {check}, not the checkout under {root}")
    # chip_smoke.py of this checkout: inputs and timing
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    build.load("wctx_codec")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lengths = np.full(RECORDS, READ_LEN, np.int64)
    rows = []
    for i, (model, order, lanes) in enumerate(CASES):
        rng = np.random.default_rng(args.seed + i)
        syms = cs.corpus_symbols(rng, model, RECORDS, READ_LEN)
        prep = cs.wctx_prep(wctx, syms, lengths, model, order, lanes)
        words, flags, states, status = ck.wctx_encode(*prep["enc"])
        flat, total = ck.rans_compact(words, flags)
        stream = flat[: int(total)].clone()
        dec = (stream, states, *prep["dec_tail"])
        out, info = ck.wctx_decode(*dec, model, order)
        idx = wctx.from_matrix(out.cpu().numpy(), prep["sb"])
        cs.check(int(status) == 0 and info.tolist() == [int(total), 0]
                 and np.array_equal(prep["present"].astype(np.uint8)[idx], syms),
                 f"decode(encode(x)) == x at model={model} order={order}")
        S, N, m, k = prep["S"], prep["lanes"], prep["S"] * prep["lanes"], int(total)
        enc_sets = [(a, b, *prep["enc"][2:])
                    for a, b in cs.rotations(prep["enc"][:2], 6 * m)]
        dec_sets = [(w, st, *dec[2:])
                    for w, st in cs.rotations((stream, states), 2 * k + 2 * m)]
        enc_ms = cs.gpu_ms(ck.wctx_encode, enc_sets, args.iters)
        dec_ms = cs.gpu_ms(lambda *a: ck.wctx_decode(*a, model, order), dec_sets,
                           args.iters)
        geometry = getattr(ck, "wctx_decode_geometry", None)
        tab = prep["dec_tail"][2]
        rows.append({"model": model, "order": order, "lanes": N, "steps": S,
                     "words": k, "encode_ms": enc_ms, "decode_ms": dec_ms,
                     "decode_geometry": geometry(N, *tab.shape)._asdict()
                     if geometry else None,
                     "encode_step_us": enc_ms * 1e3 / S,
                     "decode_step_us": dec_ms * 1e3 / S})
        del prep, enc_sets, dec_sets, words, flags, stream
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label or str(root), "set": args.set, "card": smi,
                      "cases": rows}))
    return 0


def set_constants(src: Path, assignments: list[str]) -> None:
    """Rewrite ``constexpr int NAME = <int>;`` in ``src`` for each
    ``NAME=VALUE``, outside this repository only."""
    if src.resolve() == (REPO / "fastqpacker_tpu_torch/csrc" / src.name).resolve():
        raise SystemExit(f"--set edits the checkout's source: give a copy, not {REPO}")
    text = src.read_text()
    for item in assignments:
        name, value = item.split("=", 1)
        text, n = re.subn(rf"(constexpr int {re.escape(name)} = )-?\d+;",
                          rf"\g<1>{int(value)};", text)
        if n != 1:
            raise SystemExit(f"--set {item}: {name} is not one integer constant of {src}")
    src.write_text(text)


if __name__ == "__main__":
    sys.exit(main())
