#!/usr/bin/env python3
"""Time the dense codec kernels of one checkout of the port on one GPU.

Imports ``fastqpacker_tpu_torch`` from ``--root`` (a checkout of the repo,
for example the parent commit unpacked with ``git archive`` into a
git-ignored directory), builds ``csrc/dense_codec.cu`` and times
``fq_dense_encode`` and ``fq_dense_decode`` through their wrappers
(``encode_arrays`` / ``decode_arrays``) at ``chip_smoke.py``'s shapes:
37,500 x 160 and 100,000 x 160 (reads of 151 bp), 100,000 x 151 (the v3 /
mesh block at its true length) and 37,500 x 320 (reads of 50-300 bp).

Each call's outputs are made contiguous, as a copy to the host makes them,
so the time is the wrapper's whole device time: every kernel of one call,
pad and slice passes included where a checkout has them. Where the width is
already what the kernel takes (160, 320 in any checkout) that is the kernel
alone. ``torch.profiler`` names the device operations of one call at each
shape, and a plain device ``copy_`` moving the same bytes in all is timed
beside each (``copy_ms``). Each run holds the kernels against the plain
versions (byte-equal)
and prints a SHA-256 of every output, so two checkouts can be compared byte
for byte; the inputs come from ``--seed``.

Compare two designs inside one call, in turns: parent, change, change,
parent. ``--set NAME=VALUE`` first rewrites ``constexpr int NAME = ...;`` in
the checkout's kernel source (``kTileBytes``, ``kDecodeStages``, ``kUnroll``),
so a copy of the tree times a variant of one constant; it refuses to edit
this repository's own source. The inputs, checks and timing are
``chip_smoke.py``'s (CUDA events over calls queued behind a sleep kernel,
inputs rotated past the L2 cache). Prints one JSON line per run.

Usage: python3 scripts/dense_ab.py --root DIR [--set NAME=VALUE]
       [--shape RxL] [--label NAME] [--seed 0] [--iters 200]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
from wctx_ab import set_constants

REPO = Path(__file__).resolve().parent.parent


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE")
    ap.add_argument("--shape", action="append", metavar="RxL")
    ap.add_argument("--label", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if args.set:
        set_constants(root / "fastqpacker_tpu_torch/csrc/dense_codec.cu", args.set)
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("dense_ab: no CUDA device", file=sys.stderr)
        return 1
    from fastqpacker_tpu_torch.ops import build
    from fastqpacker_tpu_torch.ops import cuda_kernels as ck
    from fastqpacker_tpu_torch.ops import device as devops

    imported = Path(build.__file__).resolve()
    if root not in imported.parents:
        raise RuntimeError(f"imported {imported}, not the checkout under {root}")
    # chip_smoke.py of this checkout: inputs, checks and timing
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    build.load("dense_codec")
    registers = {row["entry"]: {k: v for k, v in row.items() if k != "entry"}
                 for row in cs.ptxas_report(build.builds["dense_codec"].log)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    rows = []
    off = 33
    for i, (r, l, lens) in enumerate(cs.DENSE_SHAPES):
        key = f"{r}x{l}"
        if args.shape and key not in args.shape:
            continue
        rng = np.random.default_rng(args.seed + i)
        (s, q, n), ref, enc_err, dec_err = cs.kernel_case(
            ck, devops, rng, r, l, off, b"ACGT", full_len=lens, exact=False)
        if enc_err or dec_err:
            raise RuntimeError(f"kernels differ from the plain versions at {key}")

        def encode(*a):
            return [x.contiguous() for x in ck.encode_arrays(*a, off)]

        def decode(*a):
            return [x.contiguous() for x in ck.decode_arrays(*a, off)]

        enc_out = encode(s, q, n)
        dec_out = decode(ref.packed, ref.qual_delta, n)
        row = {"shape": key, "rows": r, "len": l,
               "encode_sha256": digest(enc_out), "decode_sha256": digest(dec_out),
               "encode_device_ops": cs.device_ops(lambda: encode(s, q, n)),
               "decode_device_ops": cs.device_ops(
                   lambda: decode(ref.packed, ref.qual_delta, n))}
        for name, fn, sets, nbytes in (
            ("encode", encode, cs.rotations((s, q, n), cs.encode_bytes(r, l)),
             cs.encode_bytes(r, l)),
            ("decode", decode,
             cs.rotations((ref.packed, ref.qual_delta, n), cs.decode_bytes(r, l)),
             cs.decode_bytes(r, l)),
        ):
            ms = cs.gpu_ms(fn, sets, args.iters)
            bound_ms = cs.bound(nbytes, 0)[0]
            row[f"{name}_ms"] = ms
            row[f"{name}_bound_ms"] = bound_ms
            row[f"{name}_share"] = bound_ms / ms
            row[f"{name}_copy_ms"] = cs.copy_ms(nbytes, args.iters)
            del sets
        rows.append(row)
        del s, q, n, ref, enc_out, dec_out
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label or str(root), "set": args.set, "card": smi,
                      "ptxas": registers, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
