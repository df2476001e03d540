#!/usr/bin/env python3
"""Time the header tokenizer (``fq_tok_encode`` / ``fq_tok_decode``) of one
checkout of the port on one GPU.

Imports ``fastqpacker_tpu_torch`` from ``--root`` (a checkout of the repo,
for example the parent commit unpacked with ``git archive`` into a
git-ignored directory), builds ``csrc/tokens.cu`` and times, through the
checkout's wrappers, the header stream of a v3 block of 100,000 read names
in instrument order (``utils/synth.py:ordered_illumina_fastq``, the first
block of ``chip_smoke.py``'s ``phase=tokens`` corpus; the stream on the card
at the offset the stream build leaves it, 16-byte aligned):

- ``decode``: the tokenized stream back to the header stream (the checkout's
  first call and, sized from the read-back, its write call);
- ``encode_lengths``: the encode with the block's header lengths on the card
  (the compress path's route; a checkout without that argument prints
  ``"supported": false``);
- ``encode``: the encode of a bare stream (its record starts from the
  stream's own u16 lengths).

For each: device ms (CUDA events over the launches alone, queued behind a
sleep kernel, inputs rotated past the L2 cache; ``chip_smoke.py``'s
timing), the bound (bytes in and out once over 3.35 TB/s), the device
operations of one wrapper call (``torch.profiler``, the read-backs
included), the host microseconds of one wrapper call, and a SHA-256 of the
output, which must be the same for two checkouts. ``--split`` adds each
kernel's device microseconds and launches per wrapper call; ``--ops-only``
times nothing and counts the device operations of one call of each route
(the ``cuda`` tests take them so, from a fresh process: in a long one the
profiler can miss kernels).

Compare two designs inside one call, in turns: parent, change, change,
parent. Prints one JSON line per run.

Usage: python3 scripts/tokens_ab.py --root DIR [--route ROUTE] [--label NAME]
       [--records 100000] [--seed 19] [--iters 20] [--split] [--ops-only]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
READ_LEN = 151
HOST_CALLS = 20


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def split_us(fn, calls: int = 10) -> dict:
    """Device microseconds and launches per call of each kernel (and copy)
    one call of ``fn`` runs (``torch.profiler``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0]:
            {"us": e.device_time_total / calls, "launches": e.count / calls}
            for e in prof.key_averages() if e.device_type.name == "CUDA"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--route", action="append", metavar="ROUTE",
                    help="only these routes (decode, encode_lengths, encode); default all")
    ap.add_argument("--label", default=None)
    ap.add_argument("--records", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--split", action="store_true",
                    help="also each kernel's device microseconds per call (torch.profiler)")
    ap.add_argument("--ops-only", action="store_true",
                    help="count the device operations of one call of each route, time nothing")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("tokens_ab: no CUDA device", file=sys.stderr)
        return 1
    from fastqpacker_tpu_torch.ops import build
    from fastqpacker_tpu_torch.ops import cuda_kernels as ck
    from fastqpacker_tpu_torch.ops import tokenize as plain  # the plain version: the spec

    imported = Path(build.__file__).resolve()
    if root not in imported.parents:
        raise RuntimeError(f"imported {imported}, not the checkout under {root}")
    # this checkout's timing helpers, input generator and stream layout
    cs = load("chip_smoke", REPO / "chip_smoke.py")
    synth = load("tokens_ab_synth", REPO / "fastqpacker_tpu_torch" / "utils" / "synth.py")
    ti = load("tokens_ab_inputs", REPO / "tests" / "torch_tokens_inputs.py")

    build.load("tokens")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = cs.DEV
    count = args.records
    headers = ti.headers_of(synth.ordered_illumina_fastq(count, seed=args.seed))
    stream = ti.stream_of(headers)
    tok = plain.encode_plain(stream, count)
    n, m = len(stream), len(tok)
    total, start = plain._read_varint(tok, 0)
    # the header stream follows the sequence and quality streams in the
    # stream build's buffer
    off = (count * -(-READ_LEN // 4) + count * READ_LEN) % 16
    view = cs.on_card(stream, off)
    tok_t = cs.on_card(tok)
    lengths = torch.tensor([len(h) for h in headers], dtype=torch.int64, device=dev)
    enc_params = inspect.signature(ck.tok_encode_launch).parameters
    dec_params = inspect.signature(ck.tok_decode_launch).parameters
    has_lengths = "lengths" in enc_params

    def dec_launches(t):
        call = (ck.tok_decode_launch(t, count, start) if "start" in dec_params
                else ck.tok_decode_launch(t, count))
        return ck.tok_decode_write(call, total)

    cases = {
        "decode": (dec_launches, lambda t: ck.tok_decode(t, count), tok_t, m + n),
        "encode": (lambda t: ck.tok_encode_launch(t, count)[0],
                   lambda t: ck.tok_encode(t, count), view, n + m),
    }
    if has_lengths:
        cases["encode_lengths"] = (
            lambda t: ck.tok_encode_launch(t, count, lengths)[0],
            lambda t: ck.tok_encode(t, count, lengths), view, n + 8 * count + m)
    rows = []
    for route in ("decode", "encode_lengths", "encode"):
        if args.route and route not in args.route:
            continue
        if route not in cases:
            rows.append({"route": route, "supported": False})
            continue
        launches, wrapper, inp, nbytes = cases[route]
        out = wrapper(inp)
        want = stream if route == "decode" else tok
        if out.cpu().numpy().tobytes() != want:
            raise RuntimeError(f"{route}: output differs from the plain version's")
        row = {"route": route, "supported": True, "records": count, "in_bytes": inp.numel(),
               "out_bytes": out.numel(),
               "sha256": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()}
        dops = cs.device_ops(lambda: wrapper(inp))
        row.update(device_ops_per_call=len(dops), device_ops=dops)
        if args.ops_only:
            rows.append(row)
            continue
        if args.split:
            row["split"] = split_us(lambda: wrapper(inp))
            print(f"tokens_ab {args.label or root.name} {route} split="
                  f"{json.dumps(row['split'])}", file=sys.stderr)
        sets = cs.retile(inp, max(2, -(-150_000_000 // nbytes)))
        ms = cs.gpu_ms(launches, sets, args.iters)
        del sets
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            wrapper(inp)
        host = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        bound_ms = cs.bound(nbytes, 0)[0]
        row.update(ms=ms, bound_ms=bound_ms, share=bound_ms / ms, bytes=nbytes,
                   host_us_per_call=host)
        print(f"tokens_ab {args.label or root.name} {route} ms={ms:.6f} bound_ms={bound_ms:.6f} "
              f"device_ops={len(dops)} host_us={host:.1f}", file=sys.stderr)
        rows.append(row)
    print(json.dumps({"label": args.label or str(root), "card": smi, "records": count,
                      "stream_bytes": n, "tokenized_bytes": m, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
