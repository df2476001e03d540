#!/usr/bin/env python3
"""Time the block-stage kernels (record scan, row gather, stream build,
FASTQ assembly) of one checkout of the port on one GPU.

Imports ``fastqpacker_tpu_torch`` from ``--root`` (a checkout of the repo,
for example the parent commit unpacked with ``git archive`` into a
git-ignored directory), builds ``csrc/records.cu`` and times, through the
checkout's wrappers, at every block of ``chip_smoke.py``'s ``RECORD_SHAPES``
(a v2 block of 37,500 x 151, 50-300 bp reads, a v3 block of 100,000 x 151
with u32 N positions, and blocks of 37,500 and 100,000 Illumina-style read
names of varying width):

- ``scan``: ``fq_records_scan`` of the block's text (its offsets and quality
  minima up to the count, and its info);
- ``text``: ``fq_rows_gather`` of the quality rows from the text at the
  scan's offsets (the compress side);
- ``back_to_back``: ``fq_rows_gather`` of the quality rows from the quality
  stream, runs back to back (its scan of the lengths included);
- ``decoder``: the decode's gathers of one block as the checkout's
  ``pipeline/blocks.py`` runs them (two wrapper calls and the ``(len + 3) >> 2``
  op in a checkout without the pair gather, one pair call with it);
- ``streams``: ``fq_streams_build`` of the six raw streams from the text,
  the scan's offsets and the dense encode's outputs (v3's u32 N positions
  at 100,000 records);
- ``assemble``: ``fq_fastq_assemble`` of the block's text from the decoded
  rows and the header, plus and N-position streams.

For each: device ms (CUDA events over calls queued behind a sleep kernel,
inputs rotated past the L2 cache; ``chip_smoke.py``'s timing), the bound
(bytes once over 3.35 TB/s), the device operations one call runs
(``torch.profiler``), the host microseconds of one call's enqueue, and a
SHA-256 of the outputs, which must be the same for two checkouts. The
inputs come from this checkout's ``chip_smoke.py`` (seeded) and are prepared
with the plain versions, so both checkouts time the same bytes.

Compare two designs inside one call, in turns: parent, change, change,
parent. Prints one JSON line per run. ``--ops-only`` times nothing and
counts the device operations of one call of each route (``chip_smoke.py``
and the ``cuda`` tests take them so, from a fresh process); ``--split``
adds each kernel's device microseconds per call; ``--set NAME=VALUE`` first
rewrites ``constexpr int NAME`` in a copy's ``records.cu`` (``kWindow``,
``kWriteThreads``, ``kStreamWindow``, ...), so one constant can be timed
against the tree.

Usage: python3 scripts/records_ab.py --root DIR [--shape LABEL] [--route ROUTE]
       [--label NAME] [--iters 50] [--ops-only] [--split] [--set NAME=VALUE]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

from wctx_ab import set_constants

REPO = Path(__file__).resolve().parent.parent


def split_us(fn, calls: int = 10) -> dict:
    """Device microseconds per call of each kernel one call of ``fn`` runs
    (``torch.profiler``, a fresh process)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0]:
            e.device_time_total / calls
            for e in prof.key_averages() if e.device_type.name == "CUDA"}


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--shape", action="append", metavar="LABEL")
    ap.add_argument("--route", action="append", metavar="ROUTE",
                    help="only these routes (scan, text, back_to_back, decoder, streams, "
                         "assemble); default all")
    ap.add_argument("--label", default=None)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE",
                    help="rewrite constexpr int NAME in the checkout's records.cu (a copy)")
    ap.add_argument("--split", action="store_true",
                    help="also each kernel's device microseconds per call (torch.profiler)")
    ap.add_argument("--ops-only", action="store_true",
                    help="count the device operations of one call of each route, time nothing "
                         "(a fresh process: the profiler of a long one can miss kernels)")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if args.set:
        set_constants(root / "fastqpacker_tpu_torch/csrc/records.cu", args.set)
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("records_ab: no CUDA device", file=sys.stderr)
        return 1
    from fastqpacker_tpu_torch.ops import build
    from fastqpacker_tpu_torch.ops import cuda_kernels as ck
    from fastqpacker_tpu_torch.ops import device as devops
    from fastqpacker_tpu_torch.ops import records as recops
    from fastqpacker_tpu_torch.pipeline import blocks as blockcodec

    imported = Path(build.__file__).resolve()
    if root not in imported.parents:
        raise RuntimeError(f"imported {imported}, not the checkout under {root}")
    # chip_smoke.py of this checkout: inputs and timing
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    spec = importlib.util.spec_from_file_location(
        "records_ab_synth", REPO / "fastqpacker_tpu_torch" / "utils" / "synth.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)

    build.load("records")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    pair = "quarter" in inspect.signature(ck.rows_gather).parameters
    dev = cs.DEV
    rows = []
    for i, (label, (records, lens, names)) in enumerate(cs.RECORD_SHAPES.items()):
        if args.shape and label not in args.shape:
            continue
        data = cs.records_block(records, lens, names, seed=100 + i, synth=synth)
        text = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
        offsets, _, info = recops.records_scan_plain(text, records)
        info_h = info.cpu().numpy()
        width = blockcodec.bucket_len(int(info_h[recops.SCAN_SEQ_MAX]))
        seq_rows, qual_rows = (
            recops.rows_gather_plain(text, offsets[:, c], offsets[:, 3], records, width, f)
            for c, f in ((2, 0), (6, 0xFF)))
        wide = records == cs.BLOCK_RECORDS
        enc = devops.encode_arrays_plain(seq_rows, qual_rows, offsets[:, 3].to(torch.int32), 33,
                                         (1 << 31) - 1 if wide else 1 << 16)
        sizes = recops.stream_sizes(info_h, wide)
        buf, _ = recops.streams_build_plain(text, offsets, enc.packed, enc.qual_delta,
                                            enc.nmask_bits, enc.n_counts, wide, sizes)
        cut = np.cumsum([0] + sizes)
        seq_s, qual_s, hdr_s, plus_s, npos_s, len_s = (
            buf[cut[k] : cut[k + 1]].clone() for k in range(6))
        lens_t = len_s.view(torch.int32).to(torch.int64)
        packed, deltas = (recops.rows_gather_plain(s_, None, n_, records, w_, 0) for s_, n_, w_ in
                          ((seq_s, (lens_t + 3) >> 2, width // 4), (qual_s, lens_t, width)))
        seq_a, qual_a = devops.decode_arrays_plain(packed, deltas, lens_t.to(torch.int32), 33)
        asm = (seq_a, qual_a, lens_t, hdr_s, plus_s, npos_s, wide, sizes[5], sizes[0], sizes[1])
        seq_total = int(info_h[recops.SCAN_SEQ_SUM])
        total = len(data)

        def decoder(q, s_, n_):
            if pair:
                return ck.rows_gather(q, None, n_, records, width, 0, quarter=(s_, width // 4))
            return (ck.rows_gather(q, None, n_, records, width, 0),
                    ck.rows_gather(s_, None, (n_ + 3) >> 2, records, width // 4, 0))

        cases = {
            "scan": (lambda t: ck.records_scan(t, records), (text,), cs.scan_bytes(total, records)),
            "text": (lambda t, o: ck.rows_gather(t, o[:, 6], o[:, 3], records, width, 0xFF),
                     (text, offsets), seq_total + 16 * records + records * width),
            "back_to_back": (lambda q, n_: ck.rows_gather(q, None, n_, records, width, 0),
                             (qual_s, lens_t), seq_total + 8 * records + records * width),
            "decoder": (decoder, (qual_s, seq_s, lens_t),
                        seq_total + sizes[0] + 8 * records + records * (width + width // 4)),
            "streams": (lambda t, o, *a: ck.streams_build(t, o, *a, wide, sizes),
                        (text, offsets, enc.packed, enc.qual_delta, enc.nmask_bits,
                         enc.n_counts), cs.streams_bytes(sizes, records, enc.nmask_bits)),
            "assemble": (lambda *a: ck.fastq_assemble(*a)[0][: total], asm,
                         2 * seq_total + 8 * records + sizes[2] + sizes[3] + sizes[4] + total),
        }
        for route, (fn, fargs, nbytes) in cases.items():
            if args.route and route not in args.route:
                continue
            out = fn(*fargs)
            outs = out if isinstance(out, tuple) else (out,)
            if route == "assemble":
                torch.cuda.synchronize()
                if bytes(out.cpu().numpy()) != data:
                    raise RuntimeError(f"{label}: assembled text differs from the input")
            dops = cs.device_ops(lambda: fn(*fargs))
            row = {"shape": label, "route": route, "records": records, "width": width,
                   "device_ops_per_call": len(dops), "device_ops": dops, "sha256": digest(outs)}
            if args.split:
                row["split_us"] = split_us(lambda: fn(*fargs))
                print(f"records_ab {args.label or root.name} {label} {route} split_us="
                      f"{json.dumps(row['split_us'])}", file=sys.stderr)
            rows.append(row)
            if args.ops_only:
                continue
            sets = cs.rotate(fargs, nbytes)
            ms = cs.gpu_ms(fn, sets, args.iters)
            del sets
            bound_ms = cs.bound(nbytes, 0)[0]
            row.update(ms=ms, bound_ms=bound_ms, share=bound_ms / ms, bytes=nbytes,
                       host_us_per_call=cs.host_us(fn, fargs))
            print(f"records_ab {args.label or root.name} {label} {route} ms={ms:.6f} "
                  f"bound_ms={bound_ms:.6f} device_ops={len(dops)} "
                  f"host_us={row['host_us_per_call']:.1f}", file=sys.stderr)
        del text, offsets, seq_rows, qual_rows, enc, buf, asm, seq_a, qual_a, packed, deltas
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label or str(root), "pair_gather": pair, "card": smi,
                      "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
