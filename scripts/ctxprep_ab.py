#!/usr/bin/env python3
"""Time the context-model kernels (qctx and sctx prepare, the wctx lane
matrices both ways) of one checkout of the port on one GPU.

Imports ``fastqpacker_tpu_torch`` from ``--root`` (a checkout of the repo,
for example the parent commit unpacked with ``git archive`` into a
git-ignored directory), builds ``csrc/ctxprep.cu`` and times, through the
checkout's wrappers, on ``chip_smoke.py``'s seeded 100,000 x 151 blocks of
the ``walk151`` corpus (the v3 run's: walk qualities) and the ``markov151``
corpus (the mesh run's: Markov bases, Phred walks):

- ``qctx``: ``fq_qctx_prepare`` of the block's quality deltas, with
  ``torch.bincount`` of the same keys beside (printed only);
- ``sctx``: ``fq_sctx_prepare`` of its packed bases;
- ``layout``: ``fq_wctx_layout``, the encoder's matrices and the decoder's
  start matrix, of the ``markov151`` streams at every (model, order) the
  wrapper takes (``chip_smoke.py`` CTX_MODELS: sequence orders 2, 4, 6 and
  quality orders 0, 1; the mesh path codes sequence order 2 and quality
  order 1), on the lanes the mesh path picks for them;
- ``unlayout``: ``fq_wctx_unlayout`` of the decoded matrices of those two
  streams back to packed rows and quality deltas, with
  ``torch.masked_select(mat.t(), data_mask)`` beside (the transpose and
  compaction alone; printed only).

For each: device ms (CUDA events over calls queued behind a sleep kernel,
inputs rotated past the L2 cache; ``chip_smoke.py``'s timing), the bound
(bytes once over 3.35 TB/s, ``chip_smoke.py``'s byte counts), the device
operations one call runs (``torch.profiler``), the host microseconds of one
call's enqueue, and a SHA-256 of the outputs, which must be the same for two
checkouts. The inputs come from this checkout's ``chip_smoke.py`` and are
prepared with the plain versions, so both checkouts time the same bytes.

Compare two designs inside one call, in turns: parent, change, change,
parent. Prints one JSON line per run. ``--ops-only`` times nothing and
counts the device operations of one call of each route (the ``cuda`` tests
take them so, from a fresh process); ``--split`` adds each kernel's device
microseconds per call; ``--set NAME=VALUE`` first rewrites ``constexpr int
NAME`` in a copy's ``ctxprep.cu``; ``--cache FILE`` keeps the two blocks'
streams in an ``.npz`` so that later runs skip making them.

Usage: python3 scripts/ctxprep_ab.py --root DIR [--route ROUTE] [--corpus LABEL]
       [--records N] [--label NAME] [--iters 20] [--ops-only] [--split]
       [--set NAME=VALUE] [--cache FILE]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

from records_ab import digest, split_us
from wctx_ab import set_constants

REPO = Path(__file__).resolve().parent.parent
ROUTES = ("qctx", "sctx", "layout", "unlayout")
CORPORA = ("walk151", "markov151")
# the (model, order) of the streams the mesh path codes (chip_smoke.py CTX_TIMED
# and the sequence stream beside it): the unlayout's; the layout takes every
# model and order (chip_smoke.py CTX_MODELS)
LANE_MODELS = ((0, 2), (1, 1))


def corpus_streams(cs, label: str, records: int, seed: int, cache: Path | None):
    """(packed, delta, lengths) host arrays of one corpus block, made as
    ``chip_smoke.py``'s phase ctxprep makes them, or read from ``cache``."""
    import numpy as np

    key = f"{label}_{records}_{seed}"
    if cache is not None and cache.exists():
        with np.load(cache) as z:
            if f"{key}_packed" in z:
                return z[f"{key}_packed"], z[f"{key}_delta"], z[f"{key}_lengths"]
    from fastqpacker_tpu_torch.utils.synth import synth_fastq

    one = len(synth_fastq(0, read_len=cs.READ_LEN))
    if label == "walk151":
        data = synth_fastq((records * one + one // 2) / (1 << 20), seed=seed + 11,
                           qual_model="walk")
    else:
        data = cs.context_corpus(records, seed + 12)
    saved = cs.BLOCK_RECORDS
    cs.BLOCK_RECORDS = records
    try:
        out = cs.corpus_block(data)
    finally:
        cs.BLOCK_RECORDS = saved
    if cache is not None:
        old = dict(np.load(cache)) if cache.exists() else {}
        old.update({f"{key}_packed": out[0], f"{key}_delta": out[1], f"{key}_lengths": out[2]})
        np.savez(cache, **old)
    return out


def cases(cs, ck, ctxprep, wctx, label, packed_h, delta_h, lengths, routes) -> list:
    """(route, shape, fn, args, bytes, yardstick) of the routes on one block:
    ``yardstick`` is (name, fn, args) of a PyTorch call beside, or None."""
    import numpy as np
    import torch

    from fastqpacker_tpu_torch.ops import qualctx, seqctx

    dev = cs.DEV
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    n, nrec, m = int(lengths.sum()), len(lengths), len(packed_h)
    delta, packed = t(delta_h), t(packed_h)
    bounds, pbounds = t(ctxprep.record_bounds(lengths)), t(ctxprep.record_bounds(lengths, True))
    out = []
    if "qctx" in routes:
        keys = ctxprep.qctx_keys(delta, bounds)[1]
        out.append(("qctx", label, ck.qctx_prepare, (delta, bounds),
                    2 * n + 8 * (nrec + 1) + 4 * ctxprep.QCTX_CONTEXTS * 256,
                    ("bincount", lambda k: torch.bincount(
                        k, minlength=ctxprep.QCTX_CONTEXTS * 256), (keys,))))
    if "sctx" in routes:
        out.append(("sctx", label, lambda a, b: ck.sctx_prepare(a, b, n), (packed, pbounds),
                    m + n + 16 * (nrec + 1) + 4 * ctxprep.SCTX_CONTEXTS * 4, None))
    if label != "markov151" or not {"layout", "unlayout"} & set(routes):
        return out
    raw, hist2 = ctxprep.qctx_prepare_plain(delta, bounds)
    bases, hist6 = ctxprep.sctx_prepare_plain(packed, pbounds)
    hist2_h = hist2.cpu().numpy().astype(np.int64)
    hist6_h = hist6.cpu().numpy().astype(np.int64)
    for model, order in cs.CTX_MODELS if "layout" in routes else LANE_MODELS:
        if model == 0:
            syms, hist = bases, (seqctx.marginalize(hist6_h, order) if order < 6 else hist6_h)
            mode, out_bytes, ub = ctxprep.UNLAYOUT_PACKED, m, pbounds
        else:
            syms, hist = raw, qualctx.hist_for_model(hist2_h, order)
            mode, out_bytes, ub = ctxprep.UNLAYOUT_DELTA, n, bounds
        lanes = wctx.pick_lanes_for(hist, n)
        tab_h, steps, seg = ctxprep.lane_layout(lengths, lanes)
        counts = hist.sum(axis=0)
        present = np.flatnonzero(counts > 0)
        tab, idx, pres = t(tab_h), t(wctx._sym_to_idx(present)), t(present.astype(np.uint8))
        enc = (bounds, tab, steps, model, order, idx, int(np.argmax(counts)))
        cells = steps * lanes
        geo = 8 * (nrec + 1) + 16 * (lanes + 1)
        shape = f"{label}_model{model}_order{order}_lanes{lanes}_steps{steps}"
        if "layout" in routes:
            out.append(("layout_encode", shape, lambda a, enc=enc: ck.wctx_layout(a, *enc),
                        (syms,), n + 3 * cells + geo + 256, None))
            out.append(("layout_decode", shape,
                        lambda b, tab=tab, steps=steps, model=model, order=order:
                        ck.wctx_layout(None, b, tab, steps, model, order), (bounds,),
                        cells + geo, None))
        if "unlayout" in routes and (model, order) in LANE_MODELS:
            data = t(np.arange(steps)[:, None] < seg[None, :])
            mat = torch.where(data, ctxprep.wctx_layout_plain(syms, *enc)[0], 0)
            out.append(("unlayout", shape,
                        lambda a, ub=ub, tab=tab, pres=pres, mode=mode, size=out_bytes:
                        ck.wctx_unlayout(a, ub, tab, pres, mode, size), (mat,),
                        n + out_bytes + geo * (2 if model == 0 else 1) + len(present),
                        ("masked_select", lambda a, k: torch.masked_select(a.t(), k),
                         (mat, data.t().contiguous()))))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--route", action="append", choices=ROUTES, help="default all")
    ap.add_argument("--corpus", action="append", choices=CORPORA, help="default both")
    ap.add_argument("--records", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0, help="chip_smoke.py's --seed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE",
                    help="rewrite constexpr int NAME in the checkout's ctxprep.cu (a copy)")
    ap.add_argument("--split", action="store_true",
                    help="also each kernel's device microseconds per call (torch.profiler)")
    ap.add_argument("--ops-only", action="store_true",
                    help="count the device operations of one call of each route, time nothing")
    ap.add_argument("--cache", type=Path, default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if args.set:
        set_constants(root / "fastqpacker_tpu_torch/csrc/ctxprep.cu", args.set)
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("ctxprep_ab: no CUDA device", file=sys.stderr)
        return 1
    from fastqpacker_tpu_torch.ops import build, ctxprep, wctx
    from fastqpacker_tpu_torch.ops import cuda_kernels as ck

    imported = Path(build.__file__).resolve()
    if root not in imported.parents:
        raise RuntimeError(f"imported {imported}, not the checkout under {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    build.load("ctxprep")
    ptxas = [line for line in build.builds["ctxprep"].log.splitlines()
             if "registers" in line or "spill" in line]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    routes = args.route or ROUTES
    name = args.label or root.name
    rows = []
    for label in args.corpus or CORPORA:
        packed_h, delta_h, lengths = corpus_streams(cs, label, args.records, args.seed, args.cache)
        for route, shape, fn, fargs, nbytes, yard in cases(cs, ck, ctxprep, wctx, label, packed_h,
                                                          delta_h, lengths, routes):
            out = fn(*fargs)
            torch.cuda.synchronize()
            outs = out if isinstance(out, tuple) else (out,)
            dops = cs.device_ops(lambda: fn(*fargs))
            row = {"route": route, "shape": shape, "device_ops_per_call": len(dops),
                   "device_ops": dops, "sha256": digest(outs)}
            rows.append(row)
            if args.split:
                row["split_us"] = split_us(lambda: fn(*fargs))
                print(f"ctxprep_ab {name} {shape} {route} split_us="
                      f"{json.dumps(row['split_us'])}", file=sys.stderr)
            if args.ops_only:
                continue
            sets = cs.rotate(fargs, nbytes)
            ms = cs.gpu_ms(fn, sets, args.iters)
            del sets
            bound_ms = cs.bound(nbytes, 0)[0]
            row.update(ms=ms, bound_ms=bound_ms, share=bound_ms / ms, bytes=nbytes,
                       host_us_per_call=cs.host_us(fn, fargs))
            if yard is not None:
                yname, yfn, yargs = yard
                row[f"{yname}_ms"] = cs.gpu_ms(yfn, cs.rotate(yargs, nbytes), args.iters)
            print(f"ctxprep_ab {name} {shape} {route} ms={ms:.6f} bound_ms={bound_ms:.6f} "
                  f"share={bound_ms / ms:.4f} device_ops={len(dops)} "
                  f"host_us={row['host_us_per_call']:.1f}"
                  + (f" {yard[0]}_ms={row[yard[0] + '_ms']:.6f}" if yard else ""),
                  file=sys.stderr)
        torch.cuda.empty_cache()
    print(json.dumps({"label": name, "card": smi, "ptxas": ptxas, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
