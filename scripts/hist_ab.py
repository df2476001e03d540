#!/usr/bin/env python3
"""Time the order-0 byte histogram (``fq_hist256``) of one checkout of the
port on one GPU, beside the design variants of ``scripts/hist_variants.cu``.

Imports ``fastqpacker_tpu_torch`` from ``--root`` (a checkout of the repo,
for example the parent commit unpacked with ``git archive`` into a
git-ignored directory), builds its ``csrc/hist256.cu`` and counts, through
the checkout's ``hist256`` wrapper, these streams:

- ``walk_qual``, ``walk_seq``: the quality (15.1 MB) and sequence (3.8 MB)
  streams of the first 100,000-record v3 block of ``synth_fastq(40,
  seed=seed + 4, qual_model="walk")`` (the v3 main path's fixture), on the
  card where the stream build left them;
- ``ordered_qual``, ``ordered_seq``: the same streams of the first block of
  ``ordered_illumina_fastq(100000, seed=seed + 19)`` (``chip_smoke.py``'s
  ``phase=tokens`` corpus);
- ``alternating``, ``walk_deltas``, ``uniform``, ``one_symbol``: 15.1 MB of
  two bytes in turn (every byte a new run, all lanes on two slots), of the
  walk model's quality steps (``utils/synth.py:walk_steps``: 72% zeros in
  short runs), of uniform random bytes, and of one byte
  (``chip_smoke.py:hist_streams``).

For each stream and design: device ms (CUDA events over launches queued
behind a sleep kernel, inputs rotated past the L2 cache: ``chip_smoke.py``'s
timing), the bound (the bytes read once and the 256 counts written once over
3.35 TB/s), ``torch.bincount`` of the same bytes (printed only: the port
never calls it), the device operations of one call (``torch.profiler``), host
microseconds per call, and a SHA-256 of the counts, which must be equal for
every design and checkout (each is also held against ``torch.bincount``).

``--variants 0,2`` adds the modes of ``scripts/hist_variants.cu`` (built with
the package's nvcc flags into the checkout's ``_build/``; mode 0 is the
design before the redesign, mode 5 the loads alone, whose counts are not
held). ``--split`` adds each design's per-phase microseconds of one launch
(the checkout's own when its library exports ``fq_hist256_split``, and every
variant's): the zeroing of the tables, the counting loop (with its loads:
mode 5 gives the loads alone), the CTA's table sum and adds, the ticket, the
last CTA's read-out, the launch's span. ``--encode`` times instead, per
stream, the wall ms of one ``rans.encode_stream`` call from host bytes and,
where the checkout takes them, from the stream's device view and counts
(equal payloads). ``--check-only`` times nothing: every design against
``torch.bincount`` on the streams above, the edges of
``tests/torch_tokens_inputs.py:hist_edge_cases`` and a stream of one byte
long enough for every thread's counters to flush (``--flush-bytes``).

Compare two checkouts inside one call, in turns: parent, change, change,
parent. Prints one JSON line per run.

Usage: python3 scripts/hist_ab.py --root DIR [--label NAME] [--stream NAME]...
       [--variants 0,1,...] [--split] [--check-only] [--flush-bytes N]
       [--iters 50] [--seed 0] [--encode]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
VARIANTS_SRC = REPO / "scripts" / "hist_variants.cu"
VARIANT_NAMES = {0: "parent", 1: "lane_rmw", 2: "lane_atom", 3: "lane_atom_runs", 4: "warp_runs",
                 5: "floor", 6: "lane_atom_x2", 7: "lane_atom_x4", 8: "col_512x2", 9: "col_1024",
                 10: "col_256x4", 11: "col_512x2_c8", 12: "col_512x2_fin", 13: "col_256x4_fin",
                 14: "lane_atom_fin", 15: "ring", 16: "ring_spread", 17: "ring8",
                 18: "col_1024_fin", 19: "col_512x2_fin_min2", 20: "col_512x2_fin_pair",
                 21: "col_512x2_fin_b2", 22: "col_512x2_fin_b1"}
FLOOR = 5  # the loads alone: its counts are not the histogram
STREAMS = ("walk_qual", "walk_seq", "ordered_qual", "ordered_seq", "alternating",
           "walk_deltas", "uniform", "one_symbol")  # chip_smoke.HIST_STREAMS
EMPTY = "empty"  # 0 bytes: a launch and its read-out alone
HOST_CALLS = 50
STAMP_WORDS = 8  # a variant's timeline a CTA
# the package's (csrc/hist256.cu kStampWords): start, zeroed, counted, added, SM, threads
PACKAGE_STAMP_WORDS = 6


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Variants:
    """The modes of ``scripts/hist_variants.cu``: each call allocates its
    output (and, for mode 0, its partials, as the parent's wrapper did);
    every mode shares one accumulator and ticket, left at 0 by each launch."""

    def __init__(self, build, dev):
        import torch

        digest = hashlib.sha256(VARIANTS_SRC.read_bytes() + " ".join(build.NVCC_FLAGS).encode())
        path = build.BUILD_DIR / f"libhist_variants_{digest.hexdigest()[:16]}.so"
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(path), str(VARIANTS_SRC)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            print(f"hist_ab: built {VARIANTS_SRC.name}\n{proc.stdout}{proc.stderr}", file=sys.stderr)
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fq_hist_variant_ctas.argtypes = [i, ll, i, i]
        lib.fq_hist_variant.argtypes = [i, p, ll, i, p, p, p, p, p, p]
        self.lib, self.dev = lib, dev
        self.sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.acc = torch.zeros((16 * 256,), dtype=torch.int64, device=dev)
        self.ticket = torch.zeros((1,), dtype=torch.int32, device=dev)

    def ctas(self, mode: int, view) -> int:
        return self.lib.fq_hist_variant_ctas(mode, view.numel(), view.data_ptr() % 16, self.sms)

    def __call__(self, mode: int, view, stamps=None):
        import torch

        n = view.numel()
        ctas = self.ctas(mode, view)
        partials = torch.empty((ctas * 256 if mode == 0 else 1,), dtype=torch.int64,
                               device=self.dev)
        out = torch.empty((256,), dtype=torch.int64, device=self.dev)
        rc = self.lib.fq_hist_variant(
            mode, view.data_ptr() if n else None, n, ctas, self.acc.data_ptr(),
            partials.data_ptr(), self.ticket.data_ptr(), out.data_ptr(),
            None if stamps is None else stamps.data_ptr(),
            torch.cuda.current_stream(self.dev).cuda_stream)
        if rc:
            raise RuntimeError(f"hist variant {mode}: cudaError_t {rc}")
        return out


def own_split(ck, build):
    """The checkout's ``fq_hist256_split`` as ``(view, stamps) -> counts``,
    or None where its library has none."""
    import torch

    lib = build.load("hist256")
    try:
        fn = lib.fq_hist256_split
    except AttributeError:
        return None
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ll, i, p, p, p, p]

    def call(view, stamps):
        d = view.device
        n = view.numel()
        ctas = lib.fq_hist256_ctas(n, view.data_ptr() % 16, ck._sm_count(d))
        st, _ = ck._chained_state(d, 1)
        out = torch.empty((256,), dtype=torch.int64, device=d)
        rc = fn(view.data_ptr() if n else None, n, ctas, st.acc.data_ptr(), out.data_ptr(),
                stamps.data_ptr(), torch.cuda.current_stream(d).cuda_stream)
        if rc:
            raise RuntimeError(f"fq_hist256_split: cudaError_t {rc}")
        return out

    call.ctas = lambda view: lib.fq_hist256_ctas(view.numel(), view.data_ptr() % 16,
                                                ck._sm_count(view.device))
    call.words = PACKAGE_STAMP_WORDS
    return call


def encode_routes(streams: dict, calls: int) -> dict:
    """Wall ms per ``rans.encode_stream`` call of each stream (host clock
    around a synchronised call, mean over ``calls`` after one warm-up): from
    the host bytes (upload, count, encode) and, where the checkout's
    ``encode_stream`` takes them, from the stream's device view and its
    counts (the v3 pick's route since the estimate hands its counts on);
    the payloads must be equal."""
    import inspect

    import torch
    from fastqpacker_tpu_torch.ops import rans

    out = {}
    for name, view in streams.items():
        s = view.cpu().numpy().tobytes()
        hist = rans.histogram(view)
        routes = {"host_bytes": lambda: rans.encode_stream(s, device=view.device)}
        if "view" in inspect.signature(rans.encode_stream).parameters:
            routes["view_and_counts"] = lambda: rans.encode_stream(s, device=view.device,
                                                                   view=view, hist=hist)
        row, payloads = {}, set()
        for route, fn in routes.items():
            payloads.add(hashlib.sha256(fn()).hexdigest())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            row[route] = (time.perf_counter() - t0) / calls * 1e3
        if len(payloads) != 1:
            raise RuntimeError(f"{name}: the encode routes' payloads differ")
        row["sha256"] = payloads.pop()
        print(f"hist_ab encode {name} " + " ".join(f"{k}={v:.3f}ms" for k, v in row.items()
                                                  if k != "sha256"), file=sys.stderr)
        out[name] = row
    return out


def split_of(run, ctas_of, sets, words: int = STAMP_WORDS, launches: int = 8) -> dict:
    """Per-phase microseconds of one launch (means over ``launches``
    launches on inputs rotated past the L2): per CTA the zeroing, the
    counting loop (its mean, and the last CTA's end of it from the launch's
    first start), the table sum with its adds, the ticket; the last CTA's
    read-out; the launch's span and the spread of its CTAs' starts."""
    import torch

    rows = []
    for k in range(launches):
        (view,) = sets[(k * 3) % len(sets)]
        ctas = ctas_of(view)
        stamps = torch.zeros((ctas * words,), dtype=torch.int64, device=view.device)
        torch.cuda.synchronize()
        run(view, stamps)
        torch.cuda.synchronize()
        s = stamps.view(ctas, words).cpu().numpy().astype(np.float64)
        if words == PACKAGE_STAMP_WORDS:  # no ticket, no last CTA: the adds end the CTA
            s = s[:, [0, 1, 2, 3, 3, 3, 4, 5]]
        t0 = s[:, 0].min()
        last = int(np.argmax(s[:, 5]))
        rows.append({
            "zero": np.mean(s[:, 1] - s[:, 0]),
            "loop": np.mean(s[:, 2] - s[:, 1]),
            "loop_end_max": np.max(s[:, 2] - t0),
            "cta_sum": np.mean(s[:, 3] - s[:, 2]),
            "ticket": np.mean(s[:, 4] - s[:, 3]),
            "last_cta": s[last, 5] - s[last, 4],
            "span": s[:, 5].max() - t0,
            "start_spread": s[:, 0].max() - t0,
            "ctas": ctas,
            "sms": len(set(s[:, 6].astype(int).tolist())),
        })
    return {k: (rows[0][k] if k in ("ctas", "sms") else float(np.mean([r[k] for r in rows])) / 1e3)
            for k in rows[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--stream", action="append", choices=STREAMS + (EMPTY,),
                    help="default: all but empty")
    ap.add_argument("--variants", default="", help="comma-separated modes of hist_variants.cu")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--flush-bytes", type=int, default=0,
                    help="--check-only: also a one-byte stream of this length")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--encode", action="store_true",
                    help="time the v3 rANS encode of each stream instead (see encode_routes)")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("hist_ab: no CUDA device", file=sys.stderr)
        return 1
    from fastqpacker_tpu_torch.ops import build
    from fastqpacker_tpu_torch.ops import cuda_kernels as ck

    imported = Path(build.__file__).resolve()
    if root not in imported.parents:
        raise RuntimeError(f"imported {imported}, not the checkout under {root}")
    # this checkout's timing helpers and input generators
    cs = load("chip_smoke", REPO / "chip_smoke.py")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = cs.DEV
    build.load("hist256")
    modes = [int(m) for m in args.variants.split(",") if m.strip()]
    var = Variants(build, dev) if modes else None
    designs = {"package": ck.hist256}
    for m in modes:
        designs[f"variant_{VARIANT_NAMES[m]}"] = (lambda mode: lambda v: var(mode, v))(m)
    names = args.stream or list(STREAMS)
    streams = cs.hist_streams([k for k in names if k != EMPTY], args.seed)
    if EMPTY in names:
        streams[EMPTY] = torch.empty((0,), dtype=torch.uint8, device=dev)
    label = args.label or root.name

    if args.encode:
        print(json.dumps({"label": label, "card": smi,
                          "encode": encode_routes(streams, args.iters)}))
        return 0

    if args.check_only:
        ti = load("hist_ab_inputs", REPO / "tests" / "torch_tokens_inputs.py")
        cases = {name: view for name, view in streams.items()}
        for case, (buf, off, n) in sorted(ti.hist_edge_cases().items()):
            cases[f"edge_{case}"] = cs.on_card(buf[off : off + n], off % 16)
        if args.flush_bytes:
            cases["flush_one_symbol"] = torch.full((args.flush_bytes,), 5, dtype=torch.uint8,
                                                   device=dev)
        held = {}
        for case, view in cases.items():
            if case == "flush_one_symbol":
                want = torch.zeros((256,), dtype=torch.int64, device=dev)
                want[5] = view.numel()
            else:
                want = torch.bincount(view, minlength=256)
            for dname, fn in designs.items():
                if dname == f"variant_{VARIANT_NAMES[FLOOR]}":
                    continue
                for _ in range(2):  # the accumulator and ticket come back to 0
                    got = fn(view)
                    if not torch.equal(got, want):
                        raise RuntimeError(f"{dname} on {case}: counts differ from bincount")
                held[dname] = held.get(dname, 0) + 1
        torch.cuda.synchronize()
        print(f"hist_ab {label} check-only held={json.dumps(held)}", file=sys.stderr)
        print(json.dumps({"label": label, "card": smi, "check_only": True, "held": held,
                          "cases": len(cases), "flush_bytes": args.flush_bytes}))
        return 0

    splits = {}
    if args.split:
        own = own_split(ck, build)
        if own is not None:
            splits["package"] = (own, own.ctas, own.words)
        for m in modes:
            splits[f"variant_{VARIANT_NAMES[m]}"] = (
                (lambda mode: lambda v, st: var(mode, v, st))(m),
                (lambda mode: lambda v: var.ctas(mode, v))(m), STAMP_WORDS)
    report = {}
    for sname, view in streams.items():
        n = view.numel()
        sets = cs.retile(view, max(2, -(-150_000_000 // n)) if n else 2)
        want = torch.bincount(view, minlength=256)
        bound_ms = cs.bound(n + 256 * 8, 0)[0]
        lib_ms = cs.gpu_ms(lambda t: torch.bincount(t, minlength=256), sets, 10)
        row = {"bytes": n, "misalign": view.data_ptr() % 16, "bound_ms": bound_ms,
               "bincount_ms": lib_ms, "designs": {}}
        for dname, fn in designs.items():
            got = fn(view)
            floor = dname == f"variant_{VARIANT_NAMES[FLOOR]}"
            if not floor and not torch.equal(got, want):
                raise RuntimeError(f"{dname} on {sname}: counts differ from bincount")
            d = {"sha256": None if floor else hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()}
            d["ms"] = cs.gpu_ms(fn, sets, args.iters)
            d["share"] = bound_ms / d["ms"]
            ops = cs.device_ops(lambda: fn(view))
            d["device_ops"] = len(ops)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn(view)
            d["host_us"] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
            torch.cuda.synchronize()
            if dname in splits:
                run, ctas_of, words = splits[dname]
                d["split_us"] = split_of(run, ctas_of, sets, words)
            row["designs"][dname] = d
            print(f"hist_ab {label} {sname} {dname} ms={d['ms']:.6f} bound_ms={bound_ms:.6f} "
                  f"share={d['share']:.3f} device_ops={len(ops)} host_us={d['host_us']:.1f} "
                  f"bincount_ms={lib_ms:.6f}"
                  + (f" split_us={json.dumps({k: round(v, 3) for k, v in d['split_us'].items()})}"
                     if "split_us" in d else ""), file=sys.stderr)
        shas = {d["sha256"] for d in row["designs"].values() if d["sha256"]}
        if len(shas) != 1:
            raise RuntimeError(f"{sname}: designs disagree")
        report[sname] = row
        del sets
    print(json.dumps({"label": label, "card": smi, "streams": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
