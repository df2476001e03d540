#!/usr/bin/env python3
"""Time one ``--mesh`` round of four blocks on one GPU, for one checkout.

Imports ``fastqpacker_tpu_torch`` from ``--root`` (a checkout of the repo,
for example the parent commit unpacked with ``git archive`` into a
git-ignored directory), builds its kernels and runs ``compress_mesh`` and
``decompress_mesh`` of ``--records`` records of the context-model corpus
(``chip_smoke.py``'s ``markov151_mesh``: order-1 Markov bases, per-record
quality walks, 151 bp, seeded) at 100,000-record blocks through a mesh of
four entries: the first four cards, or the one card listed four times. With
four blocks that is one round, whose four blocks are prepared and launched
by one thread in a checkout without the per-device worker threads and by
four in one with them (``parallel.mesh.for_each_device``); ``--one-thread``
runs a checkout that has them on the calling thread instead.

Prints one JSON line: the wall seconds of each direction (host clock, after
a warm-up round of 3,000 records), the container's size and SHA-256 (equal
for two checkouts that write the same container), the round trip, and the
card's name and power limit. Compare two checkouts inside one call, in
turns: parent, change, change, parent.

Usage: python3 scripts/mesh_round_ab.py --root DIR [--records 400000]
       [--seed 6] [--one-thread] [--label NAME]
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

BLOCK_RECORDS = 100_000
READ_LEN = 151


def corpus(synth_fastq, n_records: int, seed: int) -> bytes:
    one = len(synth_fastq(0, read_len=READ_LEN))
    data = synth_fastq((n_records * one + one // 2) / (1 << 20), read_len=READ_LEN, seed=seed,
                       qual_model="phredwalk", seq_model="markov")
    assert data.count(b"\n") == 4 * n_records
    return data


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--records", type=int, default=4 * BLOCK_RECORDS)
    ap.add_argument("--seed", type=int, default=6)
    ap.add_argument("--one-thread", action="store_true")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("mesh_round_ab: no CUDA device", file=sys.stderr)
        return 1
    import fastqpacker_tpu_torch as ft
    from fastqpacker_tpu_torch.ops import build
    from fastqpacker_tpu_torch.parallel import mesh as pmesh
    from fastqpacker_tpu_torch.pipeline import meshpipe
    from fastqpacker_tpu_torch.utils.synth import synth_fastq

    if Path(build.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {build.__file__}, not the checkout under {root}")
    if args.one_thread:
        orig = pmesh.for_each_device
        pmesh.for_each_device = lambda m, f, items, threads=None: orig(m, f, items, False)
    build.load_all()
    n = torch.cuda.device_count()
    mesh = [torch.device("cuda", i) for i in range(4)] if n >= 4 else [torch.device("cuda", 0)] * 4
    opts = ft.Options(version=ft.container.VERSION_3_NATIVE)
    warm = corpus(synth_fastq, 3000, args.seed + 100)
    out = io.BytesIO()
    meshpipe.decompress_mesh(io.BytesIO(meshpipe.compress_mesh_bytes(warm, opts, mesh)), out, mesh)
    assert out.getvalue() == warm

    data = corpus(synth_fastq, args.records, args.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp = meshpipe.compress_mesh_bytes(data, opts, mesh)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    out = io.BytesIO()
    t0 = time.perf_counter()
    meshpipe.decompress_mesh(io.BytesIO(comp), out, mesh)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    mb = len(data) / 1e6
    print(json.dumps({
        "label": args.label or root.name, "root": str(root), "one_thread": args.one_thread,
        "devices": [str(d) for d in mesh], "records": args.records,
        "input_bytes": len(data), "container_bytes": len(comp),
        "sha256": hashlib.sha256(comp).hexdigest(),
        "compress_s": t_c, "decompress_s": t_d,
        "compress_MBps": mb / t_c, "decompress_MBps": mb / t_d,
        "round_trip": out.getvalue() == data, "gpu": smi.strip(),
    }))
    return 0 if out.getvalue() == data else 1


if __name__ == "__main__":
    sys.exit(main())
