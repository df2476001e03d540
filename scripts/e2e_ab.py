#!/usr/bin/env python3
"""Time the FQZ v2 round trip of one checkout of the port on one GPU.

Imports ``fastqpacker_tpu_torch`` from ``--root`` (a checkout of the repo,
for example the parent commit unpacked with ``git archive`` into a
git-ignored directory), builds its kernels and runs ``compress_bytes`` and
``decompress_bytes`` on the card over ``--mb`` MiB of ``chip_smoke.py``'s
v2 corpus (``utils/synth.py``'s default: 151-bp IID bases, ~0.1% N, tiled
qualities, fixed-width headers; this checkout's generator, seeded, so both
checkouts read the same bytes), after a warm-up round trip of the same
size, as ``chip_smoke.py``'s phase e2e does.

Prints one JSON line: each direction's wall seconds and MB/s (10^6 bytes of
FASTQ over host seconds that end in a synchronisation) for each of
``--repeats`` round trips, the container's size and SHA-256 (equal for two
checkouts that write the same container), the round trip's check, and the
card's name and power limit. Compare two checkouts inside one call, in
turns: parent, change, change, parent.

Usage: python3 scripts/e2e_ab.py --root DIR [--mb 96] [--seed 0] [--repeats 2]
       [--label NAME]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--mb", type=float, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("e2e_ab: no CUDA device", file=sys.stderr)
        return 1
    import fastqpacker_tpu_torch as ft

    imported = Path(ft.__file__).resolve()
    if root not in imported.parents:
        raise RuntimeError(f"imported {imported}, not the checkout under {root}")
    spec = importlib.util.spec_from_file_location(
        "e2e_ab_synth", REPO / "fastqpacker_tpu_torch" / "utils" / "synth.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    warm = synth.synth_fastq(args.mb, seed=args.seed + 1)
    if ft.decompress_bytes(ft.compress_bytes(warm, device=dev), device=dev) != warm:
        raise RuntimeError("warm-up round trip differs from its input")
    del warm
    data = synth.synth_fastq(args.mb, seed=args.seed)
    mb = len(data) / 1e6
    runs, digests = [], set()
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp = ft.compress_bytes(data, device=dev)
        torch.cuda.synchronize()
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = ft.decompress_bytes(comp, device=dev)
        torch.cuda.synchronize()
        t_d = time.perf_counter() - t0
        if out != data:
            raise RuntimeError("decompressed output differs from the input")
        digests.add(hashlib.sha256(comp).hexdigest())
        runs.append({"compress_s": t_c, "compress_MBps": mb / t_c, "decompress_s": t_d,
                     "decompress_MBps": mb / t_d})
        del out
    if len(digests) != 1:
        raise RuntimeError("the repeats wrote different containers")
    label = args.label or str(root)
    for r in runs:
        print(f"e2e_ab {label} compress_MBps={r['compress_MBps']:.2f} "
              f"decompress_MBps={r['decompress_MBps']:.2f}", file=sys.stderr)
    print(json.dumps({"label": label, "card": smi, "input_bytes": len(data),
                      "container_bytes": len(comp), "sha256": digests.pop(),
                      "round_trip": True, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
