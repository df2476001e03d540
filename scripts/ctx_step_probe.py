#!/usr/bin/env python3
"""One thread's dependent step on the card (``scripts/ctx_step_probe.cu``): a
load chain through shared memory, global loads cached in the L1
(``ld.global.ca``, 64 KiB), in the L2 only (``.cg``, 8 MiB) and through the
read-only path (``__ldg``, 64 KiB and 1.5 MiB: the model-0 slot table's size),
and one encode step of the context coders (``csrc/ctxcoder.cu``), in cycles and
ns a step. Prints one JSON line. Needs a CUDA card and nvcc (built with the
package's flags into its ``_build/``).

    python scripts/ctx_step_probe.py [--steps 1000000]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from fastqpacker_tpu_torch.ops import build  # noqa: E402

SRC = REPO / "scripts" / "ctx_step_probe.cu"
MODES = {0: "shared", 1: "l1", 2: "l2", 3: "encode_step", 4: "read_only_64k", 5: "read_only_1.5m"}


def load() -> ctypes.CDLL:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(build.NVCC_FLAGS).encode())
    path = build.BUILD_DIR / f"libctx_step_probe_{digest.hexdigest()[:16]}.so"
    if not path.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(path), str(SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ctx_step_probe.argtypes = [p, ll, i, ll, p, p, p]
    lib.ctx_step_probe.restype = i
    return lib


def cycle(n: int, seed: int) -> torch.Tensor:
    """n u32 words holding one random cycle through all of them."""
    perm = np.random.default_rng(seed).permutation(n).astype(np.uint32)
    t = np.empty(n, np.uint32)
    t[perm] = np.roll(perm, -1)
    return torch.from_numpy(t.view(np.int32)).cuda()


def encode_params() -> torch.Tensor:
    rows = []
    for f, cum in ((1, 0), (3, 7), (17, 100), (300, 900), (1000, 3000), (2047, 2000),
                   (2731, 1300), (4000, 96)):
        s = (f - 1).bit_length()
        m = ((1 << (32 + s)) + f - 1) // f - (1 << 32)
        rows += [f, m, s, cum]
    return torch.from_numpy(np.array(rows, np.uint32).view(np.int32)).cuda()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1_000_000)
    args = ap.parse_args()
    lib = load()
    params = encode_params()
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    tables = {0: cycle(4096, 1), 1: cycle(16384, 2), 2: cycle(2 << 20, 3), 3: cycle(4096, 4),
              4: cycle(16384, 5), 5: cycle(384 * 1024, 6)}
    result = {"device": torch.cuda.get_device_name(0), "steps": args.steps}
    for mode, name in MODES.items():
        t = tables[mode]
        rows = []
        for _ in range(3):
            rc = lib.ctx_step_probe(t.data_ptr(), t.numel(), min(mode, 4), args.steps,
                                    params.data_ptr(), out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"probe mode {mode}: cudaError_t {rc}")
            cyc, ns, _ = out.tolist()
            rows.append((cyc / args.steps, ns / args.steps))
        cyc, ns = min(rows)
        result[name] = {"cycles_per_step": round(cyc, 2), "ns_per_step": round(ns, 3),
                        "table_bytes": t.numel() * 4 if mode != 3 else 0}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
