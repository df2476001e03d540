#!/usr/bin/env python3
"""One thread's dependent step on the card (``scripts/ctx_step_probe.cu``): a
load chain through shared memory, global loads cached in the L1
(``ld.global.ca``, 64 KiB), in the L2 only (``.cg``, 8 MiB) and through the
read-only path (``__ldg``, 64 KiB and 1.5 MiB: the model-0 slot table's size),
one encode step of the context coders (``csrc/ctxcoder.cu``), and the
critical paths of the two decodes' steps (the qctx dense step: a row offset, a
32-bit shared load a lane, two ballots and two popcounts; the sctx step: a
16-byte row load, three compares, selects and an add), in cycles and ns a step. Prints one JSON line. Needs a CUDA card and nvcc (built with the
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
MODES = {0: "shared", 1: "l1", 2: "l2", 3: "encode_step", 4: "read_only_64k", 5: "read_only_1.5m",
         6: "qctx_dense_step", 7: "sctx_step", 8: "qctx_dense_redux", 9: "qctx_split_ballot",
         10: "qctx_split_redux"}
# the qctx dense rows of the markov151 corpus at model 1: 41 symbols (0 among
# them) and the sentinel column, W = 42 u16 a row, 8 x 42 x 7 rows
DENSE_W, DENSE_LANES, DENSE_ROWS = 42, 21, 8 * 42 * 7
SCTX_ORDER = 6


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


def dense_rows(seed: int) -> torch.Tensor:
    """Qctx dense rows: each row a few present symbols' cums (0, then
    nondecreasing, 4096 from the first absent column on), padded so that
    every lane's load stays inside."""
    rng = np.random.default_rng(seed)
    rows = np.full((DENSE_ROWS, DENSE_W), 4096, np.uint16)
    for r in range(DENSE_ROWS):
        cuts = np.sort(rng.integers(1, 4096, rng.integers(0, 3)))
        first = rng.integers(0, 41 - len(cuts))
        rows[r, :first + 1] = 0
        rows[r, first + 1 : first + 1 + len(cuts)] = cuts
    flat = np.concatenate([rows.reshape(-1), np.zeros(64, np.uint16)])
    return torch.from_numpy(flat.view(np.int32)).cuda()


def sctx_rows(seed: int) -> torch.Tensor:
    """Sctx rows {c1, c2, c3, c4} (u32) at order 6."""
    rng = np.random.default_rng(seed)
    c = np.sort(rng.integers(0, 4097, (4**SCTX_ORDER, 3)), axis=1)
    rows = np.concatenate([c, np.full((4**SCTX_ORDER, 1), 4096)], axis=1).astype(np.uint32)
    return torch.from_numpy(rows.reshape(-1).view(np.int32)).cuda()


def dense_params() -> torch.Tensor:
    w2 = 2 * DENSE_W
    p = [w2, DENSE_LANES, 7 * w2, 42 * 7 * w2, (4**SCTX_ORDER - 1) * 16]
    return torch.from_numpy(np.array(p, np.uint32).view(np.int32)).cuda()


TABLES = {0: lambda: cycle(4096, 1), 1: lambda: cycle(16384, 2), 2: lambda: cycle(2 << 20, 3),
          3: lambda: cycle(4096, 4), 4: lambda: cycle(16384, 5), 5: lambda: cycle(384 * 1024, 6),
          6: lambda: dense_rows(7), 7: lambda: sctx_rows(8), 8: lambda: dense_rows(7),
          9: lambda: dense_rows(7), 10: lambda: dense_rows(7)}


def measure(modes=tuple(MODES), steps: int = 1_000_000) -> dict:
    """The probe's ``modes`` (best of 3 each): name -> cycles and ns a step,
    and the clock (GHz) from the shared-load chain's cycles over its ns
    (mode 0 is always run)."""
    lib = load()
    params = encode_params()
    dparams = dense_params()
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": torch.cuda.get_device_name(0), "steps": steps}
    for mode in sorted(set(modes) | {0}):
        t = TABLES[mode]()
        rows = []
        for _ in range(3):
            rc = lib.ctx_step_probe(t.data_ptr(), t.numel(), mode if mode > 5 else min(mode, 4),
                                    steps, (dparams if mode > 5 else params).data_ptr(),
                                    out.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"probe mode {mode}: cudaError_t {rc}")
            cyc, ns, _ = out.tolist()
            rows.append((cyc / steps, ns / steps))
        cyc, ns = min(rows)
        result[MODES[mode]] = {"cycles_per_step": round(cyc, 2), "ns_per_step": round(ns, 3),
                               "table_bytes": t.numel() * 4 if mode != 3 else 0}
    result["clock_ghz"] = round(result["shared"]["cycles_per_step"]
                                / result["shared"]["ns_per_step"], 4)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1_000_000)
    args = ap.parse_args()
    print(json.dumps(measure(steps=args.steps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
