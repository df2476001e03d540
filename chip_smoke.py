#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fastqpacker_tpu_torch``) on one GPU.

Phases, each fatal on failure:

1. device: the card's name, count, and ``nvidia-smi`` name and power limit;
2. build: the dense codec kernels from ``fastqpacker_tpu_torch/csrc`` with
   nvcc for sm_90a, with the build time and the ``-Xptxas -v`` report;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (R = 37,500 and 100,000 records, L = 160) and at
   edge shapes; outputs must be byte-equal (tolerance 0). Times come from
   CUDA events over many launches queued behind a sleep kernel, inputs
   rotated past the L2 cache;
4. end to end: compress and decompress of ``--mb`` MiB of synthetic FASTQ
   (seeded by ``--seed``) on the card at the default block size, checked
   against the input and against the port's own CPU compress, with the
   launch counters reset just before and read just after each direction;
   then a variable-length (50-300 bp) run.

Prints one JSON line of kernel numbers, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py [--mb 256] [--seed 0] [--varlen-mb 16]
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
ENCODE_REPLACES = "fastqpacker_tpu/ops/pallas_kernels.py:41"
DECODE_REPLACES = "fastqpacker_tpu/ops/pallas_kernels.py:186"
KERNEL_SOURCE = "fastqpacker_tpu_torch/csrc/dense_codec.cu"
DEV = torch.device("cuda")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def dense_inputs(rng, r, l, alphabet=b"ACGT", n_rate=0.001, full_len=None,
                 offset=33):
    """Padded (seq, qual, lengths) as the pipeline stages them: SEQ_PAD 0
    and QUAL_PAD 0xFF past each length."""
    if full_len is None:
        lengths = rng.integers(0, l + 1, size=r).astype(np.int32)
        lengths[: max(1, r // 8)] = 0  # empty rows
        lengths[-1] = l
    else:
        lengths = np.full(r, full_len, dtype=np.int32)
    ab = np.frombuffer(alphabet, np.uint8)
    seq = ab[rng.integers(0, len(ab), size=(r, l))]
    if n_rate:
        k = max(1, int(r * l * n_rate))
        seq[rng.integers(0, r, k), rng.integers(0, l, k)] = ord("N")
    qual = rng.integers(offset, offset + 42, size=(r, l)).astype(np.uint8)
    pad = np.arange(l)[None, :] >= lengths[:, None]
    seq[pad] = 0
    qual[pad] = 0xFF
    return seq, qual, lengths


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def gpu_ms(fn, arg_sets, iters: int) -> float:
    """Mean device ms per call of ``fn(*args)``, rotating over
    ``arg_sets``. The calls are queued behind a sleep kernel, so the
    events time the device's back-to-back work, not the host's enqueue."""
    for args in arg_sets:  # warm up
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(enqueue_s * 2.5 + 0.002, 2.0) * 2e9))
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotations(tensors, bytes_per_call: int) -> list:
    """Copies of ``tensors`` enough to move > 150 MB between two calls of
    the same inputs (three times the 50 MB L2)."""
    k = max(2, -(-150_000_000 // bytes_per_call))
    return [tuple(t.clone() for t in tensors) for _ in range(k)]


def encode_bytes(r: int, l: int) -> int:
    # reads seq, qual (R*L each) and lengths; writes packed (L/4),
    # nmask (L/8), deltas (L) per row and n_counts
    return 2 * r * l + 4 * r + r * (-(-l // 4)) + r * (-(-l // 8)) + r * l + 4 * r


def decode_bytes(r: int, l: int) -> int:
    # reads packed and deltas, writes bases and qualities (the kernel does
    # not read lengths)
    return r * (-(-l // 4)) + r * l + 2 * r * l


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def max_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def kernel_case(ck, devops, rng, r, l, offset, alphabet, full_len=None,
                n_rate=0.001, tail_n=False):
    seq, qual, lengths = dense_inputs(rng, r, l, alphabet, n_rate, full_len,
                                      offset)
    if tail_n:  # Ns past the 65,536-position tracking cap
        seq[:, -8:] = ord("N")
    dev = DEV
    s, q, n = (torch.from_numpy(x).to(dev) for x in (seq, qual, lengths))
    got = ck.encode_arrays(s, q, n, offset)
    ref = devops.encode_arrays_plain(s, q, n, offset)
    enc_err = max(max_err(a, b) for a, b in zip(got, ref))
    check(enc_err == 0, f"encode kernel == plain at R={r} L={l} off={offset}")
    seq_k, qual_k = ck.decode_arrays(ref.packed, ref.qual_delta, n, offset)
    seq_p, qual_p = devops.decode_arrays_plain(ref.packed, ref.qual_delta, n,
                                               offset)
    dec_err = max(max_err(seq_k, seq_p), max_err(qual_k, qual_p))
    check(dec_err == 0, f"decode kernel == plain at R={r} L={l} off={offset}")
    # decode restores the input within each length (N aside)
    mask = torch.arange(l, device=dev)[None, :] < n[:, None].long()
    check(bool((qual_k[mask] == q[mask]).all()), f"qual round trip R={r} L={l}")
    torch.cuda.synchronize()
    return (s, q, n), ref, enc_err, dec_err


def phase_kernels(ck, devops, rng) -> dict:
    edge = [
        (4, 8, 33, b"ACGTNacgt.RY"),
        (16, 31, 64, b"ACGTNacgt.RY"),
        (8, 152, 33, b"ACGTNacgt.RY"),
        (300, 64, 64, b"ACGTNacgt.RY"),
        (3, 1, 33, b"ACGTNacgt.RY"),
        (33, 1040, 33, b"acgtACGTN"),
    ]
    errs = {ck.ENCODE: 0, ck.DECODE: 0}
    for r, l, off, ab in edge:
        _, _, e, d = kernel_case(ck, devops, rng, r, l, off, ab)
        errs[ck.ENCODE] = max(errs[ck.ENCODE], e)
        errs[ck.DECODE] = max(errs[ck.DECODE], d)
        print(f"phase=kernels edge R={r} L={l} offset={off} byte_equal=true")
    _, ref, e, d = kernel_case(ck, devops, rng, 3, 65544, 33, b"ACGT",
                               full_len=65544, n_rate=0, tail_n=True)
    errs[ck.ENCODE] = max(errs[ck.ENCODE], e)
    errs[ck.DECODE] = max(errs[ck.DECODE], d)
    check(bool((ref.n_counts == 0).all()), "no N counted past the cap")
    print("phase=kernels edge R=3 L=65544 offset=33 tail_N_past_cap=true "
          "byte_equal=true")

    out = {}
    for r in (37_500, 100_000):
        l = 160
        for off in (33, 64):
            inputs, ref, e, d = kernel_case(ck, devops, rng, r, l, off, b"ACGT",
                                            full_len=151)
            errs[ck.ENCODE] = max(errs[ck.ENCODE], e)
            errs[ck.DECODE] = max(errs[ck.DECODE], d)
        s, q, n = inputs
        enc_sets = rotations((s, q, n), encode_bytes(r, l))
        dec_sets = rotations((ref.packed, ref.qual_delta, n), decode_bytes(r, l))
        for name, fn, plain, sets, nbytes in (
            (ck.ENCODE, ck.encode_arrays, devops.encode_arrays_plain,
             enc_sets, encode_bytes(r, l)),
            (ck.DECODE, ck.decode_arrays, devops.decode_arrays_plain,
             dec_sets, decode_bytes(r, l)),
        ):
            kms = gpu_ms(lambda *a: fn(*a, off), sets, 200)
            pms = gpu_ms(lambda *a: plain(*a, off), sets, 20)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            print(
                f"phase=kernels kernel={name} R={r} L={l} kernel_ms={kms:.6f} "
                f"bound_us={bound_ms * 1e3:.3f} bytes={nbytes} "
                f"plain_ms={pms:.6f} library_ms=null "
                f"roofline_share={bound_ms / kms:.3f} max_abs_err={errs[name]}"
            )
            out[(name, r)] = (kms, pms, bound_ms)
        del enc_sets, dec_sets
    return {"errs": errs, "times": out}


def count_blocks(container_bytes: bytes, ft) -> int:
    c = ft.container
    r = io.BytesIO(container_bytes)
    fh = c.read_file_header(r)
    n = 0
    while (hdr := c.read_block_header(r, fh.version)) is not None:
        r.seek(sum(hdr.stream_sizes(fh.version)), io.SEEK_CUR)
        n += 1
    return n


def round_trip(ft, ck, data: bytes, label: str) -> dict:
    """Compress then decompress ``data`` on the card, each direction with
    the counters reset just before and read just after; check the output
    and the container against the port's CPU compress."""
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    comp = ft.compress_bytes(data, device=DEV)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    enc_launches = ck.launches[ck.ENCODE]
    check(ck.launches[ck.DECODE] == 0, "compress launched no decode")

    ck.reset_launches()
    t0 = time.perf_counter()
    out = ft.decompress_bytes(comp, device=DEV)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    dec_launches = ck.launches[ck.DECODE]

    blocks = count_blocks(comp, ft)
    check(out == data, f"{label}: decompressed output equals the input")
    check(enc_launches == blocks > 0, f"{label}: one encode launch per block")
    check(dec_launches == blocks, f"{label}: one decode launch per block")
    t0 = time.perf_counter()
    cpu = ft.compress_bytes(data, device="cpu")
    t_cpu = time.perf_counter() - t0
    check(cpu == comp, f"{label}: GPU container byte-identical to CPU's")
    mb = len(data) / 1e6
    print(
        f"phase=e2e run={label} input_bytes={len(data)} container_bytes="
        f"{len(comp)} blocks={blocks} compress_s={t_c:.4f} "
        f"compress_MBps={mb / t_c:.2f} decompress_s={t_d:.4f} "
        f"decompress_MBps={mb / t_d:.2f} encode_launches={enc_launches} "
        f"decode_launches={dec_launches} cpu_compress_s={t_cpu:.4f} "
        f"byte_identical_to_cpu=true round_trip=true"
    )
    return {"encode": enc_launches, "decode": dec_launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, default=256)
    ap.add_argument("--varlen-mb", type=float, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import fastqpacker_tpu_torch as ft
    from fastqpacker_tpu_torch.ops import build
    from fastqpacker_tpu_torch.ops import cuda_kernels as ck
    from fastqpacker_tpu_torch.ops import device as devops
    from fastqpacker_tpu_torch.utils.synth import synth_fastq

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"phase=device name={kind!r} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    build.load("dense_codec")
    info = build.builds["dense_codec"]
    print(f"phase=build seconds={info.seconds:.2f} load_seconds="
          f"{time.perf_counter() - t0:.2f} library={info.path.name}")
    for line in info.log.splitlines():
        if "ptxas" in line:
            print(f"phase=build {line.strip()}")

    rng = np.random.default_rng(args.seed)
    kern = phase_kernels(ck, devops, rng)

    ft.compress_bytes(synth_fastq(1, seed=args.seed + 1), device=DEV)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    data = synth_fastq(args.mb, seed=args.seed)
    main_launches = round_trip(ft, ck, data, f"iid151_{args.mb:g}MiB")
    print(f"phase=e2e max_memory_allocated={torch.cuda.max_memory_allocated()}")
    del data
    varlen = synth_fastq(args.varlen_mb, read_len=300, min_len=50,
                         seed=args.seed + 2)
    round_trip(ft, ck, varlen, f"varlen50_300_{args.varlen_mb:g}MiB")

    kernels = []
    for name, launches_key, replaces in (
        (ck.ENCODE, "encode", ENCODE_REPLACES),
        (ck.DECODE, "decode", DECODE_REPLACES),
    ):
        kms, pms, bound_ms = kern["times"][(name, 37_500)]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": replaces,
            "launches": main_launches[launches_key],
            "max_abs_err": kern["errs"][name],
            "ms": kms,
            "plain_ms": pms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
