#!/usr/bin/env python3
"""Serial per-stage times of the PyTorch/CUDA port's FQZ v2 path on one GPU.

Runs each stage of the compress and decompress pipeline of
``fastqpacker_tpu_torch`` one block at a time, on one thread, and prints
the mean milliseconds per block of each: host stages on the host clock,
copies and kernels with CUDA events. The pipeline overlaps these stages
across its worker threads; this script shows what each one costs alone,
so the slowest can be named.

Usage: python3 scripts/torch_stage_breakdown.py [--mb 64] [--seed 0]
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fastqpacker_tpu_torch.entropy import zstd as zstd_entropy  # noqa: E402
from fastqpacker_tpu_torch.ops import cuda_kernels  # noqa: E402
from fastqpacker_tpu_torch.parser.fastq import (  # noqa: E402
    QUAL_PAD,
    SEQ_PAD,
    FastqStreamParser,
)
from fastqpacker_tpu_torch.pipeline import api  # noqa: E402
from fastqpacker_tpu_torch.pipeline import blocks as blockcodec  # noqa: E402
from fastqpacker_tpu_torch.pipeline.device import _bucket_len  # noqa: E402
from fastqpacker_tpu_torch.ops import reference as refops  # noqa: E402
from fastqpacker_tpu_torch.utils.synth import synth_fastq  # noqa: E402


class Clock:
    """Accumulates host ms per stage and device ms per stage (events)."""

    def __init__(self):
        self.ms: dict[str, float] = {}
        self._events: list = []

    def host(self, name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    def device(self, name, fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        self._events.append((name, start, end))
        return out

    def settle(self):
        torch.cuda.synchronize()
        for name, start, end in self._events:
            self.ms[name] = self.ms.get(name, 0.0) + start.elapsed_time(end)
        self._events.clear()


def pinned(shape, dtype, fill):
    return torch.empty(shape, dtype=dtype, pin_memory=True).fill_(fill)


def to_host(t):
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stage_breakdown: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    data = synth_fastq(args.mb, seed=args.seed)
    r_pad = api.SPEED_BLOCK_SIZE
    codec = zstd_entropy.get_codec()
    c = Clock()

    blocks = c.host("parse", lambda: list(
        FastqStreamParser(io.BytesIO(data), block_size=r_pad).blocks()))
    _, qual_offset = api.peek_detection(iter(blocks))
    # warm-up: build, allocator, first launch
    s = torch.zeros((r_pad, 160), dtype=torch.uint8, device=dev)
    cuda_kernels.encode_arrays(s, s, torch.zeros(r_pad, dtype=torch.int32, device=dev), 33)
    torch.cuda.synchronize()

    comps = []
    for blk in blocks:
        l_pad = _bucket_len(blk.max_len)

        def stage():
            seq = pinned((r_pad, l_pad), torch.uint8, SEQ_PAD)
            qual = pinned((r_pad, l_pad), torch.uint8, QUAL_PAD)
            lens = pinned((r_pad,), torch.int32, 0)
            seq.numpy()[: blk.n, : blk.max_len] = blk.seq
            qual.numpy()[: blk.n, : blk.max_len] = blk.qual
            lens.numpy()[: blk.n] = blk.lengths
            return seq, qual, lens

        host_in = c.host("c.stage_pinned", stage)
        dev_in = c.device("c.h2d", lambda: [t.to(dev, non_blocking=True) for t in host_in])
        enc = c.device("c.encode_kernel", cuda_kernels.encode_arrays, *dev_in, qual_offset)
        outs = c.device("c.d2h", lambda: [to_host(x[: blk.n]) for x in enc])
        c.settle()
        arrays = refops.EncodedArrays(*(t.numpy() for t in outs))
        raw = c.host("c.stream_assembly", blockcodec.encoded_to_raw_streams, blk, arrays)
        comps.append(c.host("c.zstd", blockcodec.compress_raw_streams, raw, codec, 2))

    for comp in comps:
        hdr = c.host("d.block_header", blockcodec.container.parse_block_header, comp, 2)
        payload = comp[blockcodec.container.BLOCK_HEADER_SIZE_V2 :]
        ds = c.host("d.zstd", blockcodec.decode_streams, hdr, payload, 2, codec)

        def decoder(packed, qual_delta, lengths, off):
            n, l = qual_delta.shape
            lp = _bucket_len(l)

            def stage():
                pk = pinned((r_pad, lp // 4), torch.uint8, 0)
                qd = pinned((r_pad, lp), torch.uint8, 0)
                ln = pinned((r_pad,), torch.int32, 0)
                pk.numpy()[:n, : packed.shape[1]] = packed
                qd.numpy()[:n, :l] = qual_delta
                ln.numpy()[:n] = lengths
                return pk, qd, ln

            t0 = time.perf_counter()
            host_in = c.host("d.stage_pinned", stage)
            dev_in = c.device("d.h2d", lambda: [t.to(dev, non_blocking=True) for t in host_in])
            seq, qual = c.device("d.decode_kernel", cuda_kernels.decode_arrays, *dev_in, off)
            outs = c.device("d.d2h", lambda: [to_host(x[:n]) for x in (seq, qual)])
            c.settle()
            decoder.ms += (time.perf_counter() - t0) * 1e3
            return outs[0].numpy()[:, :l], outs[1].numpy()[:, :l]

        decoder.ms = 0.0
        c.host("d.fastq_assembly", blockcodec.streams_to_fastq, ds, qual_offset, decoder)
        # the assembly stage's own time, without the decoder it calls
        c.ms["d.fastq_assembly"] -= decoder.ms

    n = len(blocks)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    result = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "input_bytes": len(data),
        "blocks": n,
        "block_records": r_pad,
        "ms_per_block": {k: v / n for k, v in c.ms.items()},
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
