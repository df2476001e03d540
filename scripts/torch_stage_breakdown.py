#!/usr/bin/env python3
"""Serial per-stage times of the PyTorch/CUDA port's paths on one GPU.

Runs each stage of the compress and decompress pipeline of
``fastqpacker_tpu_torch`` one block at a time, on one thread, and prints
the mean milliseconds per block of each: host stages on the host clock,
copies and kernels with CUDA events. The pipeline overlaps these stages
across its worker threads; this script shows what each one costs alone,
so the slowest can be named.

``--format v2`` (default) walks the FQZ v2 stages by hand: the text's copy
to the card and its record scan (``c.h2d_text``, ``c.scan``; ``parse`` is the
parser's whole time, its synchronisation included), the row gathers, the
dense encode and the stream build (``c.gather``, ``c.encode_kernel``,
``c.streams``), the copy back and zstd; on decompress zstd, the streams'
one copy in, the gathers, the dense decode, the assembly (``d.assemble``)
and the text's copy back. ``--format v3``
runs the v3 block encoder and decoder (``pipeline/native.py``) with its
stages wrapped in timers, on data whose quality streams are coded with
order-0 rANS: CRC32, zstd candidates, pick estimates, rANS encode and
decode (with their copies), the context prepare passes (the kernels
``c.qctx_prepare`` and ``c.sctx_prepare``, and the calls around them with
their copies), and the context coders and tokenizer when they run; ``--corpus ordered``
runs it on names in instrument order (``utils/synth.py``
``ordered_illumina_fastq``), whose header streams the tokenizer codes
(``c.tok_encode``, ``d.tok_decode`` and their kernels); ``--corpus markov`` on
whole 100,000-record blocks of the context-model corpus (Markov bases, Phred
walks), whose streams the context coders code (``c.qctx_encode``,
``c.sctx_encode``, ``d.qctx_decode``, ``d.sctx_decode``, and their kernels
``*.kernel``; the encodes' compaction is ``c.rans_encode.compact_kernel``). Every order-0
histogram of the v3 and mesh picks is ``fq_hist256`` (``*.hist256.kernel``).
``--format mesh`` does the same for the ``--mesh`` path
(``pipeline/meshpipe.py`` on a one-device list) on whole 100,000-record
blocks of the context-model corpus, one round at a time: the plan (the
prepare passes on the card, estimates, zstd candidates, CRC32), the context
coder's prep (lane layout and tables on the host, the lane matrices on the
card: ``c.wctx_layout``), copies, kernels, the finish, and the batched
decode (``d.wctx_layout`` for the start matrices, ``d.wctx_unlayout`` for
the wire bytes). A stage named ``x(incl. ...)`` contains the stages named
``x.*``.

``--root DIR`` imports the package from another checkout (for example the
parent commit unpacked with ``git archive`` into a git-ignored directory), so
two checkouts can be compared in one call, in turns; a stage that the
checkout lacks is not timed.

Usage: python3 scripts/torch_stage_breakdown.py [--format v2|v3|mesh] [--mb 64]
                                                [--seed 0] [--corpus walk|ordered|markov]
                                                [--root DIR]
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

ROOT = Path(__file__).resolve().parent.parent
if "--root" in sys.argv[:-1]:
    ROOT = Path(sys.argv[sys.argv.index("--root") + 1]).resolve()
sys.path.insert(0, str(ROOT))

from fastqpacker_tpu_torch.entropy import zstd as zstd_entropy  # noqa: E402
from fastqpacker_tpu_torch.ops import cuda_kernels  # noqa: E402
from fastqpacker_tpu_torch.ops import records as recops  # noqa: E402
from fastqpacker_tpu_torch.parser.fastq import FastqStreamParser  # noqa: E402
from fastqpacker_tpu_torch.pipeline import api  # noqa: E402
from fastqpacker_tpu_torch.pipeline import blocks as blockcodec  # noqa: E402
from fastqpacker_tpu_torch.utils.synth import ordered_illumina_fastq, synth_fastq  # noqa: E402


class Clock:
    """Accumulates host ms per stage and device ms per stage (events)."""

    def __init__(self):
        self.ms: dict[str, float] = {}
        self._events: list = []

    def host(self, name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    def device(self, name, fn, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        self._events.append((name, start, end))
        return out

    def settle(self):
        torch.cuda.synchronize()
        for name, start, end in self._events:
            self.ms[name] = self.ms.get(name, 0.0) + start.elapsed_time(end)
        self._events.clear()


def warm_parse(dev: torch.device) -> None:
    """The parser's first use in a process (context, library, buffers),
    outside the timed parse."""
    list(FastqStreamParser(io.BytesIO(synth_fastq(1)), block_size=1000, device=dev).blocks())
    torch.cuda.synchronize()


def to_host(t):
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)


def breakdown_v3(data: bytes, dev: torch.device) -> tuple[dict, int, int]:
    """Per-stage ms of the v3 block encoder and decoder, stages timed by
    wrapping the functions ``pipeline/native.py`` calls."""
    from fastqpacker_tpu_torch.ops import crc32, ctxprep, qualctx, rans, seqctx, sldm, tokenize
    from fastqpacker_tpu_torch.pipeline import native

    c = Clock()
    direction = ["c."]

    def wrap(kind, owner, attr, label):
        fn = getattr(owner, attr, None)
        if fn is None:  # a checkout without this stage
            return
        timer = c.host if kind == "host" else c.device

        def timed(*args, **kwargs):
            return timer(direction[0] + label, fn, *args, **kwargs)

        setattr(owner, attr, timed)

    for owner, attr, label in (
        (blockcodec, "dispatch_raw_streams", "raw_streams(incl. gather, dense encode, stream build)"),
        (blockcodec.PendingStreams, "result", "raw_streams.fetch(wait, d2h)"),
        (blockcodec, "streams_to_fastq", "fastq_assembly(incl. copies, gather, dense decode)"),
        (crc32, "crc32_device", "crc32(incl. copies)"),
        (native, "_zstd_candidate", "zstd_candidates"),
        (zstd_entropy.ZstdCodec, "decompress", "zstd"),
        (native, "_rans_size_estimate", "pick.rans_size_estimate"),
        (seqctx, "sample_estimate", "pick.sctx_sample_estimate"),
        (sldm, "coverage_probe", "pick.coverage_probe"),
        (qualctx, "sample_estimate", "pick.qctx_sample_estimate"),
        (qualctx, "prepare", "pick.qctx_prepare(incl. copies, kernel)"),
        (seqctx, "prepare", "pick.sctx_prepare(incl. copies, kernel)"),
        (ctxprep.Symbols, "numpy", "symbols_to_host"),
        (qualctx, "pick_model", "pick.qctx_pick_model"),
        (seqctx, "pick_order", "pick.sctx_pick_order"),
        (qualctx, "encode_prepared", "qctx_encode"),
        (seqctx, "encode_prepared", "sctx_encode"),
        (qualctx, "decode", "qctx_decode"),
        (seqctx, "decode", "sctx_decode"),
        (tokenize, "encode", "tok_encode"),
        (tokenize, "decode", "tok_decode"),
        (rans, "encode_stream", "rans_encode(incl. copies)"),
        (rans, "decode_stream", "rans_decode(incl. copies)"),
    ):
        wrap("host", owner, attr, label)
    for owner, attr, label in (
        (cuda_kernels, "encode_arrays", "dense_encode.kernel"),
        (cuda_kernels, "decode_arrays", "dense_decode.kernel"),
        (cuda_kernels, "rows_gather", "gather.kernel"),
        (cuda_kernels, "streams_build", "streams.kernel"),
        (cuda_kernels, "fastq_assemble", "assemble.kernel"),
        (cuda_kernels, "rans_encode", "rans_encode.kernel"),
        (cuda_kernels, "rans_compact", "rans_encode.compact_kernel"),
        (cuda_kernels, "rans_decode", "rans_decode.kernel"),
        (cuda_kernels, "crc32_chunks", "crc32.kernel"),
        (cuda_kernels, "hist256", "hist256.kernel"),
        (cuda_kernels, "tok_encode", "tok_encode.kernels(incl. read-back)"),
        (cuda_kernels, "tok_decode", "tok_decode.kernels(incl. read-backs)"),
        (cuda_kernels, "qctx_prepare", "qctx_prepare"),
        (cuda_kernels, "sctx_prepare", "sctx_prepare"),
        (cuda_kernels, "wctx_layout", "wctx_layout"),
        (cuda_kernels, "wctx_unlayout", "wctx_unlayout"),
        (cuda_kernels, "qctx_encode", "qctx_encode.kernel"),
        (cuda_kernels, "sctx_encode", "sctx_encode.kernel"),
        (cuda_kernels, "qctx_decode", "qctx_decode.kernel"),
        (cuda_kernels, "sctx_decode", "sctx_decode.kernel"),
        (rans, "to_device", "rans.h2d"),
        (crc32, "to_device", "crc32.h2d"),
    ):
        wrap("device", owner, attr, label)

    block_size = api.DEFAULT_BLOCK_SIZE
    warm_parse(dev)
    blocks = c.host("parse", lambda: list(
        FastqStreamParser(io.BytesIO(data), block_size=block_size, device=dev).blocks()))
    _, qual_offset = api.peek_detection(iter(blocks))
    codec = zstd_entropy.get_codec()
    native.encode_block_native(blocks[-1], qual_offset, dev)  # warm-up
    c.settle()
    parse_ms = c.ms["parse"]
    c.ms.clear()
    c.ms["parse"] = parse_ms

    comps = []
    for blk in blocks:
        comps.append(c.host("c.block_total", native.encode_block_native, blk,
                            qual_offset, dev))
        c.settle()
    direction[0] = "d."
    v3 = blockcodec.container.VERSION_3_NATIVE
    for warm in (True, False):  # the first pass warms the decompress side up
        for comp in comps:
            hdr = blockcodec.container.parse_block_header(comp, v3)
            payload = comp[blockcodec.container.BLOCK_HEADER_SIZE_V3 :]
            c.host("d.block_total", native.decode_block_payload, hdr, payload,
                   codec, qual_offset, dev)
            c.settle()
        if warm:
            c.ms = {k: v for k, v in c.ms.items() if not k.startswith("d.")}
    c.ms["tags(seq, qual) per block"] = block_tags(comps)
    return c.ms, len(blocks), block_size


def block_tags(comps: list) -> list:
    """(seq, qual) codec tags of each v3 block's bytes (header and payload)."""
    from fastqpacker_tpu_torch.format import container

    at = container.BLOCK_HEADER_SIZE_V3
    return [[TAGS[comp[at]], TAGS[comp[at + container.parse_block_header(comp, 3).seq_data_size]]]
            for comp in comps]


def breakdown_mesh(data: bytes, dev: torch.device) -> tuple[dict, int, int]:
    """Per-stage ms per block of ``compress_mesh`` / ``decompress_mesh`` on
    the device list ``[dev]``, one round (= one block) at a time, stages
    timed by wrapping the functions the path calls."""
    from fastqpacker_tpu_torch.format import container
    from fastqpacker_tpu_torch.ops import ctxprep, qualctx, seqctx, sldm, wctx
    from fastqpacker_tpu_torch.pipeline import meshpipe, native

    c = Clock()
    direction = ["c."]

    def wrap(kind, owner, attr, label):
        fn = getattr(owner, attr)
        timer = c.host if kind == "host" else c.device

        def timed(*args, **kwargs):
            return timer(direction[0] + label, fn, *args, **kwargs)

        setattr(owner, attr, timed)

    for owner, attr, label in (
        (native, "_raw_streams", "raw_streams(incl. gather, dense encode, stream build, copies)"),
        (meshpipe, "_plan_round", "plan(incl. plan.*)"),
        (seqctx, "prepare", "plan.seqctx_prepare(incl. copies, kernel)"),
        (qualctx, "prepare", "plan.qualctx_prepare(incl. copies, kernel)"),
        (ctxprep.Symbols, "numpy", "symbols_to_host"),
        (qualctx, "pick_model", "plan.qctx_pick_model"),
        (qualctx, "encode_prepared", "plan.qctx_encode(python)"),
        (wctx, "estimate_size", "plan.wctx_estimate_size"),
        (native, "_zstd_candidate", "zstd_candidates(plan and finish)"),
        (native, "_rans_size_estimate", "plan.rans_size_estimate"),
        (sldm, "coverage_probe", "plan.coverage_probe"),
        (native, "_crc_streams", "crc32(incl. copies)"),
        (meshpipe, "_dispatch_round", "dispatch(incl. prep.*, wctx.h2d, kernels)"),
        (wctx, "prepare_encode", "prep(incl. prep.*, wctx_layout)"),
        (ctxprep, "lane_layout", "lane_layout(prep and decode)"),
        (wctx, "normalize_tables", "prep.normalize_tables"),
        (meshpipe, "_finish_round", "finish(incl. finish.*)"),
        (wctx, "fetch_encoded", "finish.fetch(wait, d2h)"),
        (wctx, "assemble_payload", "finish.assemble_payload"),
        (native, "_encode_tagged_headers", "finish.headers"),
        (wctx, "parse_stream", "parse_stream"),
        (wctx, "fetch_decoded", "fetch(wait, d2h of the wire bytes)"),
        (native, "decode_block_payload", "block_payload(incl. zstd, crc32, fastq_assembly)"),
        (blockcodec, "streams_to_fastq", "fastq_assembly(incl. copies, gather, dense decode)"),
    ):
        wrap("host", owner, attr, label)
    for owner, attr, label in (
        (cuda_kernels, "fastq_assemble", "assemble.kernel"),
        (cuda_kernels, "streams_build", "streams.kernel"),
        (wctx, "to_device", "wctx.h2d"),
        (cuda_kernels, "wctx_encode", "wctx_encode.kernel"),
        (cuda_kernels, "rans_encode", "rans_encode.kernel"),
        (cuda_kernels, "rans_compact", "compact.kernel"),
        (cuda_kernels, "wctx_decode", "wctx_decode.kernel"),
        (cuda_kernels, "rans_decode", "rans_decode.kernel"),
        (cuda_kernels, "hist256", "hist256.kernel"),
        (cuda_kernels, "tok_encode", "tok_encode.kernels(incl. read-back)"),
        (cuda_kernels, "tok_decode", "tok_decode.kernels(incl. read-backs)"),
        (cuda_kernels, "qctx_prepare", "qctx_prepare"),
        (cuda_kernels, "sctx_prepare", "sctx_prepare"),
        (cuda_kernels, "wctx_layout", "wctx_layout"),
        (cuda_kernels, "wctx_unlayout", "wctx_unlayout"),
    ):
        wrap("device", owner, attr, label)

    mesh = [dev]
    block_size = api.DEFAULT_BLOCK_SIZE
    warm_parse(dev)
    blocks = c.host("parse", lambda: list(
        FastqStreamParser(io.BytesIO(data), block_size=block_size, device=dev).blocks()))
    _, qual_offset = api.peek_detection(iter(blocks))

    def encode(blk):
        raw = native._raw_streams(blk, qual_offset)
        return meshpipe._encode_round([raw], mesh)[0]

    encode(blocks[-1])  # warm-up
    c.settle()
    parse_ms = c.ms["parse"]
    c.ms.clear()
    c.ms["parse"] = parse_ms
    comps = []
    for blk in blocks:
        comps.append(c.host("c.block_total", encode, blk))
        c.settle()
    direction[0] = "d."
    head = io.BytesIO()
    container.FileHeader(
        version=container.VERSION_3_NATIVE, block_size=block_size, flags=0
    ).write(head)
    for warm in (True, False):  # the first pass warms the decompress side up
        out = io.BytesIO()
        for comp in comps:
            c.host("d.block_total", meshpipe.decompress_mesh,
                   io.BytesIO(head.getvalue() + comp), out, mesh)
            c.settle()
        if warm:
            c.ms = {k: v for k, v in c.ms.items() if not k.startswith("d.")}
    if out.getvalue() != data:
        raise RuntimeError("mesh breakdown: the round trip differs from the input")
    c.ms["tags(seq, qual) per block"] = block_tags(comps)
    return c.ms, len(blocks), block_size


TAGS = {0: "rans", 1: "zstd", 2: "tok", 3: "qctx", 4: "sctx", 5: "sldm", 6: "wctx"}


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--format", choices=["v2", "v3", "mesh"], default="v2", dest="fmt")
    ap.add_argument("--mb", type=float, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus", choices=["walk", "ordered", "markov"], default="walk",
                    help="v3: walk qualities (every quality stream TAG_RANS), names in "
                         "instrument order (every header stream TAG_TOK) or whole blocks of "
                         "the context-model corpus (TAG_SCTX / TAG_QCTX)")
    ap.add_argument("--root", default=None, help="the checkout whose package runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stage_breakdown: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if args.fmt == "mesh":
        one = len(synth_fastq(0))
        n_blocks = max(1, int(args.mb * (1 << 20) / one) // api.DEFAULT_BLOCK_SIZE)
        data = synth_fastq(
            (n_blocks * api.DEFAULT_BLOCK_SIZE * one + one // 2) / (1 << 20),
            seed=args.seed, qual_model="phredwalk", seq_model="markov",
        )
        ms, n, block_records = breakdown_mesh(data, dev)
        tags = ms.pop("tags(seq, qual) per block")
        print(json.dumps({
            "format": "mesh",
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi_line(),
            "input_bytes": len(data),
            "blocks": n,
            "block_records": block_records,
            "tags": tags,
            "ms_per_block": {k: v / n for k, v in sorted(ms.items())},
        }))
        return 0
    if args.fmt == "v3":
        if args.corpus == "ordered":
            one = len(ordered_illumina_fastq(1000, seed=args.seed)) / 1000
            data = ordered_illumina_fastq(int(args.mb * (1 << 20) / one), seed=args.seed)
        elif args.corpus == "markov":
            one = len(synth_fastq(0))
            n_blocks = max(1, int(args.mb * (1 << 20) / one) // api.DEFAULT_BLOCK_SIZE)
            data = synth_fastq(
                (n_blocks * api.DEFAULT_BLOCK_SIZE * one + one // 2) / (1 << 20),
                seed=args.seed, qual_model="phredwalk", seq_model="markov",
            )
        else:
            data = synth_fastq(args.mb, seed=args.seed, qual_model="walk")
        ms, n, block_records = breakdown_v3(data, dev)
        tags = ms.pop("tags(seq, qual) per block")
        print(json.dumps({
            "format": "v3",
            "corpus": args.corpus,
            "root": str(ROOT),
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi_line(),
            "input_bytes": len(data),
            "blocks": n,
            "block_records": block_records,
            "tags": tags,
            "ms_per_block": {k: v / n for k, v in sorted(ms.items())},
        }))
        return 0
    data = synth_fastq(args.mb, seed=args.seed)
    r_pad = api.SPEED_BLOCK_SIZE
    codec = zstd_entropy.get_codec()
    c = Clock()
    warm = synth_fastq(1, seed=args.seed + 1)  # build, allocator, first launches
    blockcodec.block_to_raw_streams(
        next(FastqStreamParser(io.BytesIO(warm), block_size=r_pad, device=dev).blocks()), 33)
    warm_parse(dev)

    blocks = c.host("parse", lambda: list(
        FastqStreamParser(io.BytesIO(data), block_size=r_pad, device=dev).blocks()))
    _, qual_offset = api.peek_detection(iter(blocks))

    comps = []
    for blk in blocks:
        # the parser's two device stages again, timed alone
        host = torch.from_numpy(blk.text.copy())
        text = c.device("c.h2d_text", lambda: host.to(dev, non_blocking=True))
        c.device("c.scan", cuda_kernels.records_scan, text, r_pad)
        width = blockcodec.bucket_len(blk.max_len)
        rows = c.device("c.gather", lambda: (blk.rows("seq", r_pad, width),
                                             blk.rows("qual", r_pad, width)))
        lens = torch.zeros((r_pad,), dtype=torch.int32, device=dev)
        lens[: blk.n] = blk.dev_offsets[:, 3]
        enc = c.device("c.encode_kernel", cuda_kernels.encode_arrays, *rows, lens, qual_offset)
        sizes = recops.stream_sizes(blk.info, False)
        buf, _ = c.device("c.streams", cuda_kernels.streams_build, blk.dev_text,
                          blk.dev_offsets, enc.packed, enc.qual_delta, enc.nmask_bits,
                          enc.n_counts, False, sizes)
        c.device("c.d2h", to_host, buf)
        c.settle()
        raw = c.host("c.build_total(incl. gather, encode, streams, d2h)",
                     blockcodec.block_to_raw_streams, blk, qual_offset)
        comps.append(c.host("c.zstd", blockcodec.compress_raw_streams, raw, codec, 2))

    # warm-up of the decompress side (its kernels' first launches, buffers)
    warm_hdr = blockcodec.container.parse_block_header(comps[0], 2)
    blockcodec.streams_to_fastq(blockcodec.decode_streams(
        warm_hdr, comps[0][blockcodec.container.BLOCK_HEADER_SIZE_V2 :], 2, codec),
        qual_offset, dev)
    for comp in comps:
        hdr = c.host("d.block_header", blockcodec.container.parse_block_header, comp, 2)
        payload = comp[blockcodec.container.BLOCK_HEADER_SIZE_V2 :]
        ds = c.host("d.zstd", blockcodec.decode_streams, hdr, payload, 2, codec)
        r = ds.num_records
        parts = [ds.lengths, ds.seq, ds.qual, ds.headers, ds.plus, ds.npos]

        def stage():
            staged = torch.empty(sum(len(p) for p in parts), dtype=torch.uint8, pin_memory=True)
            view, at = staged.numpy(), 0
            for p in parts:
                view[at : at + len(p)] = p
                at += len(p)
            return staged

        staged = c.host("d.stage_pinned", stage)
        on_dev = c.device("d.h2d", lambda: staged.to(dev, non_blocking=True))
        cut = np.cumsum([0] + [len(p) for p in parts])
        len_t, seq_t, qual_t, hdr_t, plus_t, npos_t = (
            on_dev[cut[i] : cut[i + 1]] for i in range(6))
        lens = len_t.view(torch.int32).to(torch.int64)
        width = blockcodec.bucket_len(int(ds.lengths.view("<u4").max()))
        deltas, packed = c.device("d.gather", lambda: cuda_kernels.rows_gather(
            qual_t, None, lens, r, width, 0, quarter=(seq_t, width // 4)))
        seq, qual = c.device("d.decode_kernel", cuda_kernels.decode_arrays, packed, deltas,
                             lens.to(torch.int32), qual_offset)
        out, _ = c.device("d.assemble", cuda_kernels.fastq_assemble, seq, qual, lens, hdr_t,
                          plus_t, npos_t, False, len(ds.lengths), len(ds.seq), len(ds.qual))
        c.device("d.d2h", to_host, out)
        c.settle()
        c.host("d.fastq_total(incl. stage, h2d, gather, decode, assemble, d2h)",
               blockcodec.streams_to_fastq, ds, qual_offset, dev)

    n = len(blocks)
    result = {
        "format": "v2",
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi_line(),
        "input_bytes": len(data),
        "blocks": n,
        "block_records": r_pad,
        "ms_per_block": {k: v / n for k, v in c.ms.items()},
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
