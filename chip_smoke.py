#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fastqpacker_tpu_torch``) on one GPU.

Phases, each fatal on failure:

1. device: the card's name, count, and ``nvidia-smi`` name and power limit;
2. build: every kernel source under ``fastqpacker_tpu_torch/csrc`` with nvcc
   for sm_90a (one nvcc per source, started together), with the build times
   and the ``-Xptxas -v`` report;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at edge shapes; outputs must be byte-equal
   (tolerance 0). Dense codec: byte-equal at ragged tiles and odd lengths
   (R = 1, 15, 16, 17, 33; L = 1, 8, 31, 151), on both sides of the
   long-row threshold, at L = 1,040 and 65,544, with a packed matrix wider
   than ceil(L/4), outputs contiguous at exact widths; timed at 37,500 x
   160, 100,000 x 160, 100,000 x 151 and 37,500 x 320 beside a plain
   ``copy_`` of the same bytes (``copy_ms``), and at 100,000 x 151 one
   wrapper call must run one CUDA kernel (``torch.profiler``).
   Order-0 rANS (encode, compact, decode): 256, 4,096 and 16,384 lanes with
   ragged last rows, one-symbol and 256-symbol streams, decode(encode(x))
   == x, a stream that lost words raises; timed at the v3 path's quality
   stream (15.1 MB, 16,384 lanes) and sequence stream (3.8 MB, 4,096
   lanes), the encode beside its per-step time (one warp per CTA), the
   decode beside its launch geometry (CTAs x threads, lanes per thread,
   shared bytes, registers); the compaction byte-equal to its plain version
   and to ``torch.masked_select`` at 1 cell, a tile - 1, a tile, a tile + 1
   and 20 M cells (several waves of CTAs), at flag densities 0, 0.001,
   0.11, 0.5, 1 and with flag bytes of 2 and 255, and one wrapper call at
   15.1 M cells must run its three CUDA kernels and nothing else
   (``torch.profiler``); at 16,384 lanes the decode's other
   cluster geometry, 16 CTAs x 1,024 threads with one lane each, is built
   from a copy of the package (``scripts/rans_ab.py --set
   kCtaThreads=1024``, in its own process), held against the plain version
   and timed beside the default 16 x 256 x 4. CRC32: equal to
   ``zlib.crc32`` and its plain version at lengths 0, 1, around a chunk, a
   warp's and a CTA's span, several spans and both streams, one launch per
   CRC, a misaligned view refused; timed at both streams. Times come from CUDA events over launches queued behind a
   sleep kernel, inputs rotated past the L2 cache. Each kernel's bound is
   the larger of its bytes (inputs read once, outputs written once) over
   3.35 TB/s and its operations over 67 TOP/s. ``library_ms`` is the time
   of the one PyTorch call that computes the same function, where there is
   one (``torch.masked_select`` for the compaction); the port never calls
   it;
4. end to end, FQZ v2: compress and decompress of ``--mb`` MiB of synthetic
   FASTQ (seeded by ``--seed``) on the card at the default block size,
   checked against the input and against the port's own CPU compress, with
   the launch counters reset just before and read just after each
   direction; then a variable-length (50-300 bp) run;
5. end to end, FQZ v3 (``Options(version=3)``): the same on ``--mb`` MiB of
   data whose quality streams are coded with order-0 rANS, at the v3
   default block size (100,000 records): the stream tags are read from the
   container, the rANS, CRC32 and dense launch counts are held against
   them, and the card's container is held against the CPU's on the first
   48 MiB (the CPU's plain versions are slow);
6. context rANS kernels (``fq_wctx_encode``, ``fq_wctx_decode``) against
   their plain versions, byte-equal, for the sequence model at order 2, 4, 6
   and the quality model at order 0, 1, on 256, 1,024 and 8,192 lanes with
   ragged lanes (zero-length records, lanes with no symbols, one record
   longer than a lane), and at the full width of a v3 block (100,000 records
   of 151 bp = 15.1 M symbols, the lane count the mesh path picks, and the
   sequence model at order 2 on 8,192 lanes), where they are timed, per
   launch and per step, beside their launch geometry (cluster size, threads
   per CTA, table placement, the ``-Xptxas -v`` registers, shared memory and
   spills); a stream that lost words raises. No single PyTorch call
   computes either function (``library_ms`` null). The compaction is timed
   on the encode's own words and flags at the mesh path's two streams
   (sequence order 2 on 4,096 lanes, quality order 1 on 2,048), beside its
   bound and ``torch.masked_select``;
7. the block stages of the C++ runtime as kernels (``phase=records``,
   ``csrc/records.cu``): ``fq_records_scan``, ``fq_rows_gather``,
   ``fq_streams_build`` and ``fq_fastq_assemble`` against their plain
   versions, byte-equal, on a v2 block (37,500 x 151), a block of 50-300 bp
   reads, a v3 block (100,000 x 151, u32 N positions) and blocks of 37,500
   and 100,000 Illumina-style read names of varying width (a header chain
   that is not uniform): the scan's offsets, quality minima and sums, the
   gathers from the text, back to back and the decoder's pair, the six
   streams, the text rebuilt equal to the input. Every kernel (each gather
   route) is timed at every block beside its bound, inputs rotated past the
   L2, with the device operations (``torch.profiler``) and host
   microseconds of one wrapper call; the back-to-back gather beside
   ``torch.nested.nested_tensor_from_jagged(...).to_padded_tensor`` of the
   same runs (``library_ms``; no PyTorch call computes the other routes or
   kernels); on the v2 block the host microseconds of the scan and stream
   build wrappers step by step (``phase=records host_split``). Every scan fault
   and each truncated or flipped stream raises its string on the card as on
   the CPU. Phases 4 and 5 hold their launches (a scan per window, two
   gathers and a stream build per block on compress, one pair gather and an
   assembly per block on decompress), and phase e2e prints
   ``scripts/torch_stage_breakdown.py``'s per-stage ms per block of the v2,
   v3 and mesh paths;
8. the context-model passes as kernels (``phase=ctxprep``,
   ``csrc/ctxprep.cu``): ``fq_qctx_prepare`` and ``fq_sctx_prepare`` against
   their plain versions, byte-equal, on a 100,000 x 151 block of the v3
   corpus (walk qualities) and of the mesh corpus (Markov bases, Phred
   walks), timed beside their bounds and beside ``torch.bincount`` of the
   same histogram keys (printed only: the port never calls it);
   ``fq_wctx_layout`` (the encoder's symbol-index and context matrices, the
   decoder's start matrix) and ``fq_wctx_unlayout`` (packed rows or quality
   deltas; ``torch.masked_select`` of the transposed matrix's data cells
   beside it, printed only) on the mesh block at sequence orders 2, 4, 6 and
   quality orders 0, 1, on the lanes the mesh path picks for each,
   byte-equal, the wire bytes
   equal to the block's own streams; the two length mismatches and an index
   >= npres in a decoded matrix raising their strings on the card as on the
   CPU; the sctx prepare and the layout at their tiles' edges
   (``tests/torch_ctxprep_inputs.py``) against their plain versions; the
   device operations of one call of each (``scripts/ctxprep_ab.py
   --ops-only``: 2 a prepare, 1 a layout or unlayout). Phases 5 and 9 hold
   their launches: every v3 block prepares its
   quality candidate on the card, every mesh block both candidates, one
   layout per wctx encode, one layout and one unlayout per ``TAG_WCTX``
   decode (batched and per block);
9. end to end, ``--mesh`` (``compress_mesh`` / ``decompress_mesh`` on
   ``make_mesh(1)``): ``--mesh-blocks`` blocks of 100,000 records of the
   context-model corpus (order-1 Markov bases, per-record quality walks in
   Phred 0-41); round trip, the ordinary ``decompress`` reads the container,
   the tags are counted per block (``TAG_WCTX`` on every quality stream),
   the launch counts follow the tags, and the card's container equals the
   CPU's on a two-block prefix; then the one card listed four times at a
   block size of 5,000 against the CPU's container for d = 4;
10. the CLI surfaces (``phase=surfaces``) on the v2, v3 and mesh containers
   of phases 4, 5 and 8, at their full size: ``info`` (its block and tag
   counts against the container's), ``check`` on the card (OK and the
   input's size; one dense decode per block, one rANS decode per
   ``TAG_RANS`` stream and CRC32 on v3, two wctx decodes per block on mesh;
   MB/s) and ``check`` of a copy with one flipped payload byte (fails),
   ``cat`` of a range that straddles a block boundary and of the last
   record (the bytes of the input's slice; the decode kernels launch for
   the covering blocks only; the host's index time); ``compress_paired`` /
   ``decompress_paired`` on the card of R1 (even records) and R2 (odd
   records) of the v2 and v3 corpora, the container held against
   ``compress_bytes`` with ``FLAG_PAIRED_END``, one dense encode and decode
   per block and on v3 one rANS encode and compaction per ``TAG_RANS``
   stream; and ``fqscramble`` (host only) on 2 MiB against
   ``gopcg.scramble_text``. Each kernel's row of the JSON line gains
   ``launches_surfaces``, its count in each of those runs;
11. several cards and several hosts (``phase=parallel``), on the corpora of
   phases 4, 5 and 8, on four shard devices: the first four cards, or the one
   card listed four times (then ``multi_card=not_measured``).
   ``encode_blocks_parallel`` / ``decode_sharded`` on four shards of 37,500 x
   151 rows of the v2 corpus: arrays and offsets equal to the CPU's (plain
   versions on four CPU entries), the round trip exact, one dense encode and
   decode per shard; ``entropy_encode_sharded`` / ``entropy_decode_sharded``
   on the four quality-delta rows at 256 lanes and at the tier
   ``rans._pick_lanes`` gives: totals, offsets, a shard's words decoding as a
   standalone stream, the round trip. The ``--mesh`` corpus as one round of
   four blocks through the four shard devices with a worker thread per entry
   and on the calling thread: equal containers, both round trips, wall
   seconds each. Two processes in a gloo group on ``127.0.0.1``
   (``compress_multihost`` then ``decompress_multihost`` of the v2 and the v3
   corpus; each prints its seconds and launches): the file equal to
   ``simulate_multihost(..., 2)`` on the card, its decode equal to the input,
   MB/s per direction; each host's section of a 4 MiB slice equal to the
   CPU's; four simulated hosts on one card decode to the input. Each kernel's
   row of the JSON line gains ``launches_parallel``;
12. ``fqpack bench`` on the card (``phase=bench``): the six kernel metrics
   (``kernel``, ``decode-kernel``, ``mesh-entropy``, ``mesh-entropy-decode``,
   ``wctx-entropy``, ``wctx-entropy-decode``) at ``--mb 16``, each in its own
   process through the CLI: exit 0, one JSON line with the JAX bench's metric
   name and a value > 0, the metric's kernels launched, and its time per
   launch printed beside phase kernels' time of the same kernel (not a gate);
   ``--metric kernel --profile DIR`` writes a ``torch.profiler`` trace that
   names ``fq_dense_encode`` and its device kernel; in process, ``compress``
   / ``decompress`` (v2, v3) of 32 MiB with a short estimator, ``ratio`` of
   16 MiB (round trip checked), ``mesh-e2e`` of 16 MiB with one repeat and
   ``micro``; ``--backend auto`` with the probe cache deleted takes the card
   and gives ``--backend cuda``'s container, and under ``FQZ_BACKEND=cpu``
   the CPU and the same container. Each kernel's row of the JSON line gains
   ``launches_bench``, its count in each of those runs;
13. the runtime's byte histogram and header tokenizer (``phase=tokens``,
   ``csrc/hist256.cu``, ``csrc/tokens.cu``): ``fq_hist256`` against its plain
   version at lengths 0, 1, 15, 16, 17 and past several CTAs, on views at
   each offset 1-15, one-symbol, 256-symbol and skewed streams, two bytes in
   turn, walk deltas, uniform bytes, a wave and the shortest stream that fills
   its grid, less or more one; ``fq_tok_encode`` (from the header lengths and
   from the bare stream) and ``fq_tok_decode`` on every header edge of
   ``tests/torch_tokens_inputs.py`` (count 0, empty headers, tokens of 18 and 19 digits, leading zeros, token
   counts that change, records around and across the tiles, records wider
   than a tile's columns, literals across the chain's tiles, the three name
   corpora), byte-equal, each decode fault's string equal to the CPU's;
   ``tests/testdata/golden/golden_ctx_v3.fqz`` decoded on the card; the three
   timed at a v3 block's streams where the stream build left them (the
   histogram beside ``torch.bincount``, printed only, also at the walk151
   block's streams and 15.1 MB of two bytes in turn, walk deltas, uniform
   bytes and one byte; the encode by both routes), with device operations (the decode's 4 at 100,000 and at 1,000
   records), each tokenizer kernel's device microseconds and host
   microseconds of one wrapper call; a v3 round
   trip of 3 blocks x 100,000 names in instrument order, its container equal
   to the CPU's (made by a subprocess started before the first phase),
   ``TAG_TOK`` on every header stream and the launches following the tags.
   Phases 5 and 9 hold their ``fq_hist256`` launches (one an estimate, none
   for a rANS table, which takes the estimate's counts; on ``--mesh`` one a
   quality estimate or a rANS table) and their tokenizer launches. ``--phase tokens`` runs the
   build and this phase alone;
14. the runtime's context coders (``phase=ctxcoder``, ``csrc/ctxcoder.cu``):
   ``fq_qctx_encode``, ``fq_qctx_decode``, ``fq_sctx_encode`` and ``fq_sctx_decode`` against
   their plain versions (the Python walks), byte-equal, on every case of
   ``tests/torch_ctxcoder_inputs.py`` (the JAX coder tests' cases, chunks with no record, one
   symbol, a binned stream, records and renorms across the decodes' tile edges, chunks shorter
   than a tile, empty records on tile edges) at qctx models 0 and 1 (both decode check modes;
   the dense route and, at 94 symbols, the L2 route) and sctx orders 2, 4 and 6; each decode
   fault's string on the card equal to the CPU's, a chunk that runs out of words at a tile's
   last symbol (the fault's code and symbol index equal to the plain version's), and an encode
   table with no frequency for a present symbol; ``golden_ctx_v3.fqz`` decoded on the card (one
   qctx, sctx and tokenizer decode); the device operations of one wrapper call
   (``scripts/ctxcoder_ab.py --ops-only``: 1 / 1 (dense route) / 2 (L2 route) / 1 / 1); each
   kernel held against its plain version on the first 10,000 records of a 100,000 x 151 block
   of the context-model corpus and timed at the whole block (the model and order the v3 pick
   takes) beside its bound, its µs a step of its longest chain, ``chain_bound_ms`` (that chain's
   steps x the dependent step of ``scripts/ctx_step_probe.py`` measured in this run: a shared
   load for the decodes, the encode's ALU step for the encodes) and the host µs of a wrapper
   call, the qctx decode's route a call, and the qctx pair at a binned 15.1 M-symbol quality
   stream (scarce words); then ``markov151_v3_4x100000``: a v3 round trip of 4 blocks of that
   corpus at the default block size, ``TAG_SCTX`` / ``TAG_QCTX`` on every block, the launches
   following the tags (an encode at least and one compaction an encode, one decode a stream),
   the first block equal to the CPU's container of its records (made by a subprocess started
   before the first phase), MB/s each way. Phases 5 and 9 hold the context coders' launches
   against their tags, phase 10 runs ``info``, ``check`` and ``cat`` on this container too.
   ``--phase ctxcoder`` runs the build and this phase alone.

Each phase of the whole run prints the run's seconds so far (``phase=time``).
Prints one JSON line of kernel numbers, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py [--mb 96] [--varlen-mb 16] [--mesh-blocks 4] [--seed 0]
                             [--phase all|tokens|ctxcoder]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import re
import shutil
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
# The kernels are integer code outside the tensor cores; the published rate
# nearest to that is float32 outside the tensor cores.
OPS_PER_S = 67e12
CSRC = "fastqpacker_tpu_torch/csrc/"
# kernel -> (source, the TPU program it replaces)
KERNELS = {
    "fq_dense_encode": ("dense_codec.cu", "fastqpacker_tpu/ops/pallas_kernels.py:41"),
    "fq_dense_decode": ("dense_codec.cu", "fastqpacker_tpu/ops/pallas_kernels.py:186"),
    "fq_rans_encode": ("rans_codec.cu", "fastqpacker_tpu/ops/rans.py:162"),
    "fq_rans_compact": ("rans_codec.cu", "fastqpacker_tpu/ops/rans.py:218"),
    "fq_rans_decode": ("rans_codec.cu", "fastqpacker_tpu/ops/rans.py:291"),
    "fq_crc32_chunks": ("crc32.cu", "fastqpacker_tpu/ops/crc32.py:87"),
    "fq_wctx_encode": ("wctx_codec.cu", "fastqpacker_tpu/ops/wctx.py:511"),
    "fq_wctx_decode": ("wctx_codec.cu", "fastqpacker_tpu/ops/wctx.py:577"),
    # the C++ runtime's block stages (host functions of the JAX package's
    # device paths)
    "fq_records_scan": ("records.cu", "fastqpacker_tpu/runtime/fqruntime.cpp:206"),
    "fq_rows_gather": ("records.cu", "fastqpacker_tpu/runtime/fqruntime.cpp:527"),
    "fq_streams_build": ("records.cu", "fastqpacker_tpu/runtime/fqruntime.cpp:980"),
    "fq_fastq_assemble": ("records.cu", "fastqpacker_tpu/runtime/fqruntime.cpp:1153"),
    # the context-model passes: the runtime's prepare passes and the host
    # lane passes of the JAX package's wctx coder (start_matrix :178,
    # to_matrix :157, context_matrix :218; from_matrix :170 with
    # seqctx.py:103 pack_stream and pipeline/native.py:348 _raw_to_delta)
    "fq_qctx_prepare": ("ctxprep.cu", "fastqpacker_tpu/runtime/fqruntime.cpp:1629"),
    "fq_sctx_prepare": ("ctxprep.cu", "fastqpacker_tpu/runtime/fqruntime.cpp:2092"),
    "fq_wctx_layout": ("ctxprep.cu", "fastqpacker_tpu/ops/wctx.py:178"),
    "fq_wctx_unlayout": ("ctxprep.cu", "fastqpacker_tpu/ops/wctx.py:170"),
    # the runtime's byte histogram and header tokenizer
    "fq_hist256": ("hist256.cu", "fastqpacker_tpu/runtime/fqruntime.cpp:493"),
    "fq_tok_encode": ("tokens.cu", "fastqpacker_tpu/runtime/fqruntime.cpp:1355"),
    "fq_tok_decode": ("tokens.cu", "fastqpacker_tpu/runtime/fqruntime.cpp:1445"),
    # the runtime's context coders (TAG_QCTX, TAG_SCTX)
    "fq_qctx_encode": ("ctxcoder.cu", "fastqpacker_tpu/runtime/fqruntime.cpp:1654"),
    "fq_qctx_decode": ("ctxcoder.cu", "fastqpacker_tpu/runtime/fqruntime.cpp:1855"),
    "fq_sctx_encode": ("ctxcoder.cu", "fastqpacker_tpu/runtime/fqruntime.cpp:2116"),
    "fq_sctx_decode": ("ctxcoder.cu", "fastqpacker_tpu/runtime/fqruntime.cpp:2343"),
}
QUAL_STREAM = 100_000 * 151  # bytes of a v3 block's quality stream
SEQ_STREAM = 100_000 * 38  # ... and of its packed sequence stream
V3_CPU_BYTES = 48 << 20  # prefix of the v3 input that the CPU compresses too
BLOCK_RECORDS = 100_000  # the v3 default block size
READ_LEN = 151
WCTX_MODELS = [(0, 2), (0, 4), (0, 6), (1, 0), (1, 1)]  # (model, order)
WIDE_LANES = 8192  # the widest tier, which less compressible streams pick
# the order-0 decode's other cluster geometry at 16,384 lanes: 16 CTAs x
# 1,024 threads, one lane each (the default is 16 x 256, four lanes each)
RANS_DECODE_VARIANT = "kCtaThreads=1024"
# the dense kernels' timed shapes (records, row length, read lengths): the
# v2 block at its 32-byte bucket, a v3 / mesh block at 160 and at its true
# length, and the v2 bucket of 50-300 bp reads
DENSE_SHAPES = [(37_500, 160, 151), (100_000, 160, 151), (100_000, 151, 151),
                (37_500, 320, (50, 300))]
DENSE_PROFILED = (100_000, 151)  # the v3 / mesh shape: one kernel per call
# the compaction's edge inputs: flag bytes and their probabilities (the
# densities, and bytes of 2 and 255, which count as kept), and a size that
# spans several waves of CTAs
COMPACT_FLAGS = {
    "none": {0: 1.0}, "0.001": {0: 0.999, 1: 0.001}, "0.11": {0: 0.89, 1: 0.11},
    "0.5": {0: 0.5, 1: 0.5}, "all": {1: 1.0},
    "bytes_2_255": {0: 0.4, 1: 0.2, 2: 0.2, 255: 0.2},
}
COMPACT_WAVES = 20_000_003
# the compaction's kernels (csrc/rans_codec.cu): tile counts, one CTA's scan
# of the counts, scan and scatter within each tile
COMPACT_KERNELS = ("rans_tile_counts_kernel", "rans_scan_tiles_kernel", "rans_scatter_kernel")
# the mesh path's two streams, whose words the compaction is timed on:
# (model, order) -> (label, the lanes the mesh path picks)
MESH_COMPACT = {(0, 2): ("mesh_seq", 4096), (1, 1): ("mesh_qual", 2048)}
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
    and QUAL_PAD 0xFF past each length. ``full_len``: every read that long,
    a (lo, hi) range of lengths, or None for 0-L with empty rows."""
    if full_len is None:
        lengths = rng.integers(0, l + 1, size=r).astype(np.int32)
        lengths[: max(1, r // 8)] = 0  # empty rows
        lengths[-1] = l
    elif isinstance(full_len, tuple):
        lengths = rng.integers(full_len[0], full_len[1] + 1, size=r).astype(np.int32)
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


def gpu_ms(fn, arg_sets, iters: int, warm: bool = True) -> float:
    """Mean device ms per call of ``fn(*args)``, rotating over
    ``arg_sets``. The calls are queued behind a sleep kernel, so the
    events time the device's back-to-back work, not the host's enqueue.
    ``warm=False``: ``fn`` has just run at these shapes, so no warm-up
    call (a plain version that takes seconds)."""
    for args in arg_sets if warm else ():  # warm up
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


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The least ms the card could take, and what sets it: the bytes moved
    once over the memory rate or the operations over the peak rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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
                n_rate=0.001, tail_n=False, exact=True):
    """Encode and decode of one seeded block, each held against its plain
    version; with ``exact``, every output must be contiguous at its exact
    width (the dense kernels of this checkout; an older checkout's wrapper
    returned sliced views)."""
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
    widths = ((r, -(-l // 4)), (r, -(-l // 8)), (r,), (r, l))
    check(not exact or all(x.is_contiguous() and tuple(x.shape) == w
                           for x, w in zip(got, widths)),
          f"encode outputs contiguous at exact widths, R={r} L={l}")
    seq_k, qual_k = ck.decode_arrays(ref.packed, ref.qual_delta, n, offset)
    seq_p, qual_p = devops.decode_arrays_plain(ref.packed, ref.qual_delta, n,
                                               offset)
    # a packed matrix wider than ceil(L/4): its row pitch goes to the kernel
    wide = torch.cat([ref.packed, torch.randint(0, 256, (r, 5), dtype=torch.uint8,
                                                device=dev)], dim=1)
    seq_w, qual_w = ck.decode_arrays(wide, ref.qual_delta, n, offset)
    dec_err = max(max_err(seq_k, seq_p), max_err(qual_k, qual_p),
                  max_err(seq_w, seq_p), max_err(qual_w, qual_p))
    check(dec_err == 0, f"decode kernel == plain at R={r} L={l} off={offset}")
    check(not exact or all(x.is_contiguous() and tuple(x.shape) == (r, l)
                           for x in (seq_k, qual_k)),
          f"decode outputs contiguous at exact widths, R={r} L={l}")
    # decode restores the input within each length (N aside)
    mask = torch.arange(l, device=dev)[None, :] < n[:, None].long()
    check(bool((qual_k[mask] == q[mask]).all()), f"qual round trip R={r} L={l}")
    torch.cuda.synchronize()
    return (s, q, n), ref, enc_err, dec_err


def copy_ms(nbytes: int, iters: int) -> float:
    """Device ms of one ``copy_`` that moves ``nbytes`` in all (half read,
    half written): what this card reaches for a pure stream of that size.
    It computes nothing of the codec; a yardstick of the memory alone."""
    half = torch.empty(nbytes // 2, dtype=torch.uint8, device=DEV)
    sets = rotations((half, half), nbytes)
    return gpu_ms(lambda src, dst: dst.copy_(src), sets, iters)


def device_ops(fn, sessions: int = 8) -> list[str]:
    """Names of the device operations (kernels, copies, fills) that one
    call of ``fn`` runs, from ``torch.profiler``: the fullest of up to
    ``sessions`` profiled calls, stopping once two sessions have seen the
    same non-empty list (in a long process a session can miss some or all
    of its kernels, even three in a row; it never adds any)."""
    fullest: list[str] = []
    seen = 0
    for _ in range(sessions):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"
               for _ in range(e.count)]
        if ops and len(ops) == len(fullest):
            seen += 1
        elif len(ops) > len(fullest):
            fullest, seen = ops, 1
        if seen >= 2:
            break
    return fullest


def phase_kernels(ck, devops, refops, rng) -> dict:
    t_len = ck.dense_geometry(READ_LEN).max_tile_len
    edge = [
        (4, 8, 33, b"ACGTNacgt.RY"),
        (16, 31, 64, b"ACGTNacgt.RY"),
        (8, 152, 33, b"ACGTNacgt.RY"),
        (300, 64, 64, b"ACGTNacgt.RY"),
        (3, 1, 33, b"ACGTNacgt.RY"),
        (33, 1040, 33, b"acgtACGTN"),
    ]
    # ragged tiles and odd lengths, then both sides of the long-row threshold
    edge += [(r, l, 33 + 31 * ((r + l) % 2), b"ACGTNacgt.RY")
             for r in (1, 15, 16, 17, 33) for l in (1, 8, 31, 151)]
    edge += [(r, l, 33, b"ACGTNacgt.RY") for r in (17, 33)
             for l in (t_len - 1, t_len, t_len + 1)]
    errs = {ck.ENCODE: 0, ck.DECODE: 0}
    for r, l, off, ab in edge:
        _, _, e, d = kernel_case(ck, devops, rng, r, l, off, ab)
        errs[ck.ENCODE] = max(errs[ck.ENCODE], e)
        errs[ck.DECODE] = max(errs[ck.DECODE], d)
        print(f"phase=kernels edge R={r} L={l} offset={off} "
              f"route={ck.dense_geometry(l).route} byte_equal=true")
    inputs, ref, e, d = kernel_case(ck, devops, rng, 3, 65544, 33, b"ACGT",
                                    full_len=65544, n_rate=0, tail_n=True)
    errs[ck.ENCODE] = max(errs[ck.ENCODE], e)
    errs[ck.DECODE] = max(errs[ck.DECODE], d)
    check(bool((ref.n_counts == 0).all()), "no N counted past the cap")
    print("phase=kernels edge R=3 L=65544 offset=33 tail_N_past_cap=true "
          "byte_equal=true")
    # FQZ v3 tracks N positions without the cap
    s, q, n = inputs
    wide = ck.encode_arrays(s, q, n, 33, refops.NPOS_CAP_WIDE)
    wide_ref = devops.encode_arrays_plain(s, q, n, 33, refops.NPOS_CAP_WIDE)
    check(all(torch.equal(a, b) for a, b in zip(wide, wide_ref)),
          "encode kernel == plain without the tracking cap")
    check(bool((wide.n_counts == 8).all()), "every tail N counted without the cap")
    print("phase=kernels edge R=3 L=65544 offset=33 no_cap=true byte_equal=true")

    out, shapes, per_call = {}, {}, {}
    for r, l, lens in DENSE_SHAPES:
        for off in (33, 64):
            inputs, ref, e, d = kernel_case(ck, devops, rng, r, l, off, b"ACGT",
                                            full_len=lens)
            errs[ck.ENCODE] = max(errs[ck.ENCODE], e)
            errs[ck.DECODE] = max(errs[ck.DECODE], d)
        s, q, n = inputs
        key = f"{r}x{l}"
        if (r, l) == DENSE_PROFILED:
            # one CUDA kernel per wrapper call: no zero-fill, pad or slice copy
            # (outputs made contiguous, as a copy to the host would)
            for name, call in (
                (ck.ENCODE, lambda: [x.contiguous() for x in ck.encode_arrays(s, q, n, off)]),
                (ck.DECODE, lambda: [x.contiguous() for x in ck.decode_arrays(
                    ref.packed, ref.qual_delta, n, off)]),
            ):
                ops = device_ops(call)
                print(f"phase=kernels kernel={name} R={r} L={l} device_ops_per_call="
                      f"{len(ops)} names={json.dumps(ops)}")
                check(len(ops) == 1, f"{name}: one CUDA kernel per call at R={r} L={l}")
                per_call[name] = len(ops)
        enc_sets = rotations((s, q, n), encode_bytes(r, l))
        dec_sets = rotations((ref.packed, ref.qual_delta, n), decode_bytes(r, l))
        # operations per base: encode classifies, packs 2 bits, masks, counts
        # and takes a delta (~12); decode unpacks, looks up and sums (~8)
        for name, fn, plain, sets, nbytes, ops in (
            (ck.ENCODE, ck.encode_arrays, devops.encode_arrays_plain,
             enc_sets, encode_bytes(r, l), 12 * r * l),
            (ck.DECODE, ck.decode_arrays, devops.decode_arrays_plain,
             dec_sets, decode_bytes(r, l), 8 * r * l),
        ):
            kms = gpu_ms(lambda *a: fn(*a, off), sets, 200)
            pms = gpu_ms(lambda *a: plain(*a, off), sets, 20)
            cms = copy_ms(nbytes, 200)
            out[(name, key)] = report(name, f"R={r} L={l}", kms, pms, None,
                                      nbytes, ops, errs[name])
            geo = ck.dense_geometry(l, encode=name == ck.ENCODE)
            print(f"phase=kernels kernel={name} R={r} L={l} copy_ms={cms:.6f} "
                  f"copy_share={cms / kms:.4f} route={geo.route} "
                  f"rows_per_tile={geo.rows} warps_per_cta={geo.warps} "
                  f"shared_bytes={geo.shared}")
            shapes[(name, key)] = {
                "ms": kms, "plain_ms": pms, "bound_ms": out[(name, key)][2],
                "share": out[(name, key)][2] / kms, "copy_ms": cms, "bytes": nbytes,
                "route": geo.route, "rows_per_tile": geo.rows, "warps_per_cta": geo.warps,
                "shared_bytes": geo.shared,
            }
        del enc_sets, dec_sets
    return {"errs": errs, "times": out, "shapes": shapes, "per_call": per_call}


def report(name: str, shape: str, kms: float, pms: float, lms: float | None,
           nbytes: int, ops: int, err: int) -> tuple:
    """Print one kernel's times (``lms``: the library call's, if there is
    one) beside its bound; returns the numbers of its ``kernels`` entry."""
    bound_ms, bound_by = bound(nbytes, ops)
    library = "null" if lms is None else f"{lms:.6f}"
    print(
        f"phase=kernels kernel={name} {shape} kernel_ms={kms:.6f} "
        f"bound_us={bound_ms * 1e3:.3f} bound_by={bound_by} bytes={nbytes} "
        f"operations={ops} plain_ms={pms:.6f} library_ms={library} "
        f"roofline_share={bound_ms / kms:.4f} max_abs_err={err}"
    )
    return kms, pms, bound_ms, bound_by, lms


def rans_case(ck, rans, data: np.ndarray, lanes: int) -> dict:
    """One stream through the three rANS kernels and their plain versions
    on the card, every output compared in full; decode(encode(x)) == x."""
    n = len(data)
    steps = -(-n // lanes)
    hist = np.bincount(data, minlength=256).astype(np.int64)
    pad = int(np.argmax(hist))
    hist[pad] += steps * lanes - n
    freq = rans.normalize_freqs(hist)
    fc = np.stack([freq.astype(np.int32), rans.cumulative(freq).astype(np.int32)])
    d, t = torch.from_numpy(data).to(DEV), torch.from_numpy(fc).to(DEV)
    what = f"n={n} lanes={lanes}"

    words, flags, states = ck.rans_encode(d, steps, lanes, pad, t)
    pw, pf, ps = rans.rans_encode_plain(d, steps, lanes, pad, t)
    enc_err = max(max_err(words, pw), max_err(flags, pf), max_err(states, ps))
    check(enc_err == 0, f"rans encode kernel == plain at {what}")

    flat, total = ck.rans_compact(words, flags)
    pflat, ptotal = rans.rans_compact_plain(words, flags)
    k = int(total)
    check(k == int(ptotal), f"rans compact total == plain at {what}")
    cmp_err = max_err(flat[:k], pflat[:k])
    check(cmp_err == 0, f"rans compact kernel == plain at {what}")

    tab = torch.from_numpy(rans.pack_slot_table(freq).view(np.int32)).to(DEV)
    stream = flat[:k].clone()
    out, consumed = ck.rans_decode(stream, states, tab, steps, lanes)
    pout, pconsumed = rans.rans_decode_plain(stream, states, tab, steps, lanes)
    dec_err = max_err(out, pout)
    check(dec_err == 0, f"rans decode kernel == plain at {what}")
    check(int(consumed) == int(pconsumed) == k, f"words consumed == carried at {what}")
    check(torch.equal(out[:n], d), f"decode(encode(x)) == x at {what}")
    torch.cuda.synchronize()
    return {
        "enc": (d, steps, lanes, pad, t), "cmp": (words, flags),
        "dec": (stream, states, tab, steps, lanes),
        "errs": (enc_err, cmp_err, dec_err), "n": n, "steps": steps,
        "lanes": lanes, "total": k,
    }


def walk_deltas(rng, n: int) -> np.ndarray:
    """IID quality deltas with the step distribution of the "walk" data."""
    from fastqpacker_tpu_torch.utils.synth import walk_steps

    return walk_steps(rng, n).astype(np.uint8)


def library_compact(words, flags):
    """The one PyTorch call that computes the compaction: the flagged words
    in flat order, whose count is the total. A yardstick only."""
    return torch.masked_select(words, flags.bool())


def compact_edges(ck, rans, rng) -> int:
    """The compaction at one cell, around one tile and over several waves
    of CTAs, at each flag density: byte-equal to its plain version and to
    ``torch.masked_select``. Returns the largest difference (0)."""
    tile = ck.COMPACT_TILE
    err = 0
    for m in (1, tile - 1, tile, tile + 1, COMPACT_WAVES):
        for label, fb in COMPACT_FLAGS.items():
            words = torch.from_numpy(
                rng.integers(-(1 << 15), 1 << 15, m).astype(np.int16)).to(DEV)
            flags = torch.from_numpy(rng.choice(np.array(list(fb), np.uint8), m,
                                                p=list(fb.values()))).to(DEV)
            flat, total = ck.rans_compact(words, flags)
            pflat, ptotal = rans.rans_compact_plain(words, flags)
            lib = library_compact(words, flags)
            k = int(total)
            what = f"m={m} flags={label}"
            check(k == int(ptotal) == lib.numel(), f"compact total == plain == masked_select at {what}")
            err = max(err, max_err(flat[:k], pflat[:k]), max_err(flat[:k], lib))
            check(err == 0, f"compact kernel == plain == masked_select at {what}")
        print(f"phase=kernels compact m={m} tile={tile} flags={json.dumps(list(COMPACT_FLAGS))} "
              f"byte_equal_plain=true byte_equal_masked_select=true")
    torch.cuda.synchronize()
    return err


def phase_rans(ck, rans, rng, registers: dict) -> dict:
    errs = {ck.RANS_ENCODE: 0, ck.RANS_COMPACT: compact_edges(ck, rans, rng), ck.RANS_DECODE: 0}

    def fold(case):
        for name, e in zip(errs, case["errs"]):
            errs[name] = max(errs[name], e)

    for lanes in (256, 4096, 16384):
        n = 37 * lanes + lanes // 3 + 1  # a ragged last row
        for label, data in (
            ("one_symbol", np.full(n, 65, np.uint8)),
            ("256_symbols", rng.integers(0, 256, n).astype(np.uint8)),
            ("qualities", walk_deltas(rng, n)),
            ("full_rows", walk_deltas(rng, 8 * lanes)),
        ):
            fold(rans_case(ck, rans, data, lanes))
            print(f"phase=kernels rans lanes={lanes} stream={label} "
                  f"n={len(data)} byte_equal=true round_trip=true")

    # a stream that lost words: no read out of bounds, and the API raises
    data = walk_deltas(rng, 300_000)
    good = rans.encode_stream(data, device=DEV)
    check(rans.decode_stream(good, device=DEV) == data.tobytes(), "stream API round trip")
    off = 8 + 512 + 4 * 256
    total = int.from_bytes(good[off : off + 4], "little")
    bad = good[:off] + (total - 100).to_bytes(4, "little") + good[off + 4 : -200]
    try:
        rans.decode_stream(bad, device=DEV)
    except rans.RansError as e:
        check(str(e) == "corrupted rANS stream data", "corrupt stream message")
        print("phase=kernels rans corrupt_words raises=true")
    else:
        raise RuntimeError("check failed: a stream that lost words decoded")

    out, extra = {}, {}
    for label, data, lanes in (
        ("qual", walk_deltas(rng, QUAL_STREAM), 16384),
        ("seq", rng.integers(0, 256, SEQ_STREAM).astype(np.uint8), 4096),
    ):
        check(rans._pick_lanes(len(data)) == lanes, f"{label} stream's lane tier")
        case = rans_case(ck, rans, data, lanes)
        fold(case)
        n, steps, m, k = case["n"], case["steps"], case["steps"] * lanes, case["total"]
        shape = f"stream={label} n={n} lanes={lanes} steps={steps} words={k}"
        d, *enc_rest = case["enc"]
        stream, *dec_rest = case["dec"]
        # operations per cell: encode reads its table entry, tests, shifts,
        # divides, takes the remainder and recombines (~10); compact tests
        # the flag, adds it into the prefix and moves the word (~4); decode
        # masks, reads and unpacks its entry, multiplies, compares, ranks
        # and refills (~12)
        dec_sets = [(x, *dec_rest) for (x,) in rotations((stream,), 2 * k + m)]
        lib = library_compact(*case["cmp"])
        check(lib.numel() == k and torch.equal(lib, ck.rans_compact(*case["cmp"])[0][:k]),
              f"masked_select == compact kernel at {shape}")
        extra[("compact", label)] = {"cells": m, "words": k, "lanes": lanes}
        if label == "qual":  # its three kernels per call, no fill or copy
            ops = device_ops(lambda: ck.rans_compact(*case["cmp"]))
            print(f"phase=kernels kernel={ck.RANS_COMPACT} cells={m} device_ops_per_call="
                  f"{len(ops)} names={json.dumps(ops)}")
            check(len(ops) == 3 and all(any(k in op for op in ops) for k in COMPACT_KERNELS),
                  f"{ck.RANS_COMPACT}: its three CUDA kernels per call at {m} cells")
            extra[("compact", label)]["device_ops_per_call"] = len(ops)
        for name, fn, plain, library, sets, nbytes, ops in (
            (ck.RANS_ENCODE, ck.rans_encode, rans.rans_encode_plain, None,
             [(x, *enc_rest) for (x,) in rotations((d,), n + 3 * m)],
             n + 2 * 256 * 4 + 3 * m + 4 * lanes, 10 * m),
            (ck.RANS_COMPACT, ck.rans_compact, rans.rans_compact_plain,
             library_compact,
             rotations(case["cmp"], 3 * m + 2 * k), 3 * m + 2 * k + 8, 4 * m),
            (ck.RANS_DECODE, ck.rans_decode, rans.rans_decode_plain, None, dec_sets,
             2 * k + 4 * lanes + 4 * 4096 + m + 8, 12 * m),
        ):
            kms = gpu_ms(fn, sets, 20)
            pms = gpu_ms(plain, sets[:1], 1)
            lms = gpu_ms(library, sets, 20) if library else None
            out[(name, label)] = (
                *report(name, shape, kms, pms, lms, nbytes, ops, errs[name]), steps)
        ems = out[(ck.RANS_ENCODE, label)][0]
        print(f"phase=kernels kernel={ck.RANS_ENCODE} {shape} "
              f"step_us={ems * 1e3 / steps:.4f} ctas={-(-lanes // 32)} threads_per_cta=32")
        extra[("encode", label)] = {"lanes": lanes, "step_us": ems * 1e3 / steps,
                                    "ctas": -(-lanes // 32), "threads_per_cta": 32}
        kms, _, bound_ms = out[(ck.RANS_DECODE, label)][:3]
        geometry = rans_geometry(ck.rans_decode_geometry(lanes), registers)
        extra[label] = {"lanes": lanes, "step_us": kms * 1e3 / steps, **geometry}
        print(f"phase=kernels kernel={ck.RANS_DECODE} {shape} "
              f"step_us={kms * 1e3 / steps:.4f} roofline_share={bound_ms / kms:.4f} "
              f"geometry={json.dumps(geometry, sort_keys=True)}")
        del case, sets, dec_sets
    return {"errs": errs, "times": out, "extra": extra}


def rans_geometry(g, registers: dict) -> dict:
    """One order-0 decode geometry as the reports print it, with the
    registers of its kernel instance (lanes per thread)."""
    return {"cluster": g.cluster, "ctas": g.cluster, "threads_per_cta": g.threads,
            "lanes_per_thread": g.lanes_per_thread, "shared_bytes": g.shared,
            "registers": registers.get(g.lanes_per_thread)}


def phase_rans_variant(qual: dict, qual_ms: float) -> dict:
    """The order-0 decode at its other cluster geometry on the quality
    stream: ``scripts/rans_ab.py --set RANS_DECODE_VARIANT`` on a copy of
    the package under its ``_build`` directory (git-ignored), in its own
    process, on the same seeded stream shape. It holds the variant against
    the plain version and times it as phase kernels does."""
    repo = Path(__file__).resolve().parent
    root = repo / "fastqpacker_tpu_torch/_build" / ("variant_" + RANS_DECODE_VARIANT.replace("=", "_"))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(repo / "fastqpacker_tpu_torch", root / "fastqpacker_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    try:
        run = subprocess.run(
            [sys.executable, str(repo / "scripts/rans_ab.py"), "--root", str(root),
             "--set", RANS_DECODE_VARIANT, "--stream", "qual"],
            capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(run.returncode == 0, f"rans_ab.py --set {RANS_DECODE_VARIANT}: "
          f"rc={run.returncode} {run.stderr[-2000:]}")
    (row,) = json.loads(run.stdout.strip().splitlines()[-1])["cases"]
    g = row["geometry"]
    key = f"{g['cluster']}x{g['threads']}x{g['lanes_per_thread']}"
    check(key == "16x1024x1", f"the variant's geometry is 16 x 1,024 x 1, got {key}")
    default = f"{qual['cluster']}x{qual['threads_per_cta']}x{qual['lanes_per_thread']}"
    by_geometry = {
        default: {"ms": qual_ms, "step_us": qual["step_us"]},
        key: {"ms": row["decode_ms"], "step_us": row["step_us"], "steps": row["steps"],
              "registers": row["registers"], "shared_bytes": g["shared"],
              "set": RANS_DECODE_VARIANT},
    }
    print(f"phase=kernels kernel=fq_rans_decode stream=qual lanes={row['lanes']} "
          f"steps={row['steps']} geometry={key} ms={row['decode_ms']:.6f} "
          f"step_us={row['step_us']:.4f} registers={row['registers']} "
          f"against={default} ms={qual_ms:.6f}")
    return by_geometry


def phase_crc(ck, crc32, rng) -> dict:
    chunk = crc32.CHUNK
    span = crc32.CTA_CHUNKS * chunk
    check(crc32.crc32_device(b"", device=DEV) == 0, "CRC32 of nothing is 0")
    err = 0
    before = ck.launches[ck.CRC32]
    # chunk, warp (32 chunks) and CTA span edges, several spans, the streams
    lengths = (1, chunk - 1, chunk, chunk + 1, 3 * chunk + 17, 32 * chunk, span - 1,
               span, span + 1, 2 * span + 32 * chunk + 3, crc32.MIN_DEVICE_BYTES,
               SEQ_STREAM, QUAL_STREAM)
    for n in lengths:
        data = rng.integers(0, 256, n).astype(np.uint8)
        t = torch.from_numpy(data).to(DEV)
        got = ck.crc32_chunks(t)
        err = max(err, max_err(got, crc32.crc32_chunks_plain(t)))
        want = zlib.crc32(data.tobytes())
        check(int(got.item()) & 0xFFFFFFFF == want, f"CRC32 kernel == zlib at n={n}")
        check(crc32.crc32_device(data, device=DEV) == want, f"crc32_device == zlib at n={n}")
        print(f"phase=kernels crc32 n={n} equals_zlib=true")
    check(err == 0, "CRC32 kernel == plain")
    # one launch per CRC; below MIN_DEVICE_BYTES crc32_device stays on the host
    above = sum(n >= crc32.MIN_DEVICE_BYTES for n in lengths)
    check(ck.launches[ck.CRC32] - before == len(lengths) + above,
          "one CRC32 launch per CRC, none below the size rule")
    try:
        ck.crc32_chunks(torch.zeros(4096, dtype=torch.uint8, device=DEV)[3:])
    except ValueError:
        print("phase=kernels crc32 misaligned_view refused=true")
    else:
        raise RuntimeError("check failed: a misaligned CRC32 view was taken")
    out = {}
    for label, n in (("qual", QUAL_STREAM), ("seq", SEQ_STREAM)):
        data = rng.integers(0, 256, n).astype(np.uint8)
        t = torch.from_numpy(data).to(DEV)
        sets = rotations((t,), n)
        kms = gpu_ms(ck.crc32_chunks, sets, 50)
        pms = gpu_ms(crc32.crc32_chunks_plain, sets[:1], 1)
        out[(ck.CRC32, label)] = (
            # per byte: xor, mask, table read and xor, shift
            *report(ck.CRC32, f"stream={label} n={n} chunk={chunk} span={span}", kms,
                    pms, None, n + 4, 4 * n, err),
            None,
        )
    return {"errs": {ck.CRC32: err}, "times": out}


TAG_NAMES = {0: "rans", 1: "zstd", 2: "tok", 3: "qctx", 4: "sctx", 5: "sldm", 6: "wctx"}


def stream_tags(comp: bytes, ft) -> tuple[int, dict]:
    """Blocks of a v3 container and, per tagged slot, its streams by codec."""
    c = ft.container
    r = io.BytesIO(comp)
    fh = c.read_file_header(r)
    if fh.flags & c.FLAG_SEQ_DICT:
        c.read_seq_dict_section(r)
    tags = {"seq": {}, "qual": {}, "headers": {}}
    blocks = 0
    while (hdr := c.read_block_header(r, fh.version)) is not None:
        sizes = hdr.stream_sizes(c.VERSION_2)
        payload = r.read(sum(sizes))
        for slot, at in (("seq", 0), ("qual", sizes[0]), ("headers", sizes[0] + sizes[1])):
            name = TAG_NAMES[payload[at]]
            tags[slot][name] = tags[slot].get(name, 0) + 1
        blocks += 1
    return blocks, tags


def round_trip_v3(ft, ck, data: bytes, label: str) -> dict:
    """FQZ v3 on the card, each direction with the counters reset just
    before and read just after; the launch counts are held against the
    stream tags read from the container."""
    opts = ft.Options(version=ft.container.VERSION_3_NATIVE)
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    comp = ft.compress_bytes(data, opts, device=DEV)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    c_counts = ck.launches.as_dict()

    ck.reset_launches()
    t0 = time.perf_counter()
    out = ft.decompress_bytes(comp, device=DEV)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    d_counts = ck.launches.as_dict()

    check(out == data, f"{label}: decompressed output equals the input")
    blocks, tags = stream_tags(comp, ft)
    n_rans = tags["seq"].get("rans", 0) + tags["qual"].get("rans", 0)
    check(tags["qual"].get("rans", 0) == blocks > 0,
          f"{label}: every block's quality stream is TAG_RANS")
    check(c_counts[ck.RANS_ENCODE] == n_rans,
          f"{label}: one rANS encode launch per TAG_RANS stream")
    check_ctx_launches(ck, label, tags, c_counts, d_counts)
    check(d_counts[ck.RANS_DECODE] == n_rans,
          f"{label}: one rANS decode launch per TAG_RANS stream")
    check(c_counts[ck.RANS_DECODE] == 0 and d_counts[ck.RANS_ENCODE] == 0,
          f"{label}: no rANS launch in the wrong direction")
    check(c_counts[ck.CRC32] > 0 and d_counts[ck.CRC32] > 0,
          f"{label}: CRC32 launched in both directions")
    check(c_counts[ck.ENCODE] == blocks and d_counts[ck.DECODE] == blocks,
          f"{label}: one dense launch per block and direction")
    check(c_counts[ck.RECORDS_SCAN] >= blocks and c_counts[ck.STREAMS_BUILD] == blocks
          and d_counts[ck.FASTQ_ASSEMBLE] == blocks,
          f"{label}: the block stages ran on the card in both directions")
    # every block's quality pick prepares its qctx candidate (the full pass
    # or the sampled pre-gate) on the card; the sctx pre-gate is skipped by
    # the cross-block memo on some blocks; no TAG_WCTX stream, so no lane pass
    check(c_counts[ck.QCTX_PREPARE] >= blocks and c_counts[ck.SCTX_PREPARE] >= 1,
          f"{label}: the qctx / sctx prepare passes ran on the card")
    check(c_counts[ck.WCTX_LAYOUT] == c_counts[ck.WCTX_UNLAYOUT] == 0
          and all(d_counts[k] == 0 for k in (ck.QCTX_PREPARE, ck.SCTX_PREPARE,
                                              ck.WCTX_LAYOUT, ck.WCTX_UNLAYOUT)),
          f"{label}: no lane pass without a TAG_WCTX stream, no prepare on decompress")
    # every order-0 histogram on the card: one a size estimate, whose counts
    # a stream that picks rANS takes its table from; the tokenizer where the
    # header gate lets it run, its decode per TAG_TOK stream
    want = stream_counts(comp, ft, READ_LEN)
    check(c_counts[ck.HIST256] == want["estimates"] and d_counts[ck.HIST256] == 0,
          f"{label}: one fq_hist256 an estimate, none for a rANS table "
          f"({c_counts[ck.HIST256]}, {want})")
    check(c_counts[ck.TOK_ENCODE] == want["tok_encodes"]
          and d_counts[ck.TOK_DECODE] == want["tok_streams"],
          f"{label}: the tokenizer launches follow the header tags ({want})")

    # the card's container against the CPU's, on a prefix that ends at a
    # record boundary; one worker, since the probe memo depends on order
    cut = data.rfind(b"\n@SIM0.", 0, V3_CPU_BYTES) + 1
    small = data[:cut] if cut > 0 else data
    one = ft.Options(version=ft.container.VERSION_3_NATIVE, workers=1)
    t0 = time.perf_counter()
    gpu_small = ft.compress_bytes(small, one, device=DEV)
    t_gpu1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_small = ft.compress_bytes(small, one, device="cpu")
    t_cpu1 = time.perf_counter() - t0
    check(gpu_small == cpu_small, f"{label}: GPU container byte-identical to CPU's")
    mb = len(data) / 1e6
    print(
        f"phase=e2e run={label} input_bytes={len(data)} container_bytes="
        f"{len(comp)} blocks={blocks} tags={json.dumps(tags, sort_keys=True)} "
        f"compress_s={t_c:.4f} compress_MBps={mb / t_c:.2f} "
        f"decompress_s={t_d:.4f} decompress_MBps={mb / t_d:.2f} "
        f"compress_launches={json.dumps(c_counts, sort_keys=True)} "
        f"decompress_launches={json.dumps(d_counts, sort_keys=True)} "
        f"round_trip=true"
    )
    print(
        f"phase=e2e run={label} cpu_identity_bytes={len(small)} workers=1 "
        f"gpu_compress_s={t_gpu1:.4f} cpu_compress_s={t_cpu1:.4f} "
        f"byte_identical_to_cpu=true"
    )
    return {"compress": c_counts, "decompress": d_counts, "comp": comp}


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
    c_counts = ck.launches.as_dict()
    enc_launches = c_counts[ck.ENCODE]
    check(c_counts[ck.DECODE] == 0, "compress launched no decode")

    ck.reset_launches()
    t0 = time.perf_counter()
    out = ft.decompress_bytes(comp, device=DEV)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    d_counts = ck.launches.as_dict()
    dec_launches = d_counts[ck.DECODE]

    blocks = count_blocks(comp, ft)
    check(out == data, f"{label}: decompressed output equals the input")
    check(enc_launches == blocks > 0, f"{label}: one encode launch per block")
    check(dec_launches == blocks, f"{label}: one decode launch per block")
    # the block stages: a scan per window (a window that holds too few
    # records is scanned again, larger), two gathers and a stream build per
    # block on compress; one pair gather and an assembly per block on
    # decompress
    check(c_counts[ck.RECORDS_SCAN] >= blocks and c_counts[ck.STREAMS_BUILD] == blocks
          and c_counts[ck.ROWS_GATHER] == 2 * blocks and c_counts[ck.FASTQ_ASSEMBLE] == 0,
          f"{label}: compress scanned, gathered and built on the card: {c_counts}")
    check(d_counts[ck.FASTQ_ASSEMBLE] == blocks and d_counts[ck.ROWS_GATHER] == blocks
          and d_counts[ck.RECORDS_SCAN] == 0,
          f"{label}: decompress gathered and assembled on the card: {d_counts}")
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
        f"compress_launches={json.dumps(c_counts, sort_keys=True)} "
        f"decompress_launches={json.dumps(d_counts, sort_keys=True)} "
        f"byte_identical_to_cpu=true round_trip=true"
    )
    return {"encode": enc_launches, "decode": dec_launches, "comp": comp,
            "compress": c_counts, "decompress": d_counts}



# ---------------------------------------------------------------------------
# phase records: the C++ runtime's block stages as kernels (csrc/records.cu)
# ---------------------------------------------------------------------------

# the block stages' inputs: label -> (records, read length or range, read
# names: fixed-width ids, or Illumina-style names of varying width)
RECORD_SHAPES = {
    "v2_37500x151": (37_500, 151, "fixed"),
    "varlen50_300_37500": (37_500, (50, 300), "fixed"),
    "v3_100000x151": (100_000, 151, "fixed"),
    "names_37500x151": (37_500, 151, "illumina"),
    "names_100000x151": (100_000, 151, "illumina"),
}
RECORD_TIMED = "v2_37500x151"  # the shape of the kernels line: a v2 block
RECORD_HOST_CALLS = 20  # wrapper calls per reading of the host clock


def scan_bytes(n_text: int, count: int) -> int:
    # reads the text; writes offsets (64 B), qmin (2 B) per record and info
    return n_text + 66 * count + 128


def mask_bytes(nmask: torch.Tensor, records: int) -> int:
    """The N-mask bytes the stream build needs: in each record's row, those
    up to its last nonzero byte (none in the row of a record with no N)."""
    m = nmask[:records] != 0
    if not m.numel():
        return 0
    return int((m * torch.arange(1, m.shape[1] + 1, device=m.device)).amax(1).sum())


def streams_bytes(sizes: list, records: int, nmask: torch.Tensor) -> int:
    # reads the header and plus payloads, offsets (64 B), packed and delta
    # bytes and N counts per record, and the N masks as far as each row's
    # last N; writes the six streams
    return (sizes[2] + sizes[3] - 4 * records + 64 * records + sizes[0] + sizes[1]
            + mask_bytes(nmask, records) + 4 * records + sum(sizes))


def records_block(records: int, lens, names: str, seed: int, synth=None) -> bytes:
    """One block's FASTQ text: synthetic reads of ``lens`` (a length or a
    (lo, hi) range), ~0.1% N; fixed-width headers, or Illumina-style read
    names whose width varies (``names="illumina"``). ``synth``: the module
    that writes them (default: the port's ``utils/synth.py``)."""
    if synth is None:
        from fastqpacker_tpu_torch.utils import synth
    if names == "illumina":
        return synth.illumina_fastq(records, read_len=lens, seed=seed)
    if isinstance(lens, tuple):
        data = synth.synth_fastq(1 + records * 420 // (1 << 20), read_len=lens[1],
                                 min_len=lens[0], seed=seed)
    else:
        data = synth.synth_fastq(1 + records * (2 * lens + 80) // (1 << 20), read_len=lens,
                                 seed=seed)
    ends = np.flatnonzero(np.frombuffer(data, np.uint8) == 0x0A)[3::4]
    check(len(ends) >= records, f"records_block: {len(ends)} < {records} records")
    return data[: int(ends[records - 1]) + 1]


def rotate(args: tuple, nbytes: int) -> list:
    """``rotations`` of an argument tuple whose tensors are cloned and
    whose other arguments pass as they are."""
    k = max(2, -(-150_000_000 // nbytes))
    return [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            for _ in range(k)]


def host_us(fn, args, calls: int = RECORD_HOST_CALLS) -> float:
    """Host microseconds per wrapper call: the enqueue of ``calls`` calls on
    the host clock, with no synchronisation between them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def nested_pad(data: torch.Tensor, offsets: torch.Tensor, rows: int, width: int):
    """The one PyTorch call that pads runs back to back into rows (a
    yardstick; the port never calls it)."""
    return torch.nested.nested_tensor_from_jagged(data, offsets).to_padded_tensor(
        0, (rows, width))


def library_pad_ms(data, lens, rows: int, width: int, iters: int) -> tuple:
    """``nested_pad``'s device ms on the decode's quality runs, or None and
    why (the installed PyTorch may lack it, or refuse uint8)."""
    if not hasattr(torch.nested, "nested_tensor_from_jagged"):
        return None, "torch.nested.nested_tensor_from_jagged missing"
    offsets = torch.zeros(lens.numel() + 1, dtype=torch.int64, device=lens.device)
    torch.cumsum(lens, 0, out=offsets[1:])
    values = data[: int(offsets[-1])]
    try:
        got = nested_pad(values, offsets, rows, width)
    except Exception as e:  # noqa: BLE001 (reported, not a failure of the port)
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    torch.cuda.synchronize()
    ms = gpu_ms(lambda v, o: nested_pad(v, o, rows, width), [(values, offsets)] * 2, iters)
    del got
    return ms, "torch.nested.nested_tensor_from_jagged(data, offsets).to_padded_tensor"


def time_case(name: str, label: str, route: str, kfn, pfn, args: tuple, nbytes: int,
              ops: int, err: int, lms=None, note=None) -> dict:
    """One kernel's device time (calls queued behind a sleep kernel, inputs
    rotated past the L2 cache), its plain version's, its bound and the host
    microseconds of one wrapper call; printed, and returned as a
    ``by_shape`` entry."""
    sets = rotate(args, nbytes)
    kms = gpu_ms(kfn, sets, 50)
    pms = gpu_ms(pfn, sets[:1] * 2, 3)
    hus = host_us(kfn, args)
    del sets
    bound_ms, bound_by = bound(nbytes, ops)
    print(f"phase=records kernel={name} block={label} route={route} kernel_ms={kms:.6f} "
          f"bound_us={bound_ms * 1e3:.3f} bytes={nbytes} plain_ms={pms:.6f} "
          f"library_ms={'null' if lms is None else f'{lms:.6f}'} "
          f"roofline_share={bound_ms / kms:.4f} host_us_per_call={hus:.1f} max_abs_err={err}"
          + (f" library={json.dumps(note)}" if note else ""))
    return {"ms": kms, "plain_ms": pms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lms, "host_us_per_call": hus}


# the blocks at which the device operations of one wrapper call are counted
# (fixed-width headers, names of varying width), and each route's ceiling
RECORD_OPS_SHAPES = ("v2_37500x151", "names_100000x151")
RECORD_OPS_LIMIT = {"text": 1, "back_to_back": 1, "decoder": 1, "assemble": 3, "scan": 2,
                    "streams": 1}


def records_device_ops() -> dict:
    """The device operations (``torch.profiler``) of one call of the scan,
    each gather route, the stream build and the assembly, counted by
    ``scripts/records_ab.py
    --ops-only`` in a process of its own: the profiler of a long process can
    miss kernels. label -> route -> (count, names)."""
    cmd = [sys.executable, "scripts/records_ab.py", "--root", ".", "--ops-only"]
    for label in RECORD_OPS_SHAPES:
        cmd += ["--shape", label]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"records_ab.py --ops-only: {proc.stderr[-2000:]}")
    run = json.loads(proc.stdout.strip().splitlines()[-1])
    out: dict = {}
    for c in run["cases"]:
        n = c["device_ops_per_call"]
        check(1 <= n <= RECORD_OPS_LIMIT[c["route"]],
              f"{c['shape']} {c['route']}: {n} device operations per call ({c['device_ops']})")
        out.setdefault(c["shape"], {})[c["route"]] = {"device_ops_per_call": n,
                                                       "device_ops": c["device_ops"]}
        print(f"phase=records block={c['shape']} route={c['route']} device_ops_per_call={n} "
              f"ops={json.dumps(c['device_ops'])}")
    return out


def records_case(ft, ck, recops, data: bytes, records: int, label: str, timed: bool) -> dict:
    """The four block stages of one block, each kernel held against its
    plain version on the card (byte-equal), the text rebuilt equal to the
    input; the gather (from the text, back to back, the decode's pair) and
    the assembly timed beside their bounds and plain versions, with their
    device operations and host microseconds per call; with ``timed``, the
    scan and the stream build too."""
    from fastqpacker_tpu_torch.pipeline import blocks as blockcodec

    text = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(DEV)
    # 1. scan
    got = ck.records_scan(text, records)
    ref = recops.records_scan_plain(text, records)
    count = int(got[2][recops.SCAN_COUNT])
    check(count == records and int(ref[2][recops.SCAN_COUNT]) == records,
          f"{label}: scan found {count} records")
    check(int(got[2][recops.SCAN_CONSUMED]) == len(data), f"{label}: scan consumed the block")
    errs = {ck.RECORDS_SCAN: max(max_err(got[0][:count], ref[0][:count]),
                                 max_err(got[1][:count], ref[1][:count]),
                                 max_err(got[2], ref[2]))}
    check(errs[ck.RECORDS_SCAN] == 0, f"{label}: scan kernel == plain")
    offsets, qmin, info = got
    offsets = offsets[:count]
    info_h = info.cpu().numpy()
    width = blockcodec.bucket_len(int(info_h[recops.SCAN_SEQ_MAX]))
    # 2. gathers (the compress side: from the text at the scan's offsets)
    gathers = []
    for col, fill in ((2, 0), (6, 0xFF)):
        g = ck.rows_gather(text, offsets[:, col], offsets[:, 3], records, width, fill)
        p = recops.rows_gather_plain(text, offsets[:, col], offsets[:, 3], records, width, fill)
        gathers.append((g, max_err(g, p)))
    errs[ck.ROWS_GATHER] = max(e for _, e in gathers)
    check(errs[ck.ROWS_GATHER] == 0, f"{label}: gather kernel == plain")
    seq_rows, qual_rows = (g for g, _ in gathers)
    lengths32 = offsets[:, 3].to(torch.int32)
    # 3. stream build (v2 layout; v3's u32 npos on the 100,000-record blocks)
    wide = records == BLOCK_RECORDS
    enc = ck.encode_arrays(seq_rows, qual_rows, lengths32, 33,
                           npos_cap=(1 << 31) - 1 if wide else 1 << 16)
    sizes = recops.stream_sizes(info_h, wide)
    buf, binfo = ck.streams_build(text, offsets, enc.packed, enc.qual_delta, enc.nmask_bits,
                                  enc.n_counts, wide, sizes)
    pbuf, pinfo = recops.streams_build_plain(text, offsets, enc.packed, enc.qual_delta,
                                             enc.nmask_bits, enc.n_counts, wide, sizes)
    errs[ck.STREAMS_BUILD] = max(max_err(buf, pbuf), max_err(binfo, pinfo))
    check(errs[ck.STREAMS_BUILD] == 0, f"{label}: stream build kernel == plain")
    check(int(binfo[0]) == sizes[4], f"{label}: npos bytes agree with the scan")
    # 4. assembly from the streams (the decompress side): the decoder's pair
    # gather (quality deltas and packed bases in one launch), then the text
    parts, at = [], 0
    for size in sizes:
        parts.append(buf[at : at + size])
        at += size
    seq_s, qual_s, hdr_s, plus_s, npos_s, len_s = parts
    lens = len_s.clone().view(torch.int32).to(torch.int64)
    pair = (qual_s, None, lens, records, width, 0)
    quarter = (seq_s, width // 4)
    deltas, packed = ck.rows_gather(*pair, quarter=quarter)
    want = recops.rows_gather_plain(*pair, quarter=quarter)
    single = ck.rows_gather(*pair)
    errs[ck.ROWS_GATHER] = max(errs[ck.ROWS_GATHER], max_err(deltas, want[0]),
                               max_err(packed, want[1]), max_err(single, want[0]))
    check(errs[ck.ROWS_GATHER] == 0, f"{label}: back-to-back and pair gather kernel == plain")
    seq_a, qual_a = ck.decode_arrays(packed, deltas, lens.to(torch.int32), 33)
    asm_args = (seq_a, qual_a, lens, hdr_s, plus_s, npos_s, wide, sizes[5], sizes[0], sizes[1])
    out, ainfo = ck.fastq_assemble(*asm_args)
    pout, pinfo = recops.fastq_assemble_plain(*asm_args)
    total = int(ainfo[0])
    errs[ck.FASTQ_ASSEMBLE] = max(max_err(out[:total], pout[:total]), max_err(ainfo, pinfo))
    check(errs[ck.FASTQ_ASSEMBLE] == 0 and int(ainfo[1]) == 0, f"{label}: assemble kernel == plain")
    check(bytes(out[:total].cpu().numpy()) == data, f"{label}: assembled text equals the input")
    print(f"phase=records case={label} records={records} text_bytes={len(data)} width={width} "
          f"stream_bytes={json.dumps(sizes)} byte_equal=true round_trip=true")
    names = (ck.RECORDS_SCAN, ck.ROWS_GATHER, ck.STREAMS_BUILD, ck.FASTQ_ASSEMBLE)
    row = {"errs": errs, "times": {}, "by_shape": {name: {} for name in names}}
    torch.cuda.synchronize()
    nb = len(data)
    seq_total = int(info_h[recops.SCAN_SEQ_SUM])
    gather_err, asm_err = errs[ck.ROWS_GATHER], errs[ck.FASTQ_ASSEMBLE]
    by = row["by_shape"]
    by[ck.RECORDS_SCAN]["scan"] = time_case(
        ck.RECORDS_SCAN, label, "scan", lambda t: ck.records_scan(t, records),
        lambda t: recops.records_scan_plain(t, records), (text,), scan_bytes(nb, records),
        4 * nb, errs[ck.RECORDS_SCAN])
    # reads the qualities, starts and lengths (16 B a row); writes the rows
    by[ck.ROWS_GATHER]["text"] = time_case(
        ck.ROWS_GATHER, label, "text",
        lambda t, o: ck.rows_gather(t, o[:, 6], o[:, 3], records, width, 0xFF),
        lambda t, o: recops.rows_gather_plain(t, o[:, 6], o[:, 3], records, width, 0xFF),
        (text, offsets), seq_total + 16 * records + records * width, records * width, gather_err)
    by[ck.STREAMS_BUILD]["streams"] = time_case(
        ck.STREAMS_BUILD, label, "streams",
        lambda t, o, *a: ck.streams_build(t, o, *a, wide, sizes),
        lambda t, o, *a: recops.streams_build_plain(t, o, *a, wide, sizes),
        (text, offsets, enc.packed, enc.qual_delta, enc.nmask_bits, enc.n_counts),
        streams_bytes(sizes, records, enc.nmask_bits), 2 * sum(sizes), errs[ck.STREAMS_BUILD])
    lms, note = library_pad_ms(qual_s, lens, records, width, 50)
    by[ck.ROWS_GATHER]["back_to_back"] = time_case(
        ck.ROWS_GATHER, label, "back_to_back",
        lambda q, n: ck.rows_gather(q, None, n, records, width, 0),
        lambda q, n: recops.rows_gather_plain(q, None, n, records, width, 0),
        (qual_s, lens), seq_total + 8 * records + records * width, records * width, gather_err,
        lms, note)
    by[ck.ROWS_GATHER]["pair"] = time_case(
        ck.ROWS_GATHER, label, "pair",
        lambda q, s_, n: ck.rows_gather(q, None, n, records, width, 0, quarter=(s_, width // 4)),
        lambda q, s_, n: recops.rows_gather_plain(q, None, n, records, width, 0,
                                                  quarter=(s_, width // 4)),
        (qual_s, seq_s, lens), seq_total + sizes[0] + 8 * records + records * (width + width // 4),
        records * (width + width // 4), gather_err)
    by[ck.FASTQ_ASSEMBLE]["assemble"] = time_case(
        ck.FASTQ_ASSEMBLE, label, "assemble", lambda *a: ck.fastq_assemble(*a),
        lambda *a: recops.fastq_assemble_plain(*a), asm_args,
        # reads the rows, lengths, header, plus and npos streams; writes the text
        2 * seq_total + 8 * records + sizes[2] + sizes[3] + sizes[4] + total, 2 * total,
        asm_err)
    if not timed:
        return row
    for name, route in ((ck.RECORDS_SCAN, "scan"), (ck.ROWS_GATHER, "text"),
                        (ck.STREAMS_BUILD, "streams"), (ck.FASTQ_ASSEMBLE, "assemble")):
        row["times"][name] = by[name][route]
    row["host_split"] = {
        ck.RECORDS_SCAN: host_split(ck, ck.RECORDS_SCAN, lambda: ck.records_scan(text, records)),
        ck.STREAMS_BUILD: host_split(ck, ck.STREAMS_BUILD, lambda: ck.streams_build(
            text, offsets, enc.packed, enc.qual_delta, enc.nmask_bits, enc.n_counts, wide,
            sizes)),
    }
    return row


HOST_SPLIT_CALLS = 200  # wrapper calls per reading of the host split
# the wrappers' helpers in ops/cuda_kernels.py that the split times, by step
HOST_SPLIT_STEPS = {"_check": "checks", "_check_1d": "checks", "_plain_or_cuda": "checks",
                    "_sm_count": "scratch", "_scratch": "scratch",
                    "_chained_state": "chained_state", "_launch": "launch"}


def host_split(ck, name: str, call) -> dict:
    """Host microseconds of one call of a records wrapper (``call``, run
    HOST_SPLIT_CALLS times on the host clock), step by step, through the
    wrapper itself: for a second run, each helper of HOST_SPLIT_STEPS and,
    inside ``_launch``, the ctypes call are wrapped in a timer. What the
    helpers do not take ("outputs_and_rest") is the wrapper's own code, its
    output allocations the most of it. The ``record_function`` span and the
    device context that ``_launch`` opens are timed alone beside it. Printed
    as a phase record."""
    us = dict.fromkeys(("checks", "scratch", "chained_state", "launch", "launch.ctypes_call"),
                       0.0)

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                us[key] += time.perf_counter() - t0
        return run

    class Lib:  # the loaded library, each entry point's call timed
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, attr):
            return timed(getattr(self.lib, attr), "launch.ctypes_call")

    def per_call(body) -> float:
        body()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_SPLIT_CALLS):
            body()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / HOST_SPLIT_CALLS * 1e6

    whole = per_call(call)
    saved, build = {attr: getattr(ck, attr) for attr in HOST_SPLIT_STEPS}, ck.build
    try:
        for attr, key in HOST_SPLIT_STEPS.items():
            setattr(ck, attr, timed(saved[attr], key))
        ck.build = type("build", (), {"load": staticmethod(lambda lib: Lib(build.load(lib)))})
        call()
        us.update(dict.fromkeys(us, 0.0))
        timed_whole = per_call(call)
    finally:
        for attr, fn in saved.items():
            setattr(ck, attr, fn)
        ck.build = build
    split = {k: v / HOST_SPLIT_CALLS * 1e6 for k, v in us.items()}
    split["launch.rest"] = split["launch"] - split["launch.ctypes_call"]
    split["outputs_and_rest"] = timed_whole - sum(
        split[k] for k in ("checks", "scratch", "chained_state", "launch"))
    def span():
        with torch.profiler.record_function(name):
            pass

    def context():
        with torch.cuda.device(DEV):
            pass

    out = {"whole_wrapper": whole, "whole_wrapper_with_timers": timed_whole, **split,
           "alone.record_function": per_call(span), "alone.device_context": per_call(context)}
    print(f"phase=records host_split kernel={name} calls={HOST_SPLIT_CALLS} "
          f"us_per_call={json.dumps({k: round(v, 3) for k, v in out.items()})}")
    return out


def records_faults(ft, ck, recops) -> dict:
    """Every scan fault and every assembly fault raises its string on the
    card, as on the CPU."""
    from fastqpacker_tpu_torch.entropy import zstd
    from fastqpacker_tpu_torch.parser.fastq import FastqParseError, FastqStreamParser
    from fastqpacker_tpu_torch.pipeline import blocks as blockcodec

    good = b"@r1 x\nACGTN\n+p\nIIIII\n@r2\nAC\n+\nII\n"
    bad_texts = [b"@r\nAC\n+\nII\nx\n", b"@r\nAC\n-\nII\n", b"@r\nAC\n+\nI\n",
                 good + b"@r3\nA\n-x\n", good + b"r3\n"]
    seen = []
    for text in bad_texts:
        msgs = []
        for dev in (DEV, "cpu"):
            try:
                list(FastqStreamParser(io.BytesIO(text), block_size=2, device=dev).blocks())
                msgs.append(None)
            except FastqParseError as e:
                msgs.append(str(e))
        check(msgs[0] is not None and msgs[0] == msgs[1], f"scan fault {text!r}: {msgs}")
        seen.append(msgs[0])
    comp = ft.compress_bytes(good * 8, ft.Options(block_size=16), device="cpu")
    hdr = ft.container.parse_block_header(comp[ft.container.FILE_HEADER_SIZE:], 2)
    ds = blockcodec.decode_streams(hdr, comp[ft.container.FILE_HEADER_SIZE + 36:], 2,
                                   zstd.get_codec())
    faults = 0
    for field in ("lengths", "seq", "qual", "headers", "plus", "npos"):
        orig = getattr(ds, field)
        for cut in (len(orig) - 1, len(orig) // 2):
            for flip in (False, True):
                bad = orig.copy() if flip else orig[:cut]
                if flip:
                    bad[min(cut, len(bad) - 1)] ^= 0x5A
                setattr(ds, field, bad)
                msgs = []
                for dev in (DEV, "cpu"):
                    try:
                        out = blockcodec.streams_to_fastq(ds, 33, dev)
                        msgs.append(("ok", len(out)))
                    except ValueError as e:
                        msgs.append((type(e).__name__, str(e)))
                check(msgs[0] == msgs[1], f"stream fault {field} cut={cut} flip={flip}: {msgs}")
                faults += msgs[0][0] != "ok"
        setattr(ds, field, orig)
    print(f"phase=records faults scan={len(seen)} scan_strings={json.dumps(sorted(set(seen)))} "
          f"stream_faults={faults} equal_to_cpu=true")
    return {"scan": len(seen), "streams": faults}


def phase_records(ft, ck, recops, rng) -> dict:
    """The four block stages at the main paths' shapes and at blocks of
    read names of varying width, against their plain versions, each timed
    at every shape with its device operations and host microseconds per
    call; the host split of the scan and stream build wrappers on the v2
    block; and their faults."""
    rows = {}
    for i, (label, (records, lens, names)) in enumerate(RECORD_SHAPES.items()):
        data = records_block(records, lens, names, seed=100 + i)
        rows[label] = records_case(ft, ck, recops, data, records, label, label == RECORD_TIMED)
        del data
        torch.cuda.empty_cache()
    faults = records_faults(ft, ck, recops)
    errs = {name: max(r["errs"][name] for r in rows.values()) for name in rows[RECORD_TIMED]["errs"]}
    routes = {ck.RECORDS_SCAN: ("scan",), ck.ROWS_GATHER: ("text", "back_to_back", "decoder"),
              ck.STREAMS_BUILD: ("streams",), ck.FASTQ_ASSEMBLE: ("assemble",)}
    by_shape = {name: {label: r["by_shape"][name] for label, r in rows.items()} for name in routes}
    for label, per_route in records_device_ops().items():
        for name, names in routes.items():
            for route in names:
                key = "pair" if route == "decoder" else route
                by_shape[name][label][key].update(per_route[route])
    return {"errs": errs, "times": rows[RECORD_TIMED]["times"], "faults": faults,
            "by_shape": by_shape, "host_split": rows[RECORD_TIMED]["host_split"]}


# ---------------------------------------------------------------------------
# phase ctxprep: the context-model passes as kernels (csrc/ctxprep.cu)
# ---------------------------------------------------------------------------

# the streams the layout kernels are timed on in the kernels line: the
# mesh path's quality stream (model 1, order 1) on the lanes it picks
CTX_TIMED = (1, 1)
CTX_MODELS = [(0, 2), (0, 4), (0, 6), (1, 0), (1, 1)]  # seq orders 2/4/6, qual 0/1


def corpus_block(data: bytes, records: int | None = None):
    """The seq (packed rows) and qual (deltas) streams and the lengths of
    the first block of ``data``, built on the card: ``records`` records
    (default: BLOCK_RECORDS, read at the call)."""
    from fastqpacker_tpu_torch.parser.fastq import FastqStreamParser
    from fastqpacker_tpu_torch.pipeline import blocks as blockcodec

    records = records or BLOCK_RECORDS
    blk = next(FastqStreamParser(io.BytesIO(data), block_size=records, device=DEV).blocks())
    check(blk.n == records, f"corpus block of {blk.n} records")
    raw = blockcodec.block_to_raw_streams(blk, 33, wide_npos=True)
    return (np.frombuffer(raw.seq, np.uint8), np.frombuffer(raw.qual, np.uint8),
            np.frombuffer(raw.lengths, "<u4").astype(np.int64))


def ctx_time(name, shape, kfn, pfn, args, nbytes, ops, err, lib=None) -> tuple:
    """A kernel timed over rotated inputs beside its plain version (and a
    PyTorch reference call, printed only), with its bound."""
    sets = rotations(args, max(nbytes, 1))
    kms = gpu_ms(kfn, sets, 20)
    pms = gpu_ms(pfn, sets[:1], 1)
    extra = {}
    if lib is not None:
        lname, lfn, largs, what = lib
        extra[f"{lname}_ms"] = gpu_ms(lfn, rotations(largs, largs[0].numel() * 8), 20)
        print(f"phase=ctxprep kernel={name} {shape} {lname}_ms={extra[f'{lname}_ms']:.6f} "
              f"({what} by one PyTorch call; printed only)")
    return (*report(name, shape, kms, pms, None, nbytes, ops, err), extra)


def ctxprep_corpus(ck, ctxprep, wctx, label: str, data: bytes, layouts: bool) -> dict:
    """Each kernel of csrc/ctxprep.cu on one corpus block against its plain
    version on the card (byte-equal), timed; with ``layouts``, the lane
    passes at every (model, order) the mesh path codes, on the lanes it
    picks for them."""
    from fastqpacker_tpu_torch.ops import qualctx, seqctx

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    packed_h, delta_h, lengths = corpus_block(data)
    n, nrec, m = int(lengths.sum()), len(lengths), len(packed_h)
    delta, packed = t(delta_h), t(packed_h)
    bounds_h = ctxprep.record_bounds(lengths)
    pbounds_h = ctxprep.record_bounds(lengths, packed=True)
    bounds, pbounds = t(bounds_h), t(pbounds_h)
    errs, times = {}, {}
    shape = f"corpus={label} records={nrec} symbols={n}"

    raw, hist2 = ck.qctx_prepare(delta, bounds)
    praw, phist2 = ctxprep.qctx_prepare_plain(delta, bounds)
    errs[ck.QCTX_PREPARE] = max(max_err(raw, praw), max_err(hist2, phist2))
    check(errs[ck.QCTX_PREPARE] == 0, f"{label}: fq_qctx_prepare == plain")
    keys = ctxprep.qctx_keys(delta, bounds)[1]
    times[ck.QCTX_PREPARE] = ctx_time(
        ck.QCTX_PREPARE, shape, ck.qctx_prepare, ctxprep.qctx_prepare_plain, (delta, bounds),
        2 * n + 8 * (nrec + 1) + 4 * ctxprep.QCTX_CONTEXTS * 256, 16 * n, errs[ck.QCTX_PREPARE],
        ("bincount", lambda k: torch.bincount(k, minlength=ctxprep.QCTX_CONTEXTS * 256), (keys,),
         "the same keys counted"))
    del keys
    bases, hist6 = ck.sctx_prepare(packed, pbounds, n)
    pbases, phist6 = ctxprep.sctx_prepare_plain(packed, pbounds)
    errs[ck.SCTX_PREPARE] = max(max_err(bases, pbases), max_err(hist6, phist6))
    check(errs[ck.SCTX_PREPARE] == 0, f"{label}: fq_sctx_prepare == plain")
    keys = ctxprep.sctx_keys(packed, pbounds, n)[1]
    times[ck.SCTX_PREPARE] = ctx_time(
        ck.SCTX_PREPARE, shape, lambda a, b: ck.sctx_prepare(a, b, n),
        ctxprep.sctx_prepare_plain, (packed, pbounds),
        m + n + 16 * (nrec + 1) + 4 * ctxprep.SCTX_CONTEXTS * 4, 16 * n, errs[ck.SCTX_PREPARE],
        ("bincount", lambda k: torch.bincount(k, minlength=ctxprep.SCTX_CONTEXTS * 4), (keys,),
         "the same keys counted"))
    del keys
    print(f"phase=ctxprep corpus={label} records={nrec} symbols={n} packed_bytes={m} "
          f"qctx_prepare_byte_equal=true sctx_prepare_byte_equal=true")
    row = {"errs": errs, "times": times, "layout": {}}
    if not layouts:
        return row
    hist2_h = hist2.cpu().numpy().astype(np.int64)
    hist6_h = hist6.cpu().numpy().astype(np.int64)
    errs[ck.WCTX_LAYOUT] = errs[ck.WCTX_UNLAYOUT] = 0
    for model, order in CTX_MODELS:
        if model == 0:
            syms, hist = bases, (seqctx.marginalize(hist6_h, order) if order < 6 else hist6_h)
            mode, out_bytes, ub = ctxprep.UNLAYOUT_PACKED, m, pbounds
        else:
            syms, hist = raw, qualctx.hist_for_model(hist2_h, order)
            mode, out_bytes, ub = ctxprep.UNLAYOUT_DELTA, n, bounds
        lanes = wctx.pick_lanes_for(hist, n)
        tab_h, S, seg = ctxprep.lane_layout(lengths, lanes)
        counts = hist.sum(axis=0)
        present = np.flatnonzero(counts > 0)
        pad = int(np.argmax(counts))
        tab, idx, pres = t(tab_h), t(wctx._sym_to_idx(present)), t(present.astype(np.uint8))
        enc_args = (syms, bounds, tab, S, model, order, idx, pad)
        sym_idx, ctx = ck.wctx_layout(*enc_args)
        psym, pctx = ctxprep.wctx_layout_plain(*enc_args)
        start = ck.wctx_layout(None, bounds, tab, S, model, order)
        pstart = ctxprep.wctx_layout_plain(None, bounds, tab, S, model, order, None, 0)
        e_lay = max(max_err(sym_idx, psym), max_err(ctx, pctx), max_err(start, pstart))
        # the decoder's matrix: the symbols' indices, 0 on padding
        data = t(np.arange(S)[:, None] < seg[None, :])
        mat = torch.where(data, sym_idx, 0)
        wire, fault = ck.wctx_unlayout(mat, ub, tab, pres, mode, out_bytes)
        pwire, pfault = ctxprep.wctx_unlayout_plain(mat, ub, tab, pres, mode)
        e_un = max(max_err(wire, pwire), max_err(fault, pfault))
        want = packed_h if model == 0 else delta_h
        check(e_lay == 0 and e_un == 0 and int(fault) == 0
              and np.array_equal(wire.cpu().numpy(), want),
              f"{label} model={model} order={order}: layout / unlayout == plain, wire == stream")
        errs[ck.WCTX_LAYOUT] = max(errs[ck.WCTX_LAYOUT], e_lay)
        errs[ck.WCTX_UNLAYOUT] = max(errs[ck.WCTX_UNLAYOUT], e_un)
        cells = S * lanes
        geo = 8 * (nrec + 1) + 16 * (lanes + 1)
        lshape = f"{shape} model={model} order={order} lanes={lanes} steps={S} cells={cells}"
        row["layout"][(model, order)] = {
            "encode": ctx_time(ck.WCTX_LAYOUT, lshape + " direction=encode",
                               lambda a: ck.wctx_layout(a, *enc_args[1:]),
                               lambda a: ctxprep.wctx_layout_plain(a, *enc_args[1:]), (syms,),
                               n + 3 * cells + geo + 256, 8 * cells, e_lay),
            "decode": ctx_time(ck.WCTX_LAYOUT, lshape + " direction=decode",
                               lambda b: ck.wctx_layout(None, b, tab, S, model, order),
                               lambda b: ctxprep.wctx_layout_plain(None, b, tab, S, model,
                                                                   order, None, 0),
                               (bounds,), cells + geo, 2 * cells, e_lay),
            "unlayout": ctx_time(ck.WCTX_UNLAYOUT, lshape,
                                 lambda a: ck.wctx_unlayout(a, ub, tab, pres, mode, out_bytes),
                                 lambda a: ctxprep.wctx_unlayout_plain(a, ub, tab, pres, mode),
                                 (mat,), n + out_bytes + geo * (2 if model == 0 else 1)
                                 + len(present), 6 * n, e_un,
                                 ("masked_select", lambda a, k: torch.masked_select(a.t(), k),
                                  (mat, data.t().contiguous()),
                                  "the data cells transposed and compacted, without the present "
                                  "map or the delta,")),
            "lanes": lanes, "steps": S,
        }
        print(f"phase=ctxprep corpus={label} model={model} order={order} lanes={lanes} "
              f"steps={S} layout_byte_equal=true unlayout_byte_equal=true wire_equals_stream=true")
        del sym_idx, ctx, start, mat, data, wire, psym, pctx, pstart, pwire
        torch.cuda.empty_cache()
    return row


def ctxprep_faults(ck, ctxprep, wctx) -> dict:
    """The length mismatches raise their strings before any launch, and an
    index >= npres in a decoded matrix raises "corrupted wctx stream" from
    the unlayout's fault flag, on the card as on the CPU."""
    from fastqpacker_tpu_torch.ops import qualctx, seqctx

    lengths = np.array([151, 0, 37, 70_001], np.int64)
    msgs = []
    for dev in (DEV, torch.device("cpu")):
        got = []
        for fn, stream in ((qualctx.prepare, np.zeros(int(lengths.sum()) - 1, np.uint8)),
                           (seqctx.prepare, np.zeros(int(((lengths + 3) >> 2).sum()) + 1,
                                                     np.uint8))):
            try:
                fn(stream, lengths, dev)
                got.append(None)
            except ValueError as e:
                got.append(str(e))
        small = np.full(300, 50, np.int64)  # the CPU's plain decode walks every step
        rng = np.random.default_rng(9)
        syms = np.clip(30 + np.cumsum(rng.integers(-2, 3, int(small.sum()))) // 3, 0, 41)
        payload = wctx.encode_stream(syms.astype(np.uint8), small, 1, 1, lanes=256, device=dev)
        real = ck.wctx_unlayout

        def flipped(mat, *args):
            mat = mat.clone()
            mat[1, 0] = 255
            return real(mat, *args)

        ck.wctx_unlayout = flipped
        try:
            wctx.decode_wire(payload, small, device=dev)
            got.append(None)
        except wctx.WctxError as e:
            got.append(str(e))
        finally:
            ck.wctx_unlayout = real
        msgs.append(got)
    want = ["qual stream length does not match record lengths",
            "packed sequence data does not match lengths", "corrupted wctx stream"]
    check(msgs[0] == msgs[1] == want, f"ctxprep faults: {msgs}")
    print(f"phase=ctxprep faults={json.dumps(msgs[0])} equal_to_cpu=true")
    return {"faults": len(want)}


# device operations one call of each context pass may run (a histogram's
# memset and the kernel; one launch for the lane passes)
CTX_OPS_LIMIT = {"qctx": 2, "sctx": 2, "layout_encode": 1, "layout_decode": 1, "unlayout": 1}


def ctxprep_device_ops() -> dict:
    """The device operations (``torch.profiler``) of one call of each
    context pass at every model and order, counted by ``scripts/ctxprep_ab.py
    --ops-only`` on a 20,000-record ``markov151`` block in a process of its
    own (the profiler of a long process can miss kernels): route -> counts."""
    cmd = [sys.executable, "scripts/ctxprep_ab.py", "--root", ".", "--ops-only",
           "--records", "20000", "--corpus", "markov151"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"ctxprep_ab.py --ops-only: {proc.stderr[-2000:]}")
    out: dict = {}
    for c in json.loads(proc.stdout.strip().splitlines()[-1])["cases"]:
        n = c["device_ops_per_call"]
        check(1 <= n <= CTX_OPS_LIMIT[c["route"]],
              f"{c['shape']} {c['route']}: {n} device operations per call ({c['device_ops']})")
        out.setdefault(c["route"], []).append(n)
        print(f"phase=ctxprep route={c['route']} {c['shape']} device_ops_per_call={n} "
              f"ops={json.dumps(c['device_ops'])}")
    return out


def ctxprep_edges(ck, ctxprep) -> int:
    """The sctx prepare and the layout at their tiles' edges
    (``tests/torch_ctxprep_inputs.py``: short records, starts just before a
    thread's 16 bases and a tile edge, a 70,001-bp read, pad bits set;
    2,047 lanes, steps one past a tile, records starting at a tile's first
    step, positions past 112) against their plain versions on the card,
    byte for byte, at every model and order. Returns the cases held."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_ctxprep_inputs", Path(__file__).resolve().parent / "tests" / "torch_ctxprep_inputs.py")
    ci = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ci)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    held = 0
    for case in sorted(ci.sctx_prepare_edge_cases()):
        lengths, packed_h = ci.sctx_prepare_stream(case, 83)
        packed, b = t(packed_h), t(ctxprep.record_bounds(lengths, packed=True))
        got = ck.sctx_prepare(packed, b, int(lengths.sum()))
        want = ctxprep.sctx_prepare_plain(packed, b)
        check(all(max_err(x, y) == 0 for x, y in zip(got, want)),
              f"sctx prepare edge {case}: kernel == plain")
        held += 1
    for case in sorted(ci.layout_edge_cases()):
        for model, order in CTX_MODELS:
            lengths, lanes, syms = ci.layout_stream(case, model, 84)
            tab, steps, _ = ctxprep.lane_layout(lengths, lanes)
            counts = np.bincount(syms, minlength=256)
            idx = np.zeros(256, np.uint8)
            idx[counts > 0] = np.arange(int((counts > 0).sum()))
            args = (t(syms), t(ctxprep.record_bounds(lengths)), t(tab), steps, model, order,
                    t(idx), int(np.argmax(counts)))
            got = (*ck.wctx_layout(*args), ck.wctx_layout(None, *args[1:6]))
            want = (*ctxprep.wctx_layout_plain(*args),
                    ctxprep.wctx_layout_plain(None, *args[1:6], None, 0))
            check(all(max_err(x, y) == 0 for x, y in zip(got, want)),
                  f"layout edge {case} model={model} order={order}: kernel == plain")
            held += 1
    print(f"phase=ctxprep edges={held} sctx_prepare_byte_equal=true layout_byte_equal=true")
    return held


def phase_ctxprep(ft, ck, args) -> dict:
    """The four context-model kernels at full width (100,000 x 151): the
    prepare passes on the v3 run's corpus (walk qualities) and the mesh
    run's (Markov bases, Phred walks), the lane passes on the latter at every
    model and order the mesh path codes; then their faults."""
    from fastqpacker_tpu_torch.ops import ctxprep, wctx
    from fastqpacker_tpu_torch.utils.synth import synth_fastq

    one = len(synth_fastq(0, read_len=READ_LEN))
    walk = synth_fastq((BLOCK_RECORDS * one + one // 2) / (1 << 20), seed=args.seed + 11,
                       qual_model="walk")
    rows = {"walk": ctxprep_corpus(ck, ctxprep, wctx, "walk151", walk, False)}
    del walk
    markov = context_corpus(BLOCK_RECORDS, args.seed + 12)
    rows["markov"] = ctxprep_corpus(ck, ctxprep, wctx, "markov151", markov, True)
    del markov
    faults = ctxprep_faults(ck, ctxprep, wctx)
    edges = ctxprep_edges(ck, ctxprep)
    ops = ctxprep_device_ops()
    errs = {}
    for row in rows.values():
        for name, e in row["errs"].items():
            errs[name] = max(errs.get(name, 0), e)
    return {"errs": errs, "rows": rows, "edges": edges, "device_ops": ops, **faults}


# ---------------------------------------------------------------------------
# phase tokens: the runtime's byte histogram and header tokenizer
# (csrc/hist256.cu, csrc/tokens.cu)
# ---------------------------------------------------------------------------

TOKEN_BLOCKS = 3  # the ordered-name round trip: blocks of BLOCK_RECORDS records
RANS_MIN_BYTES = 16384  # pipeline/native.py: streams below go to zstd unestimated
TOK_GATE_BYTES = 256 << 10  # pipeline/native.py: the header gate looks at larger streams
GOLDEN_TOK = "tests/testdata/golden/golden_ctx_v3.fqz"
# SHA-256 of its FASTQ (tests/test_golden.py:_golden_ctx_fastq, which the CPU
# tests decode it to)
GOLDEN_TOK_SHA256 = "173eef211411531f4ccf343a983fe62ed4756ccd8254e230aae710e655dea76a"

# the CPU's v3 container of a corpus, made in a process of its own while the
# card runs the other phases (one worker: the probe memo depends on order):
# the ordered-name corpus of phase tokens, or the first block of the
# context-model corpus of phase ctxcoder (its Python walks take a minute)
_CPU_REFERENCE = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
import fastqpacker_tpu_torch as ft
corpus, records, seed, out = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
keep, block = int(sys.argv[6]), int(sys.argv[7])
if corpus == "ordered":
    from fastqpacker_tpu_torch.utils.synth import ordered_illumina_fastq
    data = ordered_illumina_fastq(records, seed=seed)
else:
    import chip_smoke
    data = chip_smoke.context_corpus(records, seed)
if keep:  # the first records only
    at = -1
    for _ in range(4 * keep):
        at = data.index(b"\n", at + 1)
    data = data[: at + 1]
opts = ft.Options(version=ft.container.VERSION_3_NATIVE, block_size=block, workers=1)
open(out, "wb").write(ft.compress_bytes(data, opts, device="cpu"))
"""


class CpuReference:
    """The CPU's container of ``corpus`` ("ordered": the ordered-name
    corpus; "context": the context-model corpus) of ``records`` records, or
    of its first ``keep``, at blocks of BLOCK_RECORDS, from a subprocess
    started at once; :meth:`result` waits for it, :meth:`stop` ends it."""

    def __init__(self, corpus: str, records: int, seed: int, workdir: Path, keep: int = 0):
        self.path = workdir / f"{corpus}_cpu.fqz"
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CPU_REFERENCE, str(Path(__file__).resolve().parent),
             corpus, str(records), str(seed), str(self.path), str(keep), str(BLOCK_RECORDS)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(self) -> tuple[bytes, float]:
        _, err = self.proc.communicate(timeout=900)
        check(self.proc.returncode == 0, f"CPU reference container: {err[-2000:]}")
        return self.path.read_bytes(), time.perf_counter() - self.t0

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def load_tests_module(name: str):
    """A module of ``tests/`` (its seeded inputs), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def on_card(b: bytes, off: int = 0) -> torch.Tensor:
    """``b`` on the card as a view ``off`` bytes into its buffer."""
    buf = torch.from_numpy(np.frombuffer(b"\x5a" * off + b + b"\x5a", np.uint8).copy()).to(DEV)
    return buf[off : off + len(b)]


def outcome(fn, *args):
    """("ok", bytes) or ("error", the ValueError's string) of one call."""
    try:
        r = fn(*args)
    except ValueError as e:
        return ("error", str(e))
    return ("ok", r if isinstance(r, bytes) else r.cpu().numpy().tobytes())


def tokens_edges(ck, rans, tokenize, ti) -> dict:
    """Every edge of ``tests/torch_tokens_inputs.py`` on the card against the
    plain versions, byte for byte: the histogram's lengths, offsets and
    alphabets; the header lists through the encode (a view at offset 3) and
    back through the decode; each decode fault (string) and stream whose
    bytes past its last record would fault; the encode's faults. Returns the
    cases held per kernel."""
    held = {"hist256": 0, "tok_encode": 0, "tok_encode_lengths": 0, "tok_decode": 0,
            "decode_faults": 0, "encode_faults": 0}
    for case, (buf, off, n) in sorted(ti.hist_edge_cases().items()):
        t = on_card(buf[off : off + n], off % 16)
        check(torch.equal(ck.hist256(t).cpu(), rans.hist256_plain(t.cpu())),
              f"hist256 edge {case}: kernel == plain")
        held["hist256"] += 1
    for case, headers in sorted(ti.header_edge_cases().items()):
        s = ti.stream_of(headers)
        view = on_card(s, 3)
        want = tokenize.tok_encode_plain(view.cpu(), len(headers))
        check(torch.equal(ck.tok_encode(view, len(headers)).cpu(), want),
              f"tok_encode edge {case}: kernel == plain")
        if headers:  # the compress path's route: the record starts from the header lengths
            lens = torch.tensor([len(h) for h in headers], dtype=torch.int64, device=DEV)
            check(torch.equal(ck.tok_encode(view, len(headers), lens).cpu(), want),
                  f"tok_encode edge {case} from the header lengths: kernel == plain")
            held["tok_encode_lengths"] += 1
        back = ck.tok_decode(on_card(want.numpy().tobytes()), len(headers))
        check(back.cpu().numpy().tobytes() == s, f"tok_decode edge {case}: the stream back")
        held["tok_encode"] += 1
        held["tok_decode"] += 1
    strings = set()
    for case, (data, count) in sorted(ti.decode_fault_cases().items()):
        want = outcome(tokenize.decode_plain, data, count)
        got = outcome(ck.tok_decode, on_card(data), count)
        check(got == want, f"tok_decode fault {case}: {got[1] if got[0] == 'error' else 'ok'} "
                           f"== the CPU's {want[1] if want[0] == 'error' else 'ok'}")
        if want[0] == "error":
            strings.add(want[1])
        held["decode_faults"] += 1
    for stream, count in ((ti.stream_of([b"a", b"b"]), 3), (ti.stream_of([b"a", b"b"])[:-1], 2),
                          (ti.stream_of([b"a", b"b"]) + b"\x00", 2),
                          (ti.stream_of([b"a" * 300, b"b"])[:-5], 2)):
        want = outcome(tokenize.encode_plain, stream, count)
        check(want[0] == "error" and outcome(ck.tok_encode, on_card(stream, 5), count) == want,
              f"tok_encode fault {want[1]}: the CPU's string")
        held["encode_faults"] += 1
    print(f"phase=tokens edges={json.dumps(held, sort_keys=True)} byte_equal=true "
          f"decode_fault_strings={json.dumps(sorted(strings))} equal_to_cpu=true")
    return held


def retile(view: torch.Tensor, k: int) -> list:
    """``k`` copies of ``view``, each at the same offset past a 16-byte
    boundary in a buffer of its own (the L2 rotation of a misaligned view)."""
    off = view.data_ptr() % 16
    out = []
    for _ in range(k):
        buf = torch.empty(view.numel() + 32, dtype=torch.uint8, device=DEV)
        base = (16 - buf.data_ptr() % 16) % 16 + off
        buf[base : base + view.numel()].copy_(view)
        out.append((buf[base : base + view.numel()],))
    return out


def tokens_block(data: bytes):
    """The first 100,000-record block of ``data``, its six streams built on
    the card (``RawStreams``, their device views where the stream build left
    them)."""
    from fastqpacker_tpu_torch.parser.fastq import FastqStreamParser
    from fastqpacker_tpu_torch.pipeline import blocks as blockcodec

    blk = next(FastqStreamParser(io.BytesIO(data), block_size=BLOCK_RECORDS, device=DEV).blocks())
    return blockcodec.block_to_raw_streams(blk, 33, wide_npos=True)


HIST_STREAMS = ("walk_qual", "walk_seq", "ordered_qual", "ordered_seq", "alternating",
                "walk_deltas", "uniform", "one_symbol")


def hist_streams(names, seed: int) -> dict:
    """name -> a uint8 view on the card: the quality (15.1 MB) and sequence
    (3.8 MB) streams of the first 100,000-record v3 block of the walk151
    corpus (``synth_fastq(40, seed=seed + 4, qual_model="walk")``, the v3
    main path's fixture) and of the ordered-name corpus
    (``ordered_illumina_fastq(100000, seed=seed + 19)``), where the stream
    build left them; and QUAL_STREAM bytes of two bytes in turn (every byte
    a new run, all lanes on two slots), of the walk model's quality steps
    (72% zeros in short runs), of uniform bytes and of one byte."""
    from fastqpacker_tpu_torch.utils import synth

    out = {}
    if {"walk_qual", "walk_seq"} & set(names):
        raw = tokens_block(synth.synth_fastq(40, seed=seed + 4, qual_model="walk"))
        out["walk_qual"], out["walk_seq"] = raw.device_view(1), raw.device_view(0)
    if {"ordered_qual", "ordered_seq"} & set(names):
        raw = tokens_block(synth.ordered_illumina_fastq(BLOCK_RECORDS, seed=seed + 19))
        out["ordered_qual"], out["ordered_seq"] = raw.device_view(1), raw.device_view(0)
    rng = np.random.default_rng(seed + 21)
    n = QUAL_STREAM
    made = {
        "alternating": lambda: np.tile(np.array([3, 200], np.uint8), n // 2 + 1)[:n],
        "walk_deltas": lambda: synth.walk_steps(rng, n).view(np.uint8),
        "uniform": lambda: rng.integers(0, 256, n, dtype=np.uint8),
        "one_symbol": lambda: np.full(n, 77, np.uint8),
    }
    for name, fn in made.items():
        if name in names:
            out[name] = torch.from_numpy(np.ascontiguousarray(fn())).to(DEV)
    return {k: out[k] for k in names}


# the device operations of one call of each of phase tokens' wrappers, in a
# process of its own (the profiler of a long process can miss kernels), and
# each kernel's device microseconds a call; the decode also at a small count
_TOKENS_OPS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import torch
from fastqpacker_tpu_torch.ops import cuda_kernels as ck
from fastqpacker_tpu_torch.utils.synth import ordered_illumina_fastq
raw = cs.tokens_block(ordered_illumina_fastq(cs.BLOCK_RECORDS, seed=int(sys.argv[2])))
n = raw.num_records
view, lens = raw.device_view(2), raw.header_lengths
tok = ck.tok_encode(view, n, lens)
small = 1000
tok_small = ck.tok_encode(view[: int(lens[:small].sum()) + 2 * small], small, lens[:small])
calls = {
    "hist256_qual": lambda: ck.hist256(raw.device_view(1)),
    "hist256_seq": lambda: ck.hist256(raw.device_view(0)),
    "tok_encode": lambda: ck.tok_encode(view, n, lens),
    "tok_encode_bare": lambda: ck.tok_encode(view, n),
    "tok_decode": lambda: ck.tok_decode(tok, n),
    "tok_decode_small": lambda: ck.tok_decode(tok_small, small),
}
out = {name: cs.device_ops(fn) for name, fn in calls.items()}
out["split_us"] = {name: cs.split_us(calls[name]) for name in
                   ("tok_encode", "tok_encode_bare", "tok_decode")}
print(json.dumps(out))
"""


def split_us(fn, calls: int = 10) -> dict:
    """Device microseconds and launches per call of each kernel and copy
    one call of ``fn`` runs (``torch.profiler``)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0].strip():
            {"us": round(e.device_time_total / calls, 3), "launches": e.count / calls}
            for e in prof.key_averages() if e.device_type.name == "CUDA"}


def tokens_device_ops(seed: int) -> dict:
    """Route -> the device operations (``torch.profiler``) of one wrapper
    call at a v3 block of ordered names, counted in a process of its own;
    ``split_us``: the tokenizer's kernels' device microseconds a call."""
    proc = subprocess.run([sys.executable, "-c", _TOKENS_OPS,
                           str(Path(__file__).resolve().parent), str(seed)],
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"tokens device operations: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def tokens_timed(ft, ck, rans, tokenize, data: bytes, seed: int) -> dict:
    """The three kernels at a v3 block's shapes, on the block's streams where
    the stream build left them (the first 100,000 records of the ordered
    corpus): the histogram of the quality (15.1 MB) and sequence (3.8 MB)
    streams (and, under ``("hist256", "by_stream")``, of the walk151 block's
    streams and the adversarial streams of :func:`hist_streams`), the
    tokenizer on the header stream both ways (the encode from the block's
    header lengths, as the compress path calls it, and from the bare stream
    beside it). Each kernel's device time over inputs rotated
    past the L2 (for the tokenizer its launches alone: the wrapper reads the
    fault and the size back), its bound, its plain version's (on the card
    for the histogram, a bincount; Python on the host for the tokenizer),
    ``torch.bincount`` of the same bytes for the histogram (printed only: the
    port never calls it), device operations (``torch.profiler``; the decode
    at 1,000 records too: the same count) and each tokenizer kernel's
    device microseconds a call, and host microseconds of one wrapper call
    (a process of its own counts the operations)."""
    raw = tokens_block(data)
    all_ops = tokens_device_ops(seed)
    rows = {}
    for label, i in (("qual", 1), ("seq", 0)):
        view = raw.device_view(i)
        n = view.numel()
        sets = retile(view, max(2, -(-150_000_000 // n)))
        kms = gpu_ms(ck.hist256, sets, 50)
        pms = gpu_ms(rans.hist256_plain, sets[:2], 5)
        lms = gpu_ms(lambda t: torch.bincount(t, minlength=256), sets, 20)
        err = max_err(ck.hist256(view), rans.hist256_plain(view))
        ops = all_ops[f"hist256_{label}"]
        hus = host_us(ck.hist256, (view,))
        rows[("hist256", label)] = (*report(ck.HIST256, f"stream={label} bytes={n} "
                                            f"misalign={view.data_ptr() % 16}", kms, pms, lms,
                                            n + 256 * 8, 0, err),
                                    {"err": err, "bytes": n, "device_ops_per_call": len(ops),
                                     "device_ops": ops, "host_us_per_call": hus})
        print(f"phase=tokens kernel={ck.HIST256} stream={label} device_ops_per_call={len(ops)} "
              f"ops={json.dumps(ops)} host_us_per_call={hus:.1f} torch_bincount_ms={lms:.6f} "
              f"(printed only)")
        check(len(ops) == 1, f"hist256: one device operation a call, got {ops}")
        del sets
    by_stream = {}
    for label, view in hist_streams([k for k in HIST_STREAMS if not k.startswith("ordered")],
                                    seed - 19).items():
        n = view.numel()
        sets = retile(view, max(2, -(-150_000_000 // n)))
        kms = gpu_ms(ck.hist256, sets, 50)
        lms = gpu_ms(lambda t: torch.bincount(t, minlength=256), sets, 10)
        err = max_err(ck.hist256(view), torch.bincount(view, minlength=256))
        check(err == 0, f"hist256 on {label}: kernel == plain")
        bms = bound(n + 256 * 8, 0)[0]
        by_stream[label] = {"ms": kms, "bound_ms": bms, "library_ms": lms, "bytes": n,
                            "host_us_per_call": host_us(ck.hist256, (view,)), "err": err}
        print(f"phase=tokens kernel={ck.HIST256} stream={label} bytes={n} kernel_ms={kms:.6f} "
              f"bound_us={bms * 1e3:.3f} roofline_share={bms / kms:.4f} "
              f"torch_bincount_ms={lms:.6f} (printed only) max_abs_err={err}")
        del sets, view
    rows[("hist256", "qual")][5]["by_stream"] = by_stream
    count = raw.num_records
    view, lens = raw.device_view(2), raw.header_lengths
    n = view.numel()
    t0 = time.perf_counter()
    tok_h = tokenize.encode_plain(raw.headers, count)
    enc_plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    check(tokenize.decode_plain(tok_h, count) == raw.headers, "plain tokenizer round trip")
    dec_plain_ms = (time.perf_counter() - t0) * 1e3
    want = torch.from_numpy(np.frombuffer(tok_h, np.uint8).copy())
    got = ck.tok_encode(view, count, lens)
    bare = ck.tok_encode(view, count)
    check(got.numel() == bare.numel() == len(tok_h),
          "the tokenized header stream's length == plain (both routes)")
    enc_err = max(max_err(got.cpu(), want), max_err(bare.cpu(), want))
    tok = on_card(tok_h)
    back = ck.tok_decode(tok, count)
    check(back.numel() == len(raw.headers), "the decoded header stream's length == plain")
    dec_err = max_err(back.cpu(), torch.from_numpy(np.frombuffer(raw.headers, np.uint8).copy()))
    check(enc_err == 0 and dec_err == 0, "the tokenizer on the block's header stream == plain")
    m = len(tok_h)
    split = all_ops["split_us"]
    for key, name in (("tok_encode", "lengths"), ("tok_encode_bare", "bare"),
                      ("tok_decode", "decode")):
        print(f"phase=tokens split route={name} records={count} "
              f"split_us={json.dumps(split[key], sort_keys=True)}")
    ops_big, ops_small = all_ops["tok_decode"], all_ops["tok_decode_small"]
    print(f"phase=tokens kernel={ck.TOK_DECODE} device_ops_per_call={len(ops_big)} "
          f"records={count} device_ops_per_call_at_1000={len(ops_small)}")
    check(len(ops_big) == len(ops_small) == 4,
          f"tok_decode: 4 device operations a call at any count ({ops_big} / {ops_small})")
    check(len(all_ops["tok_encode"]) == 2,
          f"tok_encode from the header lengths: 1 kernel and the read-back ({all_ops['tok_encode']})")

    def dec_launches(t):
        call = ck.tok_decode_launch(t, count)
        return ck.tok_decode_write(call, len(raw.headers))

    k = max(2, -(-150_000_000 // n))
    enc_sets = retile(view, k)
    kms = gpu_ms(lambda t: ck.tok_encode_launch(t, count, lens), enc_sets, 10)
    bare_ms = gpu_ms(lambda t: ck.tok_encode_launch(t, count), enc_sets, 10)
    ops = all_ops["tok_encode"]
    hus = host_us(ck.tok_encode, (view, count, lens))
    bare_hus = host_us(ck.tok_encode, (view, count))
    rows[("tok_encode", "headers")] = (
        *report(ck.TOK_ENCODE, f"headers={count} bytes={n} out={m} route=lengths", kms,
                enc_plain_ms, None, n + 8 * count + m, 0, enc_err),
        {"err": enc_err, "bytes": n, "records": count, "out_bytes": m,
         "device_ops_per_call": len(ops), "device_ops": ops, "host_us_per_call": hus,
         "split_us": split["tok_encode"],
         "bare_stream": {"ms": bare_ms, "bound_ms": bound(n + m, 0)[0],
                         "device_ops_per_call": len(all_ops["tok_encode_bare"]),
                         "host_us_per_call": bare_hus, "split_us": split["tok_encode_bare"]},
         "plain_ms_clock": "host (the plain version is Python on the CPU)"})
    print(f"phase=tokens kernel={ck.TOK_ENCODE} route=lengths device_ops_per_call={len(ops)} "
          f"ops={json.dumps(ops)} host_us_per_call={hus:.1f}")
    print(f"phase=tokens kernel={ck.TOK_ENCODE} route=bare kernel_ms={bare_ms:.6f} "
          f"device_ops_per_call={len(all_ops['tok_encode_bare'])} host_us_per_call={bare_hus:.1f}")
    del enc_sets
    dec_sets = retile(tok, max(2, -(-150_000_000 // (m + n))))
    kms = gpu_ms(dec_launches, dec_sets, 10)
    ops = all_ops["tok_decode"]
    hus = host_us(ck.tok_decode, (tok, count))
    rows[("tok_decode", "headers")] = (
        *report(ck.TOK_DECODE, f"headers={count} bytes={m} out={n}", kms, dec_plain_ms, None,
                m + n, 0, dec_err),
        {"err": dec_err, "bytes": m, "records": count, "out_bytes": n,
         "device_ops_per_call": len(ops), "device_ops_per_call_at_1000": len(ops_small),
         "device_ops": ops, "host_us_per_call": hus, "split_us": split["tok_decode"],
         "plain_ms_clock": "host (the plain version is Python on the CPU)"})
    print(f"phase=tokens kernel={ck.TOK_DECODE} device_ops_per_call={len(ops)} "
          f"ops={json.dumps(ops)} host_us_per_call={hus:.1f}")
    del dec_sets
    return rows


def stream_counts(comp: bytes, ft, read_len: int) -> dict:
    """Per container: the sequence and quality streams the v3 pick estimates
    (>= RANS_MIN_BYTES; the sequence stream of fixed ``read_len`` reads),
    the blocks whose header stream the tokenizer encodes (TAG_TOK, or zstd
    not cut by the header gate of pipeline/native.py) and the TAG_TOK
    streams."""
    from fastqpacker_tpu_torch.entropy.zstd import frame_content_size

    c = ft.container
    r = io.BytesIO(comp)
    fh = c.read_file_header(r)
    if fh.flags & c.FLAG_SEQ_DICT:
        c.read_seq_dict_section(r)
    out = {"estimates": 0, "qual_estimates": 0, "tok_encodes": 0, "tok_streams": 0}
    while (hdr := c.read_block_header(r, fh.version)) is not None:
        sizes = hdr.stream_sizes(c.VERSION_2)
        payload = r.read(sum(sizes))
        seq_raw = hdr.num_records * ((read_len + 3) // 4)
        out["estimates"] += (seq_raw >= RANS_MIN_BYTES) + (hdr.original_qual_size >= RANS_MIN_BYTES)
        out["qual_estimates"] += hdr.original_qual_size >= RANS_MIN_BYTES
        head = payload[sizes[0] + sizes[1] : sizes[0] + sizes[1] + sizes[2]]
        if head[0] == c.TAG_TOK:
            out["tok_encodes"] += 1
            out["tok_streams"] += 1
        else:
            gate = max(4096, (sizes[0] + sizes[1]) >> 7)
            raw = frame_content_size(head[1:])
            out["tok_encodes"] += not (len(head) - 1 <= gate and raw > TOK_GATE_BYTES)
    return out


def tokens_round_trip(ft, ck, data: bytes, cpu_ref: CpuReference) -> dict:
    """v3 round trip of the ordered-name corpus on the card (one worker,
    counters reset before each direction): the data back, the container
    equal to the CPU's, TAG_TOK on every block's header stream, and the
    launches following the tags (one fq_tok_encode a block the header gate
    lets through, one fq_tok_decode a TAG_TOK stream, one fq_hist256 an
    estimate and none for a rANS table)."""
    opts = ft.Options(version=ft.container.VERSION_3_NATIVE, workers=1)
    label = f"ordered151_v3_{TOKEN_BLOCKS}x{BLOCK_RECORDS}"
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    comp = ft.compress_bytes(data, opts, device=DEV)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    c_counts = ck.launches.as_dict()
    ck.reset_launches()
    t0 = time.perf_counter()
    out = ft.decompress_bytes(comp, device=DEV)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    d_counts = ck.launches.as_dict()
    routes = ck.qctx_routes.as_dict()
    check(out == data, f"{label}: decompressed output equals the input")
    blocks, tags = stream_tags(comp, ft)
    want = stream_counts(comp, ft, READ_LEN)
    check(blocks == TOKEN_BLOCKS and tags["headers"].get("tok", 0) == blocks,
          f"{label}: TAG_TOK on every block's header stream ({tags['headers']})")
    check(c_counts[ck.TOK_ENCODE] == want["tok_encodes"] == blocks,
          f"{label}: one tokenizer encode a block ({c_counts[ck.TOK_ENCODE]})")
    check(d_counts[ck.TOK_DECODE] == want["tok_streams"] and c_counts[ck.TOK_DECODE] == 0
          and d_counts[ck.TOK_ENCODE] == 0, f"{label}: one tokenizer decode a TAG_TOK stream")
    check(c_counts[ck.HIST256] == want["estimates"] and d_counts[ck.HIST256] == 0,
          f"{label}: one histogram an estimate, none for a rANS table ({c_counts[ck.HIST256]})")
    cpu, cpu_s = cpu_ref.result()
    check(comp == cpu, f"{label}: the card's container equals the CPU's")
    mb = len(data) / 1e6
    print(f"phase=tokens run={label} input_bytes={len(data)} container_bytes={len(comp)} "
          f"blocks={blocks} tags={json.dumps(tags, sort_keys=True)} compress_s={t_c:.4f} "
          f"compress_MBps={mb / t_c:.2f} decompress_s={t_d:.4f} decompress_MBps={mb / t_d:.2f} "
          f"compress_launches={json.dumps(c_counts, sort_keys=True)} "
          f"decompress_launches={json.dumps(d_counts, sort_keys=True)} "
          f"qctx_decode_routes={json.dumps(routes, sort_keys=True)} round_trip=true "
          f"byte_identical_to_cpu=true cpu_reference_s={cpu_s:.1f}")
    return {"compress": c_counts, "decompress": d_counts}


def phase_tokens(ft, ck, args, cpu_ref: CpuReference) -> dict:
    """fq_hist256, fq_tok_encode and fq_tok_decode: their edges and faults
    against the plain versions, the golden v3 container decoded on the card,
    their times at a v3 block's shapes, and the ordered-name v3 round trip."""
    from fastqpacker_tpu_torch.ops import rans, tokenize
    from fastqpacker_tpu_torch.utils.synth import ordered_illumina_fastq

    ti = load_tests_module("torch_tokens_inputs")
    edges = tokens_edges(ck, rans, tokenize, ti)
    golden_ctx(ft, ck)
    data = ordered_illumina_fastq(TOKEN_BLOCKS * BLOCK_RECORDS, seed=args.seed + 19)
    times = tokens_timed(ft, ck, rans, tokenize, data, args.seed + 19)
    run = tokens_round_trip(ft, ck, data, cpu_ref)
    return {"edges": edges, "times": times, "run": run}


# ---------------------------------------------------------------------------
# phase ctxcoder: the runtime's context coders (csrc/ctxcoder.cu)
# ---------------------------------------------------------------------------

CTX_BLOCKS = 4  # the markov151 v3 run: blocks of BLOCK_RECORDS records
CTX_PREFIX = 10_000  # records of the full-width streams that the plain versions code
CTX_ROUTES = ("qctx_encode", "qctx_decode", "sctx_encode", "sctx_decode")
# each wrapper's device operations a call (scripts/ctxcoder_ab.py --ops-only):
# the encodes one kernel, the qctx decode one on its dense route and two (its
# slot table, its walk) on the L2 route, the sctx decode one
CTX_CODER_OPS = {"qctx_encode": 1, "qctx_decode": 1, "qctx_decode_l2": 2, "sctx_encode": 1,
                 "sctx_decode": 1}


def tensors_err(got, want) -> int:
    """Max abs difference of two tuples of tensors, or -1 where a shape
    differs."""
    err = 0
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.shape != w.shape:
            return -1
        err = max(err, max_err(g, w))
    return err


def ctxcoder_edges(ck, qualctx, seqctx, ctxprep, ci) -> dict:
    """Each case of ``tests/torch_ctxcoder_inputs.py`` through the four
    kernels against their plain versions, byte for byte: the qctx cases at
    models 0 and 1 (both decode check modes), the sctx cases at orders 2, 4
    and 6; each decode fault's string on the card equal to the CPU's (with
    and without the whole-file checks), and an encode table with no
    frequency for a present symbol. Returns the cases held per route."""
    held = dict.fromkeys((*CTX_ROUTES, "decode_faults", "tile_faults", "encode_faults"), 0)
    ck.reset_launches()
    for stream, name, syms_in, lengths, arg in ci.coder_cases():
        cpu = ci.coder_inputs(stream, syms_in, lengths, "cpu", arg)
        want = ci.empty_encode()
        if len(cpu["syms"]):
            want = ci.coder_encode(stream, cpu)
            got = ci.coder_encode(stream, ci.coder_inputs(stream, syms_in, lengths, DEV, arg))
            check(tensors_err(got, want) == 0, f"{stream} encode {name} at {arg}: kernel == plain")
            held[f"{stream}_encode"] += 1
        for checks in ((False, True) if stream == "qctx" else (False,)):
            ref = ci.coder_decode(stream, ci.coder_decode_args(stream, cpu, want, "cpu", checks))
            got = ci.coder_decode(stream, ci.coder_decode_args(stream, cpu, want, DEV, checks))
            check(tensors_err(got, ref) == 0 and not ref[1][:, 0].any(),
                  f"{stream} decode {name} at {arg} checks={checks}: kernel == plain")
            held[f"{stream}_decode"] += 1
    for stream, mod, (payloads, lengths) in (("qctx", qualctx, ci.qctx_fault_payloads()),
                                             ("sctx", seqctx, ci.sctx_fault_payloads())):
        for name, payload in payloads.items():
            for kw in (({}, {"runtime_checks": True}) if stream == "qctx" else ({},)):
                got = outcome(lambda p: mod.decode(p, lengths, device=DEV, **kw), payload)
                want = outcome(lambda p: mod.decode(p, lengths, device="cpu", **kw), payload)
                said = [o[1] if o[0] == "error" else "decoded" for o in (got, want)]
                check(got == want, f"{stream} fault {name} {kw}: {said[0]!r} on the card, "
                                   f"{said[1]!r} on the CPU")
                held["decode_faults"] += 1
    routes = ck.qctx_routes.as_dict()
    check(routes["shared"] > 0 and routes["l2"] > 0, f"both qctx decode routes held: {routes}")
    for stream, (payload, lengths, k, j) in ci.tile_fault_payloads().items():
        mod = qualctx if stream == "qctx" else seqctx
        got = outcome(lambda p: mod.decode(p, lengths, device=DEV), payload)
        want = outcome(lambda p: mod.decode(p, lengths, device="cpu"), payload)
        info = ci.coder_decode(stream, ci.payload_decode_args(stream, payload, lengths, DEV))[1]
        check(got == want and info[k].tolist() == [2, j],
              f"{stream}: chunk {k} runs out of words at symbol {j}, a tile's last: "
              f"{info.tolist()}, {got} on the card, {want} on the CPU")
        held["tile_faults"] += 1
    for stream, name, err in (("qctx", "varlen", qualctx.QctxError),
                              ("sctx", "markov-40x151", seqctx.SctxError)):
        case = next(c for c in ci.coder_cases() if c[0] == stream and c[1] == name)
        outs = []
        for dev in (DEV, "cpu"):
            inp = ci.coder_inputs(stream, case[2], case[3], dev)
            freq = inp["freq"].copy()
            # the context of every record's first symbol (qctx: the sentinels)
            q = ci.qualctx
            freq[(q.NUM_QBINS - 1) * (q.NUM_Q2B if inp["arg"] else 1)
                 + (q.NUM_Q2B - 1) * inp["arg"] if stream == "qctx" else 0] = 0
            outs.append(outcome(lambda: ci.ctxcoder.launch_encode(
                ck.qctx_encode if stream == "qctx" else ck.sctx_encode,
                ctxprep.Symbols(inp["syms"]), case[3], freq, inp["arg"],
                err(f"invalid {stream} frequency table")).result()))
        check(outs[0] == outs[1] == ("error", f"invalid {stream} frequency table"),
              f"{stream} encode with no frequency for a present symbol: {outs}")
        held["encode_faults"] += 1
    print(f"phase=ctxcoder edges={json.dumps(held, sort_keys=True)} "
          f"qctx_decode_routes={json.dumps(routes, sort_keys=True)}")
    return held


def chain_steps(plan: torch.Tensor, ci, decode: bool) -> int:
    """The longest chain of a call: a chunk's symbols (decode), or the
    symbols of its fullest (chunk, state) chain (encode)."""
    sb = plan.numpy()[ci.ctxcoder.PLAN_SB : ci.ctxcoder.PLAN_SB + 5]
    n = np.diff(sb)
    return int(n.max()) if decode else int(((n + 3) // 4).max())


def coder_bytes(inp: dict, words: int, decode: bool, out_bytes: int = 0) -> int:
    """The bytes a context coder's function must move (each input read once,
    each output written once). Encode: the symbols, the record starts, the
    table's f and cum (4 B an entry; the reciprocals are the design's), the
    emitted words (u16), the 16 states and counts. Decode: the words, the
    record starts, the decode table, the output and the 4 chunks' info."""
    starts = inp["starts"].numel() * 8
    if decode:
        return 2 * words + starts + inp["dtab"].numel() * inp["dtab"].element_size() \
            + out_bytes + 4 * 2 * 8
    return inp["syms"].numel() + starts + 4 * inp["tab"].numel() + 2 * words + 16 * (4 + 8)


def ctx_probe() -> dict:
    """``scripts/ctx_step_probe.py``'s dependent steps on this card, now:
    the shared-load chain (the decodes' floor), the encode's ALU step, the
    qctx dense and sctx steps' critical paths."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / "ctx_step_probe.py"
    spec = importlib.util.spec_from_file_location("ctx_step_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.measure((0, 3, 6, 7))
    print(f"phase=ctxcoder probe={json.dumps(res, sort_keys=True)}")
    return res


def chain_bound_ms(probe: dict | None, steps: int, decode: bool) -> float | None:
    """The longest chain's steps x the probe's dependent step (a shared load
    for a decode, the encode's ALU step), in ms at the clock of this run."""
    if probe is None:
        return None
    return steps * probe["shared" if decode else "encode_step"]["ns_per_step"] / 1e6


def qctx_route(ck, call) -> str:
    """The qctx decode's route in one call (a checkout before the dense
    route has only the L2 one)."""
    if not hasattr(ck, "qctx_routes"):
        call()
        return "l2"
    ck.qctx_routes.reset()
    call()
    return next(r for r, n in ck.qctx_routes.as_dict().items() if n)


def ctxcoder_timed(ck, ci, label: str, streams: dict, ops: dict, iters: int = 3,
                   probe: dict | None = None) -> dict:
    """The four kernels at one block's streams (``streams``: stream ->
    (host deltas or packed rows, lengths)): each held against its plain
    version on the first CTX_PREFIX records and timed there beside it (the
    plain versions are Python walks: host ms; the kernel: device ms over
    ``iters`` launches; the bound and the host µs of one wrapper call at the
    same inputs), then timed at the whole block (``full_width``: device ms,
    its bound, its µs a step of its longest chain, ``chain_bound_ms`` from
    ``probe``, the qctx decode's route)."""
    rows = {}
    for stream, (syms_in, lengths) in streams.items():
        lengths = np.asarray(lengths, np.int64)
        per = ((lengths + 3) >> 2) if stream == "sctx" else lengths
        cut = int(per[:CTX_PREFIX].sum())
        full = ci.coder_inputs(stream, syms_in, lengths, DEV)
        arg = full["arg"]
        pre_card = ci.coder_inputs(stream, syms_in[:cut], lengths[:CTX_PREFIX], DEV, arg)
        pre_cpu = ci.coder_inputs(stream, syms_in[:cut], lengths[:CTX_PREFIX], "cpu", arg)
        t0 = time.perf_counter()
        want = ci.coder_encode(stream, pre_cpu)
        enc_plain_ms = (time.perf_counter() - t0) * 1e3
        got = ci.coder_encode(stream, pre_card)
        enc_err = tensors_err(got, want)
        check(enc_err == 0, f"{label} {stream} encode on {CTX_PREFIX} records: kernel == plain")
        dargs = ci.coder_decode_args(stream, pre_cpu, want, "cpu")
        t0 = time.perf_counter()
        dref = ci.coder_decode(stream, dargs)
        dec_plain_ms = (time.perf_counter() - t0) * 1e3
        dargs_card = ci.coder_decode_args(stream, pre_cpu, want, DEV)
        dec_err = tensors_err(ci.coder_decode(stream, dargs_card), dref)
        check(dec_err == 0 and not dref[1][:, 0].any(),
              f"{label} {stream} decode on {CTX_PREFIX} records: kernel == plain")
        pre_words = dargs_card[0].numel()
        pre_enc_ms = gpu_ms(lambda: ci.coder_encode(stream, pre_card), [()], iters)
        pre_dec_ms = gpu_ms(lambda: ci.coder_decode(stream, dargs_card), [()], iters)

        enc = ci.coder_encode(stream, full)
        n = full["syms"].numel()
        dec_args = ci.coder_decode_args(stream, full, enc, DEV)
        out, info = ci.coder_decode(stream, dec_args)
        want_out = np.frombuffer(syms_in, np.uint8)
        check(not info[:, 0].any().item() and np.array_equal(out.cpu().numpy(), want_out),
              f"{label} {stream}: the kernels' round trip at full width")
        words = dec_args[0].numel()
        nrec = len(lengths)
        # the round trip above ran both at these shapes
        enc_ms = gpu_ms(lambda: ci.coder_encode(stream, full), [()], iters, warm=False)
        dec_ms = gpu_ms(lambda: ci.coder_decode(stream, dec_args), [()], iters, warm=False)
        steps_e = chain_steps(full["plan"], ci, False)
        steps_d = chain_steps(dec_args[2], ci, True)
        name_e = ck.QCTX_ENCODE if stream == "qctx" else ck.SCTX_ENCODE
        name_d = ck.QCTX_DECODE if stream == "qctx" else ck.SCTX_DECODE
        what = "model" if stream == "qctx" else "order"
        pre_shape = (f"{label} {what}={arg} symbols={pre_card['syms'].numel()} "
                     f"words={pre_words} records={CTX_PREFIX}")
        shape = f"{label} {what}={arg} symbols={n} words={words} records={nrec}"
        for route, name, ms, pms, pre_ms, steps, pre_bytes, nbytes, err, call in (
                (f"{stream}_encode", name_e, enc_ms, enc_plain_ms, pre_enc_ms, steps_e,
                 coder_bytes(pre_card, pre_words, False), coder_bytes(full, words, False),
                 enc_err, (lambda: ci.coder_encode(stream, pre_card))),
                (f"{stream}_decode", name_d, dec_ms, dec_plain_ms, pre_dec_ms, steps_d,
                 coder_bytes(pre_card, pre_words, True, dref[0].numel()),
                 coder_bytes(full, words, True, out.numel()), dec_err,
                 (lambda: ci.coder_decode(stream, dargs_card)))):
            hus = host_us(call, (), 3)
            kms, pms, bms, bby, lms = report(name, pre_shape, pre_ms, pms, None, pre_bytes, 0,
                                             err)
            full_bound, full_by = bound(nbytes, 0)
            chain_ms = chain_bound_ms(probe, steps, route.endswith("decode"))
            full_row = {"ms": ms, "bound_ms": full_bound, "bound_by": full_by, "bytes": nbytes,
                        "symbols": n, "words": words, "records": nrec, "steps": steps,
                        "us_per_step": ms * 1e3 / steps, "chain_bound_ms": chain_ms}
            if route == "qctx_decode":
                full_row["route"] = qctx_route(ck, lambda: ci.coder_decode(stream, dec_args))
            rows[route] = (kms, pms, bms, bby, lms, {
                "err": err, "shape": pre_shape, what: arg, "bytes": pre_bytes,
                "chain_bound_ms": chain_ms,
                "plain_records": CTX_PREFIX, "plain_ms_clock": "host (the plain version is "
                "Python on the CPU)", "host_us_per_call": hus, "full_width": full_row,
                "device_ops_per_call": len(ops[route]), "device_ops": ops[route]})
            print(f"phase=ctxcoder kernel={name} {shape} steps={steps} kernel_ms={ms:.6f} "
                  f"bound_us={full_bound * 1e3:.3f} bound_by={full_by} bytes={nbytes} "
                  f"us_per_step={ms * 1e3 / steps:.5f} chain_bound_ms={chain_ms} "
                  f"route={full_row.get('route', 'none')} ms_at_{CTX_PREFIX}_records={pre_ms:.4f} "
                  f"plain_ms_at_{CTX_PREFIX}_records={pms:.1f} host_us_per_call={hus:.1f} "
                  f"device_ops_per_call={len(ops[route])} ops={json.dumps(ops[route])}")
        del full, pre_card, pre_cpu, enc, dec_args
    return rows


def binned_timed(ck, ci, seed: int, iters: int = 3, probe: dict | None = None) -> dict:
    """The qctx kernels on a binned 15.1 M-symbol quality stream (RTA3
    levels, sticky runs: far fewer words than symbols), round trip checked."""
    lengths = np.full(BLOCK_RECORDS, READ_LEN, np.int64)
    raw = ci.binned(np.random.default_rng(seed), lengths)
    delta = np.frombuffer(ci.qualctx.deintegrate(raw, lengths), np.uint8)
    inp = ci.coder_inputs("qctx", delta, lengths, DEV)
    enc = ci.coder_encode("qctx", inp)
    dargs = ci.coder_decode_args("qctx", inp, enc, DEV)
    out, info = ci.coder_decode("qctx", dargs)
    check(not info[:, 0].any().item() and np.array_equal(out.cpu().numpy(), delta),
          "binned quality stream: the qctx kernels' round trip")
    enc_ms = gpu_ms(lambda: ci.coder_encode("qctx", inp), [()], iters, warm=False)
    dec_ms = gpu_ms(lambda: ci.coder_decode("qctx", dargs), [()], iters, warm=False)
    n, words = delta.size, dargs[0].numel()
    steps_e = chain_steps(inp["plan"], ci, False)
    steps_d = chain_steps(dargs[2], ci, True)
    row = {"symbols": n, "words": words, "model": inp["arg"],
           "encode": {"ms": enc_ms, "steps": steps_e, "us_per_step": enc_ms * 1e3 / steps_e,
                      "bound_ms": bound(coder_bytes(inp, words, False), 0)[0],
                      "chain_bound_ms": chain_bound_ms(probe, steps_e, False)},
           "decode": {"ms": dec_ms, "steps": steps_d, "us_per_step": dec_ms * 1e3 / steps_d,
                      "bound_ms": bound(coder_bytes(inp, words, True, n), 0)[0],
                      "chain_bound_ms": chain_bound_ms(probe, steps_d, True),
                      "route": qctx_route(ck, lambda: ci.coder_decode("qctx", dargs))}}
    print(f"phase=ctxcoder stream=binned_qual {json.dumps(row, sort_keys=True)}")
    return row


def ctxcoder_device_ops() -> subprocess.Popen:
    """Start counting each wrapper's device operations a call in a process
    of its own (``scripts/ctxcoder_ab.py --ops-only``); read by
    :func:`ctxcoder_ops_result`."""
    root = Path(__file__).resolve().parent
    return subprocess.Popen([sys.executable, str(root / "scripts" / "ctxcoder_ab.py"), "--root",
                             str(root), "--ops-only", "--records", "20000"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ctxcoder_ops_result(proc: subprocess.Popen) -> dict:
    """Route -> device operations of one wrapper call, from
    :func:`ctxcoder_device_ops`'s process."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"ctxcoder_ab.py --ops-only: {err[-2000:]}")
    ops = {c["route"]: c["device_ops"] for c in json.loads(out.strip().splitlines()[-1])["cases"]}
    for route, want in CTX_CODER_OPS.items():
        check(len(ops[route]) == want, f"{route}: {want} device operations a call, got {ops[route]}")
    return ops


def golden_ctx(ft, ck) -> dict:
    """``tests/testdata/golden/golden_ctx_v3.fqz`` decoded on the card to its
    FASTQ's SHA-256, its TAG_TOK, TAG_QCTX and TAG_SCTX streams by the
    kernels (one decode each)."""
    golden = Path(__file__).resolve().parent.joinpath(GOLDEN_TOK).read_bytes()
    ck.reset_launches()
    t0 = time.perf_counter()
    back = ft.decompress_bytes(golden, device=DEV)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ck.launches.as_dict()
    check(hashlib.sha256(back).hexdigest() == GOLDEN_TOK_SHA256,
          f"{GOLDEN_TOK}: decoded on the card to its FASTQ")
    check(counts[ck.TOK_DECODE] == counts[ck.QCTX_DECODE] == counts[ck.SCTX_DECODE] == 1,
          f"{GOLDEN_TOK}: its TAG_TOK, TAG_QCTX and TAG_SCTX streams by the kernels ({counts})")
    print(f"phase=ctxcoder golden={GOLDEN_TOK} output_bytes={len(back)} decode_s={secs:.4f} "
          f"tok_decode_launches={counts[ck.TOK_DECODE]} qctx_decode_launches="
          f"{counts[ck.QCTX_DECODE]} sctx_decode_launches={counts[ck.SCTX_DECODE]} "
          f"sha256_equal=true")
    return counts


def check_ctx_launches(ck, label: str, tags: dict, c: dict, d: dict) -> None:
    """The context coders' launches follow the tags: at least one encode a
    TAG_QCTX / TAG_SCTX stream (a candidate can lose on its real size), one
    decode a stream, none in the wrong direction, and one compaction an
    encode of any coder."""
    n_q, n_s = tags["qual"].get("qctx", 0), tags["seq"].get("sctx", 0)
    check(c[ck.QCTX_ENCODE] >= n_q and c[ck.SCTX_ENCODE] >= n_s,
          f"{label}: an encode launch per TAG_QCTX / TAG_SCTX stream")
    check(d[ck.QCTX_DECODE] == n_q and d[ck.SCTX_DECODE] == n_s,
          f"{label}: one decode launch per TAG_QCTX / TAG_SCTX stream")
    check(c[ck.QCTX_DECODE] == c[ck.SCTX_DECODE] == d[ck.QCTX_ENCODE] == d[ck.SCTX_ENCODE] == 0,
          f"{label}: no context coder launch in the wrong direction")
    check(c[ck.RANS_COMPACT] == c[ck.RANS_ENCODE] + c[ck.WCTX_ENCODE] + c[ck.QCTX_ENCODE]
          + c[ck.SCTX_ENCODE], f"{label}: one compaction per encode launch")


def first_block(comp: bytes, ft) -> bytes:
    """The bytes of a container's first block (its header and payload)."""
    c = ft.container
    r = io.BytesIO(comp)
    fh = c.read_file_header(r)
    start = r.tell()
    hdr = c.read_block_header(r, fh.version)
    r.seek(sum(hdr.stream_sizes(c.VERSION_2)), io.SEEK_CUR)
    return comp[start : r.tell()]


def ctxcoder_round_trip(ft, ck, data: bytes, cpu_ref) -> dict:
    """v3 round trip of the context-model corpus at the default block size
    on the card (the default workers, a CUDA stream each; counters reset
    before each direction): the data back, TAG_SCTX and TAG_QCTX on every
    block, the launches following the tags, the first block equal to the
    CPU's container of the first BLOCK_RECORDS records (made by a subprocess
    started before the first phase), MB/s each way."""
    opts = ft.Options(version=ft.container.VERSION_3_NATIVE, block_size=BLOCK_RECORDS)
    label = f"markov151_v3_{CTX_BLOCKS}x{BLOCK_RECORDS}"
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    comp = ft.compress_bytes(data, opts, device=DEV)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    c_counts = ck.launches.as_dict()
    ck.reset_launches()
    t0 = time.perf_counter()
    out = ft.decompress_bytes(comp, device=DEV)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    d_counts = ck.launches.as_dict()
    routes = ck.qctx_routes.as_dict()
    check(out == data, f"{label}: decompressed output equals the input")
    blocks, tags = stream_tags(comp, ft)
    check(blocks == CTX_BLOCKS and tags["seq"].get("sctx", 0) == tags["qual"].get("qctx", 0)
          == blocks, f"{label}: TAG_SCTX and TAG_QCTX on every block ({tags})")
    check_ctx_launches(ck, label, tags, c_counts, d_counts)
    check(routes["shared"] == d_counts[ck.QCTX_DECODE] and not routes["l2"],
          f"{label}: every qctx decode on the dense route ({routes})")
    check(c_counts[ck.QCTX_PREPARE] >= blocks and c_counts[ck.SCTX_PREPARE] >= blocks,
          f"{label}: the qctx and sctx prepare passes of every block (and the sampled "
          f"estimates' prefixes) on the card")
    cpu, cpu_s = cpu_ref.result()
    check(first_block(comp, ft) == first_block(cpu, ft),
          f"{label}: the card's first block equals the CPU's")
    mb = len(data) / 1e6
    print(f"phase=ctxcoder run={label} input_bytes={len(data)} container_bytes={len(comp)} "
          f"blocks={blocks} tags={json.dumps(tags, sort_keys=True)} compress_s={t_c:.4f} "
          f"compress_MBps={mb / t_c:.2f} decompress_s={t_d:.4f} decompress_MBps={mb / t_d:.2f} "
          f"compress_launches={json.dumps(c_counts, sort_keys=True)} "
          f"decompress_launches={json.dumps(d_counts, sort_keys=True)} "
          f"qctx_decode_routes={json.dumps(routes, sort_keys=True)} round_trip=true "
          f"first_block_identical_to_cpu=true cpu_reference_s={cpu_s:.1f}")
    return {"compress": c_counts, "decompress": d_counts, "comp": comp, "label": label,
            "qctx_decode_routes": routes}


def phase_ctxcoder(ft, ck, args, cpu_ref) -> dict:
    """fq_qctx_encode, fq_qctx_decode, fq_sctx_encode and fq_sctx_decode: their
    edges and faults against the plain versions, the golden ctx container on
    the card, their times at the full-width streams of the context-model
    corpus (100,000 x 151) and at a binned quality stream, and the
    markov151 v3 round trip."""
    from fastqpacker_tpu_torch.ops import ctxprep, qualctx, seqctx

    t0 = time.perf_counter()

    def step(name: str) -> None:
        print(f"phase=time ctxcoder_step={name} elapsed_s={time.perf_counter() - t0:.1f}")

    ci = load_tests_module("torch_ctxcoder_inputs")
    ops_proc = ctxcoder_device_ops()  # its own process, while the edges run here
    try:
        edges = ctxcoder_edges(ck, qualctx, seqctx, ctxprep, ci)
        step("edges")
        golden = golden_ctx(ft, ck)
        data = context_corpus(CTX_BLOCKS * BLOCK_RECORDS, args.seed + 23)
        packed, delta, lengths = corpus_block(data)
        step("golden_and_corpus")
    except BaseException:
        ops_proc.kill()
        ops_proc.wait()
        raise
    ops = ctxcoder_ops_result(ops_proc)
    step("device_ops")
    probe = ctx_probe()
    step("probe")
    times = ctxcoder_timed(ck, ci, "markov151",
                           {"qctx": (delta, lengths), "sctx": (packed, lengths)}, ops,
                           probe=probe)
    step("timed")
    times["qctx_decode"][5]["binned_qual"] = binned_timed(ck, ci, args.seed + 24, probe=probe)
    times["qctx_decode"][5]["device_ops_per_call_l2_route"] = len(ops["qctx_decode_l2"])
    step("binned")
    run = ctxcoder_round_trip(ft, ck, data, cpu_ref)
    step("round_trip")
    run["data"] = data
    return {"edges": edges, "golden": golden, "times": times, "run": run}


# the per-stage breakdowns phase e2e prints: format -> --mb (v2: a few
# blocks; v3: two 100,000-record blocks; mesh: one)
STAGE_RUNS = {"v2": 32, "v3": 54, "mesh": 35}


def phase_stages(args) -> None:
    """Per-stage ms per block of the v2, v3 and mesh paths
    (``scripts/torch_stage_breakdown.py``, each in its own process)."""
    script = Path(__file__).resolve().parent / "scripts" / "torch_stage_breakdown.py"
    for fmt, mb in STAGE_RUNS.items():
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, str(script), "--format", fmt, "--mb", str(mb),
                            "--seed", str(args.seed)], capture_output=True, text=True)
        check(p.returncode == 0, f"stage breakdown {fmt}: {p.stderr[-2000:]}")
        line = json.loads(p.stdout.strip().splitlines()[-1])
        ms = {k: round(v, 4) for k, v in line["ms_per_block"].items()}
        print(f"phase=e2e stages={fmt} blocks={line['blocks']} block_records="
              f"{line['block_records']} wall_s={time.perf_counter() - t0:.2f} "
              f"ms_per_block={json.dumps(ms, sort_keys=True)}")


# ---------------------------------------------------------------------------
# the CLI surfaces: info, check, cat -r, --pair, fqscramble
# ---------------------------------------------------------------------------

# info's names of the v3 codec tags, where they differ from TAG_NAMES
INFO_TAG_NAMES = {"tok": "tok+zstd"}
SCRAMBLE_BYTES = 2 << 20  # the fqscramble input (host only)


def info_counts(text: str) -> tuple[int, int, dict]:
    """Blocks, records and, per tagged slot, its streams by codec, as
    ``fqpack info`` prints them."""
    blocks = int(re.search(r"^  blocks:\s+(\d+)$", text, re.M).group(1))
    records = int(re.search(r"^  records:\s+(\d+)$", text, re.M).group(1))
    tags = {}
    for slot, codecs in re.findall(r"^    stream (\w+)\s+[\d,]+ bytes(?:  \[(.*)\])?$", text, re.M):
        for part in filter(None, codecs.split(", ")):
            name, _, n = part.partition(" x")
            tags.setdefault(slot, {})[name] = int(n or 1)
    return blocks, records, tags


def record_ends(data: bytes) -> np.ndarray:
    """End offset (exclusive) of each record of ``data``."""
    return np.flatnonzero(np.frombuffer(data, np.uint8) == 10)[3::4] + 1


def record_slice(data: bytes, ends: np.ndarray, start: int, stop: int) -> bytes:
    return data[(int(ends[start - 1]) if start else 0) : int(ends[stop - 1])]


def block_streams(tags_by_block: list, covering: range, codec: str) -> int:
    """Streams coded ``codec`` (seq and qual slots) in the blocks ``covering``."""
    return sum((s == codec) + (q == codec) for s, q in (tags_by_block[i] for i in covering))


def tags_by_block(comp: bytes, ft) -> list:
    """(seq codec, qual codec) per block of a v3 container."""
    c = ft.container
    r = io.BytesIO(comp)
    c.read_file_header(r)
    rows = []
    while (hdr := c.read_block_header(r, c.VERSION_3_NATIVE)) is not None:
        sizes = hdr.stream_sizes(c.VERSION_2)
        payload = r.read(sum(sizes))
        rows.append((TAG_NAMES[payload[0]], TAG_NAMES[payload[sizes[0]]]))
    return rows


def split_mates(data: bytes, ends: np.ndarray) -> tuple[bytes, bytes, bytes]:
    """R1 (even records) and R2 (odd records) of ``data``, and the text
    that interleaving them gives back (``data`` less a last odd record)."""
    n = len(ends) // 2 * 2
    mv = memoryview(data)
    starts = np.concatenate(([0], ends[:-1]))
    r1 = b"".join(mv[a:b] for a, b in zip(starts[0:n:2].tolist(), ends[0:n:2].tolist()))
    r2 = b"".join(mv[a:b] for a, b in zip(starts[1:n:2].tolist(), ends[1:n:2].tolist()))
    return r1, r2, data[: int(ends[n - 1])]


def surface_container(ft, ck, inspect, ranges, label, kind, data, comp, workdir) -> dict:
    """``info``, ``check`` (and ``check`` of a copy with one flipped payload
    byte) and ``cat`` of two ranges of one container on the card, each with
    the counters reset just before and read just after."""
    path = workdir / f"{label}.fqz"
    path.write_bytes(comp)
    block = ft.container.read_file_header(io.BytesIO(comp)).block_size
    ends = record_ends(data)
    n = len(ends)
    out = io.StringIO()
    check(inspect.info(str(path), out=out) == 0, f"info {label}")
    blocks, records, info_tags = info_counts(out.getvalue())
    check(records == n, f"info {label}: records")
    if kind == "v2":
        check(blocks == count_blocks(comp, ft), f"info {label}: blocks")
        by_block = None
    else:
        n_blocks, tags = stream_tags(comp, ft)
        want = {slot: {INFO_TAG_NAMES.get(k, k): v for k, v in t.items()}
                for slot, t in tags.items()}
        check(blocks == n_blocks and info_tags == want, f"info {label}: blocks and tags")
        by_block = tags_by_block(comp, ft)
    runs = {}

    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    out = io.StringIO()
    rc = inspect.check(str(path), out=out, device=DEV)
    torch.cuda.synchronize()
    t_check = time.perf_counter() - t0
    counts = ck.launches.as_dict()
    check(rc == 0 and out.getvalue() == f"OK: decoded {len(data):,} bytes of FASTQ\n",
          f"check {label}: OK and the input's size")
    check(counts[ck.DECODE] == blocks, f"check {label}: one dense decode per block")
    if kind == "v3":
        check(counts[ck.RANS_DECODE] == block_streams(by_block, range(blocks), "rans") > 0
              and counts[ck.CRC32] > 0,
              f"check {label}: one rANS decode per TAG_RANS stream, CRC32 launched")
    if kind == "mesh":
        check(counts[ck.WCTX_DECODE] == 2 * blocks
              == block_streams(by_block, range(blocks), "wctx"),
              f"check {label}: two wctx decodes per block")
    if kind in ("v3", "ctx"):
        check(counts[ck.QCTX_DECODE] == block_streams(by_block, range(blocks), "qctx")
              and counts[ck.SCTX_DECODE] == block_streams(by_block, range(blocks), "sctx"),
              f"check {label}: one qctx / sctx decode per TAG_QCTX / TAG_SCTX stream")
    if kind == "ctx":
        check(counts[ck.QCTX_DECODE] == counts[ck.SCTX_DECODE] == blocks
              and counts[ck.CRC32] > 0,
              f"check {label}: a qctx and an sctx decode per block, CRC32 launched")
    runs[f"check_{kind}"] = counts

    bad = bytearray(comp)
    r = io.BytesIO(comp)
    ft.container.read_file_header(r)
    hdr = ft.container.read_block_header(r, comp[4])
    bad[r.tell() + sum(hdr.stream_sizes(min(comp[4], 2))) // 2] ^= 0xFF
    bad_path = workdir / f"{label}_flipped.fqz"
    bad_path.write_bytes(bytes(bad))
    out = io.StringIO()
    rc = inspect.check(str(bad_path), out=out, device=DEV)
    check(rc == 1 and out.getvalue().startswith("check FAILED: "),
          f"check {label}: a flipped payload byte fails")
    failed = out.getvalue().strip()
    bad_path.unlink()

    t0 = time.perf_counter()
    idx = ranges.index_path(str(path))
    t_index = time.perf_counter() - t0
    check(idx.total_records == n and len(idx.entries) == blocks, f"cat {label}: index")
    cat_rows = []
    for name, start, stop in (("straddle", block - 5, block + 5), ("last", n - 1, n)):
        covering = range(start // block, (stop - 1) // block + 1)
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        got = ranges.read_record_range(str(path), start, stop, index=idx, device=DEV)
        torch.cuda.synchronize()
        t_cat = time.perf_counter() - t0
        counts = ck.launches.as_dict()
        check(got == record_slice(data, ends, start, stop), f"cat {label} {name}: bytes")
        check(counts[ck.DECODE] == len(covering),
              f"cat {label} {name}: one dense decode per covering block")
        if kind == "v3":
            check(counts[ck.RANS_DECODE] == block_streams(by_block, covering, "rans"),
                  f"cat {label} {name}: rANS decodes of the covering blocks only")
        if kind == "mesh":
            check(counts[ck.WCTX_DECODE] == block_streams(by_block, covering, "wctx"),
                  f"cat {label} {name}: wctx decodes of the covering blocks only")
        if kind in ("v3", "ctx"):
            check(counts[ck.QCTX_DECODE] == block_streams(by_block, covering, "qctx")
                  and counts[ck.SCTX_DECODE] == block_streams(by_block, covering, "sctx"),
                  f"cat {label} {name}: qctx / sctx decodes of the covering blocks only")
        text = int(ends[min(covering.stop * block, n) - 1]) - (
            int(ends[covering.start * block - 1]) if covering.start else 0)
        runs[f"cat_{kind}_{name}"] = counts
        cat_rows.append(f"{name}=[{start},{stop}) blocks={len(covering)} s={t_cat:.4f} "
                        f"decoded_MBps={text / 1e6 / t_cat:.2f} output_bytes={len(got)}")
    path.unlink()
    print(f"phase=surfaces container={label} info_blocks={blocks} info_records={records} "
          f"info_tags={json.dumps(info_tags, sort_keys=True)} check_s={t_check:.4f} "
          f"check_MBps={len(data) / 1e6 / t_check:.2f} flipped={failed!r} "
          f"cat_index_host_s={t_index:.6f} cat {' '.join(cat_rows)} "
          f"launches={json.dumps(runs, sort_keys=True)}")
    return runs


def surface_pair(ft, ck, api, kind, data, comp) -> dict:
    """``compress_paired`` / ``decompress_paired`` on the card of R1 (even
    records) and R2 (odd records) of ``data``, whose interleaving is
    ``data`` again, held against ``compress_bytes`` with FLAG_PAIRED_END."""
    c = ft.container
    version = c.VERSION_3_NATIVE if kind == "v3" else c.CURRENT_VERSION
    ends = record_ends(data)
    r1, r2, inter = split_mates(data, ends)
    opts = ft.Options(version=version)
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    out = io.BytesIO()
    api.compress_paired(io.BytesIO(r1), io.BytesIO(r2), out, opts, device=DEV)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    c_counts = ck.launches.as_dict()
    paired = out.getvalue()
    want = ft.compress_bytes(inter, ft.Options(version=version, flags=c.FLAG_PAIRED_END),
                             device=DEV)
    check(paired == want, f"pair {kind}: the container of compress_bytes with FLAG_PAIRED_END")
    if inter == data:  # ... which is the round trip's container with the flag set
        check(paired == comp[:9] + bytes([comp[9] | c.FLAG_PAIRED_END]) + comp[10:],
              f"pair {kind}: the round trip's container with the flag")
    blocks = count_blocks(paired, ft)
    check(c_counts[ck.ENCODE] == blocks, f"pair {kind}: one dense encode per block")
    if kind == "v3":
        n_rans = block_streams(tags_by_block(paired, ft), range(blocks), "rans")
        check(c_counts[ck.RANS_ENCODE] == c_counts[ck.RANS_COMPACT] == n_rans > 0,
              f"pair {kind}: one rANS encode and compaction per TAG_RANS stream")

    ck.reset_launches()
    t0 = time.perf_counter()
    w1, w2 = io.BytesIO(), io.BytesIO()
    api.decompress_paired(io.BytesIO(paired), w1, w2, device=DEV)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    d_counts = ck.launches.as_dict()
    check(w1.getvalue() == r1 and w2.getvalue() == r2, f"pair {kind}: R1 and R2 back")
    check(d_counts[ck.DECODE] == blocks, f"pair {kind}: one dense decode per block")
    if kind == "v3":
        check(d_counts[ck.RANS_DECODE] == n_rans, f"pair {kind}: one rANS decode per stream")
    mb = len(inter) / 1e6
    print(f"phase=surfaces pair={kind} records={len(ends) // 2 * 2} input_bytes={len(inter)} "
          f"container_bytes={len(paired)} blocks={blocks} compress_s={t_c:.4f} "
          f"compress_MBps={mb / t_c:.2f} decompress_s={t_d:.4f} decompress_MBps={mb / t_d:.2f} "
          f"compress_launches={json.dumps(c_counts, sort_keys=True)} "
          f"decompress_launches={json.dumps(d_counts, sort_keys=True)} round_trip=true")
    return {f"pair_{kind}_compress": c_counts, f"pair_{kind}_decompress": d_counts}


def phase_surfaces(ft, ck, containers: dict) -> dict:
    """The CLI surfaces on the containers the earlier phases made, at their
    full size: ``info``, ``check`` and ``cat`` of each, ``--pair`` on the v2
    and v3 corpora, and ``fqscramble`` (host) on a few MiB."""
    from fastqpacker_tpu_torch.cli import fqscramble
    from fastqpacker_tpu_torch.cli import inspect
    from fastqpacker_tpu_torch.pipeline import api, ranges
    from fastqpacker_tpu_torch.utils import gopcg

    workdir = Path(__file__).resolve().parent / "fastqpacker_tpu_torch" / "_build" / "surfaces"
    workdir.mkdir(parents=True, exist_ok=True)
    runs = {}
    for kind, (label, data, comp) in containers.items():
        runs.update(surface_container(ft, ck, inspect, ranges, label, kind, data, comp,
                                      workdir))
    for kind in ("v2", "v3"):
        _, data, comp = containers[kind]
        runs.update(surface_pair(ft, ck, api, kind, data, comp))
    shutil.rmtree(workdir)

    data = containers["v2"][1]
    part = data[: data.rfind(b"\n@", 0, SCRAMBLE_BYTES) + 1]
    t0 = time.perf_counter()
    out = io.BytesIO()
    fqscramble.scramble_stream_pcg(io.BytesIO(part), out, seed=7)
    t_s = time.perf_counter() - t0
    check(out.getvalue() == gopcg.scramble_text(part, 7) and len(out.getvalue()) == len(part),
          "fqscramble equals gopcg.scramble_text")
    print(f"phase=surfaces fqscramble input_bytes={len(part)} seed=7 host_s={t_s:.4f} "
          f"host_MBps={len(part) / 1e6 / t_s:.3f}")
    return runs


# ---------------------------------------------------------------------------
# context rANS kernels
# ---------------------------------------------------------------------------


def context_corpus(n_records: int, seed: int, read_len: int = READ_LEN) -> bytes:
    """``n_records`` records of the context-model corpus."""
    from fastqpacker_tpu_torch.utils.synth import synth_fastq

    one = len(synth_fastq(0, read_len=read_len))
    data = synth_fastq((n_records * one + one // 2) / (1 << 20), read_len=read_len,
                       seed=seed, qual_model="phredwalk", seq_model="markov")
    check(data.count(b"\n") == 4 * n_records, "corpus record count")
    return data


def corpus_symbols(rng, model: int, n_records: int, read_len: int) -> np.ndarray:
    """Flat symbols of the corpus's streams: base codes or raw qualities."""
    from fastqpacker_tpu_torch.utils.synth import markov_codes

    if model == 0:
        return markov_codes(rng, n_records, read_len).reshape(-1)
    steps = rng.integers(-2, 3, size=(n_records, read_len)).astype(np.int32)
    return np.clip(30 + np.cumsum(steps, axis=1) // 3, 0, 41).astype(np.uint8).reshape(-1)


def wctx_prep(wctx, syms, lengths, model, order, lanes=None) -> dict:
    """One stream's host prep (the numpy functions of ops/wctx.py) and its
    tensors on the card."""
    C = wctx.model_geometry(model, order)[0]
    n = len(syms)
    if lanes is None:  # the lane count the mesh path picks for this stream
        sb, S, seg = wctx.stream_layout(lengths, 256)
        startm = wctx.start_matrix(lengths, sb, S)
        symm = wctx.to_matrix(syms, sb, S, 0)
        hist = wctx.matrix_histogram(
            symm, wctx.context_matrix(symm, startm, model, order), C, seg)
        lanes = wctx.pick_lanes_for(hist, n)
    sb, S, seg = wctx.stream_layout(lengths, lanes)
    startm = wctx.start_matrix(lengths, sb, S)
    symm = wctx.to_matrix(syms, sb, S, int(np.argmax(np.bincount(syms, minlength=256))))
    ctxm = wctx.context_matrix(symm, startm, model, order)
    present, freq_p = wctx.build_tables(symm, ctxm, C, seg)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    tab = t(wctx.device_table(freq_p))
    seg_t = t(seg)
    return {
        "enc": (t(wctx._sym_to_idx(present)[symm]), t(ctxm.astype(np.int16)), seg_t, tab),
        "dec_tail": (t(startm.view(np.uint8)), seg_t, tab, t(present.astype(np.uint8))),
        "sb": sb, "S": S, "lanes": lanes, "n": n, "C": C, "npres": len(present),
        "present": present, "syms": syms,
    }


def wctx_case(ck, wctx, prep: dict, model: int, order: int) -> dict:
    """Both kernels against their plain versions on the card, every output
    in full; decode(encode(x)) == x."""
    what = f"model={model} order={order} n={prep['n']} lanes={prep['lanes']}"
    got = ck.wctx_encode(*prep["enc"])
    want = wctx.wctx_encode_plain(*prep["enc"])
    enc_err = max(max_err(a, b) for a, b in zip(got, want))
    check(enc_err == 0, f"wctx encode kernel == plain at {what}")
    words, flags, states, status = got
    check(int(status) == 0, f"wctx encode status at {what}")
    flat, total = ck.rans_compact(words, flags)
    k = int(total)
    stream = flat[:k].clone()
    dec = (stream, states, *prep["dec_tail"])
    out, info = ck.wctx_decode(*dec, model, order)
    pout, pinfo = wctx.wctx_decode_plain(*dec, model, order)
    dec_err = max(max_err(out, pout), max_err(info, pinfo))
    check(dec_err == 0, f"wctx decode kernel == plain at {what}")
    check(info.tolist() == [k, 0], f"wctx words consumed == carried at {what}")
    idx = wctx.from_matrix(out.cpu().numpy(), prep["sb"])
    check(np.array_equal(prep["present"].astype(np.uint8)[idx], prep["syms"]),
          f"wctx decode(encode(x)) == x at {what}")
    torch.cuda.synchronize()
    return {"dec": dec, "errs": (enc_err, dec_err), "words": k, "cmp": (words, flags)}


def mesh_compact(ck, rans, case: dict, shape: str) -> tuple:
    """The compaction of one mesh stream's encode output (its words and
    flags as the wctx encode wrote them): byte-equal to the plain version
    and ``torch.masked_select``, then timed beside them."""
    words, flags = case["cmp"]
    m, k = words.numel(), case["words"]
    flat, total = ck.rans_compact(words, flags)
    pflat, ptotal = rans.rans_compact_plain(words, flags)
    lib = library_compact(words, flags)
    check(int(total) == int(ptotal) == lib.numel() == k, f"compact total at {shape}")
    err = max(max_err(flat[:k], pflat[:k]), max_err(flat[:k], lib))
    check(err == 0, f"compact kernel == plain == masked_select at {shape}")
    sets = rotations((words, flags), 3 * m + 2 * k)
    kms = gpu_ms(ck.rans_compact, sets, 20)
    pms = gpu_ms(rans.rans_compact_plain, sets[:1], 1)
    lms = gpu_ms(library_compact, sets, 20)
    return report(ck.RANS_COMPACT, shape, kms, pms, lms, 3 * m + 2 * k + 8, 4 * m, err)


def phase_wctx(ck, wctx, rans, rng) -> dict:
    errs = {ck.WCTX_ENCODE: 0, ck.WCTX_DECODE: 0}
    compact = {}

    def fold(case):
        for name, e in zip(errs, case["errs"]):
            errs[name] = max(errs[name], e)

    for lanes in (256, 1024, 8192):
        n_rec = max(300, lanes)
        lengths = rng.integers(0, 120, n_rec).astype(np.int64)
        lengths[7] = 2000  # one record longer than a lane
        lengths[20 : 20 + n_rec // 6] = 0  # zero-length records, empty lanes
        for model, order in WCTX_MODELS:
            syms = corpus_symbols(rng, model, 1, int(lengths.sum()))
            prep = wctx_prep(wctx, syms, lengths, model, order, lanes)
            check(bool((prep["enc"][2] == 0).any()), "a lane with no symbols")
            fold(wctx_case(ck, wctx, prep, model, order))
            print(f"phase=kernels wctx lanes={lanes} model={model} order={order} "
                  f"n={len(syms)} steps={prep['S']} byte_equal=true round_trip=true")

    # a stream that lost words: no read out of bounds, and the API raises
    lengths = np.full(2000, 100, np.int64)
    syms = corpus_symbols(rng, 1, 2000, 100)
    good = wctx.encode_stream(syms, lengths, 1, 0, device=DEV)
    check(np.array_equal(wctx.decode_stream(good, lengths, device=DEV), syms),
          "wctx stream API round trip")
    p = wctx.parse_stream(good)
    nwords = len(p["words"])
    at = len(good) - 2 * nwords - 4 * p["N"] - 4
    bad = good[:at] + (nwords - 40).to_bytes(4, "little") + good[at + 4 : -80]
    try:
        wctx.decode_stream(bad, lengths, device=DEV)
    except wctx.WctxError as e:
        check(str(e) == "trailing wctx words", "corrupt wctx stream message")
        print("phase=kernels wctx corrupt_words raises=true")
    else:
        raise RuntimeError("check failed: a wctx stream that lost words decoded")

    # full width: one v3 block's stream, the lane count the mesh path picks,
    # and the sequence model on the widest tier
    out = {}
    lengths = np.full(BLOCK_RECORDS, READ_LEN, np.int64)
    for model, order, lanes in [(m, o, None) for m, o in WCTX_MODELS] + [(0, 2, WIDE_LANES)]:
        syms = corpus_symbols(rng, model, BLOCK_RECORDS, READ_LEN)
        prep = wctx_prep(wctx, syms, lengths, model, order, lanes)
        case = wctx_case(ck, wctx, prep, model, order)
        fold(case)
        S, N, C, npres, k = prep["S"], prep["lanes"], prep["C"], prep["npres"], case["words"]
        m, live, tab_bytes = S * N, prep["n"], 2 * C * (npres + 1)
        geo = ck.wctx_decode_geometry(N, C, npres + 1)
        shape = (f"model={model} order={order} n={live} lanes={N} steps={S} "
                 f"contexts={C} npres={npres} words={k}")
        stream, *dec_rest = case["dec"]
        # bytes: encode reads symbols (1) and contexts (2) and writes words (2)
        # and flags (1) per cell; decode reads the start mask (1) and writes
        # the symbol (1) per cell and reads the words; both read seg, the
        # table once and the states. Operations per live cell: encode two
        # table reads, a test, a shift, divide, remainder, recombine (~12);
        # decode the context update (~8), log2(npres) search probes of 3 and
        # the state update, rank and refill (~12).
        probes = max(1, int(np.ceil(np.log2(max(npres, 2)))))
        dec_sets = [(w, dec_rest[0], st, *dec_rest[2:])
                    for w, st in rotations((stream, dec_rest[1]), 2 * k + 2 * m)]
        for name, fn, plain, sets, nbytes, ops, launch in (
            (ck.WCTX_ENCODE, ck.wctx_encode, wctx.wctx_encode_plain,
             [(a, b, *prep["enc"][2:]) for a, b in rotations(prep["enc"][:2], 6 * m)],
             6 * m + 8 * N + tab_bytes + 4, 12 * live,
             {"cluster": 1, "ctas": N // 32, "threads_per_cta": 32, "lanes_per_thread": 1}),
            (ck.WCTX_DECODE,
             lambda *a: ck.wctx_decode(*a, model, order),
             lambda *a: wctx.wctx_decode_plain(*a, model, order),
             dec_sets, 2 * k + 2 * m + 8 * N + tab_bytes + npres + 16,
             (20 + 3 * probes) * live,
             {"cluster": geo.cluster, "ctas": geo.cluster, "threads_per_cta": geo.threads,
              "lanes_per_thread": 1,
              "table": "shared" if geo.table_shared else "readonly_cache",
              "shared_bytes": geo.shared}),
        ):
            kms = gpu_ms(fn, sets, 10)
            pms = gpu_ms(plain, sets[:1], 1, warm=False)  # wctx_case ran it at these shapes
            extra = {"lanes": N, "steps": S, "step_us": kms * 1e3 / S, **launch}
            print(f"phase=kernels kernel={name} {shape} step_us={extra['step_us']:.4f} "
                  f"geometry={json.dumps(launch, sort_keys=True)}")
            key = (name, model, order) if lanes is None else (name, model, order, lanes)
            out[key] = (*report(name, shape, kms, pms, None, nbytes, ops, errs[name]), extra)
        if lanes is None and (model, order) in MESH_COMPACT:
            label, want_lanes = MESH_COMPACT[(model, order)]
            check(N == want_lanes, f"the mesh path's {label} stream on {want_lanes} lanes, got {N}")
            cshape = f"stream={label} model={model} order={order} lanes={N} steps={S} cells={m} words={k}"
            compact[label] = ((*mesh_compact(ck, rans, case, cshape), S),
                              {"cells": m, "words": k, "lanes": N})
        del case, prep, sets, dec_sets
        torch.cuda.empty_cache()
    return {"errs": errs, "times": out, "compact": compact}


def ptxas_report(log: str) -> list[dict]:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: registers, static
    shared memory and spills."""
    rows, cur = [], None
    for line in log.splitlines():
        if (mm := re.search(r"Compiling entry function '(\w+)'", line)):
            cur = {"entry": mm.group(1)}
            rows.append(cur)
        elif cur is not None and (mm := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur["spill_stores"], cur["spill_loads"] = int(mm.group(1)), int(mm.group(2))
        elif cur is not None and (mm := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(mm.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return rows


def rans_decode_registers(log: str) -> dict:
    """Registers of each ``rans_decode_kernel<K>`` instance, by K."""
    return {int(mm.group(1)): row["registers"] for row in ptxas_report(log)
            if (mm := re.search(r"rans_decode_kernelILi(\d+)E", row["entry"]))
            and "registers" in row}


def entry_label(entry: str) -> str:
    """A kernel's label from its mangled name: ``wctx_decode_kernel<kQual,
    kTabShared>``, ``wctx_encode_kernel<kShared>``, ``rans_decode_kernel<K>``,
    the order-0 encode's and the CRC's one instance each, the compaction's
    three kernels, and the dense codec's tile and row kernels."""
    if (mm := re.search(r"rans_decode_kernelILi(\d+)E", entry)):
        return f"fq_rans_decode<lanes_per_thread={mm.group(1)}>"
    if (mm := re.search(r"wctx_decode_kernelILb(\d)ELb(\d)E", entry)):
        return f"fq_wctx_decode<qual={mm.group(1)},table_shared={mm.group(2)}>"
    if (mm := re.search(r"wctx_encode_kernelILb(\d)E", entry)):
        return f"fq_wctx_encode<table_shared={mm.group(1)}>"
    if (mm := re.search(r"dense_decode_tilesILb(\d)E", entry)):
        return f"fq_dense_decode<tiles,short_rows={mm.group(1)}>"
    for kernel, name in (("rans_encode_kernel", "fq_rans_encode"),
                         ("rans_tile_counts_kernel", "fq_rans_compact<tile_counts>"),
                         ("rans_scan_tiles_kernel", "fq_rans_compact<scan_tiles>"),
                         ("rans_scatter_kernel", "fq_rans_compact<scatter>"),
                         ("crc32_kernel", "fq_crc32_chunks"),
                         ("dense_encode_tiles", "fq_dense_encode<tiles>"),
                         ("dense_encode_rows", "fq_dense_encode<rows>"),
                         ("dense_decode_rows", "fq_dense_decode<rows>")):
        if kernel in entry:
            return name
    return entry


# ---------------------------------------------------------------------------
# the --mesh path
# ---------------------------------------------------------------------------


def wctx_streams(comp: bytes, ft) -> list:
    """Per block of a v3 container: the (model, order, lanes) of its
    TAG_WCTX sequence and quality streams (None where the tag is another)."""
    c = ft.container
    r = io.BytesIO(comp)
    fh = c.read_file_header(r)
    rows = []
    while (hdr := c.read_block_header(r, fh.version)) is not None:
        sizes = hdr.stream_sizes(c.VERSION_2)
        payload = r.read(sum(sizes))
        row = []
        for at in (0, sizes[0]):
            row.append((payload[at + 1], payload[at + 2], 1 << payload[at + 3])
                       if payload[at] == c.TAG_WCTX else None)
        rows.append(row)
    return rows


def phase_mesh(ft, ck, args) -> dict:
    from fastqpacker_tpu_torch.parallel import mesh as pmesh
    from fastqpacker_tpu_torch.pipeline import meshpipe

    mesh = pmesh.make_mesh(1)
    check(mesh == [torch.device("cuda", 0)], "make_mesh(1) is the card")
    # the CLI's --mesh options: the v3 container, so 100,000-record blocks
    v3 = ft.Options(version=ft.container.VERSION_3_NATIVE)
    warm = context_corpus(3000, args.seed + 5)
    out = io.BytesIO()
    meshpipe.decompress_mesh(
        io.BytesIO(meshpipe.compress_mesh_bytes(warm, v3, mesh)), out, mesh)
    check(out.getvalue() == warm, "mesh warm-up round trip")

    data = context_corpus(args.mesh_blocks * BLOCK_RECORDS, args.seed + 6)
    label = f"markov151_mesh_{args.mesh_blocks}x{BLOCK_RECORDS}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    t0 = time.perf_counter()
    comp = meshpipe.compress_mesh_bytes(data, v3, mesh)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    c_counts = ck.launches.as_dict()

    ck.reset_launches()
    t0 = time.perf_counter()
    out = io.BytesIO()
    meshpipe.decompress_mesh(io.BytesIO(comp), out, mesh)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    d_counts = ck.launches.as_dict()
    peak = torch.cuda.max_memory_allocated()
    check(out.getvalue() == data, f"{label}: decompress_mesh output equals the input")
    del out

    fh = ft.container.read_file_header(io.BytesIO(comp))
    check(fh.version == ft.container.VERSION_3_NATIVE and fh.block_size == BLOCK_RECORDS,
          f"{label}: a v3 container at the default block size")
    blocks, tags = stream_tags(comp, ft)
    streams = wctx_streams(comp, ft)
    check(blocks == args.mesh_blocks, f"{label}: block count")
    for i, (seq, qual) in enumerate(streams):
        print(f"phase=e2e run={label} block={i} seq_wctx={seq} qual_wctx={qual}")
    print(f"phase=e2e run={label} tags={json.dumps(tags, sort_keys=True)}")
    n_wctx = tags["seq"].get("wctx", 0) + tags["qual"].get("wctx", 0)
    n_rans = tags["qual"].get("rans", 0)
    check(tags["qual"].get("wctx", 0) == blocks,
          f"{label}: every block's quality stream is TAG_WCTX")
    check(tags["qual"].get("qctx", 0) == 0, f"{label}: no block's quality stream took qctx")
    # compress launches every candidate that its estimate lets through, and
    # a candidate can still lose on its real size; decompress launches one
    # decode per stream that carries the tag
    check(c_counts[ck.WCTX_ENCODE] >= n_wctx > 0,
          f"{label}: at least one wctx encode launch per TAG_WCTX stream")
    check(c_counts[ck.WCTX_ENCODE] <= 2 * blocks, f"{label}: at most two candidates a block")
    check_ctx_launches(ck, label, tags, c_counts, d_counts)
    check(c_counts[ck.RANS_ENCODE] >= n_rans, f"{label}: rANS launches cover TAG_RANS streams")
    check(d_counts[ck.WCTX_DECODE] == n_wctx and d_counts[ck.RANS_DECODE] == n_rans,
          f"{label}: one decode launch per TAG_WCTX / TAG_RANS stream")
    check(c_counts[ck.WCTX_DECODE] == 0 and d_counts[ck.WCTX_ENCODE] == 0,
          f"{label}: no wctx launch in the wrong direction")
    check(c_counts[ck.ENCODE] == blocks and d_counts[ck.DECODE] == blocks,
          f"{label}: one dense launch per block and direction")
    check(c_counts[ck.RECORDS_SCAN] >= blocks and c_counts[ck.STREAMS_BUILD] == blocks
          and d_counts[ck.FASTQ_ASSEMBLE] == blocks,
          f"{label}: the block stages ran on the card in both directions")
    check(c_counts[ck.CRC32] > 0 and d_counts[ck.CRC32] > 0,
          f"{label}: CRC32 launched in both directions")
    # the plan prepares both context models of every block on the card; each
    # wctx encode takes its matrices from a layout launch, and each TAG_WCTX
    # decode its start matrix and its wire bytes
    check(c_counts[ck.QCTX_PREPARE] == c_counts[ck.SCTX_PREPARE] == blocks,
          f"{label}: one qctx and one sctx prepare launch per block")
    check(c_counts[ck.WCTX_LAYOUT] == c_counts[ck.WCTX_ENCODE]
          and c_counts[ck.WCTX_UNLAYOUT] == 0,
          f"{label}: one layout launch per wctx encode")
    check(d_counts[ck.WCTX_LAYOUT] == d_counts[ck.WCTX_UNLAYOUT] == n_wctx
          and d_counts[ck.QCTX_PREPARE] == d_counts[ck.SCTX_PREPARE] == 0,
          f"{label}: one start-matrix layout and one unlayout per TAG_WCTX stream")
    # the plan estimates each quality stream's order-0 size from its
    # histogram, and each rANS job's table is counted on its device; the
    # tokenizer where the header gate lets it run
    want = stream_counts(comp, ft, READ_LEN)
    check(c_counts[ck.HIST256] == want["qual_estimates"] + c_counts[ck.RANS_ENCODE]
          and d_counts[ck.HIST256] == 0,
          f"{label}: one fq_hist256 a quality estimate or rANS table ({c_counts[ck.HIST256]})")
    check(c_counts[ck.TOK_ENCODE] == want["tok_encodes"]
          and d_counts[ck.TOK_DECODE] == want["tok_streams"],
          f"{label}: the tokenizer launches follow the header tags ({want})")

    ck.reset_launches()
    t0 = time.perf_counter()
    check(ft.decompress_bytes(comp, device=DEV) == data,
          f"{label}: the ordinary decompress reads the mesh container")
    t_o = time.perf_counter() - t0
    o_counts = ck.launches.as_dict()
    check(o_counts[ck.WCTX_DECODE] == o_counts[ck.WCTX_LAYOUT]
          == o_counts[ck.WCTX_UNLAYOUT] == n_wctx,
          f"{label}: the ordinary decompress decodes TAG_WCTX on the card, its start "
          f"matrices and wire bytes too")
    mb = len(data) / 1e6
    print(
        f"phase=e2e run={label} input_bytes={len(data)} container_bytes={len(comp)} "
        f"blocks={blocks} compress_s={t_c:.4f} compress_MBps={mb / t_c:.2f} "
        f"decompress_s={t_d:.4f} decompress_MBps={mb / t_d:.2f} "
        f"ordinary_decompress_s={t_o:.4f} "
        f"compress_launches={json.dumps(c_counts, sort_keys=True)} "
        f"decompress_launches={json.dumps(d_counts, sort_keys=True)} "
        f"max_memory_allocated={peak} round_trip=true"
    )
    qual0 = streams[0][1]
    kept = {"data": data, "comp": comp}
    del data, comp

    # the card's container against the CPU's (the plain versions are Python
    # loops over the steps: two small blocks)
    small = context_corpus(40_000, args.seed + 7)
    opts = ft.Options(block_size=20_000)
    t0 = time.perf_counter()
    gpu_small = meshpipe.compress_mesh_bytes(small, opts, mesh)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_small = meshpipe.compress_mesh_bytes(small, opts, pmesh.make_mesh(1, device="cpu"))
    t_cpu = time.perf_counter() - t0
    check(gpu_small == cpu_small, "mesh d=1: GPU container byte-identical to CPU's")
    _, small_tags = stream_tags(gpu_small, ft)
    print(f"phase=e2e run=mesh_d1_cpu_identity records=40000 block_size=20000 "
          f"tags={json.dumps(small_tags, sort_keys=True)} gpu_compress_s={t_gpu:.4f} "
          f"cpu_compress_s={t_cpu:.4f} byte_identical_to_cpu=true")

    # the group logic on the card: the one card listed four times, a full
    # round and a partial one
    four = mesh * 4
    data4 = context_corpus(24_000, args.seed + 8)
    opts4 = ft.Options(block_size=5_000)
    ck.reset_launches()
    gpu4 = meshpipe.compress_mesh_bytes(data4, opts4, four)
    enc4 = ck.launches[ck.WCTX_ENCODE]
    cpu4 = meshpipe.compress_mesh_bytes(data4, opts4, pmesh.make_mesh(4, device="cpu"))
    check(gpu4 == cpu4, "mesh d=4: GPU container byte-identical to CPU's")
    blocks4, tags4 = stream_tags(gpu4, ft)
    check(blocks4 == 5 and tags4["qual"].get("wctx", 0) > 0, "mesh d=4: five blocks, TAG_WCTX picked")
    lanes4 = [{s[2] for row in wctx_streams(gpu4, ft)[a:b] for s in row[1:] if s}
              for a, b in ((0, 4), (4, 5))]
    check(all(len(x) <= 1 for x in lanes4), "mesh d=4: one quality lane count per round")
    out = io.BytesIO()
    meshpipe.decompress_mesh(io.BytesIO(gpu4), out, four)
    check(out.getvalue() == data4, "mesh d=4: round trip on the card")
    print(f"phase=e2e run=mesh_d4_one_card_four_times records=24000 block_size=5000 "
          f"blocks={blocks4} tags={json.dumps(tags4, sort_keys=True)} "
          f"wctx_encode_launches={enc4} byte_identical_to_cpu_d4=true round_trip=true")
    return {"compress": c_counts, "decompress": d_counts, "ordinary_decompress": o_counts,
            "qual": qual0, **kept}


# ---------------------------------------------------------------------------
# several cards in one process, several hosts
# ---------------------------------------------------------------------------

SHARD_RECORDS = 37_500  # one v2 block of the iid151 corpus per shard
SHARD_COUNT = 4
HOSTS = 2
IDENTITY_SLICE = 4 << 20  # bytes of input whose sections the CPU recomputes

_HOST_WORKER = r"""
import json, sys, time
rank, nproc, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, root)
import torch
import torch.distributed as dist
import fastqpacker_tpu_torch as ft
from fastqpacker_tpu_torch.ops import build, cuda_kernels as ck
from fastqpacker_tpu_torch.parallel import multihost as mh
from fastqpacker_tpu_torch.utils.synth import synth_fastq

mh.init_distributed(f"127.0.0.1:{port}", nproc, rank, timeout=300)
dev = mh.process_device()
build.load_all()
ft.decompress_bytes(ft.compress_bytes(synth_fastq(1, seed=rank), device=dev), device=dev)
for job in json.loads(sys.argv[5]):
    opts = ft.Options(version=job["version"])
    dist.barrier()
    ck.reset_launches()
    t0 = time.perf_counter()
    mh.compress_multihost(job["input"], job["output"], opts, device=dev)
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t0
    compress_launches = ck.launches.as_dict()
    dist.barrier()  # every section is on disk
    ck.reset_launches()
    t0 = time.perf_counter()
    mh.decompress_multihost(job["output"], job["output"] + ".fq", device=dev)
    torch.cuda.synchronize()
    decompress_s = time.perf_counter() - t0
    print(json.dumps({"rank": rank, "device": str(dev), "run": job["label"],
                      "compress_s": compress_s, "decompress_s": decompress_s,
                      "compress_launches": compress_launches,
                      "decompress_launches": ck.launches.as_dict()}), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_mesh(count: int) -> list:
    """Four shard devices: the first four cards, or the one card four times."""
    if count >= SHARD_COUNT:
        return [torch.device("cuda", i) for i in range(SHARD_COUNT)]
    return [torch.device("cuda", 0)] * SHARD_COUNT


def parallel_arrays(ft, ck, pmesh, data: bytes, mesh) -> dict:
    """``encode_blocks_parallel`` / ``decode_sharded`` on four shards of
    37,500 x 151 rows, and the sharded order-0 rANS on their quality-delta
    rows, against the CPU (plain versions on four CPU entries)."""
    from fastqpacker_tpu_torch.ops import rans
    from fastqpacker_tpu_torch.parser.fastq import FastqStreamParser

    blk = next(FastqStreamParser(io.BytesIO(data), block_size=SHARD_COUNT * SHARD_RECORDS).blocks())
    check(blk.n == SHARD_COUNT * SHARD_RECORDS and blk.max_len == READ_LEN, "shard rows")
    seq, qual, lengths = blk.seq, blk.qual, blk.lengths.astype(np.int32)
    cpu = pmesh.make_mesh(SHARD_COUNT, device="cpu")
    encs, offsets = pmesh.encode_blocks_parallel(seq, qual, lengths, 33, mesh)  # warm-up
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    encs, offsets = pmesh.encode_blocks_parallel(seq, qual, lengths, 33, mesh)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    shard_lengths = pmesh.shard_rows(lengths, mesh)
    t0 = time.perf_counter()
    s, q = pmesh.decode_sharded([e.packed for e in encs], [e.qual_delta for e in encs],
                                shard_lengths, qual_offset=33, mesh=mesh)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    counts = ck.launches.as_dict()
    launches = {"arrays_dense": counts}
    check(counts[ck.ENCODE] == SHARD_COUNT and counts[ck.DECODE] == SHARD_COUNT,
          "parallel: one dense encode and one decode per shard")
    check(all(e.packed.device == dev for e, dev in zip(encs, mesh)), "shards on their devices")
    got = pmesh.gather_encoded(encs)
    want_encs, want_offsets = pmesh.encode_blocks_parallel(seq, qual, lengths, 33, cpu)
    want = pmesh.gather_encoded(want_encs)
    check(all(np.array_equal(getattr(got, f), getattr(want, f))
              for f in ("packed", "nmask_bits", "n_counts", "qual_delta")),
          "parallel: sharded dense encode byte-equal to the CPU")
    check(np.array_equal(offsets, want_offsets) and offsets.dtype == np.int64,
          "parallel: offsets equal to the CPU's")
    l64 = lengths.astype(np.int64).reshape(SHARD_COUNT, SHARD_RECORDS)
    per = ((l64 + 3) // 4).sum(axis=1) + l64.sum(axis=1) + 4 * SHARD_RECORDS
    check(np.array_equal(offsets, np.cumsum(per) - per), "parallel: offsets are the prefix")
    base = np.where(np.isin(seq, np.frombuffer(b"ACGT", np.uint8)), seq, ord("A"))
    check(np.array_equal(pmesh.gather_rows(s), base) and np.array_equal(pmesh.gather_rows(q), qual),
          "parallel: decode_sharded round trip")
    mb = (seq.nbytes + qual.nbytes) / 1e6
    print(f"phase=parallel arrays devices={[str(d) for d in mesh]} shards={SHARD_COUNT}x"
          f"{SHARD_RECORDS}x{READ_LEN} encode_s={t_enc:.6f} decode_s={t_dec:.6f} "
          f"encode_MBps={mb / t_enc:.2f} decode_MBps={mb / t_dec:.2f} "
          f"offsets={offsets.tolist()} launches={json.dumps(counts, sort_keys=True)} "
          f"byte_equal_to_cpu=true round_trip=true")

    streams = np.stack([e.qual_delta.cpu().numpy().reshape(-1) for e in encs])
    m = streams.shape[1]
    for lanes in sorted({256, rans._pick_lanes(m)}):
        freq_cum, pad_sym = pmesh.entropy_table(streams, lanes=lanes)
        ck.reset_launches()
        t0 = time.perf_counter()
        enc = pmesh.entropy_encode_sharded(streams, freq_cum, mesh=mesh, pad_sym=pad_sym,
                                           m_per_shard=m, lanes=lanes)
        t_e = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = pmesh.entropy_decode_sharded(enc.words, enc.states, freq_cum, mesh=mesh,
                                           m_per_shard=m, lanes=lanes)
        back = pmesh.gather_rows(out).reshape(SHARD_COUNT, m)
        t_d = time.perf_counter() - t0
        counts = launches[f"arrays_rans_{lanes}_lanes"] = ck.launches.as_dict()
        check(np.array_equal(back, streams), f"parallel: sharded rANS round trip at {lanes} lanes")
        check(counts[ck.RANS_ENCODE] == counts[ck.RANS_COMPACT] == counts[ck.RANS_DECODE]
              == SHARD_COUNT, f"parallel: one rANS encode, compaction, decode per shard")
        check(np.array_equal(enc.offsets, np.cumsum(enc.totals) - enc.totals),
              "parallel: word offsets are the prefix of the totals")
        # each shard's words and states are those of a standalone stream of
        # that row with the group's table
        for k in (0, SHARD_COUNT - 1):
            payload = rans.assemble_payload(
                m, lanes, freq_cum[0].astype(np.uint16),
                enc.states[k].cpu().numpy().view(np.uint32),
                enc.words[k][: int(enc.totals[k])].cpu().numpy().view(np.uint16))
            check(rans.decode_stream(payload, device=mesh[k]) == streams[k].tobytes(),
                  "parallel: a shard's words decode as a standalone stream")
        mb = streams.nbytes / 1e6
        print(f"phase=parallel entropy lanes={lanes} m_per_shard={m} totals={enc.totals.tolist()} "
              f"offsets={enc.offsets.tolist()} encode_s={t_e:.6f} decode_s={t_d:.6f} "
              f"encode_MBps={mb / t_e:.2f} decode_MBps={mb / t_d:.2f} "
              f"launches={json.dumps(counts, sort_keys=True)} round_trip=true")
    return launches


@contextlib.contextmanager
def single_thread(pmesh):
    """``for_each_device`` on the calling thread (the dispatch without the
    per-device worker threads), for a comparison in one run."""
    orig = pmesh.for_each_device
    pmesh.for_each_device = lambda m, f, items, threads=None: orig(m, f, items, False)
    try:
        yield
    finally:
        pmesh.for_each_device = orig


def parallel_threads(ft, ck, pmesh, data: bytes, mesh) -> dict:
    """The ``--mesh`` round of four 100,000-record blocks through the one
    card listed four times (or four cards), with a worker thread per entry
    and on the calling thread: the same container and wall seconds."""
    from fastqpacker_tpu_torch.pipeline import meshpipe

    v3 = ft.Options(version=ft.container.VERSION_3_NATIVE)
    runs, launches = {}, {}
    for how in ("threads", "one_thread"):
        ctx = single_thread(pmesh) if how == "one_thread" else contextlib.nullcontext()
        with ctx:
            ck.reset_launches()
            t0 = time.perf_counter()
            comp = meshpipe.compress_mesh_bytes(data, v3, mesh)
            torch.cuda.synchronize()
            t_c = time.perf_counter() - t0
            c_counts = ck.launches.as_dict()
            out = io.BytesIO()
            ck.reset_launches()
            t0 = time.perf_counter()
            meshpipe.decompress_mesh(io.BytesIO(comp), out, mesh)
            torch.cuda.synchronize()
            t_d = time.perf_counter() - t0
            d_counts = ck.launches.as_dict()
        check(out.getvalue() == data, f"parallel: mesh d=4 round trip ({how})")
        runs[how] = comp
        launches[f"mesh_round_{how}"] = {k: c_counts[k] + d_counts[k] for k in c_counts}
        mb = len(data) / 1e6
        print(f"phase=parallel mesh_round dispatch={how} devices={[str(d) for d in mesh]} "
              f"input_bytes={len(data)} container_bytes={len(comp)} compress_s={t_c:.4f} "
              f"decompress_s={t_d:.4f} compress_MBps={mb / t_c:.2f} "
              f"decompress_MBps={mb / t_d:.2f} wctx_encode_launches={c_counts[ck.WCTX_ENCODE]} "
              f"wctx_decode_launches={d_counts[ck.WCTX_DECODE]} round_trip=true")
    check(runs["threads"] == runs["one_thread"],
          "parallel: the threaded mesh container equals the one-thread container")
    print("phase=parallel mesh_round containers_equal=true")
    return launches


def parallel_hosts(ft, ck, corpora: dict, workdir: Path) -> dict:
    """Two processes in a gloo group on one machine (both on the card when
    there is one), ``compress_multihost`` then ``decompress_multihost`` of
    each corpus; the simulation, the CPU, and more hosts than cards."""
    from fastqpacker_tpu_torch.parallel import multihost as mh

    jobs, inputs = [], {}
    for label, (version, data) in corpora.items():
        src = workdir / f"{label}.fq"
        src.write_bytes(data)
        inputs[label] = (src, version, data)
        jobs.append({"label": label, "version": version, "input": str(src),
                     "output": str(workdir / f"{label}_{HOSTS}hosts.fqz")})
    root = Path(__file__).resolve().parent
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _HOST_WORKER, str(rank), str(HOSTS), str(port), str(root),
         json.dumps(jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=root, text=True)
        for rank in range(HOSTS)]
    results, failed = [], None
    try:
        for rank, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=420)
            except subprocess.TimeoutExpired:
                failed = f"host {rank} timed out"
                break
            if p.returncode != 0:
                failed = f"host {rank} exited {p.returncode}: {err[-3000:]}"
                break
            results += [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(failed is None, f"parallel: {failed}")
    launches = {}
    for job in jobs:
        label = job["label"]
        src, version, data = inputs[label]
        rows = sorted((r for r in results if r["run"] == label), key=lambda r: r["rank"])
        check(len(rows) == HOSTS, f"parallel: every host reported {label}")
        comp = Path(job["output"]).read_bytes()
        check(Path(job["output"] + ".fq").read_bytes() == data,
              f"parallel: {label} {HOSTS}-process decompress equals the input")
        sim = workdir / f"{label}_sim.fqz"
        mh.simulate_multihost(str(src), str(sim), HOSTS, ft.Options(version=version), device=DEV)
        check(sim.read_bytes() == comp, f"parallel: {label} {HOSTS}-process file equals the simulation")
        sim.unlink()
        for row in rows:
            check(row["compress_launches"][ck.ENCODE] > 0 and row["decompress_launches"][ck.DECODE] > 0,
                  f"parallel: host {row['rank']} ran the dense kernels on {label}")
            if version == 3:
                check(row["compress_launches"][ck.CRC32] > 0 and row["decompress_launches"][ck.CRC32] > 0,
                      f"parallel: host {row['rank']} ran CRC32 on {label}")
        t_c = max(r["compress_s"] for r in rows)
        t_d = max(r["decompress_s"] for r in rows)
        mb = len(data) / 1e6
        launches[f"hosts_{label}"] = {
            k: sum(r["compress_launches"][k] + r["decompress_launches"][k] for r in rows)
            for k in rows[0]["compress_launches"]}
        per_host = [{"rank": r["rank"], "device": r["device"], "compress_s": r["compress_s"],
                     "decompress_s": r["decompress_s"],
                     **{f"{d}_launches": {k: n for k, n in r[f"{d}_launches"].items() if n}
                        for d in ("compress", "decompress")}}
                    for r in rows]
        print(f"phase=parallel hosts={HOSTS} run={label} input_bytes={len(data)} "
              f"container_bytes={len(comp)} compress_s={t_c:.4f} decompress_s={t_d:.4f} "
              f"compress_MBps={mb / t_c:.2f} decompress_MBps={mb / t_d:.2f} "
              f"per_host={json.dumps(per_host, sort_keys=True)} "
              f"equals_simulation=true round_trip=true")

        # the card's sections against the CPU's on a small slice
        cut = data.rfind(b"\n@", 0, IDENTITY_SLICE) + 1
        small = workdir / f"{label}_slice.fq"
        small.write_bytes(data[:cut])
        opts = ft.Options(version=version, workers=1)
        for h, (a, b) in enumerate(mh.host_ranges(str(small), HOSTS)):
            gpu = mh.compress_host_section(str(small), a, b, h, opts, 33, DEV)
            cpu = mh.compress_host_section(str(small), a, b, h, opts, 33, "cpu")
            check(gpu.payload == cpu.payload, f"parallel: {label} host {h} section equals the CPU's")
        print(f"phase=parallel run={label} slice_bytes={cut} sections_equal_to_cpu=true")
        small.unlink()

    # more hosts than cards: four simulated hosts on the card
    src, version, data = inputs["iid151_v2"]
    four = workdir / "four_hosts.fqz"
    t0 = time.perf_counter()
    mh.simulate_multihost(str(src), str(four), 4, ft.Options(version=version), device=DEV)
    back = workdir / "four_hosts.fq"
    mh.simulate_multihost_decompress(str(four), str(back), 4, device=DEV)
    check(back.read_bytes() == data, "parallel: four hosts on one card decode to the input")
    print(f"phase=parallel hosts=4 run=iid151_v2 one_card=true wall_s={time.perf_counter() - t0:.4f} "
          f"container_bytes={four.stat().st_size} decode_equals_two_process_decode=true")
    return launches


def phase_parallel(ft, ck, args, count: int, v2_data: bytes, v3_data: bytes,
                   mesh_data: bytes) -> dict:
    from fastqpacker_tpu_torch.parallel import mesh as pmesh

    if count < 2:
        print(f"phase=parallel multi_card=not_measured count={count}")
    mesh = parallel_mesh(count)
    arrays = parallel_arrays(ft, ck, pmesh, v2_data, mesh)
    threads = parallel_threads(ft, ck, pmesh, mesh_data, mesh)
    workdir = Path(__file__).resolve().parent / "fastqpacker_tpu_torch" / "_build" / "parallel"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        hosts = parallel_hosts(ft, ck, {"iid151_v2": (2, v2_data), "walk151_v3": (3, v3_data)},
                               workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {**arrays, **threads, **hosts}


# ---------------------------------------------------------------------------
# phase bench: fqpack bench on the card, its profiler, --backend auto
# ---------------------------------------------------------------------------

BENCH_MB = 16
# bench metric -> (its JSON metric name, the kernels it must launch, bytes of
# one launch in its unit: the dense pair counts seq + qual of 65,536 x 152,
# the entropy metrics their symbols)
BENCH_KERNEL_METRICS = {
    "kernel": ("encode_kernel_throughput", ("fq_dense_encode",), 2 * 65536 * 152),
    "decode-kernel": ("decode_kernel_throughput", ("fq_dense_decode",), 2 * 65536 * 152),
    "mesh-entropy": ("mesh_entropy_encode_throughput", ("fq_rans_encode", "fq_rans_compact"),
                     BENCH_MB << 20),
    "mesh-entropy-decode": ("mesh_entropy_decode_throughput", ("fq_rans_decode",),
                            BENCH_MB << 20),
    "wctx-entropy": ("wctx_entropy_encode_throughput", ("fq_wctx_encode",),
                     (BENCH_MB << 20) // READ_LEN * READ_LEN),
    "wctx-entropy-decode": ("wctx_entropy_decode_throughput", ("fq_wctx_decode",),
                            (BENCH_MB << 20) // READ_LEN * READ_LEN),
}
BENCH_WALL_MB = 32  # the in-process wall-clock metrics' input
BENCH_ESTIMATOR = {"window_s": 1.0, "min_s": 0.0, "cap_s": 10.0}  # a short one
ROOT = Path(__file__).resolve().parent


def bench_cli(args: list[str]) -> tuple[dict, dict, str]:
    """``fqpack bench ARGS`` in its own process: exit 0 and exactly one
    JSON line on stdout; returns the line, the launch counts the bench
    logs on stderr, and stderr."""
    p = subprocess.run(
        [sys.executable, "-m", "fastqpacker_tpu_torch.cli.fqpack", "bench", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    check(p.returncode == 0, f"fqpack bench {' '.join(args)} exits 0: {p.stderr[-3000:]}")
    lines = p.stdout.splitlines()
    check(len(lines) == 1, f"fqpack bench {' '.join(args)} prints one line: {lines}")
    counts = [ln for ln in p.stderr.splitlines() if ln.startswith("launches ")]
    check(len(counts) == 1, "the bench logs its launches")
    return json.loads(lines[0]), json.loads(counts[0].removeprefix("launches ")), p.stderr


def bench_kernel_metrics(phase_ms: dict) -> dict:
    """Each kernel metric of ``fqpack bench`` in its own process at
    ``--mb 16``: its JSON line, its launches, its time per launch beside the
    phase-kernels time of the same kernel (a consistency line: the shapes
    differ; not a gate)."""
    counts = {}
    for metric, (name, kernels, nbytes) in BENCH_KERNEL_METRICS.items():
        t0 = time.perf_counter()
        line, launches, err = bench_cli(["--mb", str(BENCH_MB), "--metric", metric])
        check(line["metric"] == name and line["unit"] == "MB/s" and line["value"] > 0,
              f"bench {metric}: {line}")
        for kernel in kernels:
            check(launches[kernel] > 0, f"bench {metric} launched {kernel}")
        ms, label = phase_ms[metric]
        print(f"phase=bench metric={metric} json={json.dumps(line)} "
              f"per_launch_ms={nbytes / (line['value'] * 1e6) * 1e3:.6f} "
              f"phase_kernels_ms={ms:.6f} ({label}) wall_s={time.perf_counter() - t0:.2f} "
              f"launches={json.dumps({k: v for k, v in launches.items() if v})}")
        for row in err.splitlines():
            if row.startswith("roofline "):
                print(f"phase=bench metric={metric} {row}")
        counts[metric] = launches
    return counts


def bench_profile() -> None:
    """``fqpack bench --metric kernel --profile DIR``: a trace file is
    written and names the wrapper (``fq_dense_encode``) and its device
    kernel (``dense_encode_tiles``)."""
    out = ROOT / "fastqpacker_tpu_torch" / "_build" / "bench_profile"
    shutil.rmtree(out, ignore_errors=True)
    try:
        line, launches, err = bench_cli(["--mb", str(BENCH_MB), "--metric", "kernel",
                                         "--profile", str(out)])
        check(f"profile trace written to {out}" in err, "bench --profile says where")
        traces = sorted(out.rglob("*.json"))
        check(len(traces) > 0, "bench --profile wrote a trace file")
        text = "".join(t.read_text(errors="replace") for t in traces)
        check("fq_dense_encode" in text, "the trace names fq_dense_encode")
        check("dense_encode_tiles" in text, "the trace holds the device kernel")
        print(f"phase=bench profile files={len(traces)} bytes={sum(t.stat().st_size for t in traces)} "
              f"names_fq_dense_encode=true device_kernel=dense_encode_tiles "
              f"fq_dense_encode_launches={launches['fq_dense_encode']} json={json.dumps(line)}")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def bench_in_process(ck) -> dict:
    """The wall-clock metrics through the bench's own functions, with a
    short estimator: compress and decompress (v2, v3) of 32 MiB, ``ratio``
    of 16 MiB, ``mesh-e2e`` of 16 MiB with one repeat, and ``micro``; each
    run's launch counts read just after it."""
    from fastqpacker_tpu_torch import bench as fb

    counts = {}
    data = fb.synth_fastq(BENCH_WALL_MB)

    def run(label, fn):
        ck.reset_launches()
        t0 = time.perf_counter()
        got = fn()
        counts[label] = ck.launches.as_dict()
        return got, time.perf_counter() - t0

    for v3 in (False, True):
        label = "compress-v3" if v3 else "compress"
        (mbps, ratio, best), wall = run(label, lambda: fb.bench_compress(
            data, DEV, 3, v3=v3, **BENCH_ESTIMATOR))
        check(mbps > 0 and ratio > 1 and counts[label][ck.ENCODE] > 0, f"bench {label}")
        if v3:
            check(counts[label][ck.CRC32] > 0, "bench compress-v3 launched CRC32")
        print(f"phase=bench metric={label} mb={BENCH_WALL_MB} mbps={mbps:.3f} ratio={ratio:.4f} "
              f"best_s={best:.4f} wall_s={wall:.2f}")
        label = "decompress-v3" if v3 else "decompress"
        (mbps, best), wall = run(label, lambda: fb.bench_decompress(
            data, DEV, 3, v3=v3, **BENCH_ESTIMATOR))
        check(mbps > 0 and counts[label][ck.DECODE] > 0, f"bench {label}")
        print(f"phase=bench metric={label} mb={BENCH_WALL_MB} mbps={mbps:.3f} best_s={best:.4f} "
              f"wall_s={wall:.2f}")

    names = {"ratio": "compression_ratio", "mesh-e2e": "mesh_e2e_compress_throughput",
             "micro": "parse_throughput"}
    for metric, mb, fixture in (("ratio", BENCH_MB, fb.synth_fastq(BENCH_MB)),
                                ("mesh-e2e", BENCH_MB, None), ("micro", BENCH_WALL_MB, data)):
        out = io.StringIO()
        args = argparse.Namespace(metric=metric, mb=mb, repeats=1)
        with contextlib.redirect_stdout(out):
            _, wall = run(metric, lambda: fb._run_metric(args, fixture, DEV))
        lines = out.getvalue().splitlines()
        check(len(lines) == 1, f"bench {metric} prints one line")
        line = json.loads(lines[0])
        check(line["metric"] == names[metric] and line["value"] > 0, f"bench {metric}: {line}")
        print(f"phase=bench metric={metric} mb={mb} json={json.dumps(line)} wall_s={wall:.2f}")
    check(counts["ratio"][ck.ENCODE] > 0 and counts["ratio"][ck.DECODE] > 0,
          "bench ratio ran the dense kernels")
    check(counts["mesh-e2e"][ck.WCTX_ENCODE] > 0, "bench mesh-e2e ran the wctx encode")
    check(counts["micro"][ck.RECORDS_SCAN] > 0 and counts["micro"][ck.STREAMS_BUILD] > 0,
          "bench micro scans and builds the streams on the card")
    return counts


def bench_backend_auto(ck) -> dict:
    """``fqpack --backend auto`` on a small file, the port's probe cache
    deleted before each run: it takes the card and says why, with
    ``--backend cuda``'s container; under ``FQZ_BACKEND=cpu`` it takes the
    CPU, with the same container."""
    import os

    from fastqpacker_tpu_torch.cli import fqpack as cli
    from fastqpacker_tpu_torch.pipeline import auto
    from fastqpacker_tpu_torch.utils.synth import synth_fastq

    work = ROOT / "fastqpacker_tpu_torch" / "_build" / "bench_auto"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    src = work / "in.fq"
    src.write_bytes(synth_fastq(4, seed=11))

    def run(backend, out, env=None):
        Path(auto._cache_path()).unlink(missing_ok=True)
        auto.backend_choice.cache_clear()
        old = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        err = io.StringIO()
        try:
            ck.reset_launches()
            with contextlib.redirect_stderr(err):
                rc = cli.main(["--backend", backend, "-i", str(src), "-o", str(work / out)])
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            auto.backend_choice.cache_clear()
        check(rc == 0, f"--backend {backend} exits 0: {err.getvalue()}")
        return err.getvalue(), ck.launches.as_dict(), (work / out).read_bytes()

    try:
        said, counts, comp = run("auto", "auto.fqz")
        check(said.startswith("backend auto: cuda (") and said.count("\n") == 1,
              f"--backend auto takes the card: {said!r}")
        check(counts[ck.ENCODE] > 0, "--backend auto launched the dense encode")
        _, _, want = run("cuda", "cuda.fqz")
        check(comp == want, "--backend auto's container equals --backend cuda's")
        said_cpu, cpu_counts, comp_cpu = run("auto", "cpu.fqz", {"FQZ_BACKEND": "cpu"})
        check(said_cpu == "backend auto: cpu (FQZ_BACKEND=cpu)\n", f"FQZ_BACKEND=cpu: {said_cpu!r}")
        check(comp_cpu == want and not any(cpu_counts.values()),
              "FQZ_BACKEND=cpu: the same container, no kernel launched")
        print(f"phase=bench backend_auto={said.strip()!r} fqz_backend_cpu={said_cpu.strip()!r} "
              f"containers_equal=true bytes={len(want)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"backend_auto": counts}


def phase_bench(ck, phase_ms: dict) -> dict:
    t0 = time.perf_counter()
    counts = bench_kernel_metrics(phase_ms)
    bench_profile()
    counts.update(bench_in_process(ck))
    counts.update(bench_backend_auto(ck))
    print(f"phase=bench wall_s={time.perf_counter() - t0:.2f}")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, default=96)
    ap.add_argument("--mesh-blocks", type=int, default=4)
    ap.add_argument("--varlen-mb", type=float, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=("all", "tokens", "ctxcoder"), default="all",
                    help="tokens / ctxcoder: the build and that phase alone (its kernels' "
                         "line with the launches of its v3 run)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import fastqpacker_tpu_torch as ft
    from fastqpacker_tpu_torch.ops import build
    from fastqpacker_tpu_torch.ops import crc32
    from fastqpacker_tpu_torch.ops import cuda_kernels as ck
    from fastqpacker_tpu_torch.ops import device as devops
    from fastqpacker_tpu_torch.ops import rans
    from fastqpacker_tpu_torch.ops import records as recops
    from fastqpacker_tpu_torch.ops import reference as refops
    from fastqpacker_tpu_torch.ops import wctx
    from fastqpacker_tpu_torch.utils.synth import synth_fastq

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"phase=device name={kind!r} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    build.load_all()
    print(f"phase=build sources={len(build.builds)} wall_seconds="
          f"{time.perf_counter() - t0:.2f}")
    for name, info in build.builds.items():
        print(f"phase=build source={name}.cu nvcc_seconds={info.seconds:.2f} "
              f"library={info.path.name}")
        for row in ptxas_report(info.log):
            print(f"phase=build {name}: {entry_label(row.pop('entry'))} "
                  f"{json.dumps(row, sort_keys=True)}")

    # the CPU's containers of phase tokens' and phase ctxcoder's corpora,
    # made while the card works
    tokens_dir = Path(__file__).resolve().parent / "fastqpacker_tpu_torch" / "_build" / "tokens"
    tokens_dir.mkdir(parents=True, exist_ok=True)
    refs = {}
    try:
        if args.phase in ("all", "tokens"):
            refs["tokens"] = CpuReference("ordered", TOKEN_BLOCKS * BLOCK_RECORDS,
                                          args.seed + 19, tokens_dir)
        if args.phase in ("all", "ctxcoder"):
            refs["ctxcoder"] = CpuReference("context", CTX_BLOCKS * BLOCK_RECORDS,
                                            args.seed + 23, tokens_dir, keep=BLOCK_RECORDS)
        if args.phase == "tokens":
            return tokens_only(args, ft, ck, kind, count, smi, refs["tokens"])
        if args.phase == "ctxcoder":
            return ctxcoder_only(args, ft, ck, kind, count, smi, refs["ctxcoder"])
        return run_phases(args, ft, build, crc32, ck, devops, rans, recops, refops, wctx,
                          synth_fastq, kind, count, smi, refs)
    finally:
        for ref in refs.values():
            ref.stop()
        shutil.rmtree(tokens_dir, ignore_errors=True)


def tokens_only(args, ft, ck, kind, count, smi, cpu_ref) -> int:
    """``--phase tokens``: phase tokens alone; each of its kernels' entries
    takes its launches from the ordered-name v3 run."""
    tokens = phase_tokens(ft, ck, args, cpu_ref)
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, key, direction in ((ck.HIST256, ("hist256", "qual"), "compress"),
                                 (ck.TOK_ENCODE, ("tok_encode", "headers"), "compress"),
                                 (ck.TOK_DECODE, ("tok_decode", "headers"), "decompress")):
        *times, extra = tokens["times"][key]
        extra = dict(extra)
        launches = tokens["run"][direction][name]
        check(launches > 0, f"{name} launched on the ordered-name run")
        source, replaces = KERNELS[name]
        kernels.append({"name": name, "route": "cuda", "source": CSRC + source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": extra.pop("err"), **dict(zip(fields, times)), **extra})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


CTX_KERNELS = {  # kernel -> (route, the direction of the run that launches it)
    "fq_qctx_encode": ("qctx_encode", "compress"), "fq_qctx_decode": ("qctx_decode", "decompress"),
    "fq_sctx_encode": ("sctx_encode", "compress"), "fq_sctx_decode": ("sctx_decode", "decompress"),
}


def ctxcoder_rows(ctx: dict) -> list:
    """The four context coders' entries of the ``kernels`` line: launches
    from the markov151 v3 run; ms, plain_ms and bound_ms at the first
    CTX_PREFIX records of its streams (the plain versions' size), the whole
    block's in ``full_width``."""
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for name, (route, direction) in CTX_KERNELS.items():
        *times, extra = ctx["times"][route]
        extra = dict(extra)
        err = extra.pop("err")
        launches = ctx["run"][direction][name]
        check(launches > 0, f"{name} launched on the {ctx['run']['label']} run")
        more = {**extra, "edge_cases_checked": ctx["edges"],
                **({"routes_ctx_run": ctx["run"]["qctx_decode_routes"]}
                   if name == "fq_qctx_decode" else {}),
                "launches_golden_ctx": ctx["golden"][name],
                "launches_ctx_run": {d: ctx["run"][d][name] for d in ("compress", "decompress")}}
        rows.append((name, launches, err, (*times, None), more))
    return rows


def ctxcoder_only(args, ft, ck, kind, count, smi, cpu_ref) -> int:
    """``--phase ctxcoder``: phase ctxcoder alone; each of its kernels'
    entries takes its launches from the markov151 v3 run."""
    ctx = phase_ctxcoder(ft, ck, args, cpu_ref)
    kernels = []
    for name, launches, err, (kms, pms, bound_ms, bound_by, lms, _), extra in ctxcoder_rows(ctx):
        source, replaces = KERNELS[name]
        kernels.append({"name": name, "route": "cuda", "source": CSRC + source,
                        "replaces": replaces, "launches": launches, "max_abs_err": err,
                        "ms": kms, "plain_ms": pms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lms, **extra})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def run_phases(args, ft, build, crc32, ck, devops, rans, recops, refops, wctx, synth_fastq,
               kind, count, smi, refs) -> int:
    t_start = time.perf_counter()

    def lap(done: str) -> None:  # the run's seconds so far, after each phase
        print(f"phase=time done={done} elapsed_s={time.perf_counter() - t_start:.1f}")

    rng = np.random.default_rng(args.seed)
    kern = phase_kernels(ck, devops, refops, rng)
    kern_rans = phase_rans(ck, rans, rng, rans_decode_registers(build.builds["rans_codec"].log))
    kern_rans["extra"]["qual"]["by_geometry"] = phase_rans_variant(
        kern_rans["extra"]["qual"], kern_rans["times"][(ck.RANS_DECODE, "qual")][0])
    kern_crc = phase_crc(ck, crc32, rng)
    lap("kernels")
    kern_wctx = phase_wctx(ck, wctx, rans, rng)
    lap("wctx")
    kern_records = phase_records(ft, ck, recops, rng)
    lap("records")
    kern_ctx = phase_ctxprep(ft, ck, args)
    lap("ctxprep")

    # warm-up: a round trip of the same size (kernel loads, the worker
    # threads' streams, page-locked buffers of the block sizes), so the
    # timed runs read the steady state
    warm = synth_fastq(args.mb, seed=args.seed + 1)
    check(ft.decompress_bytes(ft.compress_bytes(warm, device=DEV), device=DEV) == warm,
          "v2 warm-up round trip")
    del warm
    torch.cuda.reset_peak_memory_stats()
    v2_data = synth_fastq(args.mb, seed=args.seed)
    v2_label = f"iid151_{args.mb:g}MiB"
    main_launches = round_trip(ft, ck, v2_data, v2_label)
    print(f"phase=e2e max_memory_allocated={torch.cuda.max_memory_allocated()}")
    varlen = synth_fastq(args.varlen_mb, read_len=300, min_len=50,
                         seed=args.seed + 2)
    round_trip(ft, ck, varlen, f"varlen50_300_{args.varlen_mb:g}MiB")
    del varlen
    lap("e2e_v2")

    # FQZ v3: warm up (codecs, streams), then the rANS-picking data
    warm = synth_fastq(1, seed=args.seed + 3, qual_model="walk")
    v3 = ft.Options(version=ft.container.VERSION_3_NATIVE)
    check(ft.decompress_bytes(ft.compress_bytes(warm, v3, device=DEV), device=DEV)
          == warm, "v3 warm-up round trip")
    torch.cuda.reset_peak_memory_stats()
    v3_data = synth_fastq(args.mb, seed=args.seed + 4, qual_model="walk")
    v3_label = f"walk151_v3_{args.mb:g}MiB"
    v3_launches = round_trip_v3(ft, ck, v3_data, v3_label)
    print(f"phase=e2e v3_max_memory_allocated={torch.cuda.max_memory_allocated()}")
    lap("e2e_v3")

    mesh_run = phase_mesh(ft, ck, args)
    lap("mesh")
    phase_stages(args)
    lap("stages")
    # phase ctxcoder first: it runs while the CPU's ordered-name container is
    # still being made, which phase tokens waits for
    ctx = phase_ctxcoder(ft, ck, args, refs["ctxcoder"])
    lap("ctxcoder")
    tokens = phase_tokens(ft, ck, args, refs["tokens"])
    lap("tokens")

    mesh_data = mesh_run.pop("data")
    surfaces = phase_surfaces(ft, ck, {
        "v2": (v2_label, v2_data, main_launches.pop("comp")),
        "v3": (v3_label, v3_data, v3_launches.pop("comp")),
        "mesh": (f"markov151_mesh_{args.mesh_blocks}x{BLOCK_RECORDS}",
                 mesh_data, mesh_run.pop("comp")),
        "ctx": (ctx["run"]["label"], ctx["run"].pop("data"), ctx["run"].pop("comp")),
    })
    lap("surfaces")
    parallel = phase_parallel(ft, ck, args, count, v2_data, v3_data, mesh_data)
    lap("parallel")
    del v2_data, v3_data, mesh_data
    rt = kern_rans["times"]
    bench = phase_bench(ck, {
        "kernel": (kern["times"][(ck.ENCODE, "37500x160")][0], "37500x160"),
        "decode-kernel": (kern["times"][(ck.DECODE, "37500x160")][0], "37500x160"),
        "mesh-entropy": (rt[(ck.RANS_ENCODE, "qual")][0] + rt[(ck.RANS_COMPACT, "qual")][0],
                         "encode + compact, 15.1 MB at 16384 lanes"),
        "mesh-entropy-decode": (rt[(ck.RANS_DECODE, "qual")][0], "15.1 MB at 16384 lanes"),
        "wctx-entropy": (kern_wctx["times"][(ck.WCTX_ENCODE, 1, 0)][0],
                         "qual order 0, 15.1 M symbols at 2048 lanes"),
        "wctx-entropy-decode": (kern_wctx["times"][(ck.WCTX_DECODE, 1, 0)][0],
                                "qual order 0, 15.1 M symbols at 2048 lanes"),
    })
    lap("bench")

    # launches: the count from the main path's run that drives the kernel
    # (dense: the v2 run, per direction; rANS and CRC32: the v3 run)
    dense_shapes = {
        name: {key: row for (n, key), row in kern["shapes"].items() if n == name}
        for name in (ck.ENCODE, ck.DECODE)
    }
    rows = [
        (ck.ENCODE, main_launches["encode"], kern["errs"][ck.ENCODE],
         (*kern["times"][(ck.ENCODE, "37500x160")], None),
         {"launches_v3": v3_launches["compress"][ck.ENCODE],
          "device_ops_per_call_100000x151": kern["per_call"][ck.ENCODE],
          "by_shape": dense_shapes[ck.ENCODE]}),
        (ck.DECODE, main_launches["decode"], kern["errs"][ck.DECODE],
         (*kern["times"][(ck.DECODE, "37500x160")], None),
         {"launches_v3": v3_launches["decompress"][ck.DECODE],
          "device_ops_per_call_100000x151": kern["per_call"][ck.DECODE],
          "by_shape": dense_shapes[ck.DECODE]}),
    ]
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, direction in ((ck.RANS_ENCODE, "compress"), (ck.RANS_COMPACT, "compress"),
                            (ck.RANS_DECODE, "decompress")):
        more = {}
        if name == ck.RANS_ENCODE:  # the quality stream's; the sequence's beside
            seq = kern_rans["times"][(name, "seq")]
            more = {**kern_rans["extra"][("encode", "qual")],
                    "seq_stream": {**dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), seq)),
                                   "steps": seq[5], **kern_rans["extra"][("encode", "seq")]}}
        if name == ck.RANS_DECODE:  # the quality stream's; the sequence's beside
            seq = kern_rans["times"][(name, "seq")]
            more = {**kern_rans["extra"]["qual"],
                    "seq_stream": {**dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), seq)),
                                   "steps": seq[5], **kern_rans["extra"]["seq"]}}
        if name == ck.RANS_COMPACT:  # the quality stream's; every shape beside
            qual_extra = kern_rans["extra"][("compact", "qual")]
            by_shape = {
                f"v3_{label}": {**dict(zip(fields, kern_rans["times"][(name, label)])),
                                "steps": kern_rans["times"][(name, label)][5],
                                **kern_rans["extra"][("compact", label)]}
                for label in ("qual", "seq")
            }
            for label in ("mesh_seq", "mesh_qual"):
                times, shape_extra = kern_wctx["compact"][label]
                by_shape[label] = {**dict(zip(fields, times)), "steps": times[5], **shape_extra}
            more = {"cells": qual_extra["cells"], "words": qual_extra["words"],
                    "device_ops_per_call_15.1M": qual_extra["device_ops_per_call"],
                    "by_shape": by_shape}
        rows.append((name, v3_launches[direction][name], kern_rans["errs"][name],
                     kern_rans["times"][(name, "qual")], more))
    crc_seq = kern_crc["times"][(ck.CRC32, "seq")]
    rows.append((ck.CRC32, v3_launches["compress"][ck.CRC32], kern_crc["errs"][ck.CRC32],
                 kern_crc["times"][(ck.CRC32, "qual")],
                 {"launches_decompress": v3_launches["decompress"][ck.CRC32],
                  "seq_stream": dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"),
                                         crc_seq))}))
    # context rANS: the count from the mesh run; the times of the model and
    # order that run's quality streams were coded with, the others beside
    qual = mesh_run["qual"][:2]
    wt = kern_wctx["times"]
    for name, direction in ((ck.WCTX_ENCODE, "compress"), (ck.WCTX_DECODE, "decompress")):
        by_model = {
            f"model{m}_order{o}": {**dict(zip(fields, wt[(name, m, o)])), **wt[(name, m, o)][5]}
            for m, o in WCTX_MODELS
        }
        by_model[f"model0_order2_lanes{WIDE_LANES}"] = {
            **dict(zip(fields, wt[(name, 0, 2, WIDE_LANES)])), **wt[(name, 0, 2, WIDE_LANES)][5]}
        kms, pms, bound_ms, bound_by, lms, extra = wt[(name, *qual)]
        more = {"model_order": list(qual), **extra, "by_model": by_model}
        rows.append((name, mesh_run[direction][name], kern_wctx["errs"][name],
                     (kms, pms, bound_ms, bound_by, lms, extra["steps"]), more))
    # the block stages: the counts of the v2 run (the direction that runs
    # each most), the other runs beside; times at a v2 block (phase records)
    for name, direction in ((ck.RECORDS_SCAN, "compress"), (ck.ROWS_GATHER, "compress"),
                            (ck.STREAMS_BUILD, "compress"), (ck.FASTQ_ASSEMBLE, "decompress")):
        more = {
            "shape": f"block {RECORD_TIMED}",
            "launches_v2": {d: main_launches[d][name] for d in ("compress", "decompress")},
            "launches_v3": {d: v3_launches[d][name] for d in ("compress", "decompress")},
            "launches_mesh": {d: mesh_run[d][name] for d in ("compress", "decompress")},
            "faults_checked": kern_records["faults"],
        }
        more["by_shape"] = kern_records["by_shape"][name]
        if name in kern_records["host_split"]:
            more["host_split_us"] = kern_records["host_split"][name]
        t = kern_records["times"][name]
        rows.append((name, main_launches[direction][name], kern_records["errs"][name],
                     (t["ms"], t["plain_ms"], t["bound_ms"], t["bound_by"], t["library_ms"],
                      None), more))
    # the context-model passes: the counts of the mesh run (the prepare
    # passes and the encode's layout on compress, the unlayout on
    # decompress), the v3 run beside; times at the walk corpus (prepare) and
    # the mesh path's quality stream (the lane passes), every shape beside
    ctx_rows = kern_ctx["rows"]
    for name, direction in ((ck.QCTX_PREPARE, "compress"), (ck.SCTX_PREPARE, "compress"),
                            (ck.WCTX_LAYOUT, "compress"), (ck.WCTX_UNLAYOUT, "decompress")):
        more = {
            "launches_v3": {d: v3_launches[d][name] for d in ("compress", "decompress")},
            "launches_mesh": {d: mesh_run[d][name] for d in ("compress", "decompress")},
            "launches_mesh_ordinary_decompress": mesh_run["ordinary_decompress"][name],
            "faults_checked": kern_ctx["faults"],
        }
        routes = {ck.QCTX_PREPARE: ("qctx",), ck.SCTX_PREPARE: ("sctx",),
                  ck.WCTX_LAYOUT: ("layout_encode", "layout_decode"),
                  ck.WCTX_UNLAYOUT: ("unlayout",)}[name]
        more["device_ops_per_call"] = {r: kern_ctx["device_ops"][r] for r in routes}
        if name in (ck.SCTX_PREPARE, ck.WCTX_LAYOUT):
            more["edge_cases_checked"] = kern_ctx["edges"]
        if name in (ck.QCTX_PREPARE, ck.SCTX_PREPARE):
            *times, lib = ctx_rows["walk"]["times"][name]
            mk = ctx_rows["markov"]["times"][name]
            more.update(shape=f"walk151 block of {BLOCK_RECORDS} records", **lib,
                        by_shape={"markov151": {**dict(zip(fields, mk[:5])), **mk[5]}})
        else:
            part = "encode" if name == ck.WCTX_LAYOUT else "unlayout"
            lay = ctx_rows["markov"]["layout"]
            *times, _ = lay[CTX_TIMED][part]
            by_shape = {}
            for (m_, o_), row in lay.items():
                for p_ in (("encode", "decode") if name == ck.WCTX_LAYOUT else ("unlayout",)):
                    by_shape[f"model{m_}_order{o_}_{p_}"] = {
                        **dict(zip(fields, row[p_][:5])), "lanes": row["lanes"],
                        "steps": row["steps"]}
            more.update(shape=f"markov151 model={CTX_TIMED[0]} order={CTX_TIMED[1]} "
                              f"lanes={lay[CTX_TIMED]['lanes']} steps={lay[CTX_TIMED]['steps']}",
                        by_shape=by_shape)
        rows.append((name, mesh_run[direction][name], kern_ctx["errs"][name],
                     (*times[:5], None), more))
    # the byte histogram: the count of the v3 run (the v3 block's
    # estimates), the tokens and mesh runs beside; times at the v3 block's
    # quality stream, the sequence stream's and the others' beside. The tokenizer:
    # the counts of the ordered-name v3 run, whose header streams are TAG_TOK
    tt, trun = tokens["times"], tokens["run"]
    for name, key, direction in ((ck.HIST256, ("hist256", "qual"), "compress"),
                                 (ck.TOK_ENCODE, ("tok_encode", "headers"), "compress"),
                                 (ck.TOK_DECODE, ("tok_decode", "headers"), "decompress")):
        kms, pms, bound_ms, bound_by, lms, extra = tt[key]
        extra = dict(extra)
        err = extra.pop("err")
        more = {**extra, "edge_cases_checked": tokens["edges"],
                "launches_v3": {d: v3_launches[d][name] for d in ("compress", "decompress")},
                "launches_tokens": {d: trun[d][name] for d in ("compress", "decompress")},
                "launches_mesh": {d: mesh_run[d][name] for d in ("compress", "decompress")}}
        if name == ck.HIST256:
            seq = tt[("hist256", "seq")]
            more["seq_stream"] = {**dict(zip(fields, seq[:5])),
                                  **{k: v for k, v in seq[5].items() if k != "err"}}
            launches = v3_launches[direction][name]
        else:
            launches = trun[direction][name]
        rows.append((name, launches, err, (kms, pms, bound_ms, bound_by, lms, None), more))
    # the context coders: the counts of the markov151 v3 run; the v3, mesh
    # and golden runs beside
    for name, launches, err, times, more in ctxcoder_rows(ctx):
        for run, counts in (("v3", v3_launches), ("mesh", mesh_run)):
            more[f"launches_{run}"] = {d: counts[d][name] for d in ("compress", "decompress")}
        rows.append((name, launches, err, times, more))
    for row in rows[:6]:  # the earlier kernels run on the mesh path too
        name = row[0]
        direction = "decompress" if name in (ck.DECODE, ck.RANS_DECODE) else "compress"
        row[4]["launches_mesh"] = mesh_run[direction][name]
    check({row[0] for row in rows} == set(KERNELS), "every kernel has its row")
    kernels = []
    for name, launches, err, (kms, pms, bound_ms, bound_by, lms, steps), extra in rows:
        check(launches > 0, f"{name} launched on a main path")
        extra["launches_surfaces"] = {run: counts[name] for run, counts in surfaces.items()}
        extra["launches_parallel"] = {run: counts[name] for run, counts in parallel.items()}
        extra["launches_bench"] = {run: counts[name] for run, counts in bench.items()}
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": CSRC + source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": err,
            "ms": kms,
            "plain_ms": pms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lms,
            "steps": steps,
            **extra,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
