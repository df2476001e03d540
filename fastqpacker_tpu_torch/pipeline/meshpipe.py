"""FQZ v3 compression with the entropy stage on a list of devices.

The port of ``fastqpacker_tpu/pipeline/meshpipe.py``. Blocks are grouped in
rounds of D (one per device of the mesh, :func:`..parallel.mesh.make_mesh`);
each round's sequence and quality streams are coded on the devices by the
context coder (``parallel.mesh.wctx_encode_streams``, TAG_WCTX) or the
order-0 coder (``parallel.mesh.entropy_encode_streams``, TAG_RANS) and come
back as standalone wire streams. The container written here is a standard
FQZ v3 file: ``pipeline.native.decompress_native`` (and the ``fqpack`` CLI)
decode it with no knowledge of how it was produced. What a round shares
(one lane count and context order per group of TAG_WCTX streams, one
frequency table per group of TAG_RANS streams) is on the wire, so the
bytes depend on D.

Host keeps the irregular byte work (record scan, stream building,
header/plus/npos/length side streams via zstd). The dense block
transform and the block CRC32 run on the first device of the mesh.
"""

from __future__ import annotations

import contextlib
import io
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Optional

import numpy as np
import torch

from ..entropy import zstd as zstd_entropy
from ..format import container
from ..ops import device as devops
from ..ops import qualctx, rans, seqctx, sldm, wctx
from ..ops import reference as refops
from ..parallel import mesh as pmesh
from ..parser.fastq import FastqStreamParser, RecordBlock
from . import api
from . import blocks as blockcodec
from . import native


@contextlib.contextmanager
def _on_device(dev):
    """Launches of the body on ``dev``'s card and this thread's stream of
    it (no-op on the CPU)."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), devops.worker_stream(dev):
        yield


def _plan_seq(ordereds, lengths_l, codec, seq_dict, devs):
    """Per-block sequence-slot pick: device context coder (TAG_WCTX over
    unpacked codes) vs the host candidates (adaptive zstd; probe-gated
    sldm for coverage structure, with the container-level cross-block
    dictionary as LDM prefix when present) — the same empirical-size
    policy as the per-block v3 pipeline (native._encode_tagged_seq), with
    wctx standing in for sctx. Block i's prepare pass runs on ``devs[i]``
    (``fq_sctx_prepare``), where its bases stay. Returns (infos, chosen seq
    order or None)."""
    infos = []
    for i, (o, lens) in enumerate(zip(ordereds, lengths_l)):
        s = o[0]
        z = native._zstd_candidate(codec, s)
        info = {"host": bytes([native.TAG_ZSTD]) + z}
        if len(s) >= native.RANS_MIN_BYTES:
            s_arr = np.frombuffer(s, np.uint8)
            try:
                with _on_device(devs[i]):
                    info["bases"], info["hist6"] = seqctx.prepare(s_arr, lens, devs[i])
            except seqctx.SctxError:
                pass
            try:
                if (
                    seq_dict is not None
                    or sldm.coverage_probe(s_arr) >= sldm.DUP_THRESHOLD
                ):
                    cand = (
                        sldm.encode_bases(info["bases"].numpy(), prefix=seq_dict)
                        if "bases" in info
                        else sldm.encode(s_arr, lens, prefix=seq_dict)
                    )
                    if len(cand) + 1 < len(info["host"]):
                        info["host"] = bytes([native.TAG_SLDM]) + cand
            except ValueError:
                pass
        infos.append(info)
    # one context order per round: argmin of the summed estimates over
    # candidate blocks
    best_k, best_tot = None, None
    for k in wctx.SEQ_ORDERS:
        tot, any_b = 0, False
        for info in infos:
            if "hist6" not in info:
                continue
            h = (
                seqctx.marginalize(info["hist6"], k)
                if k < seqctx.MAX_ORDER
                else info["hist6"]
            )
            e = wctx.estimate_size(h, wctx.pick_lanes_for(h, int(h.sum())))
            info.setdefault("est", {})[k] = e
            tot += e
            any_b = True
        if any_b and (best_tot is None or tot < best_tot):
            best_k, best_tot = k, tot
    return infos, best_k


def _plan_qual(ordereds, views, lengths_l, codec, devs):
    """Per-block quality-slot pick: the lane context coder (order-1 and
    order-2 models, like qctx) vs order-0 rANS vs qctx vs host
    adaptive zstd, by estimated size (mirrors
    native._encode_tagged_qual). Block i's prepare pass runs on ``devs[i]``
    (``fq_qctx_prepare``), where its raw qualities stay; its order-0
    histogram on ``views[i]``, the stream where the stream build left it.
    Returns (infos, round qual order)."""
    infos = []
    for i, (o, lens) in enumerate(zip(ordereds, lengths_l)):
        q = o[1]
        z = native._zstd_candidate(codec, q)
        info = {"host": bytes([native.TAG_ZSTD]) + z, "choice": "host"}
        if len(q) >= native.RANS_MIN_BYTES:
            q_arr = np.frombuffer(q, np.uint8)
            bar = len(z)
            try:
                with _on_device(devs[i]):
                    raw_q, hist2 = qualctx.prepare(q_arr, lens, devs[i])
                hist0 = qualctx.hist_for_model(hist2, 0)
                if int((hist0.any(axis=0)).sum()) <= wctx.B_MAX:
                    est = {
                        0: wctx.estimate_size(
                            hist0, wctx.pick_lanes_for(hist0, len(q))
                        ),
                        1: wctx.estimate_size(
                            hist2, wctx.pick_lanes_for(hist2, len(q))
                        ),
                    }
                    est_w = min(est.values())
                    # same est-noise slack as the seq gate: actual
                    # payload sizes make the final call
                    if est_w < bar * 1.02:
                        info.update(
                            choice="wctx", raw=raw_q,
                            hists={0: hist0, 1: hist2}, est=est,
                        )
                        bar = min(bar, est_w)
                # qctx as a FALLBACK candidate (coded on devs[i] too,
                # fq_qctx_encode): its 16-state layout has no per-lane
                # cost, so on tiny/constant quals it can be far smaller
                # than the 4 B/lane wctx states. The lane coder keeps
                # priority — qctx only competes when it beats the wctx
                # estimate by > 5% (its decode is 4 chains, wctx's
                # thousands of lanes) or when wctx is not viable at all.
                _, est_q = qualctx.pick_model(hist2)
                w_est = (
                    min(info["est"].values())
                    if info["choice"] == "wctx"
                    else None
                )
                if est_q < bar and (
                    w_est is None or est_q < w_est * 0.95
                ):
                    hq = qualctx.encode_prepared(raw_q, lens, hist2)
                    if len(hq) + 1 < len(info["host"]):
                        info["host"] = bytes([native.TAG_QCTX]) + hq
                        if len(hq) + 1 < bar:
                            bar = len(hq) + 1
                            info["choice"] = "host"
            except qualctx.QctxError:
                pass
            est_r0, _ = native._rans_size_estimate(views[i])
            if est_r0 < bar:
                info["choice"] = "rans"
        infos.append(info)
    # one qual order per round, by summed estimates over the wctx-chosen
    # blocks — same policy as seq_k
    tot = {0: 0, 1: 0}
    any_w = False
    for info in infos:
        if info["choice"] == "wctx":
            any_w = True
            tot[0] += info["est"][0]
            tot[1] += info["est"][1]
    q_order = (1 if tot[1] < tot[0] else 0) if any_w else 0
    return infos, q_order


def _plan_round(raws, mesh, seq_dict=None):
    """Host planning for one round (runs on the prefetch worker,
    overlapped with the previous round's device work): ordered streams,
    per-stream empirical picks (block i's context prepare passes on
    ``mesh[i]``, where its wctx encode runs), CRCs (on ``mesh[0]``), host
    candidate frames. The zstd codec is taken thread-locally (ZSTD
    contexts are not thread-safe; this runs on a different thread than
    _finish_round)."""
    codec = zstd_entropy.get_codec()
    dev = mesh[0]
    ordereds = [raw.ordered(container.VERSION_2) for raw in raws]
    lengths_l = [
        np.frombuffer(o[5], "<u4").astype(np.int64) for o in ordereds
    ]
    seq_infos, seq_k = _plan_seq(ordereds, lengths_l, codec, seq_dict, mesh)
    qual_infos, qual_order = _plan_qual(
        ordereds, [raw.device_view(1) for raw in raws], lengths_l, codec, mesh
    )
    crcs = [native._crc_streams(o, dev) for o in ordereds]
    return {
        "raws": raws,
        "ordereds": ordereds,
        "lengths_l": lengths_l,
        "seq_infos": seq_infos,
        "seq_k": seq_k,
        "qual_infos": qual_infos,
        "qual_order": qual_order,
        "crcs": crcs,
    }


def _dispatch_round(plan, mesh):
    """Launch the round's device work and return the plan augmented with
    its finishers — the caller overlaps the device round with finishing
    the PREVIOUS round (result fetch + container writes).

    The seq/qual entropy stage runs on the devices with the v3 context
    models (ops/wctx.py) whenever their estimated size wins the
    per-stream empirical pick — order-0 rANS and host zstd/sldm remain
    candidates, so the mesh container is never bigger than the best
    backend available for each stream."""
    d = len(mesh)
    ordereds = plan["ordereds"]
    lengths_l = plan["lengths_l"]
    seq_infos = plan["seq_infos"]
    seq_k = plan["seq_k"]
    qual_infos = plan["qual_infos"]

    # --- device program 1: seq context coder
    # Job i is block i's (None where the coder does not run), so it runs
    # on mesh[i], the device its prepare pass left the symbols on.
    plan["seq_finish"] = None
    if seq_k is not None:
        jobs = [None] * len(seq_infos)
        for i, info in enumerate(seq_infos):
            est = info.get("est", {}).get(seq_k)
            # run the device coder whenever the estimate is within noise
            # of winning (1.02x); the final pick compares ACTUAL payload
            # sizes, so this gate only saves wasted launches
            if est is None or est >= (len(info["host"]) - 1) * 1.02:
                continue
            h = (
                seqctx.marginalize(info["hist6"], seq_k)
                if seq_k < seqctx.MAX_ORDER
                else info["hist6"]
            )
            jobs[i] = (info["bases"], lengths_l[i], h)
        if any(jobs):
            plan["seq_slots"] = range(len(jobs))
            plan["seq_finish"] = pmesh.wctx_encode_streams(
                jobs, wctx.MODEL_SEQ, seq_k, mesh, async_result=True
            )

    # --- device program 2: qual context coder
    plan["qw_finish"] = None
    q_order = plan["qual_order"]
    wjobs = [None] * len(qual_infos)
    for i, info in enumerate(qual_infos):
        if info["choice"] == "wctx":
            wjobs[i] = (info["raw"], lengths_l[i], info["hists"][q_order])
    if any(wjobs):
        plan["qw_slots"] = range(len(wjobs))
        plan["qw_finish"] = pmesh.wctx_encode_streams(
            wjobs, wctx.MODEL_QUAL, q_order, mesh, async_result=True
        )

    # --- device program 3: qual order-0 rANS (noisy quals with no
    # order-1 structure still beat zstd here)
    plan["qr_finish"] = None
    rjobs, rslots = [], []
    for i, info in enumerate(qual_infos):
        if info["choice"] == "rans":
            rjobs.append(ordereds[i][1])
            rslots.append(i)
    if rjobs:
        group = list(rjobs) + [b""] * (d - len(rjobs))
        plan["qr_slots"] = rslots
        plan["qr_finish"] = pmesh.entropy_encode_streams(
            group, mesh, async_result=True
        )
    return plan


def _finish_round(plan) -> list[bytes]:
    """Fetch the round's device results, pick per-stream winners by
    actual size, and assemble the v3 wire blocks. Thread-local codec
    (may run on a different thread than _plan_round)."""
    codec = zstd_entropy.get_codec()
    ordereds = plan["ordereds"]
    seq_infos = plan["seq_infos"]
    qual_infos = plan["qual_infos"]

    seq_out: list = [None] * len(ordereds)
    if plan["seq_finish"] is not None:
        for slot, pl in zip(plan["seq_slots"], plan["seq_finish"]()):
            if pl is not None and len(pl) + 1 < len(
                seq_infos[slot]["host"]
            ):
                seq_out[slot] = bytes([native.TAG_WCTX]) + pl
    for i, info in enumerate(seq_infos):
        if seq_out[i] is None:
            seq_out[i] = info["host"]

    qual_out: list = [None] * len(ordereds)
    if plan["qw_finish"] is not None:
        for slot, pl in zip(plan["qw_slots"], plan["qw_finish"]()):
            if pl is not None and len(pl) + 1 < len(
                qual_infos[slot]["host"]
            ):
                qual_out[slot] = bytes([native.TAG_WCTX]) + pl
    if plan["qr_finish"] is not None:
        for slot, pl in zip(plan["qr_slots"], plan["qr_finish"]()):
            if qual_out[slot] is None and len(pl) + 1 < len(
                qual_infos[slot]["host"]
            ):
                qual_out[slot] = bytes([native.TAG_RANS]) + pl
    for i, info in enumerate(qual_infos):
        if qual_out[i] is None:
            qual_out[i] = info["host"]

    out = []
    for bi, (raw, ordered) in enumerate(
        zip(plan["raws"], ordereds)
    ):
        # v3 wire: streams 0-2 are codec-tagged, 3-5 are raw zstd frames
        # (pipeline/native.py STREAM_CODECS + decode_block_payload)
        comp = [seq_out[bi], qual_out[bi]]
        gate = max(4096, (len(comp[0]) + len(comp[1])) >> 7)
        comp.append(
            native._encode_tagged_headers(
                ordered[2], raw.device_view(2), raw.num_records, codec, gate,
                raw.header_lengths,
            )
        )
        for s in ordered[3:]:
            comp.append(native._zstd_candidate(codec, s))
        hdr = container.BlockHeader(
            num_records=raw.num_records,
            seq_data_size=len(comp[0]),
            qual_data_size=len(comp[1]),
            header_data_size=len(comp[2]),
            plus_data_size=len(comp[3]),
            npositions_size=len(comp[4]),
            seq_lengths_size=len(comp[5]),
            original_seq_size=raw.original_seq_size,
            original_qual_size=raw.original_qual_size,
            crc32=plan["crcs"][bi],
        )
        out.append(
            hdr.to_bytes(container.VERSION_3_NATIVE) + b"".join(comp)
        )
    return out


def _encode_round(raws, mesh) -> list[bytes]:
    """Synchronous round encode (tests / simple callers)."""
    plan = _plan_round(raws, mesh)
    return _finish_round(_dispatch_round(plan, mesh))


def compress_mesh(
    r: BinaryIO,
    w: BinaryIO,
    opts: Optional[api.Options] = None,
    mesh=None,
) -> None:
    """Compress FASTQ from ``r`` into a standard FQZ v3 container whose
    seq/qual entropy stage ran on the devices of ``mesh`` (default: every
    CUDA card; one block per device per round). Decode with the ordinary
    ``fastqpacker_tpu_torch.decompress`` / CLI — nothing mesh-specific
    survives in the container.
    """
    opts = opts or api.Options()
    if opts.lossless:
        raise ValueError(
            "compress_mesh does not implement lossless mode; use the "
            "host v3 pipeline (Options(lossless=True))"
        )
    mesh = pmesh._resolve_mesh(mesh)
    d = len(mesh)
    dev = mesh[0]
    block_size = api.resolve_block_size(opts)

    parser = FastqStreamParser(r, block_size=block_size, device=dev)
    block_iter = parser.blocks()
    # Phred detection from the reference's fixed min(100k, file)-record
    # window regardless of -b (compress.go:48-52,137-154).
    peeked, qual_offset = api.peek_detection(block_iter)
    first_block = peeked[0] if peeked else None
    second_block = peeked[1] if len(peeked) > 1 else None
    if first_block is not None and second_block is None:
        # single-block containers gain nothing from a cross-block dict
        # (native.compress_native peeks the same way)
        for blk in block_iter:
            second_block = blk
            peeked.append(blk)
            break
    flags = opts.flags | (
        container.FLAG_PHRED64
        if qual_offset == refops.PHRED64_OFFSET
        else 0
    )
    # Cross-block sequence dictionary in mesh mode too: block 0's
    # coverage probe decides; the dict becomes the LDM prefix of every
    # TAG_SLDM candidate in _plan_seq. The container stays standard v3 —
    # the ordinary decoder reads the section; decompress_mesh routes
    # dict containers to it.
    seq_dict = None
    raw0 = None
    if (
        first_block is not None
        and first_block.n > 0
        and second_block is not None
    ):
        with devops.worker_stream(dev):
            raw0 = native._raw_streams(first_block, qual_offset)
        packed0 = np.frombuffer(raw0.seq, np.uint8)
        if sldm.coverage_probe(packed0) >= sldm.DUP_THRESHOLD:
            lens0 = np.frombuffer(raw0.lengths, "<u4").astype(np.int64)
            try:
                seq_dict = sldm.build_dict(packed0, lens0)
                flags |= container.FLAG_SEQ_DICT
            except ValueError:
                seq_dict = None
    container.FileHeader(
        version=container.VERSION_3_NATIVE,
        block_size=block_size,
        flags=flags,
    ).write(w)
    if seq_dict is not None:
        container.write_seq_dict_section(
            w, sldm.compress_dict(seq_dict), len(seq_dict)
        )
    if first_block is None:
        return

    def all_blocks():
        yield from peeked
        yield from block_iter

    # Three-stage software pipeline: a worker thread parses, stream-builds
    # AND plans (host zstd/sldm candidates, context histograms, CRCs)
    # round i+1 while round i runs on the devices and the main thread
    # finishes round i-1 (result fetch, container writes) — kernel
    # launches return before the device is done, so the devices never
    # wait for host bookkeeping.
    def build_and_plan(blks: list[RecordBlock]):
        with devops.worker_stream(dev):
            raws = [
                raw0
                if (blk is first_block and raw0 is not None)
                else native._raw_streams(blk, qual_offset)
                for blk in blks
            ]
            return _plan_round(raws, mesh, seq_dict)

    def rounds():
        group: list[RecordBlock] = []
        for blk in all_blocks():
            group.append(blk)
            if len(group) == d:
                yield group
                group = []
        if group:
            yield group

    with ThreadPoolExecutor(max_workers=1) as pool:
        build_fut = None
        inflight = None

        def advance(next_build):
            nonlocal build_fut, inflight
            if build_fut is not None:
                plan = _dispatch_round(build_fut.result(), mesh)
                if inflight is not None:
                    for payload in _finish_round(inflight):
                        w.write(payload)
                inflight = plan
            build_fut = next_build

        for group in rounds():
            advance(pool.submit(build_and_plan, group))
        advance(None)
        if inflight is not None:
            for payload in _finish_round(inflight):
                w.write(payload)


def compress_mesh_bytes(data: bytes, opts=None, mesh=None) -> bytes:
    out = io.BytesIO()
    compress_mesh(io.BytesIO(data), out, opts, mesh)
    return out.getvalue()


def decompress_mesh(
    r: BinaryIO, w: BinaryIO, mesh=None, fh=None, runtime_errors: bool = False
) -> None:
    """Decompress an FQZ v3 container with the entropy stage batched over
    the devices of ``mesh``: groups of D consecutive blocks whose seq/qual
    streams are all TAG_RANS with a shared frequency table, or all
    TAG_WCTX with one model, order and lane count (what ``compress_mesh``
    writes per round), decode as one group
    (``parallel.mesh.entropy_decode_streams`` / ``wctx_decode_streams``);
    anything else — mixed tables, other codec tags, dict/lossless
    containers — falls back to the ordinary per-block decoder. The block
    CRC32 checks cover the batched output, so a wrong batch decode fails
    exactly like corrupt data.

    A zstd frame or a tagged stream of a block payload that fails keeps the
    per-block decoders' string, as in the JAX package's ``decompress_mesh``;
    ``runtime_errors`` (the route of the default decoder,
    ``device.decompress_device``, which decides it for the whole file)
    raises it as that decoder does (``blocks.payload_zstd_errors``,
    ``blocks.runtime_stream_errors``).
    """
    # ``fh``: the caller (device.decompress_device's TAG_WCTX routing)
    # already consumed the file header from ``r``.
    opts_fh = fh if fh is not None else container.read_file_header(r)
    if opts_fh.version != container.VERSION_3_NATIVE:
        raise container.FormatError(
            "decompress_mesh requires an FQZ v3 container "
            f"(got version {opts_fh.version}); use the ordinary decoder"
        )
    mesh = pmesh._resolve_mesh(mesh)
    d = len(mesh)
    dev = mesh[0]
    qual_offset = (
        refops.PHRED64_OFFSET if opts_fh.phred64 else refops.PHRED33_OFFSET
    )
    if opts_fh.flags & (container.FLAG_SEQ_DICT | container.FLAG_LOSSLESS):
        # dict/lossless containers: the ordinary pipeline handles the
        # sections; re-dispatch with the header already consumed
        native.decompress_native(
            r, w, opts_fh, qual_offset, api._resolve_workers(0), dev
        )
        return
    codec = zstd_entropy.get_codec()

    def zstd_errors():
        return blockcodec.payload_zstd_errors(runtime_errors)

    def read_group():
        group = []
        while len(group) < d:
            hdr = container.read_block_header(
                r, container.VERSION_3_NATIVE
            )
            if hdr is None:
                break
            size = sum(hdr.stream_sizes(container.VERSION_2))
            payload = r.read(size)
            if len(payload) < size:
                raise container.FormatError("truncated block payload")
            group.append((hdr, payload))
        return group

    empty = struct.pack(rans.HEADER_FMT, 0, 0)

    def group_lengths(group):
        """Per-block record-length vectors (stream 5, plain zstd)."""
        out = []
        for hdr, payload in group:
            sizes = hdr.stream_sizes(container.VERSION_2)
            off = sum(sizes[:5])
            with zstd_errors():
                lb = codec.decompress(payload[off : off + sizes[5]])
            if len(lb) % 4:
                raise container.FormatError(
                    "truncated sequence length data"
                )
            out.append(np.frombuffer(lb, "<u4").astype(np.int64))
        return out

    while True:
        group = read_group()
        if not group:
            return
        pre = [dict() for _ in group]
        lens_cache = None
        for slot in (0, 1):
            chunks = []
            for hdr, payload in group:
                sizes = hdr.stream_sizes(container.VERSION_2)
                off = sum(sizes[:slot])
                chunks.append(payload[off : off + sizes[slot]])
            if all(c[:1] == bytes([native.TAG_RANS]) for c in chunks):
                payloads = [c[1:] for c in chunks] + [empty] * (
                    d - len(group)
                )
                with blockcodec.runtime_stream_errors(native.TAG_RANS, runtime_errors):
                    try:
                        decoded = pmesh.entropy_decode_streams(payloads, mesh)
                    except rans.RansError as e:
                        raise container.FormatError(str(e)) from None
                if decoded is None:
                    continue  # mixed tables/lanes: per-block path
                for i in range(len(group)):
                    pre[i][slot] = decoded[i]
            elif all(c[:1] == bytes([native.TAG_WCTX]) for c in chunks):
                # batched context decode: one launch per device for the
                # whole group's TAG_WCTX streams
                if lens_cache is None:
                    lens_cache = group_lengths(group)
                with blockcodec.runtime_stream_errors(native.TAG_WCTX, runtime_errors):
                    try:
                        # each stream comes back as its wire bytes
                        # (packed rows or quality deltas), built on its card
                        wires = pmesh.wctx_decode_streams(
                            [c[1:] for c in chunks], lens_cache, mesh, wire=True
                        )
                    except wctx.WctxError as e:
                        raise container.FormatError(str(e)) from None
                    if wires is None:
                        continue  # mixed models/lanes: per-block path
                    for i, wire in enumerate(wires[: len(group)]):
                        if wire is not None:
                            pre[i][slot] = wire.tobytes()
            # other/mixed codec tags in this group: per-block path
        with devops.worker_stream(dev):
            for (hdr, payload), p in zip(group, pre):
                with zstd_errors():
                    text = native.decode_block_payload(
                        hdr, payload, codec, qual_offset, dev,
                        predecoded=p or None, runtime=runtime_errors,
                    )
                w.write(text)
        if len(group) < d:
            return
