"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

Each source is compiled once, on first use, into a shared library with a
plain C interface under ``fastqpacker_tpu_torch/_build/`` (listed in
``.gitignore``) and loaded with ``ctypes``. :func:`load_all` starts one
``nvcc`` per source at the same time. The library name carries a hash
of the source and the flags, so an edited source is never served by a stale
build. There is no fallback: a missing toolkit or a failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C signatures of the exported launchers: every pointer and the stream are
# void*, every int an int, every long long a long long; each returns the
# launch's cudaError_t.
SIGNATURES = {
    "dense_codec": {
        # seq, qual, lengths, packed, nmask, n_counts, qual_delta,
        # rows, length, qual_offset, npos_cap, stream
        "fq_dense_encode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        # packed, qual_delta, seq, qual, rows, length, packed pitch,
        # qual_offset, stream
        "fq_dense_decode": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "rans_codec": {
        # data, n, steps, lanes, pad_sym, freq_cum, words, flags, states,
        # stream
        "fq_rans_encode": [_P, _L, _I, _I, _I, _P, _P, _P, _P, _P],
        # words, flags, m, tile_counts, tile_offsets, out, total, stream
        "fq_rans_compact": [_P, _P, _L, _P, _P, _P, _P, _P],
        # words, total_words, states, slot_tab, steps, lanes, out,
        # consumed, stream
        "fq_rans_decode": [_P, _L, _P, _P, _I, _I, _P, _P, _P],
    },
    "crc32": {
        # data, n, partials, ticket, out, stream
        "fq_crc32_chunks": [_P, _L, _P, _P, _P, _P],
    },
    "wctx_codec": {
        # sym, ctx, seg, tab, contexts, width, steps, lanes, words, flags,
        # states, status, stream
        "fq_wctx_encode": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
        # words, total_words, states, startm, seg, tab, contexts, width,
        # present, model, order, steps, lanes, out, info, stream
        "fq_wctx_decode": [_P, _L, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I,
                           _P, _P, _P],
    },
    "records": {
        # text, n, max_records, ctas, scratch, ticket, status, epoch,
        # offsets, qmin, info, stream
        "fq_records_scan": [_P, _L, _L, _I, _P, _P, _P, _L, _P, _P, _P, _P],
        # data, data_n, starts (or null), starts stride, lens, lens stride,
        # r, rows, width, fill, data2, data2_n, width2, out2 (or null),
        # tile_rows, ticket, status, epoch, out, stream
        "fq_rows_gather": [_P, _L, _P, _L, _P, _L, _L, _L, _L, _I, _P, _L, _L, _P,
                           _I, _P, _P, _L, _P, _P],
        # text, offsets, n, packed, packed pitch, qual_delta, qual pitch,
        # nmask, nmask pitch, n_counts, wide, six stream sizes,
        # tile_records, ticket, status, epoch, out, info, stream
        "fq_streams_build": [_P, _P, _L, _P, _L, _P, _L, _P, _L, _P, _I,
                             _L, _L, _L, _L, _L, _L, _I, _P, _P, _L, _P, _P, _P],
        # seq_rows, qual_rows, pitch, lengths, r, headers, headers_n,
        # headers tile, plus, plus_n, has_plus, plus tile, npos, npos_n, wide,
        # npos tile, len_n, seq_n, qual_n, checks, tile_records, scratch, out,
        # cap, info, ticket, status, epoch, stream
        "fq_fastq_assemble": [_P, _P, _L, _P, _L, _P, _L, _I, _P, _L, _I, _I, _P, _L,
                              _I, _I, _L, _L, _L, _I, _I, _P, _P, _L, _P, _P, _P,
                              _L, _P],
    },
    "ctxprep": {
        # delta, n, bounds, nrec, raw, hist, ticket, status, epoch, stream
        "fq_qctx_prepare": [_P, _L, _P, _L, _P, _P, _P, _P, _L, _P],
        # packed, packed_n, bounds, nrec, bases, hist, stream
        "fq_sctx_prepare": [_P, _L, _P, _L, _P, _P, _P],
        # syms (or null), bounds, lanes_tab, lanes, steps, model, order,
        # idx_map, pad_sym, sym_out, ctx_out, start_out, stream
        "fq_wctx_layout": [_P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P],
        # mat, bounds, nrec, lanes_tab, lanes, steps, present, npres, mode,
        # dst, fault, ticket, status, epoch, stream
        "fq_wctx_unlayout": [_P, _P, _L, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _L, _P],
    },
    "hist256": {
        # data (any alignment), n, ctas, acc, out, stream
        "fq_hist256": [_P, _L, _I, _P, _P, _P],
    },
    "tokens": {
        # data (any alignment), n, count, lens (or 0), lens stride, starts,
        # chain_info, maps, out, info, ticket, status, epoch, stream
        "fq_tok_encode": [_P, _L, _L, _P, _L, _P, _P, _P, _P, _P, _P, _P, _L, _P],
        # data, n, count, ops, recstart, maps, fin, agg, rbase, info,
        # ticket, status, epoch, stream
        "fq_tok_decode": [_P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _P],
        # the decode's second call: data .. info of its first call, out, stream
        "fq_tok_decode_write": [_P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "ctxcoder": {
        # syms, starts, plan (host int64), tab, model or order, words, flags,
        # states, counts, stream
        "fq_qctx_encode": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
        "fq_sctx_encode": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
        # words, starts, plan (host int64), fcum, contexts, model, checks,
        # alphabet (host u8, or 0), its symbols (0: the L2 route), the dense
        # route's tile, slot scratch (the L2 route's, or 0), out, info, stream
        "fq_qctx_decode": [_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P],
        # words, starts, plan (host int64), freq, order, out, info, stream
        "fq_sctx_decode": [_P, _P, _P, _P, _I, _P, _P, _P],
    },
}

# The second call of a kernel whose wrapper calls its library twice, with a
# host read between (the first call's name is the one counted).
SECOND_CALLS = {"fq_tok_decode_write": "fq_tok_decode"}

# Exported functions that launch nothing (each returns a cudaError_t too).
QUERIES = {
    "dense_codec": {
        # length, packed pitch, encode (1) or decode (0), out (five int32)
        "fq_dense_geometry": [_I, _I, _I, _P],
    },
    "crc32": {
        # bytes per span (one partial each)
        "fq_crc32_span_bytes": [],
    },
    "rans_codec": {
        # lanes, out (four int32)
        "fq_rans_decode_geometry": [_I, _P],
    },
    "wctx_codec": {
        # lanes, contexts, width, out (four int32)
        "fq_wctx_decode_geometry": [_I, _I, _I, _P],
    },
    "ctxcoder": {
        # symbols, model, tile -> the qctx dense route's shared bytes
        "fq_qctx_dense_bytes": [_I, _I, _I],
    },
    "hist256": {
        # n, misalignment (data address % 16), SMs -> CTAs of a launch
        "fq_hist256_ctas": [_L, _I, _I],
    },
    "tokens": {
        # n, count -> tiles of status words a call takes at most
        "fq_tok_tiles": [_L, _L],
        # n -> u64 words of a chain's tile maps
        "fq_tok_map_words": [_L],
        # bytes of a token's state, of a column's aggregate
        "fq_tok_state_bytes": [],
        "fq_tok_agg_bytes": [],
    },
}


@dataclass
class BuildInfo:
    """What one build did: the library, its seconds (0 when an existing
    build was loaded) and nvcc's output (the ``-Xptxas -v`` report)."""

    path: Path
    seconds: float
    log: str


_libs: dict[str, ctypes.CDLL] = {}
builds: dict[str, BuildInfo] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from csrc/ on first use"
    )


def _compile(name: str) -> BuildInfo:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return BuildInfo(out, seconds, log)


def _register(name: str, info: BuildInfo) -> None:
    lib = ctypes.CDLL(str(info.path))
    for fn, argtypes in {**SIGNATURES[name], **QUERIES.get(name, {})}.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    builds[name] = info
    _libs[name] = lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _register(name, _compile(name))
        return _libs[name]


def load_all() -> None:
    """Build every source that is not loaded yet, one ``nvcc`` each, all
    started together, and load the libraries."""
    with _lock:
        missing = [name for name in SIGNATURES if name not in _libs]
        if not missing:
            return
        with ThreadPoolExecutor(max_workers=len(missing)) as pool:
            infos = list(pool.map(_compile, missing))
        for name, info in zip(missing, infos):
            _register(name, info)
