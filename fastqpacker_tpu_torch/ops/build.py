"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

Each source is compiled once, on first use, into a shared library with a
plain C interface under ``fastqpacker_tpu_torch/_build/`` (listed in
``.gitignore``) and loaded with ``ctypes``. The library name carries a hash
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

# C signatures of the exported launchers: every pointer and the stream are
# void*, every int an int; each returns the launch's cudaError_t.
SIGNATURES = {
    "dense_codec": {
        # seq, qual, lengths, packed, nmask, n_counts, qual_delta,
        # rows, width, qual_offset, stream
        "fq_dense_encode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        # packed, qual_delta, seq, qual, rows, width, qual_offset, stream
        "fq_dense_decode": [_P, _P, _P, _P, _I, _I, _I, _P],
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            info = _compile(name)
            lib = ctypes.CDLL(str(info.path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            builds[name] = info
            _libs[name] = lib
        return _libs[name]
