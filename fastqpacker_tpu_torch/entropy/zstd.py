"""ctypes binding to the system libzstd for the FQZ v1/v2 entropy stage.

The port's own copy of the v1/v2 part of ``fastqpacker_tpu/entropy/zstd.py``
(the long-distance-matching profile and prefix references serve only FQZ v3
and are not carried). Frames must be byte-identical to that module's, or
the containers of the two packages differ: the same level, hash log,
checksum flag, probe and stored-frame rule.

The reference entropy stage is klauspost/compress zstd at ``SpeedFastest``
with frame checksums on (reference: internal/compress/compress.go:113-122);
``SpeedFastest`` corresponds to libzstd level 1. Any standard zstd frame is
interchangeable on the wire, so the containers stay readable by the Go
fqpack binary and vice versa.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
import threading

_lib = None
_lib_lock = threading.Lock()

# ZSTD_cParameter enum values (zstd.h, stable API).
_ZSTD_c_compressionLevel = 100
_ZSTD_c_hashLog = 102
_ZSTD_c_targetLength = 106
_ZSTD_c_checksumFlag = 201

_ZSTD_CONTENTSIZE_UNKNOWN = 2**64 - 1
_ZSTD_CONTENTSIZE_ERROR = 2**64 - 2

DEFAULT_LEVEL = 1  # SpeedFastest equivalent

# Level-1 tuning: hashLog 13 keeps the fast-strategy hash table at 32 KB at
# byte-equal output on every FASTQ stream; zstd clamps it for small inputs.
_FAST_HASH_LOG = 13

# compress_adaptive probe: sample this prefix at normal settings; if it
# stays above the ratio threshold the stream is treated as incompressible
# and coded with the accelerated context (targetLength acts as the fast
# strategy's acceleration factor).
_PROBE_BYTES = 128 << 10
_PROBE_MIN_STREAM = 1 << 20
_PROBE_INCOMPRESSIBLE = 0.97
_RAW_BLOCK_MAX = 128 << 10    # RFC8878 Block_Maximum_Size
_STORE_MAX_STREAM = 32 << 20  # keep frame window under decoder caps


def _store_raw_frame(mv) -> bytes | None:
    """Stored zstd frame (all raw blocks, RFC8878) with XXH64 checksum:
    magic, FHD 0xE4 (single-segment, 8-byte FCS, checksum), content in
    <=128 KB raw blocks, XXH64 low 32 bits. None when xxhash is absent
    (the probe path falls back to the accelerated real codec)."""
    try:
        import xxhash
    except ImportError:
        return None

    n = len(mv)
    if n == 0:
        return None
    parts = [b"\x28\xb5\x2f\xfd\xe4", struct.pack("<Q", n)]
    off = 0
    while True:
        bn = min(n - off, _RAW_BLOCK_MAX)
        last = 1 if off + bn >= n else 0
        parts.append(struct.pack("<I", (bn << 3) | last)[:3])
        parts.append(bytes(mv[off : off + bn]))
        off += bn
        if off >= n:
            break
    parts.append(struct.pack("<I", xxhash.xxh64(mv).intdigest() & 0xFFFFFFFF))
    return b"".join(parts)


class ZstdError(RuntimeError):
    pass


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        lib = ctypes.CDLL(name)
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_createCCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_createDCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeDCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
        lib.ZSTD_CCtx_setParameter.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.ZSTD_compress2.restype = ctypes.c_size_t
        lib.ZSTD_compress2.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.ZSTD_decompressDCtx.restype = ctypes.c_size_t
        lib.ZSTD_decompressDCtx.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        _lib = lib
        return lib


def _check(lib, code: int) -> int:
    if lib.ZSTD_isError(code):
        raise ZstdError(lib.ZSTD_getErrorName(code).decode())
    return code


def _src_view(data):
    """(object-to-keep-alive, pointer-arg, nbytes) for bytes-like input
    without copying: bytes pass as a borrowed pointer, writable buffers
    (numpy arrays, bytearrays) via from_buffer. Only non-contiguous or
    exotic readonly buffers fall back to a bytes copy."""
    if isinstance(data, bytes):
        return data, data, len(data)
    try:
        mv = memoryview(data).cast("B")
    except TypeError:
        data = bytes(data)
        return data, data, len(data)
    if not mv.readonly:
        buf = (ctypes.c_char * mv.nbytes).from_buffer(mv)
        return mv, buf, mv.nbytes
    data = mv.tobytes()
    return data, data, len(data)


class ZstdCodec:
    """One compression + decompression context pair: level 1, hash log
    13, frame checksums on.

    Contexts are not thread-safe, so each thread owns its own
    ``ZstdCodec`` (:func:`get_codec`) and reuses it across blocks.
    """

    def __init__(self):
        self._lib = _load()
        self._cctx = self._lib.ZSTD_createCCtx()
        self._dctx = self._lib.ZSTD_createDCtx()
        self._accel_cctx = None  # lazy, see compress_adaptive
        if not self._cctx or not self._dctx:
            raise ZstdError("failed to create zstd context")
        for param, val in (
            (_ZSTD_c_compressionLevel, DEFAULT_LEVEL),
            (_ZSTD_c_hashLog, _FAST_HASH_LOG),
            (_ZSTD_c_checksumFlag, 1),
        ):
            _check(
                self._lib,
                self._lib.ZSTD_CCtx_setParameter(self._cctx, param, val),
            )

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is None:
            return
        if getattr(self, "_cctx", None):
            lib.ZSTD_freeCCtx(self._cctx)
            self._cctx = None
        if getattr(self, "_accel_cctx", None):
            lib.ZSTD_freeCCtx(self._accel_cctx)
            self._accel_cctx = None
        if getattr(self, "_dctx", None):
            lib.ZSTD_freeDCtx(self._dctx)
            self._dctx = None

    def _compress_ctx(self, cctx, data) -> bytes:
        keep, src, nbytes = _src_view(data)
        bound = self._lib.ZSTD_compressBound(nbytes)
        dst = ctypes.create_string_buffer(bound)
        n = _check(
            self._lib,
            self._lib.ZSTD_compress2(
                cctx, dst, bound, src if nbytes else None, nbytes
            ),
        )
        del keep
        # string_at copies only the n output bytes; dst.raw[:n] would
        # materialize the whole compressBound-sized buffer first
        return ctypes.string_at(dst, n)

    def compress_adaptive(self, data) -> bytes:
        """Compress, accelerating streams a sampled probe shows to be
        incompressible (e.g. 2-bit packed high-entropy DNA, where the
        match search is pure waste). Output is always a standard zstd
        frame; only the search effort varies, so interop and decode are
        unaffected. Small streams skip the probe."""
        mv = data if isinstance(data, bytes) else memoryview(data).cast("B")
        if len(mv) < _PROBE_MIN_STREAM:
            return self._compress_ctx(self._cctx, data)
        probe = self._compress_ctx(self._cctx, mv[:_PROBE_BYTES])
        if len(probe) < _PROBE_INCOMPRESSIBLE * _PROBE_BYTES:
            return self._compress_ctx(self._cctx, data)
        if len(mv) <= _STORE_MAX_STREAM:
            # incompressible stream -> stored raw-block frame at memcpy
            # speed (any standard decoder reads it)
            frame = _store_raw_frame(mv)
            if frame is not None:
                return frame
        if self._accel_cctx is None:
            cctx = self._lib.ZSTD_createCCtx()
            if not cctx:
                raise ZstdError("failed to create zstd context")
            for param, val in (
                (_ZSTD_c_compressionLevel, DEFAULT_LEVEL),
                (_ZSTD_c_hashLog, _FAST_HASH_LOG),
                (_ZSTD_c_targetLength, 1024),
                (_ZSTD_c_checksumFlag, 1),
            ):
                _check(
                    self._lib,
                    self._lib.ZSTD_CCtx_setParameter(cctx, param, val),
                )
            self._accel_cctx = cctx
        return self._compress_ctx(self._accel_cctx, data)

    def decompress(self, data) -> bytes:
        """Decompress a single zstd frame (frame checksum verified)."""
        keep, src, nbytes = _src_view(data)
        if nbytes == 0:
            return b""
        size = self._lib.ZSTD_getFrameContentSize(src, nbytes)
        guessed = size in (_ZSTD_CONTENTSIZE_UNKNOWN, _ZSTD_CONTENTSIZE_ERROR)
        if guessed:  # no declared content size: grow a guessed buffer
            size = max(4 * nbytes, 1 << 16)
        while True:
            dst = ctypes.create_string_buffer(max(size, 1))
            code = self._lib.ZSTD_decompressDCtx(
                self._dctx, dst, size, src, nbytes
            )
            if self._lib.ZSTD_isError(code):
                name = self._lib.ZSTD_getErrorName(code).decode()
                # Grow ONLY when the size was a guess and within a sane
                # cap: corrupt frames can report dstSize_tooSmall forever,
                # and each retry zeroes a 4x larger buffer — a hang.
                if "too small" in name.lower() and guessed and size < (1 << 31):
                    size *= 4
                    continue
                raise ZstdError(name)
            del keep
            return ctypes.string_at(dst, code)


_tls = threading.local()


def get_codec() -> ZstdCodec:
    """Thread-local codec instance (one per worker thread)."""
    codec = getattr(_tls, "codec", None)
    if codec is None:
        codec = ZstdCodec()
        _tls.codec = codec
    return codec
