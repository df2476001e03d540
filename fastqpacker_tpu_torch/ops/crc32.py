"""Chunk-parallel CRC32 (IEEE 802.3, reflected poly 0xEDB88320).

The port of ``fastqpacker_tpu/ops/crc32.py``. A CRC is serial per byte
stream, so the stream is cut into contiguous chunks of :data:`CHUNK` bytes,
the last one filled up with zero bytes, and every chunk's raw CRC (state 0,
no final XOR) is computed independently. Raw CRCs are linear:
``raw(A||B) = shift(raw(A), len(B)) ^ raw(B)``, where ``shift`` multiplies
by ``x^(8*len(B))`` modulo the CRC polynomial (the math of zlib's
``crc32_combine``). Every chunk is whole, so the chunks combine in a binary
tree whose level l shifts by the constant ``CHUNK * 2^l`` bytes. Two
constants of the stream's length finish it: the zeros that filled the last
chunk are shifted out again by ``x^(-8t)`` (``x`` is invertible modulo the
polynomial), and ``shift(0xFFFFFFFF, n) ^ 0xFFFFFFFF`` turns the raw CRC
into zlib's (initial state and final XOR).

The Hopper kernel is ``csrc/crc32.cu`` (wrapper
:func:`..ops.cuda_kernels.crc32_chunks`); :func:`crc32_chunks_plain` is its
plain PyTorch version. The result equals ``zlib.crc32`` for every input.

Size rule (kept from the JAX package, ``crc32.py:126-127``): a stream below
:data:`MIN_DEVICE_BYTES` is too small to fan out and goes to ``zlib`` on
the host.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from .device import resolve_device, to_device

POLY = 0xEDB88320
# Bytes per chunk (per kernel thread): csrc/crc32.cu's kChunk, a multiple
# of 16. The result does not depend on it.
CHUNK = 256
# Chunks per CTA span (csrc/crc32.cu's kThreads): a warp combines 32 chunks,
# a CTA 128, and the last CTA the spans.
CTA_CHUNKS = 128
MIN_DEVICE_BYTES = 16384

_M32 = 0xFFFFFFFF
_X0 = 0x80000000  # x^0 in the reflected representation
_X8 = 0x00800000  # x^8
# x^-1 mod P(x): x * (P(x) - 1) / x = P(x) - 1 = 1 in GF(2)[x] / P(x)
_XINV = ((POLY << 1) | 1) & _M32


# ---------------------------------------------------------------------------
# GF(2) arithmetic on Python ints (host combine of a few streams)
# ---------------------------------------------------------------------------


def _multmodp(a: int, b: int) -> int:
    """a(x) * b(x) mod P(x), reflected representation."""
    p = 0
    m = _X0
    while m:
        if a & m:
            p ^= b
        m >>= 1
        b = (b >> 1) ^ POLY if b & 1 else b >> 1
    return p


def _pow_modp(a: int, e: int) -> int:
    """a(x)^e mod P(x)."""
    p = _X0
    while e:
        if e & 1:
            p = _multmodp(a, p)
        a = _multmodp(a, a)
        e >>= 1
    return p


def _x8n_modp(nbytes: int) -> int:
    """x^(8 * nbytes) mod P(x)."""
    return _pow_modp(_X8, nbytes)


def finish_constants(n: int, padded: int) -> tuple[int, int]:
    """The two constants that turn the raw CRC of ``n`` bytes followed by
    ``padded - n`` zero bytes into ``zlib.crc32`` of the ``n`` bytes:
    ``crc = multmodp(unshift, raw) ^ xor``."""
    unshift = _pow_modp(_XINV, 8 * (padded - n))
    return unshift, _multmodp(_x8n_modp(n), _M32) ^ _M32


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of A||B from crc32(A), crc32(B), len(B)."""
    if len2 == 0:
        return crc1 & _M32
    return (_multmodp(_x8n_modp(int(len2)), int(crc1) & _M32) ^ int(crc2)) & _M32


# ---------------------------------------------------------------------------
# Plain PyTorch version of the device program
# ---------------------------------------------------------------------------


def _byte_table(dev: torch.device) -> torch.Tensor:
    c = torch.arange(256, dtype=torch.int64, device=dev)
    for _ in range(8):
        c = torch.where((c & 1) != 0, (c >> 1) ^ POLY, c >> 1)
    return c


def _multmodp_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise :func:`_multmodp` on int64 tensors."""
    p = torch.zeros_like(b)
    for i in range(32):
        p = torch.where((a & (_X0 >> i)) != 0, p ^ b, p)
        b = torch.where((b & 1) != 0, (b >> 1) ^ POLY, b >> 1)
    return p


def crc32_chunks_plain(data: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """CRC32 of ``data`` ((n,) uint8, n >= 1) -> (1,) int32 holding the u32
    bit pattern: the raw CRC of each ``chunk``-byte piece (the last filled
    with zeros), combined in a binary tree of constant shifts counted from
    the stream's end, then :func:`finish_constants`."""
    dev = data.device
    n = data.numel()
    nchunks = -(-n // chunk)
    padded = torch.zeros(nchunks * chunk, dtype=torch.int64, device=dev)
    padded[:n] = data
    rows = padded.view(nchunks, chunk)
    table = _byte_table(dev)
    raw = torch.zeros(nchunks, dtype=torch.int64, device=dev)
    for t in range(chunk):
        raw = table[(raw ^ rows[:, t]) & 0xFF] ^ (raw >> 8)
    # leaf e is the e-th chunk from the end; leaves past the start are zero
    # (leading zeros leave a raw CRC as it is)
    leaves = 1 << (nchunks - 1).bit_length()
    v = torch.zeros(leaves, dtype=torch.int64, device=dev)
    v[:nchunks] = raw.flip(0)
    q = _x8n_modp(chunk)  # level l shifts by chunk * 2^l bytes
    while v.numel() > 1:
        v = v[0::2] ^ _multmodp_t(torch.full_like(v[1::2], q), v[1::2])
        q = _multmodp(q, q)
    unshift, xor = finish_constants(n, nchunks * chunk)
    crc = _multmodp(unshift, int(v[0].item())) ^ xor
    return torch.tensor([(crc ^ 0x80000000) - 0x80000000], dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# Host-facing API
# ---------------------------------------------------------------------------


def crc32_device(data: bytes | np.ndarray, device=None) -> int:
    """CRC32 of ``data`` computed chunk-parallel on ``device`` (default: the
    CUDA card); streams below :data:`MIN_DEVICE_BYTES` go to zlib."""
    from . import cuda_kernels

    dev = resolve_device(device)
    raw = (
        np.frombuffer(data, np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else data
    )
    n = len(raw)
    if n == 0:
        return 0
    if n < MIN_DEVICE_BYTES:
        return zlib.crc32(raw.tobytes()) & _M32  # too small to fan out
    return int(cuda_kernels.crc32_chunks(to_device(dev, raw)).item()) & _M32
