"""Chunk-parallel CRC32 (IEEE 802.3, reflected poly 0xEDB88320).

The port of ``fastqpacker_tpu/ops/crc32.py``. A CRC is serial per byte
stream, so the stream is cut into contiguous chunks of :data:`CHUNK` bytes,
every chunk's CRC is computed independently, and the chunk CRCs are joined
with the GF(2) identity ``crc(A||B) = shift(crc(A), len(B)) ^ crc(B)``,
where ``shift`` multiplies by ``x^(8*len(B))`` modulo the CRC polynomial
(the math of zlib's ``crc32_combine``). The stream's CRC is then the XOR
over chunks of ``shift(crc_i, bytes after chunk i)``, which is a parallel
reduction, done on the device.

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
# Bytes per chunk (per kernel thread); a multiple of 16. The kernel's time
# is one thread's serial walk over its chunk plus its GF(2) shift, so a
# short chunk is faster as long as the chunks still fill the card.
CHUNK = 256
MIN_DEVICE_BYTES = 16384

_M32 = 0xFFFFFFFF
_X0 = 0x80000000  # x^0 in the reflected representation
_X8 = 0x00800000  # x^8


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


def _x8n_modp(nbytes: int) -> int:
    """x^(8 * nbytes) mod P(x)."""
    p, q = _X0, _X8
    while nbytes:
        if nbytes & 1:
            p = _multmodp(q, p)
        q = _multmodp(q, q)
        nbytes >>= 1
    return p


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


def _x8n_modp_t(nbytes: torch.Tensor) -> torch.Tensor:
    """Elementwise :func:`_x8n_modp`; ``nbytes`` int64 >= 0."""
    p = torch.full_like(nbytes, _X0)
    q = torch.full_like(nbytes, _X8)
    n = nbytes.clone()
    for _ in range(max(int(nbytes.max().item()).bit_length(), 0)):
        p = torch.where((n & 1) != 0, _multmodp_t(q, p), p)
        q = _multmodp_t(q, q)
        n = n >> 1
    return p


def crc32_chunks_plain(data: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """CRC32 of ``data`` ((n,) uint8, n >= 1) -> (1,) int32 holding the u32
    bit pattern: table-driven CRC of each ``chunk``-byte piece, each shifted
    past the bytes after it, XOR-reduced."""
    dev = data.device
    n = data.numel()
    nchunks = -(-n // chunk)
    padded = torch.zeros(nchunks * chunk, dtype=torch.int64, device=dev)
    padded[:n] = data
    rows = padded.view(nchunks, chunk)
    start = torch.arange(nchunks, dtype=torch.int64, device=dev) * chunk
    lens = torch.clamp(n - start, max=chunk)
    table = _byte_table(dev)
    crc = torch.full((nchunks,), _M32, dtype=torch.int64, device=dev)
    full = n // chunk  # rows below this index are whole chunks
    for t in range(chunk):
        step = table[(crc ^ rows[:, t]) & 0xFF] ^ (crc >> 8)
        if full == nchunks:
            crc = step
        else:
            crc = torch.where(t < lens, step, crc)
    crc = crc ^ _M32
    after = n - start - lens
    part = torch.where(after > 0, _multmodp_t(_x8n_modp_t(after), crc), crc)
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    for i in range(32):  # XOR-reduce bit by bit (a sum's parity)
        total |= ((part >> i) & 1).sum().reshape(1) % 2 << i
    return (((total & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


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
