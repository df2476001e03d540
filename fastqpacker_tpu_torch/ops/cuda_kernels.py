"""Wrappers of the dense codec's Hopper kernels (``csrc/dense_codec.cu``).

``encode_arrays`` replaces ``fastqpacker_tpu/ops/pallas_kernels.py``'s
``encode_arrays_pallas`` and ``decode_arrays`` its ``decode_arrays_pallas``
(and the XLA twins in ``fastqpacker_tpu/ops/device.py``). Each checks its
tensors, allocates the outputs on their device and launches on the current
CUDA stream. A CPU tensor goes to the plain PyTorch version
(:mod:`.device`); a CUDA tensor launches the kernel or raises.

``launches`` counts kernel launches per kernel, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import threading

import torch

from . import build
from .device import DenseEncoded, decode_arrays_plain, encode_arrays_plain

ENCODE = "fq_dense_encode"
DECODE = "fq_dense_decode"

launches = {ENCODE: 0, DECODE: 0}
_launch_lock = threading.Lock()  # pipeline workers launch concurrently


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_offset(qual_offset: int) -> None:
    if not 0 <= qual_offset <= 255:
        raise ValueError(f"qual_offset must be a byte, got {qual_offset}")


def _fit_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with exactly ``width`` columns: zero-padded or cut, contiguous
    and 16-byte aligned (a fresh allocation whenever it changes)."""
    if x.shape[1] == width:
        return x
    out = torch.zeros((x.shape[0], width), dtype=x.dtype, device=x.device)
    k = min(width, x.shape[1])
    out[:, :k] = x[:, :k]
    return out


def _launch(name: str, device: torch.device, *args) -> None:
    for a in args:
        if isinstance(a, torch.Tensor) and a.data_ptr() % 16:
            raise ValueError(f"{name}: tensor storage is not 16-byte aligned")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    lib = build.load("dense_codec")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        with _launch_lock:
            rc = getattr(lib, name)(*ptrs, stream)
            if rc != 0:
                raise RuntimeError(f"{name} failed to launch: cudaError_t {rc}")
            launches[name] += 1


def _plain_or_cuda(dev: torch.device) -> bool:
    """True for a CPU tensor (plain version); a CUDA tensor launches the
    kernel; any other device is refused."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {dev}")
    return dev.type == "cpu"


def encode_arrays(
    seq: torch.Tensor,
    qual: torch.Tensor,
    lengths: torch.Tensor,
    qual_offset: int,
) -> DenseEncoded:
    """Dense block encode of (R, L) uint8 seq/qual and (R,) int32 lengths."""
    r, l = seq.shape
    dev = seq.device
    _check("seq", seq, torch.uint8, (r, l), dev)
    _check("qual", qual, torch.uint8, (r, l), dev)
    _check("lengths", lengths, torch.int32, (r,), dev)
    _check_offset(qual_offset)
    if _plain_or_cuda(dev):
        return encode_arrays_plain(seq, qual, lengths, qual_offset)
    w = -(-l // 16) * 16
    seq_w, qual_w = _fit_cols(seq, w), _fit_cols(qual, w)
    packed = torch.empty((r, w // 4), dtype=torch.uint8, device=dev)
    nmask = torch.empty((r, w // 8), dtype=torch.uint8, device=dev)
    n_counts = torch.empty((r,), dtype=torch.int32, device=dev)
    delta = torch.empty((r, w), dtype=torch.uint8, device=dev)
    if r:
        _launch(ENCODE, dev, seq_w, qual_w, lengths, packed, nmask, n_counts,
                delta, r, w, qual_offset)
    return DenseEncoded(
        packed[:, : -(-l // 4)], nmask[:, : -(-l // 8)], n_counts, delta[:, :l]
    )


def decode_arrays(
    packed: torch.Tensor,
    qual_delta: torch.Tensor,
    lengths: torch.Tensor,
    qual_offset: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense block decode: (R, >= ceil(L/4)) packed and (R, L) deltas ->
    (R, L) ASCII bases and qualities."""
    r, l = qual_delta.shape
    dev = qual_delta.device
    if packed.shape[0] != r or packed.shape[1] < -(-l // 4):
        raise ValueError(
            f"packed: expected ({r}, >= {-(-l // 4)}), got {tuple(packed.shape)}"
        )
    _check("packed", packed, torch.uint8, packed.shape, dev)
    _check("qual_delta", qual_delta, torch.uint8, (r, l), dev)
    _check("lengths", lengths, torch.int32, (r,), dev)
    _check_offset(qual_offset)
    if _plain_or_cuda(dev):
        return decode_arrays_plain(packed, qual_delta, lengths, qual_offset)
    w = -(-l // 16) * 16
    packed_w, delta_w = _fit_cols(packed, w // 4), _fit_cols(qual_delta, w)
    seq = torch.empty((r, w), dtype=torch.uint8, device=dev)
    qual = torch.empty((r, w), dtype=torch.uint8, device=dev)
    if r:
        _launch(DECODE, dev, packed_w, delta_w, seq, qual, r, w, qual_offset)
    return seq[:, :l], qual[:, :l]
