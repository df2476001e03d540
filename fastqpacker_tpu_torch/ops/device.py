"""Plain PyTorch versions of the dense block transforms, and their
numpy-facing adapters.

``encode_arrays_plain`` / ``decode_arrays_plain`` are tensor code with the
semantics of ``fastqpacker_tpu/ops/device.py``'s ``encode_arrays_jit`` /
``decode_arrays_jit``. They are what the kernel wrappers of
:mod:`.cuda_kernels` run on CPU tensors, and what the kernels are held
against on the card.

The adapters ``encode_block_arrays`` / ``decode_block_arrays`` take and
return host numpy arrays and run the transform on ``device`` through the
kernel wrappers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import reference as refops

_A, _C, _G, _T = 65, 67, 71, 84


class DenseEncoded(NamedTuple):
    """Encode outputs as tensors (mirrors refops.EncodedArrays)."""

    packed: torch.Tensor  # (R, ceil(L/4)) uint8
    nmask_bits: torch.Tensor  # (R, ceil(L/8)) uint8
    n_counts: torch.Tensor  # (R,) int32
    qual_delta: torch.Tensor  # (R, L) uint8


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without a card, a CUDA request raises; nothing drops to the
    CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(CLI: --backend cpu) to run on the CPU"
        )
    return dev


def _pack_fields(values: torch.Tensor, per_byte: int) -> torch.Tensor:
    """(R, L) small integers -> (R, ceil(L/per_byte)) bytes, field k of a
    byte at bits [k*bits, (k+1)*bits), LSB-first."""
    r, l = values.shape
    lp = -(-l // per_byte) * per_byte
    v = torch.zeros((r, lp), dtype=torch.int32, device=values.device)
    v[:, :l] = values
    bits = 8 // per_byte
    shifts = torch.arange(per_byte, device=values.device, dtype=torch.int32) * bits
    return (v.reshape(r, lp // per_byte, per_byte) << shifts).sum(
        dim=-1, dtype=torch.int32
    ).to(torch.uint8)


def encode_arrays_plain(
    seq: torch.Tensor,
    qual: torch.Tensor,
    lengths: torch.Tensor,
    qual_offset: int,
) -> DenseEncoded:
    """Dense block encode: base codes, 2-bit pack, ambiguity bitmask
    (length-limited, capped at the u16 tracking bound), per-record N
    counts and byte-wrapping quality deltas."""
    l = seq.shape[1]
    col = torch.arange(l, device=seq.device, dtype=torch.int32)[None, :]
    upper = seq & 0xDF
    is_c, is_g, is_t = upper == _C, upper == _G, upper == _T
    codes = is_c.to(torch.int32) + 2 * is_g.to(torch.int32) + 3 * is_t.to(torch.int32)
    valid = (upper == _A) | is_c | is_g | is_t
    nmask = (
        ~valid
        & (col < lengths[:, None])
        & (col < refops.MAX_SEQUENCE_LENGTH)
    )
    qn = qual - qual_offset  # uint8 arithmetic wraps mod 256
    prev = torch.zeros_like(qn)
    prev[:, 1:] = qn[:, :-1]
    return DenseEncoded(
        packed=_pack_fields(codes, 4),
        nmask_bits=_pack_fields(nmask.to(torch.int32), 8),
        n_counts=nmask.sum(dim=1, dtype=torch.int32),
        qual_delta=qn - prev,
    )


_ACGT = torch.tensor(list(b"ACGT"), dtype=torch.uint8)


def decode_arrays_plain(
    packed: torch.Tensor,
    qual_delta: torch.Tensor,
    lengths: torch.Tensor,
    qual_offset: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense block decode: packed codes -> ASCII ACGT, quality deltas ->
    per-row running sum + offset, mod 256. N restoration is the caller's
    (host) job; ``lengths`` is part of the signature only."""
    r, l = qual_delta.shape
    shifts = torch.arange(0, 8, 2, device=packed.device, dtype=torch.uint8)
    codes = ((packed[:, :, None] >> shifts) & 3).reshape(r, -1)[:, :l]
    seq = _ACGT.to(packed.device)[codes.long()]
    acc = torch.cumsum(qual_delta.to(torch.int64), dim=1) + qual_offset
    return seq, (acc & 0xFF).to(torch.uint8)


# ---------------------------------------------------------------------------
# numpy-facing adapters
# ---------------------------------------------------------------------------


def _to(dev: torch.device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def encode_block_arrays(
    seq: np.ndarray,
    qual: np.ndarray,
    lengths: np.ndarray,
    qual_offset: int,
    device=None,
) -> refops.EncodedArrays:
    """Host arrays in, host arrays out, the encode on ``device``."""
    from . import cuda_kernels

    dev = resolve_device(device)
    enc = cuda_kernels.encode_arrays(
        _to(dev, seq), _to(dev, qual), _to(dev, lengths.astype(np.int32)),
        qual_offset,
    )
    return refops.EncodedArrays(*(x.cpu().numpy() for x in enc))


def decode_block_arrays(
    packed: np.ndarray,
    qual_delta: np.ndarray,
    lengths: np.ndarray,
    qual_offset: int,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host arrays in, (seq ASCII, qual ASCII) host arrays out, the
    decode on ``device``."""
    from . import cuda_kernels

    dev = resolve_device(device)
    seq, qual = cuda_kernels.decode_arrays(
        _to(dev, packed), _to(dev, qual_delta),
        _to(dev, lengths.astype(np.int32)), qual_offset,
    )
    return seq.cpu().numpy(), qual.cpu().numpy()
