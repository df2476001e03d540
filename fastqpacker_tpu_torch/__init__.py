"""fastqpacker_tpu_torch: the PyTorch/CUDA port of fastqpacker_tpu.

FQZ v1/v2 (fqpack-compatible, zstd) and FQZ v3 (native: per-stream codec
picks, order-0 rANS, block CRC32) compress and decompress, with the dense
block transforms, the rANS coder and the CRC32 as hand-written CUDA kernels
for Hopper (``csrc/*.cu``). Containers are byte-identical to the JAX
package's. Every entry point runs on the CUDA card unless the caller passes
``device="cpu"``; without a card it raises.

Public API::

    from fastqpacker_tpu_torch import compress, decompress, Options
"""

from __future__ import annotations

import io
from typing import Optional

from .utils import malloc_tuning as _malloc_tuning

_malloc_tuning.tune()

from .format import container  # noqa: E402
from .pipeline.api import DEFAULT_BLOCK_SIZE, DecompressOptions, Options  # noqa: E402
from .pipeline.device import compress_device, decompress_device  # noqa: E402

__version__ = "0.1.0"

compress = compress_device
decompress = decompress_device


def compress_bytes(
    data: bytes, opts: Optional[Options] = None, device=None
) -> bytes:
    out = io.BytesIO()
    compress(io.BytesIO(data), out, opts, device=device)
    return out.getvalue()


def decompress_bytes(
    data: bytes, opts: Optional[DecompressOptions] = None, device=None
) -> bytes:
    out = io.BytesIO()
    decompress(io.BytesIO(data), out, opts, device=device)
    return out.getvalue()


__all__ = [
    "DEFAULT_BLOCK_SIZE",
    "DecompressOptions",
    "Options",
    "compress",
    "compress_bytes",
    "container",
    "decompress",
    "decompress_bytes",
    "__version__",
]
