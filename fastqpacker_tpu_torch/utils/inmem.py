"""Zero-copy views of addressable byte sources.

The port's copy of ``fastqpacker_tpu/utils/inmem.py``. The decode routing
of :mod:`..pipeline.device` sniffs the first block of a v3 container, so it
wants the source as one contiguous buffer: BytesIO exposes its internal
buffer, regular files are mmap'd. Pipes, sockets, gzip wrappers, and peek wrappers
return ``None`` and stay on the streaming path.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Optional


def source_view(r: BinaryIO) -> Optional[memoryview]:
    """Memoryview over ``r``'s remaining bytes (from the current position),
    or ``None`` if the source is not addressable. On success the reader is
    advanced to EOF — the view replaces reads. For file sources the mmap
    is kept alive by the returned view itself.
    """
    if isinstance(r, io.BytesIO):
        # getvalue(), not getbuffer(): on a bytes-constructed BytesIO the
        # init bytes are shared copy-on-write, so getvalue() is free while
        # getbuffer() copies the whole buffer to unshare it. A later write
        # to the BytesIO unshares without touching our view.
        pos = r.tell()
        mv = memoryview(r.getvalue())
        r.seek(0, io.SEEK_END)
        return mv[pos:] if pos else mv
    if isinstance(r, io.BufferedReader) and isinstance(
        getattr(r, "raw", None), io.FileIO
    ):
        import mmap
        import os
        import stat

        try:
            st = os.fstat(r.fileno())
            if not stat.S_ISREG(st.st_mode) or st.st_size == 0:
                return None
            pos = r.tell()
            mm = mmap.mmap(r.fileno(), 0, access=mmap.ACCESS_READ)
            # Cold-cache files: tell the kernel we will stream the whole
            # mapping so readahead runs ahead of the readers.
            try:
                mm.madvise(mmap.MADV_SEQUENTIAL)
                mm.madvise(mmap.MADV_WILLNEED)
            except (AttributeError, OSError):
                pass
        except (OSError, ValueError):
            return None
        r.seek(0, io.SEEK_END)
        mv = memoryview(mm)
        return mv[pos:] if pos else mv
    return None
