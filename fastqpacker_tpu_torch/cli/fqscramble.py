"""fqscramble CLI of the PyTorch/CUDA port: anonymize FASTQ for benchmarking.

The port of ``fastqpacker_tpu/cli/fqscramble.py``. Shuffles bases within
each read, preserving base composition, quality distribution, read lengths
and headers while destroying genomic content, with a seeded RNG for
reproducibility (reference: cmd/fqscramble/main.go).

The default mode is **byte-identical to the Go tool**: the same
``rand.NewPCG(seed, seed)`` PCG-DXSM stream, ``rand.Shuffle`` Fisher-Yates
with Lemire bounded ints, and the same 4-line state machine
(main.go:72,111-158), run by :mod:`..utils.gopcg` (pure Python; the port has
no C++ runtime). ``--fast`` selects the legacy vectorized mode instead
(argsort of masked random keys per padded batch), RNG-divergent from the
reference. Host only: no device program runs here.

Run as ``python -m fastqpacker_tpu_torch.cli.fqscramble``.
"""

from __future__ import annotations

import argparse
import gzip
import io
import sys
from typing import BinaryIO

import numpy as np

from ..parser.fastq import FastqStreamParser
from ..utils import gopcg


def scramble_stream_pcg(
    r: BinaryIO, w: BinaryIO, seed: int = 42, chunk_bytes: int = 64 << 20
) -> None:
    """Go-fqscramble-exact scramble (default mode): stream in chunks cut
    at 4-line-group boundaries, carrying the PCG state across chunks."""
    rng = gopcg.GoPCG(seed, seed)
    pending = b""
    while True:
        chunk = r.read(chunk_bytes)
        if not chunk:
            break
        buf = pending + chunk
        # cut after the last complete 4-line group (groups are framed by
        # newline count; the remainder carries into the next chunk)
        nl = np.flatnonzero(np.frombuffer(buf, np.uint8) == 10)
        complete_groups = len(nl) // 4
        if complete_groups == 0:
            pending = buf
            continue
        cut = int(nl[4 * complete_groups - 1]) + 1
        part, pending = buf[:cut], buf[cut:]
        w.write(gopcg.scramble_text(part, seed, rng))
    if pending:
        w.write(gopcg.scramble_text(pending, seed, rng))


def scramble_stream(
    r: BinaryIO, w: BinaryIO, seed: int = 42, block_size: int = 20000
) -> None:
    """Legacy vectorized scramble (``--fast``): not byte-compatible with
    the Go tool's PCG stream (use the default mode for that)."""
    rng = np.random.default_rng(seed)
    parser = FastqStreamParser(r, block_size=block_size)
    for blk in parser.blocks():
        if blk.n == 0:
            continue
        L = blk.max_len
        lengths = blk.lengths.astype(np.int64)
        if L > 0:
            keys = rng.random((blk.n, L))
            col = np.arange(L, dtype=np.int64)[None, :]
            keys[col >= lengths[:, None]] = 2.0  # padding sorts last
            perm = np.argsort(keys, axis=1, kind="stable")
            shuffled = np.take_along_axis(blk.seq, perm, axis=1)
        else:
            shuffled = blk.seq

        out = io.BytesIO()
        for i in range(blk.n):
            h, _, p, q = blk.record(i)
            ln = int(lengths[i])
            out.write(b"@" + h + b"\n")
            out.write(shuffled[i, :ln].tobytes() + b"\n")
            out.write(b"+" + p + b"\n")
            out.write(q + b"\n")
        w.write(out.getvalue())


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="fqscramble",
        description="Scramble FASTQ files for privacy-preserving benchmarks",
    )
    p.add_argument("-i", dest="input", default="",
                   help="input FASTQ file (supports .gz)")
    p.add_argument("-o", dest="output", default="",
                   help="output FASTQ file (default: stdout)")
    p.add_argument("-seed", "--seed", type=int, default=42,
                   help="random seed for reproducibility")
    p.add_argument("--fast", action="store_true",
                   help="legacy vectorized shuffle (faster, but NOT "
                        "byte-identical to the Go tool's PCG stream)")
    p.add_argument("positional", nargs="*", default=[])
    args = p.parse_args(argv)

    if not args.input and args.positional:
        args.input = args.positional[0]

    if args.input in ("", "-"):
        inp: BinaryIO = sys.stdin.buffer
        close_in = lambda: None  # noqa: E731
    else:
        f = open(args.input, "rb")
        if args.input.endswith(".gz"):
            inp = gzip.GzipFile(fileobj=f)  # type: ignore[assignment]
        else:
            inp = f
        close_in = f.close

    if args.output in ("", "-"):
        out: BinaryIO = sys.stdout.buffer
        close_out = out.flush
    else:
        fo = open(args.output, "wb")
        out = fo
        close_out = fo.close

    try:
        if args.fast:
            scramble_stream(inp, out, seed=args.seed)
        else:
            scramble_stream_pcg(inp, out, seed=args.seed)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        close_out()
        close_in()
    return 0


if __name__ == "__main__":
    sys.exit(main())
