"""fqpack CLI of the PyTorch/CUDA port: compress and decompress FASTQ.

Same flag surface as ``fastqpacker_tpu/cli/fqpack.py`` (the reference CLI,
cmd/fqpack/main.go:65-101): ``fqpack [-d] [-i in] [-o out] [-c]
[-b blocksize] [-w workers] [-version] [-h]`` plus positional input/output
paths; stdin/stdout defaults; transparent gzip input in compress mode
only (main.go:123-174). ``--backend cuda`` (the default) runs the dense
block transforms on the card and fails without one; ``--backend cpu`` runs
their plain PyTorch versions.

Run as ``python -m fastqpacker_tpu_torch.cli.fqpack``.
"""

from __future__ import annotations

import argparse
import sys
from typing import BinaryIO, Callable

from .. import __version__
from ..format import container
from ..parser.fastq import FastqParseError
from ..pipeline import api, device
from ..utils import gzipio

BUFFER_SIZE = 1 << 20
NOT_PORTED = "not yet ported in fastqpacker_tpu_torch"


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fqpack",
        description="Fast FASTQ compression tool (PyTorch/CUDA)",
        add_help=False,
    )
    p.add_argument("-d", action="store_true", dest="decompress",
                   help="decompress mode")
    p.add_argument("-i", dest="input", default="",
                   help="input file (default: stdin)")
    p.add_argument("-o", dest="output", default="",
                   help="output file (default: stdout)")
    p.add_argument("-c", action="store_true", dest="to_stdout",
                   help="write to stdout (compress mode)")
    p.add_argument("-b", dest="block_size", type=int, default=0,
                   help="records per block (0 = auto: 37500)")
    p.add_argument("-w", dest="workers", type=int, default=0,
                   help="compression workers (default: NumCPU)")
    p.add_argument("-version", action="store_true", dest="show_version",
                   help="show version and exit")
    p.add_argument("-h", "--help", action="store_true", dest="show_help",
                   help="show help")
    p.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                   help="device for the dense block transforms")
    p.add_argument("--format", choices=["zstd", "native"], default="zstd",
                   dest="wire_format",
                   help="container flavor: zstd (fqpack-compatible v2); "
                        f"native (v3) is {NOT_PORTED}")
    # surfaces of the JAX package's CLI that this package does not have yet
    for flag, dest in (("--max-ratio", "max_ratio"), ("--lossless", "lossless"),
                       ("--mesh", "mesh")):
        p.add_argument(flag, action="store_true", dest=dest,
                       help=f"{NOT_PORTED}")
    p.add_argument("--pair", dest="pair", default="", help=f"{NOT_PORTED}")
    p.add_argument("positional", nargs="*", default=[])
    return p


def _unported(args) -> str | None:
    """The first requested surface this package does not have yet."""
    if args.positional and args.positional[0] in ("info", "check", "cat"):
        return args.positional[0]
    for flag, on in (
        ("--format native", args.wire_format == "native"),
        ("--max-ratio", args.max_ratio),
        ("--lossless", args.lossless),
        ("--mesh", args.mesh),
        ("--pair", bool(args.pair)),
    ):
        if on:
            return flag
    return None


def open_input(path: str, decompress: bool) -> tuple[BinaryIO, Callable[[], None]]:
    if path in ("", "-"):
        raw = sys.stdin.buffer
        if decompress:
            return raw, lambda: None
        return gzipio.wrap_input_maybe_gzip(path, raw), lambda: None
    try:
        f = open(path, "rb")
    except OSError as e:
        raise RuntimeError(f"cannot open input: {e}") from e
    if decompress:
        return f, f.close
    return gzipio.wrap_input_maybe_gzip(path, f), f.close


def open_output(path: str, to_stdout: bool) -> tuple[BinaryIO, Callable[[], None]]:
    if path in ("", "-") or to_stdout:
        out = sys.stdout.buffer
        return out, out.flush
    try:
        f = open(path, "wb", buffering=BUFFER_SIZE)
    except OSError as e:
        raise RuntimeError(f"cannot create output: {e}") from e
    return f, f.close


def execute(args, inp: BinaryIO, out: BinaryIO) -> None:
    if args.decompress:
        device.decompress_device(
            inp, out, api.DecompressOptions(workers=args.workers),
            device=args.backend,
        )
        return
    opts = api.Options(block_size=args.block_size, workers=args.workers)
    device.compress_device(inp, out, opts, device=args.backend)


def main(argv: list[str] | None = None) -> int:
    raw_argv = sys.argv[1:] if argv is None else argv
    if raw_argv and raw_argv[0] == "bench":
        print(f"error: bench is {NOT_PORTED}", file=sys.stderr)
        return 1
    parser = build_argparser()
    args = parser.parse_args(raw_argv)

    if args.show_help:
        parser.print_help(sys.stderr)
        return 0
    if args.show_version:
        print(f"fqpack version {__version__}")
        return 0
    missing = _unported(args)
    if missing:
        print(f"error: {missing} is {NOT_PORTED}", file=sys.stderr)
        return 1

    if args.positional:
        if not args.input:
            args.input = args.positional[0]
        if len(args.positional) > 1 and not args.output:
            args.output = args.positional[1]

    try:
        inp, close_in = open_input(args.input, args.decompress)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        out, close_out = open_output(args.output, args.to_stdout)
    except RuntimeError as e:
        close_in()
        print(f"error: {e}", file=sys.stderr)
        return 1

    try:
        execute(args, inp, out)
    except BrokenPipeError:
        # stdout consumer went away: the conventional 128+SIGPIPE status
        return 141
    except (container.FormatError, FastqParseError, ValueError,
            RuntimeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        close_out()
        close_in()
    return 0


if __name__ == "__main__":
    sys.exit(main())
