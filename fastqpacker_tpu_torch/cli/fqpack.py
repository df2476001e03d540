"""fqpack CLI of the PyTorch/CUDA port: compress and decompress FASTQ.

Same flag surface as ``fastqpacker_tpu/cli/fqpack.py`` (the reference CLI,
cmd/fqpack/main.go:65-101): ``fqpack [-d] [-i in] [-o out] [-c]
[-b blocksize] [-w workers] [-version] [-h]`` plus positional input/output
paths; stdin/stdout defaults; transparent gzip input in compress mode
only (main.go:123-174). ``--format native`` writes the FQZ v3 container
(per-stream codec picks, order-0 rANS, block CRC32); ``--max-ratio`` and
``--lossless`` imply it. ``--mesh`` writes v3 with the seq/qual entropy
stage on the devices (context coder ``TAG_WCTX`` or order-0 rANS, one block
per device per round: every card with ``--backend cuda``, one CPU entry with
``--backend cpu``); ``-d --mesh`` decodes such rounds as groups. ``--pair``
interleaves an R2 mate file on compress and splits it back on decompress.
Subcommands: ``info FILE`` (header and stream accounting), ``check FILE``
(decode every block, write nothing), ``cat FILE -r START:STOP`` (decode
only the blocks that cover a record range) and ``bench [...]`` (the port's
benchmark, :mod:`..bench`: one metric, one JSON line). ``--backend cuda``
(the default) runs the device programs on the card and fails without one;
``--backend cpu`` runs their plain PyTorch versions; ``--backend auto``
asks the transfer probe (:mod:`..pipeline.auto`) once and prints its
choice and the reason on stderr (``backend auto: cuda (transfer N MB/s)``).

Run as ``python -m fastqpacker_tpu_torch.cli.fqpack``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import BinaryIO, Callable

from .. import __version__
from ..format import container
from ..parser.fastq import FastqParseError
from ..parallel import mesh as pmesh
from ..pipeline import api, device, meshpipe
from ..utils import gzipio

BUFFER_SIZE = 1 << 20


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
                   help="records per block (0 = auto: 37500 zstd / "
                        "100000 native)")
    p.add_argument("-w", dest="workers", type=int, default=0,
                   help="compression workers (default: NumCPU)")
    p.add_argument("-version", action="store_true", dest="show_version",
                   help="show version and exit")
    p.add_argument("-h", "--help", action="store_true", dest="show_help",
                   help="show help")
    p.add_argument("--backend", choices=["cuda", "cpu", "auto"], default="cuda",
                   help="device for the kernels (dense transforms, rANS, "
                        "context rANS, CRC32); auto: the card when its "
                        "transfer probe says so, else the CPU (printed)")
    p.add_argument("--format", choices=["zstd", "native"], default="zstd",
                   dest="wire_format",
                   help="container flavor: zstd (fqpack-compatible v2) or "
                        "native (rANS v3)")
    p.add_argument("--max-ratio", action="store_true", dest="max_ratio",
                   help="prefer ratio over speed: context-modeled quality "
                        "coding and zstd level 9 (implies --format native)")
    p.add_argument("--lossless", action="store_true", dest="lossless",
                   help="strictly lossless: preserve lowercase bases and "
                        "exotic symbols verbatim (implies --format native)")
    p.add_argument("--mesh", action="store_true", dest="mesh",
                   help="compress v3 with the entropy stage on the devices "
                        "(TAG_WCTX / TAG_RANS seq/qual streams, one block "
                        "per device per round; implies --format native). "
                        "Decode needs no special flag.")
    p.add_argument("--pair", dest="pair", default="",
                   help="paired-end mate file: on compress, the R2 input "
                        "(records interleave R1,R2,...; sets FlagPairedEnd); "
                        "on decompress, the R2 output (-o/-c gets R1)")
    p.add_argument("-r", "--records", dest="records", default="",
                   help="record range START:STOP for the cat subcommand "
                        "(0-based, half-open; either side may be empty)")
    p.add_argument("positional", nargs="*", default=[])
    return p


def _parse_record_range(spec: str) -> tuple[int, int | None]:
    if not spec:
        return 0, None
    head, sep, tail = spec.partition(":")
    try:
        start = int(head) if head else 0
        stop = int(tail) if tail else None
        if not sep and head:  # bare N means the single record N
            stop = start + 1
    except ValueError:
        raise RuntimeError(f"invalid record range: {spec!r}") from None
    if start < 0 or (stop is not None and stop < start):
        raise RuntimeError(f"invalid record range: {spec!r}")
    return start, stop


def cat(target: str, records: str, out: BinaryIO, device=None) -> int:
    """Random-access decode of a record sub-range (pipeline/ranges.py)."""
    from ..pipeline import ranges

    start, stop = _parse_record_range(records)
    out.write(ranges.read_record_range(target, start, stop, device=device))
    return 0


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


def resolve_backend(args) -> None:
    """Resolve ``--backend auto`` to ``cuda`` or ``cpu`` through
    :func:`..pipeline.auto.device_worthwhile` and say which and why on
    stderr; an explicit backend stays as it is."""
    if args.backend != "auto":
        return
    from ..pipeline import auto

    worthwhile, reason = auto.backend_choice()
    args.backend = "cuda" if worthwhile else "cpu"
    print(f"backend auto: {args.backend} ({reason})", file=sys.stderr)


def _version(args) -> int:
    native = args.wire_format == "native" or args.max_ratio or args.lossless
    return container.VERSION_3_NATIVE if native else container.CURRENT_VERSION


def execute(args, inp: BinaryIO, out: BinaryIO) -> None:
    if args.pair:
        if args.mesh:
            raise RuntimeError("--mesh does not support --pair yet")
        _execute_paired(args, inp, out)
        return
    if args.mesh and args.max_ratio:
        raise RuntimeError(
            "--mesh does not support --max-ratio (the mesh path codes "
            "seq/qual with order-0 rANS on the device)"
        )
    if args.mesh and args.decompress:
        meshpipe.decompress_mesh(
            inp, out, pmesh.make_mesh(device=args.backend)
        )
        return
    if args.decompress:
        device.decompress_device(
            inp, out, api.DecompressOptions(workers=args.workers),
            device=args.backend,
        )
        return
    opts = api.Options(
        block_size=args.block_size,
        workers=args.workers,
        version=container.VERSION_3_NATIVE if args.mesh else _version(args),
        order1_qual=args.max_ratio,
        lossless=args.lossless,
    )
    if args.mesh:
        if args.lossless:
            raise RuntimeError("--mesh does not support --lossless")
        meshpipe.compress_mesh(
            inp, out, opts, pmesh.make_mesh(device=args.backend)
        )
        return
    device.compress_device(inp, out, opts, device=args.backend)


def _execute_paired(args, inp: BinaryIO, out: BinaryIO) -> None:
    """--pair handling: R1 comes from -i/-o as usual, R2 from --pair."""
    if args.decompress:
        try:
            w2 = open(args.pair, "wb", buffering=BUFFER_SIZE)
        except OSError as e:
            raise RuntimeError(f"cannot create output: {e}") from e
        try:
            api.decompress_paired(
                inp, out, w2, api.DecompressOptions(workers=args.workers),
                device=args.backend,
            )
        finally:
            w2.close()
        return
    r2, close_r2 = open_input(args.pair, decompress=False)
    try:
        api.compress_paired(
            inp, r2, out,
            api.Options(
                block_size=args.block_size,
                workers=args.workers,
                version=_version(args),
                order1_qual=args.max_ratio,
                lossless=args.lossless,
            ),
            device=args.backend,
        )
    finally:
        close_r2()


def main(argv: list[str] | None = None) -> int:
    try:
        return _main(argv)
    except BrokenPipeError:
        # stdout consumer went away (e.g. `fqpack info | head`): exit
        # silently with the conventional 128+SIGPIPE status.
        try:
            sys.stderr.close()
        except OSError:
            pass
        return 141


def _main(argv: list[str] | None = None) -> int:
    raw_argv = sys.argv[1:] if argv is None else argv
    if raw_argv and raw_argv[0] == "bench":
        # `fqpack bench [...]` forwards everything to the port's bench,
        # which owns its own flags (--mb, --metric, ...)
        from .. import bench

        try:
            return bench.main(raw_argv[1:])
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    parser = build_argparser()
    args = parser.parse_args(raw_argv)

    if args.show_help:
        parser.print_help(sys.stderr)
        return 0
    if args.show_version:
        print(f"fqpack version {__version__}")
        return 0

    # subcommands: fqpack info|check|cat <file>
    if args.positional and args.positional[0] in ("info", "check", "cat"):
        sub = args.positional[0]
        target = (
            args.positional[1] if len(args.positional) > 1 else args.input
        )
        try:
            if sub != "info":
                resolve_backend(args)
            if sub == "cat":
                out, close_out = open_output(args.output, args.to_stdout)
                try:
                    return cat(target, args.records, out, device=args.backend)
                finally:
                    close_out()
            from . import inspect as fqinspect

            if sub == "info":
                return fqinspect.info(target)
            return fqinspect.check(target, device=args.backend)
        except BrokenPipeError:
            raise
        except (container.FormatError, ValueError, RuntimeError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    if args.positional:
        if not args.input:
            args.input = args.positional[0]
        if len(args.positional) > 1 and not args.output:
            args.output = args.positional[1]

    resolve_backend(args)
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
        raise
    except (container.FormatError, FastqParseError, ValueError,
            RuntimeError, NotImplementedError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        close_out()
        close_in()
    return 0


if __name__ == "__main__":
    _rc = main()
    # A consumer that closed our stdout mid-stream (`fqpack info | head`)
    # makes the final flush raise: exit 141 with no interpreter error dump.
    try:
        sys.stdout.flush()
    except (BrokenPipeError, ValueError, OSError):
        _rc = 141
        os.dup2(os.open(os.devnull, os.O_WRONLY), 1)
    sys.exit(_rc)
