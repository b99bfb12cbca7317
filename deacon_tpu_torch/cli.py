"""Command-line interface of the port: ``index build``, ``index info`` and
``filter``, with the flags of the JAX package's (ref: src/main.rs:9-234)
and ``--device cuda|cpu`` (default cuda) for ``index build`` and
``filter``, and ``--mesh DATAxSHARD`` for ``filter``."""

from __future__ import annotations

import argparse
import sys

from .constants import (
    DEFAULT_ABS_THRESHOLD,
    DEFAULT_CAPACITY_MILLIONS,
    DEFAULT_COMPRESSION_LEVEL,
    DEFAULT_KMER_LENGTH,
    DEFAULT_REL_THRESHOLD,
    DEFAULT_WINDOW_SIZE,
    MAX_K_BUILD,
    TOOL_NAME,
    VERSION,
)


def _abs_threshold(value: str) -> int:
    v = int(value)
    # ref: src/main.rs:44 — clap value_parser!(u16).range(1..)
    if not 1 <= v <= 65535:
        raise argparse.ArgumentTypeError(f"{v} is not in 1..=65535")
    return v


def _k_build(value: str) -> int:
    v = int(value)
    if not 1 <= v <= MAX_K_BUILD:  # ref: src/main.rs:166
        raise argparse.ArgumentTypeError(f"{v} is not in 1..={MAX_K_BUILD}")
    return v


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=TOOL_NAME,
        description=(
            "GPU minimizer-based filter for nucleotide sequences in "
            "FASTA/FASTQ format (PyTorch/CUDA port of deacon-tpu)"
        ),
    )
    parser.add_argument("--version", action="version",
                        version=f"{TOOL_NAME} {VERSION}")
    sub = parser.add_subparsers(dest="command", required=True)
    p_index = sub.add_parser("index", help="build and inspect minimizer indexes")
    isub = p_index.add_subparsers(dest="index_command", required=True)
    p_build = isub.add_parser("build", help="index minimizers within a fastx file")
    p_build.add_argument("input", help="input fastx path (gz/zst/xz supported)")
    p_build.add_argument("-k", dest="kmer_length", type=_k_build,
                         default=DEFAULT_KMER_LENGTH,
                         help=f"k-mer length (1-{MAX_K_BUILD})")
    p_build.add_argument("-w", dest="window_size", type=int,
                         default=DEFAULT_WINDOW_SIZE,
                         help="minimizer window size")
    p_build.add_argument("-o", "--output", default="-",
                         help="output path (- for stdout)")
    p_build.add_argument("-c", "--capacity", dest="capacity_millions",
                         type=int, default=DEFAULT_CAPACITY_MILLIONS,
                         help="preallocated capacity in millions")
    p_build.add_argument("-t", "--threads", type=int, default=8)
    p_build.add_argument("-q", "--quiet", action="store_true",
                         help="suppress sequence header output")
    p_build.add_argument("-e", "--entropy-threshold", type=float, default=0.0,
                         help="minimum scaled entropy threshold (0.0-1.0)")
    p_build.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                         help="compute device (default cuda; never falls back)")
    p_info = isub.add_parser("info", help="show index information")
    p_info.add_argument("index", help="path to index file")

    p = sub.add_parser(
        "filter",
        help="keep or discard fastx records with sufficient minimizer hits",
    )
    p.add_argument("index", help="path to minimizer index file")
    p.add_argument("input", nargs="?", default="-",
                   help="path to fastx file (or - for stdin)")
    p.add_argument("input2", nargs="?", default=None,
                   help="optional second paired fastx file (or - for interleaved stdin)")
    p.add_argument("-o", "--output", default="-",
                   help="output fastx path (- for stdout; detects .gz/.zst/.xz)")
    p.add_argument("-O", "--output2", default=None,
                   help="optional second paired output fastx path")
    p.add_argument("-a", "--abs-threshold", type=_abs_threshold,
                   default=DEFAULT_ABS_THRESHOLD,
                   help="minimum absolute number of minimizer hits for a match")
    p.add_argument("-r", "--rel-threshold", type=float,
                   default=DEFAULT_REL_THRESHOLD,
                   help="minimum relative proportion (0.0-1.0) of minimizer hits")
    p.add_argument("-p", "--prefix-length", type=int, default=0,
                   help="search only the first N nucleotides (0 = entire sequence)")
    p.add_argument("-d", "--deplete", action="store_true",
                   help="discard matching sequences")
    p.add_argument("-R", "--rename", action="store_true",
                   help="replace sequence headers with incrementing numbers")
    p.add_argument("-s", "--summary", default=None,
                   help="path to JSON summary output file")
    p.add_argument("-t", "--threads", type=int, default=8,
                   help="number of execution threads (0 = auto)")
    p.add_argument("--compression-level", type=int,
                   default=DEFAULT_COMPRESSION_LEVEL,
                   help="output compression level (1-9 gz & xz; 1-22 zstd)")
    p.add_argument("--debug", action="store_true",
                   help="output sequences with minimizer hits to stderr")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress progress reporting")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="compute device (default cuda; never falls back)")
    p.add_argument("--mesh", default=None, metavar="DATAxSHARD",
                   help="device mesh, e.g. 2x4: read batches data-parallel "
                        "over DATA rows, the index range-sharded over SHARD "
                        "devices; needs DATA*SHARD distinct cards on cuda, "
                        "repeats the CPU on cpu")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.command == "index":
            _run_index(args)
            return 0
        from .config import FilterConfig

        if args.output2 is not None and args.input2 is None:
            print(
                "Warning: --output2 specified but no second input file "
                "provided. --output2 will be ignored.",
                file=sys.stderr,
            )  # ref: src/main.rs:320-324
        FilterConfig(
            minimizers_path=args.index,
            input_path=args.input,
            input2_path=args.input2,
            output_path=args.output,
            output2_path=args.output2,
            abs_threshold=args.abs_threshold,
            rel_threshold=args.rel_threshold,
            prefix_length=args.prefix_length,
            summary_path=args.summary,
            deplete=args.deplete,
            rename=args.rename,
            threads=args.threads,
            compression_level=args.compression_level,
            debug=args.debug,
            quiet=args.quiet,
            device=args.device,
            mesh=args.mesh,
        ).execute()
    except BrokenPipeError:
        return 0
    except KeyboardInterrupt:
        print("Interrupted", file=sys.stderr)
        return 130
    except (ValueError, OSError, RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


def _run_index(args) -> None:
    from .index import build as index_ops

    if args.index_command == "info":
        index_ops.info(args.index)
        return
    from .config import IndexConfig

    IndexConfig(
        input_path=args.input,
        kmer_length=args.kmer_length,
        window_size=args.window_size,
        output_path=None if args.output == "-" else args.output,
        capacity_millions=args.capacity_millions,
        threads=args.threads,
        quiet=args.quiet,
        entropy_threshold=args.entropy_threshold,
        device=args.device,
    ).execute()


if __name__ == "__main__":
    sys.exit(main())
