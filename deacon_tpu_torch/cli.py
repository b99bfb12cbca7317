"""Command-line interface of the port: ``index build|info|union|diff``,
``filter``, ``server`` and ``client``, with the flags of the JAX
package's (ref: src/main.rs:9-234), ``--device`` (default cuda) for
``index build``, ``index diff``, ``filter`` and ``server``, and
``--mesh``: ``DATAxSHARD|pod|pod-data|pod-2d`` for ``filter``,
``pod-data`` for ``index build``, ``DATAxSHARD|pod`` for ``server``
(the multi-process modes read the JAX package's DEACON_* environment;
parallel/multihost.py). ``client`` accepts ``--device`` and ``--mesh``
and ignores them with a warning: the server decides.

The devices against the JAX package's choices (DEVICE_HELP): ``cuda``
is its ``tpu`` (the server's ``jax``), ``cpu`` its ``cpu``, and ``host``
(``filter``, ``index build``, ``server``) its host engine: the native
route of ``filter --device auto``, the server's ``host``, the host
route of ``index build``. Its oracle switch ``--device numpy`` has no
counterpart. A ``--mesh`` wins over ``host``, as there."""

from __future__ import annotations

import argparse
import os
import sys

from .constants import (
    DEFAULT_ABS_THRESHOLD,
    DEFAULT_CAPACITY_MILLIONS,
    DEFAULT_COMPRESSION_LEVEL,
    DEFAULT_KMER_LENGTH,
    DEFAULT_REL_THRESHOLD,
    DEFAULT_WINDOW_SIZE,
    MAX_K_BUILD,
    MAX_K_DIFF_FASTX,
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


def _k_diff(value: str) -> int:
    v = int(value)
    if not 1 <= v <= MAX_K_DIFF_FASTX:  # ref: src/main.rs:223
        raise argparse.ArgumentTypeError(
            f"{v} is not in 1..={MAX_K_DIFF_FASTX}")
    return v


#: --device choices, and their help, of filter, index build and server
DEVICES = ["cuda", "cpu", "host"]
DEVICE_HELP = ("cuda (default; the JAX package's tpu), cpu (its cpu) or "
               "host (its host engine, no card: the native route of "
               "filter --device auto, the server's host, the host route "
               "of index build); never falls back")


def _add_filter_like_args(p: argparse.ArgumentParser) -> None:
    """The flags of filter and client (ref: src/main.rs:24-155)."""
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
    p_build.add_argument("--device", default="cuda", choices=DEVICES,
                         help=DEVICE_HELP)
    p_build.add_argument("--mesh", default=None, choices=["pod-data"],
                         help="'pod-data': each rank (DEACON_NUM_PROC/"
                              "DEACON_PROC_ID) indexes its own record-"
                              "aligned byte range of the input and rank 0 "
                              "merges the partial indexes; aggregate build "
                              "throughput scales with the ranks")
    p_info = isub.add_parser("info", help="show index information")
    p_info.add_argument("index", help="path to index file")

    p_union = isub.add_parser("union",
                              help="combine minimizer indexes (A ∪ B…)")
    p_union.add_argument("inputs", nargs="+", help="input index file(s)")
    p_union.add_argument("-o", "--output", default="-")
    p_union.add_argument("-c", "--capacity", dest="capacity_millions",
                         type=int, default=None)
    p_diff = isub.add_parser("diff", help="subtract minimizers (A - B)")
    p_diff.add_argument("first", help="first index file")
    p_diff.add_argument("second", help="second index file or FASTX file "
                                       "(- for stdin)")
    p_diff.add_argument("-k", "--kmer-length", type=_k_diff, default=None)
    p_diff.add_argument("-w", "--window-size", type=int, default=None)
    p_diff.add_argument("-o", "--output", default="-")
    p_diff.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device of the FASTX minimizer extraction "
                             "(default cuda; never falls back)")

    p = sub.add_parser(
        "filter",
        help="keep or discard fastx records with sufficient minimizer hits",
    )
    p.add_argument("index", help="path to minimizer index file")
    _add_filter_like_args(p)
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help=DEVICE_HELP + "; host reads and writes the "
                        "probe table's <index>.probe sidecar "
                        "(DEACON_PROBE_CACHE: 0 never, 1 always, unset "
                        "from 4M keys)")
    p.add_argument("--mesh", default=None,
                   metavar="DATAxSHARD|pod|pod-data|pod-2d",
                   help="device mesh, e.g. 2x4: read batches data-parallel "
                        "over DATA rows, the index range-sharded over SHARD "
                        "devices; needs DATA*SHARD distinct cards on cuda, "
                        "repeats the CPU on cpu. 'pod': torch.distributed "
                        "multi-process mode (DEACON_COORD/DEACON_NUM_PROC/"
                        "DEACON_PROC_ID env): every rank holds only its "
                        "block of the index and must be fed the same "
                        "input. 'pod-data': each rank filters its own byte "
                        "range of the input(s) on its own cards; aggregate "
                        "reads/s scales with the ranks (plain or BGZF "
                        "single-end, or plain paired file inputs). "
                        "'pod-2d': both at once: rank groups of "
                        "DEACON_POD_SHARDS ranks each own a byte range "
                        "while the index is cut across the group's ranks")

    p_server = sub.add_parser(
        "server", help="serve a pre-loaded minimizer index over HTTP")
    p_server.add_argument("index", help="path to minimizer index file")
    p_server.add_argument("-p", "--port", type=int, default=8888)
    p_server.add_argument("--host", default="0.0.0.0")
    p_server.add_argument("--device", default="cuda", choices=DEVICES,
                          help="where the membership probes run: "
                               + DEVICE_HELP)
    p_server.add_argument("--mesh", default=None, metavar="DATAxSHARD|pod",
                          help="shard the index's keys across a device "
                               "mesh (e.g. 1x4; distinct cards on cuda, "
                               "the CPU repeated on cpu), or 'pod': across "
                               "the ranks of a torch.distributed process "
                               "group (DEACON_COORD/DEACON_NUM_PROC/"
                               "DEACON_PROC_ID; rank 0 serves HTTP, the "
                               "other ranks take part in its probes)")

    p_client = sub.add_parser(
        "client",
        help="filter by streaming pre-hashed minimizers to a server")
    p_client.add_argument("server_address",
                          help="server address (including port)")
    _add_filter_like_args(p_client)
    p_client.add_argument("--device", default=None,
                          choices=["auto", "tpu", "cpu", "numpy", *DEVICES],
                          help="ignored with a warning: decisions run on "
                               "the server")
    p_client.add_argument("--mesh", default=None, metavar="DATAxSHARD",
                          help="ignored with a warning: decisions run on "
                               "the server")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.command == "index":
            _run_index(args)
            return 0
        if args.command == "server":
            from .server.app import run_server

            # a long-lived process: huge pages on a built probe table pay off
            os.environ.setdefault("DEACON_PROBE_THP", "1")
            run_server(args.index, args.port, host=args.host,
                       device=args.device, mesh=args.mesh)
            return 0
        from .config import FilterConfig

        if args.output2 is not None and args.input2 is None:
            print(
                "Warning: --output2 specified but no second input file "
                "provided. --output2 will be ignored.",
                file=sys.stderr,
            )  # ref: src/main.rs:320-324
        client = args.command == "client"
        if client and args.device is not None:
            print("Warning: --device is ignored in client mode (decisions "
                  "run on the server).", file=sys.stderr)
        FilterConfig(
            minimizers_path=None if client else args.index,
            server_address=args.server_address if client else None,
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
            mesh=args.mesh,
            # the client has no device: it extracts on the host and the
            # server decides on its own
            **({} if client else {"device": args.device}),
        ).execute()
    except BrokenPipeError:
        return 0
    except KeyboardInterrupt:
        print("Interrupted", file=sys.stderr)
        return 130
    except (ValueError, OSError, RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    finally:
        from .parallel.multihost import leave_distributed

        leave_distributed()
    return 0


def _run_index(args) -> None:
    from .index import build as index_ops

    if args.index_command == "info":
        index_ops.info(args.index)
        return
    if args.index_command == "union":
        index_ops.union(args.inputs,
                        None if args.output == "-" else args.output,
                        args.capacity_millions)
        return
    if args.index_command == "diff":
        index_ops.diff(args.first, args.second, args.kmer_length,
                       args.window_size,
                       None if args.output == "-" else args.output,
                       device=args.device)
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
        mesh=args.mesh,
    ).execute()


if __name__ == "__main__":
    sys.exit(main())
