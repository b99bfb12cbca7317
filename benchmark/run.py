"""Benchmark of deacon_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout; the cells, configurations and metrics
are those of BENCHMARK.json there. Prints diagnostics on stderr, the
numbers compared for ``correct`` with their limits as its last lines, and
one JSON result as the last line of stdout: the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``.
Needs a CUDA device and never falls back to the CPU: without one it
exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
# the checkout's root, not this directory, heads the import path
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.load_manifest(ROOT)
    cell = harness.cell_entry(bench, args.workload)
    harness.cache_dirs(ROOT)
    import torch

    need = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"needs {need} CUDA device(s); torch.cuda.is_available()="
            f"{torch.cuda.is_available()}, device_count="
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.cuda.init()
    import deacon_tpu_torch  # noqa: F401 (fails here, without the program)

    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START, log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    for line in harness.check_lines(result["checks"]):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
