#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deacon_tpu_torch) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
ending in torch.cuda.synchronize() and one flushed line with its seconds:

0. device: the card's name and power limit (nvidia-smi); then the host
   library (deacon_tpu_torch/io/native/host.cpp: reader, writers, tile
   packer, index codec, sorted-set merges, host extraction, and the host
   engine of --device host) built by g++,
   with its seconds, the g++ version, which codec headers
   (/usr/include/{zlib,zstd,lzma,bzlib}.h) and which codec libraries
   (ldconfig -p) the machine has;
1. build: nvcc compiles csrc/*.cu into deacon_tpu_torch/_build/;
2. kernel parity at main-path shapes: K1 (select_compact) at the three
   default tiles and K2 (probe_hits) on a production-sized sorted stream
   with a forced spill table, each against its plain PyTorch version
   (exact: the outputs are integers), with times and bounds; K1's and
   K2's times are device times (CUDA-graph replay), printed beside the
   time around wrapper calls (call_ms) and the ratio to the bound;
3. CLI end to end: ``deacon_tpu_torch.cli.main(["index", "build", ...])``
   on the card writes a seeded 2 Mbp genome's index, byte-identical to
   the index written from the host NumPy oracle; ``filter`` against it,
   single and paired, search and deplete, output byte-identical between
   --device cuda and --device cpu; both kernels' launch counters must
   rise;
4. panhuman scale (~4.1e8 index keys, k=31, w=15): keys made on the card,
   the radix table built on the card, ~20 Mbp of Illumina-like and
   ONT-like reads through DeviceDecider, some with poly-G tails and
   low-complexity stretches whose rows exceed their minimizer budget (the
   pipeline reruns those units on the card; at least one must be), the
   hits and totals of every read held against an independent reference
   (searchsorted membership, torch.unique distinct counts, NumPy XXH3).
   The kernels' launch counts are those of this timed window;
5. K3 (values_select) against its plain version, exact (row totals and
   every live slot's pos, lo and hi), at the three default tiles at
   k=41, w=15 and one tile each at (k, w) = (56, 9), (57, 15) at
   L = 16384 and (31, 15), with dirty bases, short and unused rows;
   device times (CUDA-graph replay) beside call_ms, the bound of the slot
   grid (grid_bound) and the dense planes' bound (bound_dense_ms);
6. phase 3 at k=41, w=15 (the wide-k path, K3): ``index build`` with and
   without -e 0.5 on a multi-record FASTA with N runs, IUPAC codes and
   lowercase, on the card and on the CPU, byte-identical to each other
   and to the oracle's index; then ``filter`` against it, cuda against
   cpu, with reads whose rows go over their minimizer budget;
7. phase 4 at k=41 (phase 4's table freed first): 4.1e8 keys plus the
   k=41 minimizers of a seeded 5 Mbp genome, phase 4's read mix; the
   reference hashes 128-bit values; K3 and K2 must run in the timed
   window and K1 must not;
8. index build at scale: a seeded 104 Mbp multi-record FASTA through
   ``index build`` on the card at k=31 (K1) and k=41 (K3), with Mbp/s;
   both indexes byte-identical to the oracle's over the records the
   oracle (six worker processes) finishes within its time limit; and
   ``index build --device host`` (the host engine's route, -t 8) at both
   k, quiet and reporting, each byte-identical to the card build, no
   kernel launched, with seconds, Mbp/s and the host's CPU;
9. K4 (select_csum) against its plain version (the slot grid of
   select_csum_slots_plain), exact as in phase 5, at the tiles
   (384, 4096), (1152, 2048), (12288, 512) at k=31, w=15 and
   (1152, 2048) at (15, 5), dirty, short and unused rows; times and
   bounds as in phase 5;
10. K5 (values_argmin) against its plain version (the slot grid of
   values_argmin_slots_plain), exact as in phase 5, at the three default
   tiles at k=31 and k=41, and (2048, 2048) at (56, 9); times and bounds
   as in phase 5;
11. the CLI under the engine's switches, card against CPU, byte for
   byte: ``index build`` under DEACON_PALLAS=1 at k=31 and 41 against the
   oracle's index (K5 only), ``filter`` single and paired under
   DEACON_TPU_TILES=384:4096,1152:2048,12288:512 (K4), DEACON_ENGINE=3
   (K4), DEACON_ENGINE=2 (K3) and DEACON_PALLAS=1 at k=31 and 41 (K5),
   each with its launch counters checked;
12. ``filter`` with .zst input and output on the card through libzstd;
   whether libzstd.so.1 loaded is printed;
13. K2's sharded form on phase 4's table, rebuilt on the card shard by
   shard (build_radix_shards) for S = 4 and S = 3 (uneven row ranges),
   and the main-path stream: the blocks concatenated equal the table,
   each shard's hits equal its plain version's, and their sum the
   unsharded K2's hits exactly; device times (and call_ms) of the S
   launches together and of the unsharded one, and the bound;
14. ``filter --mesh``: --mesh 1x1 on the card byte-identical to the run
   without --mesh and to --device cpu --mesh 2x4, single and paired;
   --mesh 1x2 on one card exits 1 with "need 2 devices, have 1";
4a, 4b, 4c, 7b: phase 4's reads once more against its table under
   DEACON_TPU_TILES=384:4096,1152:2048,12288:512 (K4), DEACON_PALLAS=1
   (K5) and no switch (K1, a control run in the same place as the other
   two), and phase 7's under DEACON_PALLAS=1 (K5): every unit equal to
   the phase's reference counts, with Mbp/s, busy share, reruns and the
   window's launches of each kernel;
4d: phase 4's reads through DeviceDecider over make_mesh(2, 4,
   ["cuda:0"] * 8) (two data rows, four table shards on the one card):
   every unit equal to phase 4's reference, K2 launched 4 times per
   batch, with Mbp/s, busy share, reruns, launches, the shard build's
   seconds and GB and the peak memory;
15. server and client at panhuman scale: phase 4's keys written with
   ``write_index`` to an index file (~3.7 GB; the tempdir's free space
   printed first, too little fails the phase), ``make_server`` on the
   card in a thread (its /, /index_header and /index_version checked),
   ``cli.main(["client", ...])`` over ~2 Mbp of phase 4's Illumina-like
   reads, single and paired, search and deplete, on the binary and the
   JSON wire, each output byte-identical to ``cli.main(["filter", ...])``
   on the card from the same file (K1 and K2 launch there; the client
   runs launch no kernel of the port: the server probes by searchsorted)
   and each summary equal apart from the program, the index, the output
   paths and the timings; printed: the file's write seconds, the
   server's start (sha256, load_index, upload), the resident GB, the
   peaks over the phase's start of the server's start and of the filter
   runs, the probe's device ms and queries/s at 1e5 and 1e6 queries, the
   client's Mbp/s (host-bound: NumPy oracle extraction) and each
   filter's index load and Mbp/s;
16. ``index diff`` on the card: the phase-15 file minus the 5 Mbp genome
   as FASTA at k=31 (K1), equal to NumPy's setdiff1d of the keys and the
   genome's oracle minimizers, with seconds and Mbp/s of the CLI and of
   the FASTX part alone; at phase 6's size from a k=41 index with -k/-w
   absent (K3) and under DEACON_PALLAS=1 at k=41 and 31 (K5), each
   against setdiff1d and with only its kernel launched; ``index union``
   and index-minus-index ``diff`` of two ~1e7-key indexes against
   np.union1d and np.setdiff1d;
17. host I/O on the card's host, every host-library function against its
   plain version on seeded inputs (a mismatch fails the phase): the
   reader on ~41 MB of phase 4's reads (some with IUPAC and lowercase
   bases) as FASTQ, single and paired, in each input format (plain, gzip,
   BGZF, zstd, xz, bzip2), against the Python parser, with MB/s of each;
   the tile packer at the three default tiles and 4a's, with the filter's
   and the index build's codes, against pack_rows_packed_plain, with ms
   per tile of both; the phase-15 file decoded by the host library and
   by utils/bincode (NumPy), keys equal, seconds of each; a writer round
   trip in each output codec, with MB/s; host extraction against the
   NumPy oracle on ~1 Mbp at k=31 and k=56. The file is deleted after it.

18. the multi-process modes on the card, from the phase-15 file (after
   phase 16, before 17), each rank a spawned process of this script on
   cuda:0 with its DEACON_* variables (the ranks share the card, so their
   collectives run over gloo): two ranks of ``filter --mesh pod`` (each
   rank's output), two of ``--mesh pod-data`` single, paired and BGZF,
   four of ``--mesh pod-2d`` (DEACON_POD_SHARDS=2), all on phase 4's
   reads written as ~20 Mbp of FASTQ (a BGZF copy of the single file);
   two of ``index build --mesh pod-data`` over a seeded 20 Mbp FASTA; two
   of ``server --mesh pod`` with ``client`` against rank 0; and
   ``make_server`` on make_mesh(1, 2, ["cuda:0"] * 2) with ``client``.
   Every output byte-identical to the one-process command on the card
   from the same file; each rank's counters set to 0 before its command
   and read after: K1 and K2 launch in every filter rank (K1 in every
   build rank), and in the pod modes K2 runs on exactly the rank's block
   of rows (shard_rows). Printed per run: Mbp/s (input over the slowest
   rank's wall), and per rank its seconds, load and pipeline seconds,
   peak GB, backend and launches.

19. the host engine (``--device host``) from the phase-15 file (after
   phase 18, before 17) and phase 18's FASTQ: ``filter --device host``
   with .gz output, each run a spawned process of this script: single
   (plain input) building the probe table and writing its ~4.1 GB
   sidecar (DEACON_PROBE_CACHE=1; free space checked first, too little
   fails the phase), then single from the BGZF copy and paired (-O) from
   the sidecar; every output BGZF and, decompressed, byte-identical to
   ``filter --device cuda`` on the same file (K1 and K2 launched there,
   nothing in the host runs); then ``server --device host`` started from
   the sidecar, ``client`` on both wires equal to phase 15's answers of
   the cuda server. Printed: start seconds (index decode plus table build
   against the sidecar's load), Mbp/s, threads, peak RSS, the sidecar's
   bytes, the card's name and power limit, the host's CPU model and
   cores, the host server's start.

20. the device rule (after phase 19, before 17): the JAX package's
   ``--device auto``. A seeded 2 Mbp genome (an index under the rule's
   1M keys) and ~3 Mbp of reads (a FASTQ under its 16 MB): ``index build
   --device auto`` takes the host route and ``filter --device auto`` the
   host engine (its table built at start), neither launching a kernel,
   each output byte-identical to ``--device cuda``'s (K1, K2 launched);
   the same small job as one-shot CLI processes (``python -m
   deacon_tpu_torch``, start included) on ``auto`` and ``cuda``, and on
   three copies of its FASTQ (over 16 MB: auto takes cuda) on ``auto``
   and ``host``; then the phase-15 file and phase 18's FASTQ with phase
   19's sidecar moved aside (auto takes cuda: K1 and K2 launch) and back
   (the host engine from the sidecar, the keys not decoded), both
   outputs equal to phase 19's cuda run. Each run prints its route,
   seconds and Mbp/s beside the card's name and power limit.

Phases run in the order 0, 1, 2, 9, 10, 3, 11, 12, 14, 4, 4a, 4b, 4c, 13,
4d, 15, 16, 18, 19, 20, 17, 5, 6, 7, 7b, 8. Each switch is set in
os.environ only around its phase.

``python3 chip_smoke.py --k1`` runs phases 0 and 1 and then K1's part of
phase 2 alone, printing its numbers as the last line and no result: the
quickest check and timing of K1. ``python3 chip_smoke.py --k2`` does
the same for K2: phases 0 and 1, then phase 4's table and main-path
stream (K2 whole and its S = 4 and S = 3 launches, as in phase 13), a
repeat-heavy stream (one read holding most member keys, beside the same
keys spread over reads) and phase 2's stream, each exact against the
plain version, by device time and call_ms. ``python3 chip_smoke.py
--k3`` runs phases 0 and 1, then ``engine.select_slots(...,
route="K3")`` (K3 with whatever torch work the tree runs after it) on
phase 5's tiles, each exact against the dense route built from plain
parts (compact_rows over the dense planes of values_select_plain), by
device time and call_ms. ``--k4`` does the same for the K4 route on
phase 9's tiles (against csum_slots over select_csum_plain's plane) and
``--k5`` for the K5 route on phase 10's (against compact_rows over
flag_mask and values_argmin_plain's planes gathered at wp). Copied into
a checkout of an earlier commit and run there, each times that commit's
kernel (or route) by the same measures. ``python3 chip_smoke.py --pod4``
needs four cards: it runs phases 0 and 1, then the pod modes with each
rank on a card of its own, where the collectives run over nccl
(pods_on_cards), then with two ranks of two cards each (pod single and
paired, pod-2d with DEACON_POD_SHARDS=1, pod-data on a 2x1 and a 1x2
local mesh, the pod index build, the pod server idle past its keep-alive
period) and two ranks seeing all four cards (pods_on_card_pairs), each
with its launches and peak memory per card, then the single-process
meshes over the four cards
(``filter --mesh 2x2`` and ``1x4``, single and paired, and ``server
--mesh 1x4`` with ``client``, each against the one-card run, with each
card's peak memory; meshes_on_cards), printing its numbers as the last
line and no result.

Every temporary file lives in a tempfile directory outside the checkout
and is deleted; nothing is left running. Exits non-zero, printing no
result, when no CUDA device is present or any check fails. The last line
is {"ok": true, "device": {...}}; the line before it names the kernels
run, and before that come a JSON line of per-kernel numbers and the
card's name and power limit.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import deacon_tpu_torch as dtt
from deacon_tpu_torch.cli import main as cli_main
from deacon_tpu_torch.filter.engine import DeviceDecider
from deacon_tpu_torch.index.store import load_header_and_count
from deacon_tpu_torch.io import native_loader as host
from deacon_tpu_torch.io import zstd
from deacon_tpu_torch.io.fastx import FastxReader, open_maybe_compressed
from deacon_tpu_torch.io.writers import get_writer
from deacon_tpu_torch.ops import _build
from deacon_tpu_torch.ops import kernels as K
from deacon_tpu_torch.ops.engine import DevicePipeline, select_slots
from deacon_tpu_torch.ops.hash import lsr, xxh3_64
from deacon_tpu_torch.ops.minimizers_np import get_minimizer_hashes_and_positions
from deacon_tpu_torch.ops.host_extract import (
    extract_filter_batch,
    extract_filter_batch_plain,
)
from deacon_tpu_torch.ops.pack import (
    INDEX_CODE,
    PACK_CODE,
    RowBlock,
    _Row,
    default_budget_frac,
    join_seqs,
    pack_block,
    pack_rows_packed,
    pack_rows_packed_plain,
    v4_row_budget,
)
from deacon_tpu_torch.ops.radix_probe import (
    build_radix_shards,
    build_radix_table,
    prep_sorted,
    sorted_unique_keys,
)
from deacon_tpu_torch.parallel.sharded import make_mesh
from deacon_tpu_torch.utils import bincode
from deacon_tpu_torch.utils.xxh3 import xxh3_64_u64, xxh3_64_u128

SEED = 20261017
K_, W_ = 31, 15
K_WIDE = 41
SWITCHES = ("DEACON_TPU_TILES", "DEACON_ENGINE", "DEACON_PALLAS")
#: non-power-of-two row lengths: every tile takes the K4 route (arch 3)
K4_TILES = ((384, 4096), (1152, 2048), (12288, 512))
K4_TILES_ENV = ",".join(f"{L}:{R}" for L, R in K4_TILES)
PANHUMAN_KEYS = 410_000_000  # README: ~4.1e8 minimizers at k=31, w=15
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
INT32_OPS_PER_S = 33.5e12    # half the 67 TFLOP/s fp32 rate: 64 INT32 lanes/SM
I64_MIN = -(1 << 63)
BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def log(phase: str, t0: float, **numbers) -> None:
    torch.cuda.synchronize()
    fields = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[phase {phase}] {time.perf_counter() - t0:.3f} s {fields}",
          flush=True)


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean ms per call on the card (CUDA events around reps calls)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _graph(fn, reps: int):
    """reps calls of fn captured in one CUDA graph (after two warm-up calls
    on a side stream), replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _replay_ms(graph) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def graph_ms(fn, reps: int = 20, iters: int = 5) -> float:
    """Mean device ms per call: reps calls captured in one CUDA graph,
    replayed iters times between CUDA events, so that the host's time per
    call (the wrapper's checks and allocations) is not counted."""
    graph = _graph(fn, reps)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (reps * iters)


#: bytes read between calls to evict the card's 50 MB L2 cache (cold_ms)
L2_FLUSH_BYTES = 256 << 20


def cold_ms(fn, reps: int = 20, iters: int = 7) -> float:
    """Device ms per call of fn with the L2 cache flushed before each call:
    one graph of reps (read of L2_FLUSH_BYTES, fn) pairs and one of the
    reads alone, replayed in turns iters times; the median of the first
    less the median of the second, over reps. Where graph_ms replays one
    input, the sectors fn touched stay in L2 from call to call; a filter
    batch finds its table rows in device memory."""
    buf = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def flush():
        return buf.sum()

    def both():
        flush()
        return fn()

    g_both, g_flush = _graph(both, reps), _graph(flush, reps)
    t_both, t_flush = [], []
    for _ in range(iters):
        t_flush.append(_replay_ms(g_flush))
        t_both.append(_replay_ms(g_both))
    return (float(np.median(t_both)) - float(np.median(t_flush))) / reps


@contextlib.contextmanager
def switches(**env):
    """The engine's switches set to env (the others unset) for a phase,
    restored after it."""
    old = {name: os.environ.pop(name, None) for name in SWITCHES}
    os.environ.update(env)
    try:
        yield
    finally:
        for name, value in old.items():
            os.environ.pop(name, None)
            if value is not None:
                os.environ[name] = value


#: the selection kernels by name (each tile class runs one of them)
SELECT = {"K1": K.select_compact, "K3": K.values_select,
          "K4": K.select_csum, "K5": K.values_argmin}


#: the device-side names of the kernels, as torch.profiler lists them
OWN_KERNELS = {"K1": "select_compact_kernel", "K2": "radix_probe_kernel",
               "K3": "values_select_kernel", "K4": "select_csum_kernel",
               "K5": "values_argmin_kernel"}


def reset_launches() -> None:
    for f in (*SELECT.values(), K.probe_hits):
        f.launches = 0


def launch_counts() -> dict:
    out = {name: f.launches for name, f in SELECT.items()}
    out["K2"] = K.probe_hits.launches
    return dict(sorted(out.items()))


def check_route(launches: dict, kernel: str, what: str) -> None:
    """kernel and K2 launched, no other selection kernel."""
    others = [n for n in SELECT if n != kernel and launches[n]]
    if launches[kernel] <= 0 or launches["K2"] <= 0 or others:
        raise AssertionError(f"{what}: expected {kernel} and K2 only, "
                             f"launches {launches}")


def bound_ms(nbytes: float, ops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def rand_seq(rng, n: int) -> bytes:
    return rng.choice(BASES, size=n).tobytes()


def revcomp(s: bytes) -> bytes:
    return s.translate(COMP)[::-1]


# ---------------------------------------------------------------------------
# phase 2: kernel parity at main-path shapes
# ---------------------------------------------------------------------------

def tile_rows(rng, L: int, R: int, k: int = K_, w: int = W_) -> list[_Row]:
    """R rows of a tile: random reads of varied length, runs of N,
    low-complexity stretches and short rows (allow_short)."""
    l = k + w - 1
    rows = []
    for i in range(R):
        kind = i % 8
        n = int(rng.integers(l, L + 1))
        s = bytearray(rand_seq(rng, n))
        if kind == 1:  # a run of N
            b = int(rng.integers(0, n))
            run = min(n - b, int(rng.integers(1, 120)))
            s[b:b + run] = b"N" * run
        elif kind == 2:  # low complexity
            a = int(rng.integers(0, n))
            run = min(n - a, int(rng.integers(20, 400)))
            unit = rand_seq(rng, int(rng.integers(1, 4)))
            s[a:a + run] = (unit * (run // len(unit) + 1))[:run]
        elif kind == 3:  # short read: fewer than w k-mers
            s = bytearray(rand_seq(rng, int(rng.integers(k, l))))
        elif kind == 4:  # lowercase and IUPAC bytes
            for j in rng.integers(0, n, 6):
                s[int(j)] = b"acgtRY"[int(rng.integers(0, 6))]
        rows.append(_Row(i // 2, i % 2, 0, bytes(s)))
    return rows


def k1_tiles(rng) -> dict:
    """K1 at the three default tiles: exact against its plain version,
    with its device time (CUDA-graph replay), its time around wrapper
    calls (call_ms), its plain version's and its bound."""
    dev = torch.device("cuda")
    budget_frac = default_budget_frac(W_)
    k1 = {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
          "max_abs_err": 0, "tiles": []}
    for L, R in DevicePipeline.DEFAULT_TILES:
        Br = v4_row_budget(L, W_, budget_frac)
        arrs = pack_rows_packed(tile_rows(rng, L, R), R, L, K_, K_ + W_ - 1)
        pc, pv, mlen, allow = (torch.from_numpy(a).to(dev) for a in arrs[:4])

        def kern():
            return K.select_compact(pc, pv, mlen, allow, k=K_, w=W_, Br=Br)

        def plain():
            return K.select_compact_plain(pc, pv, mlen, allow, k=K_, w=W_,
                                          Br=Br)

        pos, val, tot = kern()
        ppos, pval, ptot = plain()
        torch.cuda.synchronize()
        if not torch.equal(tot, ptot):
            raise AssertionError(f"K1 row totals differ at tile {(L, R)}")
        lane = torch.arange(Br, device=dev)[None, :]
        live = lane < torch.clamp(tot, max=Br)[:, None]
        err = max(
            int((pos[live].long() - ppos[live].long()).abs().max()),
            int((val[live] != pval[live]).sum()),
        ) if bool(live.any()) else 0
        if err:
            raise AssertionError(f"K1 slots differ at tile {(L, R)}")
        # ms: the kernel's device time; call_ms: events around 20 wrapper
        # calls, which counts the host's time per call where that is the
        # longer (the earlier measure, kept for comparison)
        ms = graph_ms(kern)
        call_ms = time_ms(kern, 20)
        pms = time_ms(plain, 3, warm=1)
        slots = int(live.sum())
        nbytes = R * (L // 4 + L // 8 + 4 + 1 + 4) + slots * 12
        ops = R * L * 40.0  # ~40 int ops/base: 2 rolling k-mers, fmix32,
        # window min, validity and flag, scan
        b, by = bound_ms(nbytes, ops)
        k1["ms"] += ms
        k1["call_ms"] += call_ms
        k1["plain_ms"] += pms
        k1["bound_ms"] += b
        k1["bound_by"] = by
        k1["tiles"].append({"L": L, "R": R, "Br": Br, "ms": round(ms, 4),
                            "call_ms": round(call_ms, 4),
                            "plain_ms": round(pms, 3), "bytes": nbytes,
                            "bytes_bound_ms": round(
                                nbytes / HBM_BYTES_PER_S * 1e3, 5),
                            "bound_ms": round(b, 5), "bound_by": by,
                            "ratio_to_bound": round(ms / b, 2),
                            "slots": slots,
                            "overflow_rows": int((tot > Br).sum())})
    return k1


def dense_k2_stream():
    """Phase 2's K2 input: a production-sized stream (the (2048, 2048)
    tile's slot grid at the real density) on a 2**21-key table with a
    forced spill. Returns (table, key, srid, first, reads)."""
    dev = torch.device("cuda")
    budget_frac = default_budget_frac(W_)
    g = torch.Generator(device=dev).manual_seed(SEED)
    keys = torch.randint(I64_MIN, (1 << 63) - 1, (1 << 21,), device=dev,
                         dtype=torch.int64, generator=g)
    # 180 keys in one bucket: 128 fill it, the rest go to the spill table
    top = keys[7] & ~((1 << 34) - 1)
    crafted = top | torch.randint(0, 1 << 34, (180,), device=dev,
                                  dtype=torch.int64, generator=g)
    table = build_radix_table(torch.cat([keys, crafted]))
    if table.sp == 0:
        raise AssertionError("K2 parity table has no spill")
    R, Br = 2048, v4_row_budget(2048, W_, budget_frac)
    q = R * Br
    pick = torch.randint(0, keys.numel(), (q,), device=dev, generator=g)
    member = keys[pick]
    other = torch.randint(I64_MIN, (1 << 63) - 1, (q,), device=dev,
                          dtype=torch.int64, generator=g)
    coin = torch.rand(q, device=dev, generator=g) < 0.5
    hashes = torch.where(coin, member, other).reshape(R, Br)
    # the largest crafted key ranks past 128 in its bucket: it is in the
    # spill table; planted 8 times in one read it must count once
    hashes[0, :8] = sorted_unique_keys(crafted)[-1]
    valid = torch.rand((R, Br), device=dev, generator=g) < 0.67
    valid[0, :8] = True
    rid = (torch.arange(R, device=dev, dtype=torch.int32) // 2)
    key, srid, first = prep_sorted(hashes, valid, rid[:, None].expand(R, Br))
    return table, key, srid, first, R // 2


def phase2(rng) -> dict:
    t0 = time.perf_counter()
    k1 = k1_tiles(rng)
    k2 = measure_k2(*dense_k2_stream())
    log("2 kernel parity", t0, k1=json.dumps(k1["tiles"]),
        k2=json.dumps(k2))
    return {"k1": k1, "k2": k2}


def parity_tile(rng, k: int, w: int, L: int, R: int):
    """A tile of tile_rows with 1 row in 16 unused (mlen -1), on the card."""
    n = R - max(1, R // 16)
    arrs = pack_rows_packed(tile_rows(rng, L, n, k, w), R, L, k, k + w - 1)
    return [torch.from_numpy(a).to("cuda") for a in arrs[:4]]


#: K3's tiles: the three default tiles at k=41, w=15, then (56, 9),
#: k = 57 at the longest row and K3 at k <= 32 (K1's 64-bit values)
K3_TILES = [(K_WIDE, W_, L, R) for L, R in DevicePipeline.DEFAULT_TILES] + [
    (56, 9, 2048, 2048), (57, 15, 16384, 512), (31, 15, 2048, 2048)]


def slot_mismatches(got, want, Br: int, what: str) -> int:
    """Compare two slot grids ((R, Br) positions, value planes, (R,)
    totals): totals exactly, then every live slot; raises on a difference
    and returns the live slot count."""
    pos, planes, tot = got
    wpos, wplanes, wtot = want
    torch.cuda.synchronize()
    if not torch.equal(tot, wtot):
        raise AssertionError(f"{what}: row totals differ")
    live = (torch.arange(Br, device=tot.device)[None, :]
            < torch.clamp(tot, max=Br)[:, None])
    if len(planes) != len(wplanes):
        raise AssertionError(f"{what}: {len(planes)} value planes, "
                             f"want {len(wplanes)}")
    bad = int((pos[live] != wpos[live]).sum()) + sum(
        int((g[live] != x[live]).sum()) for g, x in zip(planes, wplanes))
    if bad:
        raise AssertionError(f"{what}: {bad} slot entries differ")
    return int(live.sum())


def as_grid(out):
    """A wrapper's (pos, val, tot) or (pos, lo, hi, tot) as select_slots'
    (pos, [planes], tot)."""
    if len(out) == 3:
        return out[0], [out[1]], out[2]
    pos, lo, hi, tot = out
    return pos, [lo] if hi is None else [lo, hi], tot


def dense_k3_slots(pc, pv, mlen, allow, *, k: int, w: int, Br: int):
    """The dense K3 route by its own plain parts: compact_rows over the
    dense planes of values_select_plain (interfaces older trees have)."""
    lo, hi, wpf = K.values_select_plain(pc, pv, mlen, allow, k=k, w=w)
    return K.compact_rows((wpf >> 16) != 0, wpf & 0xFFFF,
                          [lo, hi] if k > 32 else [lo], Br)


def dense_k4_slots(pc, pv, mlen, allow, *, k: int, w: int, Br: int):
    """The dense K4 route by its own plain parts: csum_slots over
    select_csum_plain's plane (older trees keep csum_slots in
    ops/engine.py)."""
    from deacon_tpu_torch.ops import engine

    csum_slots = getattr(K, "csum_slots", None) or engine.csum_slots
    plane, tot = K.select_csum_plain(pc, pv, mlen, allow, k=k, w=w)
    return csum_slots(pc, plane, tot, k=k, Br=Br)


def dense_k5_slots(pc, pv, mlen, allow, *, k: int, w: int, Br: int):
    """The dense K5 route by its own plain parts: compact_rows over
    flag_mask and over values_argmin_plain's planes gathered at wp."""
    planes, wp = K.values_argmin_plain(pc, mlen, k=k, w=w)
    flag = K.flag_mask(wp, pv, mlen, allow, k=k, w=w)
    at_wp = wp.to(torch.int64)
    return K.compact_rows(flag, wp, [p.gather(1, at_wp) for p in planes],
                          Br)


def grid_bound(k: int, L: int, R: int, slots: int):
    """The bound of a kernel that writes the slot grid (K3, K4, K5):
    R * (L/4 + L/8 + 9) bytes (packed codes and validity, mlen, allow, the
    row total) plus 12 bytes a live slot (pos and the value; 20 at
    k > 32, the value's high half), against ~40 int32 operations a base
    at k <= 32 (two rolling k-mers, fmix32, window minimum, validity and
    flag, scan) or ~80 at k > 32 (two 128-bit strands sliced from a
    192-bit window, their compare, the fold and fmix32, validity, the van
    Herk minimum, flag and scan), whichever is larger. Returns (bound_ms,
    bound_by, bytes)."""
    nbytes = R * (L // 4 + L // 8 + 9) + slots * (20 if k > 32 else 12)
    b, by = bound_ms(nbytes, R * L * (80.0 if k > 32 else 40.0))
    return b, by, nbytes


#: bytes of the dense planes each slot-grid kernel's first version moved
#: (its inputs and its (R, L) outputs), for bound_dense_ms
DENSE_BYTES = {
    "K3": lambda k, L, R: R * (L // 4 + L // 8 + 5) + R * L * 20,
    "K4": lambda k, L, R: R * (L // 4 + L // 8 + 5) + R * L * 4 + R * 4,
    "K5": lambda k, L, R: R * (L // 4 + 4) + R * L * (20 if k > 32 else 12),
}


def grid_parity(rng, name: str, kern, plain, cases) -> list:
    """A slot-grid kernel (K3, K4, K5: name, its wrapper kern and plain
    version plain) against its plain version, exact (row totals and every
    live slot's pos and value planes), on cases (k, w, L, R) with the
    tile's slot budget, 1 row in 16 unused (mlen -1). Per tile: device
    time (ms, CUDA-graph replay), call_ms (events around wrapper calls,
    the measure of earlier runs), the plain version's time, grid_bound
    and the dense planes' bound (bound_dense_ms, DENSE_BYTES)."""
    tiles = []
    for k, w, L, R in cases:
        Br = v4_row_budget(L, w, default_budget_frac(w))
        pc, pv, mlen, allow = parity_tile(rng, k, w, L, R)

        def run():
            return kern(pc, pv, mlen, allow, k=k, w=w, Br=Br)

        def run_plain():
            return plain(pc, pv, mlen, allow, k=k, w=w, Br=Br)

        got = as_grid(run())
        slots = slot_mismatches(got, as_grid(run_plain()), Br,
                                f"{name} at (k, w, L, R) = {(k, w, L, R)}")
        overflow = int((got[2] > Br).sum())
        del got
        ms = graph_ms(run)
        call_ms = time_ms(run, 20)
        pms = time_ms(run_plain, 3, warm=1)
        b, by, nbytes = grid_bound(k, L, R, slots)
        dense, _ = bound_ms(DENSE_BYTES[name](k, L, R),
                            R * L * (80.0 if k > 32 else 40.0))
        tiles.append({"k": k, "w": w, "L": L, "R": R, "Br": Br, "ms": ms,
                      "call_ms": call_ms, "plain_ms": pms, "bytes": nbytes,
                      "bound_ms": b, "bound_by": by, "bound_dense_ms": dense,
                      "ratio_to_bound": ms / b, "slots": slots,
                      "overflow_rows": overflow})
    return tiles


def tile_sums(tiles: list, k: int, prefix: str = "") -> dict:
    """ms, call_ms, plain_ms, bound_ms and bound_dense_ms summed over the
    tiles at k, with bound_by, under names with prefix."""
    at_k = [t for t in tiles if t["k"] == k]
    out = {prefix + n: sum(t[n] for t in at_k)
           for n in ("ms", "call_ms", "plain_ms", "bound_ms",
                     "bound_dense_ms")}
    out[prefix + "bound_by"] = at_k[-1]["bound_by"]
    return out


def grid_phase(rng, phase: str, name: str, kern, plain, cases,
               sums: dict) -> dict:
    """grid_parity logged as a phase; sums: {prefix: k} of the tile sums
    (tile_sums) to report."""
    t0 = time.perf_counter()
    tiles = grid_parity(rng, name, kern, plain, cases)
    out = {"max_abs_err": 0}
    for prefix, k in sums.items():
        out.update(tile_sums(tiles, k, prefix))
    out["tiles"] = tiles
    log(phase, t0, **{name.lower(): json.dumps(tiles)})
    return out


def phase5_k3(rng) -> dict:
    """K3 (values_select) against its plain version on K3_TILES (the three
    k=41 default tiles summed for the kernel table)."""
    return grid_phase(rng, "5 K3 parity", "K3", K.values_select,
                      K.values_select_compact_plain, K3_TILES,
                      {"": K_WIDE})


#: K4's tiles: K4_TILES at k=31, w=15 and (1152, 2048) at (15, 5)
K4_CASES = [(K_, W_, L, R) for L, R in K4_TILES] + [(15, 5, 1152, 2048)]

#: K5's tiles: the three default tiles at k=31 and k=41, w=15, and
#: (2048, 2048) at (56, 9)
K5_CASES = [(k, W_, L, R) for k in (K_, K_WIDE)
            for L, R in DevicePipeline.DEFAULT_TILES] + [(56, 9, 2048, 2048)]


def phase9_k4(rng) -> dict:
    """K4 (select_csum) against its plain version (select_csum_slots_plain)
    on K4_CASES (the three K4_TILES summed for the kernel table)."""
    return grid_phase(rng, "9 K4 parity", "K4", K.select_csum,
                      K.select_csum_slots_plain, K4_CASES, {"": K_})


def phase10_k5(rng) -> dict:
    """K5 (values_argmin) against its plain version
    (values_argmin_slots_plain) on K5_CASES (the three default tiles at
    k=31 summed for the kernel table, at k=41 as k41_*)."""
    return grid_phase(rng, "10 K5 parity", "K5", K.values_argmin,
                      K.values_argmin_slots_plain, K5_CASES,
                      {"": K_, "k41_": K_WIDE})


def route_alone(rng, route: str, cases, dense) -> dict:
    """``--k3``, ``--k4``, ``--k5``: engine.select_slots on one route (its
    kernel and whatever torch work a tree runs after it) on cases, exact
    against dense (the route built from plain parts every tree has), by
    device time (CUDA-graph replay) and call_ms; ms_by_k and
    call_ms_by_k sum the tiles at each k."""
    out = {"ms_by_k": {}, "call_ms_by_k": {}, "max_abs_err": 0, "tiles": []}
    for k, w, L, R in cases:
        Br = v4_row_budget(L, w, default_budget_frac(w))
        pc, pv, mlen, allow = parity_tile(rng, k, w, L, R)

        def run():
            return select_slots(pc, pv, mlen, allow, k=k, w=w, Br=Br,
                                route=route)

        slots = slot_mismatches(
            run(), dense(pc, pv, mlen, allow, k=k, w=w, Br=Br), Br,
            f"select_slots {route} at (k, w, L, R) = {(k, w, L, R)}")
        ms = graph_ms(run)
        call_ms = time_ms(run, 20)
        out["ms_by_k"][k] = out["ms_by_k"].get(k, 0.0) + ms
        out["call_ms_by_k"][k] = out["call_ms_by_k"].get(k, 0.0) + call_ms
        out["tiles"].append({"k": k, "w": w, "L": L, "R": R, "Br": Br,
                             "ms": ms, "call_ms": call_ms, "slots": slots})
    return out


#: the route modes: route, its cases and its dense oracle
ROUTE_MODES = {"--k3": ("K3", K3_TILES, dense_k3_slots),
               "--k4": ("K4", K4_CASES, dense_k4_slots),
               "--k5": ("K5", K5_CASES, dense_k5_slots)}


# ---------------------------------------------------------------------------
# phase 3: CLI end to end, cuda against cpu
# ---------------------------------------------------------------------------

def write_fastq(path: str, records) -> None:
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b"@" + name + b"\n" + seq + b"\n+\n" + b"I" * len(seq)
                    + b"\n")


def write_fasta(path: str, records, width: int = 70) -> None:
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name + b"\n")
            for j in range(0, len(seq), width):
                f.write(seq[j:j + width] + b"\n")


def cli_index_build(fa: str, out: str, k: int, w: int, device: str,
                    *extra: str) -> None:
    args = ["index", "build", fa, "-k", str(k), "-w", str(w), "-o", out,
            "-q", "--device", device, *extra]
    rc = cli_main(args)
    if rc != 0:
        raise AssertionError(f"CLI exit {rc}: {args}")


def oracle_index(path: str, seqs, k: int, w: int, e: float = 0.0) -> bytes:
    """The index of seqs written from the host NumPy oracle
    (minimizers_np.compute_minimizer_hashes); returns its bytes."""
    parts = [dtt.compute_minimizer_hashes(s, k, w, e) for s in seqs]
    dtt.write_index(np.unique(np.concatenate(parts)),
                    dtt.IndexHeader.new(k, w), path)
    with open(path, "rb") as f:
        return f.read()


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def sample_read(rng, genome: bytes, n: int) -> bytes:
    if rng.random() < 0.5:
        s = int(rng.integers(0, len(genome) - n))
        r = genome[s:s + n]
        return revcomp(r) if rng.random() < 0.5 else r
    return rand_seq(rng, n)


def phase3(rng) -> dict:
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="deacon_torch_smoke_")
    try:
        genome = rand_seq(rng, 2_000_000)
        fa = os.path.join(tmp, "genome.fa")
        write_fasta(fa, [(b"genome", genome)])
        idx = os.path.join(tmp, "genome.idx")
        cli_index_build(fa, idx, K_, W_, "cuda")
        if read_bytes(idx) != oracle_index(os.path.join(tmp, "oracle.idx"),
                                           [genome], K_, W_):
            raise AssertionError("index build on the card differs from the "
                                 "oracle's index (k=31)")
        single = [(b"s%d" % i, sample_read(rng, genome, 150))
                  for i in range(3000)]
        single += [(b"long%d" % i,
                    sample_read(rng, genome, int(rng.integers(2000, 40000))))
                   for i in range(40)]
        # rows of the (2048, 2048) tile over their 384-slot minimizer
        # budget: rerun on the card
        single += [(b"lowc%d" % i, sample_read(rng, genome, 600)
                    + low_complexity(rng, int(rng.integers(600, 1400))))
                   for i in range(12)]
        pairs = [(sample_read(rng, genome, 150), sample_read(rng, genome, 150))
                 for _ in range(1500)]
        paths = {n: os.path.join(tmp, n) for n in ("s.fq", "r1.fq", "r2.fq")}
        write_fastq(paths["s.fq"], single)
        write_fastq(paths["r1.fq"], [(b"p%d/1" % i, a)
                                     for i, (a, _) in enumerate(pairs)])
        write_fastq(paths["r2.fq"], [(b"p%d/2" % i, b)
                                     for i, (_, b) in enumerate(pairs)])
        reset_launches()
        runs = 0
        for deplete in ([], ["--deplete"]):
            for inputs, two in (([paths["s.fq"]], False),
                                ([paths["r1.fq"], paths["r2.fq"]], True)):
                got = {}
                for device in ("cuda", "cpu"):
                    out = os.path.join(tmp, f"o_{device}.fq")
                    out2 = os.path.join(tmp, f"o2_{device}.fq")
                    summ = os.path.join(tmp, f"s_{device}.json")
                    args = ["filter", idx, *inputs, "-o", out, "-a", "2",
                            "-s", summ, "-q", "--device", device, *deplete]
                    if two:
                        args += ["-O", out2]
                    rc = cli_main(args)
                    if rc != 0:
                        raise AssertionError(f"CLI exit {rc}: {args}")
                    with open(summ) as f:
                        s = json.load(f)
                    for key in ("version", "time", "seqs_per_second",
                                "bp_per_second", "output", "output2"):
                        s.pop(key)
                    got[device] = (
                        open(out, "rb").read(),
                        open(out2, "rb").read() if two else b"",
                        s,
                    )
                    runs += 1
                if got["cuda"] != got["cpu"]:
                    raise AssertionError(
                        f"cuda and cpu CLI outputs differ ({inputs}, "
                        f"{deplete})")
                if not got["cuda"][0]:
                    raise AssertionError("empty CLI output")
        launches = launch_counts()
        check_route(launches, "K1", "filter at k=31")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("3 cli end to end", t0, runs=runs, kept_bytes=len(got["cuda"][0]),
        launches=json.dumps(launches))
    return launches


def dirty_records(rng, n: int, lo: int, hi: int):
    """n FASTA records of lo..hi bases: runs of N, IUPAC codes, a
    lowercase stretch and a 2-4 kbp low-complexity stretch (half poly-A,
    whose k-mers fail an entropy threshold of 0.5; its rows go over their
    minimizer budget) in each."""
    recs = []
    for i in range(n):
        s = bytearray(rand_seq(rng, int(rng.integers(lo, hi))))
        for _ in range(5):
            b = int(rng.integers(0, len(s) - 300))
            run = int(rng.integers(1, 300))
            s[b:b + run] = b"N" * run
        for j in rng.integers(0, len(s), 40):
            s[int(j)] = b"RYKMSWBDHVN"[int(rng.integers(0, 11))]
        a = int(rng.integers(0, len(s) - 5000))
        s[a:a + 5000] = bytes(s[a:a + 5000]).lower()
        m = int(rng.integers(2000, 4001))
        a = int(rng.integers(0, len(s) - m))
        s[a:a + m] = b"A" * (m // 2) + low_complexity(rng, m - m // 2)
        recs.append((b"chr%d seeded record" % i, bytes(s)))
    return recs


def phase6_wide_cli(rng) -> dict:
    """Phase 3 at k=41: index build (card and CPU, with and without
    -e 0.5) against the oracle's index, then filter cuda against cpu."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="deacon_torch_smoke_wide_")
    k = K_WIDE
    try:
        recs = dirty_records(rng, 6, 40_000, 120_000)
        fa = os.path.join(tmp, "ref.fa")
        write_fasta(fa, recs)
        seqs = [s for _, s in recs]
        reset_launches()
        sizes = []
        for e in ([], ["-e", "0.5"]):
            built = {}
            for device in ("cuda", "cpu"):
                built[device] = os.path.join(tmp, f"{device}{len(e)}.idx")
                cli_index_build(fa, built[device], k, W_, device, *e)
            want = oracle_index(os.path.join(tmp, "oracle.idx"), seqs, k,
                                W_, float(e[1]) if e else 0.0)
            for device, path in built.items():
                if read_bytes(path) != want:
                    raise AssertionError(
                        f"index build -k {k} {e} on {device} differs from "
                        "the oracle's index")
            sizes.append(len(want))
        if not sizes[1] < sizes[0]:
            raise AssertionError("-e 0.5 filtered no k-mer of the FASTA")
        build_launches = launch_counts()
        if build_launches["K3"] <= 0 or any(
                build_launches[n] for n in ("K1", "K4", "K5")):
            raise AssertionError(f"index build -k {k}: {build_launches}")
        idx = os.path.join(tmp, "cuda0.idx")  # built without -e
        genome = b"".join(seqs)
        single = [(b"s%d" % i, sample_read(rng, genome, 150))
                  for i in range(1500)]
        single += [(b"long%d" % i,
                    sample_read(rng, genome, int(rng.integers(2000, 20000))))
                   for i in range(20)]
        lowc = [sample_read(rng, genome, 600)
                + low_complexity(rng, int(rng.integers(600, 1400)))
                for _ in range(12)]
        single += [(b"lowc%d" % i, r) for i, r in enumerate(lowc)]
        # a row of the (2048, 2048) tile over its 384-slot budget
        over = sum(
            get_minimizer_hashes_and_positions(r, 0, k, W_)[0].size
            > v4_row_budget(2048, W_, default_budget_frac(W_))
            for r in lowc)
        if over == 0:
            raise AssertionError("no read goes over its minimizer budget")
        pairs = [(sample_read(rng, genome, 150), sample_read(rng, genome, 150))
                 for _ in range(800)]
        paths = {n: os.path.join(tmp, n) for n in ("s.fq", "r1.fq", "r2.fq")}
        write_fastq(paths["s.fq"], single)
        write_fastq(paths["r1.fq"], [(b"p%d/1" % i, a)
                                     for i, (a, _) in enumerate(pairs)])
        write_fastq(paths["r2.fq"], [(b"p%d/2" % i, b)
                                     for i, (_, b) in enumerate(pairs)])
        reset_launches()
        runs, kept = 0, 0
        for deplete in ([], ["--deplete"]):
            for inputs, two in (([paths["s.fq"]], False),
                                ([paths["r1.fq"], paths["r2.fq"]], True)):
                got = {}
                for device in ("cuda", "cpu"):
                    out = os.path.join(tmp, f"o_{device}.fq")
                    out2 = os.path.join(tmp, f"o2_{device}.fq")
                    args = ["filter", idx, *inputs, "-o", out, "-a", "2",
                            "-q", "--device", device, *deplete]
                    if two:
                        args += ["-O", out2]
                    rc = cli_main(args)
                    if rc != 0:
                        raise AssertionError(f"CLI exit {rc}: {args}")
                    got[device] = (read_bytes(out),
                                   read_bytes(out2) if two else b"")
                    runs += 1
                if got["cuda"] != got["cpu"]:
                    raise AssertionError(
                        f"k={k}: cuda and cpu CLI outputs differ "
                        f"({inputs}, {deplete})")
                kept += len(got["cuda"][0])
        if kept == 0:
            raise AssertionError("empty CLI output at k=41")
        launches = launch_counts()
        check_route(launches, "K3", f"k={k} filter")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("6 cli at k=41", t0, index_bp=sum(map(len, seqs)),
        builds=4, index_bytes=json.dumps(sizes), filter_runs=runs,
        reads_over_budget=over,
        build_launches=json.dumps(build_launches),
        filter_launches=json.dumps(launches))
    return launches


def filter_both(idx: str, inputs: list[str], out_dir: str, tag: str,
                extra=()) -> bytes:
    """``filter`` on the card and on the CPU; their outputs (and -O
    outputs) must be byte-identical. Returns the card's output."""
    got = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(out_dir, f"{tag}_{device}.fq")
        args = ["filter", idx, *inputs, "-o", out, "-a", "2", "-q",
                "--device", device, *extra]
        if len(inputs) == 2:
            args += ["-O", out + ".2"]
        rc = cli_main(args)
        if rc != 0:
            raise AssertionError(f"CLI exit {rc}: {args}")
        got[device] = (read_bytes(out),
                       read_bytes(out + ".2") if len(inputs) == 2 else b"")
    if got["cuda"] != got["cpu"]:
        raise AssertionError(f"{tag}: cuda and cpu CLI outputs differ")
    if not got["cuda"][0]:
        raise AssertionError(f"{tag}: empty CLI output")
    return got["cuda"][0]


def phase11_switch_cli(rng) -> dict:
    """The CLI under the engine's switches, card against CPU: ``index
    build`` under DEACON_PALLAS=1 at k=31 and 41 byte-identical to the
    oracle's index (K5 only); then ``filter``, single and paired, under
    DEACON_TPU_TILES=K4_TILES (K4), DEACON_ENGINE=3 (K4), DEACON_ENGINE=2
    (K3) and DEACON_PALLAS=1 at k=31 and 41 (K5), each with the launch
    counters checked. Then phase 12: one ``filter`` with .zst input and
    output on the card, its decompressed output equal to the plain run's."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="deacon_torch_smoke_switch_")
    out: dict = {"index_build": {}, "filter": {}}
    try:
        genome = rand_seq(rng, 600_000)
        fa = os.path.join(tmp, "genome.fa")
        write_fasta(fa, [(b"genome", genome)])
        idx = {}
        for k in (K_, K_WIDE):
            want = oracle_index(os.path.join(tmp, "oracle.idx"), [genome], k,
                                W_)
            with switches(DEACON_PALLAS="1"):
                reset_launches()
                for device in ("cuda", "cpu"):
                    path = os.path.join(tmp, f"p1_{device}_{k}.idx")
                    cli_index_build(fa, path, k, W_, device)
                    if read_bytes(path) != want:
                        raise AssertionError(
                            f"index build -k {k} under DEACON_PALLAS=1 on "
                            f"{device} differs from the oracle's index")
                launches = launch_counts()
            others = [n for n in SELECT if n != "K5" and launches[n]]
            if launches["K5"] <= 0 or others:
                raise AssertionError(f"index build -k {k} under "
                                     f"DEACON_PALLAS=1: {launches}")
            out["index_build"][f"k{k}"] = launches
            idx[k] = os.path.join(tmp, f"p1_cuda_{k}.idx")
        single = [(b"s%d" % i, sample_read(rng, genome, 150))
                  for i in range(1500)]
        single += [(b"long%d" % i,
                    sample_read(rng, genome, int(rng.integers(2000, 20000))))
                   for i in range(20)]
        single += [(b"lowc%d" % i, sample_read(rng, genome, 600)
                    + low_complexity(rng, int(rng.integers(600, 1400))))
                   for i in range(8)]
        pairs = [(sample_read(rng, genome, 150),
                  sample_read(rng, genome, 150)) for _ in range(500)]
        paths = {n: os.path.join(tmp, n) for n in ("s.fq", "r1.fq", "r2.fq")}
        write_fastq(paths["s.fq"], single)
        write_fastq(paths["r1.fq"], [(b"p%d/1" % i, a)
                                     for i, (a, _) in enumerate(pairs)])
        write_fastq(paths["r2.fq"], [(b"p%d/2" % i, b)
                                     for i, (_, b) in enumerate(pairs)])
        cases = [("tiles", {"DEACON_TPU_TILES": K4_TILES_ENV}, K_, "K4"),
                 ("engine3", {"DEACON_ENGINE": "3"}, K_, "K4"),
                 ("engine2", {"DEACON_ENGINE": "2"}, K_, "K3"),
                 ("pallas1", {"DEACON_PALLAS": "1"}, K_, "K5"),
                 ("pallas1_k41", {"DEACON_PALLAS": "1"}, K_WIDE, "K5")]
        for name, env, k, kernel in cases:
            with switches(**env):
                reset_launches()
                filter_both(idx[k], [paths["s.fq"]], tmp, name)
                filter_both(idx[k], [paths["r1.fq"], paths["r2.fq"]], tmp,
                            name + "_paired", ["--deplete"])
                launches = launch_counts()
            check_route(launches, kernel, f"filter under {env} at k={k}")
            out["filter"][name] = launches
        log("11 cli under the switches", t0, **{
            n: json.dumps(v) for n, v in out.items()})
        # phase 12: .zst in and out on the card, through libzstd
        t0 = time.perf_counter()
        try:
            zstd.library("chip_smoke")
            loaded = True
        except zstd.ZstdError as e:
            loaded = False
            print(f"[phase 12] libzstd: {e}", flush=True)
        plain = filter_both(idx[K_], [paths["s.fq"]], tmp, "plain")
        zin = paths["s.fq"] + ".zst"
        with open(zin, "wb") as f:
            w = zstd.Writer(f, 3, zin)
            w.write(read_bytes(paths["s.fq"]))
            w.close()
        zout = os.path.join(tmp, "o.fq.zst")
        rc = cli_main(["filter", idx[K_], zin, "-o", zout, "-a", "2", "-q",
                       "--device", "cuda"])
        if rc != 0:
            raise AssertionError(f".zst filter: CLI exit {rc} (libzstd "
                                 f"loaded: {loaded})")
        raw = read_bytes(zout)
        with open_maybe_compressed(zout) as f:
            unpacked = f.read()
        if not raw.startswith(b"\x28\xb5\x2f\xfd") or unpacked != plain:
            raise AssertionError(".zst filter output differs from the plain "
                                 "run's")
        out["zst"] = {"libzstd_loaded": loaded, "in_bytes": len(
            read_bytes(zin)), "out_bytes": len(raw),
            "out_decompressed_bytes": len(unpacked)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("12 zst", t0, zst=json.dumps(out["zst"]))
    return out


def phase14_mesh_cli(rng) -> dict:
    """``filter --mesh``: on the card with --mesh 1x1, byte-identical to
    the same run without --mesh and to --device cpu --mesh 2x4, single
    and paired (-O); --mesh 1x2 with one card exits 1 with "need 2
    devices, have 1" on stderr."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="deacon_torch_smoke_mesh_")
    out: dict = {}
    try:
        genome = rand_seq(rng, 400_000)
        fa = os.path.join(tmp, "genome.fa")
        write_fasta(fa, [(b"genome", genome)])
        idx = os.path.join(tmp, "genome.idx")
        cli_index_build(fa, idx, K_, W_, "cuda")
        single = [(b"s%d" % i, sample_read(rng, genome, 150))
                  for i in range(1500)]
        single += [(b"long%d" % i,
                    sample_read(rng, genome, int(rng.integers(2000, 20000))))
                   for i in range(10)]
        single += [(b"lowc%d" % i, sample_read(rng, genome, 600)
                    + low_complexity(rng, int(rng.integers(600, 1400))))
                   for i in range(6)]
        pairs = [(sample_read(rng, genome, 150),
                  sample_read(rng, genome, 150)) for _ in range(500)]
        paths = {n: os.path.join(tmp, n) for n in ("s.fq", "r1.fq", "r2.fq")}
        write_fastq(paths["s.fq"], single)
        write_fastq(paths["r1.fq"], [(b"p%d/1" % i, a)
                                     for i, (a, _) in enumerate(pairs)])
        write_fastq(paths["r2.fq"], [(b"p%d/2" % i, b)
                                     for i, (_, b) in enumerate(pairs)])
        for name, inputs in (("single", [paths["s.fq"]]),
                             ("paired", [paths["r1.fq"], paths["r2.fq"]])):
            got = {}
            for tag, extra in (("plain", ["--device", "cuda"]),
                               ("mesh1x1", ["--device", "cuda", "--mesh",
                                            "1x1"]),
                               ("cpu2x4", ["--device", "cpu", "--mesh",
                                           "2x4"])):
                o = os.path.join(tmp, f"{name}_{tag}.fq")
                args = ["filter", idx, *inputs, "-o", o, "-a", "2", "-q",
                        *extra]
                if len(inputs) == 2:
                    args += ["-O", o + ".2"]
                if tag == "mesh1x1":
                    reset_launches()
                rc = cli_main(args)
                if rc != 0:
                    raise AssertionError(f"CLI exit {rc}: {args}")
                if tag == "mesh1x1":
                    out[f"{name}_mesh1x1_launches"] = launch_counts()
                got[tag] = (read_bytes(o), read_bytes(o + ".2")
                            if len(inputs) == 2 else b"")
            if not (got["plain"] == got["mesh1x1"] == got["cpu2x4"]
                    and got["plain"][0]):
                raise AssertionError(f"{name}: filter --mesh outputs differ "
                                     "from the run without --mesh")
            check_route(out[f"{name}_mesh1x1_launches"], "K1",
                        f"{name} filter --mesh 1x1")
            out[f"{name}_bytes"] = len(got["plain"][0]) + len(got["plain"][1])
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli_main(["filter", idx, paths["s.fq"], "-o",
                           os.path.join(tmp, "m12.fq"), "-q", "--mesh",
                           "1x2"])
        cards = torch.cuda.device_count()
        want = "need 2 devices, have 1" if cards == 1 else None
        if want is not None and (rc != 1 or want not in err.getvalue()):
            raise AssertionError(f"--mesh 1x2 on one card: exit {rc}, "
                                 f"stderr {err.getvalue()!r}")
        out["mesh1x2"] = {"cards": cards, "exit": rc,
                          "stderr": err.getvalue().strip()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("14 cli --mesh", t0, **{n: json.dumps(v) for n, v in out.items()})
    return out


# ---------------------------------------------------------------------------
# phase 4: panhuman scale against an independent reference
# ---------------------------------------------------------------------------

def _fmix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)


def reference_minimizers(seqs: list[bytes], units: np.ndarray, dev,
                         k: int = K_):
    """Filter-side minimizers of every read (the NumPy oracle's rules,
    ops/minimizers_np), computed over one flat arena of all reads on the
    device: canonical values (128-bit as two int64 halves for k > 32)
    built base by base, fmix32 selection keys of the xor of their 32-bit
    limbs, the leftmost minimum of every whole window of w k-mers (of all
    k-mers for a read with fewer than w), ACGT-valid k-mers only. Base
    codes and validity follow the spec ((byte >> 1) & 3; ACGTacgt) and
    the hashes are the NumPy XXH3 of utils/xxh3, so no code of the path
    under test is shared. Returns (unit of each minimizer, its XXH3-64
    hash)."""
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    arena = np.frombuffer(b"".join(seqs), np.uint8)
    n = arena.size
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    code = torch.from_numpy(((arena >> 1) & 3).astype(np.int64)).to(dev)
    acgt = np.isin(arena, np.frombuffer(b"ACGTacgt", np.uint8))
    bad = torch.from_numpy((~acgt).astype(np.int64)).to(dev)
    read = torch.from_numpy(np.repeat(np.arange(len(seqs)), lens)).to(dev)
    start = torch.from_numpy(starts).to(dev)[read]
    m_of = torch.from_numpy(lens - k + 1).to(dev)[read]  # k-mers per read
    rel = torch.arange(n, device=dev) - start

    def shifted(x, s, fill=0):
        return torch.cat([x[s:], torch.full((s,), fill, dtype=x.dtype,
                                            device=dev)])

    zero = torch.zeros_like(code)
    f_lo, f_hi, r_lo, r_hi = code, zero, code ^ 2, zero
    for i in range(1, k):
        c = shifted(code, i)
        if i < 32:
            f_lo = f_lo | (c << (2 * i))
        else:
            f_hi = f_hi | (c << (2 * (i - 32)))
        r_hi = (r_hi << 2) | lsr(r_lo, 62)
        r_lo = (r_lo << 2) | (c ^ 2)
    fh, rh = f_hi ^ I64_MIN, r_hi ^ I64_MIN
    take_f = (fh < rh) | ((fh == rh) & ((f_lo ^ I64_MIN) <= (r_lo ^ I64_MIN)))
    lo = torch.where(take_f, f_lo, r_lo)
    hi = torch.where(take_f, f_hi, r_hi)
    del f_lo, f_hi, r_lo, r_hi, fh, rh, take_f
    fold = zero
    for v in (lo, hi):
        fold = fold ^ (v & 0xFFFFFFFF) ^ lsr(v, 32)
    key = _fmix32(fold)
    key = (key >> 16) << 40 | rel  # priority, then leftmost position
    is_kmer = rel < m_of
    big = torch.iinfo(torch.int64).max
    key = torch.where(is_kmer, key, big)
    win = torch.stack([shifted(key, j, big) for j in range(W_)])
    wmin = win.min(dim=0).values
    whole = is_kmer & (rel + W_ <= m_of)  # window of w k-mers in the read
    sel = torch.full((n,), -1, dtype=torch.int64, device=dev)
    sel[whole] = start[whole] + (wmin[whole] & ((1 << 40) - 1))
    short = torch.from_numpy(lens - k + 1 <= W_).to(dev)  # one window
    short_read = short[read] & is_kmer
    if bool(short_read.any()):
        smin = torch.full((len(seqs),), big, dtype=torch.int64, device=dev)
        smin.scatter_reduce_(0, read[short_read], key[short_read], "amin")
        first_pos = short_read & (rel == 0)
        sel[first_pos] = start[first_pos] + (smin[read[first_pos]]
                                             & ((1 << 40) - 1))
    pos = torch.unique(sel[sel >= 0])  # distinct minimizer positions
    csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      bad.cumsum(0)])
    ok = (csum[pos + k] - csum[pos]) == 0
    pos = pos[ok]
    v_lo = lo[pos].cpu().numpy().view(np.uint64)
    if k <= 32:
        h = xxh3_64_u64(v_lo)
    else:
        h = xxh3_64_u128(v_lo, hi[pos].cpu().numpy().view(np.uint64))
    return (torch.from_numpy(units).to(dev)[read[pos]],
            torch.from_numpy(h.view(np.int64)).to(dev))


def reference_counts(seqs, units, n_units, keys_signed_sorted, dev, k):
    """(hits, totals) per unit: searchsorted membership on the sorted index
    keys, distinct member hashes per unit with torch.unique."""
    unit, h = reference_minimizers(seqs, units, dev, k)
    totals = torch.bincount(unit, minlength=n_units)
    q = h ^ I64_MIN
    i = torch.searchsorted(keys_signed_sorted, q).clamp(
        max=keys_signed_sorted.numel() - 1)
    member = keys_signed_sorted[i] == q
    pairs = torch.stack([unit[member], h[member]], dim=1)
    distinct = torch.unique(pairs, dim=0)
    hits = torch.bincount(distinct[:, 0], minlength=n_units)
    return hits.cpu().numpy(), totals.cpu().numpy()


def low_complexity(rng, n: int) -> bytes:
    """A poly-A, poly-G or short tandem repeat stretch of n bases."""
    unit = [b"A", b"G", b"AC", b"CAG", b"TTAGGG"][int(rng.integers(0, 5))]
    return (unit * (n // len(unit) + 1))[:n]


def make_reads(rng, genome: bytes):
    """~20 Mbp: Illumina-like 150 bp single and paired (1 in 20 with a
    20-100 bp poly-G tail), ONT-like 1-16 kbp (1 in 15 with a 300-3000 bp
    low-complexity stretch, which takes its rows over their minimizer
    budget), and a few reads over 16 kbp (chunked); half from the
    genome."""
    def illumina():
        r = sample_read(rng, genome, 150)
        if rng.random() < 0.05:
            t = int(rng.integers(20, 101))
            r = r[:150 - t] + b"G" * t
        return r

    def ont_read(n):
        r = sample_read(rng, genome, n)
        if rng.random() < 1 / 15:
            m = int(rng.integers(300, min(3000, n // 2) + 1))
            a = int(rng.integers(0, n - m))
            r = r[:a] + low_complexity(rng, m) + r[a + m:]
        return r

    single = [illumina() for _ in range(40_000)]
    pairs = [(illumina(), illumina()) for _ in range(20_000)]
    ont = [ont_read(int(rng.integers(1000, 16001))) for _ in range(900)]
    ont += [sample_read(rng, genome, int(rng.integers(16_500, 60_000)))
            for _ in range(10)]
    return single, pairs, ont


class _Cfg:  # the threshold fields DeviceDecider's decisions read
    abs_threshold, rel_threshold, deplete, debug = 2, 0.01, False, False


def run_decider(decider, single, pairs, ont, batch: int = 10_000):
    """Launch every batch as the filter engine does (each batch's reads in
    one byte arena, pairs adjacent), resolve in order; returns every
    unit's (keep, hits, total)."""
    futs = []
    for i in range(0, len(single), batch):
        futs.append(decider.launch(*join_seqs(single[i:i + batch]), False,
                                   0, _Cfg))
    for i in range(0, len(ont), 500):
        futs.append(decider.launch(*join_seqs(ont[i:i + 500]), False, 0,
                                   _Cfg))
    for i in range(0, len(pairs), batch):
        futs.append(decider.launch(
            *join_seqs([s for pr in pairs[i:i + batch] for s in pr]), True,
            0, _Cfg))
    out = [f() for f in futs]
    return list(zip(np.concatenate([d.keep for d in out]).tolist(),
                    np.concatenate([d.hits for d in out]).tolist(),
                    np.concatenate([d.totals for d in out]).tolist()))


def where_time_goes(decider, single, pairs, ont, run_s: float) -> dict:
    """The timed window's reads once more under torch.profiler (device
    time by kernel: rows whose device type is CUDA, so no op is counted
    twice; the top six, and each of the port's own kernels) and once
    under cProfile (host time by function). The device's
    busy share is its kernel and copy time over the unprofiled window."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_decider(decider, single, pairs, ont)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(r[1] for r in rows) / 1e6
    top_dev = [{"name": k[:48], "ms": round(t / 1e3, 3), "n": n}
               for k, t, n in sorted(rows, key=lambda r: -r[1])[:6]]
    # the port's own kernels, listed or not among the top six
    own = {}
    for key, t, n in rows:
        for name, kernel in OWN_KERNELS.items():
            if kernel in key:
                e = own.setdefault(name, {"ms": 0.0, "n": 0})
                e["ms"] = round(e["ms"] + t / 1e3, 4)
                e["n"] += n
    host = cProfile.Profile()
    host.enable()
    run_decider(decider, single, pairs, ont)
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host).stats
    top_host = [{"fn": f"{fn[0].rsplit('/', 1)[-1]}:{fn[2]}",
                 "self_s": round(v[2], 3), "cum_s": round(v[3], 3)}
                for fn, v in sorted(stats.items(), key=lambda kv: -kv[1][2])[:6]]
    return {"device_s": round(device_s, 4),
            "device_busy_share": round(device_s / run_s, 4),
            "top_device": top_dev, "own_kernels": own,
            "top_host_self": top_host}


def switch_window(table, k: int, reads, ref, n_bp: int, label: str,
                  env: dict, kernel: str) -> dict:
    """The panhuman window's reads once more under a switch, through a
    DeviceDecider sharing the table: every unit equal to the reference
    counts (which no route changes), Mbp/s, reruns, the window's launches
    of each kernel (kernel must be its only selection kernel) and where
    the time goes (busy share, device and host time by name)."""
    t0 = time.perf_counter()
    single, pairs, ont = reads
    with switches(**env):
        decider = DeviceDecider(DevicePipeline(table, k, W_, device="cuda"))
        routes = sorted(set(decider.pipe.routes.values()))
        run_decider(decider, single[:2000], pairs[:1000], ont[:20])
        torch.cuda.synchronize()
        pipe = decider.pipe
        pipe.rerun_batches = pipe.rerun_units = 0
        reset_launches()
        t_run = time.perf_counter()
        decisions = run_decider(decider, single, pairs, ont)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches = launch_counts()
        reruns = {"batches": pipe.rerun_batches, "units": pipe.rerun_units}
        check_route(launches, kernel, f"window {label}")
        hits_ref, tot_ref = ref
        got_h = np.array([d[1] for d in decisions])
        got_t = np.array([d[2] for d in decisions])
        bad = np.nonzero((got_h != hits_ref) | (got_t != tot_ref))[0]
        if bad.size:
            i = int(bad[0])
            raise AssertionError(
                f"window {label}: {bad.size} units differ from the "
                f"reference; first {i}: got {(got_h[i], got_t[i])}, want "
                f"{(hits_ref[i], tot_ref[i])}")
        split = where_time_goes(decider, single, pairs, ont, run_s)
    numbers = {"switch": env, "routes": routes, "mbp": n_bp / 1e6,
               "run_s": round(run_s, 3),
               "mbp_per_s": round(n_bp / 1e6 / run_s, 3),
               "on_card_rerun_batches": reruns["batches"],
               "on_card_rerun_units": reruns["units"],
               "timed_window_launches": launches, **split}
    log(f"{label} panhuman scale k={k} under a switch", t0, **{
        n: json.dumps(v) for n, v in numbers.items()})
    return numbers


def panhuman_keys(rng, k: int, phase: str):
    """A seeded 5 Mbp genome and the index keys of phases 4 and 7: 4.1e8
    random u64 keys made on the card plus the genome's minimizers at k,
    distinct and sorted. Returns (genome, its minimizers, keys, seconds
    to make the keys)."""
    dev = torch.device("cuda")
    genome = rand_seq(rng, 5_000_000)
    g_hashes = dtt.compute_minimizer_hashes(genome, k, W_)
    t_keys = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + int(phase))
    keys = torch.randint(I64_MIN, (1 << 63) - 1, (PANHUMAN_KEYS,),
                         device=dev, dtype=torch.int64, generator=gen)
    keys = torch.cat([keys, torch.from_numpy(g_hashes.view(np.int64)).to(dev)])
    keys_u = sorted_unique_keys(keys)
    del keys
    torch.cuda.synchronize()
    return genome, g_hashes, keys_u, time.perf_counter() - t_keys


def panhuman(rng, k: int, phase: str, windows=(), sharded: bool = False,
             served: bool = False):
    """Phase 4 (k=31) or 7 (k=41): a panhuman-scale table and ~20 Mbp of
    reads through DeviceDecider, every unit against the reference; then
    the same reads under each of ``windows`` ((label, switches, kernel)),
    with ``sharded`` phase 13 (K2's sharded form on the table and the
    main-path stream) and window 4d (the reads through DeviceDecider
    over a 2x4 mesh of the card), and with ``served`` phases 15 and 16 (the
    keys written to an index file: the server and client, index diff and
    union, and phase 17's codec part), before the table is freed."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    genome, g_hashes, keys_u, keys_s = panhuman_keys(rng, k, phase)
    dev = keys_u.device
    t_tab = time.perf_counter()
    decider = DeviceDecider(DevicePipeline(keys_u, k, W_, device="cuda"))
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t_tab
    table = decider.pipe.blocks[0][0]
    single, pairs, ont = make_reads(rng, genome)
    n_bp = (sum(map(len, single)) + sum(len(a) + len(b) for a, b in pairs)
            + sum(map(len, ont)))
    run_decider(decider, single[:2000], pairs[:1000], ont[:20])  # warm-up
    torch.cuda.synchronize()
    pipe = decider.pipe
    pipe.rerun_batches = pipe.rerun_units = 0
    reset_launches()
    t_run = time.perf_counter()
    decisions = run_decider(decider, single, pairs, ont)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = launch_counts()
    wide = k > 32
    check_route(launches, "K3" if wide else "K1", f"k={k}: timed window")
    reruns = {"batches": pipe.rerun_batches, "units": pipe.rerun_units}
    if reruns["units"] == 0:
        raise AssertionError("no row went over its minimizer budget: the "
                             "on-card rerun was not exercised")
    # independent reference on the card, every read and pair
    seqs = single + ont + [s for pr in pairs for s in pr]
    n_u = len(single) + len(ont) + len(pairs)
    units = np.concatenate([
        np.arange(len(single) + len(ont)),
        len(single) + len(ont) + np.repeat(np.arange(len(pairs)), 2),
    ])
    hits_ref, tot_ref = reference_counts(seqs, units, n_u, keys_u ^ I64_MIN,
                                         dev, k)
    got_h = np.array([d[1] for d in decisions])
    got_t = np.array([d[2] for d in decisions])
    bad = np.nonzero((got_h != hits_ref) | (got_t != tot_ref))[0]
    if bad.size:
        i = int(bad[0])
        raise AssertionError(
            f"{bad.size} units differ from the reference; first {i}: "
            f"got {(got_h[i], got_t[i])}, want {(hits_ref[i], tot_ref[i])}")
    t_prof = time.perf_counter()
    split = where_time_goes(decider, single, pairs, ont, run_s)
    log(f"{phase} where the time goes", t_prof, **{
        name: json.dumps(v) for name, v in split.items()})
    stream = None if wide else main_path_stream(decider.pipe, single[:8192])
    k2 = None if stream is None else measure_k2(table, *stream)
    numbers = {
        "keys": int(keys_u.numel()), "p": table.p, "sp": table.sp,
        "table_gb": round(table.nbytes / 1e9, 3),
        "keys_sort_s": round(keys_s, 3), "table_build_s": round(table_s, 3),
        "reads": len(single) + len(ont) + 2 * len(pairs), "mbp": n_bp / 1e6,
        "run_s": round(run_s, 3), "mbp_per_s": round(n_bp / 1e6 / run_s, 3),
        "hit_units": int((got_h > 0).sum()), "units": n_u,
        "on_card_rerun_batches": reruns["batches"],
        "on_card_rerun_units": reruns["units"],
        "timed_window_launches": launches,
        "max_memory_allocated_gb": round(
            torch.cuda.max_memory_allocated() / 1e9, 3),
    }
    log(f"{phase} panhuman scale k={k}", t0, **numbers, k2=json.dumps(k2))
    extra = {label: switch_window(table, k, (single, pairs, ont),
                                  (hits_ref, tot_ref), n_bp, label, env,
                                  kernel)
             for label, env, kernel in windows}
    k2_sharded = None
    if sharded:
        k2_sharded = phase13_k2_sharded(keys_u, table, stream)
        extra["4d"] = sharded_window(keys_u, k, (single, pairs, ont),
                                     (hits_ref, tot_ref), n_bp)
    if served:
        extra.update(file_phases(keys_u, genome, g_hashes, single, pairs,
                                 ont))
    return {"numbers": numbers, "k2": k2, "launches": launches,
            "windows": extra, "k2_sharded": k2_sharded}


def k2_bound(table, key, srid, first, n_seg: int, blocks=None) -> dict:
    """K2's bound on one sorted stream, for the whole table or (blocks:
    (row_lo, rows) of each shard) the S launches together, which split
    the stream between them. Bytes: the stream's (4 B srid per query, 4 B
    first per real one, 8 B key per live one (real and first of its
    run)), one 32 B sector of each distinct main row that the live
    queries touch, one of each distinct spill row that a full main row
    sends a query to (not in the row, above its slot 127), and the 4 B
    hits per read of each launch; operations: one sector's four 64-bit
    compares per probed row. bound_scan_ms is the bound of a kernel that
    scans rows, as the first version of K2 did, for the same stream: each
    shard reads the whole stream, each row and each spill row of a
    non-member is read whole (1 KB), and every slot is compared."""
    p, sp = table.p, table.sp
    blocks = blocks or [(0, 1 << p)]
    real = srid >= 0
    live = real & (first != 0)
    q, n_real = key.numel(), int(real.sum())
    lk = key[live]
    n_live = lk.numel()
    bucket = lsr(lk, 64 - p)
    main = K._member_plain(table.slots, p, lk)
    last = table.slots[:, 127][bucket]
    sent = (~main & (lsr(last, 64 - p) == bucket)
            & ((last ^ I64_MIN) < (lk ^ I64_MIN)))
    rows = int(torch.unique(bucket).numel())
    spill_rows = spill_rows_scan = 0
    if sp:
        for lo, n in blocks:
            own = (bucket >= lo) & (bucket < lo + n)
            spill_rows += int(torch.unique(
                lsr(lk[own & sent], 64 - sp)).numel())
            spill_rows_scan += int(torch.unique(
                lsr(lk[own & ~main], 64 - sp)).numel())
    stream = 4 * q + 4 * n_real + 8 * n_live
    s = len(blocks)
    nbytes = stream + 32 * (rows + spill_rows) + 4 * n_seg * s
    n_sent = int(sent.sum()) if sp else 0
    b, by = bound_ms(nbytes, (n_live + n_sent) * 8.0)
    scan_bytes = (s * (stream + 4 * n_seg)
                  + 1024 * (rows + spill_rows_scan))
    n_miss = int((~main).sum()) if sp else 0
    scan, _ = bound_ms(scan_bytes, (n_live + n_miss) * 128 * 2.0)
    return {"q": q, "p": p, "sp": sp, "real": n_real, "live": n_live,
            "rows_touched": rows, "spill_rows": spill_rows,
            "spill_probes": n_sent, "bytes": nbytes, "bound_ms": b,
            "bound_by": by, "scan_bytes": scan_bytes, "bound_scan_ms": scan}


def measure_k2(table, key, srid, first, n_seg: int) -> dict:
    """K2 against its plain version on one sorted stream: exactness; ms,
    its device time (CUDA-graph replay); cold_ms, the same with the L2
    cache flushed before each call; call_ms, events around wrapper calls
    (the earlier measure, which counts the wrapper's host time where
    that is longer); the plain version's ms; the bound (k2_bound)."""
    args = (table.slots, table.spill, key, srid, first)
    kw = {"p": table.p, "sp": table.sp, "num_segments": n_seg}
    h_k = K.probe_hits(*args, **kw)
    h_p = K.probe_hits_plain(*args, **kw)
    torch.cuda.synchronize()
    err = int((h_k - h_p).abs().max())
    if err:
        raise AssertionError(f"K2 differs from its plain version (p={table.p})")

    def kern():
        return K.probe_hits(*args, **kw)

    out = k2_bound(table, key, srid, first, n_seg)
    out.update({"hits": int(h_k.sum()), "ms": graph_ms(kern),
                "cold_ms": cold_ms(kern), "call_ms": time_ms(kern, 20),
                "plain_ms": time_ms(lambda: K.probe_hits_plain(*args, **kw),
                                    3, warm=1),
                "max_abs_err": err})
    out["ratio_to_bound"] = round(out["ms"] / out["bound_ms"], 2)
    out["ratio_to_bound_scan"] = round(out["ms"] / out["bound_scan_ms"], 2)
    return out


def main_path_stream(pipe: DevicePipeline, reads: list[bytes]):
    """The sorted stream (key, srid, first) and read count of one full
    (256, 8192) batch of 150 bp reads, built as engine_step builds it."""
    dev = pipe.device
    L, _ = pipe.tiles[0]
    Br = v4_row_budget(L, pipe.w, pipe.budget_frac)
    rows = [_Row(i, 0, 0, s) for i, s in enumerate(reads)]
    arrs = pack_rows_packed(rows, len(rows), L, pipe.k, pipe.l)
    pc, pv, mlen, allow, rid = (torch.from_numpy(a).to(dev)
                                for a in arrs[:5])
    pos, val, tot = K.select_compact(pc, pv, mlen, allow, k=pipe.k,
                                     w=pipe.w, Br=Br)
    valid = torch.arange(Br, device=dev)[None, :] < tot.clamp(max=Br)[:, None]
    key, srid, first = prep_sorted(xxh3_64(val), valid,
                                   rid[:, None].expand(len(rows), Br))
    return key, srid, first, len(rows)


# ---------------------------------------------------------------------------
# phase 13 and window 4d: K2's sharded form, the sharded filter
# ---------------------------------------------------------------------------

def phase13_k2_sharded(keys_u, table, stream) -> dict:
    """K2's sharded form on phase 4's table (rebuilt shard by shard with
    build_radix_shards, on the card) and the main-path stream, for S = 4
    and S = 3 (uneven row ranges; S = 3's middle block straddles row
    2**(p-1)): the blocks concatenated equal the table's slots; each
    shard's K2 hits equal its plain version on the same block; their sum
    equals the unsharded K2's hits exactly. Times of the S launches
    together and of the unsharded launch, each as device time (ms,
    CUDA-graph replay; cold_ms, with the L2 cache flushed before them)
    and around wrapper calls (call_ms); the bound of the S launches
    together (k2_bound)."""
    t0 = time.perf_counter()
    key, srid, first, n_seg = stream
    kw = {"p": table.p, "sp": table.sp, "num_segments": n_seg}

    def launch_whole():
        return K.probe_hits(table.slots, table.spill, key, srid, first, **kw)

    # what every launch costs besides its queries: the wrapper's zeroed
    # hits (a fill kernel), and K2 on an all-filler stream of the same q
    idle = (torch.full_like(key, -1), torch.full_like(srid, -1),
            torch.zeros_like(first))
    idle[2][:1] = 1
    whole = launch_whole()
    out = {"q": key.numel(), "p": table.p, "sp": table.sp,
           "live": int(((srid >= 0) & (first != 0)).sum()),
           "unsharded_ms": graph_ms(launch_whole),
           "unsharded_cold_ms": cold_ms(launch_whole),
           "unsharded_call_ms": time_ms(launch_whole, 20),
           "fill_ms": graph_ms(lambda: torch.zeros(
               n_seg, dtype=torch.int32, device=key.device)),
           "idle_launch_ms": graph_ms(lambda: K.probe_hits(
               table.slots, table.spill, *idle, **kw))}
    for n_shard in (4, 3):
        t_b = time.perf_counter()
        shards = build_radix_shards(keys_u, n_shard,
                                    [keys_u.device] * n_shard)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t_b
        if not torch.equal(torch.cat([t.slots for t in shards]),
                           table.slots) or any(
                t.sp != table.sp or (table.sp and not torch.equal(
                    t.spill, table.spill)) for t in shards):
            raise AssertionError(f"S={n_shard}: shard blocks differ from the "
                                 "whole table")

        def launch_all():
            return [K.probe_hits(t.slots, t.spill, key, srid, first,
                                 row_lo=t.row_lo, **kw) for t in shards]

        K.probe_hits.launches = 0
        per = launch_all()
        if K.probe_hits.launches != n_shard:
            raise AssertionError(f"S={n_shard}: {K.probe_hits.launches} "
                                 "launches")
        err = 0
        for t, h in zip(shards, per):
            plain = K.probe_hits_plain(t.slots, t.spill, key, srid, first,
                                       row_lo=t.row_lo, **kw)
            err = max(err, int((h - plain).abs().max()))
        total = sum(per[1:], per[0])
        if err or not torch.equal(total, whole):
            raise AssertionError(f"S={n_shard}: sharded K2 differs (plain "
                                 f"err {err}, sum equal "
                                 f"{torch.equal(total, whole)})")
        bound = k2_bound(table, key, srid, first, n_seg,
                         [(t.row_lo, t.slots.shape[0]) for t in shards])
        ms = graph_ms(launch_all)
        out[f"S{n_shard}"] = {
            "rows": [t.slots.shape[0] for t in shards],
            "build_s": round(build_s, 3), "ms": ms,
            "cold_ms": cold_ms(launch_all),
            "call_ms": time_ms(launch_all, 20),
            "plain_ms": time_ms(lambda: [
                K.probe_hits_plain(t.slots, t.spill, key, srid, first,
                                   row_lo=t.row_lo, **kw) for t in shards],
                3, warm=1),
            **{n: bound[n] for n in ("rows_touched", "spill_rows", "bytes",
                                     "bound_ms", "bound_by",
                                     "bound_scan_ms")},
            "max_abs_err": err, "hits": int(total.sum()),
            "ratio_to_unsharded": round(ms / out["unsharded_ms"], 2)}
        del shards, per, total
        torch.cuda.empty_cache()
    log("13 K2 sharded parity", t0, **{n: json.dumps(v)
                                       for n, v in out.items()})
    return out


def sharded_window(keys_u, k: int, reads, ref, n_bp: int) -> dict:
    """Window 4d: phase 4's reads through DeviceDecider over a 2x4 mesh of
    the one card ([cuda:0] * 8: eight mesh positions, four table shards
    shared by the two data rows): every unit equal to the reference, K2
    launched 4 times per batch (K1 once), Mbp/s, busy share, reruns,
    launches, the shard build's seconds and GB and the peak memory."""
    t0 = time.perf_counter()
    single, pairs, ont = reads
    torch.cuda.reset_peak_memory_stats()
    t_b = time.perf_counter()
    decider = DeviceDecider(DevicePipeline(
        keys_u, k, W_, mesh=make_mesh(2, 4, [keys_u.device] * 8)))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_b
    pipe = decider.pipe
    blocks = {id(t): t for row in pipe.blocks for t in row}.values()
    block_gb = sum(t.nbytes for t in blocks) / 1e9
    run_decider(decider, single[:2000], pairs[:1000], ont[:20])
    torch.cuda.synchronize()
    pipe.rerun_batches = pipe.rerun_units = 0
    reset_launches()
    t_run = time.perf_counter()
    decisions = run_decider(decider, single, pairs, ont)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = launch_counts()
    reruns = {"batches": pipe.rerun_batches, "units": pipe.rerun_units}
    check_route(launches, "K1", "window 4d")
    if launches["K2"] != 4 * launches["K1"]:
        raise AssertionError(f"window 4d: K2 must launch 4 times per batch, "
                             f"launches {launches}")
    hits_ref, tot_ref = ref
    got_h = np.array([d[1] for d in decisions])
    got_t = np.array([d[2] for d in decisions])
    bad = np.nonzero((got_h != hits_ref) | (got_t != tot_ref))[0]
    if bad.size:
        i = int(bad[0])
        raise AssertionError(
            f"window 4d: {bad.size} units differ from the reference; first "
            f"{i}: got {(got_h[i], got_t[i])}, want "
            f"{(hits_ref[i], tot_ref[i])}")
    split = where_time_goes(decider, single, pairs, ont, run_s)
    numbers = {"mesh": pipe.mesh.shape, "blocks": len(blocks),
               "shard_build_s": round(build_s, 3),
               "blocks_gb": round(block_gb, 3), "mbp": n_bp / 1e6,
               "run_s": round(run_s, 3),
               "mbp_per_s": round(n_bp / 1e6 / run_s, 3),
               "on_card_rerun_batches": reruns["batches"],
               "on_card_rerun_units": reruns["units"],
               "timed_window_launches": launches,
               "max_memory_allocated_gb": round(
                   torch.cuda.max_memory_allocated() / 1e9, 3), **split}
    del decider, pipe, blocks
    torch.cuda.empty_cache()
    log("4d panhuman scale k=31, sharded 2x4", t0, **{
        n: json.dumps(v) for n, v in numbers.items()})
    return numbers


def repeat_heavy(table, keys_u) -> dict:
    """K2 on a repeat-heavy stream, the worst case for its atomics:
    256 x 512 slots, all valid, of member keys of phase 4's table, rows
    0-239 one read unit and the last 16 rows a read each ("one_read");
    and the same keys with every row its own read ("spread"): the same
    probes with other atomic targets. Each exact against the plain
    version, with its device time (measure_k2)."""
    dev = keys_u.device
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    R, Br = 256, 512
    pick = torch.randint(0, keys_u.numel(), (R * Br,), device=dev,
                         generator=g)
    hashes = keys_u[pick].reshape(R, Br)
    valid = torch.ones((R, Br), dtype=torch.bool, device=dev)
    rows = torch.arange(R, device=dev, dtype=torch.int32)
    out = {}
    for name, rid in (("one_read", (rows - (R - 17)).clamp(min=0)),
                      ("spread", rows)):
        key, srid, first = prep_sorted(hashes, valid,
                                       rid[:, None].expand(R, Br))
        m = measure_k2(table, key, srid, first, int(rid.max()) + 1)
        out[name] = {n: m[n] for n in ("live", "hits", "ms", "cold_ms",
                                       "call_ms", "bound_ms",
                                       "max_abs_err")}
    out["one_read_over_spread"] = round(
        out["one_read"]["ms"] / out["spread"]["ms"], 3)
    return out


def k2_alone(rng) -> dict:
    """``--k2``: K2 alone, exact against its plain version and timed by
    device time and around wrapper calls (measure_k2), on phase 4's table
    (4.1e8 keys) and main-path stream, with phase 13's S = 4 and S = 3
    launches and the repeat-heavy stream, then on phase 2's stream. Uses
    only interfaces that earlier commits of the port have, so that a copy
    of this script times their K2 by the same measures."""
    t0 = time.perf_counter()
    genome, _, keys_u, _ = panhuman_keys(rng, K_, "4")
    table = build_radix_table(keys_u)
    pipe = DevicePipeline(table, K_, W_, device="cuda")
    single, _, _ = make_reads(rng, genome)
    stream = main_path_stream(pipe, single[:8192])
    out = {"phase4": measure_k2(table, *stream),
           "sharded": phase13_k2_sharded(keys_u, table, stream),
           "repeat_heavy": repeat_heavy(table, keys_u)}
    del pipe, table, stream, keys_u
    torch.cuda.empty_cache()
    out["phase2"] = measure_k2(*dense_k2_stream())
    log("2-13 K2 alone", t0, **{n: json.dumps(v) for n, v in out.items()})
    return out


# ---------------------------------------------------------------------------
# phases 15 and 16: the server and the index operations from a file
# ---------------------------------------------------------------------------

#: the summary's fields that name the program, the index or a timing
SUMMARY_VOLATILE = ("version", "index", "output", "output2", "time",
                    "seqs_per_second", "bp_per_second")


def cli_timed(args: list[str]) -> tuple[float, str]:
    """cli_main(args) with its standard error captured; raises on a
    non-zero exit. Returns (wall seconds, standard error)."""
    err = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_main(args)
    wall = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"CLI exit {rc}: {args}\n{err.getvalue()[-2000:]}")
    return wall, err.getvalue()


def summary_of(path: str) -> dict:
    with open(path) as f:
        s = json.load(f)
    return {n: v for n, v in s.items() if n not in SUMMARY_VOLATILE}


def http_get(url: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


def file_phases(keys_u, genome: bytes, g_hashes, single, pairs,
                ont) -> dict:
    """Phases 15, 16, 18, 19, 20 and 17 on phase 4's keys and reads, the keys
    written once to an index file in a tempdir (the free space printed
    first; too little fails the phase) and deleted after phase 17."""
    tmp = tempfile.mkdtemp(prefix="deacon_torch_smoke_file_")
    try:
        n = int(keys_u.numel())
        need = 2 * (9 * n + 64) + (2 << 30)  # the file, the diff's output
        free = shutil.disk_usage(tmp).free
        print(f"[phase 15] tempdir {tmp}: {free / 1e9:.3f} GB free, "
              f"{need / 1e9:.3f} GB needed", flush=True)
        if free < need:
            raise AssertionError(f"phase 15: {free / 1e9:.3f} GB free in "
                                 f"{tmp}, {need / 1e9:.3f} GB needed")
        idx = os.path.join(tmp, "panhuman.idx")
        t = time.perf_counter()
        keys_host = keys_u.cpu().numpy().view(np.uint64)  # u64 ascending
        dtt.write_index(keys_host, dtt.IndexHeader.new(K_, W_), idx)
        write_s = time.perf_counter() - t
        answers: dict = {}
        refs: dict = {}
        out = {"15": phase15_server(idx, keys_u, keys_host, write_s, single,
                                    pairs, tmp, answers)}
        out["16"] = phase16_index_ops(idx, keys_host, genome, g_hashes, tmp)
        out["18"] = phase18_pod(idx, single, pairs, ont, tmp)
        out["19"] = phase19_host_engine(idx, single, pairs, ont, tmp,
                                        answers, refs)
        out["20"] = phase20_device_rule(idx, tmp, refs)
        out["17"] = phase17_host_io(idx, keys_host, single + ont, pairs,
                                    tmp)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def probe_numbers(probe, keys_u, keys_host) -> dict:
    """The server's probe on 1e5 and 1e6 queries, half of them keys:
    device ms (CUDA events around the search on queries already on the
    card) and queries/s of whole calls (upload from pinned memory, search,
    copy back), each held against NumPy's searchsorted on the host keys."""
    gen = torch.Generator(device=keys_u.device).manual_seed(SEED + 15)
    out = {}
    for n in (100_000, 1_000_000):
        q = torch.randint(I64_MIN, (1 << 63) - 1, (n,), device=keys_u.device,
                          dtype=torch.int64, generator=gen)
        pick = torch.randint(0, keys_u.numel(), (n // 2,),
                             device=keys_u.device, generator=gen)
        q[: n // 2] = keys_u[pick]
        q_host = q.cpu().numpy().view(np.uint64)
        i = np.minimum(np.searchsorted(keys_host, q_host), keys_host.size - 1)
        want = keys_host[i] == q_host
        flipped = q ^ I64_MIN
        if not np.array_equal(probe.member(flipped).cpu().numpy(), want):
            raise AssertionError(f"probe on {n} queries differs")
        ms = time_ms(lambda: probe.member(flipped), reps=20)
        got = probe(q_host)
        t = time.perf_counter()
        for _ in range(5):
            got = probe(q_host)
        call_s = (time.perf_counter() - t) / 5
        if not np.array_equal(got, want):
            raise AssertionError(f"probe call on {n} queries differs")
        out[str(n)] = {"device_ms": round(ms, 4),
                       "call_ms": round(call_s * 1e3, 3),
                       "queries_per_s": round(n / call_s),
                       "members": int(want.sum())}
    return out


def phase15_server(idx: str, keys_u, keys_host, write_s: float, single,
                   pairs, tmp: str, answers: dict) -> dict:
    """Phase 15: the server on the card from the panhuman file, the CLI's
    client against it over ~2 Mbp of phase 4's Illumina-like reads
    (single and paired, search and deplete, binary and JSON wires), each
    output byte-identical to ``filter`` on the card from the same file
    (K2's path; the server's is a searchsorted probe) and each summary
    equal apart from the program, the index, the output paths and the
    timings. Each client's output and summary go into ``answers`` by
    (wire, run), for phase 19."""
    import threading

    from deacon_tpu_torch.server.app import make_server

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t = time.perf_counter()
    httpd = make_server(idx, 0, host="127.0.0.1", device="cuda")
    start_s = time.perf_counter() - t
    start_peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    state = httpd.state
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        root = http_get(url + "/").decode()
        want_root = (f"Index loaded with {keys_u.numel()} minimizers and "
                     "header: IndexHeader { format_version: 2, "
                     f"kmer_length: {K_}, window_size: {W_} }}")
        header = json.loads(http_get(url + "/index_header"))
        version = http_get(url + "/index_version").decode()
        name, sha = version.rsplit("@", 1)
        if (root != want_root or header != {"format_version": 2,
                                            "kmer_length": K_,
                                            "window_size": W_}
                or name != idx or len(sha) != 64):
            raise AssertionError(f"phase 15 endpoints: {root!r} {header} "
                                 f"{version!r}")
        resident_gb = state.probe.nbytes / 1e9
        probe = probe_numbers(state.probe, keys_u, keys_host)
        # ~1 Mbp of single reads and ~1 Mbp of pairs
        reads = {"s.fq": [(b"s%d" % i, r) for i, r in
                          enumerate(single[:6700])]}
        reads["r1.fq"] = [(b"p%d/1" % i, a)
                          for i, (a, _) in enumerate(pairs[:3350])]
        reads["r2.fq"] = [(b"p%d/2" % i, b)
                          for i, (_, b) in enumerate(pairs[:3350])]
        for fname, recs in reads.items():
            write_fastq(os.path.join(tmp, fname), recs)
        bp = {"single": sum(len(r) for _, r in reads["s.fq"]),
              "paired": sum(len(r) for f in ("r1.fq", "r2.fq")
                            for _, r in reads[f])}
        runs = []
        launches = {"filter": None, "client": None}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        filters = {}
        for mode in ("single", "paired"):
            inputs = ([os.path.join(tmp, "s.fq")] if mode == "single" else
                      [os.path.join(tmp, f) for f in ("r1.fq", "r2.fq")])
            for deplete in (False, True):
                tag = f"{mode}{'_deplete' if deplete else ''}"
                flags = ["--deplete"] if deplete else []
                o = os.path.join(tmp, f"f_{tag}.fq")
                sm = o + ".json"
                wall, err = cli_timed(["filter", idx, *inputs, "-o", o, "-s",
                                       sm, "--device", "cuda", *flags])
                load = [ln for ln in err.splitlines()
                        if ln.startswith("Loaded index")][0]
                filters[tag] = (read_bytes(o), summary_of(sm))
                runs.append({"run": f"filter {tag}", "s": round(wall, 3),
                             "load_line": load,
                             "mbp_per_s": round(bp[mode] / 1e6 / wall, 3)})
        launches["filter"] = launch_counts()
        filter_peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
        check_route(launches["filter"], "K1", "phase 15 filter")
        reset_launches()
        clients = 0
        for wire in ("binary", "json"):
            for tag, (want_out, want_summary) in filters.items():
                mode = "paired" if tag.startswith("paired") else "single"
                inputs = ([os.path.join(tmp, "s.fq")] if mode == "single"
                          else [os.path.join(tmp, f)
                                for f in ("r1.fq", "r2.fq")])
                flags = ["--deplete"] if "deplete" in tag else []
                o = os.path.join(tmp, f"c_{wire}_{tag}.fq")
                sm = o + ".json"
                old = os.environ.pop("DEACON_WIRE", None)
                if wire == "json":
                    os.environ["DEACON_WIRE"] = "json"
                try:
                    wall, _ = cli_timed(["client", url, *inputs, "-o", o,
                                         "-s", sm, "-q", *flags])
                finally:
                    os.environ.pop("DEACON_WIRE", None)
                    if old is not None:
                        os.environ["DEACON_WIRE"] = old
                with open(sm) as f:
                    summ_index = json.load(f)["index"]
                if (read_bytes(o) != want_out
                        or summary_of(sm) != want_summary
                        or summ_index != f"{url}:{version}"):
                    raise AssertionError(f"phase 15: client {wire} {tag} "
                                         "differs from filter")
                answers[wire, tag] = (want_out, want_summary)
                clients += 1
                runs.append({"run": f"client {wire} {tag}",
                             "s": round(wall, 3),
                             "mbp_per_s_host_bound": round(
                                 bp[mode] / 1e6 / wall, 3)})
        launches["client"] = launch_counts()
        if any(launches["client"].values()):
            raise AssertionError("phase 15: the server's probe launched a "
                                 f"kernel of the port: {launches['client']}")
        if not any(filters[t][0] for t in filters):
            raise AssertionError("phase 15: every output is empty")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    numbers = {
        "keys": int(keys_u.numel()),
        "file_gb": round(os.path.getsize(idx) / 1e9, 3),
        "write_index_s": round(write_s, 3),
        "server_start_s": round(start_s, 3),
        **{n: round(v, 3) for n, v in state.timings.items()},
        "resident_gb": round(resident_gb, 3),
        "start_peak_gb": round(start_peak_gb, 3),
        "filter_peak_gb": round(filter_peak_gb, 3),
        "probe": probe, "mbp": {m: v / 1e6 for m, v in bp.items()},
        "client_runs": clients, "runs": runs, "launches": launches,
    }
    del state, httpd
    torch.cuda.empty_cache()
    log("15 server and client at panhuman scale", t0, **{
        n: json.dumps(v) for n, v in numbers.items()})
    return numbers


# ---------------------------------------------------------------------------
# phase 19: the host engine (--device host) at panhuman scale
# ---------------------------------------------------------------------------

#: seconds a phase-19 run may take before it is killed
HOST_RUN_LIMIT_S = 300


def host_cpu() -> dict:
    """The host's CPU as /proc/cpuinfo names its first core (model name,
    vendor, family, model, stepping, whether it has AVX-512F; a virtual
    machine may report the name as unknown) and the core count."""
    fields = {"model name": "model", "vendor_id": "vendor",
              "cpu family": "family", "model": "model_number",
              "stepping": "stepping"}
    out = {"model": "unknown"}
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break  # the first core only
            key, _, val = line.partition(":")
            key = key.strip()
            if key in fields:
                out[fields[key]] = val.strip()
            elif key == "flags":
                out["avx512f"] = "avx512f" in val.split()
    out["cores"] = os.cpu_count()
    return out


class PeakRss:
    """This process's peak resident set while the block runs: VmHWM of
    /proc/self/status where the kernel reports it (getrusage's ru_maxrss
    would carry the peak of a parent that forked the process), else the
    largest resident size of /proc/self/statm sampled every 10 ms by a
    thread. ``gb`` and ``source`` after the block; gb None when neither
    file tells."""

    def __enter__(self):
        import threading

        self.gb, self.source, self._max = None, None, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        page = os.sysconf("SC_PAGE_SIZE")
        while True:
            with contextlib.suppress(OSError, ValueError, IndexError), \
                    open("/proc/self/statm") as f:
                self._max = max(self._max, int(f.read().split()[1]) * page)
            if self._stop.wait(0.01):
                return

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        with contextlib.suppress(OSError), open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    self.gb = round(int(line.split()[1]) * 1024 / 1e9, 3)
                    self.source = "VmHWM"
                    return False
        if self._max:
            self.gb = round(self._max / 1e9, 3)
            self.source = "statm sampled every 10 ms"
        return False


def _host_run(queue, env: dict, argv: list) -> None:
    """One run of phase 19 in a spawned process: ``cli_main(argv)`` with
    ``env`` set, the kernels' counters set to 0 just before and read
    just after. Puts its exit code, wall seconds, the seconds of its
    index decode, probe table build, sidecar load and sidecar save, its
    peak RSS in GB and how it was read (PeakRss), its launches and its
    standard error's tail on ``queue``."""
    from deacon_tpu_torch.filter import engine as fengine
    from deacon_tpu_torch.io import native_loader as nl

    os.environ.update(env)
    secs = {"decode_s": 0.0, "build_s": 0.0, "sidecar_load_s": 0.0,
            "sidecar_save_s": 0.0}

    def timed(fn, key):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                secs[key] += time.perf_counter() - t
        return run

    fengine.load_index = timed(fengine.load_index, "decode_s")
    nl.native_probe = timed(nl.native_probe, "build_s")
    nl.load_probe_sidecar = timed(nl.load_probe_sidecar, "sidecar_load_s")
    nl.maybe_save_probe_sidecar = timed(nl.maybe_save_probe_sidecar,
                                        "sidecar_save_s")
    err = io.StringIO()
    reset_launches()
    t = time.perf_counter()
    with PeakRss() as rss:
        try:
            with contextlib.redirect_stderr(err):
                rc = cli_main([str(a) for a in argv])
        except Exception as e:  # noqa: BLE001 - reported to the parent
            rc = f"{type(e).__name__}: {e}"
        wall = time.perf_counter() - t
    queue.put({"rc": rc, "s": round(wall, 3),
               **{n: round(v, 3) for n, v in secs.items()},
               "peak_rss_gb": rss.gb, "rss_source": rss.source,
               "launches": launch_counts(),
               "stderr": err.getvalue()[-1500:]})


def host_run(argv: list, env: dict) -> dict:
    """``_host_run`` in a spawned process of this script; raises unless it
    exits 0 within HOST_RUN_LIMIT_S, launching no kernel of the port."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=_host_run, args=(q, env, argv))
    proc.start()
    try:
        got = q.get(timeout=HOST_RUN_LIMIT_S)
        proc.join(timeout=60)
    except queue_mod.Empty:
        raise AssertionError(f"phase 19: {argv[:2]} outlasted "
                             f"{HOST_RUN_LIMIT_S} s") from None
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
    if got["rc"] != 0:
        raise AssertionError(f"phase 19: {argv} failed: {got}")
    if any(got["launches"].values()):
        raise AssertionError(f"phase 19: the host engine launched a kernel "
                             f"of the port: {got['launches']}")
    return got


def sidecar_bytes(n_keys: int) -> int:
    """The size of the probe table's sidecar for ``n_keys`` keys: a 4 KiB
    header page, then n/0.8 + 1 slots and the 2^16-slot spill of 8
    bytes."""
    return 4096 + (int(max(n_keys, 1024) / 0.8) + 1 + (1 << 16)) * 8


def phase19_host_engine(idx: str, single, pairs, ont, tmp: str,
                        answers: dict, refs: dict) -> dict:
    """Phase 19: the host engine (``--device host``) at panhuman scale,
    from the phase-15 file and phase 18's FASTQ (~13.9 Mbp single and its
    BGZF copy, ~6 Mbp paired): (a) ``filter --device host`` with .gz
    output, each run a spawned process of this script: single from the
    plain file building the probe table and writing its ~4.1 GB sidecar
    (DEACON_PROBE_CACHE=1; the free space is checked first), then single
    from the BGZF copy and paired (-O) starting from the sidecar; each
    output, decompressed, byte-identical to ``filter --device cuda`` on
    the same file (whose run launches K1 and K2), and each host run
    launches no kernel; (b) ``server --device host`` started from the
    sidecar, with ``client`` on both wires, each output and summary equal
    to phase 15's against the cuda server (``answers``). Printed: start
    seconds (index decode plus table build, against the sidecar's load),
    Mbp/s, threads, peak RSS, the sidecar's bytes, the card's name and
    power limit, the host's CPU model and core count. The sidecar stays
    for phase 20, which deletes it; ``refs`` gets the cuda run's single
    output, decompressed, and its bases."""
    import gzip
    import threading

    from deacon_tpu_torch.server.app import HostProbe, make_server

    t0 = time.perf_counter()
    _, count = load_header_and_count(idx)
    need = sidecar_bytes(count) + (1 << 30)
    free = shutil.disk_usage(tmp).free
    print(f"[phase 19] tempdir {tmp}: {free / 1e9:.3f} GB free, "
          f"{need / 1e9:.3f} GB needed", flush=True)
    if free < need:
        raise AssertionError(f"phase 19: {free} bytes free in {tmp}, "
                             f"{need} bytes needed")
    fq, gz = os.path.join(tmp, "pod_s.fq"), os.path.join(tmp, "pod_s.fq.gz")
    r1, r2 = (os.path.join(tmp, f"pod_r{m}.fq") for m in (1, 2))
    bp = {"single": sum(len(r) for r in single + ont),
          "paired": sum(len(a) + len(b) for a, b in pairs)}
    threads = 8  # the CLI's default -t
    ref, runs = {}, {}
    for name, inputs in (("single", [fq]), ("paired", [r1, r2])):
        o = os.path.join(tmp, f"hc_{name}.fq.gz")
        extra = ["-O", o + ".2.gz"] if name == "paired" else []
        reset_launches()
        wall, _ = cli_timed(["filter", idx, *inputs, "-o", o, *extra,
                             "--device", "cuda"])
        launches = launch_counts()
        if launches["K1"] <= 0 or launches["K2"] <= 0:
            raise AssertionError(f"phase 19 cuda {name}: {launches}")
        ref[name] = [gzip.decompress(read_bytes(o))] + (
            [gzip.decompress(read_bytes(o + ".2.gz"))] if extra else [])
        runs[f"cuda {name}"] = {"s": round(wall, 3), "mbp_per_s": round(
            bp[name] / 1e6 / wall, 3), "launches": launches}
    if not ref["single"][0] or not ref["paired"][0]:
        raise AssertionError("phase 19: a cuda output is empty")
    refs.update(single=ref["single"][0], bp=bp["single"])
    side = idx + ".probe"
    env = {"DEACON_PROBE_CACHE": "1"}
    for label, name, inputs in (("host single, table built", "single", [fq]),
                                ("host single bgzf, sidecar", "single", [gz]),
                                ("host paired, sidecar", "paired", [r1, r2])):
        o = os.path.join(tmp, f"hh_{len(runs)}.fq.gz")
        extra = ["-O", o + ".2.gz"] if name == "paired" else []
        got = host_run(["filter", idx, *inputs, "-o", o, *extra, "-t",
                        threads, "--device", "host"], env)
        outs = [read_bytes(o)] + ([read_bytes(o + ".2.gz")] if extra else [])
        if not all(x.endswith(BGZF_EOF) for x in outs):
            raise AssertionError(f"phase 19 {label}: .gz output not BGZF")
        if [gzip.decompress(x) for x in outs] != ref[name]:
            raise AssertionError(f"phase 19 {label}: output differs from "
                                 "--device cuda")
        source = ("built at startup" if "built" in label
                  else "sidecar cache")
        if f"probe table: {source}" not in got["stderr"]:
            raise AssertionError(f"phase 19 {label}: {got['stderr']}")
        start = (got["decode_s"] + got["build_s"] if "built" in label
                 else got["sidecar_load_s"])
        runs[label] = {
            "s": got["s"], "start_s": round(start, 3),
            **{n: got[n] for n in ("decode_s", "build_s", "sidecar_load_s",
                                   "sidecar_save_s", "peak_rss_gb",
                                   "rss_source")},
            "mbp_per_s": round(bp[name] / 1e6 / got["s"], 3),
            "mbp_per_s_after_start": round(
                bp[name] / 1e6 / max(got["s"] - start, 1e-9), 3),
            "threads": threads}
        if not os.path.exists(side):
            raise AssertionError(f"phase 19 {label}: no sidecar {side}")
    side_bytes = os.path.getsize(side)
    if side_bytes != sidecar_bytes(count):
        raise AssertionError(f"phase 19: sidecar of {side_bytes} bytes, "
                             f"{sidecar_bytes(count)} expected")

    t = time.perf_counter()
    httpd = make_server(idx, 0, host="127.0.0.1", device="host")
    start_s = time.perf_counter() - t
    probe = httpd.state.probe
    if not isinstance(probe, HostProbe) or probe.source != "sidecar cache":
        raise AssertionError(f"phase 19: the host server's probe {probe}")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    server = {"start_s": round(start_s, 3),
              **{n: round(v, 3) for n, v in httpd.state.timings.items()},
              "clients": []}
    try:
        reset_launches()
        for (wire, tag), (want, want_summary) in answers.items():
            inputs = ([os.path.join(tmp, "s.fq")] if tag.startswith("single")
                      else [os.path.join(tmp, f) for f in ("r1.fq", "r2.fq")])
            o = os.path.join(tmp, f"hs_{wire}_{tag}.fq")
            old = os.environ.pop("DEACON_WIRE", None)
            if wire == "json":
                os.environ["DEACON_WIRE"] = "json"
            try:
                wall, _ = cli_timed(["client", url, *inputs, "-o", o, "-s",
                                     o + ".json", "-q",
                                     *(["--deplete"] if "deplete" in tag
                                       else [])])
            finally:
                os.environ.pop("DEACON_WIRE", None)
                if old is not None:
                    os.environ["DEACON_WIRE"] = old
            if read_bytes(o) != want or summary_of(o + ".json") \
                    != want_summary:
                raise AssertionError(f"phase 19: client {wire} {tag} of the "
                                     "host server differs from the cuda "
                                     "server's")
            server["clients"].append({"run": f"{wire} {tag}",
                                      "s": round(wall, 3)})
        if len(server["clients"]) != 8:
            raise AssertionError(f"phase 19: {len(server['clients'])} "
                                 "client runs, 8 expected")
        if any(launch_counts().values()):
            raise AssertionError(f"phase 19: the host server launched a "
                                 f"kernel: {launch_counts()}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        probe.table.close()
    del httpd, probe
    numbers = {"nvidia_smi": nvidia_smi_line(), "cpu": host_cpu(),
               "keys": count, "sidecar_bytes": side_bytes,
               "mbp": {n: v / 1e6 for n, v in bp.items()}, "runs": runs,
               "server": server}
    log("19 host engine at panhuman scale", t0,
        **{n: json.dumps(v) for n, v in numbers.items()})
    return numbers


# ---------------------------------------------------------------------------
# phase 20: the device rule (--device auto)
# ---------------------------------------------------------------------------

#: phase 20's small job: a genome whose index is under the rule's 1M keys,
#: and reads whose FASTQ is under its 16 MB
RULE_GENOME_BP = 2_000_000
RULE_READS = 20_000
#: seconds a one-shot CLI run of phase 20 may take before it is killed
ONE_SHOT_LIMIT_S = 300


def one_shot(argv: list) -> tuple[float, str]:
    """``python -m deacon_tpu_torch ARGV`` in a fresh process from the
    root of the checkout, as a user's single command runs: its wall
    seconds from start to exit (Python's start and torch's import, and on
    cuda the card's start and the kernels' load, included) and its
    standard error. Raises on a non-zero exit; a run past
    ONE_SHOT_LIMIT_S is killed."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deacon_tpu_torch", *map(str, argv)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=ONE_SHOT_LIMIT_S)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"one-shot CLI exit {proc.returncode}: {argv}\n"
                             f"{proc.stderr[-2000:]}")
    return wall, proc.stderr


def engine_route(stderr: str) -> str:
    """The route that the ``Engine:`` line of a run names: "host" (the
    host engine, or the host index build) or "cuda" (the card's
    pipeline)."""
    line = next((x for x in stderr.splitlines() if x.startswith("Engine:")),
                "")
    if "native C++ pipeline" in line or "host extraction" in line:
        return "host"
    if "pipeline (cuda" in line:
        return "cuda"
    raise AssertionError(f"phase 20: no route in {stderr[-800:]!r}")


def phase20_device_rule(idx: str, tmp: str, refs: dict) -> dict:
    """Phase 20: the JAX package's device rule, ``--device auto``, on the
    card's machine (after phase 19, from its sidecar; before 17). (a) A
    seeded 2 Mbp genome: ``index build --device auto`` takes the host
    route, its index byte-identical to ``--device cuda``'s; ``filter
    --device auto`` with ~3 Mbp of reads takes the host engine (the table
    built at start), launching no kernel, its output byte-identical to
    ``--device cuda``'s (K1 and K2 launched). (b) The same small job as
    one-shot CLI processes (one_shot), on ``auto`` (host) and ``cuda``,
    and on three copies of its FASTQ (over the rule's 16 MB) on ``auto``
    (cuda) and ``host``: what each route costs a user's single command,
    start included, on each side of the input threshold; each output
    equal to (three copies of) the in-process cuda run's. (c) The
    phase-15 file (4.1e8 keys) and phase 18's FASTQ with the sidecar
    moved aside: auto takes cuda (K1 and K2 launch); with it back: the
    host engine from the sidecar, the keys not decoded; both outputs
    equal to phase 19's cuda run. Each run prints its route, seconds and
    Mbp/s with the card's name and power limit. Deletes the sidecar."""
    from deacon_tpu_torch.constants import (
        AUTO_HOST_MAX_INPUT_BYTES,
        AUTO_HOST_MAX_KEYS,
    )
    from deacon_tpu_torch.filter import engine as fengine

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    side = idx + ".probe"
    try:
        rng = np.random.default_rng(SEED + 20)
        genome = rand_seq(rng, RULE_GENOME_BP)
        fa = os.path.join(tmp, "rule_genome.fa")
        write_fasta(fa, [(b"genome", genome)])
        fq = os.path.join(tmp, "rule_reads.fq")
        write_fastq(fq, [(b"r%d" % i, sample_read(rng, genome, 150))
                         for i in range(RULE_READS)])
        small_bp = 150 * RULE_READS
        runs: dict = {}
        real_load = fengine.load_index
        decoded = []

        def counted_load(*a, **kw):
            decoded.append(1)
            return real_load(*a, **kw)

        def run(label, argv, want, bp, kernels=("K1", "K2")):
            reset_launches()
            decoded.clear()
            fengine.load_index = counted_load
            try:
                wall, err = cli_timed([str(a) for a in argv])
            finally:
                fengine.load_index = real_load
            launches = launch_counts()
            route = engine_route(err)
            if route != want:
                raise AssertionError(f"phase 20 {label}: route {route}, "
                                     f"{want} expected: {err[-800:]}")
            ran = [n for n in kernels if launches[n] > 0]
            if want == "cuda" and ran != list(kernels):
                raise AssertionError(f"phase 20 {label}: {launches}")
            if want != "cuda" and any(launches.values()):
                raise AssertionError(f"phase 20 {label}: the {route} route "
                                     f"launched a kernel: {launches}")
            runs[label] = {"route": route, "s": round(wall, 3),
                           "mbp_per_s": round(bp / 1e6 / wall, 3),
                           "launches": launches,
                           "keys_decoded": bool(decoded)}
            print(f"[phase 20] {label}: route {route}, {wall:.3f} s, "
                  f"{bp / 1e6 / wall:.3f} Mbp/s, launches "
                  f"{json.dumps(launches)}; {smi}", flush=True)
            return err

        if os.path.getsize(fa) >= AUTO_HOST_MAX_INPUT_BYTES or \
                os.path.getsize(fq) >= AUTO_HOST_MAX_INPUT_BYTES:
            raise AssertionError("phase 20: the small job is not small")
        idx_small = {}
        for device, want in (("cuda", "cuda"), ("auto", "host")):
            idx_small[device] = os.path.join(tmp, f"rule_{device}.idx")
            run(f"index build --device {device}", [
                "index", "build", fa, "-o", idx_small[device], "-q",
                "--device", device], want, RULE_GENOME_BP, kernels=("K1",))
        if read_bytes(idx_small["auto"]) != read_bytes(idx_small["cuda"]):
            raise AssertionError("phase 20: index build --device auto "
                                 "differs from --device cuda")
        small_idx = idx_small["cuda"]
        n_keys = load_header_and_count(small_idx)[1]
        if n_keys >= AUTO_HOST_MAX_KEYS:
            raise AssertionError(f"phase 20: {n_keys} keys is no small job")
        outs = {}
        for device, want in (("cuda", "cuda"), ("auto", "host")):
            o = os.path.join(tmp, f"rule_{device}.fq")
            err = run(f"small job --device {device}", [
                "filter", small_idx, fq, "-o", o, "--device", device],
                want, small_bp)
            if device == "auto" and "probe table: built at startup" \
                    not in err:
                raise AssertionError(f"phase 20 small job: {err[-800:]}")
            outs[device] = read_bytes(o)
        if not outs["cuda"] or outs["auto"] != outs["cuda"]:
            raise AssertionError("phase 20: the small job's outputs differ "
                                 "from --device cuda's")
        fq3 = os.path.join(tmp, "rule_reads_x3.fq")
        with open(fq3, "wb") as f:
            f.write(read_bytes(fq) * 3)
        if os.path.getsize(fq3) < AUTO_HOST_MAX_INPUT_BYTES:
            raise AssertionError("phase 20: three copies are not large")
        one = {}
        for inp, copies, device, want in ((fq, 1, "auto", "host"),
                                          (fq, 1, "cuda", "cuda"),
                                          (fq3, 3, "auto", "cuda"),
                                          (fq3, 3, "host", "host")):
            label = (f"one-shot small job{' x3' if copies > 1 else ''} "
                     f"--device {device}")
            o = os.path.join(tmp, f"rule_one_{len(one)}.fq")
            wall, err = one_shot(["filter", small_idx, inp, "-o", o,
                                  "--device", device])
            route = engine_route(err)
            if route != want:
                raise AssertionError(f"phase 20 {label}: route {route}, "
                                     f"{want} expected: {err[-800:]}")
            if read_bytes(o) != outs["cuda"] * copies:
                raise AssertionError(f"phase 20 {label}: output differs "
                                     "from --device cuda's")
            bp = small_bp * copies
            one[label] = {"route": route, "s": round(wall, 3),
                          "mbp_per_s": round(bp / 1e6 / wall, 3),
                          "input_bytes": os.path.getsize(inp)}
            print(f"[phase 20] {label}: route {route}, {wall:.3f} s, "
                  f"{bp / 1e6 / wall:.3f} Mbp/s, "
                  f"{os.path.getsize(inp)} input bytes; {smi}", flush=True)

        big_fq = os.path.join(tmp, "pod_s.fq")
        if not os.path.exists(side):
            raise AssertionError(f"phase 20: no sidecar {side} from phase 19")
        os.replace(side, side + ".aside")
        o = os.path.join(tmp, "rule_panhuman_cuda.fq")
        run("panhuman, sidecar aside, --device auto",
            ["filter", idx, big_fq, "-o", o, "--device", "auto"], "cuda",
            refs["bp"])
        if read_bytes(o) != refs["single"]:
            raise AssertionError("phase 20: auto on cuda differs from phase "
                                 "19's --device cuda output")
        os.replace(side + ".aside", side)
        o = os.path.join(tmp, "rule_panhuman_host.fq")
        err = run("panhuman, sidecar, --device auto",
                  ["filter", idx, big_fq, "-o", o, "--device", "auto"],
                  "host", refs["bp"])
        if "probe table: sidecar cache" not in err or \
                runs["panhuman, sidecar, --device auto"]["keys_decoded"]:
            raise AssertionError(f"phase 20: the sidecar was not used: "
                                 f"{err[-800:]}")
        if read_bytes(o) != refs["single"]:
            raise AssertionError("phase 20: auto from the sidecar differs "
                                 "from phase 19's --device cuda output")
    finally:
        for path in (side, side + ".aside"):
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)
    numbers = {"nvidia_smi": smi, "small_keys": n_keys,
               "small_mbp": small_bp / 1e6, "panhuman_mbp": refs["bp"] / 1e6,
               "runs": runs, "one_shot": one}
    log("20 device rule", t0,
        **{n: json.dumps(v) for n, v in numbers.items()})
    return numbers


#: seconds a phase-18 run's ranks may take together before they are killed
POD_RUN_LIMIT_S = 300

#: the client's Mbp/s against ``server --mesh pod`` on two ranks of two
#: cards each when PodProbe held a rank's range on its first card only
#: (single, paired, single after 165 s idle; four NVIDIA H100 80GB HBM3 at
#: 700.00 W), printed beside this run's
FIRST_CARD_ONLY_CLIENT_MBP = {"single": 5.691, "paired": 9.766,
                              "single after idle": 12.922}


def _pod_rank(queue, rank_env: dict, argv: list) -> None:
    """One rank of a phase-18 or ``--pod4`` run, in a spawned process:
    ``cli_main(argv)`` on the cards the rank sees (cuda:0 first) with the
    rank's DEACON_* variables, the kernels' counters set to 0 just before
    and read just after. Puts its exit code, seconds, launches (in all and
    per visible card, with the server probe's searches as "search"), the
    (row_lo, rows) blocks K2 ran on, the
    collectives' backend, the shape and cards of each mesh it made, the
    peak GB of cuda:0 and of each visible card, its load and
    pipeline-build seconds, the seconds and count of its hits'
    all-reduces, the pod server's keep-alive messages it sent or took,
    and its standard error's tail on ``queue``."""
    from deacon_tpu_torch.filter import engine as fengine
    from deacon_tpu_torch.index import store
    from deacon_tpu_torch.ops import engine as oengine
    from deacon_tpu_torch.ops import radix_probe as rp
    from deacon_tpu_torch.parallel import multihost

    os.environ.update(rank_env)
    rank = int(rank_env.get("DEACON_PROC_ID", "0"))
    secs = {"load_s": 0.0, "pipeline_s": 0.0, "allreduce_s": 0.0}
    calls = {"allreduce_s": 0}
    blocks = set()
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    per_card = {n: [0] * n_cards for n in (*SELECT, "K2", "search")}

    def on_card(name, fn):
        def run(pc, *a, **kw):
            if pc.device.type == "cuda":
                per_card[name][pc.device.index] += 1
            return fn(pc, *a, **kw)
        return run

    for name, fn in SELECT.items():
        setattr(oengine, fn.__name__, on_card(name, fn))

    def timed(fn, key):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                secs[key] += time.perf_counter() - t
                calls[key] = calls.get(key, 0) + 1
        return run

    probe = rp.probe_hits

    def probe_hits(slots, spill, keys, srid, first, **kw):
        blocks.add((int(kw.get("row_lo", 0)), int(slots.shape[0])))
        if keys.device.type == "cuda":
            per_card["K2"][keys.device.index] += 1
        return probe(slots, spill, keys, srid, first, **kw)

    rp.probe_hits = probe_hits
    launch = oengine.DeviceHashProbe.launch

    def search(self, hashes):
        if len(hashes) and len(self) and self.device.type == "cuda":
            per_card["search"][self.device.index] += 1
        return launch(self, hashes)

    oengine.DeviceHashProbe.launch = search
    meshes = []

    def shape_of(make):
        def run(*a, **kw):
            m = make(*a, **kw)
            meshes.append({**m.shape, "cards": [
                [d.index for d in row] for row in m.devices]})
            return m
        return run

    multihost._pod_mesh = shape_of(multihost._pod_mesh)
    multihost.make_local_data_mesh = shape_of(
        multihost.make_local_data_mesh)
    beats = [0]
    broadcast = multihost.PodMesh.broadcast

    def counted_broadcast(self, arr):
        got = broadcast(self, arr)
        if got.size == 1 and int(got[0]) == -1:
            beats[0] += 1
        return got

    multihost.PodMesh.broadcast = counted_broadcast
    store.load_index_range = timed(store.load_index_range, "load_s")
    fengine.load_index = timed(fengine.load_index, "load_s")
    fengine.make_decider = timed(fengine.make_decider, "pipeline_s")
    multihost.PodMesh.sum_over_shards = timed(
        multihost.PodMesh.sum_over_shards, "allreduce_s")
    backends = []
    choose = multihost.collective_backend

    def collective_backend(every):
        backends.append(choose(every))
        return backends[-1]

    multihost.collective_backend = collective_backend
    err = io.StringIO()
    card = n_cards > 0
    if card:
        torch.cuda.init()  # the allocator's statistics exist from here
    for i in range(n_cards):
        torch.cuda.reset_peak_memory_stats(i)
    reset_launches()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli_main([str(a) for a in argv])
    except Exception as e:  # noqa: BLE001 - reported to the parent
        rc = f"{type(e).__name__}: {e}"
    for i in range(n_cards):
        torch.cuda.synchronize(i)
    wall = time.perf_counter() - t
    card_peak = [round(torch.cuda.max_memory_allocated(i) / 1e9, 3)
                 for i in range(n_cards)]
    queue.put({"rank": rank, "rc": rc, "s": round(wall, 3),
               "launches": launch_counts(), "k2_blocks": sorted(blocks),
               "backend": backends[-1] if backends else None,
               "peak_gb": card_peak[0] if card else None,
               "card_peak_gb": card_peak,
               "card_launches": {n: v for n, v in per_card.items()
                                 if any(v)},
               "meshes": meshes, "heartbeats": beats[0],
               **{n: round(v, 3) for n, v in secs.items()},
               "allreduces": calls["allreduce_s"],
               "stderr": err.getvalue()[-1500:]})


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def pod_ranks(n: int, argv, env=None, coord: bool = True,
              during=None, limit: float = POD_RUN_LIMIT_S) -> list:
    """Run ``n`` ranks of one command (``argv``, or ``argv(rank)``) in
    spawned processes of this script (the rank's DEACON_* variables and
    ``env``, or ``env(rank)``, in each process's environment from its
    start; DEACON_COORD a free local port unless ``coord`` is false), call
    ``during()`` while they run (for a server: rank 0 gets SIGINT after
    it), and return the ranks' reports by rank. Raises if a rank exits
    non-zero or the ranks outlast ``limit`` seconds; kills them then."""
    import multiprocessing as mp
    import queue as queue_mod
    import signal

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = []
    for r in range(n):
        rank_env = {"DEACON_NUM_PROC": str(n), "DEACON_PROC_ID": str(r),
                    **((env(r) if callable(env) else env) or {})}
        if coord:
            rank_env["DEACON_COORD"] = f"127.0.0.1:{port}"
        args = argv(r) if callable(argv) else argv
        procs.append(ctx.Process(target=_pod_rank, args=(q, rank_env, args)))
        saved = {k: os.environ.get(k) for k in rank_env}
        os.environ.update(rank_env)  # a spawned child starts with these
        try:
            procs[-1].start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    deadline = time.perf_counter() + limit
    reports = {}
    try:
        if during is not None:
            try:
                during()
            finally:
                os.kill(procs[0].pid, signal.SIGINT)
        while len(reports) < n:
            left = deadline - time.perf_counter()
            if left <= 0:
                raise AssertionError(f"phase 18: {args[:2]} ranks outlasted "
                                     f"{limit} s")
            try:
                got = q.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise AssertionError(f"phase 18: a rank died ({dead})")
                continue
            reports[got["rank"]] = got
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    out = [reports[r] for r in range(n)]
    bad = [x for x in out if x["rc"] != 0]
    if bad:
        raise AssertionError(f"phase 18: {args[:2]} rank failed: {bad}")
    return out


def pod_block(shard: int, n_shard: int, p: int) -> tuple:
    """(row_lo, rows) of a pod rank's block of the 2**p-row table."""
    from deacon_tpu_torch.ops.radix_probe import shard_rows

    r0, r1 = shard_rows(shard, n_shard, p)
    return (r0, r1 - r0)


def pod_record(label: str, reports: list, n_bp: int, filter_ranks=True,
               blocks=None, backend="gloo") -> dict:
    """A multi-process run's numbers: Mbp/s over the slowest rank's wall
    and each rank's report. Raises unless K1 and K2 launched in every
    rank (``filter_ranks``), K2 ran on exactly ``blocks(rank)`` (pod
    modes) and the backend rule chose ``backend`` in every rank that
    made a pod mesh."""
    for x in reports:
        lc = x["launches"]
        if filter_ranks and (lc["K1"] <= 0 or lc["K2"] <= 0):
            raise AssertionError(f"{label} rank {x['rank']}: launches {lc}")
        if blocks is not None and x["k2_blocks"] != [blocks(x["rank"])]:
            raise AssertionError(
                f"{label} rank {x['rank']}: K2 ran on {x['k2_blocks']}, "
                f"not rows {blocks(x['rank'])}")
        if blocks is not None and x["backend"] != backend:
            raise AssertionError(
                f"{label} rank {x['rank']}: the backend rule chose "
                f"{x['backend']}, not {backend}")
    wall = max(x["s"] for x in reports)
    return {"mbp_per_s": round(n_bp / 1e6 / wall, 3) if n_bp else None,
            "ranks": [{n: x[n] for n in (
                "s", "load_s", "pipeline_s", "allreduce_s", "allreduces",
                "peak_gb", "backend", "launches", "k2_blocks",
                *(("card_peak_gb", "card_launches", "meshes")
                  if len(x["card_peak_gb"]) > 1 else ()))}
                for x in reports]}


def same_bytes(path: str, want: bytes, what: str) -> None:
    if read_bytes(path) != want:
        raise AssertionError(f"{what} differs from the one-process output")


def phase18_pod(idx: str, single, pairs, ont, tmp: str) -> dict:
    """Phase 18: the multi-process modes on the card, each rank a spawned
    process of this script on cuda:0 (the ranks share the card, so their
    collectives run over gloo), from the panhuman file of phase 15: two
    ranks of ``filter --mesh pod``; two of ``--mesh pod-data``, single,
    paired and BGZF; four of ``--mesh pod-2d`` (DEACON_POD_SHARDS=2); two
    of ``index build --mesh pod-data`` over a seeded 20 Mbp FASTA; two of
    ``server --mesh pod`` answering ``client``; and ``make_server`` on
    make_mesh(1, 2, ["cuda:0"] * 2) answering ``client``. Every output is
    byte-identical to the one-process command on the card from the same
    file; K1 and K2 launch in every filter rank (K1 in every build rank),
    and in the pod modes K2 runs on exactly the rank's block of rows and
    the backend rule picks gloo (the ranks share the card)."""
    import threading

    from deacon_tpu_torch.ops.radix_probe import choose_p
    from deacon_tpu_torch.parallel.sharded import make_mesh as mk_mesh
    from deacon_tpu_torch.server.app import make_server

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 18)
    fq = os.path.join(tmp, "pod_s.fq")
    r1, r2 = (os.path.join(tmp, f"pod_r{m}.fq") for m in (1, 2))
    write_fastq(fq, [(b"s%d" % i, r) for i, r in enumerate(single + ont)])
    write_fastq(r1, [(b"p%d/1" % i, a) for i, (a, _) in enumerate(pairs)])
    write_fastq(r2, [(b"p%d/2" % i, b) for i, (_, b) in enumerate(pairs)])
    gz = fq + ".gz"
    with open(gz, "wb") as f:
        f.write(bgzf(read_bytes(fq)))
    fa = os.path.join(tmp, "pod_build.fa")
    recs = dirty_records(rng, 5, SCALE_RECORD_BP, SCALE_RECORD_BP + 1)
    write_fasta(fa, recs)
    bp = {"single": sum(len(r) for r in single + ont),
          "paired": sum(len(a) + len(b) for a, b in pairs),
          "fasta": sum(len(x) for _, x in recs)}
    _, count = load_header_and_count(idx)
    p = choose_p(count)
    runs, ref = {}, {}
    for name, inputs in (("single", [fq]), ("paired", [r1, r2])):
        o = os.path.join(tmp, f"pod_ref_{name}.fq")
        extra = ["-O", o + ".2"] if name == "paired" else []
        wall, _ = cli_timed(["filter", idx, *inputs, "-o", o, *extra,
                             "--device", "cuda"])
        ref[name] = (read_bytes(o), read_bytes(o + ".2") if extra else None)
        runs[f"one-process filter {name}"] = {
            "s": round(wall, 3), "mbp_per_s": round(bp[name] / 1e6 / wall,
                                                    3)}
    if not ref["single"][0] or not ref["paired"][0]:
        raise AssertionError("phase 18: a reference output is empty")
    ref_idx = os.path.join(tmp, "pod_ref.idx")
    t = time.perf_counter()
    cli_index_build(fa, ref_idx, K_, W_, "cuda")
    runs["one-process index build"] = {
        "s": round(time.perf_counter() - t, 3)}

    def record(label, reports, n_bp, **checks):
        runs[label] = pod_record(label, reports, n_bp, **checks)

    def block_of(n_shard):
        return lambda rank: pod_block(rank % n_shard, n_shard, p)

    outs = [os.path.join(tmp, f"pod{r}.fq") for r in range(2)]
    reports = pod_ranks(2, lambda r: ["filter", idx, fq, "-o", outs[r],
                                      "--device", "cuda", "--mesh", "pod"])
    record("pod 2 ranks single", reports, bp["single"],
           blocks=block_of(2))
    for o in outs:
        same_bytes(o, ref["single"][0], "--mesh pod")
    for name, inputs in (("single", [fq]), ("paired", [r1, r2]),
                         ("bgzf", [gz])):
        o = os.path.join(tmp, f"pd_{name}.fq")
        extra = ["-O", o + ".2"] if name == "paired" else []
        reports = pod_ranks(2, ["filter", idx, *inputs, "-o", o, *extra,
                                "--device", "cuda", "--mesh", "pod-data"],
                            coord=False)
        want = ref["paired" if name == "paired" else "single"]
        same_bytes(o, want[0], f"--mesh pod-data {name}")
        if extra:
            same_bytes(o + ".2", want[1], "--mesh pod-data paired -O")
        record(f"pod-data 2 ranks {name}", reports,
               bp["paired" if name == "paired" else "single"])
    o = os.path.join(tmp, "p2d.fq")
    reports = pod_ranks(4, ["filter", idx, fq, "-o", o, "--device", "cuda",
                            "--mesh", "pod-2d"],
                        env={"DEACON_POD_SHARDS": "2"})
    same_bytes(o, ref["single"][0], "--mesh pod-2d")
    record("pod-2d 4 ranks single", reports, bp["single"],
           blocks=block_of(2))
    o = os.path.join(tmp, "pod_build.idx")
    reports = pod_ranks(2, ["index", "build", fa, "-o", o, "-q", "--device",
                            "cuda", "--mesh", "pod-data"], coord=False)
    same_bytes(o, read_bytes(ref_idx), "index build --mesh pod-data")
    record("index build pod-data 2 ranks", reports, bp["fasta"],
           filter_ranks=False)
    if any(x["launches"]["K1"] <= 0 for x in reports):
        raise AssertionError(f"phase 18 build: {reports}")

    http = _free_port()
    url = f"http://127.0.0.1:{http}"
    client = {}

    def serve_and_ask():
        wait_http(url)
        o = os.path.join(tmp, "pod_client.fq")
        client["s"], _ = cli_timed(["client", url, fq, "-o", o, "-q"])
        same_bytes(o, ref["single"][0], "client of server --mesh pod")

    reports = pod_ranks(2, ["server", idx, "-p", http, "--host", "127.0.0.1",
                            "--device", "cuda", "--mesh", "pod"],
                        during=serve_and_ask)
    record("server pod 2 ranks", reports, 0, filter_ranks=False)
    runs["server pod 2 ranks"]["client_mbp_per_s"] = round(
        bp["single"] / 1e6 / client["s"], 3)
    t = time.perf_counter()
    httpd = make_server(idx, 0, host="127.0.0.1", device="cuda",
                        mesh=mk_mesh(1, 2, ["cuda:0"] * 2))
    start_s = time.perf_counter() - t
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        o = os.path.join(tmp, "mesh_client.fq")
        wall, _ = cli_timed(["client",
                             f"http://127.0.0.1:{httpd.server_address[1]}",
                             r1, r2, "-o", o, "-O", o + ".2", "-q"])
        same_bytes(o, ref["paired"][0], "client of a 1x2 mesh server")
        same_bytes(o + ".2", ref["paired"][1],
                   "client of a 1x2 mesh server -O")
        runs["server mesh 1x2 on cuda:0"] = {
            "start_s": round(start_s, 3),
            **{n: round(v, 3) for n, v in httpd.state.timings.items()},
            "resident_gb": round(httpd.state.probe.nbytes / 1e9, 3),
            "client_mbp_per_s": round(bp["paired"] / 1e6 / wall, 3)}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    del httpd
    torch.cuda.empty_cache()
    numbers = {"mbp": {n: v / 1e6 for n, v in bp.items()}, "p": p,
               "runs": runs}
    log("18 multi-process modes on the card", t0,
        **{n: json.dumps(v) for n, v in numbers.items()})
    return numbers


def pods_on_cards(rng) -> dict:
    """``python3 chip_smoke.py --pod4`` on a machine with four cards: the
    pod modes with each rank on a card of its own (CUDA_VISIBLE_DEVICES
    set to the rank), where the backend rule picks nccl, against the
    one-process ``filter`` on card 0: phase 4's keys written to an index
    file, phase 4's single and ONT-like reads as FASTQ; four ranks each
    of ``filter --mesh pod``, ``--mesh pod-2d`` (DEACON_POD_SHARDS=2: two
    groups of two), ``--mesh pod-data`` and ``server --mesh pod`` answered
    by ``client``. Every output byte-identical to the one-process run,
    K1 and K2 launched in every filter rank, K2 on exactly each pod rank's
    block, nccl chosen in every pod rank. Then the pod modes with two
    ranks of two cards each, and two ranks that see all four cards
    (pods_on_card_pairs); then, in this process, which sees the four
    cards, the single-process meshes over them (meshes_on_cards)."""
    from deacon_tpu_torch.ops.radix_probe import choose_p

    cards = torch.cuda.device_count()
    if cards < 4:
        raise AssertionError(f"--pod4 needs four cards, this machine has "
                             f"{cards}")
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="deacon_torch_smoke_pod4_")
    try:
        genome, _, keys_u, _ = panhuman_keys(rng, K_, "4")
        n_keys = int(keys_u.numel())
        idx = os.path.join(tmp, "panhuman.idx")
        dtt.write_index(keys_u.cpu().numpy().view(np.uint64),
                        dtt.IndexHeader.new(K_, W_), idx)
        del keys_u
        torch.cuda.empty_cache()
        single, pairs, ont = make_reads(rng, genome)
        fq = os.path.join(tmp, "s.fq")
        write_fastq(fq, [(b"s%d" % i, r) for i, r in enumerate(single + ont)])
        r1, r2 = (os.path.join(tmp, f"r{m}.fq") for m in (1, 2))
        write_fastq(r1, [(b"p%d/1" % i, a) for i, (a, _) in enumerate(pairs)])
        write_fastq(r2, [(b"p%d/2" % i, b) for i, (_, b) in enumerate(pairs)])
        n_bp = sum(len(r) for r in single + ont)
        paired_bp = sum(len(a) + len(b) for a, b in pairs)
        o = os.path.join(tmp, "ref.fq")
        wall, _ = cli_timed(["filter", idx, fq, "-o", o, "--device", "cuda"])
        ref = read_bytes(o)
        runs = {"one-process filter": {"s": round(wall, 3), "mbp_per_s":
                                       round(n_bp / 1e6 / wall, 3)}}
        wall, _ = cli_timed(["filter", idx, r1, r2, "-o", o + ".p", "-O",
                             o + ".p2", "--device", "cuda"])
        refs = {"single": [ref], "paired": [read_bytes(o + ".p"),
                                            read_bytes(o + ".p2")]}
        runs["one-process filter paired"] = {
            "s": round(wall, 3), "mbp_per_s": round(paired_bp / 1e6 / wall,
                                                    3)}
        p = choose_p(n_keys)

        def card(r):
            return {"CUDA_VISIBLE_DEVICES": str(r)}

        outs = [os.path.join(tmp, f"pod{r}.fq") for r in range(4)]
        reports = pod_ranks(4, lambda r: ["filter", idx, fq, "-o", outs[r],
                                          "--device", "cuda", "--mesh",
                                          "pod"], env=card)
        for o in outs:
            same_bytes(o, ref, "--mesh pod on four cards")
        runs["pod 4 ranks"] = pod_record(
            "pod 4 ranks", reports, n_bp, backend="nccl",
            blocks=lambda r: pod_block(r, 4, p))
        o = os.path.join(tmp, "p2d.fq")
        reports = pod_ranks(4, ["filter", idx, fq, "-o", o, "--device",
                                "cuda", "--mesh", "pod-2d"],
                            env=lambda r: {**card(r),
                                           "DEACON_POD_SHARDS": "2"})
        same_bytes(o, ref, "--mesh pod-2d on four cards")
        runs["pod-2d 4 ranks"] = pod_record(
            "pod-2d 4 ranks", reports, n_bp, backend="nccl",
            blocks=lambda r: pod_block(r % 2, 2, p))
        o = os.path.join(tmp, "pd.fq")
        reports = pod_ranks(4, ["filter", idx, fq, "-o", o, "--device",
                                "cuda", "--mesh", "pod-data"], env=card,
                            coord=False)
        same_bytes(o, ref, "--mesh pod-data on four cards")
        runs["pod-data 4 ranks"] = pod_record("pod-data 4 ranks", reports,
                                              n_bp)
        url = f"http://127.0.0.1:{_free_port()}"
        client = {}

        def serve_and_ask():
            wait_http(url)
            o = os.path.join(tmp, "client.fq")
            client["s"], _ = cli_timed(["client", url, fq, "-o", o, "-q"])
            same_bytes(o, ref, "client of server --mesh pod on four cards")

        reports = pod_ranks(4, ["server", idx, "-p", url.rsplit(":", 1)[1],
                                "--host", "127.0.0.1", "--device", "cuda",
                                "--mesh", "pod"], env=card,
                            during=serve_and_ask)
        runs["server pod 4 ranks"] = {
            **pod_record("server pod 4 ranks", reports, 0,
                         filter_ranks=False),
            "client_mbp_per_s": round(n_bp / 1e6 / client["s"], 3),
            "backends": [x["backend"] for x in reports]}
        if runs["server pod 4 ranks"]["backends"] != ["nccl"] * 4:
            raise AssertionError(f"server pod on four cards: "
                                 f"{runs['server pod 4 ranks']['backends']}")
        inputs = {"single": [fq], "paired": [r1, r2]}
        bps = {"single": n_bp, "paired": paired_bp}
        runs.update(pods_on_card_pairs(rng, idx, tmp, inputs, refs, bps, p))
        runs.update(meshes_on_cards(idx, tmp, inputs, refs, bps))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("pod4 the pod modes on four cards", t0, mbp=n_bp / 1e6,
        runs=json.dumps(runs))
    return runs


def pods_on_card_pairs(rng, idx: str, tmp: str, inputs: dict, refs: dict,
                       bp: dict, p: int) -> dict:
    """``--pod4``'s ranks that drive two cards each, the JAX pod modes'
    own shape (one process per host over all of its chips): rank 0 sees
    cards 0 and 1 (CUDA_VISIBLE_DEVICES=0,1), rank 1 cards 2 and 3.

    * ``filter --mesh pod``, single and paired: each rank's mesh has two
      data rows and its collectives run over nccl; K1 and K2 launch on
      both of its cards, K2 on the rank's block of rows only;
    * ``--mesh pod-2d`` with DEACON_POD_SHARDS=1 (two groups of one rank,
      the whole table on each of a rank's two data rows);
    * ``--mesh pod-data`` with DEACON_POD_ENGINE=sharded (a 2x1 local
      mesh: the table whole on both cards) and DEACON_POD_LOCAL_MESH=1x2
      (the table cut over the two cards);
    * ``index build --mesh pod-data`` against the one-process build;
    * ``server --mesh pod`` answered by ``client``, single and paired,
      then idle for longer than HEARTBEAT_S and answered again (the
      keep-alive over nccl); both cards of each rank hold the rank's
      value range (card 1's peak GB within 10% of card 0's) and search
      their parts of the queries; GB and searches per card, the client's
      Mbp/s beside those of the probe on a rank's first card only;
    * ``server --mesh pod`` on ranks of unequal cards (cards 0,1 and
      card 2): data=1 in both ranks, card 0 alone searching, exact;
    * the README's launch lines uncut (no CUDA_VISIBLE_DEVICES, each
      rank seeing the four cards): two ranks of ``filter --mesh pod``,
      of ``--mesh pod-data`` and of ``server --mesh pod`` with
      ``client``.

    Every output byte-identical to the one-process run on card 0
    (``refs``; the build against ``cli_index_build`` on card 0). Per
    run: Mbp/s, each rank's mesh, backend, launches per card, peak GB
    per card and its all-reduces' share of its seconds."""
    from deacon_tpu_torch.server.app import HEARTBEAT_S

    runs = {}

    def pair(r):
        return {"CUDA_VISIBLE_DEVICES": f"{2 * r},{2 * r + 1}"}

    def check(label, reports, mesh, cards, **launched):
        """Each rank made ``mesh`` (data, shard) over its local cards
        ``cards`` and launched each kernel of ``launched`` on exactly the
        cards listed there, each of which held memory."""
        for x in reports:
            if any(x["card_peak_gb"][i] <= 0 for i in
                   {i for on in launched.values() for i in on}):
                raise AssertionError(f"{label} rank {x['rank']}: peak GB "
                                     f"{x['card_peak_gb']}")
            got = [(m["data"], m["shard"], m["cards"]) for m in x["meshes"]]
            if mesh is not None and got != [(*mesh, cards)]:
                raise AssertionError(f"{label} rank {x['rank']}: meshes "
                                     f"{x['meshes']}, not {mesh} on {cards}")
            for kernel, want in launched.items():
                on = [i for i, n in enumerate(
                    x["card_launches"].get(kernel, ())) if n > 0]
                if on != want:
                    raise AssertionError(
                        f"{label} rank {x['rank']}: {kernel} launched on "
                        f"cards {on}, not {want}: {x['card_launches']}")

    def keep(label, rec, reports):
        for r, x in zip(rec["ranks"], reports):
            r["allreduce_share"] = round(x["allreduce_s"] / x["s"], 4)
            r["heartbeats"] = x["heartbeats"]
        runs[label] = rec
        print(f"[pod4] {label}: {json.dumps(rec)}", flush=True)

    both = [[0], [1]]
    for name, paths in inputs.items():
        outs = [os.path.join(tmp, f"pair_pod_{name}{r}.fq") for r in range(2)]

        def argv(r, paths=paths, outs=outs, name=name):
            extra = ["-O", outs[r] + ".2"] if name == "paired" else []
            return ["filter", idx, *paths, "-o", outs[r], *extra,
                    "--device", "cuda", "--mesh", "pod"]

        reports = pod_ranks(2, argv, env=pair)
        for o in outs:
            same_bytes(o, refs[name][0], f"--mesh pod, 2 cards a rank, {name}")
            if name == "paired":
                same_bytes(o + ".2", refs[name][1],
                           "--mesh pod, 2 cards a rank, paired -O")
        label = f"pod 2 ranks x 2 cards {name}"
        check(label, reports, (2, 2), both, K1=[0, 1], K2=[0, 1])
        keep(label, pod_record(label, reports, bp[name], backend="nccl",
                               blocks=lambda r: pod_block(r, 2, p)), reports)
    o = os.path.join(tmp, "pair_p2d.fq")
    reports = pod_ranks(2, ["filter", idx, *inputs["single"], "-o", o,
                            "--device", "cuda", "--mesh", "pod-2d"],
                        env=lambda r: {**pair(r), "DEACON_POD_SHARDS": "1"})
    same_bytes(o, refs["single"][0], "--mesh pod-2d, 2 cards a rank")
    label = "pod-2d 2 groups of 1 rank x 2 cards"
    check(label, reports, (2, 1), both, K1=[0, 1], K2=[0, 1])
    keep(label, pod_record(label, reports, bp["single"], backend="nccl",
                           blocks=lambda r: pod_block(0, 1, p)), reports)
    for label, env, mesh, cards, k1 in (
            ("pod-data 2 ranks, local mesh 2x1",
             {"DEACON_POD_ENGINE": "sharded"}, (2, 1), both, [0, 1]),
            ("pod-data 2 ranks, local mesh 1x2",
             {"DEACON_POD_LOCAL_MESH": "1x2"}, (1, 2), [[0, 1]], [0])):
        o = os.path.join(tmp, f"pair_pd_{mesh[0]}x{mesh[1]}.fq")
        reports = pod_ranks(2, ["filter", idx, *inputs["single"], "-o", o,
                                "--device", "cuda", "--mesh", "pod-data"],
                            env=lambda r, env=env: {**pair(r), **env},
                            coord=False)
        same_bytes(o, refs["single"][0], label)
        check(label, reports, mesh, cards, K1=k1, K2=[0, 1])
        keep(label, pod_record(label, reports, bp["single"]), reports)
    fa = os.path.join(tmp, "pair_build.fa")
    recs = dirty_records(rng, 5, SCALE_RECORD_BP, SCALE_RECORD_BP + 1)
    write_fasta(fa, recs)
    ref_idx = os.path.join(tmp, "pair_build_ref.idx")
    t = time.perf_counter()
    cli_index_build(fa, ref_idx, K_, W_, "cuda")
    one_s = time.perf_counter() - t
    o = os.path.join(tmp, "pair_build.idx")
    reports = pod_ranks(2, ["index", "build", fa, "-o", o, "-q", "--device",
                            "cuda", "--mesh", "pod-data"], env=pair,
                        coord=False)
    same_bytes(o, read_bytes(ref_idx), "index build --mesh pod-data, "
                                       "2 cards a rank")
    label = "index build pod-data 2 ranks x 2 cards"
    check(label, reports, None, None, K1=[0])
    rec = pod_record(label, reports, sum(len(x) for _, x in recs),
                     filter_ranks=False)
    rec["one_process_s"] = round(one_s, 3)
    keep(label, rec, reports)

    def held(reports):
        """The cards on which each rank held memory."""
        return [[i for i, g in enumerate(x["card_peak_gb"]) if g > 0]
                for x in reports]

    url = f"http://127.0.0.1:{_free_port()}"
    idle_s = HEARTBEAT_S + 15
    client = {}

    def ask(label, name):
        o = os.path.join(tmp, f"pair_client_{len(client)}.fq")
        extra = ["-O", o + ".2"] if name == "paired" else []
        wall, _ = cli_timed(["client", url, *inputs[name], "-o", o, *extra,
                             "-q"])
        what = f"client of server --mesh pod, 2 cards a rank ({label})"
        same_bytes(o, refs[name][0], what)
        if extra:
            same_bytes(o + ".2", refs[name][1], what + " -O")
        client[f"{label} mbp_per_s"] = round(bp[name] / 1e6 / wall, 3)

    def serve_and_ask():
        wait_http(url)
        ask("single", "single")
        ask("paired", "paired")
        time.sleep(idle_s)
        ask("single after idle", "single")

    def server_argv(url):
        return ["server", idx, "-p", url.rsplit(":", 1)[1], "--host",
                "127.0.0.1", "--device", "cuda", "--mesh", "pod"]

    def nccl(label, reports):
        if [x["backend"] for x in reports] != ["nccl"] * 2:
            raise AssertionError(f"{label}: backends "
                                 f"{[x['backend'] for x in reports]}")

    def per_card(reports):
        return [{"gb": x["card_peak_gb"],
                 "searches": x["card_launches"].get("search")}
                for x in reports]

    reports = pod_ranks(2, server_argv(url), env=pair,
                        during=serve_and_ask,
                        limit=POD_RUN_LIMIT_S + idle_s)
    label = "server pod 2 ranks x 2 cards"
    check(label, reports, (2, 2), both, search=[0, 1])
    nccl(label, reports)
    for x in reports:
        gb = x["card_peak_gb"]
        if not (gb[1] > 0 and abs(gb[1] - gb[0]) <= 0.1 * gb[0]):
            raise AssertionError(f"{label} rank {x['rank']}: card 1 does "
                                 f"not hold the rank's range: GB {gb}")
    if any(x["heartbeats"] < 1 for x in reports):
        raise AssertionError(f"{label}: no keep-alive in the idle gap: "
                             f"{[x['heartbeats'] for x in reports]}")
    rec = pod_record(label, reports, 0, filter_ranks=False)
    rec.update({"client": client, "idle_s": idle_s,
                "heartbeat_s": HEARTBEAT_S,
                "probe_cards": held(reports), "per_card": per_card(reports),
                "client_first_card_only": FIRST_CARD_ONLY_CLIENT_MBP})
    keep(label, rec, reports)
    url = f"http://127.0.0.1:{_free_port()}"
    unequal = {}

    def ask_unequal():
        wait_http(url)
        o = os.path.join(tmp, "unequal_client.fq")
        wall, _ = cli_timed(["client", url, *inputs["single"], "-o", o,
                             "-q"])
        same_bytes(o, refs["single"][0], "client of server --mesh pod on "
                                         "ranks of 2 cards and 1")
        unequal["single mbp_per_s"] = round(bp["single"] / 1e6 / wall, 3)

    reports = pod_ranks(2, server_argv(url), during=ask_unequal,
                        env=lambda r: {"CUDA_VISIBLE_DEVICES": "0,1"
                                       if r == 0 else "2"})
    label = "server pod ranks of 2 cards and 1"
    check(label, reports, (1, 2), [[0]], search=[0])
    nccl(label, reports)
    rec = pod_record(label, reports, 0, filter_ranks=False)
    rec.update({"client": unequal, "probe_cards": held(reports),
                "per_card": per_card(reports)})
    keep(label, rec, reports)

    def uncut(*args, **kwargs):
        """pod_ranks with no CUDA_VISIBLE_DEVICES in the ranks (this
        process's cards are fixed since its first CUDA call)."""
        visible = os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        try:
            return pod_ranks(*args, **kwargs)
        finally:
            if visible is not None:
                os.environ["CUDA_VISIBLE_DEVICES"] = visible

    every = [[0], [1], [2], [3]]
    outs = [os.path.join(tmp, f"uncut_pod{r}.fq") for r in range(2)]
    reports = uncut(2, lambda r: ["filter", idx, *inputs["single"], "-o",
                                  outs[r], "--device", "cuda", "--mesh",
                                  "pod"])
    for o in outs:
        same_bytes(o, refs["single"][0], "--mesh pod, every card a rank")
    label = "uncut pod 2 ranks, 4 cards each"
    check(label, reports, (4, 2), every, K1=[0, 1, 2, 3], K2=[0, 1, 2, 3])
    keep(label, pod_record(label, reports, bp["single"], backend="gloo",
                           blocks=lambda r: pod_block(r, 2, p)), reports)
    o = os.path.join(tmp, "uncut_pd.fq")
    reports = uncut(2, ["filter", idx, *inputs["single"], "-o", o,
                        "--device", "cuda", "--mesh", "pod-data"],
                    coord=False)
    same_bytes(o, refs["single"][0], "--mesh pod-data, every card a rank")
    label = "uncut pod-data 2 ranks"
    check(label, reports, None, None, K1=[0], K2=[0])
    keep(label, pod_record(label, reports, bp["single"]), reports)
    url = f"http://127.0.0.1:{_free_port()}"

    def ask():
        wait_http(url)
        o = os.path.join(tmp, "uncut_client.fq")
        cli_timed(["client", url, *inputs["single"], "-o", o, "-q"])
        same_bytes(o, refs["single"][0], "client of the uncut pod server")

    reports = uncut(2, ["server", idx, "-p", url.rsplit(":", 1)[1],
                        "--host", "127.0.0.1", "--device", "cuda", "--mesh",
                        "pod"], during=ask)
    label = "uncut server pod 2 ranks"
    check(label, reports, (4, 2), every, search=[0, 1, 2, 3])
    rec = pod_record(label, reports, 0, filter_ranks=False)
    rec["probe_cards"] = held(reports)
    rec["backends"] = [x["backend"] for x in reports]
    keep(label, rec, reports)
    return runs


def meshes_on_cards(idx: str, tmp: str, inputs: dict, refs: dict,
                    bp: dict) -> dict:
    """``--pod4``'s single-process meshes over four distinct cards, in
    this process (no CUDA_VISIBLE_DEVICES cut): ``filter --mesh 2x2`` and
    ``--mesh 1x4`` on ``--device cuda``, single and paired (-O), each
    output byte-identical to the one-card run (``refs``), K1 and K2
    launched, every card holding memory; then ``server --mesh 1x4``
    (make_server) answered by ``client``, single and paired. Per run:
    seconds, Mbp/s, launches and each card's peak GB
    (torch.cuda.max_memory_allocated(i), reset before the run)."""
    import threading

    from deacon_tpu_torch.server.app import make_server

    cards = range(4)
    runs = {}

    def reset():
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
        reset_launches()

    def peaks():
        for i in cards:
            torch.cuda.synchronize(i)
        return [round(torch.cuda.max_memory_allocated(i) / 1e9, 3)
                for i in cards]

    def check(o, name, what):
        same_bytes(o, refs[name][0], what)
        if name == "paired":
            same_bytes(o + ".2", refs[name][1], what + " -O")

    for spec in ("2x2", "1x4"):
        n_data, n_shard = (int(x) for x in spec.split("x"))
        for name, paths in inputs.items():
            o = os.path.join(tmp, f"mesh{spec}_{name}.fq")
            extra = ["-O", o + ".2"] if name == "paired" else []
            reset()
            wall, err = cli_timed(["filter", idx, *paths, "-o", o, *extra,
                                   "--device", "cuda", "--mesh", spec])
            peak = peaks()
            launches = launch_counts()
            what = f"filter --mesh {spec} {name} on four cards"
            check(o, name, what)
            shape = f"mesh data={n_data} x shard={n_shard}"
            if shape not in err or launches["K1"] <= 0 \
                    or launches["K2"] <= 0 or min(peak) <= 0:
                raise AssertionError(f"{what}: launches {launches}, peak GB "
                                     f"{peak}: {err[-800:]}")
            runs[f"mesh {spec} {name}"] = {
                "s": round(wall, 3),
                "mbp_per_s": round(bp[name] / 1e6 / wall, 3),
                "launches": launches, "peak_gb": peak}
            print(f"[pod4] filter --mesh {spec} {name}: "
                  f"{json.dumps(runs[f'mesh {spec} {name}'])}", flush=True)
    reset()
    t = time.perf_counter()
    httpd = make_server(idx, 0, host="127.0.0.1", device="cuda",
                        mesh="1x4")
    start_s = time.perf_counter() - t
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    server = {"start_s": round(start_s, 3),
              "resident_gb": round(httpd.state.probe.nbytes / 1e9, 3)}
    try:
        for name, paths in inputs.items():
            o = os.path.join(tmp, f"mesh_client_{name}.fq")
            extra = ["-O", o + ".2"] if name == "paired" else []
            wall, _ = cli_timed(["client", url, *paths, "-o", o, *extra,
                                 "-q"])
            check(o, name, f"client of server --mesh 1x4 ({name})")
            server[f"client_{name}_mbp_per_s"] = round(bp[name] / 1e6 / wall,
                                                       3)
        server["peak_gb"] = peaks()
        if min(server["peak_gb"]) <= 0:
            raise AssertionError(f"server --mesh 1x4: peak GB "
                                 f"{server['peak_gb']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    del httpd
    torch.cuda.empty_cache()
    runs["server mesh 1x4"] = server
    print(f"[pod4] server --mesh 1x4: {json.dumps(server)}", flush=True)
    return runs


def wait_http(url: str) -> None:
    """Return once ``url`` answers; raise after POD_RUN_LIMIT_S."""
    deadline = time.perf_counter() + POD_RUN_LIMIT_S
    while True:
        try:
            http_get(url + "/")
            return
        except OSError:
            if time.perf_counter() > deadline:
                raise AssertionError(f"{url} never answered") from None
            time.sleep(0.5)


def sorted_unique(x: np.ndarray) -> np.ndarray:
    """np.unique by a sort and an adjacent compare: the data of phase 16
    (np.unique itself is the reference's slow part there)."""
    x = np.sort(x)
    return x[np.concatenate([[True], x[1:] != x[:-1]])]


def diff_cli(first: str, second: str, out: str, what: str, *flags: str):
    """``index diff`` on the card; -> (seconds, launches, the output's keys,
    standard error)."""
    reset_launches()
    wall, err = cli_timed(["index", "diff", first, second, "-o", out,
                           "--device", "cuda", *flags])
    launches = launch_counts()
    if f"Second index: processing FASTX from file" not in err:
        raise AssertionError(f"{what}: not a FASTX diff:\n{err[-1000:]}")
    return wall, launches, dtt.load_index(out).hashes, err


def check_launches(launches: dict, kernel: str, what: str) -> None:
    """kernel launched, no other kernel of the port."""
    if launches[kernel] <= 0 or any(v for n, v in launches.items()
                                    if n != kernel):
        raise AssertionError(f"{what}: expected {kernel} only, launches "
                             f"{launches}")


def phase16_index_ops(idx: str, keys_host, genome: bytes, g_hashes,
                      tmp: str) -> dict:
    """Phase 16: ``index diff`` of the panhuman file minus the 5 Mbp
    genome as FASTA at k=31 (K1), equal to NumPy's setdiff1d of the keys
    and the genome's oracle minimizers; the same at phase 6's size from a
    k=41 index with -k/-w absent (K3) and under DEACON_PALLAS=1 at k=41
    and 31 (K5); ``index union`` and index-minus-index ``diff`` of two
    ~1e7-key indexes against np.union1d and np.setdiff1d."""
    from deacon_tpu_torch.index.build import _stream_diff_fastx

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 16)
    numbers = {}
    fa = os.path.join(tmp, "genome.fa")
    write_fasta(fa, [(b"genome", genome)])
    out = os.path.join(tmp, "diff.idx")
    wall, launches, got, err = diff_cli(idx, fa, out, "panhuman diff", "-k",
                                        str(K_), "-w", str(W_))
    t = time.perf_counter()
    want = np.setdiff1d(keys_host, g_hashes, assume_unique=True)
    setdiff_s = time.perf_counter() - t
    if not np.array_equal(got, want):
        raise AssertionError(f"panhuman diff: {got.size} keys, NumPy "
                             f"setdiff1d {want.size}")
    check_launches(launches, "K1", "panhuman diff")
    os.unlink(out)
    del got, want
    # the FASTX part alone: the keys' upload, extraction, keep-mask
    header = dtt.IndexHeader.new(K_, W_)
    t = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        rest = _stream_diff_fastx(fa, K_, W_, header, keys_host, "cuda")
    stream_s = time.perf_counter() - t
    removed = keys_host.size - rest.size
    del rest
    numbers["panhuman_k31"] = {
        "keys": int(keys_host.size), "genome_minimizers": int(g_hashes.size),
        "removed": int(removed), "cli_s": round(wall, 3),
        "cli_mbp_per_s": round(len(genome) / 1e6 / wall, 3),
        "fastx_part_s": round(stream_s, 3),
        "fastx_part_mbp_per_s": round(len(genome) / 1e6 / stream_s, 3),
        "numpy_setdiff1d_s": round(setdiff_s, 3), "launches": launches}
    if removed != g_hashes.size:
        raise AssertionError(f"panhuman diff: removed {removed} of "
                             f"{g_hashes.size}")
    # phase 6's size: six dirty records, the index of all six plus 2e6
    # random keys, minus four of them as FASTA
    recs = dirty_records(rng, 6, 40_000, 120_000)
    sub = os.path.join(tmp, "sub.fa")
    write_fasta(sub, recs[:4])
    noise = rng.integers(0, 2**64, 2_000_000, dtype=np.uint64)
    for k, env, kernel in ((K_WIDE, {}, "K3"),
                           (K_WIDE, {"DEACON_PALLAS": "1"}, "K5"),
                           (K_, {"DEACON_PALLAS": "1"}, "K5")):
        mins = [dtt.compute_minimizer_hashes(s, k, W_) for _, s in recs]
        keys = sorted_unique(np.concatenate([*mins, noise]))
        first = os.path.join(tmp, f"k{k}.idx")
        dtt.write_index(keys, dtt.IndexHeader.new(k, W_), first)
        with switches(**env):
            wall, launches, got, err = diff_cli(first, sub, out,
                                                f"diff k={k} {env}")
        if f"(k={k}, w={W_})" not in err:
            raise AssertionError(f"diff k={k}: k and w not auto-detected")
        want = np.setdiff1d(keys, sorted_unique(np.concatenate(mins[:4])),
                            assume_unique=True)
        if not np.array_equal(got, want):
            raise AssertionError(f"diff k={k} {env}: {got.size} keys, NumPy "
                                 f"setdiff1d {want.size}")
        check_launches(launches, kernel, f"diff k={k} {env}")
        bp = sum(len(s) for _, s in recs[:4])
        numbers[f"k{k}_{kernel}"] = {
            "keys": int(keys.size), "removed": int(keys.size - got.size),
            "fastx_mbp": bp / 1e6, "cli_s": round(wall, 3),
            "cli_mbp_per_s": round(bp / 1e6 / wall, 3),
            "launches": launches}
    # union and index-minus-index diff of two ~1e7-key indexes
    a = sorted_unique(rng.integers(0, 2**64, 10_000_000, dtype=np.uint64))
    b = sorted_unique(np.concatenate([
        a[rng.integers(0, a.size, 3_000_000)],
        rng.integers(0, 2**64, 7_000_000, dtype=np.uint64)]))
    ia, ib, iu = (os.path.join(tmp, f) for f in ("a.idx", "b.idx", "u.idx"))
    dtt.write_index(a, dtt.IndexHeader.new(K_, W_), ia)
    dtt.write_index(b, dtt.IndexHeader.new(K_, W_), ib)
    union_s, _ = cli_timed(["index", "union", ia, ib, "-o", iu])
    t = time.perf_counter()
    want = np.union1d(a, b)
    union1d_s = time.perf_counter() - t
    if not np.array_equal(dtt.load_index(iu).hashes, want):
        raise AssertionError("index union differs from np.union1d")
    reset_launches()
    idiff_s, _ = cli_timed(["index", "diff", ia, ib, "-o", out])
    if not np.array_equal(dtt.load_index(out).hashes,
                          np.setdiff1d(a, b, assume_unique=True)):
        raise AssertionError("index-index diff differs from np.setdiff1d")
    if any(launch_counts().values()):
        raise AssertionError("index-index diff launched a kernel")
    numbers["union_1e7"] = {"keys": [int(a.size), int(b.size)],
                            "union_s": round(union_s, 3),
                            "numpy_union1d_s": round(union1d_s, 3),
                            "numpy": np.__version__,
                            "index_diff_s": round(idiff_s, 3)}
    log("16 index union and diff on the card", t0, **{
        n: json.dumps(v) for n, v in numbers.items()})
    return numbers


# ---------------------------------------------------------------------------
# phase 8: index build at scale, against the oracle
# ---------------------------------------------------------------------------

SCALE_RECORDS, SCALE_RECORD_BP = 26, 4_000_000  # 104 Mbp
ORACLE_WORKERS, ORACLE_SECONDS = 6, 120


# ---------------------------------------------------------------------------
# phase 0's toolchain probe and phase 17: host I/O parity and rates
# ---------------------------------------------------------------------------

BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
CODEC_LIBS = ("libz.", "libzstd", "liblzma", "libbz2")


def host_toolchain() -> dict:
    """g++'s version, the codec headers present, and the codec libraries
    ldconfig knows (an unversioned .so name is a link-time name)."""
    gpp = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    ld = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                        timeout=60).stdout.splitlines()
    libs = sorted({ln.split()[0] for ln in ld
                   if ln.strip().startswith(CODEC_LIBS)})
    return {"gpp": gpp[0] if gpp else "",
            "headers": {h: os.path.exists(f"/usr/include/{h}.h")
                        for h in ("zlib", "zstd", "lzma", "bzlib")},
            "libs": libs}


def bgzf(data: bytes, block: int = 65280) -> bytes:
    """BGZF (blocked gzip): deflate members of at most ``block`` input
    bytes, each with the BC extra field holding its size, then the EOF
    block."""
    import struct
    import zlib

    out = []
    for i in range(0, len(data), block):
        chunk = data[i:i + block]
        c = zlib.compressobj(1, zlib.DEFLATED, -15)
        body = c.compress(chunk) + c.flush()
        out.append(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02"
                   b"\x00" + struct.pack("<H", 18 + len(body) + 8 - 1)
                   + body + struct.pack("<II", zlib.crc32(chunk), len(chunk)))
    return b"".join(out) + BGZF_EOF


def _compressors() -> dict:
    import bz2
    import gzip
    import lzma

    def zst(data: bytes) -> bytes:
        buf = io.BytesIO()
        w = zstd.Writer(buf, 3, "<memory>")
        w.write(data)
        w.close()
        return buf.getvalue()

    return {"plain": lambda d: d,
            "gz": lambda d: gzip.compress(d, compresslevel=1, mtime=0),
            "bgzf": bgzf, "zst": zst,
            "xz": lambda d: lzma.compress(d, preset=0),
            "bz2": lambda d: bz2.compress(d, compresslevel=1)}


def _fastq_bytes(recs) -> bytes:
    return b"".join(b"@%s\n%s\n+\n%s\n" % (n, s, b"I" * len(s))
                    for n, s in recs)


def _dirty(rng, reads: list[bytes]) -> list[bytes]:
    """One read in ten with six bases made IUPAC or lowercase."""
    out = []
    for i, r in enumerate(reads):
        if i % 10 == 3 and r:
            b = bytearray(r)
            for j in rng.integers(0, len(b), 6):
                b[int(j)] = b"acgtNRYKMn"[int(rng.integers(0, 10))]
            r = bytes(b)
        out.append(r)
    return out


def _native_records(path: str, batch: int = 10_000):
    """Every record through the host library's reader in filter-sized
    batches: (records, seconds of the reading alone)."""
    t = time.perf_counter()
    reader = FastxReader.from_path(path)
    batches = []
    while len(b := reader.read_batch(batch)):
        batches.append(b)
    secs = time.perf_counter() - t
    return [r for b in batches for r in b.records()], secs


def phase17_host_io(idx: str, keys_host, single, pairs, tmp: str) -> dict:
    """Phase 17: each host-library function against its plain version on
    seeded inputs, with rates on the card's host."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 17)
    out: dict = {}
    # reader: phase 4's reads as FASTQ, single and paired, every format
    s_reads = _dirty(rng, single)
    p_reads = _dirty(rng, [s for pr in pairs for s in pr])
    texts = {
        "s.fq": _fastq_bytes((b"s%d x" % i, r) for i, r in enumerate(s_reads)),
        "r1.fq": _fastq_bytes((b"p%d/1" % i, r)
                              for i, r in enumerate(p_reads[0::2])),
        "r2.fq": _fastq_bytes((b"p%d/2" % i, r)
                              for i, r in enumerate(p_reads[1::2])),
    }
    total_mb = sum(map(len, texts.values())) / 1e6
    reader = {}
    for fmt, comp in _compressors().items():
        native_s = plain_s = 0.0
        n_recs = 0
        for name, text in texts.items():
            path = os.path.join(tmp, f"{name}.{fmt}")
            with open(path, "wb") as f:
                f.write(comp(text))
            got, secs = _native_records(path)
            native_s += secs
            t = time.perf_counter()
            with open_maybe_compressed(path) as stream:
                want = list(FastxReader(stream))
            plain_s += time.perf_counter() - t
            if got != want:
                raise AssertionError(f"phase 17: reader on {name}.{fmt} "
                                     "differs from the Python parser")
            n_recs += len(got)
            os.unlink(path)
        reader[fmt] = {"records": n_recs,
                       "mb_per_s": round(total_mb / native_s, 3),
                       "plain_mb_per_s": round(total_mb / plain_s, 3)}
    out["reader"] = {"mb": round(total_mb, 3), "formats": reader}
    # tile packer: default tiles and 4a's, filter and index codes
    packer = []
    for L, R in (*DevicePipeline.DEFAULT_TILES, *K4_TILES):
        rows = tile_rows(rng, L, R)
        block = RowBlock.from_rows(rows)
        l = K_ + W_ - 1
        for code_name, code in (("filter", PACK_CODE), ("index", INDEX_CODE)):
            got = pack_block(block, R, L, K_, l, code)
            want = pack_rows_packed_plain(rows, R, L, K_, l, code)
            if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"phase 17: packer ({L}, {R}) {code_name}"
                                     " differs from pack_rows_packed_plain")
            native_ms = min(_wall_ms(lambda: pack_block(block, R, L, K_, l,
                                                        code))
                            for _ in range(5))
            plain_ms = min(_wall_ms(lambda: pack_rows_packed_plain(
                rows, R, L, K_, l, code)) for _ in range(2))
            packer.append({"tile": [L, R], "code": code_name,
                           "ms": round(native_ms, 3),
                           "plain_ms": round(plain_ms, 3)})
    out["packer"] = packer
    # codec: the phase-15 file, host library against NumPy
    buf = np.memmap(idx, dtype=np.uint8, mode="r")
    count, pos = bincode.decode_uint(memoryview(buf[:32].tobytes()), 3)
    t = time.perf_counter()
    got, end = host.decode_u64_varint(buf, pos, count)
    native_s = time.perf_counter() - t
    t = time.perf_counter()
    want, end_p = bincode.decode_u64_array(buf, pos, count)
    plain_s = time.perf_counter() - t
    if end != end_p or not (np.array_equal(got, want)
                            and np.array_equal(got, keys_host)):
        raise AssertionError("phase 17: decoded keys differ")
    del got, want, buf
    out["codec"] = {"keys": int(count), "decode_s": round(native_s, 3),
                    "plain_decode_s": round(plain_s, 3)}
    # writer: a round trip in each output codec
    data = texts["s.fq"][:8_000_000]
    writer = {}
    for ext in ("", ".gz", ".zst", ".xz"):
        path = os.path.join(tmp, f"w.fq{ext}")
        t = time.perf_counter()
        w = get_writer(path, 2)
        for i in range(0, len(data), 1 << 20):
            w.write(data[i:i + (1 << 20)])
        w.finish()
        secs = time.perf_counter() - t
        with open_maybe_compressed(path) as f:
            if f.read() != data:
                raise AssertionError(f"phase 17: writer round trip {ext!r}")
        writer[ext or "plain"] = {"mb_per_s": round(len(data) / 1e6 / secs,
                                                    3),
                                  "bytes": os.path.getsize(path)}
        os.unlink(path)
    out["writer"] = writer
    # host extraction (the client's) against the NumPy oracle, ~1 Mbp
    seqs = s_reads[:6700]
    extraction = {}
    for k, w in ((K_, W_), (56, 9)):
        t = time.perf_counter()
        got = extract_filter_batch(seqs, 0, k, w)
        native_s = time.perf_counter() - t
        t = time.perf_counter()
        want = extract_filter_batch_plain(seqs, 0, k, w)
        plain_s = time.perf_counter() - t
        for g, p in zip(got, want):
            if not (np.array_equal(g[0], p[0]) and np.array_equal(g[1], p[1])
                    and g[2] == p[2]):
                raise AssertionError(f"phase 17: extraction at k={k} differs"
                                     " from the oracle")
        mbp = sum(map(len, seqs)) / 1e6
        extraction[f"k{k}"] = {"mbp": mbp,
                               "mbp_per_s": round(mbp / native_s, 3),
                               "plain_mbp_per_s": round(mbp / plain_s, 3)}
    out["extraction"] = extraction
    log("17 host I/O parity and rates", t0,
        **{n: json.dumps(v) for n, v in out.items()})
    return out


def _wall_ms(fn) -> float:
    t = time.perf_counter()
    fn()
    return (time.perf_counter() - t) * 1e3


def _oracle_hashes(args) -> np.ndarray:
    seq, k, w = args
    return dtt.compute_minimizer_hashes(seq, k, w)


def phase8_host_builds(fa: str, tmp: str, builds: dict, n_bp: int) -> dict:
    """Phase 8's host route (``index build --device host``, -t 8) at k=31
    and k=41, quiet (the accumulator writes the file) and reporting (the
    counting set's per-record totals), each index byte-identical to the
    card build's; no kernel launches. Returns seconds and Mbp/s."""
    out = {}
    for k in (K_, K_WIDE):
        want = read_bytes(builds[k]["path"])
        for quiet in (True, False):
            o = os.path.join(tmp, f"host{k}{'q' if quiet else 'r'}.idx")
            reset_launches()
            wall, err = cli_timed(["index", "build", fa, "-k", str(k),
                                   "-w", str(W_), "-o", o, "-t", "8",
                                   "--device", "host",
                                   *(["-q"] if quiet else [])])
            if any(launch_counts().values()):
                raise AssertionError(f"host index build launched "
                                     f"{launch_counts()}")
            if read_bytes(o) != want:
                raise AssertionError(f"index build -k {k} --device host "
                                     f"({'quiet' if quiet else 'reporting'})"
                                     " differs from the card build")
            totals = [ln for ln in err.splitlines()
                      if ln.startswith("  ") and "total minimizers" in ln]
            if not quiet and (len(totals) != SCALE_RECORDS or not totals[-1]
                              .endswith(f"total minimizers: "
                                        f"{builds[k]['keys']}")):
                raise AssertionError(f"host index build -k {k}: per-record "
                                     f"totals {totals[-2:]}")
            out[f"k{k} {'quiet' if quiet else 'reporting'}"] = {
                "s": round(wall, 3), "mbp_per_s": round(n_bp / 1e6 / wall,
                                                        3)}
            os.remove(o)
    return out


def phase8_index_scale(rng) -> dict:
    """index build on the card at k=31 (K1) and k=41 (K3) over a seeded
    104 Mbp FASTA, timed; then the host oracle in worker processes, record
    by record, both k interleaved, for at most ORACLE_SECONDS. Each card
    index must equal, byte for byte, the oracle's over the leading records
    the oracle finished at both k (the card rebuilds that prefix when it is
    not the whole FASTA)."""
    import multiprocessing as mp

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="deacon_torch_smoke_build_")
    pool = None
    try:
        recs = dirty_records(rng, SCALE_RECORDS, SCALE_RECORD_BP,
                             SCALE_RECORD_BP + 1)
        fa = os.path.join(tmp, "genome.fa")
        write_fasta(fa, recs)
        n_bp = sum(len(s) for _, s in recs)
        builds = {}
        for k in (K_, K_WIDE):
            out = os.path.join(tmp, f"card{k}.idx")
            reset_launches()
            t = time.perf_counter()
            cli_index_build(fa, out, k, W_, "cuda")
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            builds[k] = {"path": out, "s": round(sec, 3),
                         "mbp_per_s": round(n_bp / 1e6 / sec, 3),
                         "keys": load_header_and_count(out)[1],
                         "K1": K.select_compact.launches,
                         "K3": K.values_select.launches}
            if builds[k]["K3" if k > 32 else "K1"] <= 0:
                raise AssertionError(f"index build -k {k}: {builds[k]}")
        host_builds = phase8_host_builds(fa, tmp, builds, n_bp)
        t_or = time.perf_counter()
        deadline = t_or + ORACLE_SECONDS
        pool = mp.get_context("spawn").Pool(ORACLE_WORKERS)
        tasks = [(k, pool.apply_async(_oracle_hashes, ((seq, k, W_),)))
                 for _, seq in recs for k in (K_, K_WIDE)]
        done: dict[int, list] = {K_: [], K_WIDE: []}
        for k, task in tasks:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                done[k].append(task.get(timeout=left))
            except mp.TimeoutError:
                break
        pool.terminate()
        pool.join()
        pool = None
        oracle_s = time.perf_counter() - t_or
        n_rec = min(len(done[K_]), len(done[K_WIDE]))
        if n_rec == 0:
            raise AssertionError("the oracle finished no record in time")
        checked_bp = sum(len(s) for _, s in recs[:n_rec])
        if n_rec < len(recs):
            prefix = os.path.join(tmp, "prefix.fa")
            write_fasta(prefix, recs[:n_rec])
        for k in (K_, K_WIDE):
            card = builds[k].pop("path")
            if n_rec < len(recs):
                card = os.path.join(tmp, f"prefix{k}.idx")
                cli_index_build(prefix, card, k, W_, "cuda")
            oracle = os.path.join(tmp, f"oracle{k}.idx")
            dtt.write_index(np.unique(np.concatenate(done[k][:n_rec])),
                            dtt.IndexHeader.new(k, W_), oracle)
            if read_bytes(card) != read_bytes(oracle):
                raise AssertionError(
                    f"index build -k {k} on the card differs from the "
                    f"oracle's index over {n_rec} records")
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
        shutil.rmtree(tmp, ignore_errors=True)
    numbers = {"mbp": n_bp / 1e6, "records": len(recs),
               "builds": builds, "host_builds": host_builds,
               "cpu": host_cpu(), "oracle_s": round(oracle_s, 3),
               "oracle_records": n_rec, "oracle_checked_mbp": checked_bp / 1e6}
    log("8 index build at scale", t0, **{
        name: json.dumps(v) for name, v in numbers.items()})
    return numbers


# ---------------------------------------------------------------------------
# --sanitize: K1-K5 under compute-sanitizer, in a driver with no torch
# ---------------------------------------------------------------------------

SANITIZE_TOOLS = ("memcheck", "racecheck", "initcheck", "synccheck")
SANITIZE_LIMIT_S = 900
CHECK_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "deacon_tpu_torch", "csrc", "check",
                            "kernel_check.cu")
#: kernel ids of the driver's case file (csrc/check/kernel_check.cu)
CHECK_IDS = {"K1": 1, "K2": 2, "K3": 3, "K4": 4, "K5": 5}
PLAIN = {"K1": K.select_compact_plain, "K3": K.values_select_compact_plain,
         "K4": K.select_csum_slots_plain,
         "K5": K.values_argmin_slots_plain}


def write_cases(path: str, cases: list) -> None:
    """The driver's case file: (name, kernel, params, arrays) each."""
    import struct

    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x4B435844, 1, len(cases)))
        for name, kernel, params, arrays in cases:
            f.write(name.encode().ljust(32, b"\0")[:32])
            f.write(struct.pack("<i8qI", CHECK_IDS[kernel],
                                *(list(params) + [0] * (8 - len(params))),
                                len(arrays)))
            for a in arrays:
                b = b"" if a is None else np.ascontiguousarray(a).tobytes()
                f.write(struct.pack("<q", len(b)))
                f.write(b)


def select_cases(rng) -> list:
    """K1, K3, K4 and K5 at the three default tiles (k = 31 for K1, K4,
    K5; 41 for K3) and an edge tile each (13 rows, not a multiple of 8,
    L = 256 with Br = 128 so that low-complexity rows pass their budget,
    pc and pv 8 bytes past a 16-byte boundary; k = 41 for K3 and K5),
    seeded, with their plain versions' outputs."""
    cases = []
    for name in ("K1", "K3", "K4", "K5"):
        k = K_WIDE if name == "K3" else K_
        tiles = [(k, L, R, v4_row_budget(L, W_, default_budget_frac(W_)), 0)
                 for L, R in DevicePipeline.DEFAULT_TILES]
        tiles.append((K_WIDE if name in ("K3", "K5") else K_, 256, 13, 128,
                      8))
        for k, L, R, Br, misalign in tiles:
            arrs = pack_rows_packed(tile_rows(rng, L, R, k, W_), R, L, k,
                                    k + W_ - 1)[:4]
            dev = [torch.from_numpy(a).to("cuda") for a in arrs]
            out = PLAIN[name](*dev, k=k, w=W_, Br=Br)
            pos, tot = out[0], out[-1]
            lo, hi = out[1], out[2] if len(out) == 4 else None
            cases.append((f"{name} L={L} R={R} k={k}", name,
                          (R, L, k, W_, Br, misalign),
                          [*arrs, *(x.to(torch.int32).cpu().numpy()
                                    for x in (tot, pos)),
                           *(None if x is None else
                             x.to(torch.int64).cpu().numpy()
                             for x in (lo, hi))]))
    return cases


def probe_cases(rng) -> list:
    """K2 on a seeded 2**14-key table with 180 keys crafted into one
    bucket (a spill table), whole and as block 1 of 3 (its rows straddle
    row 2**(p-1) and hold the crafted bucket), the block also with the
    table and spill 8 bytes past a 16-byte boundary; the stream of 512
    reads of 128 slots, half members, the largest crafted key planted 8
    times in read 0; hits from probe_hits_plain."""
    from deacon_tpu_torch.ops.radix_probe import choose_p, shard_rows

    n = 1 << 14
    keys = rng.integers(I64_MIN, (1 << 63) - 1, n, dtype=np.int64)
    p = choose_p(n)
    r0, r1 = shard_rows(1, 3, p)
    bucket = (r0 + r1) // 2
    crafted = ((np.uint64(bucket) << np.uint64(64 - p))
               | rng.integers(0, 1 << (64 - p), 180, dtype=np.uint64)
               ).view(np.int64)
    every = torch.from_numpy(np.concatenate([keys, crafted]))
    whole = build_radix_table(every)
    block = build_radix_shards(every, 3, ["cpu"] * 3)[1]
    if whole.sp == 0 or block.p != p or block.row_lo != r0:
        raise AssertionError(f"--sanitize: K2 case table p={block.p}, "
                             f"sp={whole.sp}, row_lo={block.row_lo}")
    R, Br = 512, 128
    q = R * Br
    member = torch.from_numpy(keys[rng.integers(0, n, q)])
    other = torch.from_numpy(rng.integers(I64_MIN, (1 << 63) - 1, q,
                                          dtype=np.int64))
    hashes = torch.where(torch.from_numpy(rng.random(q) < 0.5), member,
                         other).reshape(R, Br)
    hashes[0, :8] = int(np.sort(crafted)[-1])
    valid = torch.from_numpy(rng.random((R, Br)) < 0.67)
    valid[0, :8] = True
    rid = torch.arange(R, dtype=torch.int32)[:, None].expand(R, Br)
    key, srid, first = prep_sorted(hashes, valid, rid)
    cases = []
    for name, t, misalign in (("K2 whole", whole, 0),
                              ("K2 block 1 of 3", block, 0),
                              ("K2 block, table+8", block, 8)):
        hits = K.probe_hits_plain(t.slots, t.spill, key, srid, first, p=t.p,
                                  sp=t.sp, num_segments=R, row_lo=t.row_lo)
        cases.append((name, "K2", (q, t.row_lo, t.slots.shape[0], t.p,
                                   t.sp, R, misalign),
                      [key.numpy(), srid.numpy(), first.numpy(),
                       t.slots.numpy(), t.spill.numpy() if t.sp else None,
                       hits.numpy()]))
    return cases


def compute_sanitizer() -> str:
    found = shutil.which("compute-sanitizer")
    cands = [found] if found else []
    cands.append("/usr/local/cuda/bin/compute-sanitizer")
    for c in cands:
        if os.path.isfile(c):
            return c
    raise AssertionError("--sanitize: compute-sanitizer not found")


def sanitize(rng) -> int:
    """``python3 chip_smoke.py --sanitize``: builds csrc/check/kernel_check.cu
    with nvcc for sm_90a into _build/kernel_check (linked to the kernel
    library), writes its seeded cases (select_cases, probe_cases) to a
    temporary file, runs it once plainly (every output must equal its
    plain version's) and then under compute-sanitizer with each of
    SANITIZE_TOOLS. Prints one JSON line per run and the summary as the
    last line. Exit code 0 when every tool ran the cases and reported no
    error; 1 when the plain run failed or a tool that ran the cases
    reported an error; 3 when a tool could not run them (it refused the
    device, or the driver's CUDA calls failed under it before any case):
    a fault of the tool, not of the kernels."""
    import re

    t0 = time.perf_counter()
    binary = os.path.join(str(_build.BUILD_DIR), "kernel_check")
    cmd = [_build._nvcc(), "-std=c++17", "-O2", "-gencode",
           "arch=compute_90a,code=sm_90a", CHECK_SOURCE, "-o", binary,
           "-L", str(_build.BUILD_DIR), "-ldeacon_kernels", "-Xlinker",
           "-rpath,$ORIGIN"]
    built = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if built.returncode != 0:
        raise AssertionError(f"--sanitize: nvcc failed: {built.stdout}"
                             f"{built.stderr}")
    nvcc_s = round(time.perf_counter() - t0, 3)
    tool = compute_sanitizer()
    version = subprocess.run([tool, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    tmp = tempfile.mkdtemp(prefix="deacon_torch_sanitize_")
    runs = {}
    try:
        cases = select_cases(rng) + probe_cases(rng)
        path = os.path.join(tmp, "cases.bin")
        write_cases(path, cases)
        for name, argv in (("plain", []), *(
                (t, [tool, "--tool", t, "--error-exitcode", "86"])
                for t in SANITIZE_TOOLS)):
            t = time.perf_counter()
            got = subprocess.run([*argv, binary, path], capture_output=True,
                                 text=True, timeout=SANITIZE_LIMIT_S)
            out = got.stdout + got.stderr
            summary = re.findall(r"ERROR SUMMARY: (\d+) error", out)
            hazards = re.findall(r"\((\d+) errors?, (\d+) warnings?\)", out)
            told = [ln.split("Error:", 1)[1].strip()
                    for ln in out.splitlines()
                    if ln.startswith("========= Error:")]
            run = {"rc": got.returncode, "s": round(time.perf_counter() - t, 3),
                   # the tool ran the cases: it took the device and the
                   # driver reported on at least one case
                   "started": "Device not supported" not in out and (
                       out.count(": ok (") + out.count(": FAILED (")) > 0,
                   "cases_ok": out.count(": ok ("),
                   "errors": (int(summary[-1]) if summary else
                              int(hazards[-1][0]) if hazards else None),
                   "tool_error": told[0] if told else None,
                   "tail": out.strip().splitlines()[-12:]}
            runs[name] = run
            print(f"[sanitize] {name}: {json.dumps(run)}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    plain = runs["plain"]
    tools = [runs[t] for t in SANITIZE_TOOLS]
    verdict = ("kernel fault" if plain["rc"] != 0
               or plain["cases_ok"] != len(cases)
               or any(r["started"] and (r["rc"] != 0 or r["errors"])
                      for r in tools)
               else "tool fault" if not all(r["started"] for r in tools)
               else "clean")
    print(json.dumps({"sanitize": verdict, "cases": len(cases),
                      "compute_sanitizer": version, "nvcc_s": nvcc_s,
                      "s": round(time.perf_counter() - t0, 3),
                      "runs": {n: {m: r[m] for m in (
                          "rc", "s", "started", "errors", "cases_ok",
                          "tool_error")}
                               for n, r in runs.items()}}), flush=True)
    return {"clean": 0, "kernel fault": 1, "tool fault": 3}[verdict]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log("0 device", t0, nvidia_smi=json.dumps(smi), torch_name=json.dumps(name),
        torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    gpp_s = host.build()
    host.library()
    log("0 host library", t0, gpp_s=gpp_s if gpp_s is not None else "cached",
        **{n: json.dumps(v) for n, v in host_toolchain().items()})
    t0 = time.perf_counter()
    secs = _build.build()
    _build.library()
    log("1 build", t0, nvcc_s=secs if secs is not None else "cached")
    if sys.argv[1:] == ["--k2"]:
        k2 = k2_alone(rng)
        sh = k2["sharded"]
        print(json.dumps({
            **{n: {m: k2[n][m] for m in ("ms", "cold_ms", "call_ms",
                                         "plain_ms", "bound_ms",
                                         "bound_scan_ms", "max_abs_err")}
               for n in ("phase4", "phase2")},
            **{n: sh[n] for n in ("unsharded_ms", "unsharded_cold_ms",
                                  "unsharded_call_ms", "fill_ms",
                                  "idle_launch_ms")},
            **{n: {m: sh[n][m] for m in ("ms", "cold_ms", "call_ms",
                                         "bound_ms", "bound_scan_ms",
                                         "max_abs_err",
                                         "ratio_to_unsharded")}
               for n in ("S4", "S3")},
            "repeat_heavy": k2["repeat_heavy"]}), flush=True)
        return 0
    if len(sys.argv) == 2 and sys.argv[1] in ROUTE_MODES:
        route, cases, dense = ROUTE_MODES[sys.argv[1]]
        t0 = time.perf_counter()
        out = route_alone(rng, route, cases, dense)
        log(f"{route} route alone", t0, tiles=json.dumps(out["tiles"]))
        print(json.dumps(out), flush=True)
        return 0
    if sys.argv[1:] == ["--pod4"]:
        print(json.dumps(pods_on_cards(rng)), flush=True)
        return 0
    if sys.argv[1:] == ["--sanitize"]:
        return sanitize(rng)
    if sys.argv[1:] == ["--k1"]:
        t0 = time.perf_counter()
        k1 = k1_tiles(rng)
        log("2 K1 alone", t0, k1=json.dumps(k1["tiles"]))
        print(json.dumps({n: k1[n] for n in ("ms", "call_ms", "plain_ms",
                                              "bound_ms", "max_abs_err")}),
              flush=True)
        return 0
    p2 = phase2(rng)
    k4 = phase9_k4(rng)
    k5 = phase10_k5(rng)
    launches3 = phase3(rng)
    p11 = phase11_switch_cli(rng)
    p14 = phase14_mesh_cli(rng)
    p4 = panhuman(rng, K_, "4", windows=(
        ("4a", {"DEACON_TPU_TILES": K4_TILES_ENV}, "K4"),
        ("4b", {"DEACON_PALLAS": "1"}, "K5"),
        ("4c", {}, "K1")), sharded=True, served=True)
    k3 = phase5_k3(rng)
    launches6 = phase6_wide_cli(rng)
    p7 = panhuman(rng, K_WIDE, "7", windows=(
        ("7b", {"DEACON_PALLAS": "1"}, "K5"),))
    phase8_index_scale(rng)
    k1, k2, k2s = p2["k1"], p4["k2"], p4["k2_sharded"]
    p15, p16 = p4["windows"]["15"], p4["windows"]["16"]
    p18 = p4["windows"]["18"]["runs"]
    pod_k2 = [x["launches"]["K2"] for x in p18["pod 2 ranks single"]["ranks"]]
    kernels = [
        {"name": "K1 select_compact", "route": "cuda",
         "source": "deacon_tpu_torch/csrc/extract.cu",
         "replaces": "deacon_tpu/ops/pallas_kernels.py:736",
         "launches": p4["launches"]["K1"],
         "index_diff_launches": p16["panhuman_k31"]["launches"]["K1"],
         "pod_launches": [x["launches"]["K1"] for x in
                          p18["pod 2 ranks single"]["ranks"]],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None,
         "call_ms": k1["call_ms"],
         "shapes": "sum over the three default tiles; ms by CUDA-graph "
                   "replay, call_ms around wrapper calls"},
        {"name": "K2 radix_probe", "route": "cuda",
         "source": "deacon_tpu_torch/csrc/radix_probe.cu",
         "replaces": "deacon_tpu/ops/radix_probe.py:973",
         "launches": p4["launches"]["K2"],
         "max_abs_err": max(k2["max_abs_err"], p2["k2"]["max_abs_err"]),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None, "call_ms": k2["call_ms"],
         "cold_ms": k2["cold_ms"], "bound_scan_ms": k2["bound_scan_ms"],
         "shapes": "one (256, 8192) batch stream, panhuman table; ms by "
                   "CUDA-graph replay, call_ms around wrapper calls"},
        {"name": "K3 values_select", "route": "cuda",
         "source": "deacon_tpu_torch/csrc/values_select.cu",
         "replaces": "deacon_tpu/ops/pallas_kernels.py:312",
         "launches": p7["launches"]["K3"],
         "index_diff_launches": p16["k41_K3"]["launches"]["K3"],
         "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None,
         "call_ms": k3["call_ms"], "bound_dense_ms": k3["bound_dense_ms"],
         "shapes": "sum over the three default tiles at k=41, w=15; ms by "
                   "CUDA-graph replay, call_ms around wrapper calls; "
                   "bound_dense_ms: the dense planes' bound"},
        {"name": "K4 select_csum", "route": "cuda",
         "source": "deacon_tpu_torch/csrc/select_csum.cu",
         "replaces": "deacon_tpu/ops/pallas_kernels.py:494",
         "launches": p4["windows"]["4a"]["timed_window_launches"]["K4"],
         "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None,
         "call_ms": k4["call_ms"], "bound_dense_ms": k4["bound_dense_ms"],
         "shapes": f"sum over the tiles {K4_TILES_ENV} at k=31, w=15; ms "
                   "by CUDA-graph replay, call_ms around wrapper calls; "
                   "bound_dense_ms: the dense plane's bound"},
        {"name": "K5 values_argmin", "route": "cuda",
         "source": "deacon_tpu_torch/csrc/values_argmin.cu",
         "replaces": "deacon_tpu/ops/pallas_kernels.py:793",
         "launches": p4["windows"]["4b"]["timed_window_launches"]["K5"],
         "index_diff_launches": p16["k41_K5"]["launches"]["K5"]
         + p16["k31_K5"]["launches"]["K5"],
         "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
         "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
         "bound_by": k5["bound_by"], "library_ms": None,
         "call_ms": k5["call_ms"], "bound_dense_ms": k5["bound_dense_ms"],
         "k41": {n: k5["k41_" + n] for n in ("ms", "call_ms", "plain_ms",
                                              "bound_ms", "bound_by",
                                              "bound_dense_ms")},
         "shapes": "sum over the three default tiles at k=31, w=15 (k41: "
                   "at k=41); ms by CUDA-graph replay, call_ms around "
                   "wrapper calls; bound_dense_ms: the dense planes' "
                   "bound"},
        {"name": "K2 radix_probe, sharded form", "route": "cuda",
         "source": "deacon_tpu_torch/csrc/radix_probe.cu",
         "replaces": "deacon_tpu/ops/radix_probe.py:973",
         "launches": p4["windows"]["4d"]["timed_window_launches"]["K2"],
         "pod_launches": pod_k2,
         "pod_2d_launches": [x["launches"]["K2"] for x in
                             p18["pod-2d 4 ranks single"]["ranks"]],
         "max_abs_err": max(k2s["S4"]["max_abs_err"],
                            k2s["S3"]["max_abs_err"]),
         "ms": k2s["S4"]["ms"], "plain_ms": k2s["S4"]["plain_ms"],
         "bound_ms": k2s["S4"]["bound_ms"], "bound_by": k2s["S4"]["bound_by"],
         "library_ms": None, "call_ms": k2s["S4"]["call_ms"],
         "cold_ms": k2s["S4"]["cold_ms"],
         "bound_scan_ms": k2s["S4"]["bound_scan_ms"],
         "shapes": "S=4 row ranges (the 4 launches together), panhuman "
                   "table, one (256, 8192) batch stream; S=3 beside it; "
                   "ms by CUDA-graph replay, call_ms around wrapper calls",
         "S3": {n: k2s["S3"][n] for n in ("ms", "cold_ms", "call_ms",
                                           "plain_ms", "bound_ms",
                                           "bound_by", "bound_scan_ms",
                                           "max_abs_err")},
         "unsharded_ms": k2s["unsharded_ms"],
         "unsharded_cold_ms": k2s["unsharded_cold_ms"],
         "ratio_to_unsharded": k2s["S4"]["ratio_to_unsharded"]},
    ]
    if min(k["launches"] for k in kernels) <= 0 or min(
            k.get("index_diff_launches", 1) for k in kernels) <= 0 or min(
            min(k.get("pod_launches", [1])) for k in kernels) <= 0:
        raise AssertionError("a kernel of the main path was never launched")
    launches14 = {n: v for n, v in p14.items() if n.endswith("launches")}
    launches16 = {n: v["launches"] for n, v in p16.items() if "launches" in v}
    launches18 = {n: [x["launches"] for x in v["ranks"]]
                  for n, v in p18.items() if "ranks" in v}
    launches20 = {n: v["launches"]
                  for n, v in p4["windows"]["20"]["runs"].items()}
    print(f"[total] {time.perf_counter() - t_all:.3f} s "
          f"phase3_launches={json.dumps(launches3)} "
          f"phase6_launches={json.dumps(launches6)} "
          f"phase11_launches={json.dumps(p11['filter'])} "
          f"phase14_launches={json.dumps(launches14)} "
          f"phase15_launches={json.dumps(p15['launches'])} "
          f"phase16_launches={json.dumps(launches16)} "
          f"phase18_launches={json.dumps(launches18)} "
          f"phase20_launches={json.dumps(launches20)} "
          f"window_7b_launches="
          f"{json.dumps(p7['windows']['7b']['timed_window_launches'])}",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print("kernels: K1 select_compact, K2 radix_probe (whole table, and "
          "its sharded form as a sixth entry), K3 values_select, "
          "K4 select_csum, K5 values_argmin", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
