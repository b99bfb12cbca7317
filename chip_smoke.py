#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deacon_tpu_torch) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
ending in torch.cuda.synchronize() and one flushed line with its seconds:

0. device: the card's name and power limit (nvidia-smi);
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
   oracle (six worker processes) finishes within its time limit;
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
4d: phase 4's reads through ShardedDecider on make_mesh(2, 4,
   ["cuda:0"] * 8) (two data rows, four table shards on the one card):
   every unit equal to phase 4's reference, K2 launched 4 times per
   batch, with Mbp/s, busy share, reruns, launches, the shard build's
   seconds and GB and the peak memory.

Phases run in the order 0, 1, 2, 9, 10, 3, 11, 12, 14, 4, 4a, 4b, 4c, 13,
4d, 5, 6, 7, 7b, 8. Each switch is set in os.environ only around its
phase.

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
kernel (or route) by the same measures.

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
from deacon_tpu_torch.filter.engine import DeviceDecider, ShardedDecider
from deacon_tpu_torch.index.store import load_header_and_count
from deacon_tpu_torch.io import zstd
from deacon_tpu_torch.io.fastx import open_maybe_compressed
from deacon_tpu_torch.ops import _build
from deacon_tpu_torch.ops import kernels as K
from deacon_tpu_torch.ops.engine import DevicePipeline, select_slots
from deacon_tpu_torch.ops.hash import lsr, xxh3_64
from deacon_tpu_torch.ops.minimizers_np import get_minimizer_hashes_and_positions
from deacon_tpu_torch.ops.pack import (
    _Row,
    default_budget_frac,
    pack_rows_packed,
    v4_row_budget,
)
from deacon_tpu_torch.ops.radix_probe import (
    build_radix_shards,
    build_radix_table,
    prep_sorted,
    sorted_unique_keys,
)
from deacon_tpu_torch.parallel.sharded import make_mesh
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
    """Launch every batch as the filter engine does, resolve in order."""
    futs = []
    for i in range(0, len(single), batch):
        futs.append(("s", decider.launch_unpaired(single[i:i + batch], 0,
                                                  _Cfg)))
    for i in range(0, len(ont), 500):
        futs.append(("s", decider.launch_unpaired(ont[i:i + 500], 0, _Cfg)))
    for i in range(0, len(pairs), batch):
        futs.append(("p", decider.launch_paired(pairs[i:i + batch], 0, _Cfg)))
    out = [f() for _, f in futs]
    return [d for batch_out in out for d in batch_out]


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
        decider = DeviceDecider(table, k, W_, "cuda")
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
    distinct and sorted. Returns (genome, keys, seconds to make them)."""
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
    return genome, keys_u, time.perf_counter() - t_keys


def panhuman(rng, k: int, phase: str, windows=(), sharded: bool = False):
    """Phase 4 (k=31) or 7 (k=41): a panhuman-scale table and ~20 Mbp of
    reads through DeviceDecider, every unit against the reference; then
    the same reads under each of ``windows`` ((label, switches, kernel)),
    and with ``sharded`` phase 13 (K2's sharded form on the table and the
    main-path stream) and window 4d (the reads through ShardedDecider on
    a 2x4 mesh of the card), before the table is freed."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    genome, keys_u, keys_s = panhuman_keys(rng, k, phase)
    dev = keys_u.device
    t_tab = time.perf_counter()
    decider = DeviceDecider(keys_u, k, W_, "cuda")
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t_tab
    table = decider.pipe.table
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
    """Window 4d: phase 4's reads through ShardedDecider on a 2x4 mesh of
    the one card ([cuda:0] * 8: eight mesh positions, four table shards
    shared by the two data rows): every unit equal to the reference, K2
    launched 4 times per batch (K1 once), Mbp/s, busy share, reruns,
    launches, the shard build's seconds and GB and the peak memory."""
    t0 = time.perf_counter()
    single, pairs, ont = reads
    torch.cuda.reset_peak_memory_stats()
    t_b = time.perf_counter()
    decider = ShardedDecider(keys_u, k, W_,
                             make_mesh(2, 4, [keys_u.device] * 8))
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
    genome, keys_u, _ = panhuman_keys(rng, K_, "4")
    decider = DeviceDecider(keys_u, K_, W_, "cuda")
    table = decider.pipe.table
    single, _, _ = make_reads(rng, genome)
    stream = main_path_stream(decider.pipe, single[:8192])
    out = {"phase4": measure_k2(table, *stream),
           "sharded": phase13_k2_sharded(keys_u, table, stream),
           "repeat_heavy": repeat_heavy(table, keys_u)}
    del decider, table, stream, keys_u
    torch.cuda.empty_cache()
    out["phase2"] = measure_k2(*dense_k2_stream())
    log("2-13 K2 alone", t0, **{n: json.dumps(v) for n, v in out.items()})
    return out


# ---------------------------------------------------------------------------
# phase 8: index build at scale, against the oracle
# ---------------------------------------------------------------------------

SCALE_RECORDS, SCALE_RECORD_BP = 26, 4_000_000  # 104 Mbp
ORACLE_WORKERS, ORACLE_SECONDS = 6, 120


def _oracle_hashes(args) -> np.ndarray:
    seq, k, w = args
    return dtt.compute_minimizer_hashes(seq, k, w)


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
               "builds": builds, "oracle_s": round(oracle_s, 3),
               "oracle_records": n_rec, "oracle_checked_mbp": checked_bp / 1e6}
    log("8 index build at scale", t0, **{
        name: json.dumps(v) for name, v in numbers.items()})
    return numbers


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
        ("4c", {}, "K1")), sharded=True)
    k3 = phase5_k3(rng)
    launches6 = phase6_wide_cli(rng)
    p7 = panhuman(rng, K_WIDE, "7", windows=(
        ("7b", {"DEACON_PALLAS": "1"}, "K5"),))
    phase8_index_scale(rng)
    k1, k2, k2s = p2["k1"], p4["k2"], p4["k2_sharded"]
    kernels = [
        {"name": "K1 select_compact", "route": "cuda",
         "source": "deacon_tpu_torch/csrc/extract.cu",
         "replaces": "deacon_tpu/ops/pallas_kernels.py:736",
         "launches": p4["launches"]["K1"],
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
    if min(k["launches"] for k in kernels) <= 0:
        raise AssertionError("a kernel of the main path was never launched")
    launches14 = {n: v for n, v in p14.items() if n.endswith("launches")}
    print(f"[total] {time.perf_counter() - t_all:.3f} s "
          f"phase3_launches={json.dumps(launches3)} "
          f"phase6_launches={json.dumps(launches6)} "
          f"phase11_launches={json.dumps(p11['filter'])} "
          f"phase14_launches={json.dumps(launches14)} "
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
