"""Device engine: batched minimizer extraction, membership and counting,
and the index-build extraction.

One engine step per batch of rows of a tile (L, R), all on the device:

1. selection into an (R, Br) slot grid (select_slots), by the tile's
   route (tile_route, decided once per tile class as the JAX package's
   engine_arch decides it, with its switches DEACON_ENGINE and
   DEACON_PALLAS):
   * "K1" (arch 4: k <= 32, R % 8 == 0, L a power of two): K1
     (ops/kernels.select_compact, csrc/extract.cu) computes canonical
     values, selection keys, window minima, validity and the per-row
     compaction in one kernel;
   * "K4" (arch 3: L a multiple of 128 but not a power of two, or
     DEACON_ENGINE=3): K4 (ops/kernels.select_csum,
     csrc/select_csum.cu) does K1's work, with K1's device code, in one
     kernel;
   * "K3" (arch 2: k > 32, R % 8 != 0 or DEACON_ENGINE=2): K3
     (ops/kernels.values_select, csrc/values_select.cu) does K1's work
     for k <= 57, with 128-bit values above k = 32, in one kernel;
   * "K5" (DEACON_PALLAS=1, k <= 56, on any tile): K5
     (ops/kernels.values_argmin, csrc/values_argmin.cu) does K3's work,
     with K3's device code, in one kernel;
   every route's kernel writes the slot grid itself (csrc/select_rows.cuh,
   shared by the four); no torch compaction follows it;
2. XXH3-64 of every slot's value, 8 or 16 bytes (ops/hash.py);
3. the probe stream sorted by (hash, read) and K2
   (ops/kernels.probe_hits, csrc/radix_probe.cu) against the blocks of
   the batch's data row: the whole radix table on one card, or the
   shards of one over a mesh, each probed on its device and the hits
   summed: distinct member hashes per read unit;
4. per-unit totals from the slot grid (ops/radix_probe.totals_grid);
5. one fused int32 output: hits, totals, then ``used`` (the largest row
   total, for the host's budget check).

DevicePipeline runs these steps on one card, or over a (data x shard)
mesh (parallel/sharded.py): batches round-robin over the mesh's data
rows, the radix table cut into blocks of bucket rows over its shards,
and, for a mesh whose shards span processes, each batch's hits summed
over them. Batches launch on the current stream without synchronising;
a FetchGroup brings the outputs of every pending batch back in one
device-to-host copy.
A batch whose ``used`` exceeds its slot budget is finished on the device
too: the units owning the rows over budget run once more with a budget
that holds every row's minimizers (DevicePipeline._rerun_over_budget).

Index build (IndexBuildPipeline) runs steps 1-2 on IUPAC-canonicalised
codes, drops k-mers below the entropy threshold (entropy_keep) and hands
every sequence's hashes to the caller; rows over budget rerun on the
device as well. ``index diff`` against a FASTX stream takes the same
extraction and clears the first index's keys it hits (KeptKeys).

DeviceHashProbe holds an index's sorted keys on the device for the
server: each request's pre-hashed minimizers are one searchsorted probe.
ShardedHashProbe holds one value range of them on each shard of a mesh
(``server --mesh DATAxSHARD``); probe_rows searches a query over such a
layout, one part a data row, every part launched before any is
collected (it also serves the pod server's rows, server/app.PodProbe).
"""

from __future__ import annotations

import os
import time
from contextlib import nullcontext
from dataclasses import replace

import numpy as np
import torch

from ..constants import MAX_K_BUILD, MAX_K_FILTER
from ..device import resolve_device
from ..utils import trace
from . import minimizers_np as mnp
from .hash import as_i64, lsr, xxh3_64, xxh3_64_u128
from .kernels import (
    probe_hits,
    select_compact,
    select_csum,
    values_argmin,
    values_select,
)
from .pack import (  # noqa: F401 (_Row, pack_rows_packed: the module's API)
    INDEX_CODE,
    RowBlock,
    _Row,
    chunk_spans,
    default_budget_frac,
    effective_lengths,
    join_seqs,
    pack_block,
    pack_rows_packed,
    v4_row_budget,
)
from .radix_probe import (
    RadixTable,
    build_radix_blocks_from_file,
    build_radix_shards,
    radix_probe_hits,
    sort_runs,
    totals_grid,
)


# ---------------------------------------------------------------------------
# The engine's switches, read as the JAX package reads them
# ---------------------------------------------------------------------------

#: the longest tile row any kernel takes: wp and K4's cumsum fit 16 bits
MAX_TILE_L = 16384


def v3_eligible(k: int, L: int, R: int) -> bool:
    """The JAX package's _v3_eligible (deacon_tpu/ops/engine.py): the tile
    shapes its packed-input kernels take, unless DEACON_ENGINE=2."""
    if os.environ.get("DEACON_ENGINE", "") == "2":
        return False
    return k <= 32 and R % 8 == 0 and L % 128 == 0 and L <= MAX_TILE_L


def engine_arch(k: int, L: int, R: int) -> int:
    """The JAX package's engine_arch: 4 for an eligible tile with a
    power-of-two L, 3 for any other eligible tile or under DEACON_ENGINE=3,
    2 when not eligible or under DEACON_ENGINE=2."""
    if not v3_eligible(k, L, R):
        return 2
    if os.environ.get("DEACON_ENGINE", "") == "3":
        return 3
    if L >= 128 and (L & (L - 1)) == 0:
        return 4
    return 3


def tile_route(k: int, L: int, R: int, *, index_build: bool = False) -> str:
    """The selection kernel of a tile class (see select_slots): "K5" under
    DEACON_PALLAS=1 (the JAX package's forced v1 kernel, k <= 56; any
    other value selects the default kernels), else "K1", "K4" or "K3" for
    arch 4, 3 or 2. The index build has no arch 3 (the JAX package's
    non-v4 build runs its K3 stages), so it takes "K3" there."""
    if os.environ.get("DEACON_PALLAS", "") == "1" and k <= 56:
        return "K5"
    arch = engine_arch(k, L, R)
    if arch == 4:
        return "K1"
    return "K4" if arch == 3 and not index_build else "K3"


def tile_classes(tiles, *, k: int, l: int, rows: int,
                 index_build: bool = False):
    """The (L, R) tile classes whose rows hold a window of l bases (one of
    L = l rounded up to 128 and ``rows`` rows if none does), and the route
    of each row length (tile_route; a row length's first class is the one
    a pipeline picks). Raises ValueError for a row length no kernel takes:
    not a multiple of 128, or above MAX_TILE_L."""
    tiles = [(int(L), int(R)) for L, R in tiles]
    for L, R in tiles:
        if L % 128 or not 0 < L <= MAX_TILE_L or R < 1:
            raise ValueError(
                f"tile ({L}, {R}): the row length L must be a multiple of "
                f"128 and at most {MAX_TILE_L}, with R >= 1 rows"
            )
    tiles = [(L, R) for L, R in tiles if L >= l] or [
        (-(-l // 128) * 128, rows)]
    routes: dict[int, str] = {}
    for L, R in tiles:
        routes.setdefault(L, tile_route(k, L, R, index_build=index_build))
    return tiles, routes


def env_tiles():
    """DEACON_TPU_TILES ("L:R,L:R,...") as (L, R) pairs, or None."""
    env = os.environ.get("DEACON_TPU_TILES")
    if not env:
        return None
    try:
        return [tuple(int(x) for x in part.split(":"))
                for part in env.split(",")]
    except ValueError:
        raise ValueError(
            f"DEACON_TPU_TILES={env!r}: expected L:R,L:R,..."
        ) from None


# ---------------------------------------------------------------------------
# One engine step
# ---------------------------------------------------------------------------

def select_slots(pc, pv, mlen, allow_short, *, k: int, w: int, Br: int,
                 route: str):
    """Selected minimizers of every row, compacted in column order into an
    (R, Br) slot grid by the tile's route (tile_route): ((R, Br) int32
    positions, value planes ([lo] for k <= 32, [lo, hi] for the u128
    values of k > 32), (R,) int32 row totals)."""
    if route == "K1":
        pos, val, tot = select_compact(pc, pv, mlen, allow_short, k=k, w=w,
                                       Br=Br)
        return pos, [val], tot
    if route == "K4":
        pos, val, tot = select_csum(pc, pv, mlen, allow_short, k=k, w=w,
                                    Br=Br)
        return pos, [val], tot
    select = values_argmin if route == "K5" else values_select
    pos, lo, hi, tot = select(pc, pv, mlen, allow_short, k=k, w=w, Br=Br)
    return pos, [lo] if hi is None else [lo, hi], tot


def hash_planes(planes: list[torch.Tensor]) -> torch.Tensor:
    """XXH3-64 of slot values: 8 bytes for [lo], 16 for [lo, hi]."""
    if len(planes) == 1:
        return xxh3_64(planes[0])
    return xxh3_64_u128(planes[0], planes[1])


def engine_step(pc, pv, mlen, allow_short, rid, mate, cstart, tables, *,
                k: int, w: int, budget: int, num_segments: int,
                dedup_positions: bool, route: str):
    """One batch -> (fused (2 * num_segments + 1,) int32: hits per unit,
    totals per unit, then the largest row total; (R,) int32 row totals).
    ``tables`` is what the probe reads: [a RadixTable], or the shards of
    one (radix_probe_hits). Units with a row total above ``budget`` have
    truncated counts."""
    R, Lp = pc.shape
    L = Lp * 4
    with trace.span("step.select"):
        pos_c, planes, rt = select_slots(pc, pv, mlen, allow_short, k=k,
                                         w=w, Br=budget, route=route)
    lane = torch.arange(budget, dtype=torch.int32, device=pc.device)
    valid2d = lane[None, :] < torch.clamp(rt, max=budget)[:, None]
    with trace.span("step.hash"):
        hashes = hash_planes(planes)
    del planes
    hits = radix_probe_hits(
        tables, hashes, valid2d, rid[:, None].expand(R, budget),
        num_segments=num_segments,
    )
    l = k + w - 1
    with trace.span("step.totals"):
        totals = totals_grid(
            pos_c, valid2d, rid, mate, cstart, num_segments=num_segments,
            k=k, l=l, stride=max(1, L - l + 1),
            dedup_positions=dedup_positions,
        )
    return torch.cat([hits, totals, rt.max().reshape(1)]).to(torch.int32), rt


def upload(arrays: list[np.ndarray], device: torch.device) -> list[torch.Tensor]:
    """Host arrays -> device tensors in one copy: the arrays are laid out
    in one pinned buffer that goes over with a non-blocking copy."""
    if device.type == "cpu":
        return [torch.from_numpy(a) for a in arrays]
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // 8) * 8
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    host = buf.numpy()
    for a, o in zip(arrays, offs):
        host[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8
        )
    dev = buf.to(device, non_blocking=True)
    dtypes = {np.dtype(np.uint8): torch.uint8,
              np.dtype(np.bool_): torch.bool,
              np.dtype(np.int32): torch.int32}
    return [
        dev[o:o + a.nbytes].view(dtypes[a.dtype]).reshape(a.shape)
        for a, o in zip(arrays, offs)
    ]


def tile_index(tiles, lengths: np.ndarray) -> np.ndarray:
    """Index of the first tile class, in the order given, whose rows hold
    each length; the last class for longer ones."""
    fits = np.asarray(lengths)[:, None] <= np.array([L for L, _ in tiles])
    return np.where(fits.any(axis=1), fits.argmax(axis=1), len(tiles) - 1)


class FetchGroup:
    """Cross-batch device-to-host fetch: outputs of every batch launched
    since the last fetch are concatenated on the device and copied back
    in one transfer, then handed out per ticket."""

    def __init__(self):
        self._pending: list[tuple[int, list[torch.Tensor]]] = []
        self._done: dict[int, list[np.ndarray]] = {}
        self._next = 0

    def register(self, tensors: list[torch.Tensor]) -> int:
        t = self._next
        self._next += 1
        self._pending.append((t, list(tensors)))
        return t

    def materialize(self, ticket: int) -> list[np.ndarray]:
        got = self._done.pop(ticket, None)
        if got is not None:
            return got
        pending, self._pending = self._pending, []
        flat = [x for _, xs in pending for x in xs]
        if flat:
            with trace.span("resolve.fetch"):
                fused = torch.cat(flat).cpu().numpy()
            trace.count("fetch.copies")
            trace.count("fetch.bytes", fused.nbytes)
        else:
            fused = np.zeros(0, np.int32)
        off = 0
        for t, xs in pending:
            outs = []
            for x in xs:
                outs.append(fused[off:off + x.numel()])
                off += x.numel()
            self._done[t] = outs
        return self._done.pop(ticket)


class DevicePipeline:
    """Fused extract+probe+count pipeline over device-resident radix
    blocks, on one card or over a (data x shard) mesh.

    Read units (a read, or a pair) go to the smallest tile class (L, R)
    whose rows hold their chunks, and all rows of a unit stay in one
    batch so distinct-hit counting is exact: a unit needing more than R
    rows gets a batch of its own. A row selecting more than its budget of
    minimizers has its unit rerun on the device at resolve;
    ``rerun_batches`` and ``rerun_units`` count those reruns.

    ``index`` is the index's u64 hashes (a NumPy array or an int64
    tensor), a RadixTable on the first device, which the pipeline shares
    (a mesh of one shard only), or the path of an index file, whose blocks are
    built from the keys of their own rows (build_radix_blocks_from_file),
    so that no host holds the whole index.

    ``blocks[d][j]`` is the block of shard column j on the device of data
    row d; positions on one device share one block. With ``mesh`` None
    the pipeline runs on ``device`` alone, the 1x1 grid ``[[table]]``.
    With a mesh (parallel/sharded.Mesh, or multihost.PodMesh) batches go
    round robin over its data rows, the table is cut into its
    ``shape["shard"]`` blocks of bucket rows, of which this process
    builds and probes those of ``mesh.shards``, and the outputs come back
    to the mesh's first device, where the fetch group gathers them.

    ``tiles`` defaults to DEACON_TPU_TILES, then DEFAULT_TILES. Each tile
    class's selection kernel (``routes``, by row length) is decided once
    here from (k, L, R) and the switches (tile_route): a batch packs only
    the rows it has, so its row count never decides the route. The probe
    is K2 on every route."""

    #: (row_len, rows_per_batch) tile classes, ascending; last holds chunks
    DEFAULT_TILES = ((256, 8192), (2048, 2048), (16384, 512))
    #: batches in flight before the filter engine resolves the oldest
    RESOLVE_DEPTH = 64

    def __init__(self, index, k: int, w: int, tiles=None, device=None,
                 mesh=None):
        self.mesh = mesh
        if mesh is None:
            grid, shards, n_shard, agree = (
                ((resolve_device(device),),), (0,), 1, None)
        else:
            grid, shards, n_shard, agree = (
                mesh.devices, mesh.shards, mesh.shape["shard"],
                mesh.agree_max)
        self.device = grid[0][0]
        if not 1 <= k <= MAX_K_FILTER:
            raise ValueError(
                "Indexing the bitmask of invalid characters requires "
                f"k<={MAX_K_FILTER}, but it is {k}"
            )
        self.k, self.w = int(k), int(w)
        self.l = self.k + self.w - 1
        self.budget_frac = default_budget_frac(self.w)
        self.tiles, self.routes = tile_classes(
            tiles or env_tiles() or self.DEFAULT_TILES, k=self.k, l=self.l,
            rows=4096)
        self.L_max = self.tiles[-1][0]
        self._stride = self.L_max - self.l + 1
        self.fetch_group = FetchGroup()
        self.rerun_batches = 0
        self.rerun_units = 0
        self.n_data = len(grid)
        self._row_devices = [row[0] for row in grid]
        self._turn = 0
        if isinstance(index, RadixTable):
            if index.slots.device != self.device:
                raise ValueError("the radix table is not on this device")
            first = [index]  # shared, not copied
        elif isinstance(index, (str, os.PathLike)):
            built = build_radix_blocks_from_file(
                index, n_shard, dict(zip(shards, grid[0])), agree)
            first = [built[j] for j in shards]
        else:
            first = build_radix_shards(index, n_shard, grid[0])
        # first[c] is on grid[0][c]; every other device of column c gets
        # one copy of it
        held = {(dev, c): first[c] for c, dev in enumerate(grid[0])}
        for row in grid:
            for c, dev in enumerate(row):
                if (dev, c) not in held:
                    held[(dev, c)] = _copy_to(first[c], dev)
        self.blocks = [[held[(dev, c)] for c, dev in enumerate(row)]
                       for row in grid]

    def describe(self) -> str:
        """The filter's ``Engine:`` line for this pipeline."""
        if self.mesh is None:
            return f"device pipeline ({self.device})"
        return f"sharded device pipeline ({self.mesh.describe()})"

    def launch_counts(self, arena: np.ndarray, start: np.ndarray,
                      length: np.ndarray, unit: np.ndarray,
                      mate: np.ndarray, n_logical: int,
                      prefix_length: int):
        """Launch device batches for sequences ``arena[start[i]:start[i] +
        length[i]]``, mate ``mate[i]`` of read unit ``unit[i]`` (units
        ascending, a unit's mates adjacent); returns a resolve() ->
        (hits, totals) closure over the ``n_logical`` units. Device work
        stays in flight until then.

        Each unit goes to the smallest tile class whose rows hold its
        longest row; tile classes launch in order of their first unit,
        and a tile's units fill batches in order, a batch taking units
        while their rows fit in R (a unit of more than R rows gets a
        batch of its own)."""
        with trace.span("launch.counts"):
            eff = effective_lengths(arena, start, length, prefix_length,
                                    self.k)
            seq, rstart, rlen, cstart = chunk_spans(
                start, eff, k=self.k, l=self.l, stride=self._stride,
                max_len=self.L_max)
            rows = RowBlock(arena, rstart, rlen, unit[seq], mate[seq],
                            cstart)
            in_flight: list[tuple] = []
            if len(rows):
                # per unit with rows: its tile class and its row count
                units, first_row, n_rows = np.unique(
                    rows.rid, return_index=True, return_counts=True)
                tile = tile_index(self.tiles,
                                  np.maximum.reduceat(rows.length, first_row))
                tile_of_row = np.repeat(tile, n_rows)
                _, tile_first = np.unique(tile, return_index=True)
                for t in tile[np.sort(tile_first)].tolist():
                    L, R = self.tiles[t]
                    t_units = np.nonzero(tile == t)[0]
                    t_rows = rows.take(tile_of_row == t)
                    cum = np.cumsum(n_rows[t_units])
                    a = 0
                    while a < t_units.size:
                        before = cum[a - 1] if a else 0
                        b = max(a + 1, int(np.searchsorted(cum, before + R,
                                                           side="right")))
                        r0, r1 = int(before), int(cum[b - 1])
                        batch = t_rows.take(slice(r0, r1))
                        gids = units[t_units[a:b]]
                        batch.rid = np.searchsorted(gids, batch.rid)
                        budget = v4_row_budget(L, self.w, self.budget_frac)
                        out, rt = self._launch_batch(batch, L, gids.size,
                                                     budget)
                        in_flight.append((gids, batch, L, budget, out, rt))
                        a = b

            ticket = self.fetch_group.register([f[4] for f in in_flight])

            def resolve():
                """(hits, totals) of the launch. On a mesh whose shards
                span processes (a PodMesh), every process of the shard
                group must resolve the same launches in the same order:
                each resolve makes exactly one all-reduce of the hits
                (sum_over_shards), after any rerun of rows over their
                budget, which is decided from row totals that are the
                same in every process (the slot grid does not depend on
                the shard), never from a process's own hits."""
                hits = np.zeros(n_logical, dtype=np.int64)
                totals = np.zeros(n_logical, dtype=np.int64)
                fetched = self.fetch_group.materialize(ticket)
                for (gids, rows, L, budget, _out, rt), arr in zip(
                        in_flight, fetched):
                    n = gids.size
                    h, t = arr[:n], arr[n:2 * n]
                    if int(arr[2 * n]) > budget:
                        h, t = self._rerun_over_budget(rows, rt, L, budget,
                                                       h, t)
                    hits[gids] += h
                    totals[gids] += t
                if self.mesh is not None:
                    hits = self.mesh.sum_over_shards(hits)
                return hits, totals

            return resolve

    def _rerun_over_budget(self, rows: RowBlock, rt, L, budget, hits,
                           totals):
        """Exact (hits, totals) of a batch with rows over budget: the units
        owning those rows run again on the device, with the budget rounded
        up to their largest row total (at most L, so every slot fits)."""
        with trace.span("resolve.rerun"):
            row_tot = rt.cpu().numpy()
            rid = rows.rid
            over = np.unique(rid[row_tot > budget])
            local = np.full(len(hits), -1, np.int64)
            local[over] = np.arange(over.size)
            mine = local[rid] >= 0
            sel = rows.take(mine)
            sel.rid = local[sel.rid]
            need = int(row_tot[mine].max())
            out, _ = self._launch_batch(sel, L, over.size,
                                        min(L, -(-need // 128) * 128))
            arr = out.cpu().numpy()
            trace.count("fetch.copies", 2)
            trace.count("fetch.bytes", row_tot.nbytes + arr.nbytes)
            hits, totals = hits.copy(), totals.copy()
            hits[over] = arr[:over.size]
            totals[over] = arr[over.size:2 * over.size]
            self.rerun_batches += 1
            self.rerun_units += int(over.size)
            return hits, totals

    def _launch_batch(self, rows: RowBlock, L: int, n_units: int,
                      budget: int):
        """Pack and launch one batch on the next data row in turn; returns
        (fused output on the first device, row totals)."""
        d = self._turn % self.n_data
        self._turn += 1
        out, rt = self._step(rows, L, n_units, budget, self._row_devices[d],
                             self.blocks[d])
        return out.to(self.device, non_blocking=True), rt

    def _step(self, rows: RowBlock, L: int, n_units: int, budget: int,
              device: torch.device, tables):
        """engine_step of one batch on ``device`` against ``tables``."""
        with trace.span("launch.pack"):
            packed = list(pack_block(rows, len(rows), L, self.k, self.l))
        with trace.span("launch.upload"):
            pc, pv, mlen, allow_short, rid, mate, cstart = upload(packed,
                                                                  device)
        if trace.enabled():
            trace.count("launch.device_batches")
            trace.count("launch.rows", len(rows))
            trace.count("launch.row_bases", int(rows.length.sum()))
            trace.count("launch.tile_bases", len(rows) * L)
            trace.count("upload.bytes", sum(a.nbytes for a in packed))
        with trace.span("launch.enqueue"):
            return engine_step(
                pc, pv, mlen, allow_short, rid, mate, cstart, tables,
                k=self.k, w=self.w, budget=budget, num_segments=n_units,
                # only the largest tile class ever holds chunked long reads
                dedup_positions=L >= self.L_max, route=self.routes[L],
            )

    def probe_hashes(self, hashes: np.ndarray) -> np.ndarray:
        """Membership of u64 hashes in the index (the --debug decider's
        probe where no host holds the index): K2 over the sorted distinct
        hashes, each its own read, once per block of the first data row,
        the hits summed (over the mesh's processes too)."""
        q = np.ascontiguousarray(hashes, dtype=np.uint64)
        if q.size == 0:
            return np.zeros(0, dtype=bool)
        uniq, inv = np.unique(q, return_inverse=True)
        # the stream K2 takes: ascending as int64, read id = position
        order = np.argsort(uniq.view(np.int64), kind="stable")
        keys = torch.from_numpy(uniq.view(np.int64)[order])
        srid = torch.arange(keys.numel(), dtype=torch.int32)
        first = torch.ones(keys.numel(), dtype=torch.int32)
        hits = np.zeros(keys.numel(), dtype=np.int64)
        for t in self.blocks[0]:
            dev = t.slots.device
            hits += probe_hits(
                t.slots, t.spill, keys.to(dev), srid.to(dev), first.to(dev),
                p=t.p, sp=t.sp, num_segments=keys.numel(), row_lo=t.row_lo,
            ).cpu().numpy()
        if self.mesh is not None:
            hits = self.mesh.sum_over_shards(hits)
        member = np.zeros(uniq.size, dtype=bool)
        member[order] = hits > 0
        return member[inv]

    def counts_single(self, seqs: list[bytes], prefix_length: int):
        return self.launch_single(seqs, prefix_length)()

    def counts_paired(self, pairs, prefix_length: int):
        return self.launch_paired(pairs, prefix_length)()

    def launch_single(self, seqs: list[bytes], prefix_length: int):
        arena, start, length = join_seqs(seqs)
        n = len(seqs)
        return self.launch_counts(arena, start, length,
                                  np.arange(n, dtype=np.int64),
                                  np.zeros(n, dtype=np.int64), n,
                                  prefix_length)

    def launch_paired(self, pairs, prefix_length: int):
        arena, start, length = join_seqs([s for p in pairs for s in p])
        i = np.arange(2 * len(pairs), dtype=np.int64)
        return self.launch_counts(arena, start, length, i // 2, i % 2,
                                  len(pairs), prefix_length)


def _copy_to(t: RadixTable, device: torch.device) -> RadixTable:
    return replace(t, slots=t.slots.to(device),
                   spill=None if t.spill is None else t.spill.to(device))


# ---------------------------------------------------------------------------
# Index build
# ---------------------------------------------------------------------------

_I64_MIN = -(1 << 63)
_M55 = 0x5555555555555555


def entropy_keep_table(k: int, threshold: float) -> np.ndarray:
    """(k+1)**3 bool table: entry a*(k+1)**2 + c*(k+1) + g is whether a
    k-mer of a A, c C, g G and k-a-c-g T bases passes the scaled-entropy
    filter. Each entry is the NumPy oracle's own float32 formula
    (minimizers_np.scaled_entropy) on a k-mer of that composition, so a
    lookup is bit-identical to it by construction (the device never does
    the float math; the sum of the four terms depends on their order, so
    the table is keyed by the forward strand's counts)."""
    n = k + 1
    comps = np.array([(a, c, g) for a in range(n) for c in range(n - a)
                      for g in range(n - a - c)], dtype=np.int64)
    a, c, g = comps.T
    t = k - a - c - g
    bases = np.tile(np.frombuffer(b"ACGT", np.uint8), len(comps))
    arena = np.repeat(bases, np.stack([a, c, g, t], axis=1).reshape(-1))
    ent = mnp.scaled_entropy(arena, np.arange(len(comps)) * k, k)
    table = np.zeros(n ** 3, dtype=bool)
    table[a * n * n + c * n + g] = ent >= np.float32(threshold)
    return table


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    x = x - (lsr(x, 1) & _M55)
    x = (x & 0x3333333333333333) + (lsr(x, 2) & 0x3333333333333333)
    x = (x + lsr(x, 4)) & 0x0F0F0F0F0F0F0F0F
    return lsr(x * 0x0101010101010101, 56)


def forward_values(pc: torch.Tensor, pos: torch.Tensor, k: int):
    """Forward (not canonical) k-mer values at (R, Br) slot positions,
    read from the packed rows: bits [2p, 2p + 2k) of row r's little-endian
    code stream. Returns (lo, hi) int64 (hi is zero for k <= 32)."""
    R = pc.shape[0]
    words = torch.cat([
        pc.contiguous().view(torch.int64),
        torch.zeros((R, 2), dtype=torch.int64, device=pc.device),
    ], dim=1)
    p = pos.to(torch.int64)
    wi = p // 32
    off = 2 * (p % 32)
    w0, w1, w2 = (words.gather(1, wi + j) for j in range(3))
    sh = off.clamp(min=2)  # shifts of 64 are undefined; off == 0 is apart
    low_mask = (torch.ones_like(sh) << (64 - sh)) - 1

    def funnel(a, b):  # bits [off, off + 64) of the 128-bit (a, b)
        return torch.where(off == 0, a, ((a >> sh) & low_mask) | (b << (64 - sh)))

    lo, hi = funnel(w0, w1), funnel(w1, w2)
    if k <= 32:
        mask = -1 if k == 32 else (1 << (2 * k)) - 1
        return lo & mask, torch.zeros_like(lo)
    return lo, hi & ((1 << (2 * k - 64)) - 1)


def _code_counts(lo: torch.Tensor, hi: torch.Tensor, k: int, code: int):
    """Bases of 2-bit code ``code`` among the k codes of (lo, hi)."""
    pat = as_i64(code * _M55)
    n = torch.zeros_like(lo)
    for v, nb in ((lo, min(2 * k, 64)), (hi, 2 * k - 64)):
        if nb <= 0:
            continue
        x = ~(v ^ pat)
        x = x & lsr(x, 1) & _M55
        if nb < 64:
            x = x & ((1 << nb) - 1)
        n = n + _popcount64(x)
    return n


def entropy_keep(pc: torch.Tensor, pos: torch.Tensor, keep_table, k: int):
    """(R, Br) bool: the k-mer at each slot passes the entropy filter
    (ref: src/minimizers.rs:73-121). Its forward composition (codes A=0,
    C=1, T=2, G=3) indexes entropy_keep_table. Exact at every slot whose
    k-mer is all ACGT, the only slots an index keeps; there the packed
    (IUPAC-canonicalised) codes are the original bytes' codes."""
    lo, hi = forward_values(pc, pos, k)
    n = k + 1
    a, c, g = (_code_counts(lo, hi, k, code) for code in (0, 1, 3))
    return keep_table[a * n * n + c * n + g]


def extract_step(pc, pv, mlen, allow_short, keep_table, *, k: int, w: int,
                 Br: int, route: str):
    """Index-build extraction of one batch (ref: src/minimizers.rs:125-191):
    ((R, Br) int64 hashes, (R, Br) bool valid slots, (R,) int32 row
    totals). A row whose total exceeds Br has only its first Br slots."""
    pos, planes, rt = select_slots(pc, pv, mlen, allow_short, k=k, w=w,
                                   Br=Br, route=route)
    lane = torch.arange(Br, dtype=torch.int32, device=pc.device)
    valid = lane[None, :] < torch.clamp(rt, max=Br)[:, None]
    if keep_table is not None:
        # slots past a row's total hold unspecified positions: read at 0
        valid &= entropy_keep(pc, torch.where(valid, pos, 0), keep_table, k)
    return hash_planes(planes), valid, rt


class IndexBuildPipeline:
    """Device index-build extraction (ref: src/minimizers.rs:125-191).

    Sequences are IUPAC-canonicalised before selection; validity and the
    optional entropy filter follow the original bytes. Rows take the
    filter's tile classes and chunk rule (pack.chunk_rows) without its
    prefix cut or newline strip. A row selecting more minimizers than its
    slot budget runs again on the device with a budget that holds them
    all (``rerun_rows`` counts those rows). Each tile class's selection
    kernel is tile_route's with ``index_build=True``: K1, K3, or K5 under
    DEACON_PALLAS=1."""

    DEFAULT_TILES = DevicePipeline.DEFAULT_TILES
    #: batches launched before their results are collected
    RESOLVE_DEPTH = 64

    def __init__(self, k: int, w: int, entropy_threshold: float = 0.0,
                 tiles=None, device=None):
        if not 1 <= k <= MAX_K_BUILD or w < 1:
            raise ValueError(
                f"index build needs 1 <= k <= {MAX_K_BUILD} and w >= 1 "
                f"(k={k}, w={w})"
            )
        self.device = resolve_device(device)
        self.k, self.w = int(k), int(w)
        self.l = self.k + self.w - 1
        self.budget_frac = default_budget_frac(self.w)
        self.tiles, self.routes = tile_classes(
            tiles or self.DEFAULT_TILES, k=self.k, l=self.l, rows=512,
            index_build=True)
        self.L_max = self.tiles[-1][0]
        self._stride = self.L_max - self.l + 1
        self.entropy = float(entropy_threshold)
        self._keep_table = None
        if self.entropy != 0.0 and self.k >= 10:
            self._keep_table = torch.from_numpy(
                entropy_keep_table(self.k, self.entropy)
            ).to(self.device)
        self.rerun_rows = 0

    def _launch(self, rows: RowBlock, L: int, Br: int):
        pc, pv, mlen, allow_short, rid = upload(
            list(pack_block(rows, len(rows), L, self.k, self.l,
                            code_table=INDEX_CODE)[:5]),
            self.device,
        )
        h, valid, rt = extract_step(pc, pv, mlen, allow_short,
                                    self._keep_table, k=self.k, w=self.w,
                                    Br=Br, route=self.routes[L])
        return h, valid, rt, rid

    def _collect(self, launched, out_h, out_r) -> None:
        """Hashes and record ids of the valid slots of launched batches;
        rows over budget are dropped from their batch and rerun."""
        used = torch.stack([b[4].max() for b in launched]).cpu().numpy()
        for (rows, L, Br, h, rt, rid, valid), top in zip(launched, used):
            if top > Br:
                row_tot = rt.cpu().numpy()
                over = np.nonzero(row_tot > Br)[0]
                valid &= (rt <= Br)[:, None]
                need = min(L, -(-int(row_tot[over].max()) // 128) * 128)
                h2, valid2, _, rid2 = self._launch(rows.take(over), L, need)
                out_h.append(h2[valid2])
                out_r.append(rid2[:, None].expand_as(h2)[valid2])
                self.rerun_rows += over.size
            out_h.append(h[valid])
            out_r.append(rid[:, None].expand_as(h)[valid])

    def extract_batch(self, seqs: list[bytes]):
        """extract_arena of a list of sequences."""
        return self.extract_arena(*join_seqs(seqs))

    def extract_arena(self, arena: np.ndarray, start: np.ndarray,
                      length: np.ndarray):
        """-> ((n,) int64 hashes, (n,) int64 sequence index) on the device:
        every minimizer hash of every sequence ``arena[start[i]:start[i] +
        length[i]]`` (duplicates possible). Each row goes to the smallest
        tile class that holds it; tile classes launch in order of their
        first row, R rows a batch."""
        seq, rstart, rlen, cstart = chunk_spans(
            start, length, k=self.k, l=self.l, stride=self._stride,
            max_len=self.L_max)
        rows = RowBlock(arena, rstart, rlen, seq, np.zeros_like(seq), cstart)
        tile = tile_index(self.tiles, rlen)
        _, tile_first = np.unique(tile, return_index=True)
        out_h: list[torch.Tensor] = []
        out_r: list[torch.Tensor] = []
        launched = []
        for t in tile[np.sort(tile_first)].tolist():
            L, R = self.tiles[t]
            t_rows = rows.take(tile == t)
            Br = v4_row_budget(L, self.w, self.budget_frac)
            for a in range(0, len(t_rows), R):
                chunk = t_rows.take(slice(a, a + R))
                h, valid, rt, rid = self._launch(chunk, L, Br)
                launched.append((chunk, L, Br, h, rt, rid, valid))
                if len(launched) >= self.RESOLVE_DEPTH:
                    self._collect(launched, out_h, out_r)
                    launched = []
        if launched:
            self._collect(launched, out_h, out_r)
        if not out_h:
            z = torch.zeros(0, dtype=torch.int64, device=self.device)
            return z, z.clone()
        return torch.cat(out_h), torch.cat(out_r).to(torch.int64)


class DistinctHashes:
    """The distinct u64 hashes seen so far, on the device, kept sorted in
    unsigned order (as int64 with the sign bit flipped); the index build's
    set (ref: src/index.rs:266-284)."""

    def __init__(self, device):
        self.flipped = torch.zeros(0, dtype=torch.int64, device=device)

    def __len__(self) -> int:
        return int(self.flipped.numel())

    def add(self, hashes: torch.Tensor, seq: torch.Tensor,
            n_seqs: int) -> np.ndarray:
        """Add every sequence's hashes in order; returns the (n_seqs,)
        running distinct totals after each sequence."""
        before = len(self)
        q, seq, first = sort_runs(hashes ^ _I64_MIN, seq, pairs=False)
        q, seq = q[first], seq[first]  # each key at its first sequence
        if before and q.numel():
            i = torch.searchsorted(self.flipped, q).clamp(max=before - 1)
            new = self.flipped[i] != q
            q, seq = q[new], seq[new]
        new_per = torch.bincount(seq, minlength=n_seqs)
        if q.numel():
            self.flipped = torch.sort(torch.cat([self.flipped, q])).values
        return before + new_per.cumsum(0).cpu().numpy()

    def sorted_u64(self) -> np.ndarray:
        """The set as a sorted uint64 array on the host."""
        return (self.flipped ^ _I64_MIN).cpu().numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# Sorted key sets resident on the device: the server's probe, index diff
# ---------------------------------------------------------------------------

def upload_flipped(keys: np.ndarray, device: torch.device) -> torch.Tensor:
    """Sorted u64 keys as a new int64 tensor on ``device`` with the sign bit
    flipped, so that int64 order is the keys' unsigned order. The host
    array is copied, never aliased (on the CPU too)."""
    t = torch.from_numpy(np.ascontiguousarray(keys, dtype=np.uint64)
                         .view(np.int64)).to(device, copy=True)
    return t.bitwise_xor_(_I64_MIN)


def find_flipped(flipped: torch.Tensor, q: torch.Tensor):
    """Where flipped queries ``q`` would sit in the non-empty flipped
    sorted keys, clamped to the last key, and whether the key there is
    the query: (index, member)."""
    i = torch.searchsorted(flipped, q).clamp_(max=flipped.numel() - 1)
    return i, flipped[i] == q


class DeviceHashProbe:
    """u64 membership against an index's keys resident on the device: the
    server's decisions (clients send pre-hashed minimizers, so each
    request is one probe; ref: src/server_common.rs:8-27). The keys are
    held once, sorted and sign-flipped (8 bytes a key); a call uploads
    the queries (from pinned memory on a card), searches, compares and
    copies the bits back.

    Thread-safe without a lock: a call shares no mutable state, and the
    HTTP server's threads enqueue on the device's current stream, whose
    order the device keeps; each call's ``.cpu()`` waits for its own
    result."""

    def __init__(self, index_hashes: np.ndarray, device=None):
        self.device = resolve_device(device)
        t = time.perf_counter()
        self.flipped = upload_flipped(index_hashes, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        #: seconds of the upload (and of the file's load: from_index_file)
        self.upload_s = time.perf_counter() - t
        self.load_s = 0.0

    @classmethod
    def from_index_file(cls, path: str, device=None) -> "DeviceHashProbe":
        """Load an index file's keys, upload them and keep no host copy
        (the server drops the host array whenever a probe owns the
        keys)."""
        from ..index.store import load_index

        resolve_device(device)  # no card: raise before reading the file
        t = time.perf_counter()
        hashes = load_index(path).hashes
        load_s = time.perf_counter() - t
        self = cls(hashes, device)
        self.load_s = load_s
        return self

    def __len__(self) -> int:
        return int(self.flipped.numel())

    @property
    def nbytes(self) -> int:
        return int(self.flipped.numel()) * 8

    def member(self, q: torch.Tensor) -> torch.Tensor:
        """Membership of flipped int64 queries already on the device (the
        keys must not be empty)."""
        return find_flipped(self.flipped, q)[1]

    def launch(self, hashes: np.ndarray):
        """Start the search of u64 ``hashes``: uploads them and enqueues
        the search with this probe's card made current, and returns the
        pending bits for ``collect``. An empty search launches nothing and
        returns its (empty or all-false) answer. Spans: ``probe.upload``
        (the pinned copy and the host-to-device enqueue; nothing on the
        CPU) and ``probe.search`` (searchsorted, gather, compare)."""
        q = np.ascontiguousarray(hashes, dtype=np.uint64)
        if q.size == 0 or len(self) == 0:
            return np.zeros(q.size, dtype=bool)
        t = torch.from_numpy(q.view(np.int64))
        on_card = self.device.type == "cuda"
        with torch.cuda.device(self.device) if on_card else nullcontext():
            with trace.span("probe.upload"):
                if on_card:
                    t = t.pin_memory().to(self.device, non_blocking=True)
            with trace.span("probe.search"):
                return self.member(t ^ _I64_MIN)

    @staticmethod
    def collect(bits) -> np.ndarray:
        """The bits of a ``launch``, on the host (waits for them: span
        ``probe.fetch``)."""
        if isinstance(bits, np.ndarray):
            return bits
        with trace.span("probe.fetch"):
            return bits.cpu().numpy()

    def __call__(self, hashes: np.ndarray) -> np.ndarray:
        return self.collect(self.launch(hashes))


def probe_rows(rows, hashes: np.ndarray) -> np.ndarray:
    """Membership of u64 ``hashes`` over the probes of a (data x shard)
    layout, ``rows[i]`` the probes of data row i (disjoint value ranges,
    so a key is in one of them at most): the hashes are cut into one
    contiguous part per row (np.array_split) and each part is searched
    by every probe of its row. Every search is launched before any is
    collected, so the rows' cards work at once; the bits come back in
    the hashes' order."""
    parts = np.array_split(np.ascontiguousarray(hashes, dtype=np.uint64),
                           len(rows))
    launched = [[p.launch(part) for p in row]
                for row, part in zip(rows, parts)]
    out = []
    for part, pending in zip(parts, launched):
        bits = np.zeros(part.size, dtype=bool)
        for b in pending:
            bits |= DeviceHashProbe.collect(b)
        out.append(bits)
    return np.concatenate(out)


class ShardedHashProbe:
    """DeviceHashProbe over a (data x shard) mesh (parallel/sharded.Mesh):
    shard j holds the keys of value range j of the index file
    (store.load_index_shard) on the devices of mesh column j, one copy
    per device; a call searches its queries over the rows (probe_rows:
    one contiguous part per data row, against every shard on the row's
    devices). Thread-safe as DeviceHashProbe is."""

    def __init__(self, index_path: str, mesh):
        from ..index.store import load_index_shard

        self.mesh = mesh
        n_shard = mesh.shape["shard"]
        self.load_s = self.upload_s = 0.0
        self.probes: dict = {}
        for j in range(n_shard):
            t = time.perf_counter()
            _, keys, _ = load_index_shard(index_path, j, n_shard)
            self.load_s += time.perf_counter() - t
            for row in mesh.devices:
                if (row[j], j) not in self.probes:
                    probe = DeviceHashProbe(keys, row[j])
                    self.upload_s += probe.upload_s
                    self.probes[(row[j], j)] = probe
            del keys

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.probes.values())

    def __call__(self, hashes: np.ndarray) -> np.ndarray:
        rows = [[self.probes[(dev, j)] for j, dev in enumerate(row)]
                for row in self.mesh.devices]
        return probe_rows(rows, hashes)


class KeptKeys:
    """A sorted u64 key set on the device (int64, sign bit flipped) and a
    keep-mask over it: ``index diff`` against a FASTX stream clears the
    keys that each batch's minimizers hit (ref: src/index.rs:311-418)."""

    def __init__(self, keys: np.ndarray, device):
        self.flipped = upload_flipped(keys, device)
        self.keep = torch.ones(self.flipped.numel(), dtype=torch.bool,
                               device=self.flipped.device)

    def removed(self) -> int:
        return int(self.keep.numel()) - int(self.keep.sum())

    def remove(self, hashes: torch.Tensor, seq: torch.Tensor | None = None,
               n_seqs: int = 0) -> "np.ndarray | None":
        """Clear the keys among ``hashes`` (int64 bit patterns of u64).
        With ``seq`` (each hash's sequence in the batch) returns the
        (n_seqs,) running count of removed keys after each sequence, a
        key counting at the first sequence that hits it."""
        n = int(self.flipped.numel())
        before = self.removed() if seq is not None else 0
        if n == 0 or hashes.numel() == 0:
            return None if seq is None else np.full(n_seqs, before)
        i, hit = find_flipped(self.flipped, hashes ^ _I64_MIN)
        if seq is None:
            self.keep[i[hit]] = False
            return None
        i, seq = i[hit], seq[hit]
        new = self.keep[i]
        i, seq, first = sort_runs(i[new], seq[new], pairs=False)
        self.keep[i] = False
        new_per = torch.bincount(seq[first], minlength=n_seqs)
        return before + new_per.cumsum(0).cpu().numpy()

    def remaining(self) -> np.ndarray:
        """The keys still kept, as a sorted uint64 array on the host."""
        return (self.flipped[self.keep] ^ _I64_MIN).cpu().numpy().view(
            np.uint64)
