"""Multi-device filter pipeline over a (data x shard) mesh of torch
devices (counterpart of the JAX package's deacon_tpu/parallel/sharded.py).

Read batches are data-parallel over the ``data`` axis: successive batches
go round-robin to the rows of the mesh, and each runs its selection, hash,
sort and totals on its row's first device. The radix table is cut into
contiguous blocks of bucket rows over the ``shard`` axis
(radix_probe.build_radix_shards): a batch's sorted stream goes to each
device of its row, K2 probes that device's block there (csrc/radix_probe.cu
with a row offset; the spill table is replicated and counts only on the
shard owning a query's bucket), and the per-shard hits come back to the
row's first device and are summed with integer adds, the counterpart of
the reference's ``psum`` over ``shard``. Totals come from the slot grid
once, as they do not depend on the shard.

A mesh is an explicit grid of torch devices, and a device may appear more
than once: the CPU tests run a 2x4 mesh of ``["cpu"] * 8``, and one card
runs ``["cuda:0"] * 8``, with mesh positions on one device sharing one
block of each shard. The command line takes distinct cards on ``cuda``
(make_mesh without devices) and the CPU repeated on ``--device cpu``.

ShardedPipeline.from_file builds each block from its own rows' keys in
the index file (radix_probe.build_radix_blocks_from_file), so no host
holds the whole index. PodPipeline is the form whose shard axis runs
across processes (parallel/multihost.PodMesh): each process builds and
probes only its own block, on its own cards, and the per-process hits of
each batch of reads are summed with one all-reduce over the shard group,
the counterpart of the JAX package's ``psum`` over a process-spanning
``shard`` axis (ShardedPipeline.from_shards there).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device import resolve_device
from ..ops.engine import DevicePipeline
from ..ops.kernels import probe_hits
from ..ops.radix_probe import (
    RadixTable,
    build_radix_blocks_from_file,
    build_radix_shards,
)


def parse_mesh_spec(mesh_spec: str) -> tuple[int, int]:
    """Parse a DATAxSHARD mesh spec like "2x4" into (n_data, n_shard)."""
    try:
        n_data, n_shard = (int(x) for x in mesh_spec.lower().split("x"))
        if n_data < 1 or n_shard < 1:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"--mesh must be DATAxSHARD (e.g. 2x4), got {mesh_spec!r}"
        ) from None
    return n_data, n_shard


@dataclass(frozen=True)
class Mesh:
    """devices[d][j]: the device of data row d and shard j."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "shard": len(self.devices[0])}


def make_mesh(n_data: int, n_shard: int, devices=None) -> Mesh:
    """An n_data x n_shard mesh of the first n_data * n_shard ``devices``
    (row by row; a device may repeat), by default of distinct CUDA cards.
    Raises ValueError when there are too few."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [f"cuda:{i}" for i in range(have)]
    need = n_data * n_shard
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    devs = [resolve_device(d) for d in devices[:need]]
    return Mesh(tuple(tuple(devs[d * n_shard:(d + 1) * n_shard])
                      for d in range(n_data)))


class ShardedPipeline(DevicePipeline):
    """DevicePipeline over a mesh: the same tile classes, routes,
    switches, packing, upload, FetchGroup and on-card reruns, with batches
    round-robin over the mesh's data rows and the radix table cut into
    one block per shard. ``index_hashes`` holds the index's u64 hashes (a
    NumPy array or an int64 tensor). ``blocks[d][j]`` is shard j on
    mesh.devices[d][j]; positions on one device share one block. Outputs
    come back to the first device of the mesh, where the fetch group
    gathers them."""

    def __init__(self, index_hashes, k: int, w: int, mesh: Mesh,
                 tiles=None):
        self._init_mesh(k, w, mesh, tiles)
        self._place(build_radix_shards(index_hashes, self.n_shard,
                                       mesh.devices[0]))

    @classmethod
    def from_file(cls, index_path: str, k: int, w: int, mesh: Mesh,
                  tiles=None) -> "ShardedPipeline":
        """The pipeline of an index file, each block built from the keys
        of its rows alone (build_radix_blocks_from_file): the host never
        holds more than one block's keys."""
        self = cls.__new__(cls)
        self._init_mesh(k, w, mesh, tiles)
        blocks = build_radix_blocks_from_file(
            index_path, self.n_shard, dict(enumerate(mesh.devices[0])))
        self._place([blocks[j] for j in range(self.n_shard)])
        return self

    def _init_mesh(self, k: int, w: int, mesh: Mesh, tiles) -> None:
        self.mesh = mesh
        self.n_data, self.n_shard = mesh.shape["data"], mesh.shape["shard"]
        self._init_engine(k, w, tiles, mesh.devices[0][0])
        self._turn = 0

    def _place(self, first: list[RadixTable]) -> None:
        """blocks[d][j]: first[j] (on mesh.devices[0][j]) on every other
        device of column j, one copy per device (a PodMesh has one
        column: this process's block)."""
        held = {(t.slots.device, j): t for j, t in enumerate(first)}
        for row in self.mesh.devices:
            for j, dev in enumerate(row):
                if (dev, j) not in held:
                    held[(dev, j)] = _copy_to(first[j], dev)
        self.blocks = [[held[(dev, j)] for j, dev in enumerate(row)]
                       for row in self.mesh.devices]

    def probe_hashes(self, hashes: np.ndarray) -> np.ndarray:
        """Membership of u64 hashes in the index (the --debug decider's
        probe where no host holds the index): K2 over the sorted distinct
        hashes, each its own read, once per block of the first mesh row,
        the hits summed (over processes too, for a PodPipeline)."""
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
        hits = self._sum_over_processes(hits)
        member = np.zeros(uniq.size, dtype=bool)
        member[order] = hits > 0
        return member[inv]

    def _sum_over_processes(self, hits: np.ndarray) -> np.ndarray:
        return hits

    def _launch_batch(self, rows, L: int, n_units: int, budget: int):
        d = self._turn % self.n_data
        self._turn += 1
        out, rt = self._step(rows, L, n_units, budget,
                             self.mesh.devices[d][0], self.blocks[d])
        return out.to(self.device, non_blocking=True), rt


class PodPipeline(ShardedPipeline):
    """ShardedPipeline over a PodMesh (parallel/multihost): the shard axis
    runs across the processes of the mesh's shard group and the data axis
    over this process's cards. Each process builds only its own block of
    the radix table from the index file (bucket rows shard_rows(j, S, p)
    of shard j = mesh.shard, build_radix_blocks_from_file, with its spill
    and the retry at p + 1 agreed over the group) and K2 probes it with
    its row_lo. Every process of the group must be fed the same read
    batches in the same order: each batch's hits are summed over the
    group with one all-reduce when the batch resolves, after any rerun of
    rows over their budget, which is decided from row totals that are
    the same in every process (the slot grid does not depend on the
    shard), never from a process's own hits. Totals need no reduction."""

    def __init__(self, index_path: str, k: int, w: int, mesh, tiles=None):
        self._init_mesh(k, w, mesh, tiles)
        self._place([build_radix_blocks_from_file(
            index_path, self.n_shard, {mesh.shard: self.device},
            agree=mesh.agree_max)[mesh.shard]])

    def launch_counts(self, *args, **kwargs):
        resolve = super().launch_counts(*args, **kwargs)

        def resolve_pod():
            hits, totals = resolve()
            return self._sum_over_processes(hits), totals

        return resolve_pod

    def _sum_over_processes(self, hits: np.ndarray) -> np.ndarray:
        return self.mesh.sum_over_shards(hits)


def _copy_to(t: RadixTable, device: torch.device) -> RadixTable:
    return replace(t, slots=t.slots.to(device),
                   spill=None if t.spill is None else t.spill.to(device))
