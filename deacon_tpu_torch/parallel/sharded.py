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
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..device import resolve_device
from ..ops.engine import DevicePipeline
from ..ops.radix_probe import RadixTable, build_radix_shards


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
        self.mesh = mesh
        self.n_data, self.n_shard = mesh.shape["data"], mesh.shape["shard"]
        self._init_engine(k, w, tiles, mesh.devices[0][0])
        first = build_radix_shards(index_hashes, self.n_shard,
                                   mesh.devices[0])
        held = {(t.slots.device, j): t for j, t in enumerate(first)}
        for row in mesh.devices:
            for j, dev in enumerate(row):
                if (dev, j) not in held:
                    held[(dev, j)] = _copy_to(first[j], dev)
        self.blocks = [[held[(dev, j)] for j, dev in enumerate(row)]
                       for row in mesh.devices]
        self._turn = 0

    def _launch_batch(self, rows, L: int, n_units: int, budget: int):
        d = self._turn % self.n_data
        self._turn += 1
        out, rt = self._step(rows, L, n_units, budget,
                             self.mesh.devices[d][0], self.blocks[d])
        return out.to(self.device, non_blocking=True), rt


def _copy_to(t: RadixTable, device: torch.device) -> RadixTable:
    return replace(t, slots=t.slots.to(device),
                   spill=None if t.spill is None else t.spill.to(device))
