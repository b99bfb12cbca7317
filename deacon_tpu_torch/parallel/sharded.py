"""The (data x shard) mesh of torch devices that the filter's device
pipeline runs over (counterpart of the JAX package's
deacon_tpu/parallel/sharded.py).

The sharding rule lives in one class, ops/engine.DevicePipeline: read
batches go round-robin to the rows of the mesh, and each runs its
selection, hash, sort and totals on its row's first device; the radix
table is cut into contiguous blocks of bucket rows over the ``shard``
axis (radix_probe.build_radix_shards, or build_radix_blocks_from_file
for an index file, so that no host holds the whole index); a batch's
sorted stream goes to each device of its row, K2 probes that device's
block there (csrc/radix_probe.cu with a row offset; a block's spill
table counts only the queries of its rows), and the per-block hits come
back to the row's first device and are summed with integer adds, the
counterpart of the reference's ``psum`` over ``shard``. Totals come from
the slot grid once, as they do not depend on the shard.

A mesh says which shard columns this process holds (``shards``), how the
processes holding the other columns agree while the blocks are built
(``agree_max``) and how the hits of each batch are summed over them
(``sum_over_shards``). A Mesh holds every column in this process, so both
are the identity; a PodMesh (parallel/multihost.py) holds one column and
runs both as collectives over its process group.

A mesh is an explicit grid of torch devices, and a device may appear more
than once: the CPU tests run a 2x4 mesh of ``["cpu"] * 8``, and one card
runs ``["cuda:0"] * 8``, with mesh positions on one device sharing one
block of each shard. The command line takes distinct cards on ``cuda``
(make_mesh without devices) and the CPU repeated on ``--device cpu``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


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
    """devices[d][j]: the device of data row d and shard j, every shard
    in this process."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "shard": len(self.devices[0])}

    @property
    def shards(self) -> tuple[int, ...]:
        """The shard of each column of ``devices``."""
        return tuple(range(len(self.devices[0])))

    def sum_over_shards(self, hits: np.ndarray) -> np.ndarray:
        """Hits summed over the processes holding the other shards: none."""
        return hits

    def agree_max(self, flags: list[int]) -> list[int]:
        """Flags agreed with the processes holding the other shards:
        none."""
        return flags

    def describe(self) -> str:
        shape = self.shape
        return f"mesh data={shape['data']} x shard={shape['shard']}"


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
