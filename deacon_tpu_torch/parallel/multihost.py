"""Multi-process modes over torch.distributed (the counterpart of the JAX
package's parallel/multihost.py, which runs on jax.distributed).

Every rank runs the same command with the JAX package's environment:

    DEACON_COORD=host0:29500 DEACON_NUM_PROC=4 DEACON_PROC_ID=0..3 \\
        python -m deacon_tpu_torch filter INDEX READS -o OUT --mesh pod

* ``--mesh pod``: the index's radix table is cut into one block of bucket
  rows per rank (rank j holds block j of ops/engine.DevicePipeline over
  a PodMesh), every rank is fed the SAME input, and each batch's hits
  are summed over the ranks with one all-reduce. What scales with the
  ranks is the index memory, not the reads/s.
* ``--mesh pod-2d``: ranks form groups of ``DEACON_POD_SHARDS``
  consecutive ranks; each group is a pod over its own byte range of the
  input (filter/pod_data.run_pod_2d).
* ``--mesh pod-data``: each rank filters its own byte range on its own
  cards with no collective at all (filter/pod_data.run_pod_data), so it
  needs no coordinator.

A rank's devices are the cards torch.cuda.device_count() shows it (the
launcher sets CUDA_VISIBLE_DEVICES per rank, as for any torch job), or
the CPU on ``--device cpu``. The data axis of a pod mesh runs over them.

Backend: the default process group is gloo, on the CPU. When a pod
mesh is made the ranks all-gather their cards' UUIDs over it; the shard
group's collectives use nccl when every rank's cards are distinct, and
gloo (on host tensors) when ranks share a card or run on the CPU. The
choice is printed in the ``Engine:`` line; a collective that fails
raises, and the other backend is never tried. Every collective has the
process group's timeout (COLLECTIVE_TIMEOUT_S), so a rank that never
arrives turns into an error, not a hang.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .sharded import Mesh, make_mesh, parse_mesh_spec

#: seconds any collective waits for its peers before it raises
COLLECTIVE_TIMEOUT_S = 600


def maybe_init_distributed() -> bool:
    """Join the process group described by DEACON_COORD (host:port of
    rank 0), DEACON_NUM_PROC and DEACON_PROC_ID: gloo, over TCP, with a
    finite timeout. Idempotent. Returns False when DEACON_COORD is
    unset."""
    coord = os.environ.get("DEACON_COORD")
    if not coord:
        return False
    if dist.is_initialized():
        return True
    nproc, rank = world()
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coord}", world_size=nproc, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )
    return True


def leave_distributed() -> None:
    """Destroy this process's process group, if it joined one, before the
    interpreter exits (a gloo group torn down at exit can abort the
    process). Every collective of the command has ended by then."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """(DEACON_NUM_PROC, DEACON_PROC_ID), by default (1, 0)."""
    nproc = int(os.environ.get("DEACON_NUM_PROC", "1"))
    rank = int(os.environ.get("DEACON_PROC_ID", "0"))
    if not 0 <= rank < nproc:
        raise ValueError(
            f"DEACON_PROC_ID={rank} out of range for DEACON_NUM_PROC={nproc}"
        )
    return nproc, rank


def local_devices(device: str = "cuda") -> list[torch.device]:
    """This rank's devices: every card it sees on cuda, the CPU on cpu."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _card_ids(devices: list[torch.device]) -> list[str]:
    return [str(torch.cuda.get_device_properties(d).uuid)
            for d in devices if d.type == "cuda"]


def _gather_devices(devices: list[torch.device]) -> list[list[str]]:
    """Each rank's card UUIDs ("cpu" for the CPU), over the world group."""
    mine = _card_ids(devices) if devices[0].type == "cuda" else ["cpu"]
    if not dist.is_initialized():
        return [mine]
    every: list = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def collective_backend(every: list[list[str]]) -> str:
    """nccl when every rank's cards are distinct cards, else gloo (ranks
    sharing a card, or on the CPU). Every rank decides it from the same
    gathered card ids, so all decide alike."""
    flat = [u for ids in every for u in ids]
    distinct = "cpu" not in flat and len(set(flat)) == len(flat)
    return "nccl" if distinct else "gloo"


@dataclass(frozen=True)
class PodMesh(Mesh):
    """A (data x shard) mesh whose shard axis runs across the processes
    of ``group``: ``devices`` holds this process's data rows (one card
    each), ``shard`` is its place on the shard axis, ``n_shard`` the
    group's size. ``group`` is None for the world group (or a world of
    one); ``backend`` is the collectives' ("nccl": tensors on this
    process's first card; "gloo": host tensors)."""

    n_shard: int = 1
    shard: int = 0
    group: object = None
    backend: str = "gloo"

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "shard": self.n_shard}

    @property
    def shards(self) -> tuple[int, ...]:
        return (self.shard,)

    def describe(self) -> str:
        return f"{super().describe()}; collectives over {self.backend}"

    def _all_reduce(self, arr: np.ndarray, op) -> np.ndarray:
        if self.n_shard == 1:
            return arr
        dev = self.devices[0][0] if self.backend == "nccl" else "cpu"
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)).to(dev)
        dist.all_reduce(t, op=op, group=self.group)
        return t.cpu().numpy()

    def sum_over_shards(self, hits: np.ndarray) -> np.ndarray:
        """Per-process int64 hits summed over the shard group."""
        return self._all_reduce(hits, dist.ReduceOp.SUM)

    def agree_max(self, flags: list[int]) -> list[int]:
        """Element-wise maximum of small int flags over the shard group:
        the agreement point every process passes before it raises."""
        return self._all_reduce(np.asarray(flags, np.int64),
                                dist.ReduceOp.MAX).tolist()

    def broadcast(self, arr: np.ndarray) -> np.ndarray:
        """``arr`` (int64) of the group's first process (shard 0), in every
        process of the group (the same shape everywhere)."""
        if self.n_shard == 1:
            return arr
        dev = self.devices[0][0] if self.backend == "nccl" else "cpu"
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)).to(dev)
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast(t, src=src, group=self.group)
        return t.cpu().numpy()


def _pod_mesh(devices: list[torch.device], members: list[int],
              rank: int) -> PodMesh:
    """The PodMesh of ``rank`` over the group ``members`` (consecutive
    ranks; all of the world for --mesh pod). Every rank of the world must
    call this together: it gathers the ranks' cards and creates every
    group's communicator, in the same order everywhere."""
    every = _gather_devices(devices)
    backend = collective_backend(every)
    nproc = len(every)
    per = min(len(every[r]) for r in members) if devices[0].type == "cuda" \
        else 1
    group = None
    if len(members) < nproc or backend == "nccl":
        n = len(members)
        for g0 in range(0, nproc, n):
            ranks = list(range(g0, g0 + n))
            made = dist.new_group(ranks=ranks, backend=backend)
            if ranks == members:
                group = made
    return PodMesh(tuple((d,) for d in devices[:per]),
                   n_shard=len(members), shard=members.index(rank),
                   group=group, backend=backend)


def make_pod_mesh(device: str = "cuda") -> PodMesh:
    """The ``--mesh pod`` mesh: the shard axis across every rank of the
    process group (rank j holds shard j), the data axis over each rank's
    cards (as many as the rank with fewest has). Raises ValueError
    without DEACON_COORD: a pod never runs as one process in silence."""
    if not maybe_init_distributed():
        raise ValueError(
            "--mesh pod needs torch.distributed: set DEACON_COORD, "
            "DEACON_NUM_PROC and DEACON_PROC_ID on every rank"
        )
    nproc, rank = world()
    return _pod_mesh(local_devices(device), list(range(nproc)), rank)


def pod2d_shards(nproc: int) -> int:
    """DEACON_POD_SHARDS, checked to divide the number of ranks."""
    try:
        n_shard = int(os.environ.get("DEACON_POD_SHARDS", ""))
    except ValueError:
        n_shard = 0
    if n_shard <= 0 or nproc % n_shard:
        raise ValueError(
            "--mesh pod-2d requires DEACON_POD_SHARDS (index shards per "
            f"group) to divide DEACON_NUM_PROC; got shards={n_shard!r}, "
            f"nproc={nproc}"
        )
    return n_shard


def make_pod2d_group_mesh(device: str = "cuda") -> PodMesh:
    """The ``--mesh pod-2d`` mesh of this rank's group: groups of
    S = DEACON_POD_SHARDS consecutive ranks, the shard axis across the
    group's ranks (rank g*S + j holds shard j), the data axis over each
    rank's cards. Every group gets its own communicator."""
    nproc, rank = world()
    n_shard = pod2d_shards(nproc)
    if nproc > 1 and not maybe_init_distributed():
        raise ValueError(
            "--mesh pod-2d needs torch.distributed: set DEACON_COORD, "
            "DEACON_NUM_PROC and DEACON_PROC_ID on every rank"
        )
    group = rank // n_shard
    members = list(range(group * n_shard, (group + 1) * n_shard))
    return _pod_mesh(local_devices(device), members, rank)


def make_local_data_mesh(device: str = "cuda") -> Mesh:
    """The rank-local mesh of ``--mesh pod-data`` with
    DEACON_POD_LOCAL_MESH=DxS (reads over D rows of this rank's cards,
    the index cut over S; the CPU repeated on cpu). Without it: each card
    a data row holding the whole table."""
    devs = local_devices(device)
    spec = os.environ.get("DEACON_POD_LOCAL_MESH")
    if spec:
        n_data, n_shard = parse_mesh_spec(spec)
        if devs[0].type == "cpu":
            devs = devs * (n_data * n_shard)
        if n_data * n_shard > len(devs):
            raise ValueError(
                f"DEACON_POD_LOCAL_MESH={spec} needs {n_data * n_shard} local "
                f"devices, have {len(devs)}"
            )
    else:
        n_data, n_shard = len(devs), 1
    return make_mesh(n_data, n_shard, devs)
