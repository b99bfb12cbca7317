"""The pod server's probe (server/app.PodProbe) on ranks of two data
rows, and the row search it shares with ``server --mesh DATAxSHARD``
(ops/engine.probe_rows), against deacon_tpu on the CPU, exact.

* Two gloo ranks, each a pod mesh of two CPU data rows (the
  ``_TWO_ROWS_MESH`` hook of tests/test_torch_pod.py, the shape of a rank
  that drives two cards), through the server's own probe constructor:
  each rank holds its value range once a row (``nbytes`` twice one
  row's, each copy exactly ``shard_value_range``'s keys); rank 0's
  answers to queries of 0, 1, 2, 3 and 100,000 hashes (members of each
  range, non-members, 0, 2**64 - 1 and both sides of each range edge)
  equal the JAX ``DeviceHashProbe`` on a data=2 x shard=2 mesh of
  virtual CPU devices and ``MinimizerIndex.contains``; each rank issues
  one size broadcast, one hash broadcast and one all-reduce a query, in
  that order, and searches a row only where the row's part is not
  empty.
* probe_rows over (data x shard) layouts with uneven and empty parts
  and a shard with no keys, against np.isin.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deacon_tpu.index.store import load_index as jax_load_index  # noqa: E402
from deacon_tpu.index.store import load_index_shard as jax_shard  # noqa: E402
from deacon_tpu.ops.engine import DeviceHashProbe as JaxProbe  # noqa: E402
from deacon_tpu.parallel.sharded import make_mesh as jax_mesh  # noqa: E402
from deacon_tpu_torch.index.store import (  # noqa: E402
    IndexHeader,
    shard_value_range,
    write_index,
)
from deacon_tpu_torch.ops.engine import DeviceHashProbe, probe_rows  # noqa: E402
from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes  # noqa: E402
from tests.test_torch_pod import (  # noqa: E402
    _TWO_ROWS_MESH,
    REPO,
    _env,
    _free_port,
    _wait_all,
)

_B = np.frombuffer(b"ACGT", np.uint8)
_TOP = (1 << 64) - 1

#: one rank of the pod server's probe on two CPU data rows: rank 0 asks
#: the probe each query of QUERIES (an .npz), rank 1 mirrors its probes
#: (probe_worker_loop); each saves what its rows hold, the searches each
#: row ran, its collectives in order and rank 0's answers to OUT.RANK.npz
_PROBE_RANK = _TWO_ROWS_MESH + """
import numpy as np

from deacon_tpu_torch.ops.engine import DeviceHashProbe

index_path, queries, out = sys.argv[1:]
log, searches = [], {}
broadcast = multihost.PodMesh.broadcast
all_reduce = multihost.PodMesh.sum_over_shards
launch = DeviceHashProbe.launch


def logged_broadcast(self, arr):
    log.append(f"broadcast {arr.size}")
    return broadcast(self, arr)


def logged_all_reduce(self, hits):
    log.append(f"all-reduce {hits.size}")
    return all_reduce(self, hits)


def counted_launch(self, hashes):
    if len(hashes) and len(self):
        searches[id(self)] = searches.get(id(self), 0) + 1
    return launch(self, hashes)


multihost.PodMesh.broadcast = logged_broadcast
multihost.PodMesh.sum_over_shards = logged_all_reduce
DeviceHashProbe.launch = counted_launch
probe = app._make_probe(index_path, "cpu", "pod")()
answers = {}
if probe.mesh.shard == 0:
    with np.load(queries) as qs:
        for name in qs.files:
            answers["bits_" + name] = probe(qs[name])
    probe.shutdown()
else:
    app.probe_worker_loop(probe)
multihost.leave_distributed()
held = {f"keys{i}": (p.flipped.numpy() ^ np.int64(-1 << 63)).view(np.uint64)
        for i, p in enumerate(probe.probes)}
np.savez(f"{out}.{probe.mesh.shard}.npz", nbytes=probe.nbytes,
         log=np.array(log), searches=np.array(
             [searches.get(id(p), 0) for p in probe.probes]),
         **held, **answers)
"""


def _edges(n_shard: int) -> np.ndarray:
    """Both sides of every value range's bounds, 0 and 2**64 - 1."""
    out = {0, _TOP}
    for i in range(n_shard):
        lo, hi = shard_value_range(i, n_shard)
        out |= {lo - 1, lo, hi - 1, hi}
    return np.array(sorted(v for v in out if 0 <= v <= _TOP), np.uint64)


@pytest.fixture(scope="module")
def pod_index(tmp_path_factory):
    """An index whose keys sit in both halves of the u64 range, on both
    sides of the halves' edge and at 2**64 - 1; and the queries."""
    tmp = tmp_path_factory.mktemp("torch_pod_server")
    rng = np.random.default_rng(4242)
    keys = compute_minimizer_hashes(rng.choice(_B, 40_000).tobytes(), 31, 15)
    keys = np.unique(np.concatenate([keys, np.array(
        [(1 << 63) - 1, 1 << 63, _TOP, 5], np.uint64)]))
    path = tmp / "pod.idx"
    write_index(keys, IndexHeader.new(31, 15), path)
    edges = _edges(2)
    low, high = keys[keys < (1 << 63)], keys[keys >= (1 << 63)]
    assert low.size > 100 and high.size > 100
    big = np.concatenate([
        rng.choice(low, 30_000), rng.choice(high, 30_000),
        rng.integers(0, _TOP, 30_000, dtype=np.uint64, endpoint=True),
        keys + np.uint64(1), keys - np.uint64(1), np.tile(edges, 50)])
    big = rng.permutation(big)[:100_000]
    assert big.size == 100_000
    first = np.array([(1 << 63) - 1, 1 << 63, 0], np.uint64)
    queries = {"n0": np.zeros(0, np.uint64), "n1": first[:1],
               "n2": first[:2], "n3": first[:3], "n100000": big}
    np.savez(tmp / "queries.npz", **queries)
    return tmp, path, keys, queries


def test_pod_probe_two_ranks_two_rows_match_jax(pod_index):
    tmp, path, keys, queries = pod_index
    port = _free_port()
    procs = []
    for r in range(2):
        env = _env({"DEACON_COORD": f"127.0.0.1:{port}",
                    "DEACON_NUM_PROC": 2, "DEACON_PROC_ID": r})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _PROBE_RANK, str(path),
             str(tmp / "queries.npz"), str(tmp / "got")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
            env=env))
    rcs, errs = _wait_all(procs)
    assert rcs == [0, 0], errs
    jax_probe = JaxProbe.from_index_file(str(path), mesh=jax_mesh(2, 2))
    index = jax_load_index(str(path))
    sizes = [q.size for q in queries.values() if q.size]
    for r in range(2):
        assert "Index sharded on pod mesh data=2 x shard=2" in errs[r]
        assert (f"Pod rank {r} holds value range {r} of 2 on each card: "
                in errs[r])
        with np.load(tmp / f"got.{r}.npz") as got:
            want = jax_shard(str(path), r, 2)[1]
            lo, hi = shard_value_range(r, 2)
            np.testing.assert_array_equal(
                want, keys[(keys >= lo) & (keys <= hi - 1)])
            for row in range(2):
                np.testing.assert_array_equal(got[f"keys{row}"], want)
            assert int(got["nbytes"]) == 2 * 8 * want.size
            # n1 leaves row 1 an empty part: no search there
            assert got["searches"].tolist() == [len(sizes), len(sizes) - 1]
            # a size, the hashes, the bits' sum a query; the close's 0
            assert got["log"].tolist() == [
                *(x for n in sizes for x in (
                    "broadcast 1", f"broadcast {n}", f"all-reduce {n}")),
                "broadcast 1"]
            if r:
                continue
            for name, q in queries.items():
                bits = got["bits_" + name]
                assert bits.dtype == bool and bits.shape == q.shape
                np.testing.assert_array_equal(bits, jax_probe(q))
                np.testing.assert_array_equal(bits, index.contains(q))
    big = queries["n100000"]
    member = index.contains(big)
    assert member.any() and not member.all()
    for r in range(2):
        lo, hi = shard_value_range(r, 2)
        assert member[(big >= lo) & (big <= hi - 1)].any()


@pytest.mark.parametrize("layout", [(1, 1), (2, 1), (3, 2), (4, 3)])
@pytest.mark.parametrize("size", [0, 1, 2, 5, 1001])
def test_probe_rows_uneven_and_empty_parts_match_isin(layout, size):
    """probe_rows over n_data rows of n_shard value-range probes (the
    last range holds no keys when n_shard is 3): a part per row, empty
    where the rows outnumber the hashes, each part's bits ORed over its
    row's shards, in the hashes' order."""
    n_data, n_shard = layout
    rng = np.random.default_rng(size * 10 + n_data)
    keys = np.unique(rng.integers(0, _TOP, 3000, dtype=np.uint64,
                                  endpoint=True))
    if n_shard == 3:
        keys = keys[keys < shard_value_range(2, 3)[0]]
    ranges = []
    for j in range(n_shard):
        lo, hi = shard_value_range(j, n_shard)
        ranges.append(keys[(keys >= lo) & (keys <= hi - 1)])
    assert sum(r.size > 0 for r in ranges) == min(n_shard, 2)
    rows = [[DeviceHashProbe(r, "cpu") for r in ranges]
            for _ in range(n_data)]
    q = np.concatenate([rng.choice(keys, size), rng.integers(
        0, _TOP, size, dtype=np.uint64, endpoint=True)])
    q = rng.permutation(q)[:size]
    got = probe_rows(rows, q)
    assert got.dtype == bool and got.shape == (size,)
    np.testing.assert_array_equal(got, np.isin(q, keys))
    # an empty part or range launches nothing: its answer is on the host
    assert isinstance(rows[0][0].launch(q[:0]), np.ndarray)
    empty = DeviceHashProbe(np.zeros(0, np.uint64), "cpu")
    assert isinstance(empty.launch(q), np.ndarray)
    assert isinstance(rows[0][0].launch(keys[:1]), torch.Tensor)
