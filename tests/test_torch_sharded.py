"""deacon_tpu_torch's sharded filter on the CPU against deacon_tpu's, exact.

* build_radix_shards for 1-4 shards: the blocks' slots concatenated are
  build_radix_table's slots, with the same p, spill table and sp, for a
  plain and a spilled index.
* The row order K2's kernel relies on, for build_radix_shards' blocks
  and for the JAX builder's tables through radix_table_from_jax: each
  row holds its bucket's keys ascending as u64 in its first slots and
  values of another bucket after them, and a bucket has spill keys only
  when its row is full, each above the row's last key.
* K2's plain version with a row range: the hits of the blocks of a table
  sum to the whole table's hits (spill matches count on one shard only).
* The port's DevicePipeline on 1x1, 2x4 and 4x2 meshes of the CPU against
  the JAX ShardedPipeline on 8 virtual CPU devices, on the inputs of
  tests/test_sharded.py (a 3000-base genome with chunked and below-k
  reads, a 600,000-base genome, a spilled index), singles and pairs; the
  1x1 mesh also against the one-card form, reruns included; and under
  DEACON_PALLAS=1 and DEACON_TPU_TILES=384:64,1152:16.
* make_mesh and parse_mesh_spec: the reference's messages, repeated
  devices, the card count.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from deacon_tpu.ops import radix_probe as jrp  # noqa: E402
from deacon_tpu.parallel import sharded as jsh  # noqa: E402
from deacon_tpu_torch.ops import kernels as tk  # noqa: E402
from deacon_tpu_torch.ops.engine import DevicePipeline  # noqa: E402
from deacon_tpu_torch.ops import minimizers_np as mnp  # noqa: E402
from deacon_tpu_torch.ops import radix_probe as trp  # noqa: E402
from deacon_tpu_torch.parallel import sharded as tsh  # noqa: E402
from tests.test_radix_probe import _index_with_spill  # noqa: E402

_B = np.frombuffer(b"ACGT", np.uint8)
_SWITCHES = ("DEACON_TPU_TILES", "DEACON_ENGINE", "DEACON_PALLAS")


def _i64(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


@pytest.fixture(scope="module")
def cases():
    """name -> (index hashes, single reads, pairs, JAX geometry
    (row_len, rows_per_shard)), seeded as tests/test_sharded.py is."""
    rng = np.random.default_rng(123)

    def rs(n):
        return rng.choice(_B, size=n).tobytes()

    def mixed(genome, n):
        out = []
        for _ in range(n):
            m = int(rng.integers(31, 600))
            if rng.random() < 0.5:
                s = int(rng.integers(0, len(genome) - m))
                out.append(genome[s:s + m])
            else:
                out.append(rs(m))
        return out

    out = {}
    g = rs(3000)
    seqs = [g[100:250], rs(150), g[0:60], b"A" * 80,
            g[500:1200],  # chunked
            rs(45), g[40:70],  # short and below k
            ] + [g[i * 37:i * 37 + 120] for i in range(10)]
    pairs = [(g[100:250], g[100:250]), (rs(100), g[700:850]),
             (rs(120), rs(130)), (g[50:95], b"A" * 40)]
    out["small"] = (np.unique(mnp.compute_minimizer_hashes(g, 31, 15)),
                    seqs, pairs, (256, 16))
    g = rs(600_000)
    seqs = mixed(g, 40) + [b"A" * 80]
    pairs = [(g[:100], g[60:160]), (rs(90), g[300:400])]
    out["radix"] = (np.unique(mnp.compute_minimizer_hashes(g, 31, 15)),
                    seqs, pairs, (256, 64))
    g = rs(400_000)
    allk, h = _index_with_spill(g)
    # reads holding the minimizer forced into the spill table: it must
    # count once, on the one shard owning its bucket
    hs, pos, _ = mnp.get_minimizer_hashes_and_positions(g, 0, 31, 15)
    at = int(pos[np.nonzero(hs == np.uint64(h))[0][0]])
    seqs = mixed(g, 40) + [g[max(0, at - 40):at + 90],
                           g[max(0, at - 200):at + 400]]
    pairs = [(g[:100], g[60:160]), (rs(90), g[300:400]),
             (g[max(0, at - 10):at + 120], rs(150))]
    out["spill"] = (allk, seqs, pairs, (256, 64))
    return out


@pytest.fixture(scope="module")
def jax_counts(cases):
    """(mesh, case) -> JAX ShardedPipeline (single, paired) counts."""
    got = {}
    for mesh in ((2, 4), (4, 2), (1, 1)):
        for name, (idx, seqs, pairs, (L, rs)) in cases.items():
            pipe = jsh.ShardedPipeline(idx, 31, 15, jsh.make_mesh(*mesh),
                                       row_len=L, rows_per_shard=rs)
            got[mesh, name] = (pipe.counts_single(seqs, 0),
                               pipe.counts_paired(pairs, 0))
    return got


def _assert_counts_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("mesh", [(2, 4), (4, 2), (1, 1)])
@pytest.mark.parametrize("name", ["small", "radix", "spill"])
def test_sharded_pipeline_matches_jax(cases, jax_counts, monkeypatch, mesh,
                                      name):
    for env in _SWITCHES:
        monkeypatch.delenv(env, raising=False)
    idx, seqs, pairs, (L, rs) = cases[name]
    pipe = DevicePipeline(idx, 31, 15, tiles=((L, rs),),
                          mesh=tsh.make_mesh(*mesh, ["cpu"] * 8))
    got = (pipe.counts_single(seqs, 0), pipe.counts_paired(pairs, 0))
    _assert_counts_equal(got, jax_counts[mesh, name])
    assert got[0][0].sum() > 0 and got[1][0].sum() > 0
    assert len(pipe.blocks) == mesh[0] and len(pipe.blocks[0]) == mesh[1]
    if name == "spill":
        assert all(t.sp > 0 for row in pipe.blocks for t in row)
    if mesh == (1, 1):
        # a 1x1 mesh is the one-card form: the same table, counts and
        # reruns, also of low-complexity rows over their slot budget
        # (which the JAX pipeline refuses)
        one = DevicePipeline(idx, 31, 15, tiles=((L, rs),), device="cpu")
        _assert_counts_equal(
            (one.counts_single(seqs, 0), one.counts_paired(pairs, 0)), got)
        low = [seqs[0] + b"A" * 600, b"AC" * 450, b"T" * 1000, seqs[1]]
        _assert_counts_equal([one.counts_single(low, 0)],
                             [pipe.counts_single(low, 0)])
        assert ((one.rerun_batches, one.rerun_units)
                == (pipe.rerun_batches, pipe.rerun_units) == (1, 2))
        assert torch.equal(one.blocks[0][0].slots, pipe.blocks[0][0].slots)


@pytest.mark.parametrize("env", [{"DEACON_PALLAS": "1"},
                                 {"DEACON_TPU_TILES": "384:64,1152:16"}])
@pytest.mark.parametrize("name", ["small", "radix", "spill"])
def test_sharded_pipeline_under_switch_matches_jax(cases, jax_counts,
                                                   monkeypatch, env, name):
    """Routes change the selection kernel, never the counts."""
    for e in _SWITCHES:
        monkeypatch.delenv(e, raising=False)
    for e, v in env.items():
        monkeypatch.setenv(e, v)
    idx, seqs, pairs, _ = cases[name]
    pipe = DevicePipeline(idx, 31, 15,
                          mesh=tsh.make_mesh(2, 4, ["cpu"] * 8))
    want_route = "K5" if "DEACON_PALLAS" in env else "K4"
    assert set(pipe.routes.values()) == {want_route}
    got = (pipe.counts_single(seqs, 0), pipe.counts_paired(pairs, 0))
    _assert_counts_equal(got, jax_counts[(2, 4), name])


@pytest.mark.parametrize("n_shard", [1, 2, 3, 4])
@pytest.mark.parametrize("spilled", [False, True])
def test_build_radix_shards_concatenate_to_whole_table(n_shard, spilled):
    rng = np.random.default_rng(40 + n_shard)
    if spilled:
        keys, _ = _index_with_spill(rng.choice(_B, 150_000).tobytes())
    else:
        keys = np.unique(rng.integers(0, 2**64, 60_000, dtype=np.uint64))
    whole = trp.build_radix_table(_i64(rng.permutation(keys)))
    assert (whole.sp > 0) == spilled
    shards = trp.build_radix_shards(keys, n_shard, ["cpu"] * n_shard)
    assert torch.equal(torch.cat([t.slots for t in shards]), whole.slots)
    rows = 1 << whole.p
    for j, t in enumerate(shards):
        assert (t.p, t.sp, t.row_lo) == (whole.p, whole.sp,
                                         j * rows // n_shard)
        assert t.slots.shape[0] == (j + 1) * rows // n_shard - t.row_lo
        if spilled:
            assert torch.equal(t.spill, whole.spill)
        else:
            assert t.spill is None
    assert sum(t.n_keys for t in shards) == keys.size == whole.n_keys
    # unsorted keys with repeats give the same blocks
    again = trp.build_radix_shards(
        _i64(np.concatenate([keys[::-1], keys[:50]])), n_shard,
        ["cpu"] * n_shard)
    for a, b in zip(again, shards):
        assert torch.equal(a.slots, b.slots) and a.row_lo == b.row_lo


def _row_keys(slots, bits, row_lo=0):
    """Keys per row of a (rows, 128) slot block of bucket rows row_lo..,
    after checking the order K2's kernel relies on: a row's keys (slots
    whose bucket is the row's) fill its first slots, ascending as u64."""
    s = slots.numpy().view(np.uint64)
    own = (s >> np.uint64(64 - bits)) == np.arange(
        row_lo, row_lo + s.shape[0], dtype=np.uint64)[:, None]
    c = own.sum(axis=1)
    np.testing.assert_array_equal(own, np.arange(s.shape[1]) < c[:, None])
    assert ((s[:, 1:] > s[:, :-1]) | ~own[:, 1:]).all()
    return c


def _assert_spill_only_past_full_rows(slots, p, spill, sp, c):
    """Every spill key's main row is full and holds only smaller keys."""
    s = slots.numpy().view(np.uint64)
    sk = spill.numpy().view(np.uint64)
    sk = sk[(sk >> np.uint64(64 - sp))
            == np.arange(1 << sp, dtype=np.uint64)[:, None]]
    b = (sk >> np.uint64(64 - p)).astype(np.int64)
    assert sk.size > 0
    assert (c[b] == 128).all() and (sk > s[b, 127]).all()


@pytest.mark.parametrize("n_shard", [1, 2, 3, 4])
@pytest.mark.parametrize("spilled", [False, True])
def test_build_radix_shards_rows_hold_keys_ascending_then_fillers(
        n_shard, spilled):
    rng = np.random.default_rng(70 + n_shard)
    if spilled:
        keys, _ = _index_with_spill(rng.choice(_B, 150_000).tobytes())
    else:
        keys = np.unique(rng.integers(0, 2**64, 60_000, dtype=np.uint64))
    shards = trp.build_radix_shards(keys, n_shard, ["cpu"] * n_shard)
    t = shards[0]
    c = np.concatenate([_row_keys(x.slots, t.p, x.row_lo) for x in shards])
    if spilled:
        n_spill = int(_row_keys(t.spill, t.sp).sum())
        _assert_spill_only_past_full_rows(
            torch.cat([x.slots for x in shards]), t.p, t.spill, t.sp, c)
    else:
        n_spill = 0
        assert t.spill is None and (c < 128).all()
    assert int(c.sum()) + n_spill == keys.size


@pytest.mark.parametrize("case", ["small", "plain", "spill"])
def test_radix_table_from_jax_rows_hold_keys_ascending_then_fillers(case):
    rng = np.random.default_rng(80)
    if case == "small":
        keys = rng.integers(0, 2**64, 40, dtype=np.uint64)
    elif case == "plain":
        keys = rng.integers(0, 2**64, 150_000, dtype=np.uint64)
    else:
        keys, _ = _index_with_spill(rng.choice(_B, 150_000).tobytes())
    jt = jrp.build_radix_table(keys)
    t = trp.radix_table_from_jax(jt.planes, jt.p, jt.k, jt.spill, jt.sp)
    c = _row_keys(t.slots, t.p)
    assert (case == "spill") == (t.sp > 0)
    if t.sp:
        _row_keys(t.spill, t.sp)
        _assert_spill_only_past_full_rows(t.slots, t.p, t.spill, t.sp, c)
    assert t.n_keys == np.unique(keys).size

@pytest.mark.parametrize("n_shard", [1, 2, 3, 4])
def test_k2_plain_row_ranges_sum_to_whole_table(n_shard):
    rng = np.random.default_rng(50 + n_shard)
    keys, h = _index_with_spill(rng.choice(_B, 150_000).tobytes())
    whole = trp.build_radix_table(_i64(keys))
    assert whole.sp > 0
    R, Br, nseg = 64, 128, 32
    qk = np.where(rng.random((R, Br)) < 0.5, rng.choice(keys, size=(R, Br)),
                  rng.integers(0, 2**64, (R, Br), dtype=np.uint64))
    qk[3, :5] = h  # a key that spilled: counts once, on one shard
    valid = rng.random((R, Br)) < 0.7
    valid[3, :5] = True
    rid = torch.arange(R, dtype=torch.int32) // 2
    key, srid, first = trp.prep_sorted(_i64(qk), torch.from_numpy(valid),
                                       rid[:, None].expand(R, Br))
    kw = dict(p=whole.p, sp=whole.sp, num_segments=nseg)
    want = tk.probe_hits_plain(whole.slots, whole.spill, key, srid, first,
                               **kw)
    shards = trp.build_radix_shards(keys, n_shard, ["cpu"] * n_shard)
    per = [tk.probe_hits(t.slots, t.spill, key, srid, first,
                         row_lo=t.row_lo, **kw) for t in shards]
    assert torch.equal(sum(per), want)
    assert int(want[1]) >= 1 and int(want.sum()) > nseg
    if n_shard > 1:
        assert sum(int(x.sum()) > 0 for x in per) > 1
    grid = trp.radix_probe_hits(shards, _i64(qk), torch.from_numpy(valid),
                                rid[:, None].expand(R, Br),
                                num_segments=nseg)
    assert torch.equal(grid, want)


def test_probe_hits_rejects_a_block_outside_the_table():
    t = trp.build_radix_table(torch.arange(100, dtype=torch.int64))
    q = torch.zeros(4, dtype=torch.int64)
    q32 = q.to(torch.int32)
    rows = 1 << t.p
    for row_lo, block in ((1, t.slots), (-1, t.slots[:4]),
                          (rows - 2, t.slots[:4]), (0, t.slots[:0])):
        with pytest.raises(ValueError):
            tk.probe_hits(block, None, q, q32, q32, p=t.p, sp=0,
                          num_segments=1, row_lo=row_lo)
    got = tk.probe_hits(t.slots[4:8], None, q, q32, q32, p=t.p, sp=0,
                        num_segments=1, row_lo=4)
    assert got.tolist() == [0]


def test_one_card_row_cap_names_the_mesh(monkeypatch):
    keys = _i64(np.random.default_rng(9).integers(0, 2**64, 20_000,
                                                  dtype=np.uint64))
    p = trp.choose_p(keys.numel())
    monkeypatch.setattr(trp, "MAX_LOG2_BUCKETS", p - 2)
    with pytest.raises(NotImplementedError, match="--mesh 1xN"):
        trp.build_radix_table(keys)
    shards = trp.build_radix_shards(keys, 4, ["cpu"] * 4)
    assert [t.slots.shape[0] for t in shards] == [1 << (p - 2)] * 4
    with pytest.raises(NotImplementedError, match="more shards"):
        trp.build_radix_shards(keys, 3, ["cpu"] * 3)


def test_parse_and_make_mesh(monkeypatch):
    assert tsh.parse_mesh_spec("2x4") == jsh.parse_mesh_spec("2x4") == (2, 4)
    assert tsh.parse_mesh_spec("1X3") == (1, 3)
    for bad in ("2y4", "0x2", "x", "2x4x1", "pod"):
        with pytest.raises(ValueError) as port:
            tsh.parse_mesh_spec(bad)
        with pytest.raises(ValueError) as ref:
            jsh.parse_mesh_spec(bad)
        assert str(port.value) == str(ref.value)
    mesh = tsh.make_mesh(2, 3, ["cpu"] * 7)
    assert mesh.shape == {"data": 2, "shard": 3}
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
    with pytest.raises(ValueError, match="need 8 devices, have 6"):
        tsh.make_mesh(2, 4, ["cpu"] * 6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tsh.make_mesh(1, 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = tsh.make_mesh(2, 2)
    assert [[str(d) for d in row] for row in mesh.devices] == [
        ["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]


def test_batches_go_round_robin_over_data_rows(cases, monkeypatch):
    idx, seqs, _, _ = cases["radix"]
    pipe = DevicePipeline(idx, 31, 15, tiles=((256, 8),),
                          mesh=tsh.make_mesh(3, 2, ["cpu"] * 6))
    seen = []
    step = pipe._step

    def spy(rows, L, n_units, budget, device, tables):
        seen.append(next(d for d in range(3) if tables is pipe.blocks[d]))
        return step(rows, L, n_units, budget, device, tables)

    monkeypatch.setattr(pipe, "_step", spy)
    pipe.counts_single(seqs, 0)
    assert len(seen) >= 6 and seen[:6] == [0, 1, 2, 0, 1, 2]
    # one block per (device, shard): the rows share the CPU's blocks
    assert all(pipe.blocks[d][j] is pipe.blocks[0][j]
               for d in range(3) for j in range(2))
