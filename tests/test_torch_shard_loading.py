"""Shard loading of the port (index/store.py, radix_probe.
build_radix_blocks_from_file) and its per-process pipeline
(ops/engine.DevicePipeline over one rank's PodMesh) against deacon_tpu,
on the CPU, exact.

* shard_value_range and load_index_shard equal the JAX package's for
  N = 1-4 shards, on a sorted file and on an unsorted file with
  duplicates; the [lo, hi) loader's pieces reassemble the index.
* A pipeline built rank by rank (each "rank" a DevicePipeline over a
  PodMesh, holding only its block, built from the file's keys of its
  rows) gives, batch by batch, hits whose sum over the ranks is the
  one-process 1xS mesh pipeline's and the JAX package's
  DevicePipeline's, with equal
  totals, for S = 2 and S = 3 (uneven row ranges) and a spilled index.
* The agreement point, with ranks as threads: an error in one rank
  raises in all, and the retry at p + 1 (a spill that cannot be packed)
  happens in all, giving build_radix_shards' rows.
"""

import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from deacon_tpu.index import store as jstore  # noqa: E402
from deacon_tpu.ops.engine import DevicePipeline as JaxPipeline  # noqa: E402
from deacon_tpu_torch.index import store as tstore  # noqa: E402
from deacon_tpu_torch.ops import minimizers_np as mnp  # noqa: E402
from deacon_tpu_torch.ops.engine import DevicePipeline  # noqa: E402
from deacon_tpu_torch.ops import radix_probe as trp  # noqa: E402
from deacon_tpu_torch.parallel import sharded as tsh  # noqa: E402
from deacon_tpu_torch.parallel.multihost import PodMesh  # noqa: E402
from deacon_tpu_torch.utils import bincode  # noqa: E402
from tests.test_radix_probe import _index_with_spill  # noqa: E402

_B = np.frombuffer(b"ACGT", np.uint8)
TILES = ((256, 64),)


def _write_unsorted(path, vals):
    """A reference-style index file: keys unsorted, with duplicates."""
    with open(path, "wb") as f:
        f.write(bytes([2, 31, 15]) + bincode.encode_uint(vals.size))
        f.write(b"".join(bincode.encode_uint(int(x)) for x in vals))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_shards")
    rng = np.random.default_rng(7)
    keys = mnp.compute_minimizer_hashes(rng.choice(_B, 20_000).tobytes(),
                                        31, 15)
    keys = np.concatenate([keys, rng.integers(0, 1 << 63, 200,
                                              dtype=np.uint64)])
    tstore.write_index(keys, tstore.IndexHeader.new(31, 15),
                       tmp / "sorted.idx")
    shuffled = rng.permutation(np.concatenate([keys, keys[:300]]))
    _write_unsorted(tmp / "unsorted.idx", shuffled)
    return tmp, np.unique(keys)


def test_shard_value_range_matches_jax():
    for n in (1, 2, 3, 4, 7):
        for i in range(n):
            assert (tstore.shard_value_range(i, n)
                    == jstore.shard_value_range(i, n))
    with pytest.raises(ValueError, match="out of range"):
        tstore.shard_value_range(3, 3)


@pytest.mark.parametrize("name", ["sorted", "unsorted"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_load_index_shard_matches_jax(files, name, n_shards):
    tmp, want = files
    path = tmp / f"{name}.idx"
    parts = []
    for i in range(n_shards):
        h, got, count = tstore.load_index_shard(path, i, n_shards,
                                                chunk=997)
        jh, ref, jcount = jstore.load_index_shard(path, i, n_shards,
                                                  chunk=997)
        assert (h.kmer_length, h.window_size) == (jh.kmer_length,
                                                  jh.window_size)
        assert count == jcount
        np.testing.assert_array_equal(got, ref)
        parts.append(got)
    np.testing.assert_array_equal(np.concatenate(parts), want)


@pytest.mark.parametrize("name", ["sorted", "unsorted"])
def test_range_loader_pieces_reassemble(files, name):
    tmp, want = files
    rng = np.random.default_rng(3)
    cuts = [0, *sorted(int(x) for x in rng.integers(0, 1 << 64, 5,
                                                     dtype=np.uint64)),
            1 << 64]
    got = [tstore.load_index_range(tmp / f"{name}.idx", lo, hi,
                                   chunk=1000)[1]
           for lo, hi in zip(cuts, cuts[1:])]
    np.testing.assert_array_equal(np.concatenate(got), want)
    assert tstore.load_index_range(tmp / f"{name}.idx", 5, 5)[1].size == 0


class _AloneMesh(PodMesh):
    """One rank of a simulated pod: the sums over ranks are the test's."""

    def sum_over_shards(self, hits):
        return hits

    def agree_max(self, flags):
        return flags


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(123)
    out = {}
    for name, n in (("small", 3000), ("spill", 400_000)):
        g = rng.choice(_B, n).tobytes()
        if name == "spill":
            keys, _ = _index_with_spill(g)
        else:
            keys = np.unique(mnp.compute_minimizer_hashes(g, 31, 15))
        seqs = []
        for _ in range(60):
            m = int(rng.integers(31, 600))
            s = int(rng.integers(0, len(g) - m))
            seqs.append(g[s:s + m] if rng.random() < 0.6
                        else rng.choice(_B, m).tobytes())
        seqs += [g[:1200], b"A" * 80, g[10:40]]
        pairs = [(seqs[i], seqs[i + 1]) for i in range(0, 40, 2)]
        out[name] = keys, seqs, pairs
    return out


@pytest.mark.parametrize("n_shard", [2, 3])
@pytest.mark.parametrize("name", ["small", "spill"])
def test_rank_by_rank_pipeline_matches_one_process_and_jax(
        tmp_path, reads, name, n_shard):
    keys, seqs, pairs = reads[name]
    path = tmp_path / "i.idx"
    tstore.write_index(keys, tstore.IndexHeader.new(31, 15), path)
    cpu = torch.device("cpu")
    ranks = [DevicePipeline(str(path), 31, 15, tiles=TILES,
                            mesh=_AloneMesh(((cpu,),), n_shard=n_shard,
                                            shard=j))
             for j in range(n_shard)]
    p = trp.choose_p(keys.size)
    for j, pipe in enumerate(ranks):
        t = pipe.blocks[0][0]
        assert (t.row_lo, t.row_lo + t.slots.shape[0]) == trp.shard_rows(
            j, n_shard, p)
    whole = DevicePipeline(keys, 31, 15, tiles=TILES,
                           mesh=tsh.make_mesh(1, n_shard, ["cpu"] * n_shard))
    jpipe = JaxPipeline(keys, 31, 15, tiles=TILES)
    batches = [("single", seqs[:30]), ("single", seqs[30:]),
               ("paired", pairs)]
    for kind, batch in batches:
        if kind == "single":
            per = [r.counts_single(batch, 0) for r in ranks]
            one = whole.counts_single(batch, 0)
            ref = jpipe.counts_single(batch, 0)
        else:
            per = [r.counts_paired(batch, 0) for r in ranks]
            one = whole.counts_paired(batch, 0)
            ref = jpipe.counts_paired(batch, 0)
        hits = sum(h for h, _ in per)
        np.testing.assert_array_equal(hits, one[0])
        np.testing.assert_array_equal(hits, ref[0])
        for _, totals in per:
            np.testing.assert_array_equal(totals, ref[1])
    assert sum(h.sum() for h, _ in per) > 0
    if name == "spill":
        assert any(r.blocks[0][0].sp > 0 for r in ranks)
    # --debug's probe: the ranks' bits, summed, are membership
    q = np.concatenate([keys[::7], np.arange(1, 100, dtype=np.uint64)])
    member = sum(r.probe_hashes(q).astype(int) for r in ranks)
    np.testing.assert_array_equal(member > 0, np.isin(q, keys))
    assert member.max() == 1


def _thread_agree(n):
    """agree_max for n ranks running as threads: a barrier-synchronised
    element-wise max."""
    slots = [None] * n
    barrier = threading.Barrier(n)

    def make(j):
        def agree(flags):
            slots[j] = list(flags)
            barrier.wait()
            out = [max(col) for col in zip(*slots)]
            barrier.wait()
            return out
        return agree

    return [make(j) for j in range(n)]


def _run_ranks(fn, n):
    results, threads = [None] * n, []
    agrees = _thread_agree(n)

    def body(j):
        try:
            results[j] = fn(j, agrees[j])
        except Exception as e:  # noqa: BLE001 - the test reads it
            results[j] = e

    for j in range(n):
        threads.append(threading.Thread(target=body, args=(j,)))
        threads[-1].start()
    for t in threads:
        t.join(60)
    return results


def test_agreement_raises_in_every_rank(files, tmp_path):
    tmp, _ = files
    good, bad = str(tmp / "sorted.idx"), str(tmp_path / "missing.idx")
    cpu = torch.device("cpu")
    out = _run_ranks(
        lambda j, agree: trp.build_radix_blocks_from_file(
            good if j == 0 else bad, 2, {j: cpu}, agree=agree), 2)
    assert isinstance(out[1], FileNotFoundError)
    assert isinstance(out[0], RuntimeError)
    assert "a peer process failed" in str(out[0])


def test_retry_at_p_plus_one_in_every_rank(tmp_path):
    """300 keys in one bucket at choose_p's p: their spill keys share the
    top 9 bits, so no spill table holds them until p has grown past the
    bits they share; every rank retries together and the rows equal
    build_radix_shards'."""
    rng = np.random.default_rng(5)
    top = np.uint64(0xABCDE) << np.uint64(44)
    skew = top | rng.integers(0, 1 << 44, 300, dtype=np.uint64)
    keys = np.unique(np.concatenate([
        skew, rng.integers(0, 1 << 64, 2000, dtype=np.uint64)]))
    path = str(tmp_path / "skew.idx")
    tstore.write_index(keys, tstore.IndexHeader.new(31, 15), path)
    cpu = torch.device("cpu")
    out = _run_ranks(
        lambda j, agree: trp.build_radix_blocks_from_file(
            path, 2, {j: cpu}, agree=agree)[j], 2)
    whole = trp.build_radix_shards(keys, 2, [cpu, cpu])
    assert whole[0].p > trp.choose_p(keys.size)
    for j in range(2):
        assert out[j].p == whole[j].p
        assert out[j].row_lo == whole[j].row_lo
        torch.testing.assert_close(out[j].slots, whole[j].slots, rtol=0,
                                   atol=0)
        assert out[j].n_keys == whole[j].n_keys


@pytest.mark.parametrize("n_shard", [1, 3])
def test_blocks_filled_piece_by_piece_equal_one_piece(files, monkeypatch,
                                                      n_shard):
    """fill_block's pieces of FILL_PIECE_ROWS rows (here 3, so a block
    takes many) give the rows and the overflow of one whole fill, from
    keys in memory and from the file alike."""
    tmp, keys = files
    cpu = torch.device("cpu")
    whole = trp.build_radix_shards(keys, n_shard, [cpu] * n_shard)
    from_file = trp.build_radix_blocks_from_file(
        str(tmp / "sorted.idx"), n_shard, dict.fromkeys(range(n_shard), cpu))
    monkeypatch.setattr(trp, "FILL_PIECE_ROWS", 3)
    pieces = trp.build_radix_shards(keys, n_shard, [cpu] * n_shard)
    p = trp.choose_p(keys.size)
    for j in range(n_shard):
        r0, r1 = trp.shard_rows(j, n_shard, p)
        lo = trp._row_start(torch.from_numpy(keys.view(np.int64)), p, r0)
        hi = trp._row_start(torch.from_numpy(keys.view(np.int64)), p, r1)
        got, over = trp.fill_block(keys[lo:hi], p, r0, r1, cpu)
        want, want_over = trp._fill_slots(
            torch.from_numpy(keys[lo:hi].view(np.int64)), p, r0, r1 - r0)
        assert torch.equal(got, want) and torch.equal(over, want_over)
        for t in (pieces[j], from_file[j]):
            assert torch.equal(t.slots, whole[j].slots)
            assert t.row_lo == whole[j].row_lo and t.p == whole[j].p
