"""K1-K5 on the card against their plain PyTorch versions, exact (K2 in
its sharded form too, its blocks' hits summing to the whole table's), and
the pipeline, the sharded pipeline and the index build on the card
against the CPU or the unsharded pipeline, under the engine's switches
too.

Marked ``cuda``: each test asks a fixture whether a card is present and
skips without one (the decision is never taken at import or collection,
so every pytest-xdist worker collects the same tests). On a machine with
an H100: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from deacon_tpu_torch.ops import kernels as tk
from deacon_tpu_torch.ops import pack as tpack
from deacon_tpu_torch.ops import radix_probe as trp
from deacon_tpu_torch.ops.engine import DevicePipeline

pytestmark = pytest.mark.cuda

_B = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _tile(rng, R, L, k, w):
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    validb = rng.random((R, L)) > 0.03
    mlen = rng.integers(-1, L - k + 2, (R,)).astype(np.int32)
    mlen[0] = L - k + 1
    mlen[2] = max(1, w - 2)
    allow = rng.random(R) > 0.5
    allow[2] = True
    c = codes.reshape(R, L // 4, 4)
    pc = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)
    pv = np.packbits(validb, axis=1, bitorder="little")
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (pc, pv, mlen, allow)]


@pytest.mark.parametrize("k,w,L,R", [(31, 15, 256, 64), (32, 7, 2048, 16),
                                     (21, 11, 16384, 8), (5, 3, 128, 8),
                                     (31, 15, 16384, 512)])
def test_k1_kernel_matches_plain(cuda, k, w, L, R):
    rng = np.random.default_rng(k + w + L)
    Br = tpack.v4_row_budget(L, w, tpack.default_budget_frac(w))
    args = [a.to(cuda) for a in _tile(rng, R, L, k, w)]
    pos, val, tot = tk.select_compact(*args, k=k, w=w, Br=Br)
    ppos, pval, ptot = tk.select_compact_plain(*args, k=k, w=w, Br=Br)
    torch.cuda.synchronize()
    assert torch.equal(tot, ptot)
    live = torch.arange(Br, device=cuda)[None, :] < tot.clamp(max=Br)[:, None]
    assert torch.equal(pos[live], ppos[live])
    assert torch.equal(val[live], pval[live])


@pytest.mark.parametrize("k,w,L,R", [(41, 15, 256, 64), (56, 9, 2048, 16),
                                     (57, 15, 16384, 8), (31, 15, 2048, 16),
                                     (41, 15, 16384, 512)])
def test_k3_kernel_matches_plain(cuda, k, w, L, R):
    rng = np.random.default_rng(k + w + L + 1)
    args = [a.to(cuda) for a in _tile(rng, R, L, k, w)]
    got = tk.values_select(*args, k=k, w=w)
    want = tk.values_select_plain(*args, k=k, w=w)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert int((got[2] >> 16).sum()) > 0


@pytest.mark.parametrize("k,w,L,R", [(31, 15, 384, 4096), (31, 15, 1152, 64),
                                     (31, 15, 12288, 32), (15, 5, 1152, 16),
                                     (32, 7, 256, 8), (5, 3, 128, 8)])
def test_k4_kernel_matches_plain(cuda, k, w, L, R):
    rng = np.random.default_rng(k + w + L + 2)
    args = [a.to(cuda) for a in _tile(rng, R, L, k, w)]
    got = tk.select_csum(*args, k=k, w=w)
    want = tk.select_csum_plain(*args, k=k, w=w)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("k,w,L,R", [(31, 15, 256, 64), (41, 15, 2048, 16),
                                     (56, 9, 2048, 16), (21, 11, 16384, 8),
                                     (41, 15, 16384, 64), (5, 3, 128, 8)])
def test_k5_kernel_matches_plain(cuda, k, w, L, R):
    rng = np.random.default_rng(k + w + L + 3)
    pc, _, mlen, _ = [a.to(cuda) for a in _tile(rng, R, L, k, w)]
    planes, wp = tk.values_argmin(pc, mlen, k=k, w=w)
    pplanes, pwp = tk.values_argmin_plain(pc, mlen, k=k, w=w)
    torch.cuda.synchronize()
    assert len(planes) == len(pplanes) == (1 if k <= 32 else 2)
    assert torch.equal(wp, pwp)
    for g, w_ in zip(planes, pplanes):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("spill", [False, True])
def test_k2_kernel_matches_plain(cuda, spill):
    g = torch.Generator(device=cuda).manual_seed(7)
    keys = torch.randint(-(1 << 63), (1 << 63) - 1, (1 << 20,), device=cuda,
                         dtype=torch.int64, generator=g)
    if spill:
        top = keys[3] & ~((1 << 36) - 1)
        keys = torch.cat([keys, top | torch.randint(
            0, 1 << 36, (180,), device=cuda, generator=g)])
    t = trp.build_radix_table(keys)
    assert (t.sp > 0) == spill
    R, Br = 512, 384
    pick = torch.randint(0, keys.numel(), (R * Br,), device=cuda, generator=g)
    other = torch.randint(-(1 << 63), (1 << 63) - 1, (R * Br,), device=cuda,
                          dtype=torch.int64, generator=g)
    coin = torch.rand(R * Br, device=cuda, generator=g) < 0.5
    hashes = torch.where(coin, keys[pick], other).reshape(R, Br)
    valid = torch.rand((R, Br), device=cuda, generator=g) < 0.67
    rid = torch.arange(R, device=cuda, dtype=torch.int32) // 4
    key, srid, first = trp.prep_sorted(hashes, valid,
                                       rid[:, None].expand(R, Br))
    kw = dict(p=t.p, sp=t.sp, num_segments=R // 4)
    got = tk.probe_hits(t.slots, t.spill, key, srid, first, **kw)
    want = tk.probe_hits_plain(t.slots, t.spill, key, srid, first, **kw)
    assert torch.equal(got, want)
    assert int(want.sum()) > 0


@pytest.mark.parametrize("n_shard", [3, 4])
def test_k2_sharded_kernel_matches_plain_and_whole_table(cuda, n_shard):
    g = torch.Generator(device=cuda).manual_seed(11)
    keys = torch.randint(-(1 << 63), (1 << 63) - 1, (1 << 20,), device=cuda,
                         dtype=torch.int64, generator=g)
    top = keys[5] & ~((1 << 36) - 1)
    keys = torch.cat([keys, top | torch.randint(
        0, 1 << 36, (180,), device=cuda, generator=g)])
    whole = trp.build_radix_table(keys)
    shards = trp.build_radix_shards(keys, n_shard, [cuda] * n_shard)
    assert whole.sp > 0 and all(t.sp == whole.sp for t in shards)
    assert torch.equal(torch.cat([t.slots for t in shards]), whole.slots)
    R, Br = 512, 384
    pick = torch.randint(0, keys.numel(), (R * Br,), device=cuda, generator=g)
    other = torch.randint(-(1 << 63), (1 << 63) - 1, (R * Br,), device=cuda,
                          dtype=torch.int64, generator=g)
    coin = torch.rand(R * Br, device=cuda, generator=g) < 0.5
    hashes = torch.where(coin, keys[pick], other).reshape(R, Br)
    valid = torch.rand((R, Br), device=cuda, generator=g) < 0.67
    rid = torch.arange(R, device=cuda, dtype=torch.int32) // 4
    key, srid, first = trp.prep_sorted(hashes, valid,
                                       rid[:, None].expand(R, Br))
    kw = dict(p=whole.p, sp=whole.sp, num_segments=R // 4)
    tk.probe_hits.launches = 0
    per = []
    for t in shards:
        got = tk.probe_hits(t.slots, t.spill, key, srid, first,
                            row_lo=t.row_lo, **kw)
        want = tk.probe_hits_plain(t.slots, t.spill, key, srid, first,
                                   row_lo=t.row_lo, **kw)
        assert torch.equal(got, want)
        per.append(got)
    assert tk.probe_hits.launches == n_shard
    whole_hits = tk.probe_hits(whole.slots, whole.spill, key, srid, first,
                               **kw)
    assert torch.equal(sum(per), whole_hits) and int(whole_hits.sum()) > 0


def test_sharded_pipeline_on_card_matches_device_pipeline(cuda):
    from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes
    from deacon_tpu_torch.parallel.sharded import ShardedPipeline, make_mesh

    rng = np.random.default_rng(6)
    genome = rng.choice(_B, size=200_000).tobytes()
    idx = np.unique(compute_minimizer_hashes(genome, 31, 15))
    seqs = []
    for _ in range(300):
        n = int(rng.integers(31, 3000))
        s = int(rng.integers(0, len(genome) - n))
        seqs.append(genome[s:s + n] if rng.random() < 0.5
                    else rng.choice(_B, size=n).tobytes())
    seqs[7] = genome[:300] + b"A" * 700
    pairs = list(zip(seqs[::2], seqs[1::2]))
    tiles = ((256, 64), (1024, 32))
    pipe = ShardedPipeline(idx, 31, 15, make_mesh(1, 4, [cuda] * 4),
                           tiles=tiles)
    ref = DevicePipeline(idx, 31, 15, tiles=tiles, device=cuda)
    tk.probe_hits.launches = tk.select_compact.launches = 0
    got = (pipe.counts_single(seqs, 0), pipe.counts_paired(pairs, 0))
    assert tk.probe_hits.launches == 4 * tk.select_compact.launches > 0
    want = (ref.counts_single(seqs, 0), ref.counts_paired(pairs, 0))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_[0], w_[0])
        np.testing.assert_array_equal(g_[1], w_[1])
    assert pipe.rerun_units >= 1


def test_pipeline_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    genome = rng.choice(_B, size=200_000).tobytes()
    from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes

    idx = np.unique(compute_minimizer_hashes(genome, 31, 15))
    seqs = []
    for _ in range(300):
        n = int(rng.integers(31, 3000))
        s = int(rng.integers(0, len(genome) - n))
        seqs.append(genome[s:s + n] if rng.random() < 0.5
                    else rng.choice(_B, size=n).tobytes())
    # rows over their minimizer budget, rerun on the card
    seqs[7] = genome[:300] + b"A" * 700
    seqs[40] = b"CAG" * 300 + genome[900:1000]
    tiles = ((256, 64), (1024, 32))
    pipe = DevicePipeline(idx, 31, 15, tiles=tiles, device=cuda)
    got = pipe.counts_single(seqs, 0)
    want = DevicePipeline(idx, 31, 15, tiles=tiles, device="cpu").counts_single(
        seqs, 0)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    assert pipe.rerun_units >= 2


_SWITCHES = [
    ({"DEACON_TPU_TILES": "384:64,1152:32,12288:8"}, 31, "K4", None),
    ({"DEACON_ENGINE": "3"}, 31, "K4", ((256, 64), (1024, 32))),
    ({"DEACON_ENGINE": "2"}, 31, "K3", ((256, 64), (1024, 32))),
    ({"DEACON_PALLAS": "1"}, 31, "K5", ((256, 64), (1024, 32))),
    ({"DEACON_PALLAS": "1"}, 41, "K5", ((256, 64), (1024, 32))),
]


@pytest.mark.parametrize("env,k,kernel,tiles", _SWITCHES)
def test_pipeline_under_switch_on_card_matches_cpu(cuda, monkeypatch, env, k,
                                                   kernel, tiles):
    """Each switch routes the card's pipeline through its kernel, and the
    counts equal the CPU's (plain versions) under the same switch."""
    from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rng = np.random.default_rng(k + 5)
    genome = rng.choice(_B, size=100_000).tobytes()
    idx = np.unique(compute_minimizer_hashes(genome, k, 15))
    seqs = []
    for _ in range(200):
        n = int(rng.integers(k, 14_000))
        s = int(rng.integers(0, len(genome) - n))
        seqs.append(genome[s:s + n] if rng.random() < 0.5
                    else rng.choice(_B, size=n).tobytes())
    seqs[5] = genome[:300] + b"A" * 700
    seqs[50] = b"CAG" * 300 + genome[900:1000]
    pipe = DevicePipeline(idx, k, 15, tiles=tiles, device=cuda)
    assert set(pipe.routes.values()) == {kernel}
    launches = {"K1": tk.select_compact, "K3": tk.values_select,
                "K4": tk.select_csum, "K5": tk.values_argmin}
    for f in launches.values():
        f.launches = 0
    got = pipe.counts_single(seqs, 0)
    want = DevicePipeline(idx, k, 15, tiles=tiles, device="cpu").counts_single(
        seqs, 0)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    assert pipe.rerun_units >= 2
    assert {n for n, f in launches.items() if f.launches} == {kernel}


def test_wide_k_pipeline_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(4)
    genome = rng.choice(_B, size=100_000).tobytes()
    from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes

    idx = np.unique(compute_minimizer_hashes(genome, 41, 15))
    seqs = []
    for _ in range(200):
        n = int(rng.integers(41, 3000))
        s = int(rng.integers(0, len(genome) - n))
        seqs.append(genome[s:s + n] if rng.random() < 0.5
                    else rng.choice(_B, size=n).tobytes())
    seqs[5] = genome[:300] + b"A" * 700
    seqs[50] = b"CAG" * 300 + genome[900:1000]
    pairs = list(zip(seqs[::2], seqs[1::2]))
    tiles = ((256, 64), (1024, 32))
    pipe = DevicePipeline(idx, 41, 15, tiles=tiles, device=cuda)
    ref = DevicePipeline(idx, 41, 15, tiles=tiles, device="cpu")
    tk.values_select.launches = 0
    for got, want in ((pipe.counts_single(seqs, 0), ref.counts_single(seqs, 0)),
                      (pipe.counts_paired(pairs, 0),
                       ref.counts_paired(pairs, 0))):
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_)
    assert pipe.rerun_units >= 2 and tk.values_select.launches > 0


@pytest.mark.parametrize("k,e", [(31, 0.0), (41, 0.5), (57, 0.0)])
def test_index_build_on_card_matches_cpu(cuda, k, e):
    from deacon_tpu_torch.ops.engine import DistinctHashes, IndexBuildPipeline

    rng = np.random.default_rng(k)
    seqs = [rng.choice(_B, size=int(n)).tobytes()
            for n in rng.integers(10, 40_000, 20)]
    seqs[3] = b"ACAC" * 600 + seqs[3]
    seqs[4] = seqs[4][:500] + b"NNRYK" * 30 + seqs[4][500:].lower()
    keys = []
    for dev in (cuda, "cpu"):
        pipe = IndexBuildPipeline(k, 15, e, device=dev)
        d = DistinctHashes(pipe.device)
        running = d.add(*pipe.extract_batch(seqs), len(seqs))
        keys.append((d.sorted_u64(), running))
    np.testing.assert_array_equal(keys[0][0], keys[1][0])
    np.testing.assert_array_equal(keys[0][1], keys[1][1])


@pytest.mark.parametrize("env,k,kernel", [({"DEACON_PALLAS": "1"}, 31, "K5"),
                                          ({"DEACON_PALLAS": "1"}, 41, "K5"),
                                          ({"DEACON_ENGINE": "3"}, 31, "K3")])
def test_index_build_under_switch_on_card_matches_cpu(cuda, monkeypatch, env,
                                                      k, kernel):
    from deacon_tpu_torch.ops.engine import DistinctHashes, IndexBuildPipeline

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rng = np.random.default_rng(k + 9)
    seqs = [rng.choice(_B, size=int(n)).tobytes()
            for n in rng.integers(10, 40_000, 12)]
    seqs[3] = b"ACAC" * 600 + seqs[3]
    keys = []
    for dev in (cuda, "cpu"):
        pipe = IndexBuildPipeline(k, 15, 0.5, device=dev)
        assert set(pipe.routes.values()) == {kernel}
        d = DistinctHashes(pipe.device)
        running = d.add(*pipe.extract_batch(seqs), len(seqs))
        keys.append((d.sorted_u64(), running))
    np.testing.assert_array_equal(keys[0][0], keys[1][0])
    np.testing.assert_array_equal(keys[0][1], keys[1][1])
