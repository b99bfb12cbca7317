"""The engine's switches in deacon_tpu_torch against deacon_tpu, on the CPU,
exact (every output is an integer).

* K4 (select_csum) and K5 (values_argmin): the dense plain versions of
  the TPU kernels (select_csum_plain, values_argmin_plain) against the
  JAX package's Pallas kernels in interpret mode; the plane's consumer
  (kernels.csum_slots) against _stage_compact3 + _stage_hash_packed;
  kernels.flag_mask against _stage_flag_mask.
* engine_arch and the per-tile routes against the JAX package's
  engine_arch over a grid of k, L, R and DEACON_ENGINE.
* DevicePipeline under DEACON_TPU_TILES (non-power-of-two L),
  DEACON_ENGINE=3, DEACON_ENGINE=2 and DEACON_PALLAS=1 against the JAX
  DevicePipeline under the same switch (where the JAX pipeline raises
  BudgetOverflow, against its host decider, as its filter engine does);
  IndexBuildPipeline under DEACON_PALLAS=1 and DEACON_ENGINE=3 against the
  JAX IndexBuildPipeline and the oracle.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deacon_tpu.ops import engine as jeng  # noqa: E402
from deacon_tpu.ops import pallas_kernels as jpk  # noqa: E402
from deacon_tpu_torch.ops import engine as teng  # noqa: E402
from deacon_tpu_torch.ops import kernels as tk  # noqa: E402
from deacon_tpu_torch.ops import minimizers_np as mnp  # noqa: E402
from deacon_tpu_torch.ops.hash import xxh3_64  # noqa: E402

_B = np.frombuffer(b"ACGT", np.uint8)
_SWITCHES = ("DEACON_TPU_TILES", "DEACON_ENGINE", "DEACON_PALLAS")


def _rs(rng, n):
    return rng.choice(_B, size=n).tobytes()


def _tile(rng, R, L, k, w):
    """Dirty bases, a short row (allow_short), an empty and an unused row
    and a low-complexity stretch."""
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    validb = rng.random((R, L)) > 0.03
    mlen = rng.integers(-1, L - k + 2, (R,)).astype(np.int32)
    mlen[0] = L - k + 1
    mlen[1] = 0
    mlen[2] = max(1, w - 2)
    mlen[-1] = -1
    allow = rng.random(R) > 0.5
    allow[2] = True
    codes[3, 40:200] = codes[3, 40]
    return codes, validb, mlen, allow


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# K4 and its consumer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [384, 1152, 256])
@pytest.mark.parametrize("k,w", [(31, 15), (15, 5)])
def test_k4_plain_matches_pallas_interpret(k, w, L):
    rng = np.random.default_rng(k * 7 + L)
    R = 8
    codes, validb, mlen, allow = _tile(rng, R, L, k, w)
    pc, pv = jeng.host_pack_bits(codes, validb)
    pci, pvi = jeng.host_interleave_packed(pc, pv)
    want_plane, want_tot = jpk.select_csum_packed(
        jnp.asarray(pci), jnp.asarray(pvi), jnp.asarray(mlen),
        jnp.asarray(allow), k=k, w=w, interpret=True)
    plane, tot = tk.select_csum_plain(*_t(pc, pv, mlen, allow), k=k, w=w)
    np.testing.assert_array_equal(plane.numpy(), np.asarray(want_plane))
    np.testing.assert_array_equal(tot.numpy(),
                                  np.asarray(want_tot).reshape(-1))
    assert int(tot.sum()) > 0

    # the consumer: each row's (position, hash) slots in order, against
    # the JAX package's batch-wide compaction and packed-code hash
    want_tot = np.asarray(want_tot).reshape(-1)
    _, srow, spos, svalid, _ = jeng._stage_compact3(
        want_plane, jnp.asarray(want_tot), budget=int(want_tot.sum()) + 128)
    hlo, hhi = jeng._stage_hash_packed(
        jeng._words_view(jnp.asarray(pc)), srow, spos, k=k)
    jh = np.asarray(hlo).astype(np.uint64) | (
        np.asarray(hhi).astype(np.uint64) << np.uint64(32))
    srow, spos, svalid = (np.asarray(x) for x in (srow, spos, svalid))
    Br = L
    pos, (val,), rt = tk.csum_slots(torch.from_numpy(pc), plane, tot, k=k,
                                    Br=Br)
    h = xxh3_64(val).numpy().view(np.uint64)
    for r in range(R):
        n = int(rt[r])
        sel = svalid & (srow == r)
        np.testing.assert_array_equal(pos[r, :n].numpy(), spos[sel])
        np.testing.assert_array_equal(h[r, :n], jh[sel])


def test_k4_slots_match_oracle():
    """The K4 route (K4's plain version on the CPU) on packed rows of real
    reads (N runs, lowercase, a short row) gives the oracle's minimizers,
    position and hash, at a non-power-of-two L."""
    rng = np.random.default_rng(44)
    k, w, L = 31, 15, 640
    l = k + w - 1
    seqs = [_rs(rng, int(n)) for n in rng.integers(k, L + 1, 12)]
    seqs[1] = seqs[1][:100] + b"NNNN" + seqs[1][104:].lower()
    seqs[2] = seqs[2][:l - 1]
    rows = [teng._Row(i, 0, 0, s) for i, s in enumerate(seqs)]
    arrs = teng.pack_rows_packed(rows, len(rows), L, k, l)
    pos, planes, tot = teng.select_slots(*_t(*arrs[:4]), k=k, w=w, Br=L,
                                         route="K4")
    h = xxh3_64(planes[0]).numpy().view(np.uint64)
    for i, s in enumerate(seqs):
        want_h, want_p, _ = mnp.get_minimizer_hashes_and_positions(s, 0, k,
                                                                   w)
        n = int(tot[i])
        assert n == want_p.size
        np.testing.assert_array_equal(pos[i, :n].numpy(), want_p)
        np.testing.assert_array_equal(h[i, :n], want_h)


# ---------------------------------------------------------------------------
# K5 and the flag mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,w", [(21, 7), (31, 15), (41, 15), (56, 9)])
def test_k5_plain_matches_pallas_interpret(k, w):
    rng = np.random.default_rng(k + 55)
    R, L = 16, 640
    codes, validb, mlen, allow = _tile(rng, R, L, k, w)
    limbs, want_wp = jpk.values_argmin_fused(
        jnp.asarray(codes), jnp.asarray(mlen), k=k, w=w, interpret=True)
    pc, _ = jeng.host_pack_bits(codes, validb)
    planes, wp = tk.values_argmin_plain(*_t(pc, mlen), k=k, w=w)
    assert len(planes) == (1 if k <= 32 else 2)
    np.testing.assert_array_equal(wp.numpy(), np.asarray(want_wp))
    v = [np.asarray(x).astype(np.uint64) for x in limbs]
    for i, p in enumerate(planes):
        np.testing.assert_array_equal(
            p.numpy().view(np.uint64),
            v[2 * i] | (v[2 * i + 1] << np.uint64(32)))


@pytest.mark.parametrize("k,w", [(21, 7), (31, 15), (41, 15), (56, 9)])
def test_flag_mask_matches_jax_stage(k, w):
    rng = np.random.default_rng(k + 66)
    R, L = 16, 512
    codes, validb, mlen, allow = _tile(rng, R, L, k, w)
    pc, pv = jeng.host_pack_bits(codes, validb)
    _, wp = tk.values_argmin_plain(*_t(pc, mlen), k=k, w=w)
    want = jeng._stage_flag_mask(
        jnp.asarray(wp.numpy()), jnp.asarray(validb), jnp.asarray(mlen),
        jnp.asarray(allow), k=k, w=w)
    got = tk.flag_mask(wp, *_t(pv, mlen, allow), k=k, w=w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < R * L


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["", "2", "3", "4"])
def test_engine_arch_matches_jax(monkeypatch, engine):
    monkeypatch.setenv("DEACON_ENGINE", engine)
    for k in (15, 31, 32, 33, 41):
        for L in (128, 256, 384, 640, 1152, 2048, 12288, 16384, 16512,
                  32768):
            for R in (1, 4, 8, 12, 64, 2048):
                want = jeng.engine_arch(k, L, R)
                assert teng.engine_arch(k, L, R) == want, (k, L, R)
                assert teng.v3_eligible(k, L, R) == jeng._v3_eligible(k, L,
                                                                       R)
                route = teng.tile_route(k, L, R)
                assert route == {4: "K1", 3: "K4", 2: "K3"}[want]
                build = teng.tile_route(k, L, R, index_build=True)
                assert build == ("K1" if want == 4 else "K3")


@pytest.mark.parametrize("value,route", [("1", "K5"), ("0", "K1"),
                                         ("off", "K1"), ("interpret", "K1"),
                                         ("2", "K1")])
def test_pallas_switch_values(monkeypatch, value, route):
    monkeypatch.setenv("DEACON_PALLAS", value)
    assert teng.tile_route(31, 256, 8192) == route
    assert teng.tile_route(41, 256, 8192) == ("K5" if value == "1" else "K3")
    assert teng.tile_route(57, 256, 8192, index_build=True) == "K3"


@pytest.mark.parametrize("env", ["300:64", "256:64,20000:8", "16512:4",
                                 "256x64"])
def test_bad_tiles_raise(monkeypatch, env):
    """A DEACON_TPU_TILES row length that no kernel takes (not a multiple
    of 128, or above 16384) raises at construction, naming the limit."""
    monkeypatch.setenv("DEACON_TPU_TILES", env)
    idx = np.arange(1, 100, dtype=np.uint64)
    match = ("DEACON_TPU_TILES" if "x" in env
             else "multiple of 128 and at most 16384")
    with pytest.raises(ValueError, match=match):
        teng.DevicePipeline(idx, 31, 15, device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        teng.IndexBuildPipeline(31, 15, tiles=[(300, 8)], device="cpu")


# ---------------------------------------------------------------------------
# the pipelines under each switch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def genomes():
    rng = np.random.default_rng(61)
    out = {}
    for k in (31, 41):
        g = _rs(rng, 120_000)
        out[k] = (g, np.unique(mnp.compute_minimizer_hashes(g, k, 15)))
    return out


def _reads(rng, genome, n, lo, hi):
    out = []
    for _ in range(n):
        m = int(rng.integers(lo, hi))
        if rng.random() < 0.5:
            s = int(rng.integers(0, len(genome) - m))
            out.append(genome[s:s + m])
        else:
            out.append(_rs(rng, m))
    return out


def _jax_counts(idx, k, tiles, seqs=None, pairs=None):
    """The JAX package's counts under the current switches: its
    DevicePipeline, or, when that raises BudgetOverflow, its host decider
    (what its filter engine falls back to)."""
    import deacon_tpu as dt
    from deacon_tpu.filter.backend import LocalBackend
    from deacon_tpu.filter.engine import HostDecider

    pipe = jeng.DevicePipeline(idx, k, 15, tiles=tiles)
    try:
        return (pipe.counts_single(seqs, 0) if pairs is None
                else pipe.counts_paired(pairs, 0))
    except jeng.BudgetOverflow:
        pass
    index = dt.MinimizerIndex(dt.IndexHeader.new(k, 15), idx)
    host = HostDecider(LocalBackend(index), k, 15)
    cfg = dt.FilterConfig(minimizers_path="", input_path="")
    out = (host.decide_unpaired(seqs, 0, cfg) if pairs is None
           else host.decide_paired(pairs, 0, cfg))
    return (np.array([d[1] for d in out]), np.array([d[2] for d in out]))


_PIPE_CASES = {
    "tiles_384_1152": ({"DEACON_TPU_TILES": "384:64,1152:16"}, 31, None,
                       "K4"),
    "engine3": ({"DEACON_ENGINE": "3"}, 31, ((256, 16), (1024, 8)), "K4"),
    "engine2": ({"DEACON_ENGINE": "2"}, 31, ((256, 16), (1024, 8)), "K3"),
    "pallas1_k31": ({"DEACON_PALLAS": "1"}, 31, ((256, 16), (1024, 8)),
                    "K5"),
    "pallas1_k41": ({"DEACON_PALLAS": "1"}, 41, ((256, 16), (1024, 8)),
                    "K5"),
}


@pytest.mark.parametrize("case", sorted(_PIPE_CASES))
def test_pipeline_under_switch_matches_jax(genomes, monkeypatch, case):
    """Single reads (short, N runs, lowercase), pairs, chunked long reads
    and low-complexity rows that rerun on the device."""
    env, k, tiles, route = _PIPE_CASES[case]
    for name in _SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    genome, idx = genomes[k]
    rng = np.random.default_rng(len(case))
    seqs = _reads(rng, genome, 40, 20, 900)
    seqs += [b"ACGTN" * 40, genome[500:560].lower(), genome[9:9 + k + 3]]
    seqs += [genome[s:s + 2600] for s in (1000, 50_000)]
    seqs += [genome[5000:5400] + b"N" * 900, b"T" * 1000,
             b"AC" * 450 + genome[4000:4080], genome[2000:2300] + b"A" * 600]
    port = teng.DevicePipeline(idx, k, 15, tiles=tiles, device="cpu")
    assert set(port.routes.values()) == {route}
    got = port.counts_single(seqs, 0)
    want = _jax_counts(idx, k, tiles, seqs=seqs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].sum() > 0 and port.rerun_units >= 2
    pairs = list(zip(seqs[::2], seqs[1::2]))
    got = port.counts_paired(pairs, 0)
    want = _jax_counts(idx, k, tiles, pairs=pairs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("env,k,route", [({"DEACON_PALLAS": "1"}, 31, "K5"),
                                         ({"DEACON_PALLAS": "1"}, 41, "K5"),
                                         ({"DEACON_ENGINE": "3"}, 31, "K3")])
def test_index_build_pipeline_under_switch_matches_jax(monkeypatch, env, k,
                                                       route):
    from deacon_tpu.ops.engine import IndexBuildPipeline as JaxIndexPipeline
    from deacon_tpu_torch.ops.engine import IndexBuildPipeline

    for name in _SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rng = np.random.default_rng(k + 3)
    seqs = [_rs(rng, 500), _rs(rng, 60), _rs(rng, 20),
            _rs(rng, 100) + b"N" + _rs(rng, 100), _rs(rng, 5000),
            b"RYKMWSN" * 30 + _rs(rng, 100), _rs(rng, 300).lower(),
            b"A" * 700 + _rs(rng, 300)]
    port = IndexBuildPipeline(k, 15, 0.5, tiles=((256, 8), (1024, 8)),
                              device="cpu")
    assert set(port.routes.values()) == {route}
    h, seq = port.extract_batch(seqs)
    assert port.rerun_rows >= 1
    ref = JaxIndexPipeline(k, 15, entropy_threshold=0.5, row_len=1024,
                           rows_per_batch=8)
    try:
        want = ref.extract_batch(seqs)
    except jeng.BudgetOverflow:
        want = ref.extract_batch(seqs[:-1])
    for i, s in enumerate(seqs):
        got = np.unique(h[seq == i].numpy().view(np.uint64))
        np.testing.assert_array_equal(
            got, np.unique(mnp.compute_minimizer_hashes(s, k, 15, 0.5)))
        if i < len(want):
            np.testing.assert_array_equal(got, np.unique(want[i]))
