"""deacon_tpu_torch's DevicePipeline on the CPU against the JAX package's
DevicePipeline on the CPU (XLA emulation of its kernels): per-read hits and
totals equal for single reads, paired union, chunked long reads and an
index whose table spills, at k = 31 and on the wide-k (u128) path at
k = 41; and the port's IndexBuildPipeline against the JAX package's."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from deacon_tpu.ops.engine import DevicePipeline as JaxPipeline  # noqa: E402
from deacon_tpu_torch.ops import minimizers_np as mnp  # noqa: E402
from deacon_tpu_torch.ops.engine import DevicePipeline  # noqa: E402

_B = np.frombuffer(b"ACGT", np.uint8)


def _rs(rng, n):
    return rng.choice(_B, size=n).tobytes()


def _pipes(idx, tiles):
    return (DevicePipeline(idx, 31, 15, tiles=tiles, device="cpu"),
            JaxPipeline(idx, 31, 15, tiles=tiles))


def _index_with_spill(rng, genome):
    """Genome minimizers plus 140 keys sharing the top 30 bits of one real
    hash h and sorting below it, so h lands in the spill table."""
    idx = np.unique(mnp.compute_minimizer_hashes(genome, 31, 15))
    h = next(int(c) for c in idx if int(c) & 0xFFFFFFFF > 10_000)
    top = np.uint64(h & ~0x3FFFFFFFF)
    lows = rng.integers(0, h & 0x3FFFFFFFF, 140, dtype=np.uint64)
    return np.unique(np.concatenate([idx, top | lows]))


@pytest.fixture(scope="module")
def genome_and_index():
    rng = np.random.default_rng(21)
    genome = _rs(rng, 150_000)
    return genome, np.unique(mnp.compute_minimizer_hashes(genome, 31, 15))


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


def test_single_reads_match_jax(genome_and_index):
    genome, idx = genome_and_index
    rng = np.random.default_rng(1)
    seqs = _reads(rng, genome, 60, 20, 700)
    seqs += [b"A" * 100, genome[1000:1031] * 2, b"ACGTN" * 40,
             genome[500:560].lower()]
    port, ref = _pipes(idx, ((128, 32), (256, 16)))
    for prefix in (0, 90):
        got = port.counts_single(seqs, prefix)
        want = ref.counts_single(seqs, prefix)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert got[0].sum() > 0


def test_paired_union_matches_jax(genome_and_index):
    genome, idx = genome_and_index
    rng = np.random.default_rng(2)
    pairs = [(genome[0:100], genome[50:150]),
             (genome[200:260], genome[200:260]),  # shared minimizers once
             (_rs(rng, 80), genome[500:600])]
    pairs += list(zip(_reads(rng, genome, 30, 31, 300),
                      _reads(rng, genome, 30, 31, 300)))
    port, ref = _pipes(idx, ((128, 32), (256, 16)))
    got, want = port.counts_paired(pairs, 0), ref.counts_paired(pairs, 0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_chunked_long_reads_match_jax(genome_and_index):
    genome, idx = genome_and_index
    rng = np.random.default_rng(3)
    reads = [genome[s:s + 2600] for s in rng.integers(0, 140_000, 5)]
    reads += [genome[5000:5400] + b"N" * 2000, b"N" * 900 + genome[9000:9500],
              _rs(rng, 2600), genome[700:760], genome[3000:3100] * 8]
    port, ref = _pipes(idx, ((512, 64), (1024, 32)))
    got, want = port.counts_single(reads, 0), ref.counts_single(reads, 0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_spilled_index_matches_jax():
    rng = np.random.default_rng(4)
    genome = _rs(rng, 300_000)
    idx = _index_with_spill(rng, genome)
    port, ref = _pipes(idx, ((512, 64),))
    assert port.table.sp > 0 and ref._probe_extra[4] == port.table.sp
    seqs = _reads(rng, genome, 30, 31, 480)
    got, want = port.counts_single(seqs, 0), ref.counts_single(seqs, 0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _host_counts(idx, seqs=None, pairs=None):
    """(hits, totals) of the JAX package's host decider (NumPy oracle
    extraction, sorted-array probe): where its device pipeline sends a
    batch that raises BudgetOverflow."""
    import deacon_tpu as dt
    from deacon_tpu.filter.backend import LocalBackend
    from deacon_tpu.filter.engine import HostDecider

    index = dt.MinimizerIndex(dt.IndexHeader.new(31, 15), idx)
    host = HostDecider(LocalBackend(index), 31, 15)
    cfg = dt.FilterConfig(minimizers_path="", input_path="")
    out = (host.decide_unpaired(seqs, 0, cfg) if pairs is None
           else host.decide_paired(pairs, 0, cfg))
    return (np.array([d[1] for d in out]), np.array([d[2] for d in out]))


def test_unit_wider_than_tile_raises_budget_overflow(genome_and_index):
    """The JAX pipeline raises BudgetOverflow for a unit needing more rows
    than its tile holds; the port gives that unit a batch of its own on
    the device, with the host decider's exact counts."""
    from deacon_tpu.ops.engine import BudgetOverflow

    genome, idx = genome_and_index
    seqs = [genome[:5000], genome[9000:9150]]
    port = DevicePipeline(idx, 31, 15, tiles=((256, 4),), device="cpu")
    with pytest.raises(BudgetOverflow):
        JaxPipeline(idx, 31, 15, tiles=((256, 4),)).counts_single(seqs, 0)
    got, want = port.counts_single(seqs, 0), _host_counts(idx, seqs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0][0] > 0 and port.rerun_units == 0


@pytest.mark.parametrize("paired", [False, True])
def test_rows_over_budget_rerun_on_device(genome_and_index, paired):
    """Low-complexity rows (poly-A, dinucleotide repeats) select more
    minimizers than the slot budget: the JAX pipeline raises
    BudgetOverflow, the port reruns only their units on the device and
    gives the host decider's exact counts for every unit."""
    from deacon_tpu.ops.engine import BudgetOverflow

    genome, idx = genome_and_index
    rng = np.random.default_rng(5)
    seqs = _reads(rng, genome, 24, 100, 1000)
    seqs[3] = genome[2000:2300] + b"A" * 600
    seqs[11] = b"AC" * 450 + genome[4000:4080]
    seqs[17] = b"T" * 1000
    tiles = ((256, 16), (1024, 8))
    port = DevicePipeline(idx, 31, 15, tiles=tiles, device="cpu")
    jax_pipe = JaxPipeline(idx, 31, 15, tiles=tiles)
    if paired:
        pairs = list(zip(seqs[::2], seqs[1::2]))
        host = {"pairs": pairs}
        with pytest.raises(BudgetOverflow):
            jax_pipe.counts_paired(pairs, 0)
        got = port.counts_paired(pairs, 0)
    else:
        host = {"seqs": seqs}
        with pytest.raises(BudgetOverflow):
            jax_pipe.counts_single(seqs, 0)
        got = port.counts_single(seqs, 0)
    want = _host_counts(idx, **host)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert port.rerun_batches >= 1
    assert 1 <= port.rerun_units < len(want[0])


def test_default_device_is_cuda_and_never_falls_back(genome_and_index, monkeypatch):
    import torch

    _, idx = genome_and_index
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePipeline(idx, 31, 15)
    with pytest.raises(ValueError):
        DevicePipeline(idx, 31, 15, device="meta")


# ---------------------------------------------------------------------------
# wide k (33-56): K3, the u128 hash, the same slot grid downstream
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def genome_and_index_k41():
    rng = np.random.default_rng(41)
    genome = _rs(rng, 100_000)
    return genome, np.unique(mnp.compute_minimizer_hashes(genome, 41, 15))


def _k41_pipes(idx, tiles):
    return (DevicePipeline(idx, 41, 15, tiles=tiles, device="cpu"),
            JaxPipeline(idx, 41, 15, tiles=tiles))


def test_k41_single_and_paired_match_jax(genome_and_index_k41):
    genome, idx = genome_and_index_k41
    rng = np.random.default_rng(6)
    seqs = _reads(rng, genome, 50, 20, 700)
    seqs += [genome[300:341], genome[800:850].lower(), b"ACGTN" * 40]
    port, ref = _k41_pipes(idx, ((128, 32), (256, 16)))
    for prefix in (0, 90):
        got, want = port.counts_single(seqs, prefix), ref.counts_single(
            seqs, prefix)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert got[0].sum() > 0
    pairs = list(zip(seqs[::2], seqs[1::2]))
    got, want = port.counts_paired(pairs, 0), ref.counts_paired(pairs, 0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_k41_chunked_long_reads_and_reruns_match_jax(genome_and_index_k41):
    """Long reads chunked at the largest tile, and low-complexity rows over
    their slot budget, which the port reruns on the device."""
    genome, idx = genome_and_index_k41
    rng = np.random.default_rng(7)
    reads = [genome[s:s + 2600] for s in rng.integers(0, 90_000, 4)]
    reads += [genome[5000:5400] + b"N" * 2000, _rs(rng, 2600),
              genome[2000:2300] + b"A" * 600, b"AC" * 450 + genome[4000:4080],
              b"T" * 1000]
    port, ref = _k41_pipes(idx, ((512, 16), (1024, 8)))
    got, want = port.counts_single(reads, 0), ref.counts_single(reads, 0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert port.rerun_batches >= 1 and port.rerun_units >= 2


def test_filter_k_above_56_raises(genome_and_index_k41):
    _, idx = genome_and_index_k41
    with pytest.raises(ValueError, match="k<=56"):
        DevicePipeline(idx, 57, 15, device="cpu")


# ---------------------------------------------------------------------------
# index build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,e", [(31, 0.0), (31, 0.5), (41, 0.0), (41, 0.9)])
def test_index_build_pipeline_matches_jax(k, e):
    """Every sequence's hashes equal the JAX IndexBuildPipeline's and the
    oracle's. A poly-A row goes over its slot budget: at k <= 32 the JAX
    pipeline raises BudgetOverflow (its caller then extracts on the host;
    its wide-k budget is batch-global), the port reruns the row on the
    device."""
    from deacon_tpu.ops.engine import BudgetOverflow
    from deacon_tpu.ops.engine import IndexBuildPipeline as JaxIndexPipeline
    from deacon_tpu_torch.ops.engine import DistinctHashes, IndexBuildPipeline

    rng = np.random.default_rng(k)
    seqs = [_rs(rng, 500), _rs(rng, 60), _rs(rng, 20),
            _rs(rng, 100) + b"N" + _rs(rng, 100), _rs(rng, 5000),
            b"RYKMWSN" * 30 + _rs(rng, 100), b"ACAC" * 25 + _rs(rng, 200),
            _rs(rng, 300).lower(), b"A" * 700 + _rs(rng, 300)]
    port = IndexBuildPipeline(k, 15, e, tiles=((256, 4), (1024, 4)),
                              device="cpu")
    ref = JaxIndexPipeline(k, 15, entropy_threshold=e, row_len=1024,
                           rows_per_batch=8)
    if k <= 32:
        with pytest.raises(BudgetOverflow):
            ref.extract_batch(seqs)
        want = ref.extract_batch(seqs[:-1])
    else:
        want = ref.extract_batch(seqs)
    h, seq = port.extract_batch(seqs)
    assert port.rerun_rows == 1
    seen: set = set()
    running = DistinctHashes(port.device).add(h, seq, len(seqs))
    for i, s in enumerate(seqs):
        got = np.unique(h[seq == i].numpy().view(np.uint64))
        oracle = mnp.compute_minimizer_hashes(s, k, 15, e)
        np.testing.assert_array_equal(got, np.unique(oracle))
        if i < len(want):
            np.testing.assert_array_equal(got, np.unique(want[i]))
        seen |= set(oracle.tolist())
        assert running[i] == len(seen)
