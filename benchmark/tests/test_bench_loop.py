"""The harness's copy of ``filter.engine.run``'s loop (``run_job``) held
to ``run`` itself on the port's ``cpu`` route: the same outputs, byte for
byte, and the same FilterStats from an index file and the pool's files as
``run_job`` gives from the resident index and the pool fed through its
pipes; and the window's job, fed the pool over and over, keeping its
queue of launched batches full while it reads."""

import dataclasses

import numpy as np
import pytest

from benchmark import harness
from benchmark.drivers import filter_stream as fs
from benchmark.generators import reads
from benchmark.index_keys import genome_hashes, make_keys, to_host_u64
from benchmark.reference import I64_MIN, keep_mask, unit_counts
from benchmark.seeds import generator, rng
from benchmark.tests.test_bench_harness import CELLS, shrink

SEED = 2**31 + 21


def setup_cell(root, cell, seed=SEED):
    """The cell's configuration, traffic, pool and resident index, made
    as the driver makes them."""
    import torch
    from deacon_tpu_torch.index.store import IndexHeader, MinimizerIndex

    bench = harness.load_manifest(root)
    c = harness.cell_entry(bench, cell)
    config = harness.config_data(bench, root, c)
    traffic = harness.traffic_data(root, c["traffic"])
    k, w = int(config["k"]), int(config["w"])
    dev = torch.device("cpu")
    genome = reads.random_bases(rng(seed, "genome",
                                    config["host_genome_salt"]),
                                int(config["host_genome_bp"]))
    keys = make_keys(int(config["n_keys"]), genome_hashes(genome, dev, k, w),
                     generator(seed, "keys", dev), dev)
    index = MinimizerIndex(IndexHeader.new(k, w), to_host_u64(keys))
    pool = reads.make_pool(traffic["pool"], genome,
                           rng(seed, "pool", traffic["generator"]))
    return config, traffic, pool, index


def filter_config(config, traffic, pool, index_path, inputs, outputs):
    from deacon_tpu_torch.config import FilterConfig

    return FilterConfig(
        minimizers_path=index_path, input_path=inputs[0],
        input2_path=inputs[1] if pool.paired else None,
        output_path=outputs[0],
        output2_path=outputs[1] if pool.paired else None,
        abs_threshold=int(config["abs_threshold"]),
        rel_threshold=float(config["rel_threshold"]),
        deplete=bool(traffic.get("deplete", config["deplete"])),
        device="cpu", quiet=True)


def resident_job(work, config, traffic, pool, index, **changes):
    """The driver's job over ``pool``: feeds, output pipes, decider."""
    from deacon_tpu_torch.filter import engine
    from deacon_tpu_torch.filter.backend import LocalBackend

    in_ext, files = reads.pool_bytes(pool, traffic["pool"], 2)
    feeds, sinks = fs.plumbing(work, pool, files, in_ext,
                               traffic["output_ext"])
    cfg = filter_config(config, traffic, pool, "<resident>",
                        [f.path for f in feeds], [s.path for s in sinks])
    cfg = dataclasses.replace(cfg, **changes)
    h = index.header
    decider = engine.make_decider(index, LocalBackend(index),
                                  h.kmer_length, h.window_size, cfg)
    return fs.Job(engine, decider, cfg, pool.paired, feeds, sinks)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    root = tmp_path / "root"
    root.mkdir()
    shrink(str(root))
    return str(root)


@pytest.mark.parametrize("cell", CELLS)
def test_run_job_matches_filter_run(tiny, tmp_path, cell):
    from deacon_tpu_torch.filter import engine
    from deacon_tpu_torch.index.store import write_index

    config, traffic, pool, index = setup_cell(tiny, cell)
    files = tmp_path / "files"
    files.mkdir()
    index_path = str(files / "host.idx")
    write_index(index.hashes, index.header, index_path)
    ext, pool_files = reads.pool_bytes(pool, traffic["pool"], 2)
    inputs = []
    for i, fb in enumerate(pool_files):
        inputs.append(str(files / f"pool_R{i + 1}{ext}"))
        with open(inputs[-1], "wb") as f:
            f.write(fb.whole())
    outputs = [str(files / f"out_R{i + 1}{traffic['output_ext']}")
               for i in range(len(inputs))]
    cfg = filter_config(config, traffic, pool, index_path, inputs, outputs)
    stats, _, _ = engine.run(cfg, _return_stats=True)

    work = tmp_path / "work"
    work.mkdir()
    job = resident_job(str(work), config, traffic, pool, index)
    got = fs.run_job(job, fs.Spans(), repeat=1, keep_output=True)
    assert got["units"] == pool.n_units
    for slot in type(stats).__slots__:
        assert getattr(got["stats"], slot) == getattr(stats, slot), slot
    assert got["bases"] == stats.total_bp
    for path, out in zip(outputs, got["outputs"]):
        with open(path, "rb") as f:
            want = f.read()
        assert b"".join(out["head"]) == want
        assert out["bytes"] == len(want)


def test_window_job_keeps_its_queue_full(tiny, tmp_path, monkeypatch):
    """Fed the pool three times in batches of 100 units, the job holds
    resolve_depth + 1 batches before it resolves one, and resolves while
    it reads; every unit of the stream matches the pool's reference and
    the outputs pass the driver's comparison."""
    import torch
    from deacon_tpu_torch.ops.engine import DevicePipeline

    monkeypatch.setattr(DevicePipeline, "RESOLVE_DEPTH", 4)
    config, traffic, pool, index = setup_cell(tiny, "panhuman1.pe150")
    job = resident_job(str(tmp_path), config, traffic, pool, index,
                       batch_size=100)
    assert job.decider.resolve_depth == 4
    in_flight, events = [0, 0], []
    launch = job.decider.launch

    def counting(*a, **kw):
        fut = launch(*a, **kw)
        in_flight[0] += 1
        in_flight[1] = max(in_flight[1], in_flight[0])
        events.append("launch")

        def resolve():
            in_flight[0] -= 1
            events.append("resolve")
            return fut()
        return resolve

    job.decider.launch = counting
    res = fs.run_job(job, fs.Spans(), repeat=3, keep_output=True)
    n = pool.n_units
    assert res["units"] == 3 * n
    assert in_flight[1] == 5
    first_resolve = events.index("resolve")
    assert first_resolve == 5 and events[first_resolve + 1] == "launch"

    k, w = index.header.kmer_length, index.header.window_size
    keys = torch.from_numpy(index.hashes.view(np.int64).copy()) ^ I64_MIN
    hits, totals = unit_counts(pool.arena, pool.starts, pool.lens,
                               pool.unit_of_seq, n, keys,
                               torch.device("cpu"), k, w)
    keep = keep_mask(hits, totals, int(config["abs_threshold"]),
                     float(config["rel_threshold"]), bool(config["deplete"]))
    checks = fs.compare(pool, res, hits, totals, keep, gz=False)
    assert checks == {"units_wrong": {"value": 0, "limit": 0},
                      "records_wrong": {"value": 0, "limit": 0}}
    # a unit of the third repetition altered is seen
    res["hits"][2 * n + 5] += 1
    assert fs.compare(pool, res, hits, totals, keep, False)[
        "units_wrong"]["value"] == 1
    # a plain output one record short past the first repetition is seen
    res["hits"][2 * n + 5] -= 1
    res["outputs"][0]["bytes"] -= 10
    assert fs.compare(pool, res, hits, totals, keep, False)[
        "records_wrong"]["value"] == 1


def test_feed_ends_when_its_reader_never_came(tmp_path):
    data = np.frombuffer(b"@r\nACGT\n+\nIIII\n", np.uint8)
    feed = fs.PipeFeed(str(tmp_path / "in.fastq"),
                       reads.FileBytes(b"", data.tobytes(), data, False))
    feed.start(None)
    feed.stop()
    assert feed._thread is None
