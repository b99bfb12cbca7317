"""The harness end to end at a tiny size on the port's ``cpu`` route,
called as a function: every cell correct, a cell made of new files only
picked up, the command refusing to run without a card, and ``correct``
false under the control and under each fault of the timed path."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import control, harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["panhuman1.pe150", "panhuman1.ont", "panmouse1a.pe150-gz"]
TINY_UNITS = {"pe150": 1500, "pe150-gz": 1500, "ont": 150}


def shrink(root, keys=40_000, units=TINY_UNITS):
    """A copy of the benchmark's data at a size the CPU runs in seconds."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        cfg["n_keys"], cfg["host_genome_bp"] = keys, 30_000
        os.makedirs(os.path.dirname(os.path.join(root, c["file"])),
                    exist_ok=True)
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    tdir = os.path.join(root, "benchmark", "traffic")
    os.makedirs(tdir, exist_ok=True)
    for name in os.listdir(os.path.join(REPO, "benchmark", "traffic")):
        with open(os.path.join(REPO, "benchmark", "traffic", name)) as f:
            t = json.load(f)
        t["pool"]["units"] = units.get(name[:-5], 100)
        with open(os.path.join(tdir, name), "w") as f:
            json.dump(t, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    shrink(str(tmp_path))
    return str(tmp_path)


def run(root, cell, seed=2**31 + 7, seconds=1.0, trace=False):
    return harness.run_cell(root, cell, seed, seconds, trace, "cpu", 0.0,
                            lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_on_cpu(tiny, cell):
    r = run(tiny, cell)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= TINY_UNITS[cell.split(".")[1]]
    assert set(r["metrics"]) == {"filter_mbp_s", "setup_s"}  # no card GB
    assert list(r)[-1] == "checks"
    assert r["checks"] == {"units_wrong": {"value": 0, "limit": 0},
                           "records_wrong": {"value": 0, "limit": 0}}
    assert r["device"]["platform"] == "cpu"
    # nothing is left in TMPDIR
    assert not [n for n in os.listdir(tiny) if n.startswith("bench-")]


def test_trace_run_reports_spans(tiny):
    r = run(tiny, "panhuman1.ont", seconds=2.0, trace=True)
    assert r["correct"] is True
    m = r["metrics"]
    shares = [m[n]["value"] for n in ("reader_wait_share", "launch_share",
                                      "resolve_wait_share", "writer_share")]
    assert all(0 <= s <= 1 for s in shares) and 0.5 < sum(shares) <= 1.0
    assert m["table_build_s"]["value"] > 0
    # no device trace on the CPU: the device's metrics are left out
    for name in ("device_idle_share", "k1_roofline", "k2_roofline"):
        assert name not in m


@pytest.mark.parametrize("extra", [{}, {"deplete": False},
                                   {"mesh": "2x1"}])
def test_new_cell_of_new_files_only(tiny, extra):
    with open(os.path.join(tiny, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg_file = "benchmark/configs/tinyhost-k25w9.json"
    with open(os.path.join(tiny, bench["configs"][0]["file"])) as f:
        cfg = json.load(f)
    cfg.update(name="tinyhost-k25w9", k=25, w=9, n_keys=20_000)
    with open(os.path.join(tiny, cfg_file), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(tiny, "benchmark", "traffic", "pe150.json")) as f:
        traffic = json.load(f)
    traffic["pool"].update(units=300, read_len=100, fragment=[200, 300])
    traffic.update(extra)
    with open(os.path.join(tiny, "benchmark", "traffic", "pe100.json"),
              "w") as f:
        json.dump(traffic, f)
    bench["configs"].append({"name": "tinyhost-k25w9", "source": "x",
                             "file": cfg_file, "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tinyhost.pe100",
                               "config": "tinyhost-k25w9",
                               "traffic": "pe100", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.get("workloads", []).append("tinyhost.pe100")
    with open(os.path.join(tiny, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    r = run(tiny, "tinyhost.pe100")
    assert r["correct"] is True and r["attempted"] >= 300


def test_command_refuses_without_a_card(tmp_path):
    assert not __import__("torch").cuda.is_available()
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_command_needs_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, the command fails and prints no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode != 0 and out.stdout == ""


def test_no_jax_in_a_run(tiny):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "r = harness.run_cell(%r, 'panhuman1.pe150', 3, 0.5, False, 'cpu',"
        " 0.0, lambda m: None)\n"
        "assert r['correct']\n"
        "print(harness.forbidden_modules())\n" % (REPO, tiny))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, TMPDIR=tiny))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "deacon_tpu_torch_x", sys)
    assert harness.forbidden_modules() == [] or "deacon_tpu" not in (
        harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


# ---------------------------------------------------------------------------
# correct must come out false: the control and the faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", ["panhuman1.pe150", "panhuman1.ont"])
def test_control_is_refused(tmp_path, cell):
    """At 2e6 keys a 32-bit fingerprint collides often enough to show."""
    shrink(str(tmp_path), keys=2_000_000)
    bench = harness.load_manifest(str(tmp_path))
    c = harness.cell_entry(bench, cell)
    out = control.run_control(harness.config_data(bench, str(tmp_path), c),
                              harness.traffic_data(str(tmp_path),
                                                   c["traffic"]),
                              11, "cpu")
    assert out["reference"]["units_wrong"]["value"] == 0
    assert out["reference"]["records_wrong"]["value"] == 0
    assert out["control"]["units_wrong"]["value"] > 0


def _fault(kind):
    """A DeviceDecider.launch whose answers are broken where they are
    produced."""
    from deacon_tpu_torch.filter.engine import Decisions, DeviceDecider

    launch = DeviceDecider.launch

    def broken(self, arena, start, length, paired, prefix_length, cfg):
        resolve = launch(self, arena, start, length, paired, prefix_length,
                         cfg)

        def fut():
            d = resolve()
            n = d.keep.size
            if kind == "unchanged":  # the step leaves its outputs at zero
                z = np.zeros(n, np.int64)
                return Decisions(np.ones(n, bool), z, z.copy())
            if kind == "half":  # half of the batch left out
                h = n // 2
                return Decisions(d.keep[:h], d.hits[:h], d.totals[:h])
            hits = d.hits.copy()  # one answer altered
            hits[n // 3] += 1
            return Decisions(d.keep, hits, d.totals)
        return fut

    return broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_fault_is_refused(tiny, monkeypatch, kind):
    from deacon_tpu_torch.filter.engine import DeviceDecider

    monkeypatch.setattr(DeviceDecider, "launch", _fault(kind))
    r = run(tiny, "panhuman1.pe150")
    assert r["correct"] is False
    assert r["checks"]["units_wrong"]["value"] > 0


def test_writer_fault_is_refused(tiny, monkeypatch):
    """A record dropped where the output is formatted."""
    from deacon_tpu_torch.io import writers

    fmt = writers.format_batch

    def dropping(batch, idx, numbers=None):
        return fmt(batch, np.asarray(idx)[1:], numbers)

    monkeypatch.setattr(writers, "format_batch", dropping)
    r = run(tiny, "panhuman1.ont")
    assert r["correct"] is False
    assert r["checks"]["records_wrong"]["value"] > 0
    assert r["checks"]["units_wrong"]["value"] == 0


def test_memory_peak_is_the_programs(monkeypatch):
    """The harness's own scratch for the keys is left out of the device's
    memory peak: the program's peak alone is reported."""
    import torch

    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    ctx = {"device": torch.device("cuda"), "keys_peak_bytes": 26 * 10**9,
           "program_peak_bytes": 6 * 10**9}
    info = harness.device_info(ctx, False)
    assert info["memory_peak_bytes"] == 6 * 10**9
    assert info["platform"] == "gpu" and info["count"] == 1
