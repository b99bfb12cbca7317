"""The port's multi-process modes in real processes on the CPU, against
deacon_tpu's one-process outputs, byte for byte.

Each rank is ``python -m deacon_tpu_torch ... --device cpu`` with the JAX
package's environment (DEACON_COORD, DEACON_NUM_PROC, DEACON_PROC_ID,
DEACON_POD_SHARDS), as tests/test_multiprocess_pod.py launches its ranks;
the pod modes rendezvous over gloo on localhost.

* ``filter --mesh pod``, two ranks: each rank's output is the JAX
  package's one-process ``filter`` output (search and deplete, single
  and paired); with ``--debug``, each rank's DEBUG lines are the JAX
  package's.
* ``filter --mesh pod`` with two data rows a rank (a PodMesh of the CPU
  twice, the shape of a rank that drives two cards): single, paired and
  long reads that rerun over their slot budget, search and deplete;
  batches alternate over the rows alike in both ranks.
* ``make_pod_mesh``'s rule on faked cards: rows = the fewest cards of a
  group member, nccl only for distinct cards, one group per rank group.
* ``filter --mesh pod-data``, two ranks: single and paired, a plain and a
  BGZF input; the merged output (and -O output) is the JAX package's;
  one rank with DEACON_POD_LOCAL_MESH=1x3, in process.
* ``filter --mesh pod-2d``, four ranks, DEACON_POD_SHARDS=2.
* ``index build --mesh pod-data``, two ranks: the index file is
  byte-identical to the JAX package's ``index build``.
* ``server --mesh pod``, two ranks, answering the port's ``client``: the
  client's output is the port's ``filter``; both ranks exit 0 after the
  server is interrupted.
* ``server --mesh pod`` with two data rows a rank, idle for longer than
  the process group's timeout (cut to seconds) and answering again: the
  keep-alive.
* ``server --mesh 1x2`` on ["cpu"] * 2 through the library.
* The errors, with the JAX CLI's messages and exit code 1: pod-2d without
  DEACON_POD_SHARDS, paired BGZF in pod-data, --rename in pod-data, pod
  without DEACON_COORD; and a rank whose block cannot be built (a
  truncated index file) makes every rank exit 1 through the agreement
  point.

Every subprocess has a time limit; on expiry its peers are killed.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from helpers import bgzf_compress  # noqa: E402

from deacon_tpu.cli import main as jax_main  # noqa: E402
from deacon_tpu_torch.cli import main as torch_main  # noqa: E402
from deacon_tpu_torch.index.store import IndexHeader, write_index  # noqa: E402
from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes  # noqa: E402
from deacon_tpu_torch.server.app import make_server  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
_B = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")
LIMIT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    for k in ("DEACON_COORD", "DEACON_NUM_PROC", "DEACON_PROC_ID",
              "DEACON_POD_SHARDS", "DEACON_POD_ENGINE",
              "DEACON_POD_LOCAL_MESH", "DEACON_POD_PARTS"):
        env.pop(k, None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


#: the start of a rank's script whose pod mesh has two data rows of the
#: CPU, the shape of a rank that drives two cards (the CLI gives a CPU
#: rank one row): ``make_pod_mesh`` is replaced by ``two_rows``, which
#: makes that mesh after the rendezvous
_TWO_ROWS_MESH = """
import sys

import torch

from deacon_tpu_torch.parallel import multihost
from deacon_tpu_torch.server import app

cpu = torch.device("cpu")


def two_rows(device="cuda"):
    assert multihost.maybe_init_distributed()
    nproc, rank = multihost.world()
    return multihost.PodMesh(((cpu,), (cpu,)), n_shard=nproc, shard=rank,
                             backend="gloo")


multihost.make_pod_mesh = app.make_pod_mesh = two_rows
"""

#: a rank's command line on a pod mesh of two data rows (_TWO_ROWS_MESH);
#: the rank prints the data row of every batch launch and its reruns.
#: With ``--heartbeat TIMEOUT BEAT`` first, the process group's timeout
#: and the pod server's keep-alive period are set to those seconds.
_TWO_ROWS = _TWO_ROWS_MESH + """
from deacon_tpu_torch.cli import main
from deacon_tpu_torch.ops.engine import DevicePipeline
from deacon_tpu_torch.parallel import sharded

turns, reruns = [], [0]
launch = sharded.ShardedPipeline._launch_batch
rerun = DevicePipeline._rerun_over_budget


def spy_launch(self, *a):
    turns.append(self._turn % self.n_data)
    return launch(self, *a)


def spy_rerun(self, *a):
    reruns[0] += 1
    return rerun(self, *a)


sharded.ShardedPipeline._launch_batch = spy_launch
DevicePipeline._rerun_over_budget = spy_rerun
argv = sys.argv[1:]
if argv[0] == "--heartbeat":
    multihost.COLLECTIVE_TIMEOUT_S = float(argv[1])
    app.HEARTBEAT_S = float(argv[2])
    argv = argv[3:]
rc = main(argv)
print(f"two rows: turns {''.join(map(str, turns))} reruns {reruns[0]}",
      file=sys.stderr)
sys.exit(rc)
"""


def _spawn(args, env, two_rows=False):
    entry = ["-c", _TWO_ROWS] if two_rows else ["-m", "deacon_tpu_torch"]
    return subprocess.Popen(
        [sys.executable, *entry, *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
        env=_env(env))


def _wait_all(procs, limit=LIMIT_S):
    """(return codes, stderr texts); kills every process when one runs
    past ``limit`` seconds."""
    deadline = time.monotonic() + limit
    outs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=max(1.0, deadline -
                                               time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(err.decode())
    return [p.returncode for p in procs], outs


def _ranks(n, args, extra=None, coord=True, args_of=None, two_rows=False):
    """Run ``n`` ranks of one command (each with two data rows:
    ``two_rows``); returns (return codes, stderrs)."""
    port = _free_port()
    procs = []
    for r in range(n):
        env = {"DEACON_NUM_PROC": n, "DEACON_PROC_ID": r, **(extra or {})}
        if coord:
            env["DEACON_COORD"] = f"127.0.0.1:{port}"
        procs.append(_spawn(args_of(r) if args_of else args, env, two_rows))
    return _wait_all(procs)


def _fastq(path, recs):
    with open(path, "wb") as f:
        for name, seq in recs:
            f.write(b"@%s\n%s\n+\n%s\n" % (name, seq, b"I" * len(seq)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pod")
    rng = np.random.default_rng(2024)
    genome = rng.choice(_B, 30_000).tobytes()
    write_index(compute_minimizer_hashes(genome, 31, 15),
                IndexHeader.new(31, 15), tmp / "ref.idx")
    with open(tmp / "ref.fa", "wb") as f:
        for i in range(9):
            f.write(b">chr%d\n" % i)
            part = genome[i * 3300:(i + 1) * 3300]
            for j in range(0, len(part), 70):
                f.write(part[j:j + 70] + b"\n")

    def read(n):
        if rng.random() < 0.5:
            s = int(rng.integers(0, len(genome) - n))
            r = genome[s:s + n]
            return r.translate(_COMP)[::-1] if rng.random() < 0.5 else r
        return rng.choice(_B, n).tobytes()

    single = [(b"r%d" % i, read(int(rng.integers(40, 700))))
              for i in range(240)]
    single += [(b"long", read(9000)), (b"short", b"ACGTACGT")]
    _fastq(tmp / "s.fq", single)
    (tmp / "s.fq.gz").write_bytes(
        bgzf_compress((tmp / "s.fq").read_bytes(), block=4096))
    pairs = [(read(150), read(int(rng.integers(60, 250))))
             for _ in range(120)]
    _fastq(tmp / "r1.fq", [(b"p%d/1" % i, a) for i, (a, _) in
                           enumerate(pairs)])
    _fastq(tmp / "r2.fq", [(b"p%d/2" % i, b) for i, (_, b) in
                           enumerate(pairs)])
    # ONT-like long reads, some with poly-A or dinucleotide stretches whose
    # rows select more minimizers than their slot budget: an on-card rerun
    ont = [read(int(rng.integers(2000, 9000))) for _ in range(10)]
    ont[2] = ont[2][:1500] + b"A" * 4000 + ont[2][1500:]
    ont[6] = b"AC" * 700 + ont[6][:500]
    ont[8] = b"T" * 1500
    _fastq(tmp / "ont.fq", [(b"ont%d" % i, r) for i, r in enumerate(ont)])
    return tmp


def _jax_filter(data, inputs, flags, name):
    out = data / f"jax_{name}.fq"
    out2 = data / f"jax_{name}_2.fq"
    argv = ["filter", str(data / "ref.idx"), *[str(data / i) for i in inputs],
            "-o", str(out), "-q", *flags]
    if len(inputs) == 2:
        argv += ["-O", str(out2)]
    assert jax_main(argv) == 0
    return out.read_bytes(), out2.read_bytes() if len(inputs) == 2 else None


@pytest.mark.parametrize("inputs,flags", [
    (["s.fq"], []), (["s.fq"], ["-d"]), (["r1.fq", "r2.fq"], ["-a", "1"])])
def test_filter_pod_two_ranks_match_jax(data, inputs, flags):
    name = f"pod_{len(inputs)}_{len(flags)}"
    want = _jax_filter(data, inputs, flags, name)

    def args_of(r):
        argv = ["filter", data / "ref.idx", *[data / i for i in inputs],
                "-o", data / f"{name}.{r}.fq", *flags, "--device", "cpu",
                "--mesh", "pod"]
        if len(inputs) == 2:
            argv += ["-O", data / f"{name}.{r}_2.fq"]
        return argv

    rcs, errs = _ranks(2, None, args_of=args_of)
    assert rcs == [0, 0], errs
    for r in range(2):
        assert "Engine: sharded device pipeline (mesh data=1 x shard=2; " \
               "collectives over gloo)" in errs[r]
        assert (data / f"{name}.{r}.fq").read_bytes() == want[0]
        if len(inputs) == 2:
            assert (data / f"{name}.{r}_2.fq").read_bytes() == want[1]
    assert want[0]


#: small tiles, so that a few hundred reads make many batches for the
#: data rows to take in turn (decisions do not depend on the tiles)
_SMALL_TILES = "256:64,2048:16,16384:4"


@pytest.mark.parametrize("inputs,flags", [
    (["s.fq"], []), (["ont.fq"], []), (["ont.fq"], ["-d"]),
    (["r1.fq", "r2.fq"], ["-a", "1"]), (["r1.fq", "r2.fq"], ["-d"])])
def test_filter_pod_two_data_rows_a_rank_match_jax(data, inputs, flags):
    """Two ranks of ``--mesh pod`` whose meshes hold two data rows each
    (a process driving several devices, as the JAX pod mesh puts every
    chip of a host on its data axis): batches alternate over the rows,
    each batch's hits are all-reduced over the ranks, and each rank's
    output is the JAX package's one-process ``filter``, byte for byte.
    Both ranks take the same row for every batch, reruns included
    (ont.fq's low-complexity rows exceed their slot budget)."""
    name = f"rows_{inputs[0][:-3]}{len(inputs)}_{len(flags)}"
    want = _jax_filter(data, inputs, flags, name)

    def args_of(r):
        argv = ["filter", data / "ref.idx", *[data / i for i in inputs],
                "-o", data / f"{name}.{r}.fq", *flags, "--device", "cpu",
                "--mesh", "pod"]
        if len(inputs) == 2:
            argv += ["-O", data / f"{name}.{r}_2.fq"]
        return argv

    rcs, errs = _ranks(2, None, args_of=args_of, two_rows=True,
                       extra={"DEACON_TPU_TILES": _SMALL_TILES})
    assert rcs == [0, 0], errs
    spies = []
    for r in range(2):
        assert "Engine: sharded device pipeline (mesh data=2 x shard=2; " \
               "collectives over gloo)" in errs[r]
        assert (data / f"{name}.{r}.fq").read_bytes() == want[0]
        if len(inputs) == 2:
            assert (data / f"{name}.{r}_2.fq").read_bytes() == want[1]
        spies.append([ln for ln in errs[r].splitlines()
                      if ln.startswith("two rows: ")][-1].split())
    assert spies[0] == spies[1]
    turns, reruns = spies[0][3], int(spies[0][5])
    assert set(turns) == {"0", "1"} and len(turns) >= 4
    assert (reruns >= 2) == (inputs == ["ont.fq"])
    assert want[0] or flags == ["-d"]


@pytest.mark.parametrize("inputs", [["s.fq"], ["s.fq.gz"],
                                    ["r1.fq", "r2.fq"]])
def test_filter_pod_data_two_ranks_match_jax(data, inputs):
    name = "pd_" + inputs[0].replace(".", "_") + str(len(inputs))
    want = _jax_filter(data, inputs, ["-a", "1"], name)
    out = data / f"{name}.fq"
    argv = ["filter", data / "ref.idx", *[data / i for i in inputs], "-o",
            out, "-a", "1", "--device", "cpu", "--mesh", "pod-data"]
    if len(inputs) == 2:
        argv += ["-O", data / f"{name}_2.fq"]
    rcs, errs = _ranks(2, argv, coord=False)
    assert rcs == [0, 0], errs
    assert out.read_bytes() == want[0]
    if len(inputs) == 2:
        assert (data / f"{name}_2.fq").read_bytes() == want[1]
    assert "Retained" in errs[0] and "Retained" not in errs[1]
    assert not list(data.glob(f"{name}*.pod*"))  # parts merged, removed


def test_filter_pod_debug_lines_match_jax(data, capsys):
    """--debug on a pod mesh, where no process holds the index: host
    extraction, membership through each rank's block
    (ShardedPipeline.probe_hashes) summed over the ranks; every rank's
    DEBUG lines are the JAX package's one-process lines."""
    reads = data / "dbg.fq"
    with open(data / "s.fq", "rb") as f:
        reads.write_bytes(b"".join(f.readline() for _ in range(4 * 40)))
    capsys.readouterr()
    assert jax_main(["filter", str(data / "ref.idx"), str(reads), "-o",
                     str(data / "jax_dbg.fq"), "--debug"]) == 0
    want = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("DEBUG:")]
    rcs, errs = _ranks(2, None, args_of=lambda r: [
        "filter", data / "ref.idx", reads, "-o", data / f"dbg{r}.fq",
        "--debug", "--device", "cpu", "--mesh", "pod"])
    assert rcs == [0, 0], errs
    for r in range(2):
        got = [ln for ln in errs[r].splitlines() if ln.startswith("DEBUG:")]
        assert got == want and len(want) == 40
        assert ((data / f"dbg{r}.fq").read_bytes()
                == (data / "jax_dbg.fq").read_bytes())


def test_filter_pod_data_local_mesh_matches_jax(data, monkeypatch):
    """pod-data with DEACON_POD_LOCAL_MESH=1x3 (a rank-local mesh of the
    CPU, its blocks built from the file) in one rank, in process."""
    want = _jax_filter(data, ["s.fq"], [], "local_mesh")
    for k in ("DEACON_COORD", "DEACON_POD_ENGINE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DEACON_NUM_PROC", "1")
    monkeypatch.setenv("DEACON_PROC_ID", "0")
    monkeypatch.setenv("DEACON_POD_LOCAL_MESH", "1x3")
    out = data / "local_mesh.fq"
    assert torch_main(["filter", str(data / "ref.idx"), str(data / "s.fq"),
                       "-o", str(out), "-q", "--device", "cpu", "--mesh",
                       "pod-data"]) == 0
    assert out.read_bytes() == want[0]


def test_filter_pod_2d_four_ranks_match_jax(data):
    want = _jax_filter(data, ["s.fq"], ["-d"], "p2d")
    out = data / "p2d.fq"
    rcs, errs = _ranks(4, ["filter", data / "ref.idx", data / "s.fq", "-o",
                           out, "-d", "--device", "cpu", "--mesh", "pod-2d"],
                       extra={"DEACON_POD_SHARDS": 2})
    assert rcs == [0, 0, 0, 0], errs
    assert out.read_bytes() == want[0]


def test_index_build_pod_data_matches_jax(data):
    want = data / "jax_build.idx"
    assert jax_main(["index", "build", str(data / "ref.fa"), "-o", str(want),
                     "-q"]) == 0
    got = data / "pod_build.idx"
    rcs, errs = _ranks(2, ["index", "build", data / "ref.fa", "-o", got,
                           "--device", "cpu", "--mesh", "pod-data"],
                       coord=False)
    assert rcs == [0, 0], errs
    assert got.read_bytes() == want.read_bytes()
    assert "mode: build (pod-data, 2 rank(s))" in errs[0]


@pytest.mark.parametrize("every,members,rank,shape,backend,groups", [
    # uneven card counts: every rank gets as many rows as the fewest
    ([["a", "b", "c"], ["d"]], [0, 1], 0, (1, 2), "nccl", [[0, 1]]),
    ([["a", "b"], ["c", "d"]], [0, 1], 1, (2, 2), "nccl", [[0, 1]]),
    # ranks that see the same cards (no CUDA_VISIBLE_DEVICES cut)
    ([["a", "b", "c", "d"]] * 2, [0, 1], 0, (4, 2), "gloo", []),
    # pod-2d groups of one rank each, two cards a rank
    ([["a", "b"], ["c", "d"]], [1], 1, (2, 1), "nccl", [[0], [1]]),
    ([["a", "b"], ["c", "d"], ["e"], ["f", "g"]], [2, 3], 3, (1, 2),
     "nccl", [[0, 1], [2, 3]]),
    ([["cpu"], ["cpu"]], [0, 1], 0, (1, 2), "gloo", []),
])
def test_pod_mesh_rows_and_backend(monkeypatch, every, members, rank,
                                   shape, backend, groups):
    """The per-rank rule of make_pod_mesh and make_pod2d_group_mesh, as
    in the JAX package (deacon_tpu/parallel/multihost.py:76, :138): data
    rows = the fewest cards of a group member, nccl only when every
    rank's cards are distinct cards, one communicator per group in the
    same order on every rank (the cards faked: no card here)."""
    import torch

    from deacon_tpu_torch.parallel import multihost

    made = []
    monkeypatch.setattr(multihost, "_gather_devices", lambda devs: every)
    monkeypatch.setattr(multihost.dist, "new_group",
                        lambda ranks, backend: made.append(
                            (ranks, backend)) or f"group{ranks}")
    on_cpu = every[rank] == ["cpu"]
    devices = ([torch.device("cpu")] if on_cpu else
               [torch.device("cuda", i) for i in range(len(every[rank]))])
    mesh = multihost._pod_mesh(devices, members, rank)
    assert (mesh.shape["data"], mesh.shape["shard"]) == shape
    assert mesh.devices == tuple((d,) for d in devices[:shape[0]])
    assert mesh.backend == backend and mesh.shard == members.index(rank)
    assert made == [(g, backend) for g in groups]
    assert mesh.group == (f"group{members}" if groups else None)


def _wait_http(url, procs, limit=LIMIT_S):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        if any(p.poll() is not None for p in procs):
            return False
        try:
            urllib.request.urlopen(url, timeout=2).read()
            return True
        except OSError:
            time.sleep(0.2)
    return False


def test_server_pod_two_ranks_answers_client(data, capsys):
    coord, http = _free_port(), _free_port()
    procs = [_spawn(["server", data / "ref.idx", "-p", http, "--host",
                     "127.0.0.1", "--device", "cpu", "--mesh", "pod"],
                    {"DEACON_COORD": f"127.0.0.1:{coord}",
                     "DEACON_NUM_PROC": 2, "DEACON_PROC_ID": r})
             for r in range(2)]
    try:
        assert _wait_http(f"http://127.0.0.1:{http}/", procs)
        for inputs in (["s.fq"], ["r1.fq", "r2.fq"]):
            argv = [*[str(data / i) for i in inputs], "-a", "1", "-q"]
            assert torch_main(["client", f"http://127.0.0.1:{http}", *argv,
                               "-o", str(data / "pod_client.fq")]) == 0
            assert torch_main(["filter", str(data / "ref.idx"), *argv,
                               "-o", str(data / "pod_local.fq"),
                               "--device", "cpu"]) == 0
            assert ((data / "pod_client.fq").read_bytes()
                    == (data / "pod_local.fq").read_bytes())
    finally:
        procs[0].send_signal(signal.SIGINT)
        rcs, errs = _wait_all(procs)
    assert rcs == [0, 0], errs
    assert "Pod worker rank 1: mirroring rank 0 probes" in errs[1]
    assert "Index sharded on pod mesh data=1 x shard=2" in errs[0]


def test_server_pod_keep_alive_two_data_rows(data):
    """``server --mesh pod`` on two ranks with two data rows each, left
    idle for longer than the process group's timeout: rank 0's keep-alive
    (a size of -1 every HEARTBEAT_S) keeps the worker's wait short, and
    the next ``client`` is answered exactly (the JAX package's
    one-process ``filter``). The timeout and the period are cut to 8 s
    and 1 s from 600 s and 150 s; both ranks exit 0 after SIGINT."""
    want = _jax_filter(data, ["s.fq"], [], "alive")
    coord, http = _free_port(), _free_port()
    procs = [_spawn(["--heartbeat", 8, 1, "server", data / "ref.idx", "-p",
                     http, "--host", "127.0.0.1", "--device", "cpu",
                     "--mesh", "pod"],
                    {"DEACON_COORD": f"127.0.0.1:{coord}",
                     "DEACON_NUM_PROC": 2, "DEACON_PROC_ID": r},
                    two_rows=True)
             for r in range(2)]
    try:
        assert _wait_http(f"http://127.0.0.1:{http}/", procs)
        for i in range(2):
            if i:
                time.sleep(10)
            out = data / f"alive{i}.fq"
            assert torch_main(["client", f"http://127.0.0.1:{http}",
                               str(data / "s.fq"), "-o", str(out),
                               "-q"]) == 0
            assert out.read_bytes() == want[0]
    finally:
        procs[0].send_signal(signal.SIGINT)
        rcs, errs = _wait_all(procs)
    assert rcs == [0, 0], errs
    assert "Index sharded on pod mesh data=2 x shard=2" in errs[0]


def test_server_mesh_1x2_through_library(data):
    httpd = make_server(str(data / "ref.idx"), 0, host="127.0.0.1",
                        device="cpu", mesh="1x2")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        assert len(httpd.state.probe.probes) == 2
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        argv = [str(data / "s.fq"), "-a", "1", "-q"]
        assert torch_main(["client", url, *argv, "-o",
                           str(data / "mesh_client.fq")]) == 0
        assert torch_main(["filter", str(data / "ref.idx"), *argv, "-o",
                           str(data / "mesh_local.fq"), "--device",
                           "cpu"]) == 0
        assert ((data / "mesh_client.fq").read_bytes()
                == (data / "mesh_local.fq").read_bytes())
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("case", [
    "pod2d_no_shards", "pod2d_bad_shards", "paired_bgzf", "rename",
    "stdin"])
def test_validation_errors_match_jax(data, capsys, monkeypatch, case):
    env = {"DEACON_NUM_PROC": "2", "DEACON_PROC_ID": "0"}
    inputs = [str(data / "s.fq")]
    mesh, extra = "pod-data", []
    if case.startswith("pod2d"):
        mesh = "pod-2d"
        if case == "pod2d_bad_shards":
            env["DEACON_POD_SHARDS"] = "3"
    elif case == "paired_bgzf":
        inputs = [str(data / "s.fq.gz"), str(data / "r2.fq")]
    elif case == "rename":
        extra = ["--rename"]
    else:
        inputs = ["-"]
    for k in ("DEACON_COORD", "DEACON_POD_SHARDS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    errs = {}
    for tool, main, dev in (("torch", torch_main, ["--device", "cpu"]),
                            ("jax", jax_main, [])):
        capsys.readouterr()
        assert main(["filter", str(data / "ref.idx"), *inputs, "-o",
                     str(data / f"bad_{case}.fq"), "-q", "--mesh", mesh,
                     *extra, *dev]) == 1
        errs[tool] = capsys.readouterr().err.strip().splitlines()[-1]
    assert errs["torch"] == errs["jax"]
    assert errs["torch"].startswith("Error: ")


def test_pod_without_coordinator_is_refused(data, capsys, monkeypatch):
    monkeypatch.delenv("DEACON_COORD", raising=False)
    assert torch_main(["filter", str(data / "ref.idx"), str(data / "s.fq"),
                       "-o", str(data / "nocoord.fq"), "-q", "--mesh",
                       "pod", "--device", "cpu"]) == 1
    assert ("Error: --mesh pod needs torch.distributed: set DEACON_COORD, "
            "DEACON_NUM_PROC and DEACON_PROC_ID on every rank"
            in capsys.readouterr().err)


def test_block_error_in_one_rank_fails_every_rank(data):
    """Rank 1 reads a copy of the index whose payload is cut short: its
    block cannot be built, and both ranks exit 1 at the agreement point
    (rank 0 without a hang, with the peer's message)."""
    raw = (data / "ref.idx").read_bytes()
    (data / "cut.idx").write_bytes(raw[:len(raw) // 2])
    rcs, errs = _ranks(2, None, args_of=lambda r: [
        "filter", data / ("cut.idx" if r else "ref.idx"), data / "s.fq",
        "-o", data / f"cut{r}.fq", "-q", "--device", "cpu", "--mesh",
        "pod"])
    assert rcs == [1, 1], errs
    assert "Truncated or malformed bincode u64 stream" in errs[1]
    assert "a peer process failed to build its block" in errs[0]
