"""``deacon_tpu_torch filter --mesh`` against ``deacon_tpu filter --mesh``.

* ``--device cpu --mesh 2x4`` (the CPU repeated eight times): output,
  ``-O`` output and summary JSON byte-identical to the JAX CLI's
  ``--mesh 2x4`` on its 8 virtual CPU devices, single and paired, search
  and deplete, and the same ``Engine:`` line.
* ``--mesh 1x2 --debug``: the DEBUG lines of the JAX CLI's run.
* One card and ``--mesh 1x1`` (the same 1x1 grid): the same output, each
  with its own ``Engine:`` line.
* A malformed mesh: the JAX CLI's error; ``--mesh pod|pod-data|pod-2d``
  without what the multi-process modes need (DEACON_COORD for pod,
  DEACON_POD_SHARDS for pod-2d, an output file for pod-data's parts): an
  error, exit 1 (tests/test_torch_pod.py runs the modes); ``--mesh 1x2``
  on ``cuda`` with one card: ``need 2 devices, have 1``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deacon_tpu.cli import main as jax_main  # noqa: E402
from deacon_tpu_torch.cli import main as torch_main  # noqa: E402
from deacon_tpu_torch.index.store import IndexHeader, write_index  # noqa: E402
from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes  # noqa: E402

_B = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _fastq(path, recs):
    with open(path, "wb") as f:
        for name, seq in recs:
            f.write(b"@%s\n%s\n+\n%s\n" % (name, seq, b"I" * len(seq)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mesh_cli")
    rng = np.random.default_rng(77)
    genome = rng.choice(_B, size=40_000).tobytes()
    write_index(compute_minimizer_hashes(genome, 31, 15),
                IndexHeader.new(31, 15), tmp / "ref.idx")

    def read(n):
        if rng.random() < 0.5:
            s = int(rng.integers(0, len(genome) - n))
            r = genome[s:s + n]
            return r.translate(_COMP)[::-1] if rng.random() < 0.5 else r
        return rng.choice(_B, size=n).tobytes()

    single = [(b"r%d" % i, read(int(rng.integers(40, 700))))
              for i in range(200)]
    single += [(b"long", read(9000)), (b"nrun", b"N" * 50 + read(200)),
               (b"polyA", read(300) + b"A" * 700), (b"short", b"ACGTACGT")]
    _fastq(tmp / "s.fq", single)
    pairs = [(read(150), read(150)) for _ in range(80)]
    _fastq(tmp / "r1.fq", [(b"p%d/1" % i, a) for i, (a, _) in enumerate(pairs)])
    _fastq(tmp / "r2.fq", [(b"p%d/2" % i, b) for i, (_, b) in enumerate(pairs)])
    return tmp


def _summary(path):
    s = json.loads(Path(path).read_text())
    for key in ("version", "time", "seqs_per_second", "bp_per_second",
                "output", "output2"):
        s.pop(key)
    return s


CASES = {
    "search": (["s.fq"], ["-a", "1"]),
    "deplete_rel": (["s.fq"], ["-a", "2", "-r", "0.1", "--deplete"]),
    "paired_split": (["r1.fq", "r2.fq"], ["-a", "1", "-O"]),
    "paired_deplete": (["r1.fq", "r2.fq"], ["-a", "2", "-d"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_filter_matches_jax_cli(data, capsys, case):
    inputs, flags = CASES[case]
    outs = {}
    for tool, main, extra in (("torch", torch_main, ["--device", "cpu"]),
                              ("jax", jax_main, [])):
        out, out2 = data / f"{case}_{tool}.fq", data / f"{case}_{tool}_2.fq"
        summ = data / f"{case}_{tool}.json"
        args = ["filter", str(data / "ref.idx"),
                *(str(data / i) for i in inputs), "-o", str(out),
                "-s", str(summ), "--mesh", "2x4", *extra]
        for f in flags:
            args += ["-O", str(out2)] if f == "-O" else [f]
        capsys.readouterr()
        assert main(args) == 0
        engine = [ln for ln in capsys.readouterr().err.splitlines()
                  if ln.startswith("Engine:")]
        outs[tool] = (out.read_bytes(),
                      out2.read_bytes() if "-O" in flags else b"",
                      _summary(summ), engine)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][3] == [
        "Engine: sharded device pipeline (mesh data=2 x shard=4)"]
    assert outs["torch"][0] or case.startswith(("deplete", "paired_deplete"))


def test_mesh_debug_lines_match_jax_cli(data, capsys):
    lines = {}
    for tool, main, extra in (("torch", torch_main, ["--device", "cpu"]),
                              ("jax", jax_main, [])):
        assert main(["filter", str(data / "ref.idx"), str(data / "s.fq"),
                     "-o", str(data / f"dbg_{tool}.fq"), "-a", "1",
                     "--debug", "--mesh", "1x2", *extra]) == 0
        err = capsys.readouterr().err
        lines[tool] = [ln for ln in err.splitlines() if ln.startswith("DEBUG")]
    assert lines["torch"] == lines["jax"] and lines["torch"]


@pytest.mark.parametrize("mesh,line", [
    ([], "Engine: device pipeline (cpu)"),
    (["--mesh", "1x1"],
     "Engine: sharded device pipeline (mesh data=1 x shard=1)")])
def test_one_card_and_1x1_mesh_engine_lines(data, capsys, mesh, line):
    outs = {}
    for name, extra in (("one", []), ("this", mesh)):
        out = data / f"engine_{name}_{len(mesh)}.fq"
        capsys.readouterr()
        assert torch_main(["filter", str(data / "ref.idx"),
                           str(data / "s.fq"), "-o", str(out), "-a", "1",
                           "--device", "cpu", *extra]) == 0
        err = capsys.readouterr().err.splitlines()
        outs[name] = (out.read_bytes(),
                      [ln for ln in err if ln.startswith("Engine:")])
    assert outs["this"][1] == [line]
    assert outs["this"][0] == outs["one"][0] and outs["one"][0]


@pytest.mark.parametrize("spec", ["2y4", "0x2", "x3"])
def test_malformed_mesh_fails_as_jax_cli(data, capsys, spec):
    errs = {}
    for tool, main, extra in (("torch", torch_main, ["--device", "cpu"]),
                              ("jax", jax_main, [])):
        capsys.readouterr()
        assert main(["filter", str(data / "ref.idx"), str(data / "s.fq"),
                     "-o", str(data / "bad.fq"), "-q", "--mesh", spec,
                     *extra]) == 1
        errs[tool] = capsys.readouterr().err.strip().splitlines()[-1]
    assert errs["torch"] == errs["jax"] == (
        f"Error: --mesh must be DATAxSHARD (e.g. 2x4), got {spec!r}")


@pytest.mark.parametrize("spec,message", [
    ("pod", "Error: --mesh pod needs torch.distributed: set DEACON_COORD, "
            "DEACON_NUM_PROC and DEACON_PROC_ID on every rank"),
    ("pod-data", "Error: --mesh pod-data writes per-rank part files and "
                 "concatenates them; give -o/-O a file path"),
    ("pod-2d", "Error: --mesh pod-2d requires DEACON_POD_SHARDS (index "
               "shards per group) to divide DEACON_NUM_PROC; got "
               "shards=None, nproc=1"),
])
def test_multi_host_mesh_is_refused(data, capsys, monkeypatch, spec,
                                    message):
    for k in ("DEACON_COORD", "DEACON_NUM_PROC", "DEACON_PROC_ID",
              "DEACON_POD_SHARDS"):
        monkeypatch.delenv(k, raising=False)
    out = "-" if spec == "pod-data" else str(data / f"{spec}.fq")
    assert torch_main(["filter", str(data / "ref.idx"), str(data / "s.fq"),
                       "-o", out, "-q", "--mesh", spec,
                       "--device", "cpu"]) == 1
    assert message in capsys.readouterr().err


def test_mesh_on_cuda_needs_distinct_cards(data, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for debug in ([], ["--debug"]):
        assert torch_main(["filter", str(data / "ref.idx"),
                           str(data / "s.fq"), "-o", str(data / "c.fq"),
                           "-q", "--mesh", "1x2", *debug]) == 1
        assert "Error: need 2 devices, have 1" in capsys.readouterr().err
