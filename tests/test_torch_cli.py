"""``deacon_tpu_torch filter|index --device cpu`` against ``deacon_tpu``.

The cases of tests/test_cli_filter.py: search and deplete, single, paired
and interleaved input, -O, -a/-r/-p/--rename, FASTA, compressed output,
--debug and the summary JSON. The port's output must be byte-identical
(compressed outputs: after decompression, since a gzip header carries a
timestamp) and its summary equal apart from the program name and the
timings. ``index build`` (k = 31 and the wide k = 41, with and without
-e, from a file or stdin, to a file or stdout) must write the JAX CLI's
index byte for byte, ``index info`` print its lines, and ``filter``
against a k = 41 index give the JAX CLI's output.
"""

import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from deacon_tpu.cli import main as jax_main  # noqa: E402
from deacon_tpu.index.store import write_index as jax_write_index  # noqa: E402
from deacon_tpu_torch.cli import main as torch_main  # noqa: E402
from deacon_tpu_torch.index.store import IndexHeader, load_index, write_index  # noqa: E402
from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
_B = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _rs(rng, n):
    return rng.choice(_B, size=n).tobytes()


def _fastq(path, recs):
    with open(path, "wb") as f:
        for name, seq in recs:
            f.write(b"@%s\n%s\n+\n%s\n" % (name, seq, b"I" * len(seq)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(31)
    genome = _rs(rng, 20_000)
    hashes = compute_minimizer_hashes(genome, 31, 15)
    idx = tmp / "ref.idx"
    write_index(hashes, IndexHeader.new(31, 15), idx)
    jax_write_index(hashes, IndexHeader.new(31, 15), tmp / "jax.idx")

    def read(n):
        if rng.random() < 0.5:
            s = int(rng.integers(0, len(genome) - n))
            r = genome[s:s + n]
            return r.translate(_COMP)[::-1] if rng.random() < 0.5 else r
        return _rs(rng, n)

    single = [(b"r%d" % i, read(int(rng.integers(40, 400))))
              for i in range(120)]
    single += [(b"long", read(6000)), (b"nrun", b"N" * 50 + read(200)),
               (b"short", b"ACGTACGT")]
    _fastq(tmp / "s.fq", single)
    pairs = [(read(150), read(150)) for _ in range(60)]
    _fastq(tmp / "r1.fq", [(b"p%d/1" % i, a) for i, (a, _) in enumerate(pairs)])
    _fastq(tmp / "r2.fq", [(b"p%d/2" % i, b) for i, (_, b) in enumerate(pairs)])
    with open(tmp / "inter.fq", "wb") as f:
        for i, (a, b) in enumerate(pairs):
            f.write(b"@p%d/1\n%s\n+\n%s\n@p%d/2\n%s\n+\n%s\n"
                    % (i, a, b"I" * len(a), i, b, b"I" * len(b)))
    with open(tmp / "s.fa", "wb") as f:
        for name, seq in single[:40]:
            f.write(b">" + name + b"\n")
            for j in range(0, len(seq), 60):
                f.write(seq[j:j + 60] + b"\n")
    return tmp


def test_index_files_byte_identical(data):
    assert (data / "ref.idx").read_bytes() == (data / "jax.idx").read_bytes()
    idx = load_index(data / "ref.idx")
    assert idx.header.kmer_length == 31 and len(idx) > 0


def _read(path):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, "rb").read()
    return open(p, "rb").read()


def _summary(path):
    s = json.loads(Path(path).read_text())
    for key in ("version", "time", "seqs_per_second", "bp_per_second",
                "output", "output2"):
        s.pop(key)
    return s


CASES = {
    "search": (["s.fq"], ["-a", "1"]),
    "deplete": (["s.fq"], ["-a", "1", "--deplete"]),
    "abs2_rel": (["s.fq"], ["-a", "2", "-r", "0.2"]),
    "rel_one": (["s.fq"], ["-a", "1", "-r", "1.0"]),
    "prefix_rename": (["s.fq"], ["-a", "1", "-p", "60", "--rename"]),
    "fasta": (["s.fa"], ["-a", "1"]),
    "paired": (["r1.fq", "r2.fq"], ["-a", "1"]),
    "paired_split_deplete": (["r1.fq", "r2.fq"], ["-a", "2", "-d", "-O"]),
    "paired_rename": (["r1.fq", "r2.fq"], ["-a", "1", "-R"]),
    "gzip": (["s.fq"], ["-a", "1", "--gz"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_filter_output_matches_jax_cli(data, case):
    inputs, flags = CASES[case]
    outs = {}
    for tool, main in (("torch", torch_main), ("jax", jax_main)):
        ext = ".fq.gz" if "--gz" in flags else ".fq"
        out = data / f"{case}_{tool}{ext}"
        out2 = data / f"{case}_{tool}_2.fq"
        summ = data / f"{case}_{tool}.json"
        args = ["filter", str(data / "ref.idx"),
                *(str(data / i) for i in inputs), "-o", str(out), "-q",
                "-s", str(summ)]
        for f in flags:
            if f == "-O":
                args += ["-O", str(out2)]
            elif f != "--gz":
                args.append(f)
        args += ["--device", "cpu" if tool == "torch" else "numpy"]
        assert main(args) == 0
        outs[tool] = (_read(out), _read(out2) if "-O" in flags else b"",
                      _summary(summ))
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] or outs["torch"][1] or case == "deplete"


def _cli(module, args, stdin=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], input=stdin,
                          capture_output=True, cwd=REPO, env=env)


@pytest.mark.parametrize("deplete", [False, True])
def test_interleaved_stdin_matches_jax_cli(data, deplete):
    stdin = (data / "inter.fq").read_bytes()
    flags = ["-a", "1", "-q"] + (["-d"] if deplete else [])
    got = _cli("deacon_tpu_torch",
               ["filter", str(data / "ref.idx"), "-", "-", *flags,
                "--device", "cpu"], stdin)
    want = _cli("deacon_tpu",
                ["filter", str(data / "ref.idx"), "-", "-", *flags,
                 "--device", "numpy"], stdin)
    assert got.returncode == 0 and want.returncode == 0, got.stderr
    assert got.stdout == want.stdout and got.stdout


def test_debug_lines_match_jax_cli(data, capsys):
    lines = {}
    for tool, main, dev in (("torch", torch_main, "cpu"),
                            ("jax", jax_main, "numpy")):
        assert main(["filter", str(data / "ref.idx"), str(data / "s.fq"),
                     "-o", str(data / f"dbg_{tool}.fq"), "-a", "1",
                     "--debug", "--device", dev]) == 0
        err = capsys.readouterr().err
        lines[tool] = [ln for ln in err.splitlines() if ln.startswith("DEBUG")]
    assert lines["torch"] == lines["jax"] and lines["torch"]


def test_odd_interleaved_input_and_bad_device_fail(data):
    stdin = b"@a\nACGTACGTACGT\n+\nIIIIIIIIIIII\n"
    proc = _cli("deacon_tpu_torch",
                ["filter", str(data / "ref.idx"), "-", "-", "-q",
                 "--device", "cpu"], stdin)
    assert proc.returncode != 0
    assert b"Uneven number of interleaved" in proc.stderr
    with pytest.raises(SystemExit):
        torch_main(["filter", str(data / "ref.idx"), "--device", "tpu"])


# ---------------------------------------------------------------------------
# index build and info; filter on the wide-k (u128) path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Multi-record FASTA with N runs, IUPAC codes, lowercase, a poly-A
    stretch (rows over their slot budget), a record below k and one above
    the largest tile (chunked)."""
    tmp = tmp_path_factory.mktemp("torch_index")
    rng = np.random.default_rng(41)
    recs = []
    for i in range(6):
        s = bytearray(_rs(rng, int(rng.integers(3000, 9000))))
        s[200:260] = b"N" * 60
        s[700:720] = b"RYKMSWBDHVryk" + b"acgtacg"
        s[1500:1800] = bytes(s[1500:1800]).lower()
        recs.append((b"rec%d desc %d" % (i, i), bytes(s)))
    recs.append((b"polyA", _rs(rng, 400) + b"A" * 1500 + _rs(rng, 400)))
    recs.append((b"tiny", b"ACGTACGTAC"))
    recs.append((b"chunked", _rs(rng, 40_000)))
    path = tmp / "ref.fa"
    with open(path, "wb") as f:
        for name, seq in recs:
            f.write(b">" + name + b"\n")
            for j in range(0, len(seq), 70):
                f.write(seq[j:j + 70] + b"\n")
    return tmp, path, recs


def _stderr_lines(err: bytes):
    """The program's own standard-error lines that carry no program name,
    engine or timing (the JAX CLI may add its compiler's warnings)."""
    return [ln for ln in err.decode().splitlines()
            if ln.startswith(("  ", "Building", "Indexed", "Index info"))]


@pytest.mark.parametrize("k,e", [(31, None), (31, "0.5"), (41, None),
                                 (41, "0.5")])
def test_index_build_matches_jax_cli(fasta, k, e):
    tmp, path, _ = fasta
    flags = ["-k", str(k), "-w", "15"] + (["-e", e] if e else [])
    got = _cli("deacon_tpu_torch", ["index", "build", str(path), "-o",
                                    str(tmp / f"t{k}{e}.idx"), *flags,
                                    "--device", "cpu"])
    want = _cli("deacon_tpu", ["index", "build", str(path), "-o",
                               str(tmp / f"j{k}{e}.idx"), *flags])
    assert got.returncode == 0 and want.returncode == 0, got.stderr
    assert (tmp / f"t{k}{e}.idx").read_bytes() == (
        tmp / f"j{k}{e}.idx").read_bytes()
    assert _stderr_lines(got.stderr) == _stderr_lines(want.stderr)
    info = {}
    for tool in ("torch", "jax"):
        p = _cli("deacon_tpu_torch" if tool == "torch" else "deacon_tpu",
                 ["index", "info", str(tmp / f"t{k}{e}.idx")])
        assert p.returncode == 0
        info[tool] = _stderr_lines(p.stderr)
    assert info["torch"] == info["jax"]
    assert f"  K-mer length (k): {k}" in info["torch"]


def test_index_build_stdin_to_stdout_matches_jax_cli(fasta):
    tmp, path, _ = fasta
    data = path.read_bytes()
    flags = ["index", "build", "-", "-k", "41", "-w", "15", "-q"]
    got = _cli("deacon_tpu_torch", [*flags, "--device", "cpu"], data)
    want = _cli("deacon_tpu", flags, data)
    assert got.returncode == 0 and want.returncode == 0, got.stderr
    assert got.stdout == want.stdout and len(got.stdout) > 1000
    assert _stderr_lines(got.stderr) == _stderr_lines(want.stderr)


def test_index_build_rejects_even_l_and_bad_k(fasta):
    tmp, path, _ = fasta
    p = _cli("deacon_tpu_torch", ["index", "build", str(path), "-k", "31",
                                  "-w", "14", "--device", "cpu"])
    assert p.returncode == 1 and b"k + w - 1 must be odd" in p.stderr
    with pytest.raises(SystemExit):
        torch_main(["index", "build", str(path), "-k", "58"])


@pytest.mark.parametrize("deplete", [False, True])
def test_filter_k41_index_matches_jax_cli(fasta, deplete):
    """filter against a k = 41 index built by the port: single and paired,
    byte-identical to the JAX CLI (which runs its host engine here)."""
    tmp, path, recs = fasta
    idx = tmp / "k41.idx"
    if not idx.exists():
        assert torch_main(["index", "build", str(path), "-k", "41", "-w",
                           "15", "-o", str(idx), "-q", "--device",
                           "cpu"]) == 0
    rng = np.random.default_rng(7)
    genome = b"".join(s for _, s in recs)
    reads = []
    for i in range(80):
        n = int(rng.integers(30, 600))
        st = int(rng.integers(0, len(genome) - n))
        r = genome[st:st + n] if i % 2 else _rs(rng, n)
        reads.append(r.translate(_COMP)[::-1] if i % 3 == 0 else r)
    reads.append(b"G" * 900 + genome[:200])  # rows over their budget
    _fastq(tmp / "k41.fq", [(b"r%d" % i, r) for i, r in enumerate(reads)])
    _fastq(tmp / "k41_1.fq", [(b"p%d/1" % i, r)
                              for i, r in enumerate(reads[::2])])
    _fastq(tmp / "k41_2.fq", [(b"p%d/2" % i, r)
                              for i, r in enumerate(reads[1::2])])
    flags = ["-a", "1", "-q"] + (["--deplete"] if deplete else [])
    for inputs in (["k41.fq"], ["k41_1.fq", "k41_2.fq"]):
        outs = {}
        for tool, main, dev in (("torch", torch_main, "cpu"),
                                ("jax", jax_main, "numpy")):
            out = tmp / f"k41_{tool}.fq"
            summ = tmp / f"k41_{tool}.json"
            assert main(["filter", str(idx), *(str(tmp / i) for i in inputs),
                         "-o", str(out), "-s", str(summ), *flags,
                         "--device", dev]) == 0
            outs[tool] = (out.read_bytes(), _summary(summ))
        assert outs["torch"] == outs["jax"]
        assert outs["torch"][1]["seqs_out"] > 0


def test_debug_lines_k41_match_jax_cli(fasta, capsys):
    """--debug takes the host decider, whose NumPy extraction hashes the
    u128 values of k = 41 as the JAX CLI's does."""
    tmp, path, recs = fasta
    idx = tmp / "k41_debug.idx"
    assert torch_main(["index", "build", str(path), "-k", "41", "-w", "15",
                       "-o", str(idx), "-q", "--device", "cpu"]) == 0
    genome = recs[0][1]
    _fastq(tmp / "dbg41.fq", [(b"d%d" % i, genome[i * 300:i * 300 + 200])
                              for i in range(10)] + [(b"rnd", b"ACGT" * 50)])
    capsys.readouterr()
    lines = {}
    for tool, main, dev in (("torch", torch_main, "cpu"),
                            ("jax", jax_main, "numpy")):
        assert main(["filter", str(idx), str(tmp / "dbg41.fq"), "-o",
                     str(tmp / f"dbg41_{tool}.fq"), "-a", "1", "--debug",
                     "--device", dev]) == 0
        err = capsys.readouterr().err
        lines[tool] = [ln for ln in err.splitlines() if ln.startswith("DEBUG")]
    assert lines["torch"] == lines["jax"] and len(lines["torch"]) == 11
