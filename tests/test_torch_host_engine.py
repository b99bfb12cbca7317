"""``filter --device host``: the port's host engine (the host library's
whole pipeline) against the JAX package's native engine (its CLI's
``--device auto`` on a small index) and against the port's own
``--device cpu``, on the same seeded inputs: the counterparts of
tests/test_native_pipeline.py, a sidecar written by each package and
loaded by the other, and a k = 41 index. Outputs are compared byte for
byte with the JAX engine's (both compress through the same encoders)
and after decompression with ``--device cpu``'s (whose .gz is one
zlib stream, not BGZF); summaries apart from the program and the
timings.
"""

import gzip
import json
import lzma
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import zstandard

from deacon_tpu.cli import main as jax_main
from deacon_tpu.io import native_loader as jax_native
from deacon_tpu_torch.cli import main as torch_main
from deacon_tpu_torch.index.store import (
    IndexHeader,
    load_header_and_count,
    load_index,
    write_index,
)
from deacon_tpu_torch.io import native_loader
from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes
from helpers import BGZF_EOF

REPO = Path(__file__).resolve().parent.parent
_B = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")
FRAGMENT = b"ATGCGTACGTTAGCCTAGGCATCGATCGGATCCTAGGCGTATCGATGGCATGCAAGCTTG"


def _rs(rng, n) -> bytes:
    return rng.choice(_B, size=n).tobytes()


def _fq(recs) -> bytes:
    return b"".join(b"@%s\n%s\n+\n%s\n" % (n, s, b"I" * len(s))
                    for n, s in recs)


def _content(path) -> bytes:
    data = Path(path).read_bytes()
    p = str(path)
    if p.endswith(".gz"):
        return gzip.decompress(data)
    if p.endswith(".zst"):
        import io

        # one frame per batch: read across frames
        return zstandard.ZstdDecompressor().stream_reader(
            io.BytesIO(data), read_across_frames=True).read()
    if p.endswith(".xz"):
        return lzma.decompress(data)
    return data


def _summary(path) -> dict:
    s = json.loads(Path(path).read_text())
    for key in ("version", "time", "seqs_per_second", "bp_per_second",
                "output", "output2", "index"):
        s.pop(key, None)
    return s


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_host_engine")
    rng = np.random.default_rng(1602)
    genome = FRAGMENT + _rs(rng, 400)
    idx = tmp / "genome.idx"
    write_index(compute_minimizer_hashes(genome, 31, 15),
                IndexHeader.new(31, 15), idx)
    return tmp, idx, rng


@pytest.fixture(scope="module")
def stdin_idx(ctx):
    """A copy of the index with a sidecar: the JAX CLI's --device auto
    takes its native engine for stdin input only from a sidecar (it
    cannot size the input)."""
    tmp, idx, _ = ctx
    copy = tmp / "stdin.idx"
    copy.write_bytes(idx.read_bytes())
    _, count = load_header_and_count(copy)
    table = native_loader.native_probe(load_index(copy).hashes)
    assert native_loader.save_probe_sidecar(table, copy, count)
    return copy


def _reads(rng):
    return [
        (b"match_fwd", FRAGMENT + _rs(rng, 80)),
        (b"match_rev", FRAGMENT.translate(_COMP)[::-1] + _rs(rng, 80)),
        (b"nomatch_a", _rs(rng, 140)),
        (b"nomatch_b", _rs(rng, 139)),
        (b"short", b"ACGTACGT"),  # < k: zero minimizers
        (b"with_n", b"ACGTN" * 30),
    ]


TOOLS = {"host": (torch_main, "host"), "jax": (jax_main, "auto"),
         "cpu": (torch_main, "cpu")}


def _run_all(tmp, idx, name, inputs, flags, ext=".fastq", out2=False):
    """Each tool's (output, output 2, summary) of one filter command."""
    got = {}
    for tool, (main, device) in TOOLS.items():
        out = tmp / f"{name}_{tool}{ext}"
        o2 = tmp / f"{name}_{tool}_2{ext}"
        summ = tmp / f"{name}_{tool}.json"
        args = ["filter", str(idx), *map(str, inputs), "-o", str(out),
                "-s", str(summ), "-q", "--device", device, *flags]
        if out2:
            args += ["-O", str(o2)]
        assert main(args) == 0, (tool, args)
        got[tool] = (out, o2 if out2 else None, _summary(summ))
    return got


def _assert_same(got, compressed_equal=True):
    """The host engine's files equal the JAX engine's byte for byte, and
    --device cpu's after decompression; summaries equal all round."""
    host, jax, cpu = got["host"], got["jax"], got["cpu"]
    for i in (0, 1):
        if host[i] is None:
            continue
        if compressed_equal:
            assert host[i].read_bytes() == jax[i].read_bytes()
        assert _content(host[i]) == _content(jax[i]) == _content(cpu[i])
    assert host[2] == jax[2] == cpu[2]


@pytest.mark.parametrize(
    "name,extra",
    [
        ("search_default", []),
        ("deplete", ["-d"]),
        ("rename", ["-R", "-d"]),
        ("abs3", ["-a", "3"]),
        ("rel_half", ["-r", "0.5", "-a", "1"]),
        ("prefix", ["-p", "60"]),
        ("two_threads", ["-t", "2", "-d"]),
    ],
)
def test_single_fastq_parity(ctx, name, extra):
    tmp, idx, rng = ctx
    reads = tmp / f"{name}.fastq"
    reads.write_bytes(_fq(_reads(rng)))
    got = _run_all(tmp, idx, name, [reads], extra)
    _assert_same(got)
    assert got["host"][2]["seqs_in"] == 6


@pytest.mark.parametrize("ext", [".fasta", ".fastq.gz", ".fastq.zst",
                                 ".fastq.xz"])
def test_output_format_parity(ctx, ext):
    tmp, idx, rng = ctx
    name = "ofmt" + ext.replace(".", "_")
    reads = tmp / f"{name}.fastq"
    reads.write_bytes(_fq(_reads(rng)))
    got = _run_all(tmp, idx, name, [reads], ["-d"], ext=ext)
    _assert_same(got)
    assert _content(got["host"][0])


def test_multiline_fasta_parity(ctx):
    tmp, idx, rng = ctx
    reads = tmp / "ml.fasta"
    with open(reads, "wb") as f:
        for rid, seq in ((b"m1", FRAGMENT + _rs(rng, 100)),
                         (b"m2", _rs(rng, 160))):
            f.write(b">" + rid + b"\n")
            for i in range(0, len(seq), 20):
                f.write(seq[i:i + 20] + b"\n")
    _assert_same(_run_all(tmp, idx, "ml", [reads], [], ext=".fasta"))


def test_gz_input_parity(ctx):
    tmp, idx, rng = ctx
    reads = tmp / "gzin.fastq.gz"
    reads.write_bytes(gzip.compress(_fq(_reads(rng))))
    _assert_same(_run_all(tmp, idx, "gzin", [reads], ["-d"]))


def test_paired_separate_outputs_parity(ctx):
    tmp, idx, rng = ctx
    r1, r2 = tmp / "p_r1.fastq", tmp / "p_r2.fastq"
    # pair-OR: a matching mate 2 removes or keeps both
    r1.write_bytes(_fq([(b"p1/1", _rs(rng, 100)),
                        (b"p2/1", FRAGMENT + _rs(rng, 40)),
                        (b"p3/1", FRAGMENT)]))
    r2.write_bytes(_fq([(b"p1/2", FRAGMENT + _rs(rng, 40)),
                        (b"p2/2", _rs(rng, 100)), (b"p3/2", FRAGMENT)]))
    got = _run_all(tmp, idx, "po", [r1, r2], ["-d", "-R"], out2=True)
    _assert_same(got)
    assert got["host"][2]["seqs_in"] == 6


def test_paired_uneven_files_stop_at_shorter(ctx):
    tmp, idx, rng = ctx
    r1, r2 = tmp / "ue_r1.fastq", tmp / "ue_r2.fastq"
    r1.write_bytes(_fq([(b"u%d/1" % i, _rs(rng, 100)) for i in range(3)]))
    r2.write_bytes(_fq([(b"u1/2", _rs(rng, 100))]))
    got = _run_all(tmp, idx, "uneven", [r1, r2], ["-d"])
    _assert_same(got)
    assert got["host"][2]["seqs_in"] == 2  # one complete pair


def _cli(module, args, stdin: bytes):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          input=stdin, capture_output=True, cwd=REPO,
                          env=env, timeout=300)


def test_interleaved_stdin_parity(ctx, stdin_idx):
    tmp, idx, rng = ctx
    mates = [((b"i1/1", _rs(rng, 100)), (b"i1/2", FRAGMENT + _rs(rng, 40))),
             ((b"i2/1", _rs(rng, 100)), (b"i2/2", _rs(rng, 100)))]
    data = b"".join(_fq(pair) for pair in mates)
    outs = []
    for module, device in (("deacon_tpu_torch", "host"),
                           ("deacon_tpu", "auto")):
        out = tmp / f"il_{module}.fastq"
        proc = _cli(module, ["filter", stdin_idx, "-", "-", "-o", out, "-q",
                             "-d", "--device", device], data)
        assert proc.returncode == 0, proc.stderr.decode()
        outs.append(out.read_bytes())
    # --device cpu on the same pairs as two files writes the same records
    r1, r2 = tmp / "il_r1.fq", tmp / "il_r2.fq"
    r1.write_bytes(_fq([m[0] for m in mates]))
    r2.write_bytes(_fq([m[1] for m in mates]))
    assert torch_main(["filter", str(idx), str(r1), str(r2), "-o",
                       str(tmp / "il_cpu.fq"), "-q", "-d", "--device",
                       "cpu"]) == 0
    assert outs[0] == outs[1] == (tmp / "il_cpu.fq").read_bytes()
    assert outs[0].count(b"@i2/") == 2


def test_interleaved_odd_count_errors(ctx, stdin_idx):
    tmp, _, rng = ctx
    data = _fq([(b"a", _rs(rng, 60)), (b"b", _rs(rng, 60)),
                (b"c", _rs(rng, 60))])
    errs = []
    for module, device in (("deacon_tpu_torch", "host"),
                           ("deacon_tpu", "auto")):
        proc = _cli(module, ["filter", stdin_idx, "-", "-", "--device",
                             device], data)
        assert proc.returncode != 0
        assert b"probe table: sidecar cache" in proc.stderr
        errs.append(proc.stderr.strip().splitlines()[-1])
    assert errs[0] == errs[1]
    assert b"Uneven number of interleaved sequence pairs. Found 3 records" \
        in errs[0]


def test_single_stdin_stdout_parity(ctx, stdin_idx):
    tmp, idx, rng = ctx
    data = _fq(_reads(rng))
    outs = [_cli(module, ["filter", stdin_idx, "-", "-o", "-", "-d",
                          "--device", device], data)
            for module, device in (("deacon_tpu_torch", "host"),
                                   ("deacon_tpu", "auto"))]
    for proc in outs:
        assert proc.returncode == 0, proc.stderr.decode()
        assert b"probe table: sidecar cache" in proc.stderr
    reads = tmp / "stdin_same.fq"
    reads.write_bytes(data)
    assert torch_main(["filter", str(idx), str(reads), "-o",
                       str(tmp / "stdin_cpu.fq"), "-q", "-d", "--device",
                       "cpu"]) == 0
    assert outs[0].stdout == outs[1].stdout == \
        (tmp / "stdin_cpu.fq").read_bytes()
    assert outs[0].stdout.count(b"@nomatch") == 2


def test_empty_input_parity(ctx):
    tmp, idx, _ = ctx
    reads = tmp / "empty.fastq"
    reads.write_bytes(b"")
    got = _run_all(tmp, idx, "empty", [reads], [])
    _assert_same(got)
    assert got["host"][0].read_bytes() == b""
    assert got["host"][2]["seqs_in"] == 0


def test_invalid_compression_level(ctx, capsys):
    tmp, idx, rng = ctx
    reads = tmp / "lvl.fastq"
    reads.write_bytes(_fq([(b"a", _rs(rng, 100))]))
    args = ["filter", str(idx), str(reads), "-o", str(tmp / "x.fastq.gz"),
            "--compression-level", "11", "-q", "--device"]
    assert torch_main(args + ["host"]) == 1
    err = capsys.readouterr().err
    assert "Invalid gzip compression level 11" in err


def _genome_and_reads(tmp, rng, n_reads=20, size=40_000):
    genome = rng.choice(_B, size=size)
    fa = tmp / "g.fa"
    fa.write_bytes(b">g\n" + genome.tobytes() + b"\n")
    recs = []
    for i in range(n_reads):
        s = int(rng.integers(0, genome.size - 400))
        seq = genome[s:s + 400] if i % 2 == 0 else rng.choice(_B, size=400)
        recs.append((b"r%d" % i, seq.tobytes()))
    reads = tmp / "r.fq"
    reads.write_bytes(_fq(recs))
    return genome, fa, reads


def test_probe_sidecar_roundtrip_and_invalidation(tmp_path, monkeypatch,
                                                  capsys):
    """``<index>.probe`` lets a later run skip the key decode and the
    table build, with the same output; it goes stale when the index
    changes, and the next run rebuilds and saves it again."""
    monkeypatch.setenv("DEACON_PROBE_CACHE", "1")
    rng = np.random.default_rng(21)
    genome, fa, reads = _genome_and_reads(tmp_path, rng)
    idx = tmp_path / "g.idx"

    def run(out):
        assert torch_main(["filter", str(idx), str(reads), "-o", str(out),
                           "-d", "--device", "host"]) == 0
        err = capsys.readouterr().err
        return out.read_bytes(), err

    def build():
        assert torch_main(["index", "build", str(fa), "-o", str(idx), "-q",
                           "--device", "host"]) == 0

    build()
    cold, err = run(tmp_path / "cold.fq")
    assert "probe table: built at startup" in err
    sidecar = tmp_path / "g.idx.probe"
    assert sidecar.exists()
    _, count = load_header_and_count(idx)
    assert native_loader.load_probe_sidecar(idx, count) is not None
    warm, err = run(tmp_path / "warm.fq")
    assert "probe table: sidecar cache" in err
    assert warm == cold

    # a rebuilt index with other content invalidates the sidecar
    time.sleep(0.02)  # mtime_ns moves even on coarse filesystems
    fa.write_bytes(b">g\n" + genome[::-1].tobytes() + b"\n")
    build()
    _, count2 = load_header_and_count(idx)
    assert native_loader.load_probe_sidecar(idx, count2) is None
    fresh, err = run(tmp_path / "fresh.fq")
    assert "probe table: built at startup" in err
    assert native_loader.load_probe_sidecar(idx, count2) is not None
    assert torch_main(["filter", str(idx), str(reads), "-o",
                       str(tmp_path / "fresh_cpu.fq"), "-d", "-q",
                       "--device", "cpu"]) == 0
    assert fresh == (tmp_path / "fresh_cpu.fq").read_bytes()


@pytest.mark.parametrize("field", ["count", "size", "mtime"])
def test_stale_sidecar_is_rebuilt_never_used(tmp_path, monkeypatch, capsys,
                                            field):
    """A sidecar bound to another key count, index size or index mtime
    does not load; the run rebuilds the table from the index."""
    monkeypatch.setenv("DEACON_PROBE_CACHE", "1")
    rng = np.random.default_rng(22)
    _, fa, reads = _genome_and_reads(tmp_path, rng)
    idx = tmp_path / "g.idx"
    assert torch_main(["index", "build", str(fa), "-o", str(idx), "-q",
                       "--device", "host"]) == 0
    _, count = load_header_and_count(idx)
    probe = native_loader.native_probe(np.arange(1, 100, dtype=np.uint64))
    st = os.stat(idx)
    if field == "count":
        assert native_loader.save_probe_sidecar(probe, idx, count + 1)
    else:
        assert native_loader.save_probe_sidecar(probe, idx, count)
        if field == "size":
            with open(idx, "ab") as f:
                f.write(b"\0")
            # the trailing byte is past the trailer; keep the mtime
            os.utime(idx, ns=(st.st_atime_ns, st.st_mtime_ns))
        else:
            os.utime(idx, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert native_loader.load_probe_sidecar(idx, count) is None
    assert torch_main(["filter", str(idx), str(reads), "-o",
                       str(tmp_path / "o.fq"), "--device", "host"]) == 0
    assert "probe table: built at startup" in capsys.readouterr().err
    assert native_loader.load_probe_sidecar(idx, count) is not None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sidecar_written_by_either_package_loads_in_the_other(
        tmp_path, monkeypatch, capsys, writer):
    monkeypatch.setenv("DEACON_PROBE_CACHE", "1")
    rng = np.random.default_rng(23)
    _, fa, reads = _genome_and_reads(tmp_path, rng, n_reads=40)
    idx = tmp_path / "g.idx"
    assert torch_main(["index", "build", str(fa), "-o", str(idx), "-q",
                       "--device", "host"]) == 0
    _, count = load_header_and_count(idx)
    outs = {}
    # the writer's run builds and saves the sidecar, the reader's maps it
    order = ["jax", "torch"] if writer == "jax" else ["torch", "jax"]
    for tool in order:
        out = tmp_path / f"{tool}.fq"
        main, device = ((jax_main, "auto") if tool == "jax"
                        else (torch_main, "host"))
        assert main(["filter", str(idx), str(reads), "-o", str(out), "-d",
                     "--device", device]) == 0
        err = capsys.readouterr().err
        want = "built at startup" if tool == writer else "sidecar cache"
        assert f"probe table: {want}" in err, (tool, err)
        outs[tool] = out.read_bytes()
    assert outs["jax"] == outs["torch"]
    assert native_loader.load_probe_sidecar(idx, count) is not None
    assert jax_native.native_probe_load_sidecar(str(idx), count) is not None
    # the same decisions, key by key, from either package's mapping
    table = native_loader.load_probe_sidecar(idx, count)
    q = np.concatenate([compute_minimizer_hashes(fa.read_bytes()[3:2000],
                                                 31, 15),
                        rng.integers(1, 2**63, 500, dtype=np.uint64)])
    want = jax_native.native_probe_load_sidecar(str(idx), count).query(q)
    assert np.array_equal(table.query(q), want) and want.any()


def test_k41_parity(tmp_path):
    rng = np.random.default_rng(41)
    genome = _rs(rng, 20_000)
    idx = tmp_path / "g41.idx"
    write_index(compute_minimizer_hashes(genome, 41, 15),
                IndexHeader.new(41, 15), idx)

    def read(n):
        s = int(rng.integers(0, len(genome) - n))
        r = genome[s:s + n]
        return r.translate(_COMP)[::-1] if rng.random() < 0.5 else r

    recs = [(b"r%d" % i, read(int(rng.integers(60, 400))) if i % 2
             else _rs(rng, int(rng.integers(10, 400)))) for i in range(120)]
    r1 = tmp_path / "r1.fq.gz"
    r1.write_bytes(gzip.compress(_fq(recs)))
    r2 = tmp_path / "r2.fq"
    r2.write_bytes(_fq(recs[2:] + recs[:2]))  # mates of like kind
    got = _run_all(tmp_path, idx, "k41", [r1, r2], ["-a", "1"],
                   ext=".fq.gz", out2=True)
    _assert_same(got)
    assert 0 < got["host"][2]["seqs_out"] < 240


def test_gz_output_is_bgzf(tmp_path):
    """.gz output of the host engine is BGZF by default: gzip-readable,
    ends with the EOF marker, decodes through the port's reader; above
    level 3 zlib writes plain members with the same content."""
    rng = np.random.default_rng(5)
    g = _rs(rng, 5000)
    idx = tmp_path / "g.idx"
    write_index(compute_minimizer_hashes(g, 31, 15), IndexHeader.new(31, 15),
                idx)
    reads = tmp_path / "r.fq"
    reads.write_bytes(_fq([(b"r%d" % i, _rs(rng, 150)) for i in range(200)]))
    out = tmp_path / "o.fq.gz"
    assert torch_main(["filter", str(idx), str(reads), "-o", str(out),
                       "--deplete", "-q", "--device", "host"]) == 0
    raw = out.read_bytes()
    assert raw.endswith(BGZF_EOF)
    assert raw[:4] == b"\x1f\x8b\x08\x04"  # FEXTRA on the first member
    data = gzip.decompress(raw)
    assert data.count(b"@r") == 200
    assert sum(1 for _ in native_loader.NativeFastxReader(str(out))) == 200
    assert torch_main(["filter", str(idx), str(reads), "-o",
                       str(tmp_path / "p.fq.gz"), "--deplete", "-q",
                       "--compression-level", "6", "--device", "host"]) == 0
    praw = (tmp_path / "p.fq.gz").read_bytes()
    assert not praw.endswith(BGZF_EOF)
    assert gzip.decompress(praw) == data


def test_mesh_wins_over_host(ctx, capsys):
    """With --mesh, --device host runs the mesh on the cards, as the JAX
    package's --mesh wins over its device choice: here, with no card,
    both filter and server fail with the card's error."""
    import torch

    tmp, idx, rng = ctx
    reads = tmp / "mesh.fq"
    reads.write_bytes(_fq(_reads(rng)))
    assert not torch.cuda.is_available()  # the tests run on the CPU
    for argv in (["filter", str(idx), str(reads), "-o",
                  str(tmp / "mesh_out.fq"), "--mesh", "1x1"],
                 ["server", str(idx), "-p", "0", "--mesh", "1x1"]):
        capsys.readouterr()
        assert torch_main([*argv, "--device", "host"]) == 1
        err = capsys.readouterr().err
        assert ("need 1 devices, have 0" in err
                or "torch.cuda.is_available() is false" in err), err
        assert "native C++" not in err
