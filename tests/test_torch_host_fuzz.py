"""Randomized differential test of ``--device host``: the counterparts of
tests/test_differential_fuzz.py. Each scenario (random k and w, dirty
reads, FASTA or FASTQ, single, paired or interleaved input, plain, gzip,
BGZF or zstd input, random flags and output codec) runs through the
port's host engine, the JAX package's native engine and the port's
``--device cpu``; outputs must agree byte for byte with the JAX engine's
and after decompression with ``--device cpu``'s, summaries apart from
the timings. The chunk-parallel reader is forced on
(DEACON_CHUNK_PARSE=1, the default from 4 cores) with its default and
with a tiny chunk (DEACON_CHUNK_BYTES), and must match the serial
reader on inputs that make it hand over to it mid-stream.
"""

import gzip
import io
import json
import lzma
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import zstandard

from deacon_tpu.cli import main as jax_main
from deacon_tpu_torch.cli import main as torch_main
from deacon_tpu_torch.index.store import (
    IndexHeader,
    load_header_and_count,
    load_index,
    write_index,
)
from deacon_tpu_torch.io import native_loader
from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes
from helpers import bgzf_compress

REPO = Path(__file__).resolve().parent.parent
ALPHABET = np.frombuffer(b"ACGTACGTacgtNnRYX-", dtype=np.uint8)
_B = np.frombuffer(b"ACGT", np.uint8)


def _cli(module, args, stdin: bytes, env=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               **(env or {}))
    return subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          input=stdin, capture_output=True, cwd=REPO,
                          env=env, timeout=300)


def _write_reads(rng, path, n, genome, fmt, maxlen=400):
    with open(path, "wb") as f:
        for i in range(n):
            if rng.random() < 0.5:
                s = int(rng.integers(0, max(1, len(genome) - maxlen)))
                seq = bytes(genome[s:s + int(rng.integers(30, maxlen))])
            else:
                seq = rng.choice(ALPHABET, int(rng.integers(0, maxlen))
                                 ).astype(np.uint8).tobytes()
            rid = b"r%d extra" % i
            if fmt == "fastq":
                f.write(b"@" + rid + b"\n" + seq + b"\n+\n" + b"I" * len(seq)
                        + b"\n")
            else:
                f.write(b">" + rid + b"\n")
                for j in range(0, max(len(seq), 1), 61):
                    f.write(seq[j:j + 61] + b"\n")


def _records(path, fmt):
    raw = Path(path).read_bytes().split(b"\n")
    if fmt == "fastq":
        return [b"\n".join(raw[i:i + 4]) + b"\n"
                for i in range(0, len(raw) - 1, 4)]
    recs, cur = [], []
    for line in raw:
        if line.startswith(b">") and cur:
            recs.append(b"\n".join(cur) + b"\n")
            cur = []
        if line:
            cur.append(line)
    if cur:
        recs.append(b"\n".join(cur) + b"\n")
    return recs


def _maybe_compress_input(rng, path):
    choice = str(rng.choice(["plain", "gz", "bgzf", "zst"],
                            p=[0.4, 0.2, 0.25, 0.15]))
    if choice == "plain":
        return path
    data = Path(path).read_bytes()
    out = Path(str(path) + (".zst" if choice == "zst" else ".gz"))
    if choice == "gz":
        out.write_bytes(gzip.compress(data, 2))
    elif choice == "bgzf":
        block = int(rng.choice([512, 4096, 65280]))
        out.write_bytes(bgzf_compress(data, block=block,
                                      eof_block=bool(rng.random() < 0.8)))
    else:
        out.write_bytes(zstandard.ZstdCompressor().compress(data))
    return out


def _content(p) -> bytes:
    data = Path(p).read_bytes()
    p = str(p)
    if p.endswith(".gz"):
        return gzip.decompress(data)
    if p.endswith(".zst"):
        return zstandard.ZstdDecompressor().stream_reader(
            io.BytesIO(data), read_across_frames=True).read()
    if p.endswith(".xz"):
        return lzma.decompress(data)
    return data


def _summary(path) -> dict:
    s = json.loads(Path(path).read_text())
    for key in ("time", "seqs_per_second", "bp_per_second", "version",
                "output", "output2"):
        s.pop(key, None)
    return s


def _save_sidecar(idx) -> None:
    """The JAX CLI's --device auto takes its native engine for stdin
    input only from a valid sidecar."""
    _, count = load_header_and_count(idx)
    table = native_loader.native_probe(load_index(idx).hashes)
    assert native_loader.save_probe_sidecar(table, idx, count)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_host_engine_differential(tmp_path, monkeypatch, seed):
    rng = np.random.default_rng(seed)
    k = int(rng.choice([31, 21, 41, 15]))
    w = int(rng.choice([15, 11, 7]))
    if (k + w - 1) % 2 == 0:
        w += 1
    genome = rng.choice(_B, 20_000).astype(np.uint8)
    gpath = tmp_path / "g.fa"
    gpath.write_bytes(b">g\n" + genome.tobytes() + b"\n")
    # index build parity: host route, JAX host route, card route on the CPU
    idx = {}
    for tool, main, device in (("host", torch_main, "host"),
                               ("jax", jax_main, "numpy"),
                               ("cpu", torch_main, "cpu")):
        idx[tool] = tmp_path / f"g_{tool}.idx"
        assert main(["index", "build", str(gpath), "-o", str(idx[tool]),
                     "-k", str(k), "-w", str(w), "--quiet", "--device",
                     device]) == 0
    assert idx["host"].read_bytes() == idx["jax"].read_bytes() \
        == idx["cpu"].read_bytes()
    index = idx["host"]

    fmt = "fastq" if rng.random() < 0.7 else "fasta"
    mode = str(rng.choice(["single", "paired", "interleaved"],
                          p=[0.4, 0.4, 0.2]))
    stdin = None
    reads1 = tmp_path / "r1.fq"
    _write_reads(rng, reads1, 40, genome, fmt)
    if mode == "interleaved":
        reads2 = tmp_path / "r2.fq"
        _write_reads(rng, reads2, 40, genome, fmt)
        stdin = b"".join(a + b for a, b in zip(_records(reads1, fmt),
                                                _records(reads2, fmt)))
        inputs = ["-", "-"]
        _save_sidecar(index)
    else:
        inputs = [str(_maybe_compress_input(rng, reads1))]
        if mode == "paired":
            reads2 = tmp_path / "r2.fq"
            _write_reads(rng, reads2, 40, genome, fmt)
            inputs.append(str(_maybe_compress_input(rng, reads2)))
    paired = mode != "single"
    ext = str(rng.choice(["", ".gz", ".zst", ".xz"],
                         p=[0.4, 0.3, 0.15, 0.15]))
    flags = []
    if rng.random() < 0.5:
        flags.append("--deplete")
    if rng.random() < 0.3:
        flags.append("--rename")
    flags += ["-a", str(int(rng.integers(1, 4)))]
    flags += ["-r", str(float(rng.choice([0.0, 0.01, 0.3, 1.0])))]
    if rng.random() < 0.3:
        flags += ["-p", str(int(rng.integers(10, 200)))]
    split = paired and rng.random() < 0.5

    def run(tool, env=None):
        main, device = {"host": (torch_main, "host"),
                        "jax": (jax_main, "auto"),
                        "cpu": (torch_main, "cpu")}[tool]
        tag = tool + ("_chunk" + env.get("DEACON_CHUNK_BYTES", "")
                      if env else "")
        out, out2 = tmp_path / f"{tag}.out{ext}", tmp_path / f"{tag}2{ext}"
        summ = tmp_path / f"{tag}.json"
        args = ["filter", str(index), *inputs, "-o", str(out), "-s",
                str(summ), "--quiet", "--device", device, *flags]
        if split:
            args += ["-O", str(out2)]
        if stdin is not None:
            proc = _cli("deacon_tpu_torch" if main is torch_main
                        else "deacon_tpu", args, stdin, env)
            assert proc.returncode == 0, proc.stderr.decode()
        else:
            with monkeypatch.context() as m:
                for key, val in (env or {}).items():
                    m.setenv(key, val)
                assert main(args) == 0
        return out, out2 if split else None, _summary(summ)

    tools = ("host", "jax") if stdin is not None else ("host", "jax", "cpu")
    got = {tool: run(tool) for tool in tools}
    host = got["host"]
    for i in (0, 1):
        if host[i] is None:
            continue
        assert host[i].read_bytes() == got["jax"][i].read_bytes()
        for tool in tools:
            assert _content(got[tool][i]) == _content(host[i]), tool
    for tool in tools:
        assert got[tool][2] == host[2], tool
    assert host[2]["seqs_in"] > 0

    # the chunk-parallel reader, forced on, with its default chunk and a
    # tiny one (dozens of chunk boundaries, carries, the EOF-tail handoff)
    if mode == "single":
        for env in ({"DEACON_CHUNK_PARSE": "1"},
                    {"DEACON_CHUNK_PARSE": "1", "DEACON_CHUNK_BYTES": "512"}):
            out = run("host", env)[0]
            assert _content(out) == _content(host[0]), env


def _anomalous_fastq(rng, genome, anomaly) -> bytes:
    recs = []
    for i in range(60):
        L = int(rng.integers(50, 300))
        seq = (genome[int(rng.integers(0, genome.size - L)):][:L]
               if i % 2 == 0 else rng.choice(_B, size=L)).tobytes()
        recs.append(b"@q%d\n" % i + seq + b"\n+\n" + b"F" * len(seq) + b"\n")
    data = b"".join(recs)
    if anomaly == "crlf":  # CRLF from midway through the stream
        cut = data.rfind(b"\n@", 0, len(data) // 2) + 1
        return data[:cut] + data[cut:].replace(b"\n", b"\r\n")
    if anomaly == "blank":
        cut = data.rfind(b"\n@", 0, len(data) // 2) + 1
        return data[:cut] + b"\n\n" + data[cut:]
    if anomaly == "no_trailing_nl":
        return data[:-1]
    big = rng.choice(_B, 20_000).tobytes()  # much larger than a chunk
    return b"@big\n" + big + b"\n+\n" + b"E" * len(big) + b"\n" + data


@pytest.mark.parametrize("anomaly", ["crlf", "blank", "no_trailing_nl",
                                     "giant_record"])
def test_chunk_parse_bail_paths(tmp_path, monkeypatch, anomaly):
    """Anomalies past the first chunk hand over to the serial reader with
    the same output; records larger than a chunk accumulate."""
    rng = np.random.default_rng(sum(anomaly.encode()))
    genome = rng.choice(_B, 30_000).astype(np.uint8)
    idx = tmp_path / "g.idx"
    write_index(compute_minimizer_hashes(genome.tobytes(), 31, 15),
                IndexHeader.new(31, 15), idx)
    reads = tmp_path / "r.fq"
    reads.write_bytes(_anomalous_fastq(rng, genome, anomaly))
    outs = []
    for main, device, env in (
            (torch_main, "host", {"DEACON_CHUNK_PARSE": "1",
                                  "DEACON_CHUNK_BYTES": "1024"}),
            (torch_main, "host", {"DEACON_CHUNK_PARSE": "0"}),
            (jax_main, "auto", {"DEACON_CHUNK_PARSE": "1",
                                "DEACON_CHUNK_BYTES": "1024"}),
            (torch_main, "cpu", {})):
        out = tmp_path / f"o_{len(outs)}.fq"
        with monkeypatch.context() as m:
            for key, val in env.items():
                m.setenv(key, val)
            assert main(["filter", str(idx), str(reads), "-o", str(out),
                         "-d", "--quiet", "--device", device]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == outs[2] == outs[3], anomaly
    assert outs[0]


def test_chunk_parse_interleaved_parity(tmp_path):
    """Interleaved FASTQ chunks split at an 8-newline phase; outputs, and
    the odd-count error with its record count spanning the chunked to
    serial handoff, match the serial reader's and the JAX engine's."""
    rng = np.random.default_rng(54)
    genome = rng.choice(_B, 20_000).astype(np.uint8)
    idx = tmp_path / "g.idx"
    write_index(compute_minimizer_hashes(genome.tobytes(), 31, 15),
                IndexHeader.new(31, 15), idx)
    _save_sidecar(idx)
    recs = []
    for i in range(200):
        L = int(rng.integers(60, 500))
        seq = (genome[int(rng.integers(0, genome.size - L)):][:L]
               if i % 3 == 0 else rng.choice(_B, size=L)).tobytes()
        recs.append(b"@p%d/%d\n" % (i // 2, i % 2 + 1) + seq + b"\n+\n"
                    + b"I" * len(seq) + b"\n")
    inter = b"".join(recs)

    def run(module, env, data):
        out = tmp_path / "o.fq"
        proc = _cli(module, ["filter", idx, "-", "-", "-o", out, "-d",
                             "--quiet", "--device",
                             "host" if module == "deacon_tpu_torch"
                             else "auto"], data, env)
        if proc.returncode == 0:
            return 0, out.read_bytes()
        return proc.returncode, proc.stderr.strip().splitlines()[-1]

    chunked = {"DEACON_CHUNK_PARSE": "1", "DEACON_CHUNK_BYTES": "1024"}
    serial = {"DEACON_CHUNK_PARSE": "0"}
    want = run("deacon_tpu_torch", serial, inter)
    assert want[0] == 0 and want[1]
    assert run("deacon_tpu_torch", chunked, inter) == want
    assert run("deacon_tpu", chunked, inter) == want
    odd = inter + recs[0]
    got = run("deacon_tpu_torch", chunked, odd)
    assert got[0] != 0 and b"Found 201 records" in got[1]
    assert run("deacon_tpu", serial, odd) == got
