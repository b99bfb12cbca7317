"""The port's CLI on its host library against the JAX package's CLI.

``filter`` (single, paired and interleaved stdin; gzip, BGZF, zstd, xz
and bzip2 input; gzip, zstd and xz output; --rename, -O) and ``index
build`` / ``union`` / ``diff`` through ``deacon_tpu_torch`` with
``--device cpu``, byte for byte against ``deacon_tpu``: every output file
(compressed ones too: both write them through the same encoders), every
index byte and the summary apart from the program and the timings; and
the port's client against the port's server, byte-identical to its
``filter`` of the same file.
"""

import bz2
import gzip
import io
import json
import lzma
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from deacon_tpu.cli import main as jax_main
from deacon_tpu_torch.cli import main as torch_main
from deacon_tpu_torch.index.store import IndexHeader, write_index
from deacon_tpu_torch.io import zstd
from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes
from deacon_tpu_torch.server.app import make_server
from helpers import bgzf_compress

REPO = Path(__file__).resolve().parent.parent
_B = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _rs(rng, n):
    return rng.choice(_B, size=n).tobytes()


def _zst(data: bytes) -> bytes:
    buf = io.BytesIO()
    w = zstd.Writer(buf, 3, "<memory>")
    w.write(data)
    w.close()
    return buf.getvalue()


COMPRESS = {"gz": gzip.compress, "bgzf.gz": lambda d: bgzf_compress(d),
            "zst": _zst, "xz": lzma.compress, "bz2": bz2.compress}


def _fq(recs) -> bytes:
    return b"".join(b"@%s\n%s\n+\n%s\n" % (n, s, b"I" * len(s))
                    for n, s in recs)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_native_cli")
    rng = np.random.default_rng(1411)
    genome = _rs(rng, 30_000)
    idx = tmp / "ref.idx"
    write_index(compute_minimizer_hashes(genome, 31, 15),
                IndexHeader.new(31, 15), idx)

    def read(n):
        if rng.random() < 0.5:
            s = int(rng.integers(0, len(genome) - n))
            r = genome[s:s + n]
            return r.translate(_COMP)[::-1] if rng.random() < 0.5 else r
        return _rs(rng, n)

    single = [(b"r%d x" % i, read(int(rng.integers(20, 500))))
              for i in range(150)] + [(b"long", read(9000)),
                                      (b"nrun", b"N" * 60 + read(200))]
    pairs = [(read(150), read(int(rng.integers(90, 160)))) for _ in range(80)]
    texts = {
        "s.fq": _fq(single),
        "r1.fq": _fq([(b"p%d/1" % i, a) for i, (a, _) in enumerate(pairs)]),
        "r2.fq": _fq([(b"p%d/2" % i, b) for i, (_, b) in enumerate(pairs)]),
        "inter.fq": b"".join(
            _fq([(b"p%d/1" % i, a), (b"p%d/2" % i, b)])
            for i, (a, b) in enumerate(pairs)),
    }
    for name, text in texts.items():
        (tmp / name).write_bytes(text)
        for ext, comp in COMPRESS.items():
            (tmp / f"{name}.{ext}").write_bytes(comp(text))
    fa = b"".join(b">chr%d\n%s\n" % (i, genome[i * 7000:(i + 1) * 7000 + 50])
                  for i in range(4))
    (tmp / "g.fa").write_bytes(fa)
    (tmp / "g.fa.gz").write_bytes(gzip.compress(fa))
    (tmp / "half.fa.zst").write_bytes(_zst(fa[: len(fa) // 2]))
    return {"tmp": tmp, "idx": idx}


def _summary(path):
    s = json.loads(Path(path).read_text())
    for key in ("version", "time", "seqs_per_second", "bp_per_second",
                "output", "output2", "index"):
        s.pop(key, None)
    return s


FILTER_CASES = {
    "gz_in_gz_out": (["s.fq.gz"], ".fq.gz", ["-a", "1"]),
    "bgzf_in_zst_out": (["s.fq.bgzf.gz"], ".fq.zst", ["-a", "2"]),
    "zst_in_zst_out": (["s.fq.zst"], ".fq.zst", ["-a", "1", "--rename"]),
    "xz_in_xz_out": (["s.fq.xz"], ".fq.xz", ["-a", "1", "-d"]),
    "bz2_in": (["s.fq.bz2"], ".fq", ["-a", "1", "-p", "80"]),
    "paired_gz": (["r1.fq.gz", "r2.fq.gz"], ".fq.gz", ["-a", "1"]),
    "paired_split_zst": (["r1.fq.zst", "r2.fq.zst"], ".fq.zst",
                         ["-a", "1", "-O", "--rename"]),
    "paired_mixed": (["r1.fq.bgzf.gz", "r2.fq.xz"], ".fq", ["-a", "1",
                                                             "-d"]),
}


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_filter_files_match_jax_cli(data, case):
    tmp = data["tmp"]
    inputs, ext, flags = FILTER_CASES[case]
    got = {}
    for tool, main in (("torch", torch_main), ("jax", jax_main)):
        out, out2 = tmp / f"{case}_{tool}{ext}", tmp / f"{case}_{tool}_2{ext}"
        summ = tmp / f"{case}_{tool}.json"
        args = ["filter", str(data["idx"]), *(str(tmp / i) for i in inputs),
                "-o", str(out), "-q", "-s", str(summ)]
        for f in flags:
            args += ["-O", str(out2)] if f == "-O" else [f]
        args += ["--device", "cpu" if tool == "torch" else "numpy"]
        assert main(args) == 0
        got[tool] = (out.read_bytes(),
                     out2.read_bytes() if "-O" in flags else b"",
                     _summary(summ))
    assert got["torch"] == got["jax"]
    assert got["torch"][0]  # something was kept


def _cli(module, args, stdin):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    with open(stdin, "rb") as f:
        proc = subprocess.run([sys.executable, "-m", module, *args], stdin=f,
                              capture_output=True, cwd=REPO, env=env,
                              timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()
    return proc.stdout


@pytest.mark.parametrize("case", ["interleaved", "interleaved_gz",
                                  "single_zst"])
def test_filter_stdin_to_stdout_matches_jax_cli(data, case):
    tmp = data["tmp"]
    src = {"interleaved": "inter.fq", "interleaved_gz": "inter.fq.gz",
           "single_zst": "s.fq.zst"}[case]
    ins = ["-", "-"] if case.startswith("interleaved") else ["-"]
    args = ["filter", str(data["idx"]), *ins, "-a", "1", "-q"]
    got = _cli("deacon_tpu_torch", args + ["--device", "cpu"], tmp / src)
    want = _cli("deacon_tpu", args + ["--device", "numpy"], tmp / src)
    assert got == want and got


INDEX_CASES = {
    "build_gz": ["index", "build", "{tmp}/g.fa.gz", "-k", "31", "-w", "15",
                 "-o", "{out}"],
    "build_k41_entropy": ["index", "build", "{tmp}/g.fa.gz", "-k", "41",
                          "-w", "15", "-e", "0.5", "-o", "{out}"],
    "union": ["index", "union", "{idx}", "{tmp}/half.idx", "-o", "{out}"],
    "diff_index": ["index", "diff", "{idx}", "{tmp}/half.idx", "-o", "{out}"],
    "diff_fastx": ["index", "diff", "{idx}", "{tmp}/half.fa.zst", "-o",
                   "{out}"],
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_index_ops_match_jax_cli(data, case):
    tmp = data["tmp"]
    half = tmp / "half.idx"
    if not half.exists():
        assert jax_main(["index", "build", str(tmp / "half.fa.zst"), "-o",
                         str(half), "-q"]) == 0
    got = {}
    for tool, main in (("torch", torch_main), ("jax", jax_main)):
        out = tmp / f"{case}_{tool}.idx"
        args = [a.format(tmp=tmp, idx=data["idx"], out=out)
                for a in INDEX_CASES[case]]
        if case.startswith("build"):
            args.append("-q")
        if case.startswith("build"):
            args += ["--device", "cpu" if tool == "torch" else "numpy"]
        elif case.startswith("diff") and tool == "torch":
            args += ["--device", "cpu"]
        assert main(args) == 0
        got[tool] = out.read_bytes()
    assert got["torch"] == got["jax"]
    assert len(got["torch"]) > 12


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    addr = f"http://127.0.0.1:{httpd.server_address[1]}"
    for _ in range(50):
        try:
            urllib.request.urlopen(addr + "/", timeout=1)
            break
        except OSError:
            time.sleep(0.1)
    return addr


@pytest.mark.parametrize("wire", ["binary", "json"])
@pytest.mark.parametrize("case", ["gz_single", "zst_paired"])
def test_client_on_compressed_input_matches_filter(data, monkeypatch, case,
                                                   wire):
    tmp = data["tmp"]
    if wire == "json":
        monkeypatch.setenv("DEACON_WIRE", "json")
    inputs = (["s.fq.gz"] if case == "gz_single"
              else ["r1.fq.zst", "r2.fq.zst"])
    httpd = make_server(str(data["idx"]), 0, host="127.0.0.1", device="cpu")
    try:
        addr = _serve(httpd)
        outs = {}
        for tool in ("client", "filter"):
            out = tmp / f"{case}_{wire}_{tool}.fq.gz"
            head = [addr] if tool == "client" else [str(data["idx"])]
            args = [tool, *head, *(str(tmp / i) for i in inputs), "-o",
                    str(out), "-a", "1", "-q"]
            if tool == "filter":
                args += ["--device", "cpu"]
            assert torch_main(args) == 0
            outs[tool] = out.read_bytes()
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert outs["client"] == outs["filter"] and outs["client"]


def test_client_device_is_accepted_and_ignored(data, capsys):
    """``client ... --device cpu`` parses in both CLIs and is ignored (the
    server decides); outputs equal the run without the flag."""
    from deacon_tpu.cli import build_parser as jax_parser
    from deacon_tpu_torch.cli import build_parser as torch_parser

    argv = ["client", "127.0.0.1:1", "in.fq", "--device", "cpu"]
    assert torch_parser().parse_args(argv).device == "cpu"
    assert jax_parser().parse_args(argv).device == "cpu"
    tmp = data["tmp"]
    httpd = make_server(str(data["idx"]), 0, host="127.0.0.1", device="cpu")
    try:
        addr = _serve(httpd)
        outs = {}
        for tool, main in (("torch", torch_main), ("jax", jax_main)):
            for flag in ([], ["--device", "cpu"]):
                out = tmp / f"client_dev_{tool}_{len(flag)}.fq"
                capsys.readouterr()
                assert main(["client", addr, str(tmp / "s.fq"), "-o",
                             str(out), "-a", "1", "-q", *flag]) == 0
                if tool == "torch" and flag:
                    assert "--device is ignored in client mode" \
                        in capsys.readouterr().err
                outs[tool, len(flag)] = out.read_bytes()
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert len(set(outs.values())) == 1 and outs["torch", 2]
