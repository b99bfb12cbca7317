"""``deacon_tpu_torch server|client`` against the JAX package's, on the CPU.

The port's server (``device="cpu"``: the index's keys in a CPU tensor) and
the JAX package's run in threads on ephemeral ports, as
tests/test_server.py runs its server. The port's client output must be
byte-identical to the port's ``filter --device cpu`` and to the JAX
client's against the JAX server, on both wires (binary frame and JSON)
and across them (port client with JAX server, JAX client with port
server); the endpoints' bodies, the error codes, the summary's ``index``
field and ``DeviceHashProbe`` must equal the JAX package's.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deacon_tpu.cli import main as jax_main  # noqa: E402
from deacon_tpu.ops.engine import DeviceHashProbe as JaxProbe  # noqa: E402
from deacon_tpu.server.app import make_server as jax_make_server  # noqa: E402
from deacon_tpu_torch.cli import main as torch_main  # noqa: E402
from deacon_tpu_torch.config import FilterConfig  # noqa: E402
from deacon_tpu_torch.index.store import (  # noqa: E402
    IndexHeader,
    load_index,
    write_index,
)
from deacon_tpu_torch.ops.engine import DeviceHashProbe  # noqa: E402
from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes  # noqa: E402
from deacon_tpu_torch.server import protocol  # noqa: E402
from deacon_tpu_torch.server.app import MAX_BODY, make_server  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
_B = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _rs(rng, n):
    return rng.choice(_B, size=n).tobytes()


def _fastq(path, recs):
    with open(path, "wb") as f:
        for name, seq in recs:
            f.write(b"@%s\n%s\n+\n%s\n" % (name, seq, b"I" * len(seq)))


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    addr = f"http://127.0.0.1:{httpd.server_address[1]}"
    for _ in range(50):
        try:
            urllib.request.urlopen(addr + "/", timeout=1)
            break
        except Exception:
            time.sleep(0.1)
    return addr


@pytest.fixture(scope="module")
def srv(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_server")
    rng = np.random.default_rng(4242)
    genome = _rs(rng, 12_000)
    idx = tmp / "ref.idx"
    write_index(compute_minimizer_hashes(genome, 31, 15),
                IndexHeader.new(31, 15), idx)

    def read(n):
        if rng.random() < 0.5:
            s = int(rng.integers(0, len(genome) - n))
            r = genome[s:s + n]
            return r.translate(_COMP)[::-1] if rng.random() < 0.5 else r
        return _rs(rng, n)

    _fastq(tmp / "s.fq", [(b"r%d" % i, read(int(rng.integers(40, 400))))
                          for i in range(90)] + [(b"short", b"ACGTACGT")])
    pairs = [(read(150), read(150)) for _ in range(40)]
    _fastq(tmp / "r1.fq", [(b"p%d/1" % i, a) for i, (a, _) in enumerate(pairs)])
    _fastq(tmp / "r2.fq", [(b"p%d/2" % i, b) for i, (_, b) in enumerate(pairs)])
    with open(tmp / "inter.fq", "wb") as f:
        for i, (a, b) in enumerate(pairs):
            f.write(b"@p%d/1\n%s\n+\n%s\n@p%d/2\n%s\n+\n%s\n"
                    % (i, a, b"I" * len(a), i, b, b"I" * len(b)))
    port = make_server(str(idx), 0, host="127.0.0.1", device="cpu")
    jax = jax_make_server(str(idx), 0, host="127.0.0.1")
    out = {"tmp": tmp, "idx": idx, "genome": genome,
           "port": _serve(port), "jax": _serve(jax), "state": port.state}
    yield out
    for httpd in (port, jax):
        httpd.shutdown()
        httpd.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read()


@pytest.mark.parametrize("path", ["/", "/index_header", "/index_version"])
def test_endpoints_match_jax_server(srv, path):
    got = _get(srv["port"] + path)
    assert got == _get(srv["jax"] + path)
    if path == "/index_header":
        assert json.loads(got[2]) == {"format_version": 2, "kmer_length": 31,
                                      "window_size": 15}
    if path == "/index_version":
        name, sha = got[2].decode().split("@")
        assert name == str(srv["idx"]) and len(sha) == 64


def _summary(path):
    s = json.loads(Path(path).read_text())
    for key in ("version", "time", "seqs_per_second", "bp_per_second",
                "output", "output2", "index"):
        s.pop(key)
    return s


CASES = {
    "single": (["s.fq"], ["-a", "1"]),
    "single_deplete": (["s.fq"], ["-a", "2", "-r", "0.1", "--deplete"]),
    "paired": (["r1.fq", "r2.fq"], ["-a", "1", "-R"]),
    "paired_deplete_split": (["r1.fq", "r2.fq"], ["-a", "1", "-d", "-O"]),
}


def _run(srv, tool, target, inputs, flags, tag):
    """One filter or client run; -> (output bytes, output2 bytes, summary)."""
    tmp = srv["tmp"]
    out, out2, summ = (tmp / f"{tag}.fq", tmp / f"{tag}_2.fq",
                       tmp / f"{tag}.json")
    args = [target, *(str(tmp / i) for i in inputs), "-o", str(out), "-q",
            "-s", str(summ)]
    for f in flags:
        args += ["-O", str(out2)] if f == "-O" else [f]
    main = torch_main if tool == "torch" else jax_main
    if target == str(srv["idx"]):
        args = ["filter", *args, "--device",
                "cpu" if tool == "torch" else "numpy"]
    else:
        args = ["client", *args]
    assert main(args) == 0
    return (out.read_bytes(), out2.read_bytes() if "-O" in flags else b"",
            _summary(summ), json.loads(summ.read_text())["index"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_client_matches_filter_and_jax_client(srv, case):
    inputs, flags = CASES[case]
    client = _run(srv, "torch", srv["port"], inputs, flags, f"{case}_c")
    local = _run(srv, "torch", str(srv["idx"]), inputs, flags, f"{case}_f")
    jax = _run(srv, "jax", srv["jax"], inputs, flags, f"{case}_j")
    assert client[:3] == local[:3] == jax[:3]
    assert client[0] or client[1]
    version = _get(srv["port"] + "/index_version")[2].decode()
    assert client[3] == f"{srv['port']}:{version}"
    assert jax[3] == f"{srv['jax']}:{version}"
    assert local[3] == str(srv["idx"])


@pytest.mark.parametrize("wire", ["binary", "json"])
@pytest.mark.parametrize("client,server", [("torch", "jax"),
                                           ("jax", "torch")])
def test_cross_wire_matches(srv, monkeypatch, wire, client, server):
    """Port client against the JAX server and JAX client against the port
    server, on each wire: the same bytes as the same-package runs."""
    if wire == "json":
        monkeypatch.setenv("DEACON_WIRE", "json")
    addr = srv["port"] if server == "torch" else srv["jax"]
    for case in ("single_deplete", "paired_deplete_split"):
        inputs, flags = CASES[case]
        got = _run(srv, client, addr, inputs, flags,
                   f"x_{case}_{client}_{wire}")
        want = _run(srv, "torch", str(srv["idx"]), inputs, flags,
                    f"x_{case}_ref_{wire}")
        assert got[:3] == want[:3]


def test_wire_negotiation_against_port_server(srv, monkeypatch):
    """The port's RemoteBackend negotiates the binary frame with the port
    server; DEACON_WIRE=json keeps it on JSON; both decide alike."""
    from deacon_tpu_torch.ops.minimizers_np import (
        get_minimizer_hashes_and_positions,
    )
    from deacon_tpu_torch.server.client import RemoteBackend

    g = srv["genome"]
    batch = [get_minimizer_hashes_and_positions(s, 0, 31, 15)
             for s in (g[:200], _rs(np.random.default_rng(1), 90), g[500:640])]
    rb = RemoteBackend(srv["port"])
    assert rb._binary is None
    out_bin = rb.decide_unpaired(batch, 31, 2, 0.01, True, False)
    assert rb._binary is True
    monkeypatch.setenv("DEACON_WIRE", "json")
    rj = RemoteBackend(srv["port"])
    assert rj._binary is False
    assert rj.decide_unpaired(batch, 31, 2, 0.01, True, False) == out_bin
    pb = [(batch[0][0], batch[0][1], (g[:100], g[100:200]))]
    assert rb.decide_paired(pb, 31, 2, 0.01, False, False) == \
        rj.decide_paired(pb, 31, 2, 0.01, False, False)


def _cli(module, args, stdin=None, env=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               **(env or {}))
    return subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          input=stdin, capture_output=True, cwd=REPO,
                          env=env, timeout=300)


@pytest.mark.parametrize("deplete", [False, True])
def test_interleaved_stdin_matches(srv, deplete):
    stdin = (srv["tmp"] / "inter.fq").read_bytes()
    flags = ["-a", "1", "-q"] + (["-d"] if deplete else [])
    got = _cli("deacon_tpu_torch", ["client", srv["port"], "-", "-", *flags],
               stdin)
    local = _cli("deacon_tpu_torch", ["filter", srv["idx"], "-", "-", *flags,
                                      "--device", "cpu"], stdin)
    want = _cli("deacon_tpu", ["client", srv["jax"], "-", "-", *flags], stdin)
    assert got.returncode == local.returncode == want.returncode == 0
    assert got.stdout == local.stdout == want.stdout and got.stdout


@pytest.mark.parametrize("inputs", [["s.fq"], ["r1.fq", "r2.fq"]])
def test_debug_lines_match(srv, capsys, inputs):
    """--debug rides the JSON wire and lists each record's k-mers."""
    tmp = srv["tmp"]
    lines = {}
    for tag, main, target, extra in (
            ("client", torch_main, ["client", srv["port"]], []),
            ("filter", torch_main, ["filter", str(srv["idx"])],
             ["--device", "cpu"]),
            ("jax", jax_main, ["client", srv["jax"]], [])):
        capsys.readouterr()
        assert main([*target, *(str(tmp / i) for i in inputs), "-o",
                     str(tmp / f"dbg_{tag}.fq"), "-a", "1", "--debug",
                     *extra]) == 0
        err = capsys.readouterr().err
        lines[tag] = [ln for ln in err.splitlines() if ln.startswith("DEBUG")]
    assert lines["client"] == lines["filter"] == lines["jax"]
    assert lines["client"]


def test_probe_matches_jax_probe():
    rng = np.random.default_rng(99)
    keys = np.unique(rng.integers(0, 2**64, 30_000, dtype=np.uint64))
    keys = np.unique(np.concatenate(
        [keys, np.array([0, 1, 2**63, 2**64 - 1], np.uint64)]))
    ours, theirs = DeviceHashProbe(keys, "cpu"), JaxProbe(keys)
    q = np.concatenate([
        keys[rng.integers(0, keys.size, 5000)],
        rng.integers(0, 2**64, 5000, dtype=np.uint64),
        keys[:50] + np.uint64(1), keys[-50:] - np.uint64(1),
        np.array([0, 1, 2, 2**63 - 1, 2**63, 2**64 - 2, 2**64 - 1],
                 np.uint64)])
    got = ours(q)
    assert got.dtype == bool and got.shape == q.shape
    assert np.array_equal(got, theirs(q))
    assert np.array_equal(got, np.isin(q, keys))
    assert ours(np.zeros(0, np.uint64)).shape == (0,)
    assert np.array_equal(ours(q[:1]), theirs(q[:1]))
    empty = DeviceHashProbe(np.zeros(0, np.uint64), "cpu")
    assert not empty(q).any() and len(empty) == 0
    assert ours.nbytes == 8 * keys.size
    # no aliasing of the caller's array, and none kept on the host
    before = keys.copy()
    DeviceHashProbe(keys, "cpu")
    assert np.array_equal(keys, before)


def test_probe_from_index_file_keeps_no_host_copy(srv):
    probe = DeviceHashProbe.from_index_file(str(srv["idx"]), "cpu")
    keys = load_index(srv["idx"]).hashes
    assert len(probe) == keys.size and probe.load_s >= 0 <= probe.upload_s
    assert [n for n, v in vars(probe).items()
            if isinstance(v, np.ndarray)] == []
    assert probe(keys).all()
    st = srv["state"]
    assert st.backend.index.hashes.size == 0 and st.backend._probe is st.probe
    assert set(st.timings) == {"sha256_s", "load_index_s", "upload_s"}


def test_probe_concurrent_calls(srv):
    """The HTTP server's threads call one probe at once: every result
    equals the serial one."""
    probe = srv["state"].probe
    keys = load_index(srv["idx"]).hashes
    rng = np.random.default_rng(3)
    qs = [np.concatenate([keys[rng.integers(0, keys.size, 300)],
                          rng.integers(0, 2**64, 300, dtype=np.uint64)])
          for _ in range(32)]
    want = [probe(q) for q in qs]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        got = list(pool.map(probe, qs))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_concurrent_client_batches(srv, monkeypatch):
    """DEACON_CLIENT_INFLIGHT=3 with small batches: three POSTs in flight
    at once, outputs in order and equal to the local filter's."""
    monkeypatch.setenv("DEACON_CLIENT_INFLIGHT", "3")
    tmp = srv["tmp"]
    outs = {}
    for tag, kw in (("remote", {"server_address": srv["port"]}),
                    ("local", {"minimizers_path": str(srv["idx"]),
                               "device": "cpu"})):
        for paired in (False, True):
            out = tmp / f"inflight_{tag}_{paired}.fq"
            inputs = ({"input_path": str(tmp / "r1.fq"),
                       "input2_path": str(tmp / "r2.fq")} if paired
                      else {"input_path": str(tmp / "s.fq")})
            FilterConfig(**kw, **inputs, output_path=str(out),
                         abs_threshold=1, quiet=True, batch_size=7).execute()
            outs[tag, paired] = out.read_bytes()
    assert outs["remote", False] == outs["local", False]
    assert outs["remote", True] == outs["local", True]


def _post(addr, path, body, ctype="application/json", length=None):
    req = urllib.request.Request(addr + path, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    if length is not None:
        req.add_unredirected_header("Content-Length", str(length))
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _bad_requests(addr):
    h = np.array([1, 2, 3], np.uint64)
    p = np.array([0, 1, 2], np.uint32)
    binary_paired = protocol.encode_binary_request(
        [(h, p, (b"ACGT", b"ACGT"))], 2, 0.01, False, 31, False, True)
    out = []
    try:
        urllib.request.urlopen(addr + "/nothing", timeout=10)
    except urllib.error.HTTPError as e:
        out.append(("GET /nothing", e.code, e.read()))
    for name, path, body, kw in (
            ("route", "/nothing", b"{}", {}),
            ("json", "/should_output_unpaired", b"{broken json", {}),
            ("fields", "/should_output_paired", b'{"input": []}', {}),
            ("paired flag", "/should_output_unpaired", binary_paired,
             {"ctype": protocol.BINARY_CTYPE}),
            ("too large", "/should_output_unpaired", b"",
             {"length": MAX_BODY + 1}),
            ("negative", "/should_output_unpaired", b"", {"length": -1})):
        code, body = _post(addr, path, body, **kw)
        out.append((name, code, body))
    return out


def test_bad_requests_match_jax_server(srv):
    got = _bad_requests(srv["port"])
    assert got == _bad_requests(srv["jax"])
    assert [c for _, c, _ in got] == [404, 404, 400, 400, 400, 413, 400]


def test_client_server_down():
    proc = _cli("deacon_tpu_torch", ["client", "http://127.0.0.1:1",
                                     "whatever.fq", "-q"])
    assert proc.returncode == 1
    assert b"Failed to contact server" in proc.stderr


def test_server_mesh_and_no_card_exit_1(srv, capsys):
    """A malformed --mesh is refused with the JAX server's message before
    the index is read (tests/test_torch_pod.py serves on meshes)."""
    assert torch_main(["server", str(srv["idx"]), "-p", "0",
                       "--mesh", "2y4", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "Error: --mesh must be DATAxSHARD (e.g. 2x4), got '2y4'" in err
    assert "Loading index" not in err  # refused before reading the index
    if not torch.cuda.is_available():  # the default --device cuda
        assert torch_main(["server", str(srv["idx"]), "-p", "0"]) == 1
        assert ("torch.cuda.is_available() is false"
                in capsys.readouterr().err)


def test_client_mesh_warns(srv, capsys):
    tmp = srv["tmp"]
    capsys.readouterr()
    assert torch_main(["client", srv["port"], str(tmp / "s.fq"), "-o",
                       str(tmp / "mesh_c.fq"), "-a", "1", "-q",
                       "--mesh", "pod"]) == 0
    assert "--mesh is ignored in client mode" in capsys.readouterr().err
    assert torch_main(["filter", str(srv["idx"]), str(tmp / "s.fq"), "-o",
                       str(tmp / "mesh_f.fq"), "-a", "1", "-q",
                       "--device", "cpu"]) == 0
    assert (tmp / "mesh_c.fq").read_bytes() == (tmp / "mesh_f.fq").read_bytes()


@pytest.mark.parametrize("sidecar", [False, True])
def test_host_server_matches_cpu_server(srv, tmp_path, monkeypatch, capsys,
                                        sidecar):
    """``server --device host`` (the JAX server's default host probe):
    built from the keys, or mapped from the index's sidecar; its answers
    on both wires equal the CPU-tensor server's."""
    from deacon_tpu_torch.io import native_loader
    from deacon_tpu_torch.server.app import HostProbe

    idx = tmp_path / "ref.idx"
    idx.write_bytes(srv["idx"].read_bytes())
    monkeypatch.setenv("DEACON_PROBE_CACHE", "1" if sidecar else "0")
    if sidecar:  # a first server writes it
        first = make_server(str(idx), 0, host="127.0.0.1", device="host")
        first.server_close()
        assert (tmp_path / "ref.idx.probe").exists()
    capsys.readouterr()
    host = make_server(str(idx), 0, host="127.0.0.1", device="host")
    assert isinstance(host.state.probe, HostProbe)
    source = "sidecar cache" if sidecar else "built at startup"
    assert f"Engine: native C++ probe table ({source})" \
        in capsys.readouterr().err
    assert (tmp_path / "ref.idx.probe").exists() == sidecar
    try:
        addr = _serve(host)
        assert _get(addr + "/")[2] == _get(srv["port"] + "/")[2]
        tmp = srv["tmp"]
        for wire in ("binary", "json"):
            monkeypatch.setenv("DEACON_WIRE", wire)
            outs = []
            for server in (addr, srv["port"]):
                out = tmp / f"hostsrv_{sidecar}_{wire}_{len(outs)}.fq"
                assert torch_main(["client", server, str(tmp / "r1.fq"),
                                   str(tmp / "r2.fq"), "-o", str(out), "-a",
                                   "1", "-q"]) == 0
                outs.append(out.read_bytes())
            assert outs[0] == outs[1] and outs[0]
        q = np.concatenate([compute_minimizer_hashes(srv["genome"][:3000],
                                                     31, 15),
                            np.arange(1, 200, dtype=np.uint64)])
        assert np.array_equal(host.state.probe(q),
                              srv["state"].probe(q))
        assert isinstance(host.state.probe.table, native_loader.NativeProbe)
    finally:
        host.shutdown()
        host.server_close()


def test_server_command_asks_for_huge_pages(monkeypatch):
    """The ``server`` command (a long-lived process) sets
    DEACON_PROBE_THP=1 unless the caller set it, as the JAX server does;
    the probe classes leave the environment alone."""
    import deacon_tpu_torch.server.app as app

    seen = []
    monkeypatch.setattr(app, "run_server", lambda *a, **kw: seen.append(
        os.environ.get("DEACON_PROBE_THP")))
    for preset, want in (("0", "0"), (None, "1")):  # setenv first: undone
        if preset is None:
            monkeypatch.delenv("DEACON_PROBE_THP", raising=False)
        else:
            monkeypatch.setenv("DEACON_PROBE_THP", preset)
        assert torch_main(["server", "ref.idx", "--device", "host"]) == 0
        assert seen[-1] == want
