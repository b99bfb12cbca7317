"""``deacon_tpu_torch index union|diff`` against the JAX CLI, on the CPU.

The cases of tests/test_cli_index.py's union, diff and provenance tests:
the port's output file must be byte-identical to the JAX CLI's, and its
standard-error lines equal apart from the timings. ``diff`` runs its
FASTX extraction with ``--device cpu`` (the plain versions of K1, K3 and
K5); the JAX CLI runs its own extraction. Also: the device key set's
running counts of removed keys per record (the progress line), and the
sorted index encoder against the JAX package's encoder.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deacon_tpu.cli import main as jax_main  # noqa: E402
from deacon_tpu.index import store as jax_store  # noqa: E402
from deacon_tpu.utils import bincode as jax_bincode  # noqa: E402
from deacon_tpu_torch.cli import main as torch_main  # noqa: E402
from deacon_tpu_torch.index.store import (  # noqa: E402
    IndexHeader,
    load_index,
    read_provenance,
    write_index,
)
from deacon_tpu_torch.ops.engine import IndexBuildPipeline, KeptKeys  # noqa: E402
from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes  # noqa: E402
from deacon_tpu_torch.utils import bincode  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
_B = np.frombuffer(b"ACGT", np.uint8)
_LINES = ("First index", "Second index", "Removed", "Processed",
          "  Processed", "Performing", "No capacity", "Pre-allocating",
          "Index ", "United", "Warning", "Completed", "Error")


def _rs(rng, n):
    return rng.choice(_B, size=n).tobytes()


def _fasta(path, recs):
    with open(path, "wb") as f:
        for name, seq in recs:
            f.write(b">" + name + b"\n")
            for j in range(0, len(seq), 70):
                f.write(seq[j:j + 70] + b"\n")


def _index(path, seqs, k=31, w=15):
    hashes = np.unique(np.concatenate(
        [compute_minimizer_hashes(s, k, w) for s in seqs]))
    write_index(hashes, IndexHeader.new(k, w), path)
    return hashes


def _lines(err: str):
    """The commands' own standard-error lines, timings removed."""
    return [re.sub(r" in \d+\.\d+s$", "", ln) for ln in err.splitlines()
            if ln.startswith(_LINES)]


def _run(capsys, tool, args):
    capsys.readouterr()
    main = torch_main if tool == "torch" else jax_main
    rc = main(args + (["--device", "cpu"] if tool == "torch"
                      and args[:2] == ["index", "diff"] else []))
    return rc, _lines(capsys.readouterr().err)


def _cli(module, args, stdin=None, env=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               **(env or {}))
    return subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          input=stdin, capture_output=True, cwd=REPO, env=env)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_index_ops")
    rng = np.random.default_rng(1313)
    a, b, c = _rs(rng, 3000), _rs(rng, 3000), _rs(rng, 2000)
    _fasta(tmp / "a.fa", [(b"a", a)])
    _fasta(tmp / "b.fa", [(b"b desc", b), (b"b2", c[:700])])
    _fasta(tmp / "ab.fa", [(b"a", a), (b"b", b)])
    _index(tmp / "a.idx", [a])
    _index(tmp / "b.idx", [b, c[:700]])
    _index(tmp / "c.idx", [c])
    _index(tmp / "ab.idx", [a, b])
    _index(tmp / "ab41.idx", [a, b], k=41)
    _fasta(tmp / "b41.fa", [(b"b", b)])
    _index(tmp / "a21.idx", [a], k=21, w=11)
    return tmp


@pytest.mark.parametrize("inputs", [("a", "b"), ("a", "b", "c")])
def test_union_matches_jax_cli(data, capsys, inputs):
    outs = {}
    for tool in ("torch", "jax"):
        out = data / f"u{''.join(inputs)}_{tool}.idx"
        rc, err = _run(capsys, tool, ["index", "union",
                                      *(str(data / f"{i}.idx") for i in inputs),
                                      "-o", str(out)])
        assert rc == 0
        outs[tool] = (out.read_bytes(), err)
    assert outs["torch"] == outs["jax"]
    want = np.unique(np.concatenate(
        [load_index(data / f"{i}.idx").hashes for i in inputs]))
    got = load_index(data / f"u{''.join(inputs)}_torch.idx")
    assert np.array_equal(got.hashes, want)
    assert read_provenance(data / f"u{''.join(inputs)}_torch.idx") == 1


@pytest.mark.parametrize("command", ["union", "diff"])
def test_incompatible_headers_match_jax_cli(data, capsys, command):
    errs = {}
    for tool in ("torch", "jax"):
        rc, err = _run(capsys, tool, ["index", command, str(data / "a.idx"),
                                      str(data / "a21.idx"), "-o",
                                      str(data / f"x_{tool}.idx")])
        assert rc == 1
        errs[tool] = [ln for ln in err if ln.startswith("Error")]
    assert errs["torch"] == errs["jax"]
    assert "Incompatible headers" in errs["torch"][0]


@pytest.mark.parametrize("second", ["index", "file", "stdin"])
def test_three_way_diff_matches_jax_cli(data, capsys, second):
    """ab minus b, b given as an index, a FASTX file or FASTX on stdin:
    the same bytes from every form and from both CLIs."""
    arg = {"index": data / "b.idx", "file": data / "b.fa", "stdin": "-"}[second]
    kw = [] if second == "index" else ["-k", "31", "-w", "15"]
    outs = {}
    for tool in ("torch", "jax"):
        out = data / f"d_{second}_{tool}.idx"
        args = ["index", "diff", data / "ab.idx", arg, *kw, "-o", out]
        if second == "stdin":
            proc = _cli("deacon_tpu_torch" if tool == "torch" else "deacon_tpu",
                        args + (["--device", "cpu"] if tool == "torch" else []),
                        stdin=(data / "b.fa").read_bytes())
            assert proc.returncode == 0, proc.stderr
            err = _lines(proc.stderr.decode())
        else:
            rc, err = _run(capsys, tool, list(map(str, args)))
            assert rc == 0
        outs[tool] = (out.read_bytes(), err)
    assert outs["torch"] == outs["jax"]
    # every form removes the same keys: b's minimizers
    want = np.setdiff1d(load_index(data / "ab.idx").hashes,
                        load_index(data / "b.idx").hashes, assume_unique=True)
    got = load_index(data / f"d_{second}_torch.idx").hashes
    assert np.array_equal(got, want) and 0 < got.size
    line = [ln for ln in outs["torch"][1] if ln.startswith("Removed")][0]
    assert line == (f"Removed {len(load_index(data / 'ab.idx')) - got.size} "
                    f"minimizers, {got.size} remaining")


@pytest.mark.parametrize("idx,fa,switch", [
    ("ab.idx", "b.fa", None),        # k=31: the K1 route's plain version
    ("ab41.idx", "b41.fa", None),    # k=41: the K3 route's plain version
    ("ab.idx", "b.fa", "1"),         # DEACON_PALLAS=1: the K5 route
    ("ab41.idx", "b41.fa", "1"),
])
def test_diff_autodetects_kw_and_matches_jax_cli(data, capsys, monkeypatch,
                                                 idx, fa, switch):
    """-k/-w absent and the second file not an index: k and w come from
    the first index's header; the result does not depend on the route."""
    k = load_index(data / idx).header.kmer_length
    if switch:
        monkeypatch.setenv("DEACON_PALLAS", switch)
    routes = set(IndexBuildPipeline(k, 15, device="cpu").routes.values())
    assert routes == ({"K5"} if switch else {"K1" if k <= 32 else "K3"})
    out_t = data / f"auto_{idx}_{switch}_torch.idx"
    rc, err_t = _run(capsys, "torch", ["index", "diff", str(data / idx),
                                       str(data / fa), "-o", str(out_t)])
    assert rc == 0
    monkeypatch.delenv("DEACON_PALLAS", raising=False)
    out_j = data / f"auto_{idx}_{switch}_jax.idx"
    rc, err_j = _run(capsys, "jax", ["index", "diff", str(data / idx),
                                     str(data / fa), "-o", str(out_j)])
    assert rc == 0
    assert out_t.read_bytes() == out_j.read_bytes() and err_t == err_j
    assert f"Second index: processing FASTX from file (k={k}, w=15)…" in err_t
    if k == 31:  # explicit -k/-w give the same bytes
        out_e = data / f"explicit_{switch}.idx"
        assert torch_main(["index", "diff", str(data / idx), str(data / fa),
                           "-k", "31", "-w", "15", "-o", str(out_e),
                           "--device", "cpu"]) == 0
        assert out_e.read_bytes() == out_t.read_bytes()


def _strip_trailer(path_in, path_out):
    data = Path(path_in).read_bytes()
    assert data[-9:-1] == jax_store.PROVENANCE_MAGIC
    Path(path_out).write_bytes(data[:-9])


@pytest.mark.parametrize("case", ["union_ours", "diff_ours",
                                  "union_foreign", "diff_foreign_first"])
def test_provenance_propagation_matches_jax_cli(data, capsys, tmp_path, case):
    """ours + ours keeps the trailer; a foreign (trailer-stripped) input
    drops it from a union, a foreign first index from a diff, each with
    the foreign-index warning."""
    ia, ib = data / "a.idx", data / "b.idx"
    fa_, fb = tmp_path / "fa.idx", tmp_path / "fb.idx"
    _strip_trailer(ia, fa_)
    _strip_trailer(ib, fb)
    command, inputs = {
        "union_ours": ("union", [ia, ib]),
        "diff_ours": ("diff", [ia, ib]),
        "union_foreign": ("union", [ia, fb]),
        "diff_foreign_first": ("diff", [fa_, ib]),
    }[case]
    outs = {}
    for tool in ("torch", "jax"):
        out = tmp_path / f"o_{tool}.idx"
        rc, err = _run(capsys, tool, ["index", command, *map(str, inputs),
                                      "-o", str(out)])
        assert rc == 0
        outs[tool] = (out.read_bytes(), err, read_provenance(out))
    assert outs["torch"] == outs["jax"]
    foreign = "foreign" in case
    assert outs["torch"][2] == (None if foreign else 1)
    warned = any("was not built by deacon-tpu" in ln for ln in outs["torch"][1])
    assert warned == foreign


@pytest.mark.parametrize("second", ["index", "fasta"])
def test_diff_removing_every_key_matches_jax_cli(data, capsys, second):
    arg = data / ("ab.idx" if second == "index" else "ab.fa")
    outs = {}
    for tool in ("torch", "jax"):
        out = data / f"empty_{second}_{tool}.idx"
        rc, err = _run(capsys, tool, ["index", "diff", str(data / "ab.idx"),
                                      str(arg), "-o", str(out)])
        assert rc == 0
        outs[tool] = (out.read_bytes(), err)
    assert outs["torch"] == outs["jax"]
    assert len(load_index(data / f"empty_{second}_torch.idx")) == 0
    assert "0 remaining" in outs["torch"][1][-2]


def test_diff_without_a_card_raises(data):
    """``--device cuda`` (the default) never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _cli("deacon_tpu_torch", ["index", "diff", data / "ab.idx",
                                     data / "b.fa", "-o",
                                     data / "nocard.idx"])
    assert proc.returncode == 1
    assert b"torch.cuda.is_available() is false" in proc.stderr
    assert not (data / "nocard.idx").exists()


def test_kept_keys_running_counts_per_record():
    """remove(): each key counts at the first record hitting it; the
    running totals and the kept keys equal a NumPy per-record replay."""
    rng = np.random.default_rng(77)
    keys = np.unique(rng.integers(0, 2**64, 5000, dtype=np.uint64))
    kept = KeptKeys(keys, torch.device("cpu"))
    done = np.zeros(keys.size, dtype=bool)
    for n_seqs in (7, 1, 12):
        seq = rng.integers(0, n_seqs, 900)
        hashes = np.where(rng.random(900) < 0.5,
                          keys[rng.integers(0, keys.size, 900)],
                          rng.integers(0, 2**64, 900, dtype=np.uint64))
        hashes[:3] = [0, 2**64 - 1, keys[0]]
        got = kept.remove(torch.from_numpy(hashes.view(np.int64)),
                          torch.from_numpy(seq), n_seqs)
        want = []
        for s in range(n_seqs):
            i = np.searchsorted(keys, hashes[seq == s])
            i = np.minimum(i, keys.size - 1)
            done[i[keys[i] == hashes[seq == s]]] = True
            want.append(int(done.sum()))
        assert got.tolist() == want
        assert kept.removed() == want[-1]
    assert np.array_equal(kept.remaining(), keys[~done])
    assert kept.remove(torch.zeros(0, dtype=torch.int64)) is None


@pytest.mark.parametrize("case", ["empty", "byte", "classes", "random"])
def test_sorted_encoder_matches_jax_encoder(case):
    rng = np.random.default_rng(5)
    vals = {
        "empty": np.zeros(0, np.uint64),
        "byte": np.array([0, 1, 250], np.uint64),
        "classes": np.array([0, 250, 251, 65535, 65536, 2**32 - 1, 2**32,
                             2**64 - 1], np.uint64),
        "random": np.unique(np.concatenate([
            rng.integers(0, 300, 40), rng.integers(0, 70_000, 40),
            rng.integers(0, 2**33, 40)]).astype(np.uint64).tolist()
            + rng.integers(0, 2**64, 4000, dtype=np.uint64).tolist()),
    }[case]
    vals = np.unique(vals.astype(np.uint64))
    got = bytes(bincode.encode_sorted_u64_array(vals))
    assert got == bytes(jax_bincode.encode_u64_array(vals))
    back, end = bincode.decode_u64_array(np.frombuffer(got, np.uint8), 0,
                                         vals.size)
    assert np.array_equal(back, vals) and end == len(got)


@pytest.mark.parametrize("batch", [1000, 3])
def test_diff_progress_lines_count_removed_keys_per_record(
        data, capsys, monkeypatch, batch):
    """The progress line (every gigabase; here every 5 kbp) reports the
    keys removed up to the record that ends the span, within a batch and
    across batches: the same lines as a per-record NumPy replay."""
    import deacon_tpu_torch.index.build as tbuild

    monkeypatch.setattr(tbuild, "PROGRESS_BP", 5000)
    monkeypatch.setattr(tbuild, "DIFF_STREAM_BATCH", batch)
    rng = np.random.default_rng(batch)
    recs = [(b"r%d" % i, _rs(rng, int(n)))
            for i, n in enumerate(rng.integers(500, 4000, 12))]
    recs[7] = (b"big", _rs(rng, 12_000))  # spans two reports: one line
    keys = _index(data / f"prog{batch}.idx", [s for _, s in recs[::2]]
                  + [s[:900] for _, s in recs[1::2]])
    _fasta(data / f"prog{batch}.fa", recs)
    rc, err = _run(capsys, "torch", ["index", "diff",
                                     str(data / f"prog{batch}.idx"),
                                     str(data / f"prog{batch}.fa"), "-o",
                                     str(data / f"prog{batch}_out.idx")])
    assert rc == 0
    want, removed, total, last = [], np.zeros(keys.size, bool), 0, 0
    for i, (_, s) in enumerate(recs):
        h = compute_minimizer_hashes(s, 31, 15)
        removed |= np.isin(keys, h)
        total += len(s)
        if total // 5000 > last:
            want.append(f"  Processed {i + 1} sequences ({total}bp), "
                        f"removed {int(removed.sum())} minimizers")
            last = total // 5000
    assert [ln for ln in err if ln.startswith("  Processed")] == want
    assert len(want) >= 4
