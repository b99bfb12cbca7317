"""``deacon_tpu_torch filter|index build`` under the engine's switches, and
with .zst and .xz files, against the JAX CLI, on the CPU.

* ``filter`` under DEACON_TPU_TILES with non-power-of-two row lengths (the
  K4 route) and under DEACON_PALLAS=1 (the K5 route): byte-identical to
  the JAX CLI's ``filter --device cpu`` (its DevicePipeline) under the
  same switch, run in a process of its own.
* ``index build`` under DEACON_PALLAS=1 and DEACON_ENGINE=3:
  byte-identical to the JAX CLI's index.
* .zst input and output through the port with the ``zstandard`` module
  hidden (the port binds libzstd itself); .xz likewise. Compressed bytes
  may differ between library builds, so the decompressed outputs are
  compared with the JAX CLI's, and the .zst output is checked to be a
  zstd frame. Without libzstd the port names the library and the file.
"""

import gzip
import io
import lzma
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from deacon_tpu_torch.cli import main as torch_main  # noqa: E402
from deacon_tpu_torch.index.store import IndexHeader, write_index  # noqa: E402
from deacon_tpu_torch.io import zstd  # noqa: E402
from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
_B = np.frombuffer(b"ACGT", np.uint8)
_SWITCHES = ("DEACON_TPU_TILES", "DEACON_ENGINE", "DEACON_PALLAS")
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _rs(rng, n):
    return rng.choice(_B, size=n).tobytes()


def _fastq_bytes(recs) -> bytes:
    return b"".join(b"@%s\n%s\n+\n%s\n" % (n, s, b"I" * len(s))
                    for n, s in recs)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_switch_cli")
    rng = np.random.default_rng(66)
    genome = _rs(rng, 30_000)
    write_index(compute_minimizer_hashes(genome, 31, 15),
                IndexHeader.new(31, 15), tmp / "ref.idx")

    def read(n):
        if rng.random() < 0.5:
            s = int(rng.integers(0, len(genome) - n))
            return genome[s:s + n]
        return _rs(rng, n)

    single = [(b"r%d" % i, read(int(rng.integers(40, 1100))))
              for i in range(150)]
    single += [(b"long", read(5000)), (b"nrun", b"N" * 50 + read(200)),
               (b"polyA", read(300) + b"A" * 700), (b"short", b"ACGTACGT")]
    (tmp / "s.fq").write_bytes(_fastq_bytes(single))
    pairs = [(read(150), read(150)) for _ in range(60)]
    (tmp / "r1.fq").write_bytes(_fastq_bytes(
        [(b"p%d/1" % i, a) for i, (a, _) in enumerate(pairs)]))
    (tmp / "r2.fq").write_bytes(_fastq_bytes(
        [(b"p%d/2" % i, b) for i, (_, b) in enumerate(pairs)]))
    recs = [(b"rec%d" % i, _rs(rng, int(rng.integers(2000, 9000))))
            for i in range(4)]
    recs.append((b"dirty", _rs(rng, 300) + b"NRYK" * 10 + b"A" * 900
                 + _rs(rng, 300).lower()))
    recs.append((b"chunked", _rs(rng, 20_000)))
    with open(tmp / "ref.fa", "wb") as f:
        for name, seq in recs:
            f.write(b">" + name + b"\n" + seq + b"\n")
    return tmp


def _jax_cli(args, env):
    """The JAX CLI in a process of its own, under the given switches."""
    full = {k: v for k, v in os.environ.items() if k not in _SWITCHES}
    full.update(env, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "deacon_tpu", *args],
                          capture_output=True, cwd=REPO, env=full)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]


def _set_switches(monkeypatch, env):
    for name in _SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


_FILTER_CASES = {
    "tiles_single": ({"DEACON_TPU_TILES": "384:64,1152:16"}, ["s.fq"],
                     ["-a", "1"]),
    "tiles_paired_deplete": ({"DEACON_TPU_TILES": "384:64,1152:16"},
                             ["r1.fq", "r2.fq"], ["-a", "2", "--deplete"]),
    "pallas1_single": ({"DEACON_PALLAS": "1"}, ["s.fq"], ["-a", "1"]),
}


@pytest.mark.parametrize("case", sorted(_FILTER_CASES))
def test_filter_under_switch_matches_jax_cli(data, monkeypatch, case):
    env, inputs, flags = _FILTER_CASES[case]
    _set_switches(monkeypatch, env)
    args = ["filter", str(data / "ref.idx"), *(str(data / i) for i in inputs),
            *flags, "-q"]
    out_t, out_j = data / f"{case}_t.fq", data / f"{case}_j.fq"
    assert torch_main([*args, "-o", str(out_t), "--device", "cpu"]) == 0
    _jax_cli([*args, "-o", str(out_j), "--device", "cpu"], env)
    assert out_t.read_bytes() == out_j.read_bytes()
    assert out_t.read_bytes()


@pytest.mark.parametrize("env,k", [({"DEACON_PALLAS": "1"}, 31),
                                   ({"DEACON_PALLAS": "1"}, 41),
                                   ({"DEACON_ENGINE": "3"}, 31)])
def test_index_build_under_switch_matches_jax_cli(data, monkeypatch, env, k):
    _set_switches(monkeypatch, env)
    tag = "_".join(f"{a}{b}" for a, b in env.items()) + str(k)
    out_t, out_j = data / f"t{tag}.idx", data / f"j{tag}.idx"
    flags = ["-k", str(k), "-w", "15", "-e", "0.5", "-q"]
    assert torch_main(["index", "build", str(data / "ref.fa"), "-o",
                       str(out_t), *flags, "--device", "cpu"]) == 0
    _jax_cli(["index", "build", str(data / "ref.fa"), "-o", str(out_j),
              *flags], env)
    assert out_t.read_bytes() == out_j.read_bytes()
    assert len(out_t.read_bytes()) > 1000


def _decompress(path: Path) -> bytes:
    raw = path.read_bytes()
    if raw.startswith(ZSTD_MAGIC):
        import zstandard

        return zstandard.ZstdDecompressor().stream_reader(
            io.BytesIO(raw), read_across_frames=True).read()
    if path.suffix == ".xz":
        return lzma.decompress(raw)
    if path.suffix == ".gz":
        return gzip.decompress(raw)
    return raw


@pytest.mark.parametrize("ext", [".zst", ".xz"])
def test_compressed_input_and_output_match_jax_cli(data, monkeypatch, ext):
    """The read set and the output compressed with ext: the port with the
    zstandard module hidden, the JAX CLI with it; the decompressed outputs
    are byte-identical."""
    pytest.importorskip("zstandard")
    plain = (data / "s.fq").read_bytes()
    src = data / f"s.fq{ext}"
    if ext == ".zst":
        with open(src, "wb") as f:
            w = zstd.Writer(f, 3, str(src))
            w.write(plain[:5000])
            w.write(plain[5000:])
            w.close()
    else:
        src.write_bytes(lzma.compress(plain))
    _set_switches(monkeypatch, {})
    args = ["filter", str(data / "ref.idx"), str(src), "-a", "1", "-q"]
    out_j = data / f"out_j.fq{ext}"
    _jax_cli([*args, "-o", str(out_j), "--device", "numpy"], {})
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ImportError):
        import zstandard  # noqa: F401
    out_t = data / f"out_t.fq{ext}"
    assert torch_main([*args, "-o", str(out_t), "--device", "cpu"]) == 0
    if ext == ".zst":
        assert out_t.read_bytes().startswith(ZSTD_MAGIC)
    monkeypatch.delitem(sys.modules, "zstandard")
    got = _decompress(out_t)
    assert got == _decompress(out_j) and got


def test_zst_without_libzstd_names_library_and_file(data, monkeypatch,
                                                    capsys):
    src = data / "s.fq.zst"
    if not src.exists():
        with open(src, "wb") as f:
            w = zstd.Writer(f, 3, str(src))
            w.write((data / "s.fq").read_bytes())
            w.close()
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd-missing.so.1")
    monkeypatch.setattr(zstd, "_lib", None)
    capsys.readouterr()
    assert torch_main(["filter", str(data / "ref.idx"), str(src), "-o",
                       str(data / "nolib.fq"), "-q", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "libzstd-missing.so.1" in err and str(src) in err
    out = data / "nolib.fq.zst"
    assert torch_main(["filter", str(data / "ref.idx"), str(data / "s.fq"),
                       "-o", str(out), "-q", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "libzstd-missing.so.1" in err and str(out) in err
    assert not out.exists()
