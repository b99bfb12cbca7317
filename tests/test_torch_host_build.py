"""``index build --device host``: the port's host route (host library
extraction with a reader thread, the counting set for the per-record
totals, the accumulator for a quiet build to a file, sort and write for
a quiet build to stdout) against the JAX package's host route (``--device
numpy``) and the port's ``--device cpu``: the index bytes, and the
per-record running totals and the summary line on standard error. The
counting set and the accumulator against np.unique."""

import gzip

import numpy as np
import pytest

from deacon_tpu.cli import main as jax_main
from deacon_tpu_torch.cli import main as torch_main
from deacon_tpu_torch.index.store import (
    PROVENANCE_MAGIC,
    SCHEME_DXTP_FMIX32_V1,
    IndexHeader,
    write_index,
)
from deacon_tpu_torch.io.native_loader import NativeCountingSet, NativeRunAcc

_B = np.frombuffer(b"ACGT", np.uint8)
_IUPAC = np.frombuffer(b"ACGTACGTACGTNRYacgt", np.uint8)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Records of many sizes (one over 600 kbp: more than 0xFFFF
    distinct keys, the accumulator's own writer) with IUPAC codes,
    gzipped; and a small plain file (its count takes the generic
    writer)."""
    tmp = tmp_path_factory.mktemp("torch_host_build")
    rng = np.random.default_rng(1603)
    recs = [(b"big chr", rng.choice(_B, 650_000).tobytes())]
    recs += [(b"r%d" % i, rng.choice(_IUPAC, int(rng.integers(0, 3000)))
              .tobytes()) for i in range(60)]
    recs.append((b"dup", recs[0][1][:5000]))  # no new keys
    big = tmp / "big.fa.gz"
    big.write_bytes(gzip.compress(b"".join(b">%s\n%s\n" % r for r in recs)))
    small = tmp / "small.fa"
    small.write_bytes(b"".join(b">%s\n%s\n" % r for r in recs[1:30]))
    return {"big": big, "small": small}


CASES = {
    "quiet_file": ("big", ["-q"], False),
    "quiet_file_small": ("small", ["-q"], False),
    "quiet_stdout": ("small", ["-q"], True),
    "report_file": ("big", [], False),
    "report_stdout": ("small", [], True),
    "k41_quiet_file": ("big", ["-q", "-k", "41", "-e", "0.5"], False),
    "k41_report_file": ("small", ["-k", "41", "-w", "11"], False),
}


def _lines(err: bytes) -> list[bytes]:
    """The per-record totals and the summary line."""
    return [line for line in err.splitlines()
            if line.startswith(b"  ") or line.startswith(b"Indexed ")]


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_build_matches_jax_host_route_and_cpu(fasta, tmp_path,
                                                    capfdbinary, case):
    name, flags, stdout = CASES[case]
    got = {}
    for tool, main, device in (("host", torch_main, "host"),
                               ("jax", jax_main, "numpy"),
                               ("cpu", torch_main, "cpu")):
        out = tmp_path / f"{tool}.idx"
        target = "-" if stdout else str(out)
        assert main(["index", "build", str(fasta[name]), "-o", target,
                     "--device", device, *flags]) == 0
        cap = capfdbinary.readouterr()
        data = cap.out if stdout else out.read_bytes()
        got[tool] = (data, _lines(cap.err))
    assert got["host"] == got["jax"] == got["cpu"]
    data, lines = got["host"]
    assert len(data) > 12 and lines[-1].startswith(b"Indexed ")
    if "-q" not in flags:
        assert len(lines) > 20


def test_counting_set_against_np_unique():
    rng = np.random.default_rng(7)
    s = NativeCountingSet(capacity_hint=1000)
    seen = np.empty(0, dtype=np.uint64)
    for i in range(40):
        n = int(rng.integers(0, 70_000))
        batch = rng.integers(0, 2**64 - 1, n, dtype=np.uint64,
                             endpoint=True)
        if seen.size:  # repeats of earlier keys, and within the batch
            batch[: n // 3] = rng.choice(seen, n // 3)
        if i == 5:
            batch[:3] = 0
        new = np.setdiff1d(np.unique(batch), seen).size
        assert s.insert(batch, n_threads=int(rng.integers(0, 5))) == new
        seen = np.union1d(seen, batch)
        assert len(s) == seen.size
    assert np.array_equal(s.export_sorted(), seen)
    s.close()


@pytest.mark.parametrize("n_keys", [60_000, 400_000])
def test_runacc_against_np_unique(tmp_path, n_keys):
    """More than 0xFFFF distinct keys: finish_write writes the index
    itself; fewer: it declines and export_sorted yields the keys."""
    rng = np.random.default_rng(n_keys)
    keys = rng.integers(1, 2**64 - 1, n_keys, dtype=np.uint64)
    acc = NativeRunAcc(capacity_hint=n_keys)
    for part in np.array_split(np.concatenate([keys, keys[::3]]), 7):
        acc.add(part)
    want = np.unique(keys)
    header = IndexHeader.new(31, 15)
    trailer = PROVENANCE_MAGIC + bytes([SCHEME_DXTP_FMIX32_V1])
    path = tmp_path / "acc.idx"
    count = acc.finish_write(str(path), header.format_version, 31, 15,
                             trailer, 4)
    ref = tmp_path / "ref.idx"
    write_index(want, header, ref)
    if want.size > 0xFFFF:
        assert count == want.size
        assert path.read_bytes() == ref.read_bytes()
    else:
        assert count is None and not path.exists()
        assert np.array_equal(acc.export_sorted(), want)
    acc.close()
