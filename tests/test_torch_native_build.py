"""The port's host library is built once and fails loudly.

Six processes ask for the library at once on an empty build directory
and only one runs g++; a source that does not compile raises an error
naming g++ with the compiler's output, and a port function then raises
too instead of returning its plain version's result.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deacon_tpu_torch.io import native_loader as nl
from deacon_tpu_torch.ops import pack

REPO = Path(__file__).resolve().parent.parent


def test_six_processes_build_once(tmp_path):
    build_dir = tmp_path / "build"
    code = ("import sys\n"
            "from pathlib import Path\n"
            "from deacon_tpu_torch.io import native_loader as nl\n"
            "secs = nl.build(nl.SRC, Path(sys.argv[1]))\n"
            "print('built' if secs is not None else 'kept')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO, env=env)
             for _ in range(6)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    said = sorted(o.strip() for o, _ in outs)
    assert said == ["built"] + ["kept"] * 5
    assert sorted(p.name for p in build_dir.glob("*.so")) == [nl.LIB_NAME]
    # a second round finds the library up to date
    assert nl.build(nl.SRC, build_dir) is None


def test_broken_source_raises_naming_gpp(tmp_path, monkeypatch):
    src = tmp_path / "host.cpp"
    shutil.copy(nl.SRC, src)
    with open(src, "a") as f:
        f.write("\nint dx_broken( {\n")
    build_dir = tmp_path / "build"
    with pytest.raises(nl.NativeBuildError, match="g\\+\\+ failed") as err:
        nl.build(src, build_dir)
    assert "dx_broken" in str(err.value)  # the compiler's own output
    assert not list(build_dir.glob("*.so"))
    # the package pointed at the broken source: no plain-version result
    monkeypatch.setattr(nl, "SRC", src)
    monkeypatch.setattr(nl, "BUILD_DIR", build_dir)
    monkeypatch.setattr(nl, "_lib", None)
    rows = [pack._Row(0, 0, 0, b"ACGTACGT")]
    with pytest.raises(nl.NativeBuildError):
        pack.pack_rows_packed(rows, 8, 256, 31, 45)
    with pytest.raises(nl.NativeBuildError):
        nl.u64_merge_sorted_unique(np.arange(3, dtype=np.uint64),
                                   np.arange(2, dtype=np.uint64))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    with pytest.raises(nl.NativeBuildError, match="g\\+\\+ not found"):
        nl.build(nl.SRC, tmp_path / "build")
