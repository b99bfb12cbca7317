"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by an ``nvcc`` process of
its own, all started together, and one more ``nvcc`` call links the
objects into a shared library with a plain C interface,
``_build/libdeacon_kernels.so`` inside the package (listed in
.gitignore); ``ctypes`` binds it. The build runs at first use in a
process and again whenever a hash of the sources (``*.cu`` and ``*.cuh``)
and flags changes; a file lock keeps concurrent processes from building
over each other. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libdeacon_kernels.so"
_STAMP = BUILD_DIR / "libdeacon_kernels.sha256"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of deacon_tpu_torch are compiled at first use"
    )


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*SRC_DIR.glob("*.cu"), *SRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> float | None:
    """Compile the kernels unless an up-to-date library exists. Returns
    the build's wall seconds, or None when the existing library was kept.
    Prints the wall time and ptxas's register and shared-memory lines to
    stderr."""
    BUILD_DIR.mkdir(exist_ok=True)
    digest = _digest()
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (
            LIB_PATH.exists() and _STAMP.exists()
            and _STAMP.read_text() == digest
        ):
            return None
        nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
        tmp = BUILD_DIR / f"libdeacon_kernels.{tag}.so"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
        t0 = time.perf_counter()
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(_sources(), objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
        failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs)
                  if p.returncode != 0]
        if not failed:
            link = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                failed.append((cmd, link.returncode, link.stdout))
        for obj in objs:
            obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("\n".join(
                f"nvcc failed ({rc}): {' '.join(c)}\n{out}"
                for c, rc, out in failed))
        os.replace(tmp, LIB_PATH)
        _STAMP.write_text(digest)
    print(f"deacon_tpu_torch: nvcc built {LIB_PATH.name} from "
          f"{len(objs)} sources in {seconds:.2f} s", file=sys.stderr)
    for line in "".join(outs).splitlines():
        if "ptxas info" in line and (
            "registers" in line or "Compiling entry" in line
            or "smem" in line
        ):
            print("  " + line.strip(), file=sys.stderr)
    return seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dx_select_compact.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp,
        ]
        lib.dx_select_compact.restype = i32
        lib.dx_radix_probe.argtypes = [
            vp, vp, vp, i64, vp, i64, i64, i32, vp, i32, vp, vp,
        ]
        lib.dx_radix_probe.restype = i32
        lib.dx_values_select.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp,
        ]
        lib.dx_values_select.restype = i32
        lib.dx_select_csum.argtypes = lib.dx_select_compact.argtypes
        lib.dx_select_csum.restype = i32
        lib.dx_values_argmin.argtypes = lib.dx_values_select.argtypes
        lib.dx_values_argmin.restype = i32
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")
