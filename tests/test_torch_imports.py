"""The port stands alone: importing every deacon_tpu_torch module and
chip_smoke.py loads neither JAX nor anything of the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _port_modules() -> list[str]:
    pkg = REPO / "deacon_tpu_torch"
    mods = []
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax_and_no_jax_package():
    mods = _port_modules() + ["chip_smoke"]
    assert "deacon_tpu_torch.ops.kernels" in mods
    assert "deacon_tpu_torch.parallel.sharded" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'deacon_tpu' or m.startswith('deacon_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", proc.stdout


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_modes_fail_without_a_card():
    """Every mode of chip_smoke.py exits non-zero with no result line
    where no card is present."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    for mode in ("--sanitize", "--pod4"):
        proc = subprocess.run([sys.executable, "chip_smoke.py", mode],
                              capture_output=True, text=True, cwd=REPO,
                              env=env, timeout=300)
        assert proc.returncode != 0, mode
        assert '"ok"' not in proc.stdout and "sanitize" not in proc.stdout
