"""No module of the benchmark imports JAX, jaxlib, flax or the JAX
package (top-level names compared whole, so ``deacon_tpu_torch`` passes),
and the reference imports nothing of the program either."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "deacon_tpu"}
#: the reference and what it is built from: no module of the program
PLAIN = ("reference.py", "index_keys.py", "seeds.py", "control.py",
         "generators/reads.py")


def modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), HERE)


def top_level_imports(rel: str) -> set:
    with open(os.path.join(HERE, rel)) as f:
        tree = ast.parse(f.read(), rel)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("rel", sorted(modules()))
def test_no_jax(rel):
    assert not top_level_imports(rel) & FORBIDDEN


@pytest.mark.parametrize("rel", PLAIN)
def test_reference_imports_nothing_of_the_program(rel):
    assert not {n for n in top_level_imports(rel)
                if n.startswith("deacon_tpu")}


def test_whole_name_compare():
    assert "deacon_tpu_torch".split(".")[0] not in FORBIDDEN
