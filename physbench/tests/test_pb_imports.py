"""Nothing under physbench/ imports JAX or the JAX package, and the
plain reference imports nothing of the program either.  Top-level module
names are compared whole: the port's name begins with the JAX
package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not _top_level_imports(path) & {"jax", "jaxlib", "flax",
                                           "mgf_tpu"}


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "mgf_tpu_torch" not in _top_level_imports(path)


def test_whole_name_comparison():
    # the port's package begins with the JAX package's name and is allowed
    assert "mgf_tpu_torch".split(".")[0] != "mgf_tpu"
