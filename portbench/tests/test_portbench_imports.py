"""No module of the benchmark imports JAX or the JAX package, and the
reference and the architecture files import nothing of the program.  Names are compared whole by
their top-level part (``fedcola_tpu_torch`` begins with ``fedcola_tpu``)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "fedcola_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted(
    (BENCH / "reference").rglob("*.py")) + sorted(
    (BENCH / "arch").rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    # nor does an architecture file: it names the program's flags and
    # attributes, and program.py alone reads them
    assert "fedcola_tpu_torch" not in set(top_level_imports(path))


def test_whole_names_not_prefixes():
    assert "fedcola_tpu_torch" not in JAX
    src = BENCH / "program.py"
    assert "fedcola_tpu_torch" in set(top_level_imports(src))
