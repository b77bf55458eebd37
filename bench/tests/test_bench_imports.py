"""No module the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the
reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax(path):
    assert not set(imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = set(imported_tops(path))
    assert "repro_torch" not in tops
    assert tops <= {"__future__", "math", "typing", "zlib", "torch",
                    "reference", "numpy", "statistics"}, tops


def test_the_name_compare_is_whole():
    import harness
    assert "repro_torch" not in harness.FORBIDDEN
    assert "repro" in harness.FORBIDDEN
