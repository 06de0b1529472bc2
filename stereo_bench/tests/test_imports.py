"""Nothing under ``stereo_bench/`` imports JAX or the JAX package, and the
plain reference imports nothing of the program under test. Top-level
module names are compared whole: the program's package name begins with
the JAX package's."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ecm_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def imported_tops(path: Path) -> set[str]:
    """The top-level names of every module ``path`` imports."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "ecm_torch" not in tops
    assert tops <= {"__future__", "contextlib", "torch"}


def test_the_scan_sees_what_it_must(tmp_path):
    """The parser finds a forbidden import in each form it takes, and does
    not take the program's name for the JAX package's."""
    path = tmp_path / "probe.py"
    path.write_text("import jax.numpy\nfrom ecm_tpu.models import x\nimport importlib\nimportlib.import_module('flax')\n")
    assert imported_tops(path) >= {"jax", "ecm_tpu", "flax"}
    path.write_text("import ecm_torch.models\nfrom ecm_torch import x\n")
    assert not imported_tops(path) & FORBIDDEN
