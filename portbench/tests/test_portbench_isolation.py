"""Nothing the benchmark runs imports JAX, the JAX package or its
benchmark; the plain references import nothing of the program either.

Names are compared whole at the top level: ``repro_torch`` is the port
and not ``repro``."""
from __future__ import annotations

import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: pathlib.Path) -> set[str]:
    """Top-level names of every module ``path`` imports, by statement or
    by an ``import_module`` / ``__import__`` call on a literal."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_sources_found():
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_nor_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((PKG / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & {"repro_torch", "repro", "portbench"}


def test_the_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom jaxtyping import x\n")
    assert not imported(f) & FORBIDDEN
    f.write_text("from repro.core import batch\n")
    assert imported(f) & FORBIDDEN == {"repro"}
