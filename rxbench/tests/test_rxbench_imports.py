"""What the harness may import: no module under ``rxbench/`` imports JAX or
the JAX package, and the plain receiver and the wire format it reads
import nothing of the program.  Top-level names are compared whole:
``ofdm_tpu_torch`` begins with ``ofdm_tpu`` and is another package."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from rxbench import registry

BANNED = {"jax", "jaxlib", "flax", "ofdm_tpu"}
SOURCES = sorted(p for p in registry.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    """The top-level names of the absolute imports of a source file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def rel(p: Path) -> str:
    return str(p.relative_to(registry.HERE))


@pytest.mark.parametrize("path", SOURCES, ids=rel)
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if p.parent.name in ("reference", "wire")],
    ids=rel)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "ofdm_tpu_torch" not in names
    assert names <= {"__future__", "functools", "math", "numpy", "torch"}


def test_the_comparison_is_by_whole_names():
    assert "ofdm_tpu_torch".split(".")[0] not in BANNED
    assert "ofdm_tpu.phy".split(".")[0] in BANNED


def imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names |= {node.module} | {f"{node.module}.{a.name}"
                                      for a in node.names}
    return names


@pytest.mark.parametrize("path", SOURCES, ids=rel)
def test_the_harness_imports_none_of_the_old_benches(path):
    for name in imported_modules(path):
        assert name not in ("bench", "chip_smoke", "ofdm_tpu_torch.bench")
