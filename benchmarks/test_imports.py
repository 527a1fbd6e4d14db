"""What the benchmark's modules may import: nothing under ``benchmarks/``
imports JAX, its relatives or the JAX package (``miden_tpu``), and the
reference (``benchmarks/reference/``) imports nothing of the port either,
nor PyTorch. Names are compared by their top-level part whole, so
``miden_tpu_torch`` is not taken for ``miden_tpu``.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
NEVER = {"jax", "jaxlib", "flax", "miden_tpu"}
NOT_IN_REFERENCE = NEVER | {"miden_tpu_torch", "torch"}


def imported_top_levels(path: Path) -> set:
    """The top-level names of every absolute import in ``path``, wherever it
    stands (module level or inside a function), and of every
    ``importlib.import_module`` / ``__import__`` call with a literal name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".", 1)[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Attribute) and node.func.attr == "import_module")
                   or (isinstance(node.func, ast.Name) and node.func.id == "__import__"))):
            names.add(node.args[0].value.split(".", 1)[0])
    return names


def sources(under: Path) -> list:
    return sorted(p for p in under.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", sources(BENCH), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_top_levels(path) & NEVER


@pytest.mark.parametrize("path", sources(BENCH / "reference"), ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert not imported_top_levels(path) & NOT_IN_REFERENCE


def test_the_check_tells_the_port_from_the_jax_package(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import miden_tpu_torch.vm\nfrom miden_tpu_torch import stark\n")
    assert imported_top_levels(f) == {"miden_tpu_torch"} and not imported_top_levels(f) & NEVER
    f.write_text("def g():\n    import importlib\n    importlib.import_module('miden_tpu.vm')\n")
    assert "miden_tpu" in imported_top_levels(f)
    f.write_text("from jax import numpy\n")
    assert imported_top_levels(f) & NEVER == {"jax"}
