"""What the benchmark's files may import: no module under ``h100bench/``
imports ``jax``, ``jaxlib``, ``flax`` or ``gpar_tpu`` (top-level names
compared whole, so ``gpar_torch`` is not ``gpar_tpu``), and nothing under
``h100bench/reference/`` imports ``gpar_torch`` either."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "gpar_tpu"}


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".")[0])
    return tops


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_port(path):
    assert not imported_tops(path) & (FORBIDDEN | {"gpar_torch", "h100bench"})


def test_the_check_finds_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom gpar_tpu.models import x\nimport gpar_torch\n")
    assert imported_tops(f) & FORBIDDEN == {"jax", "gpar_tpu"}


def test_the_run_refuses_loaded_jax(monkeypatch):
    import sys
    import types

    from h100bench.lib import cell

    assert "gpar_torch" not in cell.FORBIDDEN
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("jaxlib.xla_client"))
    assert cell.forbidden_modules() == ["jaxlib"]
