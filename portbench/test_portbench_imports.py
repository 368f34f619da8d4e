"""Nothing under portbench/ imports JAX or the JAX package ``repro``, and the
reference and the checks import nothing of the program ``repro_torch``.
Module names are compared whole by their top-level part: ``repro_torch`` is
not ``repro``."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "references").glob("*.py"))
                         + sorted((HERE / "checks").glob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_and_checks_stand_apart_from_the_program(path):
    assert not imported_tops(path) & (FORBIDDEN | {"repro_torch", "portbench"})


def test_the_guard_compares_whole_names():
    from portbench import harness
    assert "repro" in harness.FORBIDDEN and "repro_torch" not in FORBIDDEN
    assert {m.split(".")[0] for m in ("repro_torch.core", "repro.core")} \
        & FORBIDDEN == {"repro"}
