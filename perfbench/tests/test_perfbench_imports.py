"""What the benchmark may import: no jax and no JAX package anywhere, and
nothing of the program in the reference."""
import ast
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent   # perfbench/
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_nor_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from perfbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_fake.x", object())
    assert "repro_torch_fake.x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro.core" in run.forbidden_modules()


def imported_modules(path: Path) -> set:
    """Full names of the modules ``path`` imports absolutely."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_the_harness_leaves_the_program_to_programs():
    """``harness.py`` builds no program itself: the MEMHD model and its
    deploy are imported by ``programs/memhd.py``."""
    family = ("repro_torch.core", "repro_torch.deploy")
    assert not [n for n in imported_modules(HERE / "harness.py")
                if n.startswith(family)]
    assert "repro_torch.deploy" in imported_modules(
        HERE / "programs" / "memhd.py")
