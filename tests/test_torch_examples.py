"""The port's example drivers (``examples/*_torch.py``) on the CPU, and the
port's independence from JAX.

``imc_mapping_report_torch`` prints Table II line for line as the JAX
package's ``imc_mapping_report`` does; every ``_torch`` driver runs to its
end with ``--device cpu`` at a small setting; and no module of
``src/repro_torch/``, no ``_torch`` example and ``chip_smoke.py`` imports
``jax`` or the JAX package ``repro``.
"""
import ast
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
PORT_EXAMPLES = ("quickstart_torch", "train_lm_torch", "serve_lm_torch",
                 "imc_mapping_report_torch")


def example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("array", [128, 64, 256])
def test_table2_prints_the_references_lines(array, capsys):
    example("imc_mapping_report").part1_table2(array)
    want = capsys.readouterr().out
    example("imc_mapping_report_torch").part1_table2(array)
    got = capsys.readouterr().out
    assert got == want and "memhd" in got


def test_imc_mapping_report_runs_on_the_cpu(capsys):
    example("imc_mapping_report_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "=== Table II (array 128x128) ===" in out
    assert "head accuracy on synthetic 6-class task" in out


def test_train_lm_runs_on_the_cpu(tmp_path, capsys):
    out = example("train_lm_torch").main(
        ["--preset", "smoke", "--steps", "3", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)])
    assert out["steps_run"] == 3 and out["device"] == "cpu"
    assert "no loss check" in capsys.readouterr().out


def test_train_lm_loss_drops_past_the_warm_up(tmp_path, capsys):
    out = example("train_lm_torch").main(
        ["--preset", "smoke", "--steps", "30", "--seq-len", "64",
         "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert out["steps_run"] == 30 and out["last_loss"] < out["first_loss"]
    assert "no loss check" not in capsys.readouterr().out


def test_serve_lm_runs_on_the_cpu(capsys):
    out = example("serve_lm_torch").main(
        ["--device", "cpu", "--prompt-len", "8", "--gen", "8"])
    assert tuple(out.shape) == (4, 16) and out.dtype == torch.int32
    assert "arch=hymba-1.5b-smoke" in capsys.readouterr().out


def test_quickstart_runs_on_the_cpu(capsys):
    example("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("fused feature serving", "hierarchical deployment",
                 "multibit deployment", "online fold", "imc deployment",
                 "kernel launches: "):
        assert line in out


def port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [EXAMPLES / f"{n}.py" for n in PORT_EXAMPLES]
    return files + [ROOT / "chip_smoke.py"]


def imported(path) -> set:
    """Every module name an ``import`` or ``from`` statement names, and
    every string handed to ``__import__`` / ``importlib.import_module``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("__import__", "import_module")):
            names.add(node.args[0].value)
    return names


def test_the_port_imports_neither_jax_nor_the_reference():
    files = port_files()
    assert len(files) > 80 and all(f.exists() for f in files)
    bad = {}
    for f in files:
        hits = {n for n in imported(f)
                if n.split(".")[0] in ("jax", "jaxlib", "repro")}
        if hits:
            bad[str(f.relative_to(ROOT))] = sorted(hits)
    assert not bad
    # The check sees what it looks for.
    assert "jax" in imported(EXAMPLES / "serve_lm.py")
    assert "repro.launch.serve" in imported(EXAMPLES / "serve_lm.py")
