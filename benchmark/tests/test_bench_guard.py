"""The import guard: nothing ``benchmark/run.py`` loads, the program
included, imports JAX or the JAX package (top-level names compared
whole: ``zpix_tpu_torch`` is not ``zpix_tpu``), and the references import
nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

PROGRAM = harness.ROOT / "zpix_tpu_torch"


def _imports(path: Path, package: str) -> set:
    """Top-level module names ``path`` imports anywhere in it (relative
    imports resolve inside ``package``)."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            tops.add(package if node.level else node.module.split(".")[0])
    return tops


def _files(root: Path):
    return [p for p in root.rglob("*.py") if "__pycache__" not in p.parts]


def test_nothing_a_run_loads_imports_jax_or_the_jax_package():
    for path in _files(harness.BENCH) + _files(PROGRAM):
        package = "zpix_tpu_torch" if PROGRAM in path.parents else "benchmark"
        bad = _imports(path, package) & set(harness.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_references_import_nothing_of_the_program():
    for path in _files(harness.BENCH / "reference"):
        tops = _imports(path, "benchmark")
        assert not tops & {"zpix_tpu_torch", "benchmark", *harness.FORBIDDEN}, (path, tops)


def test_loaded_modules_hold_no_forbidden_name():
    """In a fresh process: the harness, every data module by name, and the
    program's modules the cells drive."""
    code = f"""
import sys
sys.path.insert(0, {str(harness.ROOT)!r})
from benchmark import harness, devtrace, control
import zpix_tpu_torch, zpix_tpu_torch.parallel
for kind in ("content", "reference", "metrics"):
    for p in sorted((harness.BENCH / kind).glob("*.py")):
        if p.stem != "__init__":
            harness.load_module(kind, p.stem)
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "zpix_tpu_torch_probe", object())
    assert "zpix_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "zpix_tpu.probe", object())
    assert "zpix_tpu" in harness.forbidden_modules()
