"""No module the benchmark runs has the top-level name jax, jaxlib, flax or
pangenome_index_tpu (compared whole: pangenome_index_tpu_torch is the
program), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

from benchmark import run

BENCH_DIR = pathlib.Path(run.__file__).resolve().parent


def _imports(path: pathlib.Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        assert not _imports(path) & set(run.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    assert _imports(BENCH_DIR / "reference.py") <= {"__future__", "dataclasses", "torch"}
    assert "pangenome_index_tpu_torch" not in (BENCH_DIR / "reference.py").read_text()


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pangenome_index_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxfake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


def test_a_run_loads_none_of_them(tmp_path):
    """A whole run, traced, in a fresh interpreter."""
    code = f"""
import pathlib, sys
sys.path.insert(0, {str(run.ROOT)!r})
from benchmark import run, tiny
root = tiny.make_root(pathlib.Path({str(tmp_path)!r}) / "checkout")
line, _ = run.run_cell(tiny.TINY_CELL, 3, 0.3, True, device="cpu", root=root,
                       work_dir=root / "work")
assert line["correct"]
print(run.forbidden_modules())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
