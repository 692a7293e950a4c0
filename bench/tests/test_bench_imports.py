"""Nothing the benchmark runs imports JAX, the JAX package or the old
``benchmarks/`` folder, comparing top-level module names whole (the
program, ``repro_torch``, begins with ``repro``); the reference imports
nothing of the program; and a run with no card, or with no program
beside the benchmark, prints no result."""
from __future__ import annotations

import ast
import shutil
import subprocess
import sys

import pytest

from _tiny import ROOT, common

BENCH = ROOT / "bench"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    """Top-level names of every module the file imports, and the string
    arguments of calls to ``import_module``."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in
                ("import_module", "__import__") and node.args
                and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    assert not imported(path) & set(common.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "repro_torch" not in names
    assert names <= {"__future__", "math", "bisect", "dataclasses", "torch",
                     "bench"}


def test_top_level_names_are_compared_whole():
    sys.modules["repro_torch_like_name"] = sys.modules["math"]
    try:
        assert "repro_torch_like_name" not in common.forbidden_modules()
    finally:
        del sys.modules["repro_torch_like_name"]


def test_a_run_leaves_no_forbidden_module_loaded():
    code = ("import sys; sys.path[:0] = ['bench/tests']\n"
            "import _tiny\n"
            "r = _tiny.run('g24.static')\n"
            "from bench.harness import common\n"
            "print(r['correct'], common.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def run_cli(cwd):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "g24.static",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = run_cli(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cli(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
