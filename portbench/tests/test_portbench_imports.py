"""Nothing the benchmark runs reaches JAX or the JAX package, compared by
the top-level name as a whole (``signal_tpu_torch`` is not
``signal_tpu``); the reference reaches nothing of the port; a run
without a card fails and prints no result."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCES = sorted(p for p in (ROOT / "portbench").rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "signal_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_the_jax_package(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not [n for n in _imports(path) if n.split(".")[0] == "signal_tpu_torch"]


def test_running_modules_load_no_jax():
    code = ("import sys, importlib, pkgutil\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import portbench\n"
            "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
            "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
            "import signal_tpu_torch.engine.train, signal_tpu_torch.engine.eval\n"
            "from portbench import harness\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": ""})
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "signal_tpu_torch_extra", sys)
    assert "signal_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "signal_tpu.models", sys)
    assert "signal_tpu" in harness.forbidden_modules()


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "rgbnt201-train",
                           "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=600)


def test_a_run_without_a_card_fails_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_run_with_the_benchmark_alone_fails_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
