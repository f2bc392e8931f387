"""The port stands alone: nothing in ``signal_tpu_torch`` (or the chip
scripts that drive it on the card) reaches ``jax`` or the JAX package, neither
in its source nor when it is imported."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "signal_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "scripts" / "profile_torch_eval.py",
    REPO / "scripts" / "profile_torch_train.py", REPO / "scripts" / "profile_torch_attention.py",
    REPO / "scripts" / "export_serving_torch.py", REPO / "scripts" / "time_fed_torch.py"]


def _forbidden(name: str) -> bool:
    # compare whole names: a prefix test on "signal_tpu" would also match
    # "signal_tpu_torch"
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "signal_tpu")


def _imported_names(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_neither_jax_nor_signal_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported_names(tree) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_signal_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import signal_tpu_torch\n"
        "for m in pkgutil.walk_packages(signal_tpu_torch.__path__, 'signal_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(n for n in new if n.split('.')[0] in ('jax', 'jaxlib', 'signal_tpu'))\n"
        "assert {'signal_tpu_torch.cli', 'signal_tpu_torch.engine.eval',\n"
        "        'signal_tpu_torch.engine.train', 'signal_tpu_torch.solver',\n"
        "        'signal_tpu_torch.models.vit_prompt', 'signal_tpu_torch.models.lora',\n"
        "        'signal_tpu_torch.ops.moe', 'signal_tpu_torch.models.vit_imagenet',\n"
        "        'signal_tpu_torch.models.t2t', 'signal_tpu_torch.models.resnet',\n"
        "        'signal_tpu_torch.models.osnet', 'signal_tpu_torch.models.zoo'} <= new\n"
        "print('BAD', bad)\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
