"""The port stands alone: nothing under src/repro_torch, and not
chip_smoke.py, imports jax or anything of the JAX package ``repro``."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

torch.set_num_threads(2)


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _absolute_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args:
            # importlib.import_module("pkg...") or f"pkg.{...}"
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr) and arg.values:
                arg = arg.values[0]
            if isinstance(arg, ast.Constant):
                yield arg.value


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    for name in _absolute_imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "ml_dtypes"), \
            f"{path.relative_to(ROOT)} imports {name}"


IMPORT_ALL = r"""
import sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["repro"] = None        # and so does any import of the JAX package
import importlib, pkgutil
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.configs import get_config
get_config("qwen3-0.6b")
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
print("IMPORTED", len(names))
"""


def test_import_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORTED" in out.stdout


def _smoke(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: chip_smoke.py would run")
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and out.stdout.strip() == ""


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
