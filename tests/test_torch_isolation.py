"""The port stands alone: nothing under src/repro_torch, not chip_smoke.py
and not the port's examples (``examples/torch_*.py``) imports jax or
anything of the JAX package ``repro``."""
import ast
import importlib.util
import json
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


EXAMPLES = ["torch_kmeans_pangea", "torch_cluster_quickstart",
            "torch_serving_quickstart", "torch_serve_paged",
            "torch_quickstart", "torch_train_100m"]


def _port_files():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [p.stem for p in examples] == sorted(EXAMPLES)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
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


TRAINING_MODULES = ["data/__init__.py", "data/pipeline.py",
                    "optim/__init__.py", "optim/adamw.py",
                    "optim/compression.py", "optim/train_state.py",
                    "launch/train.py"]

TRAIN_BLOCKED = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.configs import smoke_config
from repro_torch.launch.train import run_training
res = run_training(smoke_config("qwen3-0.6b"), steps=2, batch_size=2,
                   seq_len=8, log_every=100, device="cpu")
assert res.steps == 2 and len(res.losses) == 2
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
print("TRAINED")
"""


@pytest.mark.parametrize("rel", TRAINING_MODULES)
def test_training_modules_are_in_the_checked_set(rel):
    """The trainer's modules (the data pipeline, the optimizer, the train
    launcher) are among the files ``test_no_jax_or_repro_imports`` reads."""
    assert PORT / rel in _port_files()


def test_trainer_runs_with_jax_and_repro_blocked():
    """Two CPU training steps of smoke qwen3-0.6b, through the pool, the
    loader, the loss, the attention Function and AdamW, with any import of
    jax or of the JAX package raising."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", TRAIN_BLOCKED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "TRAINED" in out.stdout


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


EXAMPLE_BLOCKED = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
"""


@pytest.mark.parametrize("name,args", [
    ("torch_kmeans_pangea", ["--points", "20000", "--iters", "2"]),
    ("torch_serving_quickstart", []),
    ("torch_serve_paged", ["--requests", "3"]),
])
def test_example_runs_with_jax_and_repro_blocked(name, args):
    """A port example run as a script on the CPU, with any import of jax
    or of the JAX package raising: rc 0 and a JSON last line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", EXAMPLE_BLOCKED,
         str(ROOT / "examples" / f"{name}.py"), *args, "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1])["device"] == "cpu"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_cuda_it_does_not_have(name):
    """Without ``--device cpu`` an example asks for CUDA, and raises on a
    machine without it before any work."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the example would run")
    spec = importlib.util.spec_from_file_location(
        f"_isolation_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main([])
