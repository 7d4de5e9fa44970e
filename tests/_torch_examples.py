"""The repo's example scripts, loaded by path, for the tests that hold each
port example (``examples/torch_<name>.py``) against its JAX example
(``examples/<name>.py``). The JAX examples read ``sys.argv``; the port's
take ``argv`` and return the dict of their last printed line."""
import contextlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name: str):
    """A fresh module of ``examples/<name>.py`` (not put in sys.modules)."""
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(mod, *args) -> list:
    """Run a JAX example's ``main`` with ``args`` as its command line; the
    lines it printed."""
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = [mod.__file__, *args]
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = argv
    return buf.getvalue().splitlines()


def run_port(mod, *args):
    """Run a port example's ``main`` on the CPU; ``(its dict, the lines it
    printed before the JSON line)``. The JSON line must be the dict."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = mod.main([*args, "--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(res))
    return res, lines[:-1]


def masked(lines, pattern: str) -> list:
    """``lines`` with every match of ``pattern`` (a time, or a count that
    depends on timing) replaced."""
    return [re.sub(pattern, "<masked>", line) for line in lines]
