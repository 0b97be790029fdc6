"""What the benchmark loads: nothing it runs imports JAX, its libraries,
the JAX package or the root `bench` module (compared by whole top-level
name: the port's name begins with the JAX package's), and its yardstick
(the reference, the scenes, the weights, the arithmetic) imports nothing
of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from perfbench.run import FORBIDDEN
from perfbench.tests.helpers import ROOT

HERE = os.path.join(ROOT, "perfbench")
YARDSTICK = ("reference.py", "scenes.py", "weights.py", "yardstick.py",
             "cfg.py", "tracing.py")


def _sources():
    for base, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imported(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_forbidden_import(path):
    assert not _imported(path) & set(FORBIDDEN)


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "gndnet_tpu_torch" not in _imported(os.path.join(HERE, name))


def _python(code: str):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_loaded_modules():
    """Importing the harness and every module it loads on a run leaves no
    forbidden top-level name in sys.modules, and the yardstick alone
    loads nothing of the program."""
    code = (
        "import sys\n"
        "import perfbench.reference, perfbench.scenes, perfbench.weights\n"
        "import perfbench.yardstick, perfbench.cfg, perfbench.tracing\n"
        "assert 'gndnet_tpu_torch' not in sys.modules\n"
        "import perfbench.run, perfbench.traffic, perfbench.control\n"
        "import perfbench.sweep, perfbench.readers.host\n"
        "import perfbench.readers.device\n"
        "import gndnet_tpu_torch.infer, gndnet_tpu_torch.train\n"
        "from perfbench.run import FORBIDDEN, loaded_forbidden\n"
        "assert not loaded_forbidden(), loaded_forbidden()\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_run_refuses_a_loaded_jax_module():
    """A run in whose process a forbidden module is loaded exits non-zero
    and prints no result."""
    code = (
        "import sys, types\n"
        "sys.path.insert(0, '.')\n"
        "from perfbench.tests import cpu_run\n"
        "sys.modules['jax'] = types.ModuleType('jax')\n"
        "sys.exit(cpu_run.main(['.', 'camera.serve_closed']))\n")
    proc = _python(code)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "jax" in proc.stderr
