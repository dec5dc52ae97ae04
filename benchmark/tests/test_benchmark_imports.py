"""What the benchmark imports: no jax, jaxlib, flax or the JAX package
anywhere under benchmark/, and nothing of the program in the reference and
the frozen yardstick. Top-level names are compared whole (``vsc_tpu_torch``
is not ``vsc_tpu``); imports inside functions count too."""

import ast
import os
import subprocess
import sys

import pytest

from lib.spec import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "vsc_tpu"}
FILES = sorted(BENCH_DIR.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name in
                                  ("reference", "frozen")],
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_reference_and_yardstick_import_nothing_of_the_program(path):
    assert "vsc_tpu_torch" not in set(_imports(path))


def test_the_walk_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("def f():\n    import vsc_tpu.ops\n    "
                 "from jax import numpy\n    import vsc_tpu_torch\n")
    assert set(_imports(p)) == {"vsc_tpu", "jax", "vsc_tpu_torch"}


def test_run_loads_nothing_forbidden_and_refuses_without_a_card():
    """run.py without a card: exit 2, no result line, and nothing of JAX
    loaded on the way."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    code = ("import runpy, sys; sys.argv = ['run.py', '--workload', "
            "'dp1080-rerender', '--seed', '1', '--seconds', '1'];\n"
            "try:\n runpy.run_path('benchmark/run.py', run_name='__main__')\n"
            "except SystemExit as e:\n rc = e.code\n"
            "import run\n"
            "print('RC', rc, 'FOUND', run.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert "RC 2 FOUND []" in r.stdout, r.stdout + r.stderr
    assert "needs 1 CUDA card" in r.stderr


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "vsc_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert run.forbidden_modules() == ["jaxlib"]
