"""The port stands alone: it imports no jax, no flax and nothing of the JAX
package ``vsc_tpu`` (every module of vsc_tpu_torch and chip_smoke.py is
imported in a fresh interpreter and the modules this added to sys.modules
are checked; every import statement of their sources, inside functions
too, is read), and its entry points run on the card unless the caller asks
for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
_BANNED = ("vsc_tpu", "jax", "jaxlib", "flax")

_SCRIPT = r"""
import importlib, importlib.util, pkgutil, sys
before = set(sys.modules)
import vsc_tpu_torch
names = ["vsc_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    vsc_tpu_torch.__path__, "vsc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
added = set(sys.modules) - before
bad = sorted(m for m in added
             if m.split(".")[0] in ("vsc_tpu", "jax", "jaxlib", "flax"))
print(len(names), "modules;", "bad:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split()[0])
    assert n >= 20, proc.stdout     # every sub-package was walked


def banned_imports(path: Path) -> list[str]:
    """Every ``import X...`` / ``from X... import`` in the file whose top
    name is vsc_tpu, jax, jaxlib or flax, at any depth (inside functions
    too), as "line name"."""
    tree = ast.parse(path.read_text(), str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [f"{node.lineno} {n}" for n in names
                if n.split(".")[0] in _BANNED]
    return bad


def test_port_source_never_imports_vsc_tpu():
    files = sorted((REPO / "vsc_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert len(files) >= 30
    bad = [f"{f.relative_to(REPO)}:{b}" for f in files
           for b in banned_imports(f)]
    assert not bad, bad


def test_import_walk_sees_imports_inside_functions(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text("import os\n"
                   "import vsc_tpu_torch.config\n"
                   "def f():\n"
                   "    from vsc_tpu.config import StereoParams\n"
                   "    import vsc_tpu.native as n\n"
                   "    from vsc_tpu_torch.config import get_path\n"
                   "    from . import sibling\n")
    assert banned_imports(src) == ["4 vsc_tpu.config", "5 vsc_tpu.native"]


def _no_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(monkeypatch):
    import torch
    from vsc_tpu_torch import default_device
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    assert default_device(force_cpu=True) == torch.device("cpu")


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    import torch
    from vsc_tpu_torch.pipeline import stream_convert
    from vsc_tpu_torch.pipeline.depth_map_generator import (build_depth_fn,
                                                            build_depthpro)
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_depth_fn("stub", 96, 8, 8, False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_depthpro(1536)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_convert.run(tmp_path, {}, model_name="stub")
    fn = build_depth_fn("stub", 96, 8, 8, False, device="cpu")
    assert fn(torch.zeros((1, 8, 8, 3), dtype=torch.uint8)).shape == (1, 8, 8)
