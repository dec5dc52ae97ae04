"""The port imports no jax and no flax: every module of vsc_tpu_torch (and
chip_smoke.py) is imported in a fresh interpreter, and the modules that
this added to sys.modules are checked."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

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
bad = sorted(m for m in added if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print(len(names), "modules;", "bad:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split()[0])
    assert n >= 20, proc.stdout     # every sub-package was walked
