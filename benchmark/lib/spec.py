"""
A cell of BENCHMARK.json and the files it names
===============================================

The harness is driven by data: a cell ("workloads" entry) names a
configuration and a traffic mix, and each is found by its name:

  configs          the configuration's "file" (sizes, dtype, batch,
                   weight seed, stereo parameters, limits of the output
                   check)
  traffic/<mix>.json
                   the mix's parameters (data): the program entry it
                   drives ("entry") and that entry's lengths, pools,
                   sliders and sample sizes
  entries/<entry>.py
                   the driver of one program entry (``Entry``: set-up,
                   warm-up, one step, the output check), run by the one
                   general loop in ``lib/harness.py``
  metrics/<name>.py
                   one reader per per-layer metric: ``read(rec)`` returns
                   the metric's value or None when the traced run holds
                   nothing for it. A metric ``<base>.<suffix>`` without a
                   file of its own is read by ``metrics/<base>.py``: the
                   same quantity in cells that report another end-to-end
                   metric

A cell reports every end-to-end metric without a "workloads" list or with
the cell in it, and with ``--trace 1`` every per-layer metric that lists
the cell, or that lists no cells and moves an end-to-end metric the cell
reports.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_benchmark", "resolve",
           "reader_path", "load_reader", "load_entry"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no BENCHMARK.json")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, mix and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=e2e, per_layer=per_layer)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metric: str) -> Path:
    """``metrics/<metric>.py``, else ``metrics/<base>.py`` for a metric
    named ``<base>.<suffix>``."""
    d = BENCH_DIR / "metrics"
    for stem in (metric, metric.split(".", 1)[0]):
        if (d / f"{stem}.py").is_file():
            return d / f"{stem}.py"
    raise FileNotFoundError(f"{d}: no reader for metric {metric}")


def load_reader(metric: str):
    """The reader of ``metric``: its module's ``read``."""
    path = reader_path(metric)
    return _load(path, f"benchmark_metric_{path.stem.replace('.', '_')}"
                 ).read


def load_entry(name: str):
    """``entries/<name>.py``: the driver of the program entry a mix
    names."""
    path = BENCH_DIR / "entries" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no driver for entry {name!r}")
    return _load(path, f"benchmark_entry_{name}")
