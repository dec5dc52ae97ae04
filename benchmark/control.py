"""
Readings that the output check's limits are set from
====================================================

    python3 benchmark/control.py --workload <cell> --seeds 3 \
        [--first-seed N] [--seconds S] [--parts depth,sbs] [--out FILE]

On the card, in one process: for each seed a whole run of the cell
(``lib/harness.run_cell``: its entry, a short window at the cell's own
load, its check) with the control planted (``lib/control.py``: the
reference in the program's place at the precision below the
configuration's). Each run's check numbers, beside their limits, and its
``correct`` (which has to read false) are printed as one JSON line per
seed and written to ``--out``. The program's own readings are those of
the benchmark's runs (``run.py``), which print the same numbers. Not run
by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def readings(cell, seeds, seconds, devices, parts=("depth", "sbs"),
             log=print) -> list:
    """One planted run a seed: [{"cell", "seed", "correct", "check"}]."""
    from lib.control import plant
    from lib.harness import run_cell
    rows = []
    for seed in seeds:
        remove = plant(cell, parts)
        try:
            r = run_cell(cell, seed, seconds, False, devices,
                         time.perf_counter(), log=lambda s: None)
        finally:
            remove()
        row = {"cell": cell.name, "seed": seed, "parts": list(parts),
               "correct": r["correct"], "check": r["check"]}
        log(json.dumps(row))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--parts", default="depth,sbs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from lib.spec import load_benchmark, resolve
    cell = resolve(load_benchmark(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print("control: needs the cell's CUDA cards", file=sys.stderr)
        return 2
    rows = readings(cell, [args.first_seed + 7919 * i
                           for i in range(args.seeds)], args.seconds,
                    [f"cuda:{i}" for i in range(cell.chips)],
                    tuple(args.parts.split(",")))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
