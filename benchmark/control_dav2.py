"""
Readings that the Depth Anything V2 cell's limits are set from
==============================================================

    python3 benchmark/control_dav2.py --workload dav2l-1080-convert \
        --seeds 3 [--first-seed N] [--seconds S] [--parts depth,sbs] \
        [--out FILE]

``control.py`` for the cells whose mix drives ``render_sbs_dav2``: on the
card, in one process, for each seed a whole run of the cell
(``lib/harness.run_cell``) with the control planted by ``plant``: the
reference Depth Anything V2 (``reference/depth_anything_v2.py``) from the
same weight file in the depth step's ``build_depth_fn`` place, at the
precision below the configuration's (``lib/control.LOWER``: fp8 under
bf16), and for "sbs" the bfloat16 reference SBS (``lib/control.plant``).
Each run's check numbers, beside their limits, and its ``correct`` (which
has to read false) are printed as one JSON line per seed and written to
``--out``. Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def plant(cell, parts=("depth", "sbs")):
    """Put the reference in the program's place; returns the function that
    takes it out again."""
    import torch
    from lib import control
    from lib.spec import load_entry
    from vsc_tpu_torch.pipeline import depth_map_generator
    undo = []
    if "depth" in parts:
        real_build = depth_map_generator.build_depth_fn
        lower = control.LOWER[cell.config["dtype"]]
        entry = load_entry(cell.mix["entry"])

        def build(*a, checkpoint, device, **k):
            ref = entry.reference_depth(cell.config, checkpoint,
                                        torch.device(device), lower)
            return lambda x: ref(x)
        depth_map_generator.build_depth_fn = build
        undo.append(lambda: setattr(depth_map_generator, "build_depth_fn",
                                    real_build))
    if "sbs" in parts:
        undo.append(control.plant(cell, ("sbs",)))

    def remove():
        for fn in reversed(undo):
            fn()
    return remove


def readings(cell, seeds, seconds, devices, parts=("depth", "sbs"),
             log=print) -> list:
    """One planted run a seed: [{"cell", "seed", "correct", "check"}]."""
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
