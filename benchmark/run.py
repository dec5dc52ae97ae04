"""
The benchmark of the PyTorch/CUDA port: one run of one cell
============================================================

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with the card(s) the cell
asks for. It reads the cell from ``BENCHMARK.json``, makes its inputs from
the seed, sets up the program (``vsc_tpu_torch``) on the cell's cards
through the driver of the entry its mix names (``entries/<entry>.py``),
runs every shape of the window once, measures a closed loop for
``--seconds`` and checks a sample of what the window produced against the
plain reference. The last line of
standard output is one JSON object: "correct", "attempted", "failed",
"metrics" (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), "device", with ``--trace 1`` "breakdown", and last
"check", each number compared beside its limit. The same numbers are the
last lines of standard error.

Exits 2 and prints no result without a card (or fewer than the cell
asks for); exits 3 and prints no result when jax, jaxlib, flax or the JAX
package is loaded once the window has closed.

The program's kernel library builds into ``build/vsc_tpu_torch/`` and the
seeded weight file into ``benchmark/.cache/``, both inside the checkout,
so only a checkout's first run builds them.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

FORBIDDEN = ("jax", "jaxlib", "flax", "vsc_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``vsc_tpu_torch`` is not ``vsc_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    from lib.spec import load_benchmark, resolve
    cell = resolve(load_benchmark(), args.workload)

    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has {have}: nothing measured", file=sys.stderr)
        return 2

    from lib.harness import run_cell
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      [f"cuda:{i}" for i in range(cell.chips)], T0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules loaded that the port must not use: "
              f"{', '.join(found)}: no result", file=sys.stderr)
        return 3
    check = result.pop("check")
    result["check"] = check
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
