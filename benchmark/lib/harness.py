"""
One run of one cell
===================

The general loop every cell runs through. The cell's traffic mix
(``traffic/<mix>.json``, data) names the program entry it drives
("entry"); that entry's driver, ``entries/<entry>.py``, is found by the
name. Its ``inputs(cell, seed, device)`` makes the run's inputs from the
seed; its ``Entry(cell, inputs, devices, spans)`` sets up the program and
the spans around the program's layers, and gives:

  warm()          every shape and kernel instance the window will run
  step(i)         one step, ending with its result in host memory:
                  (units completed, the step's sample for the check)
  record()        what its per-layer readers need besides the window's
                  own numbers (frame size, batch, stereo parameters, ...)
  release()       drops the program's state after the window
  check(samples)  {number: value}: the sampled steps' outputs against
                  the plain reference (``lib/check.py``)

and ``UNIT``, what a unit is ("frames", "requests").

Set-up ends once ``warm()`` has run. The window is a closed loop of steps
for ``seconds``; each step is timed on the host's clock. With ``trace``
the spans (CUDA events) are kept per step, and the profiler covers a few
steps in the window's middle (``lib/trace.py``); the steps it covers are
left out of the span sums.

After the window: the peak memory is read, the program's state freed,
and a sample of the window's steps drawn from the seed (a reservoir) is
held against the plain reference.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from frozen import flops
from lib import check, trace
from lib.spec import Cell, load_entry, load_reader

__all__ = ["run_cell", "Spans", "Reservoir"]

GIB = float(2 ** 30)


class Reservoir:
    """A uniform sample of ``k`` of a stream of items, drawn from ``rng``."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def offer(self, item):
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.n))
            if j < self.k:
                self.items[j] = item


class Spans:
    """CUDA events around the calls of the program's named layers, kept per
    step (when ``on`` and a card is present; else the calls run as they
    are)."""

    def __init__(self, on: bool):
        self.on = on and torch.cuda.is_available()
        self.pairs: dict[str, dict[int, list]] = {}
        self.step = -1
        self._patched: list = []

    def wrap(self, layer: str, fn):
        if not self.on:
            return fn
        pairs = self.pairs.setdefault(layer, {})

        def timed(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            pairs.setdefault(self.step, []).append((e0, e1))
            return out
        return timed

    def patch(self, module, attr: str, layer: str) -> None:
        """Time ``module.attr`` as ``layer`` until ``restore()``."""
        real = getattr(module, attr)
        self._patched.append((module, attr, real))
        setattr(module, attr, self.wrap(layer, real))

    def restore(self) -> None:
        for module, attr, real in reversed(self._patched):
            setattr(module, attr, real)
        self._patched.clear()

    def clear(self) -> None:
        for pairs in self.pairs.values():
            pairs.clear()

    def ms(self, layer: str, steps) -> float:
        pairs = self.pairs.get(layer, {})
        return sum(a.elapsed_time(b) for s in steps
                   for a, b in pairs.get(s, ()))

    def calls(self, layer: str, steps) -> int:
        pairs = self.pairs.get(layer, {})
        return sum(len(pairs.get(s, ())) for s in steps)


def _smi() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                            "clocks.sm,temperature.gpu",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def _end_to_end(metric: dict, done: int, window: float, step_s, peak: int,
                setup_s: float) -> float:
    """An end-to-end metric by its kind: a rate ("<units>/s": the units
    completed over the window), a latency percentile ("..._p<q>", ms, over
    every step of the window, each step one request where a cell reports
    one), the peak memory (GiB) or the set-up time."""
    name, unit = metric["name"], metric["unit"]
    if unit.endswith("/s"):
        return done / window
    if unit == "ms" and "_p" in name:
        q = float(name.rsplit("_p", 1)[1])
        return float(np.percentile(np.asarray(step_s) * 1e3, q))
    if unit == "GiB":
        return peak / GIB
    if name == "setup_s":
        return setup_s
    raise ValueError(f"no way to measure end-to-end metric {name} ({unit})")


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, devices,
             t0: float, log=None) -> dict:
    """One run on ``devices`` (the cell's cards, or ["cpu"] in tests);
    returns the result line's object, "check" last."""
    from vsc_tpu_torch.ops import _cuda

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    device = torch.device(devices[0])
    on_card = device.type == "cuda"
    entry_name = cell.mix["entry"]
    mod = load_entry(entry_name)

    # ---- set-up: inputs from the seed, the program, every shape warm;
    # the peak memory counts from the program's set-up on
    inputs = mod.inputs(cell, seed, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    spans = Spans(traced)
    entry = mod.Entry(cell, inputs, devices, spans)
    kept = Reservoir(int(cell.mix["check"]["sample"]),
                     np.random.default_rng([abs(int(seed)), 3]))
    entry.warm()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"setup: {setup_s:.3f} s ({entry_name}, seed {seed})")

    # ---- the window
    spans.clear()
    _cuda.reset_launches()
    # traced: the profiler covers one warm-up step (its own start-up) and
    # then "trace_steps" steps, from 30 % into the window; the window runs
    # on until they are done
    prof, prof_steps, prof_open = None, [], False
    n_trace = int(cell.mix["trace_steps"])
    step_s: list[float] = []
    units: list[int] = []
    i = 0
    t_start = time.perf_counter()
    while True:
        spans.step = i
        if traced and prof is None and on_card and \
                time.perf_counter() - t_start >= 0.3 * seconds:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            prof_open = True
        ts = time.perf_counter()
        if prof_open and prof_steps:
            with torch.profiler.record_function(trace.STEP):
                n, sample = entry.step(i)
        else:
            n, sample = entry.step(i)
        step_s.append(time.perf_counter() - ts)
        units.append(n)
        kept.offer(sample)
        sample = None
        if prof_open:
            prof_steps.append(i)
            if len(prof_steps) == n_trace + 1:
                if on_card:
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                prof_open = False
        i += 1
        if time.perf_counter() - t_start >= seconds and not prof_open:
            break
    t_end = time.perf_counter()
    spans.restore()
    window = t_end - t_start
    done = sum(units)
    launches = dict(_cuda.LAUNCHES)

    metrics = {}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if not traced:
        for m in cell.end_to_end:
            v = _end_to_end(m, done, window, step_s, peak, setup_s)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    lt = np.asarray(step_s) * 1e3
    log(f"window: {window:.4f} s, {i} steps, {done} {mod.UNIT}; step "
        f"median {float(np.median(lt)):.4f} ms, p95 "
        f"{float(np.percentile(lt, 95)):.4f} ms, max {float(lt.max()):.4f} "
        f"ms; peak {peak / GIB:.4f} GiB")

    result = {"correct": None, "attempted": done, "failed": 0,
              "metrics": metrics}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": len(devices), "memory_peak_bytes": int(peak)}

    if traced:
        covered = set(prof_steps)
        free = [s for s in range(i) if s not in covered]
        red = (trace.reduce_profile(prof) if prof is not None else
               {"device": [], "host": [], "window": None, "steps": 0})
        active = prof_steps[1:]               # the first is the warm-up
        rec = {"config": cell.config,
               "units_free": sum(units[s] for s in free),
               "host_s_free": sum(step_s[s] for s in free),
               "trace": red, "units_traced": sum(units[s] for s in active),
               "flops": flops, "trace_lib": trace}
        for layer in spans.pairs:
            rec[f"{layer}_ms_free"] = spans.ms(layer, free)
            rec[f"{layer}_calls_free"] = spans.calls(layer, free)
        rec.update(entry.record())
        for m in cell.per_layer:
            v = load_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if red["window"] is not None:
            w0, w1 = red["window"]
            busy = trace.busy_us(red["device"])
            device_info["busy_s"] = busy / 1e6
            device_info["window_s"] = (w1 - w0) / 1e6
            groups = sorted(trace.by_group(red["device"]).items(),
                            key=lambda kv: -kv[1])
            result["breakdown"] = {
                "device_ops": [[g, t / 1e6] for g, t in groups[:10]],
                "idle_gaps": [[n, t / 1e6] for n, t in trace.idle_gaps(
                    red["device"], red["host"], red["window"])]}
            log(f"trace: {red['steps']} steps, window "
                f"{(w1 - w0) / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, "
                f"{len(red['device'])} device events")
        log(f"launches per {mod.UNIT[:-1]}: " + ", ".join(
            f"{k} {v / max(done, 1):.4f}" for k, v in launches.items() if v))
    result["device"] = device_info
    log(f"card: {_smi()}" if on_card else "card: none (cpu)")

    # ---- the output check, after the window, the program's state freed
    entry.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    numbers = check.held(cell, entry.check(kept.items))
    log(f"check: {len(kept.items)} sampled steps of {kept.n}, "
        f"{time.perf_counter() - tc:.3f} s")
    result["correct"] = all(math.isfinite(n["value"])
                            and n["value"] <= n["limit"]
                            for n in numbers.values())
    result["check"] = numbers
    for k, n in numbers.items():
        log(f"check {k}: {n['value']!r} limit {n['limit']!r}")
    return result
