"""
Profiling and throughput metering
=================================

Port of ``vsc_tpu/utils/profiling.py``:

  - trace(): a torch.profiler trace around a pipeline section, enabled by
    setting VSC_TPU_PROFILE_DIR; host activity always, the card's when one
    is present. The Chrome trace lands in a directory of the run's own,
    ``$VSC_TPU_PROFILE_DIR/<label>/<time>_<pid>_<suffix>/trace.json`` (open
    it in Perfetto or chrome://tracing), so processes that share the
    directory, as the orchestrator's children do, never overwrite each
    other's traces. The JAX package takes a jax.profiler trace there, which
    makes a directory per run too.
  - Throughput: a tiny images/sec meter the step CLIs feed and expose in
    their progress lines (which the orchestrator dashboard mirrors).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

__all__ = ["trace", "Throughput", "PROFILE_ENV"]

PROFILE_ENV = "VSC_TPU_PROFILE_DIR"


@contextlib.contextmanager
def trace(label: str):
    """torch.profiler trace around a section when VSC_TPU_PROFILE_DIR is
    set, written as ``<dir>/<label>/<run>/trace.json`` with a new ``<run>``
    directory per call; otherwise free."""
    profile_dir = os.environ.get(PROFILE_ENV)
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    parent = os.path.join(profile_dir, label)
    os.makedirs(parent, exist_ok=True)
    target = tempfile.mkdtemp(
        prefix=time.strftime("%Y%m%d_%H%M%S_") + f"{os.getpid()}_", dir=parent)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(target, "trace.json"))


class Throughput:
    """Sliding-window items/sec meter."""

    def __init__(self, window: float = 30.0):
        self.window = window
        self.events: list[tuple[float, int]] = []

    def add(self, n: int = 1) -> None:
        now = time.monotonic()
        self.events.append((now, n))
        cutoff = now - self.window
        while self.events and self.events[0][0] < cutoff:
            self.events.pop(0)

    @property
    def rate(self) -> float:
        if len(self.events) < 2:
            return 0.0
        span = self.events[-1][0] - self.events[0][0]
        if span <= 0:
            return 0.0
        return sum(n for _, n in self.events[1:]) / span
