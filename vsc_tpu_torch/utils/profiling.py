"""
Profiling: traces, and the program's own spans and counters
===========================================================

  - trace(): a torch.profiler trace around a pipeline section, enabled by
    setting VSC_TPU_PROFILE_DIR (port of ``vsc_tpu/utils/profiling.py``);
    host activity always, the card's when one is present. The Chrome
    trace lands in a directory of the run's own,
    ``$VSC_TPU_PROFILE_DIR/<label>/<time>_<pid>_<suffix>/trace.json`` (open
    it in Perfetto or chrome://tracing), so processes that share the
    directory, as the orchestrator's children do, never overwrite each
    other's traces. The JAX package takes a jax.profiler trace there,
    which makes a directory per run too. The registry's spans of the
    section are written into the same file, on tracks of their own.
  - span(): the program's named spans (the dispatch, the copies in and
    out, DepthPro's encoder and decoder, the SBS), kept in a bounded ring
    while tracing is on; ``spans()`` reads them. The device counters
    (``ops/_cuda.device_counter``), reset with the launch counts, are read
    by ``counters()``.

Tracing is on exactly while a torch.profiler session is open in the
process: ``torch.autograd.profiler._is_profiler_enabled`` is one flag for
every thread, the dispatch thread of ``parallel/health.run_with_deadline``
included, whereas the profiler's own record of host events is kept per
thread and leaves that thread out. Both trace() and a caller's own
``torch.profiler.profile`` turn it on; otherwise a span site costs one
read of the flag.

A span records its name, its start and end (``time.time_ns()``, the clock
the profiler's timestamps start from), its thread, an id, its parent's id
and a batch id shared by every span under one outermost span (a
``contextvars`` variable: ``run_with_deadline`` runs its worker in a copy
of the caller's context). A host span also leaves a zero-length
``record_function("vsc.<name>")`` mark at its start, so that where the
profiler records the span's thread, a reader can put the registry's times
on the profiler's clock. A device span records a pair of CUDA events on
the current stream instead (a ``record_function`` around device work
shows up on the device too); the events belong to the span's ring slot
and are reused as the ring wraps, and their time is read by ``spans()``,
never on the hot path.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import tempfile
import threading
import time

from torch.autograd import profiler as _torch_profiler

__all__ = ["trace", "PROFILE_ENV", "tracing", "span", "spans", "counters",
           "reset", "RING"]

PROFILE_ENV = "VSC_TPU_PROFILE_DIR"
RING = 16384                  # spans kept: more than any profiled window
MARK_PREFIX = "vsc."

_ring: list = [None] * RING
_ids = itertools.count(1)
_current = contextvars.ContextVar("vsc_span", default=None)  # (id, batch)
_events: dict = {}      # CUDA device index -> [event pair or None] * RING
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """True while a torch.profiler session is open in this process."""
    return _torch_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "frames", "device", "events", "id", "parent",
                 "batch", "thread", "start_ns", "end_ns", "_token")

    def __init__(self, name, frames, device):
        self.name, self.frames, self.device = name, frames, device
        self.events = None

    def __enter__(self):
        cur = _current.get()
        self.id = next(_ids)
        self.parent, self.batch = cur if cur is not None else (None, self.id)
        self._token = _current.set((self.id, self.batch))
        self.thread = threading.current_thread().name
        self.start_ns = time.time_ns()
        if self.device:
            self.events = _event_pair(self.id % RING)
            self.events[0].record()
        else:
            with _torch_profiler.record_function(MARK_PREFIX + self.name):
                pass
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        _current.reset(self._token)
        self._token = None
        _ring[self.id % RING] = self
        return False


def _event_pair(slot: int):
    import torch
    pool = _events.setdefault(torch.cuda.current_device(), [None] * RING)
    if pool[slot] is None:
        pool[slot] = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
    return pool[slot]


def span(name: str, frames: int | None = None, device: bool = False):
    """A context manager that records the span ``name`` while tracing is
    on (``frames``: the frames it handles, where that means something;
    ``device``: time the current CUDA stream between CUDA events rather
    than leave a profiler mark), and does nothing otherwise."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, frames, device)


def spans() -> list[dict]:
    """The finished spans in the ring, oldest first: id, parent, batch,
    name, thread, start_ns, end_ns, frames and device_ms (the CUDA events'
    elapsed milliseconds; None for a host span). Waits for the events."""
    out = []
    for s in list(_ring):
        if s is None:
            continue
        device_ms = None
        if s.events is not None:
            s.events[1].synchronize()
            device_ms = s.events[0].elapsed_time(s.events[1])
        out.append({"id": s.id, "parent": s.parent, "batch": s.batch,
                    "name": s.name, "thread": s.thread,
                    "start_ns": s.start_ns, "end_ns": s.end_ns,
                    "frames": s.frames, "device_ms": device_ms})
    out.sort(key=lambda d: (d["start_ns"], d["id"]))
    return out


def counters() -> dict[str, int]:
    """The device counters (``ops/_cuda.DEVICE_COUNTERS``) as
    {"<group>.<field>": count}, their slots and cards summed, read with one
    small copy a card (which waits for the kernels that add to them)."""
    import torch

    from vsc_tpu_torch.ops._cuda import DEVICE_COUNTERS, _COUNTER_TENSORS
    out: dict[str, int] = {}
    for dev in sorted({d for _, d in _COUNTER_TENSORS}):
        groups = [g for g, d in _COUNTER_TENSORS if d == dev]
        sums = torch.stack([_COUNTER_TENSORS[g, dev] for g in groups]).cpu()
        for g, row in zip(groups, sums.sum(dim=1).tolist()):
            for field, v in zip(DEVICE_COUNTERS[g], row):
                out[f"{g}.{field}"] = out.get(f"{g}.{field}", 0) + v
    return out


def reset() -> None:
    """Forget every recorded span."""
    _ring[:] = [None] * RING


def _write_spans(path: str, recorded: list[dict]) -> None:
    """Add ``recorded`` to the Chrome trace at ``path``: a track a thread
    (named "vsc spans: <thread>"), on the file's own clock."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    tids: dict[str, int] = {}
    events = doc.setdefault("traceEvents", [])
    for s in recorded:
        if s["thread"] not in tids:
            tids[s["thread"]] = 0x7FFF0000 + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tids[s["thread"]],
                           "args": {"name": f"vsc spans: {s['thread']}"}})
        args = {k: s[k] for k in ("id", "parent", "batch", "frames",
                                  "device_ms") if s[k] is not None}
        events.append({"ph": "X", "cat": "vsc_span", "name": s["name"],
                       "pid": pid, "tid": tids[s["thread"]],
                       "ts": (s["start_ns"] - base) / 1e3,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(label: str):
    """torch.profiler trace around a section when VSC_TPU_PROFILE_DIR is
    set, written as ``<dir>/<label>/<run>/trace.json`` with a new ``<run>``
    directory per call, the section's spans from every thread included;
    otherwise free."""
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
    first = next(_ids)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(target, "trace.json")
    prof.export_chrome_trace(path)
    _write_spans(path, [s for s in spans() if s["id"] > first])
