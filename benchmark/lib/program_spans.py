"""
The program's own spans and counters, as the per-layer readers take them
========================================================================

While a torch.profiler session is open, ``vsc_tpu_torch.utils.profiling``
keeps a span for each dispatch, copy in and out, depth, DepthPro encoder
and decoder and SBS call, and the postprocess kernel counts its tiles on
the card. In a traced run that is exactly the profiled steps, the
profiler's own warm-up step included, so the readers divide by the frames
of the same spans ("transfer.copy_out"), never by ``rec["units_traced"]``.
A program without the registry (one older than it) gives nothing, and so
does an empty registry: the readers then return None.

Host spans leave a zero-length profiler mark ("vsc.<name>") at their
start on their own thread; where the profiler records that thread (the
main thread's "dispatch" in the convert cells, the copies in the
rerender) the marks in ``rec["trace"]["host"]`` put the registry's times
(``time.time_ns()``) on the profiler's clock.
"""

from __future__ import annotations

import statistics

__all__ = ["COPY_IN", "COPY_OUT", "spans", "counters", "frames",
           "host_ms_per_frame", "device_ms_per_frame", "clock_offset_us",
           "idle_in_transfer_pct"]

COPY_IN, COPY_OUT = "transfer.copy_in", "transfer.copy_out"
MARK = "vsc."


def _registry(attr: str):
    try:
        from vsc_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, attr, None)


def spans():
    """The program's finished spans, or None (no registry, or empty)."""
    read = _registry("spans")
    return (read() or None) if read is not None else None


def counters():
    """The program's counters, or None (no registry)."""
    read = _registry("counters")
    return read() if read is not None else None


def frames(sp) -> int:
    """The frames the steps copied out."""
    return sum(s["frames"] or 0 for s in sp if s["name"] == COPY_OUT)


def host_ms_per_frame(sp, name: str):
    """Host milliseconds of the spans ``name`` a frame copied out."""
    n, got = frames(sp), [s for s in sp if s["name"] == name]
    if not n or not got:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in got) / 1e6 / n


def device_ms_per_frame(sp, name: str):
    """CUDA-event milliseconds of the device spans ``name`` a frame copied
    out."""
    n = frames(sp)
    ms = [s["device_ms"] for s in sp
          if s["name"] == name and s["device_ms"] is not None]
    if not n or not ms:
        return None
    return sum(ms) / n


def clock_offset_us(sp, host):
    """Microseconds to add to a span's ``start_ns / 1e3`` to put it on the
    profiler's clock: the median over the marks in ``host`` (the trace's
    host events) of a mark's start less its span's. A name's k marks are
    the last k spans of that name on one thread (the window ends the
    registry; the profiler records some threads only): the thread whose
    pairing spreads least. None without marks."""
    marks: dict[str, list] = {}
    for a, _, name in host:
        if name.startswith(MARK):
            marks.setdefault(name[len(MARK):], []).append(a)
    offsets = []
    for name, starts in marks.items():
        starts.sort()
        by_thread: dict[str, list] = {}
        for s in sp:
            if s["name"] == name:
                by_thread.setdefault(s["thread"], []).append(
                    s["start_ns"] / 1e3)
        best = None
        for t in by_thread.values():
            if len(t) < len(starts):
                continue
            d = [m - u for m, u in zip(starts, sorted(t)[-len(starts):])]
            if best is None or max(d) - min(d) < max(best) - min(best):
                best = d
        offsets += best or []
    return statistics.median(offsets) if offsets else None


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """The length both unions of disjoint sorted intervals cover."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_transfer_pct(sp, tr):
    """The share of the trace's window (percent) in which the device runs
    nothing while a copy span (in or out) is open, the spans placed on the
    profiler's clock by ``clock_offset_us``. None without a window, device
    events or marks."""
    if tr["window"] is None or not tr["device"]:
        return None
    off = clock_offset_us(sp, tr["host"])
    if off is None:
        return None
    w0, w1 = tr["window"]
    open_ = _union((max(s["start_ns"] / 1e3 + off, w0),
                    min(s["end_ns"] / 1e3 + off, w1))
                   for s in sp if s["name"] in (COPY_IN, COPY_OUT))
    open_ = [iv for iv in open_ if iv[1] > iv[0]]
    busy = _union((a, b) for a, b, _ in tr["device"])
    idle = sum(b - a for a, b in open_) - _overlap(open_, busy)
    return 100.0 * idle / (w1 - w0)
