"""The readers of the program's own spans and counters
(``lib/program_spans.py``, ``metrics/{copy_in_host_ms_per_frame,
copy_out_host_ms_per_frame, idle_in_transfer_pct,
depth_encoder_ms_per_frame, depth_decoder_ms_per_frame,
hole_tile_pct}.py``) on hand-built registries and records."""

import ast

import pytest

from lib import program_spans, trace
from lib.spec import ROOT, load_reader

T0 = 1_790_000_000_000_000_000      # ns: where the hand-built clock starts
OFF = -T0 / 1e3 + 250.0             # us: the profiler's clock, by the marks


def _span(name, start_us, end_us, thread="vsc-dispatch", frames=None,
          device_ms=None, sid=0):
    return {"id": sid, "parent": None, "batch": 0, "name": name,
            "thread": thread, "start_ns": T0 + int(start_us * 1e3),
            "end_ns": T0 + int(end_us * 1e3), "frames": frames,
            "device_ms": device_ms}


def _registry(monkeypatch, spans, counters=None):
    from vsc_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters or {}))


def _rec(device, host, window=(0.0, 1000.0)):
    return {"trace": {"device": device, "host": host, "window": window,
                      "steps": 2}, "trace_lib": trace, "units_traced": 8}


def _convert_step(at_us, k):
    """One convert step's spans at ``at_us`` (registry time), 4 frames:
    the dispatch on the main thread, the copies on the dispatch thread."""
    return [
        _span("dispatch", at_us, at_us + 900.0, thread="MainThread",
              sid=10 * k),
        _span("transfer.copy_in", at_us + 10.0, at_us + 30.0, sid=10 * k + 1),
        _span("depth", at_us + 30.0, at_us + 700.0, frames=4,
              device_ms=600.0, sid=10 * k + 2),
        _span("depth.encoder", at_us + 40.0, at_us + 400.0, frames=4,
              device_ms=360.0, sid=10 * k + 3),
        _span("depth.decoder", at_us + 400.0, at_us + 600.0, frames=4,
              device_ms=160.0, sid=10 * k + 4),
        _span("sbs", at_us + 700.0, at_us + 750.0, frames=4, device_ms=40.0,
              sid=10 * k + 5),
        _span("transfer.drain", at_us + 750.0, at_us + 800.0, sid=10 * k + 6),
        _span("transfer.copy_out", at_us + 800.0, at_us + 860.0, frames=4,
              sid=10 * k + 7)]


def test_idle_in_transfer_reads_the_half_of_a_gap_a_copy_covers(monkeypatch):
    """The device idles 400-600 us of a 1000 us window; a copy span on the
    dispatch thread (not in the profiler's record) covers 500-700 on the
    profiler's clock once the main thread's dispatch mark places it: half
    the gap, so half of device_idle_pct."""
    spans = [_span("dispatch", -250.0, 1000.0 - 250.0, thread="MainThread"),
             _span("transfer.copy_out", 250.0, 450.0, frames=8)]
    _registry(monkeypatch, spans)
    host = [(0.0, 2.0, "vsc.dispatch"), (520.0, 680.0, "aten::copy_")]
    rec = _rec([(0.0, 400.0, "k1"), (600.0, 1000.0, "k2")], host)
    idle = load_reader("device_idle_pct")(rec)
    assert idle == pytest.approx(20.0)
    assert load_reader("idle_in_transfer_pct")(rec) == pytest.approx(
        idle / 2)
    assert load_reader("idle_in_transfer_pct.rerender")(rec) == \
        pytest.approx(10.0)


def test_the_marks_pair_with_the_last_spans_of_their_thread():
    """The registry holds the profiler's warm-up step before the window:
    the window's k marks are the last k spans of the thread that left
    them, whatever the spans of another thread of the same name."""
    sp = _convert_step(0.0, 0) + _convert_step(1000.0, 1) + \
        _convert_step(2000.0, 2)
    sp.append(_span("dispatch", 2100.0, 2200.0, thread="other"))
    host = [(1000.0 + OFF + T0 / 1e3 + 3.0, 0.0, "vsc.dispatch"),
            (2000.0 + OFF + T0 / 1e3 + 5.0, 0.0, "vsc.dispatch")]
    got = program_spans.clock_offset_us(sp, host)
    assert got == pytest.approx(OFF + 4.0)
    assert program_spans.clock_offset_us(sp, []) is None


def test_copy_depth_and_hole_readers(monkeypatch):
    sp = _convert_step(0.0, 0) + _convert_step(1000.0, 1)
    _registry(monkeypatch, sp, {"postprocess.fast_tiles": 366,
                                "postprocess.hole_tiles": 34})
    rec = _rec([], [])
    # 8 frames copied out in the two steps
    assert load_reader("copy_in_host_ms_per_frame")(rec) == \
        pytest.approx(2 * 0.020 / 8)
    assert load_reader("copy_out_host_ms_per_frame.4k")(rec) == \
        pytest.approx(2 * 0.060 / 8)
    assert load_reader("depth_encoder_ms_per_frame")(rec) == \
        pytest.approx(2 * 360.0 / 8)
    assert load_reader("depth_decoder_ms_per_frame.4k")(rec) == \
        pytest.approx(2 * 160.0 / 8)
    assert load_reader("hole_tile_pct.rerender")(rec) == pytest.approx(8.5)
    # no window in the trace: no idle share
    assert load_reader("idle_in_transfer_pct")(
        _rec([], [], window=None)) is None


READERS = ["copy_in_host_ms_per_frame", "copy_out_host_ms_per_frame",
           "idle_in_transfer_pct", "depth_encoder_ms_per_frame",
           "depth_decoder_ms_per_frame", "hole_tile_pct"]


@pytest.mark.parametrize("name", READERS)
def test_an_empty_registry_reads_nothing(monkeypatch, name):
    _registry(monkeypatch, [])
    rec = _rec([(0.0, 400.0, "k")], [(0.0, 1.0, "vsc.dispatch")])
    assert load_reader(name)(rec) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_registry_reads_nothing(monkeypatch, name):
    """The parent of the registry's PR runs the same readers: nothing to
    read there, and no error."""
    from vsc_tpu_torch.utils import profiling
    for attr in ("spans", "counters"):
        monkeypatch.delattr(profiling, attr, raising=False)
    rec = _rec([(0.0, 400.0, "k")], [(0.0, 1.0, "vsc.dispatch")])
    assert load_reader(name)(rec) is None


def _program_span_names():
    """Every name the program passes to ``span(...)``."""
    names = set()
    for path in (ROOT / "vsc_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "span"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


def test_no_span_or_mark_name_falls_in_a_kernel_group():
    names = _program_span_names()
    assert names >= {"dispatch", "transfer.copy_in", "transfer.drain",
                     "transfer.copy_out", "depth", "depth.encoder",
                     "depth.decoder", "sbs"}
    for n in names:
        for x in (n, "vsc." + n):
            assert trace.group_of(x) == "other device work", x
