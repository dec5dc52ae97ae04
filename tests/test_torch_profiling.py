"""The port's trace() (vsc_tpu_torch/utils/profiling.py) writes each run
into a directory of its own under ``$VSC_TPU_PROFILE_DIR/<label>/``, as
jax.profiler.trace does, so two runs with one label (two processes of one
step under the orchestrator, or two calls in one process) both survive."""

import json

import torch

from vsc_tpu_torch.utils.profiling import PROFILE_ENV, trace


def test_two_traces_with_one_label_both_survive(tmp_path, monkeypatch):
    monkeypatch.setenv(PROFILE_ENV, str(tmp_path))
    for n in (3, 5):
        with trace("sbs_generator"):
            torch.arange(n).sum()
    traces = sorted((tmp_path / "sbs_generator").glob("*/trace.json"))
    assert len(traces) == 2, traces
    assert traces[0].parent != traces[1].parent
    for t in traces:
        events = json.loads(t.read_text())["traceEvents"]
        assert any("aten::sum" in e.get("name", "") for e in events)


def test_no_trace_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv(PROFILE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    with trace("sbs_generator"):
        torch.arange(3).sum()
    assert list(tmp_path.iterdir()) == []


# ---- the registry of spans and counters (utils/profiling.span, spans,
# counters): on exactly while a torch.profiler session is open

import dataclasses
import statistics
import threading

import numpy as np
import pytest
from torch.autograd import profiler as torch_profiler
from torch.profiler import ProfilerActivity, profile

from vsc_tpu_torch.ops import _cuda
from vsc_tpu_torch.parallel import health
from vsc_tpu_torch.parallel.auto import gather, shard_batch
from vsc_tpu_torch.utils import profiling


@pytest.fixture
def registry():
    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _copy_step():
    """A step as the streaming converter's dispatch runs it, on the CPU."""
    x = shard_batch(np.arange(24, dtype=np.uint8).reshape(4, 2, 3), "cpu")
    with profiling.span("sbs", frames=4):
        y = x + 1
    return gather(y).numpy()


def test_nothing_is_recorded_without_a_profiler(registry):
    assert not registry.tracing()
    assert registry.span("a") is registry.span("b", frames=3, device=True)
    for _ in range(3):
        health.run_with_deadline(_copy_step, 30)
    assert registry.spans() == []


def test_the_flag_is_on_in_the_dispatch_thread_under_a_profiler():
    """The design stands on this torch behaviour: the profiler's flag is
    one for the process, so the dispatch thread sees it, though the
    profiler keeps no record of that thread's own events."""
    seen = []

    def probe():
        seen.append((threading.current_thread().name,
                     torch_profiler._is_profiler_enabled,
                     profiling.tracing()))
    health.run_with_deadline(probe, 30)
    with profile(activities=[ProfilerActivity.CPU]):
        health.run_with_deadline(probe, 30)
    health.run_with_deadline(probe, 30)
    assert seen == [("vsc-dispatch", False, False),
                    ("vsc-dispatch", True, True),
                    ("vsc-dispatch", False, False)]


def test_worker_spans_hang_under_the_callers_dispatch(registry):
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            health.run_with_deadline(_copy_step, 30)
    got = registry.spans()
    assert [s["name"] for s in got] == 2 * [
        "dispatch", "transfer.copy_in", "sbs", "transfer.drain",
        "transfer.copy_out"]
    for step in (got[:5], got[5:]):
        top, rest = step[0], step[1:]
        assert top["thread"] == threading.current_thread().name
        assert top["parent"] is None and top["batch"] == top["id"]
        for s in rest:
            assert s["thread"] == "vsc-dispatch"
            assert s["parent"] == top["id"] and s["batch"] == top["id"]
            assert top["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= top["end_ns"]
    assert got[0]["batch"] != got[5]["batch"]
    assert [s["frames"] for s in got[:5]] == [None, None, 4, None, 4]
    assert all(s["device_ms"] is None for s in got)


def test_nested_spans_share_the_outer_batch(registry):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("depth", frames=2):
            with profiling.span("depth.encoder"):
                pass
            with profiling.span("depth.decoder"):
                pass
        with profiling.span("sbs"):
            pass
    d, enc, dec, sbs = registry.spans()
    assert enc["parent"] == dec["parent"] == d["id"]
    assert enc["batch"] == dec["batch"] == d["batch"] == d["id"]
    assert sbs["parent"] is None and sbs["batch"] == sbs["id"]


def test_marks_put_the_spans_on_the_profilers_clock(registry):
    """A host span's mark ("vsc.<name>") on the profiled thread starts
    where its span starts once the profiler's relative times are put back
    on time.time_ns() by the trace's start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(8):
            with profiling.span("transfer.copy_in"):
                pass
    start = prof.profiler.kineto_results.trace_start_ns()
    marks = sorted(e.time_range.start for e in prof.events()
                   if e.name == "vsc.transfer.copy_in")
    got = registry.spans()
    assert len(marks) == len(got) == 8
    offsets_ms = [(start + m * 1e3 - s["start_ns"]) / 1e6
                  for m, s in zip(marks, got)]
    assert abs(statistics.median(offsets_ms)) < 0.5, offsets_ms


def test_the_ring_stays_bounded(registry):
    assert registry.RING >= 16384
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("dispatch"):
            for _ in range(registry.RING + 10):
                with profiling.span("sbs", device=False):
                    pass
    got = registry.spans()
    assert len(got) == registry.RING
    # the newest spans stay, the oldest went (the dispatch span, written
    # when it ends, took the slot of one of them)
    top = got[0]
    assert top["name"] == "dispatch"
    inner = sorted(s["id"] for s in got[1:])
    assert inner[-1] == top["id"] + registry.RING + 10
    assert inner[0] > top["id"] + 10


def test_trace_json_holds_the_worker_spans(tmp_path, monkeypatch, registry):
    monkeypatch.setenv(PROFILE_ENV, str(tmp_path))
    with trace("stream_convert"):
        health.run_with_deadline(_copy_step, 30)
    (path,) = (tmp_path / "stream_convert").glob("*/trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    threads = {e["tid"]: e["args"]["name"] for e in events
               if e.get("ph") == "M" and e.get("name") == "thread_name"}
    spans = [e for e in events if e.get("cat") == "vsc_span"]
    assert {e["name"] for e in spans} == {
        "dispatch", "transfer.copy_in", "sbs", "transfer.drain",
        "transfer.copy_out"}
    worker = [e for e in spans if threads[e["tid"]] == "vsc spans: "
              "vsc-dispatch"]
    assert len(worker) == 4
    # on the file's clock (its events count from baseTimeNanoseconds):
    # the dispatch span starts where the profiler's mark of it does, to
    # within the scheduling of one thread
    mark = next(e for e in events if e.get("name") == "vsc.dispatch")
    top = next(e for e in spans if e["name"] == "dispatch")
    assert abs(mark["ts"] - top["ts"]) < 5000.0
    assert all(top["ts"] <= e["ts"] <= top["ts"] + top["dur"]
               for e in worker)


def test_reset_launches_clears_the_counters(monkeypatch):
    # the counters as the postprocess wrapper leaves them while tracing
    # (on the card; a CPU tensor stands in for them here): the slots sum
    t = torch.zeros((_cuda.COUNTER_SLOTS, _cuda.COUNTER_STRIDE),
                    dtype=torch.int64)
    t[0, :2] = torch.tensor([30, 5])
    t[-1, :2] = torch.tensor([10, 2])
    t[3, 2:] = 99                           # the unused words are not read
    monkeypatch.setitem(_cuda._COUNTER_TENSORS, ("postprocess", 0), t)
    monkeypatch.setitem(_cuda.LAUNCHES, "postprocess", 3)
    assert profiling.counters() == {"postprocess.fast_tiles": 40,
                                    "postprocess.hole_tiles": 7}
    _cuda.reset_launches()
    assert profiling.counters() == {}
    assert _cuda.LAUNCHES["postprocess"] == 0


def test_no_device_counter_without_a_profiler():
    assert _cuda.device_counter("postprocess", torch.device("cuda", 0)) \
        is None


def test_a_cpu_convert_step_records_every_layer(registry, two_threads):
    """The streaming converter's per-batch body on the CPU with a tiny
    DepthPro: each layer's span, parented as the calls nest."""
    from vsc_tpu_torch.config import StereoParams
    from vsc_tpu_torch.models import DepthProConfig
    from vsc_tpu_torch.pipeline import depth_map_generator
    from vsc_tpu_torch.pipeline.stream_convert import render_sbs
    cfg = dataclasses.replace(DepthProConfig.tiny(), use_fov_head=False,
                              use_fov_encoder=False)
    depth_fn = depth_map_generator.build_depth_fn(
        "depthpro", 64, 32, 64, False, device="cpu", model_cfg=cfg)
    frames = np.random.default_rng(0).integers(0, 256, (2, 32, 64, 3),
                                               dtype=np.uint8)

    def step():
        x = shard_batch(frames, "cpu")
        return gather(render_sbs(x, depth_fn, StereoParams())).numpy()
    want = health.run_with_deadline(step, 120)
    assert registry.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        got = health.run_with_deadline(step, 120)
    assert np.array_equal(got, want)
    s = registry.spans()
    by = {x["name"]: x for x in s}
    assert [x["name"] for x in s] == [
        "dispatch", "transfer.copy_in", "depth", "depth.encoder",
        "depth.decoder", "sbs", "transfer.drain", "transfer.copy_out"]
    assert by["depth.encoder"]["parent"] == by["depth"]["id"]
    assert by["depth.decoder"]["parent"] == by["depth"]["id"]
    for name in ("transfer.copy_in", "depth", "sbs", "transfer.copy_out"):
        assert by[name]["parent"] == by["dispatch"]["id"]
    assert {x["batch"] for x in s} == {by["dispatch"]["id"]}
    assert by["transfer.copy_out"]["frames"] == by["sbs"]["frames"] == 2
