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
