"""BENCHMARK.json against the contract's shape, and every entry resolved
to its configuration, mix and readers."""

import json
import re

import pytest

from lib.spec import (BENCH_DIR, ROOT, load_benchmark, load_entry,
                      load_reader, reader_path, resolve)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = load_benchmark()


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "benchmark/run.py"]
    assert B["paths"] == ["benchmark"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_cell_resolves(cell):
    c = resolve(B, cell)
    assert c.chips == 1
    assert c.config["frame"]["height"] > 0
    entry = load_entry(c.mix["entry"])
    assert callable(entry.inputs) and entry.UNIT
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(load_reader(m["name"]))
        assert m["moves"] in names


def test_entries_follow_the_contract():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
        assert any(w["config"] == c["name"] for w in B["workloads"])
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in e2e
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert reader_path(m["name"]).is_file()


def test_readers_fall_back_to_their_base_name():
    d = BENCH_DIR / "metrics"
    assert reader_path("device_idle_pct.4k") == d / "device_idle_pct.py"
    assert reader_path("sbs_ms.preview") == d / "sbs_ms.preview.py"
    with pytest.raises(FileNotFoundError):
        reader_path("no_such_metric.4k")
    with pytest.raises(FileNotFoundError):
        load_entry("no_such_entry")


def test_layers_are_named_in_perf_md():
    text = (ROOT / "PERF.md").read_text()
    for m in B["per_layer"]:
        assert f"`{m['layer']}`" in text, m["layer"]
