"""The port's workflow state store (vsc_tpu_torch/runtime/workflow_state.py)
against the JAX package's on the cases of tests/test_workflow_state.py, plus
the collapse that reads a valid config: each case runs through one
package's ``load_workflows`` / ``save_workflows`` in a fresh directory, then
through the other's in the same directory (the YAML's keys are paths), and
the loaded and merged dicts and the YAML text written must be equal."""

import shutil
from types import SimpleNamespace

import pytest
import yaml

import vsc_tpu.config as jconfig
import vsc_tpu.runtime.workflow_state as jstate
import vsc_tpu_torch.config as tconfig
import vsc_tpu_torch.runtime.workflow_state as tstate

JAX = SimpleNamespace(state=jstate, config=jconfig)
PORT = SimpleNamespace(state=tstate, config=tconfig)


def write_yaml(path, data):
    path.write_text(yaml.safe_dump(data, sort_keys=False), encoding="utf-8")


def _all(st, status):
    return {s: status for s in st.STEP_ORDER}


def case_migrations(pkg, root):
    st = pkg.state
    wf_yaml = root / "workflows.yaml"
    write_yaml(wf_yaml, {
        "/a/one": None,                               # bare path
        "/a/two": "DONE",                             # completed shorthand
        "/a/three": {"steps": {"frame_extractor": "DONE"}},  # legacy nesting
        "/a/four": {"frame_extractor": "FAILED",      # FAILED -> PENDING
                    "depth_map_generator": "RUNNING",  # RUNNING preserved
                    "retry_count": 3},                 # legacy field dropped
    })
    wfs = st.load_workflows(wf_yaml)
    four = wfs[st.normalize_path("/a/four")]
    assert st.get_step_status(four["frame_extractor"]) == st.StepStatus.PENDING
    assert "retry_count" not in four
    merged = st.save_workflows(wf_yaml, wfs)
    return [wfs, merged, wf_yaml.read_text()]


def case_missing_and_empty(pkg, root):
    st = pkg.state
    (root / "empty.yaml").write_text("")
    (root / "list.yaml").write_text("- a\n- b\n")
    try:
        st.load_workflows(root / "list.yaml")
        bad = None
    except ValueError as e:
        bad = str(e)
    return [st.load_workflows(root / "nope.yaml"),
            st.load_workflows(root / "empty.yaml"), bad]


def case_merge_manual_edits(pkg, root):
    st = pkg.state
    wf_yaml = root / "workflows.yaml"
    p1, p2 = st.normalize_path("/a/one"), st.normalize_path("/a/two")
    state = {p1: _all(st, st.StepStatus.PENDING)}
    st.set_step_status(state[p1], "frame_extractor", st.StepStatus.RUNNING)
    first = st.save_workflows(wf_yaml, state)
    text1 = wf_yaml.read_text()
    # the user adds a workflow and a field of their own while it runs
    on_disk = yaml.safe_load(wf_yaml.read_text())
    on_disk[p2] = None
    on_disk[p1]["note"] = "mine"
    write_yaml(wf_yaml, on_disk)
    merged = st.save_workflows(wf_yaml, state)
    assert p2 in merged
    assert st.get_step_status(merged[p1]["frame_extractor"]) == \
        st.StepStatus.RUNNING
    return [first, text1, merged, wf_yaml.read_text()]


def case_transient_never_persist(pkg, root):
    st = pkg.state
    wf_yaml = root / "workflows.yaml"
    p1 = st.normalize_path("/a/one")
    state = {p1: _all(st, st.StepStatus.PENDING)}
    st.set_step_status(state[p1], "chunk_generator", st.StepStatus.RUNNING)
    st.set_step_status(state[p1], "video_concatenator", st.StepStatus.DONE)
    merged = st.save_workflows(wf_yaml, state)
    final = yaml.safe_load(wf_yaml.read_text())
    assert set(final[p1]) == set(st.PERSISTENT_STEPS)
    return [merged, wf_yaml.read_text()]


def case_collapse_to_done(pkg, root):
    # a workflow whose config is missing counts as complete / cleaned up
    st = pkg.state
    wf_yaml = root / "workflows.yaml"
    p1 = st.normalize_path(str(root / "gone"))
    merged = st.save_workflows(wf_yaml, {p1: _all(st, st.StepStatus.DONE)})
    assert yaml.safe_load(wf_yaml.read_text())[p1] == "DONE"
    return [merged, wf_yaml.read_text(), st.load_workflows(wf_yaml)]


def case_collapse_reads_config(pkg, root):
    # a valid config: DONE only once its output video exists
    st = pkg.state
    wf = root / "wf"
    wf.mkdir()
    config = pkg.config.create_default_config(root / "in.mkv")
    pkg.config.save_config(wf, config)
    wf_yaml = root / "workflows.yaml"
    p1 = st.normalize_path(str(wf))
    state = {p1: _all(st, st.StepStatus.DONE)}
    st.save_workflows(wf_yaml, state)
    before = wf_yaml.read_text()
    pkg.config.get_path(wf, config, "output_video").write_bytes(b"x")
    st.save_workflows(wf_yaml, state)
    assert yaml.safe_load(before)[p1] != "DONE"
    assert yaml.safe_load(wf_yaml.read_text())[p1] == "DONE"
    return [before, wf_yaml.read_text()]


def case_unreadable_config(pkg, root):
    st = pkg.state
    wf_yaml = root / "workflows.yaml"
    wf_dir = root / "wf"
    wf_dir.mkdir()
    (wf_dir / "config.json").write_text("{not json", encoding="utf-8")
    p1 = st.normalize_path(str(wf_dir))
    state = {p1: _all(st, st.StepStatus.DONE)}
    st.save_workflows(wf_yaml, state)
    kept = wf_yaml.read_text()
    assert yaml.safe_load(kept)[p1] != "DONE"
    (wf_dir / "config.json").unlink()
    st.save_workflows(wf_yaml, state)
    assert yaml.safe_load(wf_yaml.read_text())[p1] == "DONE"
    return [kept, wf_yaml.read_text()]


def case_config_as_directory(pkg, root):
    st = pkg.state
    wf_yaml = root / "workflows.yaml"
    wf_dir = root / "wf2"
    (wf_dir / "config.json").mkdir(parents=True)
    p1 = st.normalize_path(str(wf_dir))
    merged = st.save_workflows(wf_yaml, {p1: _all(st, st.StepStatus.DONE)})
    assert yaml.safe_load(wf_yaml.read_text())[p1] != "DONE"
    return [merged, wf_yaml.read_text()]


CASES = [case_migrations, case_missing_and_empty, case_merge_manual_edits,
         case_transient_never_persist, case_collapse_to_done,
         case_collapse_reads_config, case_unreadable_config,
         case_config_as_directory]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_state_store_matches_jax(case, tmp_path):
    root = tmp_path / "case"
    seen = []
    for pkg in (JAX, PORT):
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir()
        seen.append(case(pkg, root))
    assert seen[0] == seen[1]


def test_step_sets_match_jax():
    for name in ("STEP_ORDER", "PERSISTENT_STEPS", "TRANSIENT_STEPS",
                 "MUTEX_STEPS"):
        assert getattr(tstate, name) == getattr(jstate, name), name

    def statuses(cls):
        return {k: v for k, v in vars(cls).items() if not k.startswith("_")}
    assert statuses(tstate.StepStatus) == statuses(jstate.StepStatus)
