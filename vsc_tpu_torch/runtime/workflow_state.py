"""
Workflow state store
====================

YAML-backed batch state machine, semantics-compatible with the reference's
helper/workflow_state.py (so an existing workflows.yaml drives this
orchestrator unchanged):

  - Statuses PENDING/RUNNING/DONE/FAILED/ERROR per step
    (workflow_state.py:37-43); five steps in STEP_ORDER; the first three are
    "persistent" (status stored in YAML), chunk/concat are "transient"
    (always derived from the filesystem, stored as PENDING only).
  - Load-time migration (workflow_state.py:169-213): bare path -> defaults;
    the literal string DONE -> all-done; legacy nested `steps:` flattened;
    FAILED reset to PENDING (retry on restart); RUNNING preserved so the
    orchestrator can restart those first.
  - Merge-on-save (workflow_state.py:270-335, 401-457): the file is re-read
    before writing so manual edits survive; orchestrator state wins for
    persistent steps; completed workflows collapse to `path: DONE`; writes
    are atomic (tempfile + os.replace).

The port's own copy of ``vsc_tpu/runtime/workflow_state.py`` (no torch).
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import yaml

__all__ = [
    "StepStatus",
    "STEP_ORDER",
    "PERSISTENT_STEPS",
    "TRANSIENT_STEPS",
    "MUTEX_STEPS",
    "get_step_status",
    "set_step_status",
    "load_workflows",
    "save_workflows",
    "normalize_path",
]


class StepStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    ERROR = "ERROR"


STEP_ORDER = ["frame_extractor", "depth_map_generator", "sbs_generator",
              "chunk_generator", "video_concatenator"]
PERSISTENT_STEPS = STEP_ORDER[:3]
TRANSIENT_STEPS = STEP_ORDER[3:]
# Steps that cannot run concurrently with each other (disk-heavy / final mux)
MUTEX_STEPS = {"frame_extractor", "chunk_generator", "video_concatenator"}


def normalize_path(path: Path | str) -> str:
    return str(Path(path).resolve()).replace("\\", "/")


def get_step_status(step_value) -> str:
    """Status from a YAML step value: None -> PENDING, str -> itself,
    dict -> its 'status' field."""
    if step_value is None:
        return StepStatus.PENDING
    if isinstance(step_value, str):
        return step_value
    return step_value.get("status", StepStatus.PENDING)


def set_step_status(workflow: dict, step: str, status: str) -> None:
    workflow[step] = status


def _fresh_workflow() -> dict:
    return {step: StepStatus.PENDING for step in PERSISTENT_STEPS}


def _migrate(workflow) -> dict:
    if workflow is None:
        return _fresh_workflow()
    if workflow == StepStatus.DONE:
        return {step: StepStatus.DONE for step in STEP_ORDER}
    if isinstance(workflow, dict) and "steps" in workflow:
        workflow = workflow["steps"]
    for step in STEP_ORDER:
        workflow.setdefault(step, StepStatus.PENDING)
        # FAILED -> PENDING for retry after restart; RUNNING kept so the
        # orchestrator restarts those with priority.
        if get_step_status(workflow[step]) == StepStatus.FAILED:
            workflow[step] = StepStatus.PENDING
    for legacy in ("retry_count", "last_updated"):
        workflow.pop(legacy, None)
    return workflow


def load_workflows(yaml_path: Path) -> dict[str, dict]:
    """{normalized_path: workflow_state} from workflows.yaml, migrated."""
    yaml_path = Path(yaml_path)
    if not yaml_path.exists():
        return {}
    data = yaml.safe_load(yaml_path.read_text(encoding="utf-8"))
    if data is None:
        return {}
    if not isinstance(data, dict):
        raise ValueError(
            f"Invalid workflows file: expected mapping, got {type(data).__name__}")
    return {normalize_path(p): _migrate(wf) for p, wf in data.items()}


def _merge(current: dict[str, dict], from_file: dict[str, dict]) -> dict[str, dict]:
    """File order preserved; orchestrator wins for known steps; non-step
    fields from the file survive; transient steps never persist."""
    merged: dict[str, dict] = {}
    for path, file_wf in from_file.items():
        current_wf = current.get(path)
        if current_wf is None:
            merged[path] = _migrate(file_wf)
            continue
        if file_wf == StepStatus.DONE:
            file_wf = {step: StepStatus.DONE for step in STEP_ORDER}
        out = {k: v for k, v in file_wf.items() if k not in STEP_ORDER}
        for step in STEP_ORDER:
            if step in TRANSIENT_STEPS:
                out[step] = StepStatus.PENDING
            elif step in current_wf:
                out[step] = current_wf[step]
            elif step in file_wf:
                out[step] = file_wf[step]
            else:
                out[step] = StepStatus.PENDING
        merged[path] = out
    return merged


def _is_complete(path: str, workflow: dict) -> bool:
    """Complete = persistent steps DONE and the final output exists (or the
    workflow directory/config has been cleaned away).

    Only an affirmatively *missing* workflow (directory or config.json gone)
    counts as cleaned-up-and-done; any other error (EACCES, disk hiccup,
    corrupt JSON) preserves the current state so a transient failure during
    save can never permanently collapse an unfinished workflow to DONE
    (reference gates the collapse on affirmative completion,
    reference helper/workflow_state.py:371-398)."""
    for step in PERSISTENT_STEPS:
        if get_step_status(workflow.get(step)) != StepStatus.DONE:
            return False
    p = Path(path)
    config_file = p / "config.json"
    try:
        if not config_file.exists():
            return True  # cleaned away: treat as finished
    except OSError:
        return False  # can't even stat it: preserve state
    try:
        from vsc_tpu_torch.config import get_path, load_config
        config = load_config(p)
        return get_path(p, config, "output_video").exists()
    except Exception:
        return False  # unreadable/invalid config: NOT proven complete


def save_workflows(yaml_path: Path, workflows: dict[str, dict]) -> dict[str, dict]:
    """Merge-with-file + atomic write; returns the merged dict."""
    yaml_path = Path(yaml_path)
    yaml_path.parent.mkdir(parents=True, exist_ok=True)

    from_file: dict[str, dict] = {}
    if yaml_path.exists():
        try:
            data = yaml.safe_load(yaml_path.read_text(encoding="utf-8"))
            if isinstance(data, dict):
                from_file = {normalize_path(p): (wf if wf else {})
                             for p, wf in data.items()}
        except (yaml.YAMLError, OSError):
            pass

    merged = _merge(workflows, from_file)
    # also carry over orchestrator-only workflows missing from the file
    for path, wf in workflows.items():
        merged.setdefault(path, wf)

    out: dict[str, str | dict] = {}
    for path, wf in merged.items():
        if _is_complete(path, wf):
            out[path] = StepStatus.DONE
        else:
            out[path] = {s: wf[s] for s in PERSISTENT_STEPS if s in wf}

    fd, tmp = tempfile.mkstemp(dir=yaml_path.parent, suffix=".yaml")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            yaml.safe_dump(out, f, default_flow_style=False,
                           allow_unicode=True, sort_keys=False)
        os.replace(tmp, yaml_path)
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return merged
