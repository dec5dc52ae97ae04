"""
Workflow configuration
======================

Schema, validation, persistence, and path resolution for the per-workflow
``config.json``. The on-disk format (keys, nesting, defaults, tab-indented
JSON) is byte-compatible with the reference implementation
(reference helper/config_manager.py:31-75, 217-317) so existing
workflows can be pointed at this framework unchanged.

One deliberate improvement over the reference: unknown keys are *rejected*.
The reference README documents strict validation including unknown-key
rejection, but its validator only checks missing keys and wrong types
(reference helper/config_manager.py:124-164); we implement the
documented behavior.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any

from vsc_tpu_torch.config.stereo_params import StereoParams

__all__ = [
    "CONFIG_SCHEMA",
    "ConfigError",
    "create_default_config",
    "find_valid_frames",
    "get_frame_paths",
    "get_path",
    "load_config",
    "merge_cli_args",
    "save_config",
    "update_stereo_params",
    "validate_config",
]

_TYPE_NAMES = {
    str: "string",
    int: "integer",
    float: "float",
    bool: "boolean",
    dict: "object",
    list: "array",
}

# Leaf entries: (type, example). Nested sections are plain dicts.
# Key set mirrors reference helper/config_manager.py:31-75.
CONFIG_SCHEMA: dict[str, Any] = {
    "input_video": (str, "/videos/input.mkv"),
    "output_video": (str, "/videos/input_stereo.mkv"),
    "directories": {
        "frames": (str, "frames"),
        "depth_maps": (str, "depth_maps"),
        "sbs": (str, "sbs"),
        "chunks": (str, "chunks"),
    },
    "stereo": {
        "max_disparity": (float, 50.0),
        "convergence": (float, -10.0),
        "super_sampling": (float, 3.0),
        "edge_softness": (float, 20.0),
        "artifact_smoothing": (float, 1.0),
        "depth_gamma": (float, 0.2),
        "sharpen": (float, 14.0),
    },
    "depth": {
        "save_16bit": (bool, False),
    },
    "encoding": {
        "crf": (int, 19),
        "preset": (str, "slow"),
    },
    "free_space": {
        "sbs_generator": (str, "frame"),
        "chunk_generator": (str, "sbs"),
    },
}


class ConfigError(Exception):
    """Raised when config loading or validation fails."""


def _walk_schema(schema: dict, data: Any, path: str, errors: dict[str, list[str]]) -> None:
    if not isinstance(data, dict):
        errors.setdefault("wrong_type", []).append(
            f"  '{path or '<root>'}' (expected: object, got: "
            f"{_TYPE_NAMES.get(type(data), type(data).__name__)})"
        )
        return

    for key, spec in schema.items():
        full = f"{path}.{key}" if path else key
        if key not in data:
            if isinstance(spec, dict):
                errors.setdefault("missing", []).append(f"  '{full}' (expected: object)")
            else:
                t, example = spec
                errors.setdefault("missing", []).append(
                    f"  '{full}' (expected: {_TYPE_NAMES[t]}, example: {example})"
                )
            continue

        value = data[key]
        if isinstance(spec, dict):
            _walk_schema(spec, value, full, errors)
        else:
            t, example = spec
            # Accept int where float is expected (but never bool — bool is an
            # int subclass in Python and must not satisfy numeric fields).
            ok = isinstance(value, t) and not (t is not bool and isinstance(value, bool))
            if t is float and isinstance(value, int) and not isinstance(value, bool):
                ok = True
            if not ok:
                errors.setdefault("wrong_type", []).append(
                    f"  '{full}' (expected: {_TYPE_NAMES[t]}, got: "
                    f"{_TYPE_NAMES.get(type(value), type(value).__name__)}, example: {example})"
                )

    # Strict: reject keys not in the schema (documented reference behavior).
    for key in data:
        if key not in schema:
            full = f"{path}.{key}" if path else key
            errors.setdefault("unknown", []).append(f"  '{full}'")


def validate_config(config: dict) -> None:
    """Validate a config dict against CONFIG_SCHEMA; raise ConfigError listing
    every problem (missing keys, wrong types, unknown keys) at once, in the
    reference's aggregate-report style
    (reference helper/config_manager.py:167-214)."""
    errors: dict[str, list[str]] = {}
    _walk_schema(CONFIG_SCHEMA, config, "", errors)
    if errors:
        parts = ["Configuration validation failed:"]
        for title, key in (("Missing keys:", "missing"),
                           ("Wrong type:", "wrong_type"),
                           ("Unknown keys:", "unknown")):
            if key in errors:
                parts.append(title)
                parts.extend(errors[key])
        raise ConfigError("\n".join(parts))


def create_default_config(input_video: Path) -> dict:
    """Default config for a new workflow: output beside the input as
    ``{stem}_stereo.mkv``, forward-slash paths, StereoParams defaults
    (reference helper/config_manager.py:217-264)."""
    input_video = Path(input_video)
    defaults = StereoParams()
    output_video = input_video.parent / f"{input_video.stem}_stereo.mkv"
    return {
        "input_video": str(input_video.resolve()).replace("\\", "/"),
        "output_video": str(output_video).replace("\\", "/"),
        "directories": {
            "frames": "frames",
            "depth_maps": "depth_maps",
            "sbs": "sbs",
            "chunks": "chunks",
        },
        "stereo": defaults.to_dict(),
        "depth": {"save_16bit": False},
        "encoding": {"crf": 19, "preset": "slow"},
        "free_space": {"sbs_generator": "frame", "chunk_generator": "sbs"},
    }


def load_config(workflow_path: Path) -> dict:
    """Load and validate ``<workflow>/config.json``."""
    config_file = Path(workflow_path) / "config.json"
    if not config_file.exists():
        raise ConfigError(f"Config file not found: {config_file}")
    try:
        config = json.loads(config_file.read_text(encoding="utf-8"))
    except json.JSONDecodeError as e:
        raise ConfigError(f"Invalid JSON in config file: {e}") from e
    validate_config(config)
    return config


def save_config(workflow_path: Path, config: dict) -> None:
    """Write config as tab-indented JSON with trailing newline (the
    reference's on-disk style, reference helper/config_manager.py:302-317).

    Atomic (tempfile + replace), unlike the reference: the orchestrator and
    the tester may read config.json while it is being rewritten, and a
    torn read is treated as workflow-complete downstream."""
    import os
    import tempfile
    config_file = Path(workflow_path) / "config.json"
    fd, tmp = tempfile.mkstemp(dir=str(config_file.parent), suffix=".json")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(config, f, indent="\t")
            f.write("\n")
        os.replace(tmp, config_file)
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def update_stereo_params(workflow_path: Path, stereo_params: dict) -> None:
    """Load -> patch the ``stereo`` section -> revalidate -> save."""
    config = load_config(workflow_path)
    config["stereo"].update(stereo_params)
    validate_config(config)
    save_config(workflow_path, config)


def get_path(workflow_path: Path, config: dict, key: str) -> Path:
    """Resolve a config path: input absolute, output absolute-or-relative to
    the workflow, directories workflow-relative
    (reference helper/config_manager.py:342-379)."""
    workflow_path = Path(workflow_path)
    if key == "input_video":
        return Path(config["input_video"])
    if key == "output_video":
        out = Path(config["output_video"])
        return out if out.is_absolute() else workflow_path / out
    if key not in config["directories"]:
        raise KeyError(f"Unknown directory key: {key}")
    return workflow_path / config["directories"][key]


# CLI flag -> (section, key), mirroring
# reference helper/config_manager.py:402-413.
_CLI_KEY_MAP = {
    "save_16bit": ("depth", "save_16bit"),
    "crf": ("encoding", "crf"),
    "preset": ("encoding", "preset"),
    "max_disparity": ("stereo", "max_disparity"),
    "convergence": ("stereo", "convergence"),
    "super_sampling": ("stereo", "super_sampling"),
    "edge_softness": ("stereo", "edge_softness"),
    "artifact_smoothing": ("stereo", "artifact_smoothing"),
    "depth_gamma": ("stereo", "depth_gamma"),
    "sharpen": ("stereo", "sharpen"),
}


def merge_cli_args(config: dict, cli_args: dict) -> dict:
    """Return a new config with non-None CLI values overriding config values."""
    result = copy.deepcopy(config)
    for key, value in cli_args.items():
        if value is None:
            continue
        if key in _CLI_KEY_MAP:
            section, param = _CLI_KEY_MAP[key]
            result[section][param] = value
    return result


from vsc_tpu_torch.utils.frame_utils import DEPTH_RE as _DEPTH_RE, FRAME_RE as _FRAME_RE


def find_valid_frames(workflow_path: Path, config: dict) -> list[int]:
    """Sorted frame numbers for which both frame and depth map exist
    (reference helper/config_manager.py:426-473)."""
    workflow_path = Path(workflow_path)
    frames_dir = workflow_path / config["directories"]["frames"]
    depth_dir = workflow_path / config["directories"]["depth_maps"]
    if not frames_dir.exists() or not depth_dir.exists():
        return []

    frame_numbers = {
        int(m.group(1))
        for f in frames_dir.iterdir()
        if f.is_file() and (m := _FRAME_RE.match(f.name))
    }
    depth_numbers = {
        int(m.group(1))
        for f in depth_dir.iterdir()
        if f.is_file() and (m := _DEPTH_RE.match(f.name))
    }
    return sorted(frame_numbers & depth_numbers)


def get_frame_paths(workflow_path: Path, config: dict, frame_num: int) -> tuple[Path, Path] | None:
    """(frame_path, depth_path) for a frame number; depth prefers .tif over
    .png (reference helper/config_manager.py:476-509). None if either
    file is missing."""
    workflow_path = Path(workflow_path)
    frame_path = workflow_path / config["directories"]["frames"] / f"frame_{frame_num:06d}.png"
    if not frame_path.exists():
        return None
    depth_dir = workflow_path / config["directories"]["depth_maps"]
    for ext in (".tif", ".png"):
        depth_path = depth_dir / f"depth_frame_{frame_num:06d}{ext}"
        if depth_path.exists():
            return frame_path, depth_path
    return None
