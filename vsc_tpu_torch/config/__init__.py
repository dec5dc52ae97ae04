"""Configuration subsystem: schema, validation, persistence, path resolution.

The port's own copy of ``vsc_tpu/config`` (framework-free), so that the
port imports nothing of ``vsc_tpu``; kept byte-compatible on disk."""

from vsc_tpu_torch.config.manager import (
    CONFIG_SCHEMA,
    ConfigError,
    create_default_config,
    find_valid_frames,
    get_frame_paths,
    get_path,
    load_config,
    merge_cli_args,
    save_config,
    update_stereo_params,
    validate_config,
)
from vsc_tpu_torch.config.stereo_params import StereoParams

__all__ = [
    "CONFIG_SCHEMA",
    "ConfigError",
    "StereoParams",
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
