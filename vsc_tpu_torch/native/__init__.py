"""
Native media engine loader
==========================

Locates (and builds on first use) the ``vscmedia`` binary — the framework's
native replacement for the reference's external ffmpeg/ffprobe subprocess
layer (reference helper/ffmpeg_utils.py, frame_extractor.py:88-111,
chunk_generator.py:241-267, video_concatenator.py:198-254).

The port's own copy of ``vsc_tpu/native``: the binary is built from
``vscmedia.cpp`` here into ``vsc_tpu_torch/native/vscmedia``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["vscmedia_path", "NativeBuildError"]

_NATIVE_DIR = Path(__file__).resolve().parent
_BINARY = _NATIVE_DIR / "vscmedia"
_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    """Raised when the vscmedia binary cannot be built."""


def vscmedia_path(build: bool = True) -> Path | None:
    """Absolute path to the vscmedia binary, building it if necessary.

    Returns None (rather than raising) when the toolchain or libav headers are
    unavailable and ``build`` fails — callers fall back to the cv2 backend.
    """
    if _BINARY.exists():
        return _BINARY
    if not build:
        return None
    with _LOCK:
        if _BINARY.exists():
            return _BINARY
        make = shutil.which("make")
        if make is None:
            return None
        # built under a name of this process's own and renamed into place,
        # so a process that finds the binary never finds it half written
        # (test workers may build it at the same time)
        tmp = _NATIVE_DIR / f"{_BINARY.name}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                [make, "-C", str(_NATIVE_DIR), f"BIN={tmp.name}"],
                check=True, capture_output=True, text=True, timeout=300,
            )
            os.replace(tmp, _BINARY)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
                OSError):
            tmp.unlink(missing_ok=True)
            return None
    return _BINARY if _BINARY.exists() else None
