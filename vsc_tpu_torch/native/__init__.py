"""
Native media engine loader
==========================

Locates (and builds on first use) the ``vscmedia`` binary — the framework's
native replacement for the reference's external ffmpeg/ffprobe subprocess
layer (reference helper/ffmpeg_utils.py, frame_extractor.py:88-111,
chunk_generator.py:241-267, video_concatenator.py:198-254).

The port's own copy of ``vsc_tpu/native``: the binary is built from
``vscmedia.cpp`` here into ``vsc_tpu_torch/native/vscmedia``. Only a binary
that starts counts: a copy built on another machine whose libav libraries
are absent here fails in the dynamic loader, so it is rebuilt once, and
when that fails too the callers take their cv2 paths.
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
# binary path -> the verdict of this process (the path, or None)
_VERDICT: dict[Path, Path | None] = {}


class NativeBuildError(RuntimeError):
    """Raised when the vscmedia binary cannot be built."""


def _starts(binary: Path) -> bool:
    """With no arguments vscmedia prints its usage and exits 1; a binary
    whose shared libraries are missing exits 127 from the dynamic loader,
    and one that is no executable at all raises OSError."""
    try:
        return subprocess.run([str(binary)], capture_output=True,
                              timeout=60).returncode != 127
    except (OSError, subprocess.TimeoutExpired):
        return False


def _build() -> bool:
    make = shutil.which("make")
    if make is None:
        return False
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
        return False
    return True


def vscmedia_path(build: bool = True) -> Path | None:
    """Absolute path to a vscmedia binary that starts, building it if
    necessary; decided once per process.

    Returns None (rather than raising) when the toolchain or libav is
    unavailable: an existing binary that does not start is rebuilt once,
    and when the rebuild fails or its binary does not start either, the
    callers fall back to the cv2 backend. With ``build`` False nothing is
    built and a missing or non-starting binary gives None undecided.
    """
    binary = _BINARY
    if binary in _VERDICT:
        return _VERDICT[binary]
    with _LOCK:
        if binary in _VERDICT:
            return _VERDICT[binary]
        if binary.exists() and _starts(binary):
            _VERDICT[binary] = binary
        elif not build:
            return None
        else:
            _VERDICT[binary] = (binary if _build() and _starts(binary)
                                else None)
        return _VERDICT[binary]
