"""
Console utilities
=================

UTF-8-safe stdio and terminal titles, equivalent in behavior to
reference helper/utf8_console.py and helper/terminal_title.py
but opt-in (call the functions) rather than import-side-effecting.

The port's own copy of ``vsc_tpu/utils/console.py`` (framework-free).
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

__all__ = ["ensure_utf8_console", "set_terminal_title", "suppress_cv2_logging"]


def ensure_utf8_console() -> None:
    """Wrap stdout/stderr in UTF-8 writers with errors='replace' so progress
    glyphs never crash on legacy encodings
    (reference helper/utf8_console.py:14-37)."""
    for name in ("stdout", "stderr"):
        stream = getattr(sys, name)
        encoding = getattr(stream, "encoding", "") or ""
        if encoding.lower().replace("-", "") == "utf8":
            continue
        buffer = getattr(stream, "buffer", None)
        if buffer is None:
            continue
        setattr(sys, name, io.TextIOWrapper(buffer, encoding="utf-8",
                                            errors="replace", line_buffering=True))


def set_terminal_title(title: str) -> None:
    """Set the terminal title via ANSI OSC-0; suppressed by the
    DISABLE_TERMINAL_TITLE env var the orchestrator sets for its children
    (reference helper/terminal_title.py:16-52,
    reference workflow_orchestrator.py:899-901)."""
    if os.environ.get("DISABLE_TERMINAL_TITLE"):
        return
    try:
        sys.stdout.write(f"\033]0;{title}\007")
        sys.stdout.flush()
    except Exception:
        pass


@contextlib.contextmanager
def suppress_cv2_logging():
    """Temporarily silence OpenCV's logger during imread/imwrite probes
    (reference helper/cv2_utils.py:20-48)."""
    try:
        import cv2
        prev = cv2.getLogLevel() if hasattr(cv2, "getLogLevel") else None
        if hasattr(cv2, "setLogLevel"):
            cv2.setLogLevel(0)
    except Exception:
        prev = None
    try:
        yield
    finally:
        try:
            import cv2
            if prev is not None and hasattr(cv2, "setLogLevel"):
                cv2.setLogLevel(prev)
        except Exception:
            pass
