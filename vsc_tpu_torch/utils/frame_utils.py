"""
Frame numbering
===============

Single source of truth for parsing frame numbers out of pipeline filenames
(``frame_000123.png``, ``depth_frame_000123.tif``, ``sbs_000123.png``).
Semantics match reference helper/frame_utils.py:19-38: the number is
the final ``_<digits>.`` group of the basename, -1 when absent.
"""

from __future__ import annotations

import os
import re

__all__ = ["extract_frame_number", "frame_name", "depth_name", "sbs_name",
           "chunk_name", "FRAME_RE", "DEPTH_RE", "SBS_RE", "CHUNK_RE"]

_NUM_RE = re.compile(r"_(\d+)\.")

# Canonical filename patterns — the single definition of the on-disk naming
# contract shared by discovery, metrics, and resume logic.
FRAME_RE = re.compile(r"^frame_(\d+)\.png$")
DEPTH_RE = re.compile(r"^depth_frame_(\d+)\.(tif|png)$")
SBS_RE = re.compile(r"^sbs_(\d+)\.png$")
CHUNK_RE = re.compile(r"^sbs_(\d+)_(\d+)\.mkv$")


def extract_frame_number(filepath: str | os.PathLike) -> int:
    """Frame number embedded in a pipeline filename, or -1 if none."""
    matches = _NUM_RE.findall(os.path.basename(str(filepath)))
    return int(matches[-1]) if matches else -1


def frame_name(n: int) -> str:
    return f"frame_{n:06d}.png"


def depth_name(n: int, use_16bit: bool = False) -> str:
    return f"depth_frame_{n:06d}{'.tif' if use_16bit else '.png'}"


def sbs_name(n: int) -> str:
    return f"sbs_{n:06d}.png"


def chunk_name(start: int, end: int) -> str:
    return f"sbs_{start:06d}_{end:06d}.mkv"
