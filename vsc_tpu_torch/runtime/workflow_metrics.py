"""
Workflow metrics
================

Filesystem-derived progress for the orchestrator, mirroring
helper/workflow_metrics.py of the reference: all progress is read off the
output directories (the filesystem IS the checkpoint), cached with explicit
invalidation per scheduler tick, with the same chunking policy constants
(CHUNK_SIZE=1500, MIN_DEPTH_FOR_SBS=1000, 10 GB disk floor —
workflow_metrics.py:36-38) and the same next-chunk-end policy incl.
extend-final-chunk and the >=2-frame ffmpeg minimum
(workflow_metrics.py:276-335).

The port's own copy of ``vsc_tpu/runtime/workflow_metrics.py`` (no torch).
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

from vsc_tpu_torch.config import ConfigError, get_path, load_config
from vsc_tpu_torch.utils.frame_utils import extract_frame_number

__all__ = [
    "CHUNK_SIZE",
    "MIN_DEPTH_FOR_SBS",
    "DISK_SPACE_THRESHOLD_GB",
    "invalidate_cache",
    "get_frame_count",
    "get_depth_count",
    "get_max_depth_number",
    "get_max_sbs_number",
    "get_last_chunk_end_frame",
    "get_total_frame_count",
    "get_next_chunk_end_frame",
    "is_all_chunks_complete",
    "get_video_progress",
]

CHUNK_SIZE = 1500
MIN_DEPTH_FOR_SBS = 1000
DISK_SPACE_THRESHOLD_GB = 10

from vsc_tpu_torch.utils.frame_utils import CHUNK_RE as _CHUNK_RE


def invalidate_cache() -> None:
    _count_files.cache_clear()
    _max_frame.cache_clear()
    _chunk_info.cache_clear()


@lru_cache(maxsize=256)
def _count_files(directory: str, pattern: str) -> int:
    d = Path(directory)
    return sum(1 for _ in d.glob(pattern)) if d.exists() else 0


@lru_cache(maxsize=256)
def _max_frame(directory: str, pattern: str) -> int:
    d = Path(directory)
    if not d.exists():
        return 0
    best = 0
    for f in d.glob(pattern):
        n = extract_frame_number(str(f))
        if n > best:
            best = n
    return best


@lru_cache(maxsize=128)
def _chunk_info(chunks_dir: str) -> tuple[int, int]:
    """(last_end_frame, chunk_count); also GCs stale .mkv.tmp leftovers
    (workflow_metrics.py:102-117)."""
    d = Path(chunks_dir)
    if not d.exists():
        return 0, 0
    for tmp in d.glob("sbs_*.mkv.tmp"):
        try:
            tmp.unlink()
        except OSError:
            pass
    last_end = count = 0
    for f in d.iterdir():
        m = _CHUNK_RE.match(f.name)
        if f.is_file() and m:
            last_end = max(last_end, int(m.group(2)))
            count += 1
    return last_end, count


def _dir(workflow_path: Path, key: str) -> str | None:
    try:
        config = load_config(workflow_path)
        return str(get_path(workflow_path, config, key))
    except (ConfigError, OSError, KeyError, ValueError):
        return None


def get_frame_count(workflow_path: Path) -> int:
    d = _dir(workflow_path, "frames")
    return _count_files(d, "frame_*.png") if d else 0


def get_depth_count(workflow_path: Path) -> int:
    d = _dir(workflow_path, "depth_maps")
    if not d:
        return 0
    return (_count_files(d, "depth_frame_*.tif")
            + _count_files(d, "depth_frame_*.png"))


def get_max_depth_number(workflow_path: Path) -> int:
    d = _dir(workflow_path, "depth_maps")
    if not d:
        return 0
    return max(_max_frame(d, "depth_frame_*.tif"),
               _max_frame(d, "depth_frame_*.png"))


def get_max_sbs_number(workflow_path: Path) -> int:
    d = _dir(workflow_path, "sbs")
    return _max_frame(d, "sbs_*.png") if d else 0


def get_last_chunk_end_frame(workflow_path: Path) -> int:
    d = _dir(workflow_path, "chunks")
    return _chunk_info(d)[0] if d else 0


def get_total_frame_count(workflow_path: Path) -> int:
    try:
        from vsc_tpu_torch.io.probe import estimate_frame_count
        config = load_config(workflow_path)
        video = get_path(workflow_path, config, "input_video")
        return estimate_frame_count(video) or 0
    except (ConfigError, OSError, KeyError, ValueError):
        return 0


def get_next_chunk_end_frame(workflow_path: Path, last_chunk_end: int,
                             sbs_complete: bool = False) -> int | None:
    """Chunking policy (workflow_metrics.py:276-335):
      - intermediate: cut at last_end+CHUNK_SIZE only while more than a full
        chunk of frames would remain; otherwise extend to absorb the tail;
      - final (sbs_complete): always flush whatever remains, provided the
        encoder gets its >= 2 frames."""
    max_sbs = get_max_sbs_number(workflow_path)
    target = (last_chunk_end or 0) + CHUNK_SIZE

    if max_sbs >= target:
        remaining = max_sbs - target
        if sbs_complete:
            return max_sbs if remaining <= CHUNK_SIZE else target
        if remaining > CHUNK_SIZE:
            return target
        if remaining > 0:
            return max_sbs

    if sbs_complete:
        start = last_chunk_end if last_chunk_end > 0 else 0
        if max_sbs - start >= 2:
            return max_sbs
    return None


def is_all_chunks_complete(workflow_path: Path) -> bool:
    """Chunks cover everything? Compares against max SBS, falling back to
    max depth / total frames when SBS files were deleted to free space
    (workflow_metrics.py:338-374)."""
    last_chunk = get_last_chunk_end_frame(workflow_path)
    if last_chunk == 0:
        return False
    max_sbs = get_max_sbs_number(workflow_path)
    if max_sbs > 0:
        return last_chunk >= max_sbs
    max_depth = get_max_depth_number(workflow_path)
    if max_depth > 0:
        return last_chunk >= max_depth
    total = get_total_frame_count(workflow_path)
    return total > 0 and last_chunk >= total


def get_video_progress(workflow_path: Path) -> str:
    """'DONE' | 'X/Y' | '-' display string (workflow_metrics.py:377-419)."""
    try:
        config = load_config(workflow_path)
        if get_path(workflow_path, config, "output_video").exists():
            return "DONE"
        last_chunk = get_last_chunk_end_frame(workflow_path)
        if last_chunk == 0:
            return "-"
        total = get_total_frame_count(workflow_path)
        if total > 0:
            return f"{min(last_chunk, total)}/{total}"
        return str(last_chunk)
    except (ConfigError, OSError, KeyError, ValueError):
        return "-"
