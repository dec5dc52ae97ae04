"""
Video metadata probing
======================

Equivalent of the reference's ffprobe helpers
(reference helper/ffmpeg_utils.py:14-134): framerate as a rational
string, duration in seconds, and the instant duration*fps frame-count
estimate. Backed by the native ``vscmedia probe`` tool, with a cv2 fallback
when the native binary cannot be built.
"""

from __future__ import annotations

import json
import subprocess
from fractions import Fraction
from pathlib import Path

from vsc_tpu_torch.native import vscmedia_path

__all__ = [
    "estimate_frame_count",
    "get_video_duration",
    "get_video_framerate",
    "parse_framerate",
    "probe_video",
]


def parse_framerate(framerate_str: str) -> float | None:
    """'24000/1001' | '29.97' -> float fps, None on parse failure
    (reference helper/ffmpeg_utils.py:22-42)."""
    try:
        if "/" in framerate_str:
            num, den = framerate_str.split("/")
            return float(num) / float(den)
        return float(framerate_str)
    except (ValueError, ZeroDivisionError):
        return None


def _fps_to_rational_str(fps: float) -> str:
    """Best-effort rational string for a float fps (cv2 fallback path).
    NTSC-family rates snap to their exact /1001 rationals."""
    if fps <= 0:
        return "0/1"
    for base in (24, 30, 60, 120):
        if abs(fps - base * 1000 / 1001) < 0.01:
            return f"{base * 1000}/1001"
    frac = Fraction(fps).limit_denominator(1001)
    return f"{frac.numerator}/{frac.denominator}"


def probe_video(video_path: Path | str) -> dict | None:
    """Full metadata dict: duration, r_frame_rate, avg_frame_rate, width,
    height, nb_frames, has_audio, vcodec, pix_fmt. None if unreadable."""
    video_path = str(video_path)
    binary = vscmedia_path()
    if binary is not None:
        try:
            out = subprocess.run(
                [str(binary), "probe", video_path],
                capture_output=True, text=True, timeout=120,
            )
            if out.returncode == 0 and out.stdout.strip():
                return json.loads(out.stdout.strip())
        except (subprocess.TimeoutExpired, json.JSONDecodeError, OSError):
            pass
    return _probe_cv2(video_path)


def _probe_cv2(video_path: str) -> dict | None:
    try:
        import cv2
        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():
            return None
        fps = cap.get(cv2.CAP_PROP_FPS)
        nb = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        cap.release()
        rate = _fps_to_rational_str(fps)
        duration = nb / fps if fps > 0 else 0.0
        return {
            "duration": duration,
            "r_frame_rate": rate,
            "avg_frame_rate": rate,
            "width": w,
            "height": h,
            "nb_frames": nb,
            "has_audio": False,  # cv2 cannot see audio streams
            "vcodec": "unknown",
            "pix_fmt": "unknown",
        }
    except Exception:
        return None


def get_video_framerate(video_path: Path | str) -> str | None:
    """Rational framerate string, e.g. '24000/1001'
    (reference helper/ffmpeg_utils.py:45-72)."""
    info = probe_video(video_path)
    return info["r_frame_rate"] if info else None


def get_video_duration(video_path: Path | str) -> float | None:
    """Duration in seconds (reference helper/ffmpeg_utils.py:75-101)."""
    info = probe_video(video_path)
    return float(info["duration"]) if info else None


def estimate_frame_count(video_path: Path | str) -> int | None:
    """int(duration * fps) — instant, ±1 frame for CFR
    (reference helper/ffmpeg_utils.py:104-134)."""
    info = probe_video(video_path)
    if not info:
        return None
    fps = parse_framerate(info["r_frame_rate"])
    if fps is None or info["duration"] is None:
        return None
    return int(info["duration"] * fps)
