"""
Media engine
============

High-level decode/encode/concat operations for the pipeline steps, backed by
the native ``vscmedia`` tool (libavformat/libavcodec/libx265). This replaces
the reference's ffmpeg subprocess invocations:

  - extract_frames   <- ffmpeg -i video -an frame_%06d.png
                        (reference frame_extractor.py:88-97)
  - encode_chunk     <- ffmpeg -framerate R -start_number N -i sbs_%06d.png
                        -frames:v M -c:v libx265 -preset P -crf C
                        -pix_fmt yuv420p10le -f matroska out.mkv.tmp
                        (reference chunk_generator.py:241-254)
  - concat_chunks    <- ffmpeg -f concat -safe 0 -i list -map 0:v -map 1:a?
                        -c copy (reference video_concatenator.py:198-231)
  - RawFrameSink     <- new TPU-native streaming path: raw RGB frames piped
                        straight from device memory to the encoder, no PNG
                        round-trip (SURVEY.md section 2, "streaming upgrade")
  - make_test_video  <- ffmpeg testsrc equivalent for tests/benchmarks

A cv2 fallback covers extract when the native tool is unavailable; encode has
no x265 fallback (cv2's bundled ffmpeg lacks the encoder) and uses lossless
FFV1 instead so tests still run everywhere.
"""

from __future__ import annotations

import os
import re
import subprocess
from pathlib import Path
from typing import Callable, Iterable

from vsc_tpu_torch.native import vscmedia_path

__all__ = [
    "MediaError",
    "RawFrameSink",
    "concat_chunks",
    "decode_frames",
    "encode_chunk",
    "extract_frames",
    "make_test_video",
]

_FRAME_LINE = re.compile(r"frame=\s*(\d+)")


class MediaError(RuntimeError):
    """Raised when a media operation fails."""


def _run_with_progress(cmd: list[str], progress_cb: Callable[[int], None] | None,
                       **popen_kwargs) -> tuple[int, str]:
    """Run a subprocess, streaming 'frame=N' progress lines to progress_cb.
    Returns (returncode, tail_of_stderr)."""
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        **popen_kwargs,
    )
    stderr_tail: list[str] = []

    import threading

    def _drain_stderr():
        for line in proc.stderr:
            stderr_tail.append(line)
            if len(stderr_tail) > 50:
                stderr_tail.pop(0)

    t = threading.Thread(target=_drain_stderr, daemon=True)
    t.start()
    for line in proc.stdout:
        m = _FRAME_LINE.search(line)
        if m and progress_cb:
            progress_cb(int(m.group(1)))
    proc.wait()
    t.join(timeout=5)
    return proc.returncode, "".join(stderr_tail)


def extract_frames(video: Path | str, frames_dir: Path | str,
                   pattern: str = "frame_%06d.png",
                   progress_cb: Callable[[int], None] | None = None) -> int:
    """Decode every frame of `video` into `frames_dir` as PNGs numbered from 1
    (ffmpeg frame_%06d.png convention). Returns the frame count written."""
    frames_dir = Path(frames_dir)
    frames_dir.mkdir(parents=True, exist_ok=True)
    binary = vscmedia_path()
    if binary is not None:
        rc, err = _run_with_progress(
            [str(binary), "extract", str(video), str(frames_dir), "--pattern", pattern],
            progress_cb,
        )
        if rc != 0:
            raise MediaError(f"vscmedia extract failed: {err[-1000:]}")
        return len(list(frames_dir.glob("frame_*.png")))
    return _extract_frames_cv2(video, frames_dir, pattern, progress_cb)


def _extract_frames_cv2(video, frames_dir, pattern, progress_cb) -> int:
    import cv2
    cap = cv2.VideoCapture(str(video))
    if not cap.isOpened():
        raise MediaError(f"cannot open video: {video}")
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n += 1
        cv2.imwrite(str(Path(frames_dir) / (pattern % n)), frame)
        if progress_cb and n % 25 == 0:
            progress_cb(n)
    cap.release()
    if progress_cb:
        progress_cb(n)
    return n


def decode_frames(video: Path | str, width: int, height: int,
                  start: int = 0, count: int = -1) -> Iterable[bytes]:
    """Yield raw RGB24 frames (bytes of length width*height*3) from `video` —
    the zero-PNG streaming decode path feeding the host->HBM prefetch queue."""
    binary = vscmedia_path()
    frame_bytes = width * height * 3
    if binary is None:
        import cv2
        import numpy as np
        cap = cv2.VideoCapture(str(video))
        idx = 0
        emitted = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx < start:
                idx += 1
                continue
            idx += 1
            if count >= 0 and emitted >= count:
                break
            yield np.ascontiguousarray(frame[:, :, ::-1]).tobytes()
            emitted += 1
        cap.release()
        return
    cmd = [str(binary), "decode", str(video), "--start", str(start)]
    if count >= 0:
        cmd += ["--count", str(count)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    try:
        while True:
            buf = proc.stdout.read(frame_bytes)
            if len(buf) < frame_bytes:
                break
            yield buf
    finally:
        proc.stdout.close()
        proc.wait()


def encode_chunk(sbs_dir: Path | str, start_number: int, num_frames: int,
                 framerate: str, crf: int, preset: str, output: Path | str,
                 pattern: str = "sbs_%06d.png",
                 progress_cb: Callable[[int], None] | None = None) -> None:
    """Encode a PNG sequence into an x265 yuv420p10le matroska chunk, writing
    to `<output>.tmp` then renaming (atomic-write pattern,
    reference chunk_generator.py:238-295)."""
    output = Path(output)
    temp_path = output.with_suffix(".mkv.tmp")
    binary = vscmedia_path()
    if binary is None:
        _encode_chunk_cv2(sbs_dir, start_number, num_frames, framerate,
                          temp_path, pattern, progress_cb)
    else:
        rc, err = _run_with_progress(
            [str(binary), "encode",
             "--input-pattern", str(Path(sbs_dir) / pattern),
             "--start-number", str(start_number),
             "--frames", str(num_frames),
             "--framerate", framerate,
             "--crf", str(crf),
             "--preset", preset,
             "--output", str(temp_path)],
            progress_cb,
        )
        if rc != 0:
            temp_path.unlink(missing_ok=True)
            raise MediaError(f"vscmedia encode failed: {err[-1000:]}")
    if not temp_path.exists() or temp_path.stat().st_size == 0:
        temp_path.unlink(missing_ok=True)
        raise MediaError("chunk file was not created or is empty")
    temp_path.rename(output)


def _encode_chunk_cv2(sbs_dir, start_number, num_frames, framerate,
                      temp_path, pattern, progress_cb) -> None:
    """Fallback encoder: lossless FFV1 (cv2's ffmpeg lacks libx265). cv2
    takes the container from the file name and refuses ``.mkv.tmp``, so it
    writes ``<temp_path>.mkv`` and renames that to ``temp_path``."""
    import cv2
    from vsc_tpu_torch.io.probe import parse_framerate
    fps = parse_framerate(framerate) or 25.0
    mkv = Path(temp_path).with_name(Path(temp_path).name + ".mkv")
    writer = None
    done = False
    try:
        for i in range(num_frames):
            path = Path(sbs_dir) / (pattern % (start_number + i))
            frame = cv2.imread(str(path), cv2.IMREAD_COLOR)
            if frame is None:
                raise MediaError(f"missing frame during encode: {path}")
            if writer is None:
                writer = cv2.VideoWriter(
                    str(mkv), cv2.VideoWriter_fourcc(*"FFV1"), fps,
                    (frame.shape[1], frame.shape[0]))
                if not writer.isOpened():
                    raise MediaError(
                        "cv2 fallback encoder could not open FFV1 writer")
            writer.write(frame)
            if progress_cb and (i + 1) % 25 == 0:
                progress_cb(i + 1)
        done = True
    finally:
        if writer is not None:
            writer.release()
        if not done:
            mkv.unlink(missing_ok=True)
    if mkv.exists():
        os.replace(mkv, temp_path)
    if progress_cb:
        progress_cb(num_frames)


class RawFrameSink:
    """Streams raw RGB24 frames into the native encoder — the TPU pipeline's
    direct device->encoder path (no PNG intermediates).

    Usage:
        with RawFrameSink(out, w, h, "24000/1001", crf=19, preset="slow") as sink:
            sink.write(frame_u8_hwc_bytes)
    """

    def __init__(self, output: Path | str, width: int, height: int,
                 framerate: str, crf: int = 19, preset: str = "slow"):
        binary = vscmedia_path()
        if binary is None:
            raise MediaError("RawFrameSink requires the native vscmedia tool")
        self.output = Path(output)
        self.temp_path = self.output.with_suffix(self.output.suffix + ".tmp")
        self.proc = subprocess.Popen(
            [str(binary), "encode", "--raw", str(width), str(height),
             "--framerate", framerate, "--crf", str(crf), "--preset", preset,
             "--output", str(self.temp_path)],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )

    def write(self, frame_bytes: bytes) -> None:
        self.proc.stdin.write(frame_bytes)

    def close(self, success: bool = True) -> None:
        if self.proc.stdin and not self.proc.stdin.closed:
            self.proc.stdin.close()
        rc = self.proc.wait()
        if success and rc == 0 and self.temp_path.exists():
            self.temp_path.rename(self.output)
        else:
            self.temp_path.unlink(missing_ok=True)
            if success:
                raise MediaError(f"raw encode failed with rc={rc}")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(success=exc_type is None)


def concat_chunks(chunks: list[Path], output: Path | str,
                  is_overlapping: bool, framerate_str: str,
                  audio_source: Path | None = None,
                  progress_cb: Callable[[int], None] | None = None) -> None:
    """Concatenate chunk files (stream copy) and mux audio from the original
    input, skipping each later chunk's duplicated first frame in overlapping
    mode. Atomic .tmp -> rename
    (reference video_concatenator.py:153-295)."""
    import tempfile
    from vsc_tpu_torch.io.probe import parse_framerate

    output = Path(output)
    temp_output = output.with_suffix(output.suffix + ".tmp")
    binary = vscmedia_path()
    if binary is None:
        raise MediaError("concat requires the native vscmedia tool")

    fps = parse_framerate(framerate_str)
    frame_duration = (1.0 / fps) if (is_overlapping and fps) else 0.0

    with tempfile.TemporaryDirectory() as td:
        list_file = Path(td) / "concat.txt"
        with open(list_file, "w", encoding="utf-8") as f:
            for i, path in enumerate(chunks):
                escaped = str(Path(path).absolute()).replace("'", "'\\''")
                f.write(f"file '{escaped}'\n")
                if is_overlapping and i > 0:
                    f.write(f"inpoint {frame_duration:.6f}\n")
        cmd = [str(binary), "concat", "--list", str(list_file),
               "--output", str(temp_output)]
        if audio_source is not None:
            cmd += ["--audio", str(audio_source)]
        rc, err = _run_with_progress(cmd, progress_cb)
    if rc != 0 or not temp_output.exists() or temp_output.stat().st_size == 0:
        temp_output.unlink(missing_ok=True)
        raise MediaError(f"concat failed: {err[-1000:]}")
    temp_output.rename(output)


def make_test_video(output: Path | str, width: int = 320, height: int = 240,
                    frames: int = 48, framerate: str = "24/1",
                    with_audio: bool = False, codec: str = "libx264") -> None:
    """Generate a synthetic test video (moving gradient + bouncing block),
    replacing `ffmpeg -f lavfi -i testsrc` for tests and benchmarks."""
    binary = vscmedia_path()
    if binary is not None:
        cmd = [str(binary), "makevideo", "--output", str(output),
               "--width", str(width), "--height", str(height),
               "--frames", str(frames), "--framerate", framerate,
               "--codec", codec]
        if with_audio:
            cmd.append("--audio")
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise MediaError(f"makevideo failed: {res.stderr[-500:]}")
        return
    # cv2 fallback: mp4v, no audio
    import cv2
    import numpy as np
    from vsc_tpu_torch.io.probe import parse_framerate
    fps = parse_framerate(framerate) or 24.0
    writer = cv2.VideoWriter(str(output), cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (width, height))
    if not writer.isOpened():
        raise MediaError("cv2 fallback writer could not open")
    xs = np.linspace(0, 255, width, dtype=np.uint8)[None, :]
    ys = np.linspace(0, 255, height, dtype=np.uint8)[:, None]
    for i in range(frames):
        frame = np.zeros((height, width, 3), np.uint8)
        frame[:, :, 0] = (i * 16) & 0xFF
        frame[:, :, 1] = ys
        frame[:, :, 2] = xs
        bx, by = (i * 7) % max(width - 32, 1), (i * 5) % max(height - 32, 1)
        frame[by:by + 32, bx:bx + 32] = 255
        writer.write(frame)
    writer.release()
