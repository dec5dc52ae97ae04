"""
Step 1 — frame extraction
=========================

Port of ``vsc_tpu/pipeline/frame_extractor.py``: decodes the input video
into frames/frame_%06d.png via the port's copy of the native vscmedia
engine (``io/media.extract_frames``, replacing the reference's ffmpeg
subprocess, reference frame_extractor.py:88-111). Same CLI, same overwrite
prompt semantics (auto-overwrite when stdin is not a tty), same progress
line format for the orchestrator::

    python -m vsc_tpu_torch.pipeline.frame_extractor <workflow>
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from tqdm import tqdm

from vsc_tpu_torch.config import ConfigError, get_path, load_config
from vsc_tpu_torch.io.media import MediaError, extract_frames
from vsc_tpu_torch.io.probe import estimate_frame_count


def run(workflow_path: Path, config: dict) -> bool:
    input_video = get_path(workflow_path, config, "input_video")
    frames_dir = get_path(workflow_path, config, "frames")

    if not input_video.is_file():
        print(f"ERROR: Input video not found: {input_video}")
        return False

    existing = list(frames_dir.glob("frame_*.png"))
    if existing:
        print(f"INFO: {len(existing)} frames already exist in {frames_dir}")
        if not sys.stdin.isatty():
            print("Non-interactive mode: Overwriting existing frames.")
        else:
            try:
                answer = input("Continue and overwrite? [y/N]: ").strip().lower()
            except EOFError:
                print("Non-interactive mode: Overwriting existing frames.")
                answer = "y"
            if answer != "y":
                print("Aborted.")
                return False

    frame_count = estimate_frame_count(input_video) or 0
    print(f"Analyzing video: {input_video.name}")
    print(f"Estimated frames: {frame_count}" if frame_count
          else "Could not determine frame count.")
    print(f"Extracting frames to: {frames_dir}")

    pbar = tqdm(total=frame_count or None, unit="frame", mininterval=0.5)
    last = [0]

    def on_progress(n: int):
        if pbar.total and n > pbar.total:   # extend when estimate was short
            pbar.total = n
            pbar.refresh()
        pbar.update(n - last[0])
        last[0] = n

    try:
        n = extract_frames(input_video, frames_dir, progress_cb=on_progress)
    except MediaError as e:
        pbar.close()
        print(f"ERROR: {e}")
        return False
    pbar.close()
    print(f"Extracted {n} frames successfully.")
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Extract frames from the workflow's input video")
    parser.add_argument("workflow_path", type=Path,
                        help="Workflow directory containing config.json")
    args = parser.parse_args(argv)

    if not args.workflow_path.is_dir():
        print(f"ERROR: Workflow directory does not exist: {args.workflow_path}")
        return 1
    try:
        config = load_config(args.workflow_path)
    except ConfigError as e:
        print(f"ERROR: {e}")
        return 1
    if not run(args.workflow_path, config):
        return 1
    print("Done!")
    return 0


if __name__ == "__main__":
    from vsc_tpu_torch.utils.console import (ensure_utf8_console,
                                             set_terminal_title)
    ensure_utf8_console()
    set_terminal_title("frame_extractor " + " ".join(sys.argv[1:]))
    sys.exit(main())
