"""
Step 4 — chunk encoding
=======================

Encodes SBS PNG runs into x265 yuv420p10le matroska chunks named
``sbs_{start:06d}_{end:06d}.mkv``. Resume semantics mirror the reference
(reference chunk_generator.py): resume starts at the last chunk's end
frame INCLUSIVE, producing a deliberate 1-frame overlap that the
concatenator later collapses; gap validation before encoding; atomic
.tmp -> rename; optional SBS deletion keeping the last frame.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from tqdm import tqdm

from vsc_tpu_torch.config import ConfigError, get_path, load_config
from vsc_tpu_torch.io.media import MediaError, encode_chunk
from vsc_tpu_torch.io.probe import get_video_framerate

from vsc_tpu_torch.utils.frame_utils import CHUNK_RE as _CHUNK_RE, SBS_RE as _SBS_RE


def find_sbs_frames(sbs_dir: Path) -> list[tuple[int, Path]]:
    out = [(int(m.group(1)), f) for f in sbs_dir.iterdir()
           if f.is_file() and (m := _SBS_RE.match(f.name))]
    return sorted(out)


def find_chunks(chunks_dir: Path) -> list[tuple[int, int, Path]]:
    out = [(int(m.group(1)), int(m.group(2)), f) for f in chunks_dir.iterdir()
           if f.is_file() and (m := _CHUNK_RE.match(f.name))]
    return sorted(out)


def select_frames(frames: list[tuple[int, Path]], last_end: int | None,
                  end_frame: int | None) -> list[tuple[int, Path]]:
    """Frames from last_end INCLUSIVE (the 1-frame overlap) up to end_frame."""
    out = frames
    if last_end is not None:
        out = [(n, p) for n, p in out if n >= last_end]
    if end_frame is not None:
        out = [(n, p) for n, p in out if n <= end_frame]
    return out


def validate_contiguous(frames: list[tuple[int, Path]]) -> bool:
    if not frames:
        print("ERROR: No sbs_*.png files found!")
        return False
    nums = [n for n, _ in frames]
    expected = nums[-1] - nums[0] + 1
    if len(nums) != expected:
        present = set(nums)
        missing = [i for i in range(nums[0], nums[-1] + 1) if i not in present]
        print("ERROR: Frame sequence has gaps!")
        print(f"  Expected: {expected} frames ({nums[0]} to {nums[-1]})")
        print(f"  Found: {len(nums)} frames")
        print(f"  Missing frames: {missing[:10]}"
              + (f" ... and {len(missing) - 10} more" if len(missing) > 10 else ""))
        return False
    print(f"Frame sequence validated: {len(nums)} frames ({nums[0]} to {nums[-1]})")
    return True


def run(workflow_path: Path, config: dict, end_frame: int | None = None) -> bool:
    sbs_dir = get_path(workflow_path, config, "sbs")
    chunks_dir = get_path(workflow_path, config, "chunks")
    input_video = get_path(workflow_path, config, "input_video")

    if not sbs_dir.exists():
        print(f"ERROR: SBS directory not found: {sbs_dir}")
        return False
    chunks_dir.mkdir(parents=True, exist_ok=True)

    crf = config["encoding"]["crf"]
    preset = config["encoding"]["preset"]
    free_space_mode = config.get("free_space", {}).get("chunk_generator", "none")

    if not input_video.is_file():
        print(f"ERROR: Input video not found: {input_video}")
        return False
    framerate = get_video_framerate(input_video)
    if not framerate:
        print(f"ERROR: Could not detect framerate from input video: {input_video}")
        return False
    print(f"Framerate: {framerate}  Encoding: CRF={crf}, Preset={preset}")

    existing = find_chunks(chunks_dir)
    last_end = max((e for _, e, _ in existing), default=None)
    if existing:
        print(f"Found {len(existing)} existing chunk(s); resuming from frame {last_end}")

    all_frames = find_sbs_frames(sbs_dir)
    if not all_frames:
        print("ERROR: No sbs_*.png files found!")
        return False

    if end_frame is not None:
        lo, hi = all_frames[0][0], all_frames[-1][0]
        if not (lo <= end_frame <= hi):
            print(f"ERROR: --end-frame {end_frame} outside available range "
                  f"{lo}..{hi}")
            return False

    todo = select_frames(all_frames, last_end, end_frame)
    if not todo:
        print("All frames have already been processed. Nothing to do.")
        return True
    if len(todo) < 2:
        print(f"Only {len(todo)} frame(s) available; need at least 2.")
        return True
    if not validate_contiguous(todo):
        return False

    start_n, end_n = todo[0][0], todo[-1][0]
    output = chunks_dir / f"sbs_{start_n:06d}_{end_n:06d}.mkv"
    print(f"Creating {output.name}: frames {start_n}-{end_n} ({len(todo)})")
    print("Note: if interrupted, the whole chunk is re-encoded on retry.")

    pbar = tqdm(total=len(todo), unit="frame", mininterval=0.5)
    last = [0]

    def on_progress(n):
        pbar.update(n - last[0])
        last[0] = n

    try:
        encode_chunk(sbs_dir, start_n, len(todo), framerate, crf, preset,
                     output, progress_cb=on_progress)
    except MediaError as e:
        pbar.close()
        print(f"ERROR: {e}")
        return False
    pbar.close()
    print(f"Video created: {output.stat().st_size / (1024 * 1024):.1f} MB")

    if free_space_mode == "sbs":
        # keep the final frame: it seeds the next chunk's overlap
        to_delete = todo[:-1]
        for _, path in to_delete:
            try:
                path.unlink(missing_ok=True)
            except OSError:
                pass
        print(f"Deleted {len(to_delete)} SBS files to free space "
              "(kept last frame for next chunk).")
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Encode SBS frames into x265 video chunks")
    parser.add_argument("workflow_path", type=Path)
    parser.add_argument("--end-frame", type=int, default=None,
                        help="Encode up to this frame number (inclusive)")
    args = parser.parse_args(argv)

    if not args.workflow_path.is_dir():
        print(f"ERROR: Workflow directory not found: {args.workflow_path}")
        return 1
    try:
        config = load_config(args.workflow_path)
    except ConfigError as e:
        print(f"ERROR: {e}")
        return 1
    return 0 if run(args.workflow_path, config, args.end_frame) else 1


if __name__ == "__main__":
    sys.exit(main())
