"""
Step 5 — concatenation + audio mux
==================================

Joins the x265 chunks into the final stereo video and muxes the original
audio (stream copy, no re-encode). Validation semantics mirror the reference
(reference video_concatenator.py:60-133): chunks must be contiguous,
uniformly overlapping (end == next start) or non-overlapping
(end+1 == next start) — mixed modes are an error — and share one framerate.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from vsc_tpu_torch.config import ConfigError, get_path, load_config
from vsc_tpu_torch.io.media import MediaError, concat_chunks
from vsc_tpu_torch.io.probe import get_video_framerate
from vsc_tpu_torch.pipeline.chunk_generator import find_chunks


def validate_sequence(chunks: list[tuple[int, int, Path]]) -> tuple[bool, bool]:
    """(is_valid, is_overlapping)."""
    if len(chunks) < 2:
        return True, False
    overlapping = None
    for (s0, e0, p0), (s1, e1, p1) in zip(chunks, chunks[1:]):
        if e0 == s1:
            cur = True
        elif e0 + 1 == s1:
            cur = False
        else:
            print("ERROR: Gap or invalid sequence detected!")
            print(f"  {p0.name} ends at frame {e0}; {p1.name} starts at {s1}")
            return False, False
        if overlapping is None:
            overlapping = cur
        elif overlapping != cur:
            print("ERROR: Mixed overlapping/non-overlapping sequences detected!")
            print(f"  Between {p0.name} and {p1.name}")
            return False, False
    return True, bool(overlapping)


def validate_framerates(chunks: list[tuple[int, int, Path]]) -> str | None:
    first = get_video_framerate(chunks[0][2])
    if not first:
        print(f"ERROR: Could not detect framerate of {chunks[0][2].name}")
        return None
    for _, _, path in chunks[1:]:
        fr = get_video_framerate(path)
        if fr != first:
            print("ERROR: Framerate mismatch!")
            print(f"  {chunks[0][2].name}: {first}")
            print(f"  {path.name}: {fr}")
            return None
    return first


def run(workflow_path: Path, config: dict) -> bool:
    chunks_dir = get_path(workflow_path, config, "chunks")
    output_path = get_path(workflow_path, config, "output_video")
    input_video = get_path(workflow_path, config, "input_video")

    if not chunks_dir.is_dir():
        print(f"ERROR: Chunks directory does not exist: {chunks_dir}")
        return False

    audio_source = input_video if input_video.is_file() else None
    if audio_source is None:
        print(f"WARNING: Input video not found, output will have no audio: "
              f"{input_video}")

    output_path.parent.mkdir(parents=True, exist_ok=True)

    chunks = find_chunks(chunks_dir)
    if not chunks:
        print(f"ERROR: No sbs_XXXXXX_YYYYYY.mkv files found in {chunks_dir}")
        return False
    print(f"Found {len(chunks)} chunk(s):")
    for s, e, p in chunks:
        print(f"  - {p.name} (frames {s} to {e})")

    ok, overlapping = validate_sequence(chunks)
    if not ok:
        return False
    framerate = validate_framerates(chunks)
    if framerate is None:
        return False
    print(f"Framerate: {framerate}  Mode: "
          f"{'overlapping' if overlapping else 'non-overlapping'}")

    try:
        concat_chunks([p for _, _, p in chunks], output_path,
                      is_overlapping=overlapping, framerate_str=framerate,
                      audio_source=audio_source)
    except MediaError as e:
        print(f"ERROR: {e}")
        return False
    print(f"Video created: {output_path.stat().st_size / (1024 * 1024):.1f} MB")
    print(f"Done! Output: {output_path}")
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Concatenate SBS chunks and mux the original audio")
    parser.add_argument("workflow_path", type=Path)
    args = parser.parse_args(argv)

    if not args.workflow_path.is_dir():
        print(f"ERROR: Workflow directory not found: {args.workflow_path}")
        return 1
    try:
        config = load_config(args.workflow_path)
    except ConfigError as e:
        print(f"ERROR: {e}")
        return 1
    return 0 if run(args.workflow_path, config) else 1


if __name__ == "__main__":
    sys.exit(main())
