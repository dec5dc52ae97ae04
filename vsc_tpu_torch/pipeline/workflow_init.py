"""
Step 0 — workflow initialization
================================

Port of ``vsc_tpu/pipeline/workflow_init.py``: creates the workflow
directory layout + default config.json. CLI surface and on-disk results
match the reference's workflow_init.py (same flags, same subdirectories,
refuses to re-init an existing workflow)::

    python -m vsc_tpu_torch.pipeline.workflow_init --input-video <video>
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from vsc_tpu_torch.config import create_default_config, save_config

SUBDIRS = ("frames", "depth_maps", "sbs", "chunks")

NEXT_STEPS = """
Next steps:
  1. Extract frames:  python -m vsc_tpu_torch.pipeline.frame_extractor "{wf}"
  2. Generate depth:  python -m vsc_tpu_torch.pipeline.depth_map_generator "{wf}"
  3. Test settings:   python -m vsc_tpu_torch.pipeline.sbs_tester "{wf}"
  4. Generate SBS:    python -m vsc_tpu_torch.pipeline.sbs_generator "{wf}"
  5. Create chunks:   python -m vsc_tpu_torch.pipeline.chunk_generator "{wf}"
  6. Concatenate:     python -m vsc_tpu_torch.pipeline.video_concatenator "{wf}"
"""


def init_workflow(input_video: Path, workflow_dir: Path | None = None) -> Path:
    """Create the workflow; returns its path. Raises on re-init."""
    input_video = Path(input_video).resolve()
    if not input_video.is_file():
        raise FileNotFoundError(f"Input video does not exist: {input_video}")

    if workflow_dir is None:
        workflow_dir = input_video.parent / "workflow"
    workflow_dir = Path(workflow_dir).resolve()

    if (workflow_dir / "config.json").exists():
        raise FileExistsError(
            f"Workflow already initialized: {workflow_dir / 'config.json'}")

    workflow_dir.mkdir(parents=True, exist_ok=True)
    for sub in SUBDIRS:
        (workflow_dir / sub).mkdir(exist_ok=True)
    save_config(workflow_dir, create_default_config(input_video))
    return workflow_dir


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Initialize a new workflow directory with default configuration")
    parser.add_argument("--input-video", type=Path, required=True,
                        help="Path to the input video file")
    parser.add_argument("--workflow-dir", type=Path, default=None,
                        help="Workflow directory (default: workflow/ next to the video)")
    args = parser.parse_args(argv)

    try:
        wf = init_workflow(args.input_video, args.workflow_dir)
    except (FileNotFoundError, FileExistsError) as e:
        print(f"ERROR: {e}")
        return 1

    from vsc_tpu_torch.config import load_config
    config = load_config(wf)
    print(f"Workflow initialized: {wf}")
    print(f"  Input video:  {config['input_video']}")
    print(f"  Output video: {config['output_video']}")
    print(NEXT_STEPS.format(wf=wf))
    return 0


if __name__ == "__main__":
    from vsc_tpu_torch.utils.console import (ensure_utf8_console,
                                             set_terminal_title)
    ensure_utf8_console()
    set_terminal_title("workflow_init " + " ".join(sys.argv[1:]))
    sys.exit(main())
