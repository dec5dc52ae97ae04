"""
Step 3 — SBS stereo generation (PyTorch)
========================================

Port of ``vsc_tpu/pipeline/sbs_generator.py``: drives the batched stereo
pipeline (``ops/stereo.generate_sbs`` and its kernels) over all
frame/depth pairs, with the same CLI (``--cpu``, ``--no-interactive``,
``--batch-size``), pair discovery (.tif preferred over .png, missing depth
ranges reported), skip-existing resume, free_space deletion modes, ragged
last batch padded to the full batch, and the accelerator-health-check ->
exit-code-100 contract the orchestrator relies on: the known-answer probe
of ``parallel/health`` runs before the run and before every dispatch. The
probe synchronizes the device, so the one before a dispatch waits for the
batch before it, as the TPU's in-order queue does in the JAX package::

    python -m vsc_tpu_torch.pipeline.sbs_generator <workflow> [--cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from vsc_tpu_torch.config import (ConfigError, StereoParams, get_path,
                                  load_config)

__all__ = ["find_frame_pairs", "run", "main", "DEFAULT_BATCH"]

DEFAULT_BATCH = 4


def find_frame_pairs(frames_dir: Path, depth_dir: Path):
    """(frame_path, depth_path, frame_num_str) for every frame that has a
    depth map; reports missing ranges like the reference
    (sbs_generator.py:71-116)."""
    pairs = []
    missing = 0
    first_missing = last_missing = None
    for frame_path in sorted(frames_dir.glob("frame_*.png")):
        num = frame_path.stem.removeprefix("frame_")
        depth_path = depth_dir / f"depth_frame_{num}.tif"
        if not depth_path.exists():
            depth_path = depth_dir / f"depth_frame_{num}.png"
            if not depth_path.exists():
                if first_missing is None:
                    first_missing = num
                last_missing = num
                missing += 1
                continue
        pairs.append((frame_path, depth_path, num))
    if missing:
        print(f"Missing depth maps: {missing} frames in range "
              f"frame_{first_missing} to frame_{last_missing}")
    return pairs


def run(workflow_path: Path, config: dict, *, batch_size=DEFAULT_BATCH,
        interactive=True, device=None) -> int:
    """The SBS step on ``device`` (None: ``default_device()``). Returns the
    process exit code (0 ok, 1 error, 100 accelerator failure)."""
    import numpy as np
    import torch
    from tqdm import tqdm

    from vsc_tpu_torch import default_device
    from vsc_tpu_torch.io.image import load_image_pair, write_rgb
    from vsc_tpu_torch.io.prefetch import (PipelineAbort, SaveError,
                                           run_pipeline)
    from vsc_tpu_torch.ops.stereo import generate_sbs
    from vsc_tpu_torch.parallel import health
    from vsc_tpu_torch.parallel.auto import (data_mesh, device_count, gather,
                                             pad_to_multiple, shard_batch)
    from vsc_tpu_torch.utils.profiling import trace

    device = torch.device(device) if device is not None else default_device()
    frames_dir = get_path(workflow_path, config, "frames")
    depth_dir = get_path(workflow_path, config, "depth_maps")
    output_dir = get_path(workflow_path, config, "sbs")
    for d, name in ((frames_dir, "Frames"), (depth_dir, "Depth")):
        if not d.exists():
            print(f"ERROR: {name} directory not found: {d}")
            return 1
    output_dir.mkdir(parents=True, exist_ok=True)

    params = StereoParams.from_config(config["stereo"])
    print(f"Parameters: {params}")

    free_space_mode = config.get("free_space", {}).get("sbs_generator", "none")
    if free_space_mode != "none":
        print(f"Free space mode: {free_space_mode}")

    all_pairs = find_frame_pairs(frames_dir, depth_dir)
    todo = []
    skipped = 0
    for fp, dp, num in all_pairs:
        if (output_dir / f"sbs_{num}.png").exists():
            skipped += 1
        else:
            todo.append((fp, dp, num))
    print(f"Found: {len(all_pairs)} frame pairs, {skipped} already processed, "
          f"{len(todo)} to process")
    if not todo:
        print("All frames already processed.")
        return 0

    mesh = data_mesh(device)
    ndev = device_count(device)
    name = (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else "")
    print(f"Using: {device}{name} ({ndev} device(s)), batch={batch_size}")
    # the probe runs on every card the batches go to
    probed = [device] if mesh is None else mesh.distinct_devices()

    def healthy():
        return all(health.check_accelerator_health(d) for d in probed)

    if not healthy():
        print("\nERROR: accelerator health check failed")
        return health.ACCEL_ERROR_EXIT_CODE

    accel_failed = []

    def load_batch(chunk):
        rgbs, depths = [], []
        for fp, dp, _ in chunk:
            rgb, depth = load_image_pair(fp, dp)
            rgbs.append(rgb)
            depths.append(depth)
        # ragged final batches padded up to the FULL batch size: every
        # dispatch has one shape (pad_to_multiple AFTER the max, so it is
        # also a multiple of the device count)
        target = pad_to_multiple(max(len(rgbs), batch_size), ndev)
        while len(rgbs) < target:
            rgbs.append(rgbs[-1])
            depths.append(depths[-1])
        return np.stack(rgbs), np.stack(depths)

    def compute(batch):
        # per-dispatch health probe: the device equivalent of the
        # reference's per-frame GPU known-answer test
        # (sbs_generator.py:312-317)
        if not healthy():
            accel_failed.append(True)
            raise PipelineAbort("accelerator health check failed")
        rgbs, depths = batch
        return generate_sbs(shard_batch(rgbs, device, mesh),
                            shard_batch(depths, device, mesh), params)

    def split_results(result, chunk):
        host = gather(result).numpy()   # waits for the batch
        return [(host[i], chunk[i]) for i in range(len(chunk))]

    def save_one(entry):
        sbs, (fp, dp, num) = entry
        if not write_rgb(output_dir / f"sbs_{num}.png", sbs):
            return False
        if free_space_mode in ("frame", "all"):
            fp.unlink(missing_ok=True)
        if free_space_mode in ("depth", "all"):
            dp.unlink(missing_ok=True)
        return True

    pbar = tqdm(total=len(all_pairs), initial=skipped, unit="img",
                mininterval=0.5)
    try:
        with trace("sbs_generator"):
            done = run_pipeline(todo, load_batch, compute, save_one,
                                split_results, batch_size=batch_size,
                                interactive=interactive,
                                progress_cb=pbar.update)
    except SaveError:
        pbar.close()
        return 1
    pbar.close()
    if accel_failed:
        print("\nERROR: accelerator health check failed - device lost")
        return health.ACCEL_ERROR_EXIT_CODE
    print(f"Done! Processed {done} of {len(todo)} frames.")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Generate side-by-side stereo frames (PyTorch; on the "
                    "card unless --cpu)")
    parser.add_argument("workflow_path", type=Path)
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU (default: the card)")
    parser.add_argument("--no-interactive", action="store_true")
    parser.add_argument("--batch-size", type=int, default=DEFAULT_BATCH)
    args = parser.parse_args(argv)

    from vsc_tpu_torch import cli_device
    try:
        device = cli_device(force_cpu=args.cpu)
    except RuntimeError as e:
        print(f"ERROR: {e}")
        return 1
    if not args.workflow_path.is_dir():
        print(f"ERROR: Workflow directory not found: {args.workflow_path}")
        return 1
    try:
        config = load_config(args.workflow_path)
    except ConfigError as e:
        print(f"ERROR: {e}")
        return 1
    return run(args.workflow_path, config, batch_size=args.batch_size,
               interactive=not args.no_interactive, device=device)


if __name__ == "__main__":
    from vsc_tpu_torch.utils.console import (ensure_utf8_console,
                                             set_terminal_title)
    ensure_utf8_console()
    set_terminal_title("sbs_generator " + " ".join(sys.argv[1:]))
    sys.exit(main())
