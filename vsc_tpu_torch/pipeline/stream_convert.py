"""
Streaming converter (PyTorch / CUDA)
====================================

Port of ``vsc_tpu/pipeline/stream_convert.py``: decode -> depth (DepthPro,
Depth Anything V2 with ``--model depth-anything-v2``, or the stub) -> SBS
-> x265 chunk encode in one process with no PNG
intermediates, with the same flags, chunk naming (1-frame overlap after the
first chunk), chunk-granular resume, free-space rules and exit-100
accelerator-failure contract. Decoding, encoding and concatenation run on
the port's own copies of the JAX package's framework-free layers
(``vsc_tpu_torch.io``, ``config``, ``pipeline.video_concatenator``).

It runs on the card unless the caller asks for the CPU (``--cpu``, or
``device="cpu"`` to ``run``); with no card and no such request it raises.

The device work of one batch is ``render_sbs`` (frames in, SBS frames out),
callable without the media engine::

    python -m vsc_tpu_torch.pipeline.stream_convert <workflow> --model depthpro

The SBS stage runs the workflow's stereo config as it stands, the default
``super_sampling`` 3 included (ops/stereo.py picks the branch).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from vsc_tpu_torch.config import (ConfigError, StereoParams, get_path,
                                  load_config)

__all__ = ["render_sbs", "run", "main", "AccelFailure"]


class AccelFailure(RuntimeError):
    """Accelerator health probe failed mid-stream (exit 100 contract)."""


PROBE_EVERY_FRAMES = int(os.environ.get("VSC_TPU_STREAM_PROBE_FRAMES", "64"))
DISPATCH_TIMEOUT = float(os.environ.get("VSC_TPU_DISPATCH_TIMEOUT", "120"))
DISPATCH_COLD_TIMEOUT = float(
    os.environ.get("VSC_TPU_DISPATCH_COLD_TIMEOUT", "900"))


def render_sbs(rgb_u8, depth_fn, params: StereoParams):
    """Device work of one batch: rgb_u8 [B, H, W, 3] uint8 tensor ->
    sbs_u8 [B, H, 2W, 3] uint8 tensor, on the input's device (``Sharded``
    in, ``Sharded`` out, on a data mesh)."""
    from vsc_tpu_torch.ops.stereo import generate_sbs
    return generate_sbs(rgb_u8, depth_fn(rgb_u8), params)


def _free_space_cleanup(workflow_path: Path, config: dict, upto: int) -> None:
    """The step pipeline's free_space semantics for frames <= upto
    (intermediates that encoded chunks now supersede)."""
    from vsc_tpu_torch.utils.frame_utils import extract_frame_number
    fs = config.get("free_space", {})
    sbs_mode = fs.get("sbs_generator", "none")
    chunk_mode = fs.get("chunk_generator", "none")
    targets = []
    if sbs_mode in ("frame", "all"):
        targets.append((get_path(workflow_path, config, "frames"), upto))
    if sbs_mode in ("depth", "all"):
        targets.append((get_path(workflow_path, config, "depth_maps"), upto))
    if chunk_mode in ("sbs", "all"):
        targets.append((get_path(workflow_path, config, "sbs"), upto - 1))
    for directory, limit in targets:
        if not directory.is_dir():
            continue
        for f in directory.iterdir():
            n = extract_frame_number(f.name)
            if 0 < n <= limit:
                f.unlink(missing_ok=True)


def run(workflow_path: Path, config: dict, *, batch_size: int = 4,
        chunk_size: int = 1500, model_name: str | None = None,
        input_size: int | None = None, concat: bool = True,
        device=None) -> bool:
    import numpy as np
    import torch
    from tqdm import tqdm

    from vsc_tpu_torch.io.media import RawFrameSink, decode_frames
    from vsc_tpu_torch.io.probe import probe_video
    from vsc_tpu_torch.pipeline.chunk_generator import find_chunks
    from vsc_tpu_torch import default_device
    from vsc_tpu_torch.parallel import health
    from vsc_tpu_torch.parallel.auto import (data_mesh, device_count, gather,
                                             pad_to_multiple, shard_batch)
    from vsc_tpu_torch.pipeline import depth_map_generator
    from vsc_tpu_torch.utils.profiling import trace

    device = torch.device(device) if device is not None else default_device()
    input_video = get_path(workflow_path, config, "input_video")
    chunks_dir = get_path(workflow_path, config, "chunks")
    chunks_dir.mkdir(parents=True, exist_ok=True)

    info = probe_video(input_video)
    if not info:
        print(f"ERROR: cannot probe input video: {input_video}")
        return False
    W, H = info["width"], info["height"]
    framerate = info["r_frame_rate"]
    total = int(info["nb_frames"])

    existing = find_chunks(chunks_dir)
    done_upto = max((e for _, e, _ in existing), default=0)
    if done_upto >= total > 0:
        print("All frames already encoded into chunks.")
    else:
        try:
            checkpoint = depth_map_generator.model_checkpoint(model_name)
        except ConfigError as e:
            print(f"ERROR: {e}")
            return False
        if model_name is None:
            model_name = "depthpro" if checkpoint else "stub"
        params = StereoParams.from_config(config["stereo"])
        use_16bit = bool(config["depth"]["save_16bit"])
        mesh = data_mesh(device)
        probed = [device] if mesh is None else mesh.distinct_devices()

        def healthy():
            return all(health.check_accelerator_health(d) for d in probed)

        if not healthy():
            raise AccelFailure("accelerator health check failed")
        depth_fn = depth_map_generator.build_depth_fn(
            model_name, input_size, H, W, use_16bit, checkpoint,
            device=device, mesh=mesh)
        # every dispatch shape: the full batch, divisible by the device
        # count (the batch axis splits over the data mesh)
        dispatch_n = pad_to_multiple(batch_size, device_count(device))
        print(f"Streaming {input_video.name}: {W}x{H} @ {framerate}, "
              f"{total} frames, resume from {done_upto}, "
              f"model={model_name}, batch={batch_size}, device={device}")
        crf = config["encoding"]["crf"]
        preset = config["encoding"]["preset"]

        resume_decode_from = max(done_upto - 1, 0)
        frame_iter = decode_frames(input_video, W, H, start=resume_decode_from)
        pbar = tqdm(total=total, initial=done_upto, unit="frame",
                    mininterval=0.5)
        frame_no = done_upto
        probe_every = max(1, -(-PROBE_EVERY_FRAMES // max(batch_size, 1)))
        batches_since_probe = 0
        warmed = [False]

        def compute_batch(rgb_np, n):
            def _run():
                rgb = shard_batch(np.array(rgb_np), device, mesh)
                sbs = render_sbs(rgb, depth_fn, params)
                return gather(sbs)[:n].numpy()
            deadline = (DISPATCH_TIMEOUT if warmed[0]
                        else max(DISPATCH_TIMEOUT, DISPATCH_COLD_TIMEOUT))
            try:
                out = health.run_with_deadline(_run, deadline)
            except TimeoutError as e:
                raise AccelFailure(str(e)) from e
            warmed[0] = True
            return out

        carry_sbs = None
        if done_upto > 0:
            raw = next(frame_iter, None)
            if raw is None:
                print("ERROR: cannot re-decode chunk boundary frame")
                return False
            rgb = np.frombuffer(raw, np.uint8).reshape(1, H, W, 3)
            carry_sbs = compute_batch(np.repeat(rgb, dispatch_n, axis=0), 1)

        with trace("stream_convert"):
            while frame_no < total or total == 0:
                if not healthy():
                    raise AccelFailure("accelerator health check failed")
                batches_since_probe = 0
                start_frame = frame_no if frame_no > 0 else 1
                end_target = (min(frame_no + chunk_size, total) if total
                              else frame_no + chunk_size)
                out = chunks_dir / f"sbs_{start_frame:06d}_{end_target:06d}.mkv"
                sink = RawFrameSink(out, 2 * W, H, framerate, crf=crf,
                                    preset=preset)
                produced = 0
                try:
                    if carry_sbs is not None:
                        sink.write(carry_sbs.tobytes())
                    eof = False
                    last_sbs = None
                    while frame_no + produced < end_target:
                        raws = []
                        while len(raws) < batch_size:
                            if frame_no + produced + len(raws) >= end_target:
                                break
                            raw = next(frame_iter, None)
                            if raw is None:
                                eof = True
                                break
                            raws.append(raw)
                        if not raws:
                            break
                        n = len(raws)
                        rgb = np.frombuffer(b"".join(raws), np.uint8).reshape(
                            n, H, W, 3)
                        if n < dispatch_n:  # a fixed dispatch shape
                            rgb = np.concatenate(
                                [rgb, np.repeat(rgb[-1:], dispatch_n - n, 0)])
                        if batches_since_probe >= probe_every:
                            if not healthy():
                                raise AccelFailure(
                                    "accelerator health check failed")
                            batches_since_probe = 0
                        sbs = compute_batch(rgb, n)
                        batches_since_probe += 1
                        sink.write(sbs.tobytes())
                        last_sbs = sbs[-1:]
                        produced += n
                        pbar.update(n)
                        if eof:
                            break
                except AccelFailure:
                    sink.close(success=False)
                    pbar.close()
                    raise
                except Exception as e:
                    sink.close(success=False)
                    pbar.close()
                    print(f"ERROR: streaming conversion failed: {e}")
                    return False

                if produced == 0:
                    sink.close(success=False)
                    break
                carry_sbs = last_sbs
                actual_end = frame_no + produced
                sink.close(success=True)
                if actual_end != end_target:
                    out.rename(chunks_dir
                               / f"sbs_{start_frame:06d}_{actual_end:06d}.mkv")
                frame_no = actual_end
                _free_space_cleanup(workflow_path, config, frame_no)
                if eof:
                    break
        pbar.close()
        print(f"Encoded up to frame {frame_no}.")

    if concat:
        from vsc_tpu_torch.pipeline import video_concatenator
        return video_concatenator.run(workflow_path, config)
    return True


def main(argv=None) -> int:
    from vsc_tpu_torch.pipeline import depth_map_generator
    parser = argparse.ArgumentParser(
        description="Streaming video->stereo conversion on PyTorch/CUDA "
                    "(no PNG intermediates)")
    parser.add_argument("workflow_path", type=Path)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--chunk-size", type=int, default=1500)
    parser.add_argument("--model", choices=depth_map_generator.MODELS,
                        default=None)
    parser.add_argument("--input-size", type=int, default=None,
                        help="Model input resolution (default: the model's "
                             "own, 1536 for DepthPro, 518 for "
                             "depth-anything-v2)")
    parser.add_argument("--no-concat", action="store_true",
                        help="Stop after chunk encoding")
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
    try:
        ok = run(args.workflow_path, config, batch_size=args.batch_size,
                 chunk_size=args.chunk_size, model_name=args.model,
                 input_size=args.input_size, concat=not args.no_concat,
                 device=device)
    except AccelFailure as e:
        from vsc_tpu_torch.parallel.health import ACCEL_ERROR_EXIT_CODE
        print(f"ERROR: {e}")
        return ACCEL_ERROR_EXIT_CODE
    return 0 if ok else 1


if __name__ == "__main__":
    from vsc_tpu_torch.utils.console import (ensure_utf8_console,
                                             set_terminal_title)
    ensure_utf8_console()
    set_terminal_title("stream_convert " + " ".join(sys.argv[1:]))
    sys.exit(main())
