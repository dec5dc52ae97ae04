"""
Step 2 — depth map generation (PyTorch)
=======================================

Port of ``vsc_tpu/pipeline/depth_map_generator.py``.

``build_depth_fn``: resize the frames to the model size (bilinear),
normalize to [-1, 1], run the model, resize the depth back to the frame
size, then per-frame min-max normalize and quantize to u8/u16 — all on the
frames' device. The streaming converter calls it too.

``run`` / ``main``: the step CLI, with the JAX package's flags
(``--cpu``, ``--start-frame`` / ``--end-frame``, ``--no-interactive``,
``--batch-size``, ``--model``, ``--input-size``), resume rule (skip frames
whose output exists), ragged last batch padded to the full batch, and
output (8-bit PNG or 16-bit deflate TIFF, read back and deleted when
corrupt), through the loader / compute / saver threads of
``io/prefetch``::

    python -m vsc_tpu_torch.pipeline.depth_map_generator <workflow> [--cpu]

Without a checkpoint DepthPro runs at its full production width with
parameters drawn from a seeded generator on the target device, following
the JAX package's flax init laws (its CLI does the same under
``--model depthpro`` with no checkpoint). A checkpoint may be Apple's
``depth_pro.pt``, HuggingFace's ``apple/DepthPro-hf`` ``model.safetensors``
(or a ``.pt`` / ``.pth`` of its state dict), converted strictly by
``models/convert.py``, or an npz of the JAX parameter tree
(``vsc_tpu.models.convert.save_params``, the weight cache of
``models/bootstrap.py``), as the JAX package reads them
(``vsc_tpu/pipeline/depth_map_generator.py:85-91``). The CLI resolves it
env > npz cache > hub unless ``--model stub``.

Compute dtype: bfloat16 on CUDA, float32 on the CPU (the JAX rule: the
accelerator's native inference precision, f32 elsewhere), unless
``VSC_TPU_DEPTH_DTYPE`` says otherwise, read as the JAX package reads it
(``bfloat16`` -> bf16, any other value -> f32). The ViT attention picks its
kernel by dtype and head dim (``models/vit.py``), so f32 runs on the card.

Entry points run on the card unless the caller asks for the CPU: ``device``
None means ``vsc_tpu_torch.default_device()``, which raises without one.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import torch

from vsc_tpu_torch.config import ConfigError, get_path, load_config

__all__ = ["build_depth_fn", "build_depthpro", "depth_dtype", "run", "main",
           "CHECKPOINT_ENV", "DTYPE_ENV", "DEFAULT_BATCH"]

DEFAULT_BATCH = 8
CHECKPOINT_ENV = "VSC_TPU_DEPTH_CHECKPOINT"
DTYPE_ENV = "VSC_TPU_DEPTH_DTYPE"


def depth_dtype(device) -> torch.dtype:
    """The depth model's compute dtype on ``device``: ``VSC_TPU_DEPTH_DTYPE``
    when set (``bfloat16`` -> bf16, anything else -> f32, as
    ``vsc_tpu/pipeline/depth_map_generator.py`` reads it), else bf16 on CUDA
    and f32 on the CPU."""
    want = os.environ.get(DTYPE_ENV, "bfloat16" if torch.device(device).type
                          == "cuda" else "float32")
    return torch.bfloat16 if want == "bfloat16" else torch.float32


def build_depthpro(input_size: int, device=None, *, cfg=None,
                   checkpoint: str | None = None, seed: int = 0):
    """A DepthPro on ``device`` (None: ``default_device()``) in eval mode,
    in ``depth_dtype(device)``: production width at ``input_size`` unless
    ``cfg`` is given; weights from ``checkpoint`` (``.pt``, ``.pth`` or
    ``.safetensors`` converted, a hub download then cached as npz; any
    other file read as a JAX npz) or drawn from
    ``torch.Generator(device).manual_seed(seed)``."""
    from vsc_tpu_torch import default_device
    from vsc_tpu_torch.models import (DepthPro, DepthProConfig, ViTConfig,
                                      init_flax_like)
    if device is None:
        device = default_device()
    if cfg is None:
        if input_size % 512 != 0:
            raise ValueError(
                "DepthPro input size must be a multiple of 512 (tile = "
                "size/4, ViT/16 token grid must be a multiple of 8); the "
                f"production size is 1536. Got {input_size}.")
        # no FOV head, as in the JAX pipeline: the depth is min-max
        # normalized, so the head (a third ViT-L) cannot change it
        cfg = DepthProConfig(img_size=input_size, tile_size=input_size // 4,
                             encoder=ViTConfig(img_size=input_size // 4),
                             use_fov_head=False)
    device = torch.device(device)
    with device:
        model = DepthPro(cfg)
    if checkpoint:
        if str(checkpoint).endswith((".pt", ".pth", ".safetensors")):
            from vsc_tpu_torch.models.bootstrap import maybe_cache_npz
            from vsc_tpu_torch.models.convert import convert_torch_checkpoint
            model.load_state_dict(convert_torch_checkpoint(checkpoint, model),
                                  strict=True)
            maybe_cache_npz(checkpoint, model)
        else:
            from vsc_tpu_torch.models.convert import load_jax_npz
            load_jax_npz(checkpoint, model)
    else:
        init_flax_like(model, torch.Generator(device).manual_seed(seed))
    return model.to(depth_dtype(device)).eval()


def build_depth_fn(model_name: str, input_size: int, out_h: int, out_w: int,
                   use_16bit: bool, checkpoint: str | None = None, *,
                   device=None, model_cfg=None, seed: int = 0, mesh=None):
    """Returns f(u8 frames [B, H, W, 3] tensor on ``device``) -> quantized
    depth [B, out_h, out_w] (uint8, or uint16 with ``use_16bit``).
    ``device`` None means ``default_device()`` (the card, or an error).
    ``model_cfg`` overrides the DepthPro config (tests run a small one).

    With a ``mesh`` (``parallel/mesh``) the model is built once, on the
    mesh's first device, and ``parallel/sharding.shard_params`` places one
    replica on each data row (a device named twice shares its replica;
    with a model axis, the replicas' ViT blocks run tensor-parallel over
    it). f then takes a ``Sharded`` batch (``parallel/auto.shard_batch``),
    runs each shard on its own row and returns a ``Sharded`` depth that
    ``generate_sbs`` takes; a plain tensor runs on the first row."""
    from vsc_tpu_torch import default_device
    from vsc_tpu_torch.models.depthpro import preprocess_frames
    from vsc_tpu_torch.ops.resize import resize
    from vsc_tpu_torch.parallel.mesh import Sharded, on_device
    from vsc_tpu_torch.utils.profiling import span

    if mesh is not None:
        device = mesh.devices[0, 0]
    elif device is None:
        device = default_device()

    if model_name == "depthpro":
        if model_cfg is not None:
            input_size = model_cfg.img_size
        model = build_depthpro(input_size, device, cfg=model_cfg,
                               checkpoint=checkpoint, seed=seed)
        if mesh is not None:
            from vsc_tpu_torch.parallel.sharding import shard_params
            models = shard_params(model, mesh)
            del model
        else:
            models = [model]
        infers = [lambda x, m=m: m(x)["canonical_inverse_depth"]
                  for m in models]
    elif model_name == "stub":
        from vsc_tpu_torch.models.stub import luminance_depth
        infers = [luminance_depth] * (1 if mesh is None
                                      else mesh.shape["data"])
    else:
        raise ValueError(f"unknown depth model: {model_name}")

    max_val = 65535.0 if use_16bit else 255.0
    out_dtype = torch.uint16 if use_16bit else torch.uint8

    def one(infer, frames_u8):
        with span("depth", frames=frames_u8.shape[0],
                  device=frames_u8.is_cuda):
            x = frames_u8.to(torch.float32)
            x = resize(x, input_size, input_size, "bilinear",
                       channel_last=True)
            depth = infer(preprocess_frames(x))               # [B, S', S']
            depth = resize(depth, out_h, out_w, "bilinear")
            d_min = depth.amin(dim=(1, 2), keepdim=True)
            d_max = depth.amax(dim=(1, 2), keepdim=True)
            norm = (depth - d_min) / torch.clamp(d_max - d_min, min=1e-12)
            return torch.round(norm * max_val).to(out_dtype)

    @torch.inference_mode()
    def depth_fn(frames_u8):
        if not isinstance(frames_u8, Sharded):
            return one(infers[0], frames_u8)
        if frames_u8.mesh != mesh:
            raise ValueError("depth_fn: the batch lies on another mesh than "
                             "the model")
        parts = []
        for infer, part, dev in zip(infers, frames_u8.parts,
                                    mesh.data_devices):
            with on_device(dev):
                parts.append(one(infer, part))
        return Sharded(tuple(parts), mesh)

    return depth_fn


def run(workflow_path: Path, config: dict, *, start_frame=None, end_frame=None,
        batch_size=DEFAULT_BATCH, interactive=True,
        model_name: str | None = None, input_size: int = 1536,
        device=None) -> bool:
    """The depth step over the workflow's frames on ``device`` (None:
    ``default_device()``). Returns success."""
    import numpy as np
    from tqdm import tqdm

    from vsc_tpu_torch import default_device
    from vsc_tpu_torch.io.image import read_rgb, write_quantized_depth
    from vsc_tpu_torch.io.prefetch import SaveError, run_pipeline
    from vsc_tpu_torch.models.bootstrap import resolve_checkpoint
    from vsc_tpu_torch.parallel.auto import (data_mesh, device_count, gather,
                                             pad_to_multiple, shard_batch)
    from vsc_tpu_torch.utils.frame_utils import extract_frame_number
    from vsc_tpu_torch.utils.profiling import trace

    device = torch.device(device) if device is not None else default_device()
    input_dir = get_path(workflow_path, config, "frames")
    output_dir = get_path(workflow_path, config, "depth_maps")
    use_16bit = config["depth"]["save_16bit"]
    if not input_dir.exists():
        print(f"ERROR: Frames directory not found: {input_dir}")
        return False
    output_dir.mkdir(parents=True, exist_ok=True)

    ext = ".tif" if use_16bit else ".png"
    all_files = sorted(input_dir.glob("frame_*.png"))
    if start_frame is not None or end_frame is not None:
        all_files = [f for f in all_files
                     if (start_frame is None or extract_frame_number(f) >= start_frame)
                     and (end_frame is None or extract_frame_number(f) <= end_frame)]

    todo = []
    skipped = 0
    for f in all_files:
        out = output_dir / f"depth_{f.stem}{ext}"
        if out.exists():
            skipped += 1
        else:
            todo.append((f, out))
    print(f"Found: {len(all_files)} images, {skipped} already processed, "
          f"{len(todo)} to process")
    print(f"Output Format: {'16-bit TIFF' if use_16bit else '8-bit PNG'}")
    if not todo:
        print("All images already processed.")
        return True

    # the frame geometry from the first frame (one video => one size)
    try:
        H, W = read_rgb(todo[0][0]).shape[:2]
    except ValueError:
        print(f"ERROR: cannot read {todo[0][0]}")
        return False

    # the JAX package's order: env, then the npz cache, then the hub; only
    # when all fail does the stub (explicitly labeled) take over
    checkpoint = (os.environ.get(CHECKPOINT_ENV) if model_name == "stub"
                  else resolve_checkpoint())
    if model_name is None:
        model_name = "depthpro" if checkpoint else "stub"
    if model_name == "stub":
        print("\033[33mNo depth checkpoint available "
              f"(${CHECKPOINT_ENV} unset, no cache, no network); "
              "using luminance stub model.\033[0m")
    mesh = data_mesh(device)
    ndev = device_count(device)
    name = (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else "")
    print(f"Using: {device}{name} ({ndev} device(s)), model={model_name}, "
          f"batch={batch_size}")

    depth_fn = build_depth_fn(model_name, input_size, H, W, use_16bit,
                              checkpoint, device=device, mesh=mesh)

    def load_batch(chunk):
        # ragged final batches padded up to the FULL batch size: every
        # dispatch has one shape (pad_to_multiple AFTER the max, so it is
        # also a multiple of the device count)
        n = pad_to_multiple(max(len(chunk), batch_size), ndev)
        frames = np.empty((n, H, W, 3), np.uint8)
        for i, (src, _) in enumerate(chunk):
            frames[i] = read_rgb(src)
        frames[len(chunk):] = frames[max(len(chunk) - 1, 0)]
        return frames

    def compute(batch):
        return depth_fn(shard_batch(batch, device, mesh))

    def split_results(result, chunk):
        host = gather(result).numpy()   # waits for the batch
        return [(host[i], chunk[i][1]) for i in range(len(chunk))]

    def save_one(entry):
        depth_map, out_path = entry
        # already resized+normalized+quantized on the device
        return write_quantized_depth(depth_map, out_path)

    pbar = tqdm(total=len(all_files), initial=skipped, unit="img",
                mininterval=0.5)
    try:
        with trace("depth_map_generator"):
            done = run_pipeline(
                todo, load_batch, compute, save_one, split_results,
                batch_size=batch_size, interactive=interactive,
                progress_cb=pbar.update)
    except SaveError:
        pbar.close()
        return False
    pbar.close()
    print(f"Done! Processed {done} of {len(todo)} images.")
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Generate depth maps from RGB frames (PyTorch; on the "
                    "card unless --cpu)")
    parser.add_argument("workflow_path", type=Path)
    parser.add_argument("--start-frame", type=int, default=None)
    parser.add_argument("--end-frame", type=int, default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU (default: the card)")
    parser.add_argument("--no-interactive", action="store_true")
    parser.add_argument("--batch-size", type=int, default=DEFAULT_BATCH)
    parser.add_argument("--model", choices=("depthpro", "stub"), default=None,
                        help="Depth model (default: depthpro with checkpoint, "
                             "else stub)")
    parser.add_argument("--input-size", type=int, default=1536,
                        help="Model input resolution (reference: 1536)")
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
    ok = run(args.workflow_path, config,
             start_frame=args.start_frame, end_frame=args.end_frame,
             batch_size=args.batch_size, interactive=not args.no_interactive,
             model_name=args.model, input_size=args.input_size, device=device)
    return 0 if ok else 1


if __name__ == "__main__":
    from vsc_tpu_torch.utils.console import (ensure_utf8_console,
                                             set_terminal_title)
    ensure_utf8_console()
    set_terminal_title("depth_map_generator " + " ".join(sys.argv[1:]))
    sys.exit(main())
