"""
Depth estimation for the streaming path (PyTorch)
=================================================

Port of ``vsc_tpu/pipeline/depth_map_generator.py:build_depth_fn``: resize
the frames to the model size (bilinear), normalize to [-1, 1], run the
model, resize the depth back to the frame size, then per-frame min-max
normalize and quantize to u8/u16 — all on the frames' device.

Without a checkpoint DepthPro runs at its full production width with
parameters drawn from a seeded generator on the target device, following
the JAX package's flax init laws (its CLI does the same under
``--model depthpro`` with no checkpoint). A checkpoint may be Apple's
``depth_pro.pt``, HuggingFace's ``apple/DepthPro-hf`` ``model.safetensors``
(or a ``.pt`` / ``.pth`` of its state dict), converted strictly by
``models/convert.py``, or an npz of the JAX parameter tree
(``vsc_tpu.models.convert.save_params``, the weight cache of
``models/bootstrap.py``), as the JAX package reads them
(``vsc_tpu/pipeline/depth_map_generator.py:85-91``).

Compute dtype: bfloat16 on CUDA, float32 on the CPU (the JAX rule: the
accelerator's native inference precision, f32 elsewhere), unless
``VSC_TPU_DEPTH_DTYPE`` says otherwise, read as the JAX package reads it
(``bfloat16`` -> bf16, any other value -> f32). The ViT attention picks its
kernel by dtype and head dim (``models/vit.py``), so f32 runs on the card.

Entry points run on the card unless the caller asks for the CPU: ``device``
None means ``vsc_tpu_torch.default_device()``, which raises without one.
"""

from __future__ import annotations

import os

import torch

__all__ = ["build_depth_fn", "build_depthpro", "depth_dtype",
           "CHECKPOINT_ENV", "DTYPE_ENV"]

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
        cfg = DepthProConfig(img_size=input_size, tile_size=input_size // 4,
                             encoder=ViTConfig(img_size=input_size // 4))
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
                   device=None, model_cfg=None, seed: int = 0):
    """Returns f(u8 frames [B, H, W, 3] tensor on ``device``) -> quantized
    depth [B, out_h, out_w] (uint8, or uint16 with ``use_16bit``).
    ``device`` None means ``default_device()`` (the card, or an error).
    ``model_cfg`` overrides the DepthPro config (tests run a small one)."""
    from vsc_tpu_torch import default_device
    from vsc_tpu_torch.ops.resize import resize

    if device is None:
        device = default_device()

    if model_name == "depthpro":
        if model_cfg is not None:
            input_size = model_cfg.img_size
        model = build_depthpro(input_size, device, cfg=model_cfg,
                               checkpoint=checkpoint, seed=seed)

        def infer(x):
            return model(x)["canonical_inverse_depth"]
    elif model_name == "stub":
        from vsc_tpu_torch.models.stub import luminance_depth
        infer = luminance_depth
    else:
        raise ValueError(f"unknown depth model: {model_name}")

    max_val = 65535.0 if use_16bit else 255.0
    out_dtype = torch.uint16 if use_16bit else torch.uint8

    @torch.inference_mode()
    def depth_fn(frames_u8):
        x = frames_u8.to(torch.float32)
        x = resize(x, input_size, input_size, "bilinear", channel_last=True)
        x = x / 127.5 - 1.0
        depth = infer(x)                                  # [B, S', S']
        depth = resize(depth, out_h, out_w, "bilinear")
        d_min = depth.amin(dim=(1, 2), keepdim=True)
        d_max = depth.amax(dim=(1, 2), keepdim=True)
        norm = (depth - d_min) / torch.clamp(d_max - d_min, min=1e-12)
        return torch.round(norm * max_val).to(out_dtype)

    return depth_fn
