"""
Stereo SBS pipeline (PyTorch)
=============================

Port of ``vsc_tpu/ops/stereo.py`` — the compat branch
(``vsc_tpu/ops/stereo.py:353-389``), which is what the JAX package runs at
``super_sampling`` 1. Torch glue between three hand-written kernels:

  1. pre-stretch rgb + depth by (2*max_disparity + |convergence|)/W,
     Lanczos4, integer-quantized like cv2's u8/u16 output
  2. per-frame min-max depth normalization (zeros if flat)
  3. super-sampling (CPU tensors only for now; see below)
  4-5. gaussian edge softening + depth gamma   -> blur kernel
  6. forward warp, both eyes                   -> warp kernel
  7. per-eye postprocess on the quarter-res pyramid estimate
                                               -> postprocess kernel
  8. convergence crop
  9. unsharp sharpen                           -> blur kernel (5x5)
  10. area downscale (super-sampling only), floor to u8, SBS pack

CUDA tensors with ``super_sampling > 1`` raise NotImplementedError: the
JAX package runs that setting through four further kernels (upsample,
pool, pyramid, finish) that are not ported yet, and the port does not
quietly replace them with plain PyTorch on the card.
"""

from __future__ import annotations

import torch

from vsc_tpu.config.stereo_params import StereoParams
from vsc_tpu_torch.ops.blur_cuda import gaussian_blur_planes
from vsc_tpu_torch.ops.filters import unsharp_mask
from vsc_tpu_torch.ops.inpaint import _pyramid_fill
from vsc_tpu_torch.ops.postprocess_cuda import postprocess_eye
from vsc_tpu_torch.ops.resize import resize
from vsc_tpu_torch.ops.warp_cuda import forward_warp_eyes

__all__ = ["generate_sbs", "sbs_shapes", "StereoParams"]

SS_KERNELS_TO_PORT = ("upsample (upsample_pallas.py)", "pool (pool_pallas.py)",
                      "pyramid (pyramid_pallas.py)", "finish (finish_pallas.py)")


def sbs_shapes(height: int, width: int, params: StereoParams) -> dict:
    """All static intermediate geometry for an input size + params."""
    total_buffer = 2.0 * params.max_disparity + abs(params.convergence)
    stretch_factor = 1.0 + total_buffer / width
    stretched_w = int(width * stretch_factor)
    shapes = {"stretched_w": stretched_w, "stretched_h": height}
    if params.super_sampling > 1.0:
        up_h = int(height * params.super_sampling)
        up_w = int(stretched_w * params.super_sampling)
        scale_ratio = up_w / stretched_w
        shapes.update(up_h=up_h, up_w=up_w, scale_ratio=scale_ratio,
                      crop_w=int(width * scale_ratio))
    else:
        shapes.update(up_h=height, up_w=stretched_w, scale_ratio=1.0,
                      crop_w=width)
    return shapes


def _normalize_depth(depth):
    """Per-frame min-max normalization; flat frames -> zeros."""
    d_min = depth.amin(dim=(1, 2), keepdim=True)
    d_max = depth.amax(dim=(1, 2), keepdim=True)
    rng = d_max - d_min
    out = (depth - d_min) / torch.clamp(rng, min=1e-12)
    return torch.where(rng < 1e-6, torch.zeros_like(depth), out)


def _quantize_like(x, max_value: float):
    """Round half up + clip to the integer grid cv2.resize produces for
    u8/u16 inputs."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, max_value)


def _crop_offsets(height: int, width: int,
                  params: StereoParams) -> tuple[int, int, int]:
    """(left_offset, right_offset, crop_width) in warp-resolution pixels,
    clamped into range."""
    s = sbs_shapes(height, width, params)
    base = (s["stretched_w"] - width) // 2
    shift = int(round(params.convergence))
    left = base + shift
    right = base - shift
    if params.super_sampling > 1.0:
        ratio = s["scale_ratio"]
        left = int(left * ratio)
        right = int(right * ratio)
    crop_w = s["crop_w"]
    hi = s["up_w"] - crop_w
    return max(0, min(left, hi)), max(0, min(right, hi)), crop_w


def _postprocess_eye(eye4, artifact_smoothing: float):
    """[4, B, H, W] u8 warped eye -> [3, B, H, W] u8: the quarter-res
    push-pull estimate (plain torch, as the JAX compat branch computes it
    in jnp), then the postprocess kernel."""
    img = torch.movedim(eye4[:3], 0, -1).to(torch.float32)
    valid = eye4[3].to(torch.float32)[..., None]
    smooth_q = _pyramid_fill(img, valid, coarse_factor=4, return_coarse=True)
    smooth_q = torch.movedim(smooth_q, -1, 0).contiguous()
    return postprocess_eye(eye4, smooth_q, artifact_smoothing)


def _depth_max(depth) -> float:
    if depth.dtype == torch.uint8:
        return 255.0
    if depth.dtype == torch.uint16:
        return 65535.0
    return float("inf")     # float depth: no integer quantization


def generate_sbs(rgb, depth, params: StereoParams | None = None):
    """Batched SBS generation.

    Args:
      rgb: [B, H, W, 3] uint8 (or float holding u8 values) tensor.
      depth: [B, H, W] uint8/uint16/float "nearness" (larger = closer).
      params: StereoParams (defaults match the reference).

    Returns:
      [B, H, 2W, 3] uint8 side-by-side frames (left | right), on the
      input's device.
    """
    params = params or StereoParams()
    if params.super_sampling > 1.0 and rgb.device.type != "cpu":
        raise NotImplementedError(
            "generate_sbs: super_sampling > 1 on a GPU needs the kernels "
            "not ported yet: " + ", ".join(SS_KERNELS_TO_PORT)
            + "; set super_sampling: 1.0 in the workflow's stereo config")
    depth_max = _depth_max(depth)
    B, H, W, _ = rgb.shape
    s = sbs_shapes(H, W, params)
    rgb = rgb.to(torch.float32)
    depth = depth.to(torch.float32)

    # 1. pre-stretch
    rgb_st = _quantize_like(
        resize(rgb, H, s["stretched_w"], "lanczos4", channel_last=True), 255.0)
    depth_st = resize(depth, H, s["stretched_w"], "lanczos4")
    if depth_max != float("inf"):
        depth_st = _quantize_like(depth_st, depth_max)

    # 2. normalize
    depth_n = _normalize_depth(depth_st)

    # 3. super-sampling (CPU only, see the module docstring)
    if params.super_sampling > 1.0:
        depth_n = resize(depth_n, s["up_h"], s["up_w"], "bilinear")
        rgb_st = resize(rgb_st, s["up_h"], s["up_w"], "bilinear",
                        channel_last=True)

    # 4-5. edge softening + depth gamma
    gam = params.depth_gamma if params.depth_gamma != 1.0 else None
    if params.edge_softness > 0:
        k = max(5, min(int(params.edge_softness * 6) | 1, 31))
        depth_n = gaussian_blur_planes(depth_n.contiguous(), k,
                                       params.edge_softness, gamma=gam)
    elif gam is not None:
        depth_n = torch.clamp(depth_n, 0.001, 1.0) ** gam

    lo, ro, crop_w = _crop_offsets(H, W, params)

    # 6. forward warp, both eyes -> [4, B, H', W'] u8 stacks
    eyes = forward_warp_eyes(rgb_st.contiguous(), depth_n.contiguous(),
                             params.max_disparity)

    # 7-10. per eye: postprocess, crop, sharpen, downscale
    finals = []
    for eye4, off in zip(eyes, (lo, ro)):
        out = _postprocess_eye(eye4, params.artifact_smoothing)
        img = torch.movedim(out[..., off:off + crop_w], 0, -1).to(
            torch.float32)
        if params.sharpen > 0:
            img = unsharp_mask(img, params.sharpen)
        if params.super_sampling > 1.0:
            img = resize(img, H, W, "area", channel_last=True)
        finals.append(img)
    sbs = torch.cat(finals, dim=2)
    return torch.floor(torch.clamp(sbs, 0.0, 255.0)).to(torch.uint8)
