"""
Stereo SBS pipeline (PyTorch)
=============================

Port of ``vsc_tpu/ops/stereo.py``, taking on every device the structure the
JAX package takes on the TPU: where it calls a Pallas kernel the port calls
its hand-written CUDA kernel (CUDA tensors) or that kernel's plain version
(CPU tensors); where it runs jnp the port runs torch glue, except the
quarter pool of step 7, one kernel at every frame size (the JAX package
pools odd sizes in jnp).

  1. pre-stretch rgb + depth by (2*max_disparity + |convergence|)/W,
     Lanczos4, integer-quantized like cv2's u8/u16 output
  2. per-frame min-max depth normalization (zeros if flat)
  3. super-sampling, bilinear                  -> upsample kernel
  4-5. gaussian edge softening + depth gamma   -> blur kernel
  6. forward warp, both eyes                   -> warp kernel
  7. postprocess on the quarter-res pyramid estimate
                                               -> pool, pyramid and
                                                  postprocess kernels
  8. convergence crop
  9-10. unsharp sharpen, area downscale (super-sampling only), floor to
     u8, SBS pack                              -> finish kernel

Two branches, chosen as the JAX package chooses them on the TPU:

  planar-u8 (``vsc_tpu/ops/stereo.py:285-351``): super-sampling at an
    integer ratio on frames large enough for the finish and postprocess
    kernels (``_planar_u8_geometry_ok``), which is the default
    ``super_sampling`` 3 at any real frame size. The RGB is upsampled
    straight to planar u8, both eyes ride one [4, 2B, H', W'] pair through
    the pyramid, the postprocess and the finish, and the finish crops each
    eye at its own offset.
  compat (``:353-389``): everything else (``super_sampling`` 1, non-integer
    ratios, tiny frames), channel-last, one eye at a time; the finish
    kernel's f32 entry at integer ratios.

The planar-u8 branch honours the JAX package's split-bilateral opt-in
(``VSC_TPU_PP_SPLIT=1``, off by default, ``vsc_tpu/ops/stereo.py:304-332``)
under the same guard: the bilateral kernel (ops/bilateral_cuda.py) filters
the pair and emits the quarter pool stack, the pyramid starts from that
stack (or from the pair's own pools under ``VSC_TPU_BF_POOL=0``), and the
postprocess runs at smoothing 0. Its SBS equals the default route's bit for
bit.

Inputs placed on a data mesh (``parallel/auto.shard_batch``, both
``Sharded`` on one mesh whose data axis has more than one device and
divides the batch) run the SPMD form of ``vsc_tpu/ops/stereo.py:392-459``:
the whole program is batch-elementwise, so each shard is converted on its
own device by the same body, with no collectives, and the result is
``Sharded`` too. Each shard allocates its own buffers (the planar pair the
warp writes in place among them), so shards that share a device share
nothing else.
"""

from __future__ import annotations

import os

import torch

from vsc_tpu_torch.config.stereo_params import StereoParams
from vsc_tpu_torch.ops.bilateral_cuda import (bilateral_pool_planar,
                                              bilateral_pool_supported)
from vsc_tpu_torch.ops.blur_cuda import gaussian_blur_planes
from vsc_tpu_torch.ops.filters import unsharp_mask
from vsc_tpu_torch.ops.finish_cuda import (sharpen_downscale,
                                           sharpen_downscale_planar)
from vsc_tpu_torch.ops.inpaint import (_pyramid_fill,
                                       _pyramid_fill_planar_coarse)
from vsc_tpu_torch.ops.postprocess_cuda import _margin, postprocess_eye
from vsc_tpu_torch.ops.resize import resize
from vsc_tpu_torch.ops.upsample_cuda import upsample_bilinear_int
from vsc_tpu_torch.ops.warp_cuda import (forward_warp_eyes,
                                         forward_warp_pair_planar)
from vsc_tpu_torch.parallel.mesh import Sharded, on_device
from vsc_tpu_torch.utils.profiling import span

__all__ = ["generate_sbs", "sbs_shapes", "StereoParams"]


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


def _planar_u8_geometry_ok(s: dict, params: StereoParams) -> bool:
    """The planar-u8 branch's small-frame gate: the finish kernel takes
    crops of at least 129 columns and 5 rows, and the JAX postprocess
    kernel's reflect-101 halo (the stencil reach rounded up to 4 rows and
    64 columns) must stay smaller than the eye."""
    need = _margin(params.artifact_smoothing)
    halo_r = -(-need // 4) * 4
    halo_c = -(-need // 64) * 64
    return (s["crop_w"] >= 129 and s["up_h"] >= 5
            and halo_r < s["up_h"] and halo_c < s["up_w"])


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


def _data_mesh_of(*inputs):
    """The mesh to run the SBS program over shard by shard, when every
    input is ``Sharded`` on one mesh whose data axis has more than one
    device and divides the batch; else None."""
    mesh = None
    for a in inputs:
        if not isinstance(a, Sharded):
            return None
        m = a.mesh
        if m.shape["data"] <= 1:
            return None
        if mesh is not None and m != mesh:
            return None
        mesh = m
        if a.shape[0] % m.shape["data"] != 0:
            return None
    return mesh


def _generate_sbs_sharded(rgb, depth, params: StereoParams, mesh):
    """The SPMD form: each shard through the unsharded body on its own
    device; no collectives."""
    parts = []
    for r, d, dev in zip(rgb.parts, depth.parts, mesh.data_devices):
        with on_device(dev):
            parts.append(_generate_sbs_spanned(r, d, params))
    return Sharded(tuple(parts), mesh)


def _generate_sbs_spanned(rgb, depth, params: StereoParams):
    """``_generate_sbs_impl`` in the device span "sbs" while tracing."""
    with span("sbs", frames=rgb.shape[0], device=rgb.is_cuda):
        return _generate_sbs_impl(rgb, depth, params)


def generate_sbs(rgb, depth, params: StereoParams | None = None):
    """Batched SBS generation.

    Args:
      rgb: [B, H, W, 3] uint8 (or float holding u8 values) tensor.
      depth: [B, H, W] uint8/uint16/float "nearness" (larger = closer).
      params: StereoParams (defaults match the reference).

    Returns:
      [B, H, 2W, 3] uint8 side-by-side frames (left | right), on the
      input's device. Inputs sharded over a data mesh (``_data_mesh_of``)
      give a ``Sharded`` result: each device converts its own frames.
      While tracing (``utils/profiling``) each device's work is a device
      span, "sbs".
    """
    params = params or StereoParams()
    mesh = _data_mesh_of(rgb, depth)
    if mesh is not None:
        return _generate_sbs_sharded(rgb, depth, params, mesh)
    if isinstance(rgb, Sharded) or isinstance(depth, Sharded):
        raise ValueError("generate_sbs: sharded inputs need one data mesh "
                         "of more than one device that divides the batch, "
                         "for rgb and depth alike")
    return _generate_sbs_spanned(rgb, depth, params)


def _generate_sbs_impl(rgb, depth, params: StereoParams):
    """``generate_sbs`` on one device."""
    depth_max = _depth_max(depth)
    B, H, W, _ = rgb.shape
    s = sbs_shapes(H, W, params)
    ratio = s["scale_ratio"]
    super_sampled = params.super_sampling > 1.0
    integer_ratio = super_sampled and float(ratio).is_integer()
    planar_u8 = integer_ratio and _planar_u8_geometry_ok(s, params)
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

    # 3. super-sampling; the planar-u8 branch upsamples the RGB channel
    # first straight to u8 (the warp's own input quantization: floor
    # commutes with its winner selection)
    up_h, up_w = s["up_h"], s["up_w"]
    if super_sampled:
        depth_n = resize(depth_n, up_h, up_w, "bilinear")
        if planar_u8:
            SW = s["stretched_w"]
            x_cf = torch.movedim(rgb_st, -1, 1)
            if up_h % H == 0 and up_w % SW == 0 and up_h // H == up_w // SW:
                rgb_st = upsample_bilinear_int(
                    x_cf.reshape(-1, H, SW).contiguous(), up_h // H,
                    quantize_u8=True).reshape(B, 3, up_h, up_w)
            else:
                rgb_st = torch.floor(torch.clamp(resize(
                    x_cf, up_h, up_w, "bilinear"), 0.0, 255.0)).to(
                        torch.uint8)
        else:
            rgb_st = resize(rgb_st, up_h, up_w, "bilinear",
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

    if planar_u8:
        # 6-10 on the [4, 2B, H', W'] pair of both eyes
        pair = forward_warp_pair_planar(
            rgb_st.contiguous(), depth_n.contiguous(), params.max_disparity)
        split = (os.environ.get("VSC_TPU_PP_SPLIT", "0") == "1"
                 and bilateral_pool_supported(up_h, up_w,
                                              params.artifact_smoothing))
        if split:
            pool_in = os.environ.get("VSC_TPU_BF_POOL", "1") != "0"
            filt, quarter4 = bilateral_pool_planar(
                pair, params.artifact_smoothing, pool=pool_in)
            smooth_q = _pyramid_fill_planar_coarse(pair, quarter4=quarter4)
            del pair
            out = postprocess_eye(filt, smooth_q, 0.0)
        else:
            smooth_q = _pyramid_fill_planar_coarse(pair)
            out = postprocess_eye(pair, smooth_q, params.artifact_smoothing)
        fin = sharpen_downscale_planar(out, int(ratio), float(params.sharpen),
                                       H, W, crop_w, (lo, ro))
        sbs = torch.cat([fin[:, :B], fin[:, B:]], dim=3)   # [3, B, H, 2W]
        return torch.movedim(sbs, 0, -1).contiguous()

    # 6. forward warp, both eyes -> [4, B, H', W'] u8 stacks
    eyes = forward_warp_eyes(rgb_st.contiguous(), depth_n.contiguous(),
                             params.max_disparity)

    # 7-10. per eye: postprocess, crop, sharpen, downscale
    finals = []
    for eye4, off in zip(eyes, (lo, ro)):
        out = _postprocess_eye(eye4, params.artifact_smoothing)
        img = torch.movedim(out[..., off:off + crop_w], 0, -1).to(
            torch.float32)
        if integer_ratio:
            img = sharpen_downscale(img, int(ratio), float(params.sharpen),
                                    H, W)
        else:
            if params.sharpen > 0:
                img = unsharp_mask(img, params.sharpen)
            if super_sampled:
                img = resize(img, H, W, "area", channel_last=True)
        finals.append(img)
    sbs = torch.cat(finals, dim=2)
    return torch.floor(torch.clamp(sbs, 0.0, 255.0)).to(torch.uint8)
