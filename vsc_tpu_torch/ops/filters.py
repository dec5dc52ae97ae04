"""
Image filters (PyTorch)
=======================

Port of ``vsc_tpu/ops/filters.py`` with the same numerics:

  gaussian_blur     separable, reflect-101 borders, kornia tap order; on CUDA
                    tensors it runs the hand-written blur kernel
                    (ops/blur_cuda.py), on CPU tensors that kernel's plain
                    version
  unsharp_mask      img + s * (img - gaussian5x5(img, sigma=1)), clamped
  bilateral_filter  cv2.bilateralFilter laws for u8-valued colors
  dilate3x3         binary 3x3 dilation, zero outside the image
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["gaussian_blur", "unsharp_mask", "bilateral_filter", "dilate3x3",
           "gaussian_kernel1d", "reflect_index"]


@functools.lru_cache(maxsize=64)
def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """Normalized 1-D gaussian over a centered window (kornia semantics:
    x = arange(ksize) - (ksize-1)/2, w = exp(-x^2 / (2 sigma^2)), w /= sum)."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    w = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (w / w.sum()).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _reflect_np(n: int, before: int, after: int) -> np.ndarray:
    return np.pad(np.arange(n), (before, after), mode="reflect")


def reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source indices of a reflect-101 pad (``jnp.pad(mode="reflect")``,
    repeated reflection when the pad exceeds the axis)."""
    return torch.as_tensor(_reflect_np(n, before, after)).to(device)


def _reflect_pad_hw(img, ph: int, pw: int, channel_last: bool):
    h_axis = img.ndim - (3 if channel_last else 2)
    img = img.index_select(
        h_axis, reflect_index(img.shape[h_axis], ph, ph, img.device))
    return img.index_select(
        h_axis + 1, reflect_index(img.shape[h_axis + 1], pw, pw, img.device))


def gaussian_blur(img, ksize: int, sigma: float, channel_last: bool = False,
                  gamma=None):
    """Separable gaussian blur with reflect-101 borders over the last two
    axes (or (-3, -2) with ``channel_last``). ``gamma`` applies
    clip(x, 0.001, 1) ** gamma after the blur (fused into the kernel's
    epilogue on CUDA)."""
    from vsc_tpu_torch.ops.blur_cuda import gaussian_blur_planes
    dt = img.dtype
    x = img.to(torch.float32)
    if channel_last:
        x = torch.movedim(x, -1, -3)
    lead = x.shape[:-2]
    H, W = x.shape[-2:]
    out = gaussian_blur_planes(x.reshape(-1, H, W).contiguous(), ksize,
                               sigma, gamma=gamma).reshape(*lead, H, W)
    if channel_last:
        out = torch.movedim(out, -3, -1)
    return out.to(dt)


def unsharp_mask(img, strength: float, channel_last: bool = True):
    """img + strength * (img - gaussian5x5(img, sigma=1)), clamped to
    [0, 255]."""
    blurred = gaussian_blur(img, 5, 1.0, channel_last=channel_last)
    return torch.clamp(img + strength * (img - blurred), 0.0, 255.0)


def bilateral_filter(img, d: int, sigma_color: float, sigma_space: float):
    """cv2.bilateralFilter laws on [..., H, W, C] floats holding u8 values:
    disc dx^2+dy^2 <= (d//2)^2, space weight exp(-r^2 / (2 sigma_s^2)),
    color weight exp(-(L1 color distance)^2 / (2 sigma_c^2)), reflect-101
    borders, normalized by the summed weights."""
    radius = d // 2
    padded = _reflect_pad_hw(img, radius, radius, channel_last=True)
    H, W = img.shape[-3], img.shape[-2]
    gauss_color = -0.5 / (sigma_color * sigma_color)
    gauss_space = -0.5 / (sigma_space * sigma_space)
    num = torch.zeros_like(img)
    den = torch.zeros(img.shape[:-1] + (1,), dtype=img.dtype,
                      device=img.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            r2 = dx * dx + dy * dy
            if r2 > radius * radius:
                continue
            sw = math.exp(gauss_space * r2)
            shifted = padded[..., radius + dy: radius + dy + H,
                             radius + dx: radius + dx + W, :]
            cdiff = torch.sum(torch.abs(shifted - img), dim=-1, keepdim=True)
            wgt = sw * torch.exp(gauss_color * (cdiff * cdiff))
            num = num + wgt * shifted
            den = den + wgt
    return num / den


def dilate3x3(mask):
    """Binary 3x3 dilation (one iteration) on [..., H, W] masks, zero
    outside the image."""
    H, W = mask.shape[-2], mask.shape[-1]
    padded = torch.nn.functional.pad(mask, (1, 1, 1, 1))
    out = mask
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            out = torch.maximum(
                out, padded[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    return out
