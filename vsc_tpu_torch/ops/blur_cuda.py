"""
Separable gaussian blur — CUDA kernel wrapper and plain version
===============================================================

Replaces ``vsc_tpu/ops/blur_pallas.py:gaussian_blur_pallas`` (reached
through ``vsc_tpu/ops/filters.py:gaussian_blur``): rows pass then columns
pass over a reflect-101 padded plane, taps accumulated in the jnp order,
optional ``clip(x, 0.001, 1) ** gamma`` epilogue. Kernel source:
``csrc/blur.cu``.

``gaussian_blur_planes`` runs the plain version for CPU tensors and the
kernel for CUDA tensors; there is no fallback between them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vsc_tpu_torch.ops import _cuda

__all__ = ["gaussian_blur_planes", "gaussian_blur_planes_plain"]

MAX_TAPS = 31


def gaussian_blur_planes_plain(x, ksize: int, sigma: float, gamma=None):
    """[N, H, W] float32 -> blurred [N, H, W] float32 (the jnp path's
    shift-and-accumulate, same tap order)."""
    from vsc_tpu_torch.ops.filters import gaussian_kernel1d, reflect_index
    N, H, W = x.shape
    r = ksize // 2
    k = gaussian_kernel1d(ksize, sigma)
    xp = x.index_select(1, reflect_index(H, r, r, x.device))
    xp = xp.index_select(2, reflect_index(W, r, r, x.device))
    rows = None
    for t in range(ksize):
        term = float(k[t]) * xp[:, t:t + H, :]
        rows = term if rows is None else rows + term
    out = None
    for t in range(ksize):
        term = float(k[t]) * rows[:, :, t:t + W]
        out = term if out is None else out + term
    if gamma is not None:
        out = torch.clamp(out, 0.001, 1.0) ** gamma
    return out


def gaussian_blur_planes(x, ksize: int, sigma: float, gamma=None):
    """[N, H, W] float32 planes -> blurred planes. CPU: plain version;
    CUDA: the hand-written kernel."""
    if x.device.type == "cpu":
        return gaussian_blur_planes_plain(x, ksize, sigma, gamma)
    _cuda.require_cuda("gaussian_blur", x)
    if x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"gaussian_blur: need [N, H, W] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if ksize % 2 != 1 or not 1 <= ksize <= MAX_TAPS:
        raise ValueError(f"gaussian_blur: ksize must be odd and <= "
                         f"{MAX_TAPS}, got {ksize}")
    from vsc_tpu_torch.ops.filters import gaussian_kernel1d
    N, H, W = x.shape
    out = torch.empty_like(x)
    taps = np.ascontiguousarray(gaussian_kernel1d(ksize, sigma),
                                dtype=np.float32)
    lib = _cuda.library()
    code = lib.vsc_blur(
        x.data_ptr(), out.data_ptr(),
        taps.ctypes.data_as(ctypes.c_void_p), N, H, W, ksize,
        float(gamma) if gamma is not None else 1.0,
        int(gamma is not None), _cuda.stream_ptr(x.device))
    _cuda.check(code, "vsc_blur")
    _cuda.LAUNCHES["blur"] += 1
    return out
