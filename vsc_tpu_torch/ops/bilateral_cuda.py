"""
Split bilateral + pyramid pool prepass — CUDA kernel wrapper and plain version
==============================================================================

Replaces ``vsc_tpu/ops/bilateral_pallas.py:bilateral_pool_planar``, which
the JAX package's planar-u8 SBS branch reaches under ``VSC_TPU_PP_SPLIT=1``
(``vsc_tpu/ops/stereo.py:315-332``): the bilateral of the warped eye pair in
a kernel of its own (the postprocess then runs at smoothing 0), and the
quarter-resolution (rgb * valid, valid) pool stack that seeds the inpaint
pyramid, from the same input. Kernel source: ``csrc/bilateral.cu``, whose
per-pixel arithmetic is the postprocess's own (``csrc/bilateral.cuh``), so
the split route's SBS equals the default route's bit for bit.

The JAX kernel's strip height (``VSC_TPU_BF_ROWS``) and tap pairing
(``VSC_TPU_PP_PAIRED``) are TPU tiling and accumulation-order choices; the
port has neither.
"""

from __future__ import annotations

import ctypes

import torch

from vsc_tpu_torch.ops import _cuda
from vsc_tpu_torch.ops.postprocess_cuda import (MAX_BILATERAL_RADIUS,
                                                bilateral_plain,
                                                bilateral_tables)

__all__ = ["bilateral_pool_planar", "bilateral_pool_plain",
           "bilateral_pool_supported", "quarter_pool_plain"]


def _radius_for(smoothing: float) -> int:
    return max(5, min(int(smoothing * 4), 15)) // 2


def bilateral_pool_supported(H: int, W: int, smoothing: float) -> bool:
    """The JAX package's route guard (``bilateral_pallas.py:164-171``), so
    the port takes the split route on the same geometries: smoothing on,
    H % 4 == 0 and W even (the pool groups), and the dims above the TPU
    kernel's reflect pads."""
    if smoothing <= 0:
        return False
    pad_r = -(-2 * _radius_for(smoothing) // 8) * 8
    return H % 4 == 0 and W % 2 == 0 and H > pad_r and W > 129


def quarter_pool_plain(eye4):
    """[4, B, H, W] uint8 -> [4, B, H/4, Wq] float32: the two-level 2x2
    average ladder of (rgb * valid, valid) as sums of 16 masked values times
    0.0625, the mid level's edge column repeated when W/2 is odd."""
    msk = eye4[3].to(torch.float32)
    x = torch.cat([eye4[:3].to(torch.float32) * msk, msk[None]])
    K, B, H, W = x.shape
    x = x.reshape(K, B, H // 4, 4, W).sum(dim=3)
    x = x.reshape(K, B, H // 4, W // 2, 2).sum(dim=4)
    if (W // 2) & 1:
        x = torch.cat([x, x[..., -1:]], dim=-1)
    x = x.reshape(K, B, H // 4, x.shape[-1] // 2, 2).sum(dim=4)
    return x * 0.0625


def bilateral_pool_plain(eye4, smoothing: float, pool: bool = True):
    """The plain version of ``bilateral_pool_planar``."""
    filt = torch.cat([bilateral_plain(eye4[:3].to(torch.float32),
                                      smoothing).to(torch.uint8), eye4[3:]])
    return filt, (quarter_pool_plain(eye4) if pool else None)


def bilateral_pool_planar(eye4, smoothing: float, pool: bool = True):
    """eye4 [4, B, H, W] uint8 (r, g, b, valid) -> (filtered [4, B, H, W]
    uint8: the bilateral of r, g, b, valid passed through; quarter
    [4, B, H/4, Wq] float32 or None when ``pool`` is off). CPU tensors: the
    plain version; CUDA tensors: the kernel."""
    K, B, H, W = eye4.shape
    if K != 4 or H % 4 or W % 2 or smoothing <= 0:
        raise ValueError(f"bilateral_pool_planar: need [4, B, H, W] with "
                         f"H % 4 == 0, even W and smoothing > 0, got "
                         f"{tuple(eye4.shape)} at smoothing {smoothing}")
    if eye4.device.type == "cpu":
        return bilateral_pool_plain(eye4, smoothing, pool)
    _cuda.require_cuda("bilateral_pool_planar", eye4)
    if eye4.dtype != torch.uint8:
        raise ValueError(f"bilateral_pool_planar: need uint8, got "
                         f"{eye4.dtype}")
    rb, space_w, inv2sc = bilateral_tables(smoothing)
    if rb > MAX_BILATERAL_RADIUS:
        raise ValueError(f"bilateral_pool_planar: the kernel takes a "
                         f"bilateral radius <= {MAX_BILATERAL_RADIUS}, got "
                         f"{rb}")
    dev = eye4.device
    out = torch.empty_like(eye4)
    quarter = None
    if pool:
        W2 = W // 2
        quarter = torch.empty((4, B, H // 4, (W2 + (W2 & 1)) // 2),
                              dtype=torch.float32, device=dev)
    code = _cuda.library().vsc_bilateral_pool(
        eye4.data_ptr(), out.data_ptr(),
        quarter.data_ptr() if pool else None,
        space_w.ctypes.data_as(ctypes.c_void_p), inv2sc, B, H, W, rb,
        _cuda.stream_ptr(dev))
    _cuda.check(code, "vsc_bilateral_pool")
    _cuda.LAUNCHES["bilateral"] += 1
    return out, quarter
