"""
Integer-factor bilinear upsample — CUDA kernel wrapper and plain version
========================================================================

Replaces ``vsc_tpu/ops/upsample_pallas.py:upsample_bilinear_int_pallas``:
[N, H, W] float32 -> [N, H*f, W*f] with half-pixel source mapping and
clamped edges (torch ``align_corners=False``), in two modes:

  f32          the plain phase decomposition of ``ops/resize.py``
               (rows first, then columns), bit for bit; the depth plane's
               super-sampling reaches it through ``resize``
  quantize_u8  the exact floor of the bilinear value as uint8, computed in
               integers (band weights 2f - k and k, sum divided by (2f)^2):
               the RGB super-sampling of the planar-u8 stereo branch, with
               the warp's input quantization fused in. Inputs must hold
               integers in [0, 255].

Kernel source: ``csrc/upsample.cu``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from vsc_tpu_torch.ops import _cuda

__all__ = ["upsample_bilinear_int", "upsample_bilinear_int_plain",
           "MAX_FACTOR"]

MAX_FACTOR = 8   # the JAX kernel's supported range is 1 < f <= 8


@functools.lru_cache(maxsize=None)
def _weights(f: int):
    """Per output phase p the float32 (1 - w1, w1) of resize's phase
    decomposition, computed the way it computes them (the kernel derives
    the taps and the integer weights from f itself)."""
    wa, wb = [], []
    for p in range(f):
        sx = (p + 0.5) / f - 0.5
        w1 = sx - math.floor(sx)
        wa.append(1.0 - w1)
        wb.append(w1)
    wa, wb = np.asarray(wa, np.float32), np.asarray(wb, np.float32)
    wa.setflags(write=False)
    wb.setflags(write=False)
    return wa, wb


def _int_taps(n: int, f: int, device):
    """(i0, i1, w0, w1) int64 along one axis of n inputs: taps clamped into
    [0, n), integer weights 2f - k and k."""
    o = torch.arange(n * f, device=device)
    num = 2 * o - (f - 1)
    x0 = torch.div(num, 2 * f, rounding_mode="floor")
    k = num - x0 * 2 * f
    return (torch.clamp(x0, 0, n - 1), torch.clamp(x0 + 1, 0, n - 1),
            2 * f - k, k)


def upsample_bilinear_int_plain(x, factor: int, quantize_u8: bool = False):
    """The plain version: [N, H, W] float32 -> [N, H*f, W*f] float32, or
    uint8 with ``quantize_u8``."""
    if not quantize_u8:
        from vsc_tpu_torch.ops.resize import _upsample_axis_int
        return _upsample_axis_int(_upsample_axis_int(x, 1, factor), 2, factor)
    N, H, W = x.shape
    f = factor
    r0, r1, wr0, wr1 = _int_taps(H, f, x.device)
    c0, c1, wc0, wc1 = _int_taps(W, f, x.device)
    xi = x.to(torch.int32)
    rows = (xi.index_select(1, r0) * wr0[:, None].to(torch.int32)
            + xi.index_select(1, r1) * wr1[:, None].to(torch.int32))
    s = (rows.index_select(2, c0) * wc0.to(torch.int32)
         + rows.index_select(2, c1) * wc1.to(torch.int32))
    return torch.div(s, (2 * f) ** 2, rounding_mode="floor").to(torch.uint8)


def upsample_bilinear_int(x, factor: int, quantize_u8: bool = False):
    """CPU tensors: the plain version; CUDA tensors: the kernel."""
    if not 1 < factor <= MAX_FACTOR:
        raise ValueError(f"upsample: factor {factor} outside 2..{MAX_FACTOR}")
    if x.device.type == "cpu":
        return upsample_bilinear_int_plain(x, factor, quantize_u8)
    _cuda.require_cuda("upsample", x)
    if x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"upsample: need [N, H, W] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    N, H, W = x.shape
    if N > 65535:
        raise ValueError(f"upsample: {N} planes, the kernel's grid takes "
                         "65535")
    out = torch.empty((N, H * factor, W * factor),
                      dtype=torch.uint8 if quantize_u8 else torch.float32,
                      device=x.device)
    wa, wb = _weights(factor)
    code = _cuda.library().vsc_upsample(
        x.data_ptr(), out.data_ptr(), wa.ctypes.data, wb.ctypes.data, N, H,
        W, factor, int(quantize_u8), _cuda.stream_ptr(x.device))
    _cuda.check(code, "vsc_upsample")
    _cuda.LAUNCHES["upsample"] += 1
    return out
