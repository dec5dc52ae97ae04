"""
Fused finish (unsharp + integer-ratio area downscale) — CUDA kernel wrapper
===========================================================================

Replaces ``vsc_tpu/ops/finish_pallas.py``:

  sharpen_downscale_planar  [3, N, H', W'] uint8 -> [3, N, out_h, out_w]
                            uint8, the planar-u8 stereo branch's last stage
                            (optionally cropping each eye of the pair at
                            its own column offset in the kernel)
  sharpen_downscale         [B, H', W', 3] u8-valued float -> [B, out_h,
                            out_w, 3] float32, the compat branch's entry at
                            integer ratios; for W' < 129 or H' < 5 it runs
                            the unsharp + area glue, as the JAX entry does

Per output pixel: unsharp 5x5 (sigma 1, reflect-101 borders inside the
crop), clip to [0, 255], the mean of the ratio x ratio box (rows summed
first, then columns, then divided by ratio^2), and for u8 floor(clip(.)).
The plain version keeps the kernel's order of operations, so the two agree
exactly. Kernel source: ``csrc/finish.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vsc_tpu_torch.ops import _cuda

__all__ = ["sharpen_downscale_planar", "sharpen_downscale",
           "sharpen_downscale_plain", "MAX_RATIO"]

MAX_RATIO = 8


@functools.lru_cache(maxsize=None)
def _taps() -> np.ndarray:
    """The 5 taps of the unsharp gaussian (sigma 1), float32, contiguous;
    symmetric, which the kernel relies on (it checks)."""
    from vsc_tpu_torch.ops.filters import gaussian_kernel1d
    taps = np.ascontiguousarray(gaussian_kernel1d(5, 1.0), dtype=np.float32)
    taps.setflags(write=False)
    return taps


def _crop(planes, crop_w: int, offsets):
    lo, ro = offsets
    if lo == ro:
        return planes[..., lo:lo + crop_w]
    half = planes.shape[1] // 2
    return torch.cat([planes[:, :half, :, lo:lo + crop_w],
                      planes[:, half:, :, ro:ro + crop_w]], dim=1)


def sharpen_downscale_plain(planes, ratio: int, strength: float, out_h: int,
                            out_w: int, crop_w: int | None = None,
                            offsets=(0, 0), out_dtype=torch.uint8):
    """The plain version, same arguments as ``sharpen_downscale_planar``
    plus the output type (uint8 or float32)."""
    from vsc_tpu_torch.ops.filters import reflect_index
    crop_w = planes.shape[-1] if crop_w is None else crop_w
    x = _crop(planes, crop_w, offsets).to(torch.float32)
    H = x.shape[2]
    k = _taps()
    xp = x.index_select(2, reflect_index(H, 2, 2, x.device))
    xp = xp.index_select(3, reflect_index(crop_w, 2, 2, x.device))
    hconv = None
    for t in range(5):
        term = float(k[t]) * xp[..., t:t + crop_w]
        hconv = term if hconv is None else hconv + term
    blur = None
    for t in range(5):
        term = float(k[t]) * hconv[:, :, t:t + H, :]
        blur = term if blur is None else blur + term
    sharp = torch.clamp(x + strength * (x - blur), 0.0, 255.0)
    K, N = sharp.shape[:2]
    r = ratio
    s = sharp[:, :, :out_h * r, :out_w * r].reshape(K, N, out_h, r, out_w * r)
    rows = s[:, :, :, 0]
    for i in range(1, r):
        rows = rows + s[:, :, :, i]
    c = rows.reshape(K, N, out_h, out_w, r)
    total = c[..., 0]
    for j in range(1, r):
        total = total + c[..., j]
    res = total / float(r * r)
    if out_dtype == torch.uint8:
        return torch.floor(torch.clamp(res, 0.0, 255.0)).to(torch.uint8)
    return res


def _launch(planes, ratio, strength, out_h, out_w, crop_w, offsets,
            out_dtype):
    _cuda.require_cuda("sharpen_downscale", planes)
    K, N, H, Wf = planes.shape
    lo, ro = offsets
    if K != 3 or planes.dtype != torch.uint8:
        raise ValueError(f"sharpen_downscale: need [3, N, H, W] uint8, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    if not 1 <= ratio <= MAX_RATIO:
        raise ValueError(f"sharpen_downscale: ratio {ratio} outside "
                         f"1..{MAX_RATIO}")
    if 3 * N > 65535 or H * Wf >= 2**31 - 3:
        raise ValueError(f"sharpen_downscale: {tuple(planes.shape)} is past "
                         "the kernel's grid (3 N <= 65535) or its 32-bit "
                         "plane offsets")
    if (out_h * ratio > H or out_w * ratio > crop_w
            or min(lo, ro) < 0 or max(lo, ro) + crop_w > Wf
            or (lo != ro and N % 2)):
        raise ValueError(f"sharpen_downscale: crop {crop_w} at {offsets} of "
                         f"{tuple(planes.shape)} does not hold "
                         f"{out_h} x {out_w} boxes of {ratio}")
    out = torch.empty((3, N, out_h, out_w), dtype=out_dtype,
                      device=planes.device)
    taps = _taps()
    code = _cuda.library().vsc_finish(
        planes.data_ptr(), out.data_ptr(),
        taps.ctypes.data_as(ctypes.c_void_p), N, H, Wf, crop_w, lo, ro,
        N // 2 if lo != ro else N, ratio, float(strength), out_h, out_w,
        int(out_dtype == torch.uint8), _cuda.stream_ptr(planes.device))
    _cuda.check(code, "vsc_finish")
    _cuda.LAUNCHES["finish"] += 1
    return out


def sharpen_downscale_planar(planes, ratio: int, strength: float, out_h: int,
                             out_w: int, crop_w: int | None = None,
                             offsets=(0, 0)):
    """[3, N, H', W'] uint8 -> [3, N, out_h, out_w] uint8. With ``crop_w``
    the input is cropped to ``crop_w`` columns at ``offsets``: (lo, ro)
    for the first and the second half of the N frames (the left and right
    eyes of a pair). CPU tensors: the plain version; CUDA: the kernel."""
    crop_w = planes.shape[-1] if crop_w is None else crop_w
    if crop_w < 129 or planes.shape[2] < 5:
        raise ValueError("sharpen_downscale_planar: expects crops of at "
                         "least 5 x 129 (the JAX kernel's geometry)")
    if planes.device.type == "cpu":
        return sharpen_downscale_plain(planes, ratio, strength, out_h, out_w,
                                       crop_w, offsets)
    return _launch(planes, ratio, strength, out_h, out_w, crop_w, offsets,
                   torch.uint8)


def sharpen_downscale(img, ratio: int, strength: float, out_h: int,
                      out_w: int):
    """[B, H', W', 3] u8-valued float (cropped) -> [B, out_h, out_w, 3]
    float32: unsharp then the exact ratio x ratio box mean."""
    B, H, W, C = img.shape
    if W < 129 or H < 5:
        from vsc_tpu_torch.ops.filters import unsharp_mask
        from vsc_tpu_torch.ops.resize import resize
        x = unsharp_mask(img, strength) if strength > 0 else img
        x = x[:, :out_h * ratio, :out_w * ratio]
        return resize(x, out_h, out_w, "area",
                      channel_last=True).to(torch.float32)
    planes = torch.movedim(torch.floor(torch.clamp(img, 0.0, 255.0)), -1,
                           0).to(torch.uint8).contiguous()
    if planes.device.type == "cpu":
        out = sharpen_downscale_plain(planes, ratio, strength, out_h, out_w,
                                      out_dtype=torch.float32)
    else:
        out = _launch(planes, ratio, strength, out_h, out_w, W, (0, 0),
                      torch.float32)
    return torch.movedim(out, 0, -1)
