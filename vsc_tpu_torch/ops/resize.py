"""
Resampling (PyTorch)
====================

Port of ``vsc_tpu/ops/resize.py``: every resize as a static tap table of
(source index, weight) pairs per output coordinate, applied with one
``index_select`` + multiply-add per tap and axis. The numpy table builders
are copied rather than imported, because importing anything under
``vsc_tpu.ops`` pulls in jax.

  lanczos4  cv2 INTER_LANCZOS4, weights on cv2's 1/2048 fixed-point grid
  bilinear  F.interpolate(bilinear, align_corners=False) == cv2 INTER_LINEAR
  area      F.interpolate(area) == adaptive average pooling
  cubic     cv2 INTER_CUBIC on a float image: Keys' cubic with a = -0.75,
            4 taps at the half-pixel source position (no widening when it
            shrinks), the edge pixel replicated past the border, the
            weights in float32 as cv2 computes them (Depth Anything V2's
            input resize; not in the JAX package, which has no such model)

Integer-factor bilinear upsampling and integer-factor area downscaling take
the same phase-decomposition / reshape-mean forms as the reference, so the
arithmetic (and its rounding) is the same. A bilinear upsample by the same
integer factor on both axes of a CUDA tensor runs the upsample kernel
(ops/upsample_cuda.py, bit-identical to the phase decomposition), as the
JAX package routes it to its Pallas kernel on the TPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize", "resize_taps"]


def _lanczos4_taps(src: int, dst: int):
    scale = src / dst
    idx = np.zeros((dst, 8), np.int32)
    wgt = np.zeros((dst, 8), np.float32)
    for o in range(dst):
        sx = (o + 0.5) * scale - 0.5
        x0 = int(np.floor(sx))
        taps = np.arange(x0 - 3, x0 + 5)
        t = sx - taps
        with np.errstate(invalid="ignore", divide="ignore"):
            w = np.where(
                np.abs(t) < 1e-9, 1.0,
                np.where(np.abs(t) < 4.0,
                         4.0 * np.sin(np.pi * t) * np.sin(np.pi * t / 4.0)
                         / (np.pi * np.pi * t * t),
                         0.0))
        w = w / w.sum()
        w = np.round(w * 2048.0) / 2048.0  # cv2 fixed-point coefficient grid
        idx[o] = np.clip(taps, 0, src - 1)
        wgt[o] = w
    return idx, wgt


def _bilinear_taps(src: int, dst: int):
    scale = src / dst
    idx = np.zeros((dst, 2), np.int32)
    wgt = np.zeros((dst, 2), np.float32)
    for o in range(dst):
        sx = (o + 0.5) * scale - 0.5
        x0 = int(np.floor(sx))
        f = sx - x0
        idx[o] = [np.clip(x0, 0, src - 1), np.clip(x0 + 1, 0, src - 1)]
        wgt[o] = [1.0 - f, f]
    return idx, wgt


def _cubic_taps(src: int, dst: int):
    """cv2's INTER_CUBIC table (``interpolateCubic``): the source position
    (o + 0.5) * scale - 0.5 in float32 with scale = 1 / (dst / src) in
    double, its floor sx, taps sx - 1 .. sx + 2 clamped to the image."""
    scale = 1.0 / (dst / src)
    fx = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx)
    x = (fx - sx).astype(np.float32)
    a, one = np.float32(-0.75), np.float32(1.0)
    x1, y = x + one, one - x
    w = np.empty((dst, 4), np.float32)
    w[:, 0] = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    w[:, 1] = ((a + 2) * x - (a + 3)) * x * x + one
    w[:, 2] = ((a + 2) * y - (a + 3)) * y * y + one
    w[:, 3] = one - w[:, 0] - w[:, 1] - w[:, 2]
    idx = np.clip(sx.astype(np.int64)[:, None] + np.arange(-1, 3), 0, src - 1)
    return idx.astype(np.int32), w


def _area_taps(src: int, dst: int):
    """Output o averages [floor(o*src/dst), ceil((o+1)*src/dst)); narrower
    windows zero-pad their trailing taps."""
    starts = [(o * src) // dst for o in range(dst)]
    ends = [-((-(o + 1) * src) // dst) for o in range(dst)]
    T = max(e - s for s, e in zip(starts, ends))
    idx = np.zeros((dst, T), np.int32)
    wgt = np.zeros((dst, T), np.float32)
    for o, (s, e) in enumerate(zip(starts, ends)):
        n = e - s
        idx[o, :n] = np.arange(s, e)
        wgt[o, :n] = 1.0 / n
    return idx, wgt


_BUILDERS = {
    "lanczos4": _lanczos4_taps,
    "bilinear": _bilinear_taps,
    "area": _area_taps,
    "cubic": _cubic_taps,
}


@functools.lru_cache(maxsize=512)
def resize_taps(src: int, dst: int, method: str):
    """Cached (indices [dst, T] int32, weights [dst, T] float32)."""
    if method not in _BUILDERS:
        raise ValueError(f"unknown resize method: {method}")
    return _BUILDERS[method](src, dst)


@functools.lru_cache(maxsize=512)
def _taps_on(src: int, dst: int, method: str, device: str):
    idx, wgt = resize_taps(src, dst, method)
    return (torch.as_tensor(idx.astype(np.int64)).to(device),
            torch.as_tensor(wgt).to(device))


def _clamped(img, axis: int, delta: int):
    """img[clip(i + delta, 0, n-1)] along ``axis`` (edge replication)."""
    if delta == 0:
        return img
    n = img.shape[axis]
    idx = torch.clamp(torch.arange(n, device=img.device) + delta, 0, n - 1)
    return img.index_select(axis, idx)


def _upsample_axis_int(img, axis: int, factor: int):
    """Integer-factor bilinear upsample as a phase decomposition: out[f*i+p]
    is a fixed 2-tap blend of two edge-clamped shifted views."""
    f = factor
    phases = []
    for p in range(f):
        sx = (p + 0.5) / f - 0.5
        x0 = int(np.floor(sx))
        w1 = sx - x0
        a = _clamped(img, axis, x0)
        if w1 == 0.0:
            phases.append(a)
        else:
            phases.append((1.0 - w1) * a + w1 * _clamped(img, axis, x0 + 1))
    out = torch.stack(phases, dim=axis + 1)
    shape = list(img.shape)
    shape[axis] = img.shape[axis] * f
    return out.reshape(shape)


def _area_axis_int(img, axis: int, factor: int):
    """Integer-factor area downscale == non-overlapping mean pooling."""
    shape = list(img.shape)
    shape[axis] = img.shape[axis] // factor
    shape.insert(axis + 1, factor)
    return img.reshape(shape).mean(dim=axis + 1)


def _resample_axis(img, axis: int, dst: int, method: str):
    src = img.shape[axis]
    if src == dst:
        return img
    if method == "bilinear" and dst % src == 0:
        return _upsample_axis_int(img, axis, dst // src)
    if method == "area" and src % dst == 0:
        return _area_axis_int(img, axis, src // dst)
    idx, wgt = _taps_on(src, dst, method, str(img.device))
    w_shape = [1] * img.ndim
    w_shape[axis] = dst
    out = None
    for t in range(idx.shape[1]):
        term = img.index_select(axis, idx[:, t]) * wgt[:, t].reshape(w_shape)
        out = term if out is None else out + term
    return out


def resize(img, out_h: int, out_w: int, method: str = "bilinear",
           channel_last: bool = False):
    """Resize a float tensor to (out_h, out_w). Spatial dims are the last
    two axes, or (-3, -2) with ``channel_last`` ([..., H, W, C])."""
    h_axis = img.ndim - (3 if channel_last else 2)
    H, W = img.shape[h_axis], img.shape[h_axis + 1]
    if (method == "bilinear" and img.device.type != "cpu" and H and W
            and out_h % H == 0 and out_w % W == 0
            and out_h // H == out_w // W and out_h > H):
        from vsc_tpu_torch.ops.upsample_cuda import upsample_bilinear_int
        dt = img.dtype
        x = img.to(torch.float32)
        if channel_last:
            x = torch.movedim(x, -1, -3)
        lead = x.shape[:-2]
        out = upsample_bilinear_int(x.reshape(-1, H, W).contiguous(),
                                    out_h // H).reshape(*lead, out_h, out_w)
        if channel_last:
            out = torch.movedim(out, -3, -1)
        return out.to(dt)
    img = _resample_axis(img, h_axis, out_h, method)
    return _resample_axis(img, h_axis + 1, out_w, method)
