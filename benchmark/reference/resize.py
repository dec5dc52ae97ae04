"""
Plain resampling for the reference
==================================

A frozen copy of ``vsc_tpu_torch/ops/resize.py`` as of commit 0b643e2,
without its kernel route: every resize as a table of (source index,
weight) taps per output coordinate (cv2's Lanczos4 on its 1/2048 grid,
bilinear with half-pixel centres, area), integer bilinear upsampling as a
phase decomposition and integer area downscaling as a mean, so its
rounding is the program's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize", "upsample_axis_int"]


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
                         / (np.pi * np.pi * t * t), 0.0))
        w = w / w.sum()
        w = np.round(w * 2048.0) / 2048.0
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


def _area_taps(src: int, dst: int):
    starts = [(o * src) // dst for o in range(dst)]
    ends = [-((-(o + 1) * src) // dst) for o in range(dst)]
    T = max(e - s for s, e in zip(starts, ends))
    idx = np.zeros((dst, T), np.int32)
    wgt = np.zeros((dst, T), np.float32)
    for o, (s, e) in enumerate(zip(starts, ends)):
        idx[o, :e - s] = np.arange(s, e)
        wgt[o, :e - s] = 1.0 / (e - s)
    return idx, wgt


_BUILDERS = {"lanczos4": _lanczos4_taps, "bilinear": _bilinear_taps,
             "area": _area_taps}


@functools.lru_cache(maxsize=64)
def _taps(src: int, dst: int, method: str, device: str):
    idx, wgt = _BUILDERS[method](src, dst)
    return (torch.as_tensor(idx.astype(np.int64)).to(device),
            torch.as_tensor(wgt).to(device))


def _clamped(img, axis: int, delta: int):
    if delta == 0:
        return img
    n = img.shape[axis]
    idx = torch.clamp(torch.arange(n, device=img.device) + delta, 0, n - 1)
    return img.index_select(axis, idx)


def upsample_axis_int(img, axis: int, f: int):
    """Integer-factor bilinear upsample along ``axis`` as a phase
    decomposition of two edge-clamped shifted views."""
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


def _resample_axis(img, axis: int, dst: int, method: str):
    src = img.shape[axis]
    if src == dst:
        return img
    if method == "bilinear" and dst % src == 0:
        return upsample_axis_int(img, axis, dst // src)
    if method == "area" and src % dst == 0:
        shape = list(img.shape)
        shape[axis] = dst
        shape.insert(axis + 1, src // dst)
        return img.reshape(shape).mean(dim=axis + 1)
    idx, wgt = _taps(src, dst, method, str(img.device))
    w_shape = [1] * img.ndim
    w_shape[axis] = dst
    out = None
    for t in range(idx.shape[1]):
        term = img.index_select(axis, idx[:, t]) * wgt[:, t].reshape(w_shape)
        out = term if out is None else out + term
    return out


def resize(img, out_h: int, out_w: int, method: str = "bilinear",
           channel_last: bool = False):
    """Resize a float tensor over its last two axes, or (-3, -2) with
    ``channel_last``."""
    h_axis = img.ndim - (3 if channel_last else 2)
    img = _resample_axis(img, h_axis, out_h, method)
    return _resample_axis(img, h_axis + 1, out_w, method)
