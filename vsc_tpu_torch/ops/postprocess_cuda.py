"""
Per-eye postprocess — CUDA kernel wrapper and plain version
===========================================================

Replaces ``vsc_tpu/ops/postprocess_pallas.py:postprocess_eye_planar_pallas``
(compat entry ``postprocess_eye_pallas``, reached from
``vsc_tpu/ops/stereo.py:_postprocess_eye``). Kernel source:
``csrc/postprocess.cu``.

It ports the Pallas kernel's semantics, not the jnp path's. Over the image
plus a margin of M = rb + 1 + 2 * SWEEPS + 3 pixels (the kernel's total
stencil reach; rb is the bilateral radius), with the colors
reflect-101 padded and the valid plane zero outside the image:

  1. bilateral (cv2 laws: d = max(5, min(int(4s), 15)), sigma_color 30,
     sigma_space 25s, L1 color distance, disc dy^2 + dx^2 <= r^2), then
     floor(clip(round(.))), on the image (``bilateral_plain``); a margin
     pixel takes the value of the image pixel it reflects, so the split
     route (ops/bilateral_cuda.py, then this at smoothing 0) equals this
     bit for bit; skipped when smoothing == 0;
  2. hole = 3x3 dilation of (not valid) inside the image; keep = not hole;
  3. up to SWEEPS = 3 radius-2 frontier sweeps (disc dy^2 + dx^2 <= r^2 + 1,
     1/hypot weights) from the kept in-image pixels; margin pixels take
     part like any other, exactly as inside the kernel's halo window;
  4. in-image pixels no sweep reached take the 4x-nearest expansion of the
     quarter-resolution pyramid estimate;
  5. one radius-3 polish over the hole pixels, divided by the full weight
     sum; round(clip(.)) to u8.

The Pallas kernel's early sweep exit and per-column skip change nothing
inside the image, so neither appears here.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from vsc_tpu_torch.ops import _cuda
from vsc_tpu_torch.ops.inpaint import disc_offsets

__all__ = ["postprocess_eye", "postprocess_eye_plain", "bilateral_geometry",
           "bilateral_plain", "bilateral_tables", "margin_chans"]

SIGMA_COLOR = 30.0
FILL_RADIUS = 2
SWEEPS = 3
POLISH_RADIUS = 3
_FILL_OFFS = disc_offsets(FILL_RADIUS)
_POLISH_OFFS = disc_offsets(POLISH_RADIUS)
MAX_BILATERAL_RADIUS = 7


def bilateral_geometry(smoothing: float):
    """(radius, [(dy, dx, space weight)]) of the bilateral disc, row-major,
    center excluded; radius 0 when smoothing is off."""
    if smoothing <= 0:
        return 0, []
    d = max(5, min(int(smoothing * 4), 15))
    r = d // 2
    sigma_space = smoothing * 25.0
    offs = [(dy, dx, math.exp(-0.5 * (dy * dy + dx * dx)
                              / (sigma_space * sigma_space)))
            for dy in range(-r, r + 1) for dx in range(-r, r + 1)
            if (dy, dx) != (0, 0) and dy * dy + dx * dx <= r * r]
    return r, offs


def bilateral_tables(smoothing: float):
    """(radius, space weights float32 in the disc's row-major order,
    inv2sc) as the kernels take them from the host."""
    rb, boffs = bilateral_geometry(smoothing)
    return (rb, np.asarray([w for _, _, w in boffs], dtype=np.float32),
            -0.5 / (SIGMA_COLOR * SIGMA_COLOR))


def bilateral_plain(rgb, smoothing: float):
    """[3, B, H, W] float32 (u8 values) -> the bilateral-filtered planes,
    floor(clip(round(num / den), 0, 255)), reflect-101 borders; the
    accumulation order the kernels' shared device function runs
    (csrc/bilateral.cuh)."""
    from vsc_tpu_torch.ops.filters import reflect_index
    _, B, H, W = rgb.shape
    dev = rgb.device
    rb, boffs = bilateral_geometry(smoothing)
    x = rgb.index_select(2, reflect_index(H, rb, rb, dev))
    x = x.index_select(3, reflect_index(W, rb, rb, dev))
    inv2sc = -0.5 / (SIGMA_COLOR * SIGMA_COLOR)
    num = rgb + 0.0
    den = torch.ones((B, H, W), dtype=torch.float32, device=dev)
    for dy, dx, sw in boffs:
        sh = x[..., rb + dy:rb + dy + H, rb + dx:rb + dx + W]
        cdiff = (torch.abs(sh[0] - rgb[0]) + torch.abs(sh[1] - rgb[1])
                 + torch.abs(sh[2] - rgb[2]))
        wgt = sw * torch.exp(inv2sc * (cdiff * cdiff))
        num = num + wgt * sh
        den = den + wgt
    return torch.floor(torch.clamp(torch.round(num / den), 0.0, 255.0))


def _margin(smoothing: float) -> int:
    rb, _ = bilateral_geometry(smoothing)
    return rb + 1 + FILL_RADIUS * SWEEPS + POLISH_RADIUS


def margin_chans(eye4, smoothing: float):
    """Stage 1 over the image and its margin: [3, B, H + 2M, W + 2M]
    float32, the bilateral of the image (none at smoothing 0) reflected
    101 into the margin M = ``_margin(smoothing)``."""
    from vsc_tpu_torch.ops.filters import reflect_index
    H, W = eye4.shape[-2:]
    M = _margin(smoothing)
    chans = eye4[:3].to(torch.float32)
    if smoothing > 0:
        chans = bilateral_plain(chans, smoothing)
    chans = chans.index_select(2, reflect_index(H, M, M, eye4.device))
    return chans.index_select(3, reflect_index(W, M, M, eye4.device))


def _shift(x, dy: int, dx: int):
    """shifted[..., y, x] = x[..., y+dy, x+dx], zero beyond the array."""
    H, W = x.shape[-2:]
    p = max(abs(dy), abs(dx))
    xp = torch.nn.functional.pad(x, (p, p, p, p))
    return xp[..., p + dy:p + dy + H, p + dx:p + dx + W]


def postprocess_eye_plain(eye4, smooth_q, smoothing: float):
    """eye4 [4, B, H, W] uint8 (r, g, b, valid), smooth_q [3, B, Hq, Wq]
    float32 quarter-res estimate -> [3, B, H, W] uint8."""
    _, B, H, W = eye4.shape
    dev = eye4.device
    M = _margin(smoothing)
    Hd, Wd = H + 2 * M, W + 2 * M

    # 1. bilateral on the image, then the margin reflects it
    chans = margin_chans(eye4, smoothing)

    # 2. dilated hole mask, zero outside the image
    inimg = torch.zeros((Hd, Wd), dtype=torch.float32, device=dev)
    inimg[M:M + H, M:M + W] = 1.0
    valid = torch.nn.functional.pad((eye4[3] > 0).to(torch.float32),
                                    (M, M, M, M))
    hole_raw = inimg * (1.0 - valid)
    hole = hole_raw
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                hole = torch.maximum(hole, _shift(hole_raw, dy, dx))
    keep = 1.0 - hole * inimg
    known = keep * inimg

    # 3. frontier sweeps
    v = chans * known
    for _ in range(SWEEPS):
        acc3 = torch.zeros_like(v)
        acck = torch.zeros_like(known)
        for dy, dx, w in _FILL_OFFS:
            wk = w * _shift(known, dy, dx)
            acc3 = acc3 + wk * _shift(v, dy, dx)
            acck = acck + wk
        reach = (acck > 1e-8).to(torch.float32)
        upd = (1.0 - known) * reach
        inv_den = 1.0 / torch.clamp(acck, min=1e-8)
        v = v * (1.0 - upd) + (acc3 * inv_den) * upd
        known = torch.maximum(known, reach)

    # 4. unreached interior -> quarter-res estimate (4x nearest)
    iy = torch.clamp((torch.arange(Hd, device=dev) - M) // 4, 0,
                     smooth_q.shape[2] - 1)
    ix = torch.clamp((torch.arange(Wd, device=dev) - M) // 4, 0,
                     smooth_q.shape[3] - 1)
    smooth = smooth_q.index_select(2, iy).index_select(3, ix)
    val = torch.where(keep > 0, chans, torch.where(known > 0, v, smooth))

    # 5. polish
    wsum = sum(w for _, _, w in _POLISH_OFFS)
    acc = torch.zeros_like(val)
    for dy, dx, w in _POLISH_OFFS:
        acc = acc + w * _shift(val, dy, dx)
    val = torch.where(keep > 0, val, acc / wsum)
    out = val[..., M:M + H, M:M + W]
    return torch.round(torch.clamp(out, 0.0, 255.0)).to(torch.uint8)


def postprocess_eye(eye4, smooth_q, smoothing: float):
    """CPU tensors: the plain version; CUDA tensors: the kernel chain."""
    if eye4.device.type == "cpu" and smooth_q.device.type == "cpu":
        return postprocess_eye_plain(eye4, smooth_q, smoothing)
    _cuda.require_cuda("postprocess_eye", eye4, smooth_q)
    K, B, H, W = eye4.shape
    if (K != 4 or eye4.dtype != torch.uint8
            or smooth_q.dtype != torch.float32 or smooth_q.shape[0] != 3
            or smooth_q.shape[1] != B):
        raise ValueError(f"postprocess_eye: need eye4 [4,B,H,W] uint8 and "
                         f"smooth_q [3,B,Hq,Wq] float32, got "
                         f"{tuple(eye4.shape)} {eye4.dtype}, "
                         f"{tuple(smooth_q.shape)} {smooth_q.dtype}")
    Hq, Wq = smooth_q.shape[2:]
    if Hq <= (H - 1) // 4 or Wq <= (W - 1) // 4:
        raise ValueError("postprocess_eye: smooth_q does not cover the eye")
    rb, space_w, inv2sc = bilateral_tables(smoothing)
    if rb > MAX_BILATERAL_RADIUS:
        raise ValueError(f"postprocess_eye: the kernel takes a bilateral "
                         f"radius <= {MAX_BILATERAL_RADIUS}, got {rb}")
    tables = np.concatenate([np.asarray(
        [w for _, _, w in _FILL_OFFS] + [w for _, _, w in _POLISH_OFFS]
        + [sum(w for _, _, w in _POLISH_OFFS), inv2sc], dtype=np.float32),
        space_w])
    M = _margin(smoothing)
    Hd, Wd = H + 2 * M, W + 2 * M
    dev = eye4.device
    out = torch.empty((3, B, H, W), dtype=torch.uint8, device=dev)
    chans = torch.empty((3, B, Hd, Wd), dtype=torch.uint8, device=dev)
    keep = torch.empty((B, Hd, Wd), dtype=torch.uint8, device=dev)
    v = [torch.empty((3, B, Hd, Wd), dtype=torch.float32, device=dev)
         for _ in range(2)]
    k = [torch.empty((B, Hd, Wd), dtype=torch.uint8, device=dev)
         for _ in range(2)]
    code = _cuda.library().vsc_postprocess(
        eye4.data_ptr(), smooth_q.data_ptr(), out.data_ptr(),
        chans.data_ptr(), v[0].data_ptr(), v[1].data_ptr(),
        k[0].data_ptr(), k[1].data_ptr(), keep.data_ptr(),
        tables.ctypes.data_as(ctypes.c_void_p),
        B, H, W, Hq, Wq, M, rb, _cuda.stream_ptr(dev))
    _cuda.check(code, "vsc_postprocess")
    _cuda.LAUNCHES["postprocess"] += 1
    return out
