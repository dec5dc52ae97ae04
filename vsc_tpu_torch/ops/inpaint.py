"""
Hole filling (PyTorch)
======================

Port of ``vsc_tpu/ops/inpaint.py``: the masked push-pull pyramid estimate
(``_pyramid_fill``) that serves hole interiors beyond the frontier sweeps'
reach, its nearest upsample, and the Telea-like ``pyramid_inpaint``
(radius-2 inverse-distance frontier sweeps + a radius-3 polish) on
edge-replicated borders. The stereo path computes the quarter-resolution
estimate here and hands it to the postprocess kernel, which does the sweeps
and polish itself (ops/postprocess_cuda.py).
"""

from __future__ import annotations

import math

import torch

__all__ = ["pyramid_inpaint", "disc_offsets"]


def disc_offsets(radius: int):
    """(dy, dx, 1/hypot) over the disc dy^2 + dx^2 <= radius^2 + 1, minus
    the center, in row-major order."""
    return [(dy, dx, 1.0 / math.hypot(dy, dx))
            for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if (dy, dx) != (0, 0) and dy * dy + dx * dx <= radius * radius + 1]


_RADIUS = 2
_SWEEPS = 3
_POLISH_RADIUS = 3
_OFFSETS = disc_offsets(_RADIUS)
_POLISH_OFFSETS = disc_offsets(_POLISH_RADIUS)


def _pad_edge_hw(x, ph: int, pw: int):
    """Edge-replicate pad of [B, H, W, C] on the spatial axes."""
    H, W = x.shape[1], x.shape[2]
    iy = torch.clamp(torch.arange(-ph, H + ph, device=x.device), 0, H - 1)
    ix = torch.clamp(torch.arange(-pw, W + pw, device=x.device), 0, W - 1)
    return x.index_select(1, iy).index_select(2, ix)


def _avgpool2(x):
    """2x2 average pool of [B, H, W, C] (odd dims edge-padded first)."""
    H, W = x.shape[1], x.shape[2]
    if (H | W) & 1:
        iy = torch.clamp(torch.arange(H + (H & 1), device=x.device), 0, H - 1)
        ix = torch.clamp(torch.arange(W + (W & 1), device=x.device), 0, W - 1)
        x = x.index_select(1, iy).index_select(2, ix)
    xh = (x[:, 0::2] + x[:, 1::2]) * 0.5
    return (xh[:, :, 0::2] + xh[:, :, 1::2]) * 0.5


def _upsample_nearest(x, out_h: int, out_w: int, factor: int):
    """Nearest integer-factor upsample over axes (1, 2):
    out[i] = x[min(i // factor, n - 1)]."""
    iy = torch.clamp(torch.arange(out_h, device=x.device) // factor,
                     max=x.shape[1] - 1)
    ix = torch.clamp(torch.arange(out_w, device=x.device) // factor,
                     max=x.shape[2] - 1)
    return x.index_select(1, iy).index_select(2, ix)


def _pyramid_fill(image, valid, coarse_factor: int = 1,
                  return_coarse: bool = False):
    """Masked push-pull estimate of [B, H, W, C] ``image`` under
    [B, H, W, 1] ``valid``, starting from a pooled level when
    ``coarse_factor`` > 1; ``return_coarse`` returns it at that level."""
    out_h, out_w = image.shape[1], image.shape[2]
    img, msk = image * valid, valid
    for _ in range(max(coarse_factor, 1).bit_length() - 1):
        img, msk = _avgpool2(img), _avgpool2(msk)
    levels = []
    size = max(img.shape[1], img.shape[2])
    while size > 1:
        levels.append((img, msk))
        img, msk = _avgpool2(img), _avgpool2(msk)
        size = (size + 1) // 2
    filled = img / torch.clamp(msk, min=1e-8)
    for img, msk in reversed(levels):
        up = _upsample_nearest(filled, img.shape[1], img.shape[2], 2)
        local = img / torch.clamp(msk, min=1e-8)
        filled = torch.where(msk > 1e-8, local, up)
    if return_coarse:
        return filled
    if filled.shape[1] != out_h or filled.shape[2] != out_w:
        filled = _upsample_nearest(filled, out_h, out_w, coarse_factor)
    return filled


def _frontier_sweep(val, known):
    B, H, W, C = val.shape
    R = _RADIUS
    vp = _pad_edge_hw(val, R, R)
    kp = torch.nn.functional.pad(known, (0, 0, R, R, R, R))
    num = torch.zeros_like(val)
    den = torch.zeros_like(known)
    for dy, dx, w in _OFFSETS:
        v = vp[:, R + dy:R + dy + H, R + dx:R + dx + W, :]
        k = kp[:, R + dy:R + dy + H, R + dx:R + dx + W, :]
        num = num + (w * k) * v
        den = den + w * k
    cand = num / torch.clamp(den, min=1e-8)
    reachable = den > 1e-8
    new_val = torch.where(known > 0, val, torch.where(reachable, cand, val))
    new_known = torch.maximum(known, reachable.to(known.dtype))
    return new_val, new_known


def pyramid_inpaint(image, hole_mask):
    """Fill the holes of [B, H, W, C] ``image`` where [B, H, W]
    ``hole_mask`` is 1; valid pixels come back unchanged."""
    valid = (1.0 - hole_mask.to(image.dtype))[..., None]
    B, H, W, C = image.shape
    smooth = _pyramid_fill(image, valid)
    val, known = image * valid, valid
    for _ in range(_SWEEPS):
        val, known = _frontier_sweep(val, known)
    out = torch.where(valid > 0, image, torch.where(known > 0, val, smooth))
    R = _POLISH_RADIUS
    wsum = sum(w for _, _, w in _POLISH_OFFSETS)
    padded = _pad_edge_hw(out, R, R)
    acc = torch.zeros_like(out)
    for dy, dx, wgt in _POLISH_OFFSETS:
        acc = acc + wgt * padded[:, R + dy:R + dy + H, R + dx:R + dx + W, :]
    return torch.where(valid > 0, out, acc / wsum)
