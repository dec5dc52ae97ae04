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

``_pyramid_fill_planar_coarse`` is the planar-u8 form the super-sampled
stereo branch uses: one quarter pool kernel (ops/pool_cuda.py) for the
first two levels at any frame size, the pyramid kernel
(ops/pyramid_cuda.py) for the whole ladder from there. ``_push_pull_hw``
is the plain ladder over the last two axes that both kernels' plain
versions run.
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


def _edge_even(x):
    """Edge-pad the last two axes of x to even sizes."""
    H, W = x.shape[-2], x.shape[-1]
    if not (H | W) & 1:
        return x
    iy = torch.clamp(torch.arange(H + (H & 1), device=x.device), 0, H - 1)
    ix = torch.clamp(torch.arange(W + (W & 1), device=x.device), 0, W - 1)
    return x.index_select(-2, iy).index_select(-1, ix)


def _avgpool2_hw(x):
    """2x2 average pool over the last two axes, odd dims edge-padded first:
    ((a + c) + (b + d)) * 0.25 rounding, as the jnp average of averages."""
    x = _edge_even(x)
    xh = (x[..., 0::2, :] + x[..., 1::2, :]) * 0.5
    return (xh[..., 0::2] + xh[..., 1::2]) * 0.5


def _upsample_nearest_hw(x, out_h: int, out_w: int, factor: int):
    """Nearest integer-factor upsample over the last two axes."""
    iy = torch.clamp(torch.arange(out_h, device=x.device) // factor,
                     max=x.shape[-2] - 1)
    ix = torch.clamp(torch.arange(out_w, device=x.device) // factor,
                     max=x.shape[-1] - 1)
    return x.index_select(-2, iy).index_select(-1, ix)


def _push_pull_hw(img, msk):
    """Masked push-pull of [3, B, h, w] ``img`` (already times the mask)
    under [B, h, w] ``msk``: pool to 1 x 1, fill it (img / msk), then
    combine back up level by level."""
    levels = []
    while max(msk.shape[-2], msk.shape[-1]) > 1:
        levels.append((img, msk))
        img, msk = _avgpool2_hw(img), _avgpool2_hw(msk)
    filled = img / torch.clamp(msk, min=1e-8)
    for img_l, msk_l in reversed(levels):
        up = _upsample_nearest_hw(filled, img_l.shape[-2], img_l.shape[-1], 2)
        filled = torch.where(msk_l > 1e-8, img_l / torch.clamp(msk_l, min=1e-8),
                             up)
    return filled


def _pyramid_fill_planar_coarse(eye4, quarter4=None):
    """[4, B, H, W] uint8 (r, g, b, valid) eye stack -> the [3, B, ~H/4,
    ~W/4] float32 quarter-resolution push-pull estimate, in the plane-major
    layout the postprocess kernel reads. Equal to
    ``_pyramid_fill(img, valid, coarse_factor=4, return_coarse=True)``.

    The first two levels are one ``avgpool4_eye4`` launch at any H and W:
    the kernel replicates an odd side's edge at each level itself, where
    the JAX package pools even sizes in its kernels and odd ones in jnp
    glue (the same bits). The pyramid kernel takes the whole ladder from
    the quarter, where the JAX package runs jnp levels above its
    ``VSC_TPU_PYR_KMAX`` handoff and its kernel below: the same ladder.

    ``quarter4``: the [4, B, H/4, ~W/4] float32 pooled (rgb * valid, valid)
    stack already computed (the split route's bilateral kernel emits it,
    ops/bilateral_cuda.py); the pool is skipped and ``eye4`` is unused."""
    from vsc_tpu_torch.ops.pool_cuda import avgpool4_eye4
    from vsc_tpu_torch.ops.pyramid_cuda import pyramid_fill_below
    return pyramid_fill_below(avgpool4_eye4(eye4) if quarter4 is None
                              else quarter4)


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
