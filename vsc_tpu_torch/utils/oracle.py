"""
Reference-semantics oracle
==========================

The port's copy of ``tests/oracle.py``: an independent torch+cv2+numpy
implementation of the reference pipeline's compute semantics (the
reference project's ``helper/stereo_core.py``), used ONLY as ground truth:
by ``vsc_tpu_torch.bench``'s SSIM quality gate and in golden tests. It
follows the documented stage behavior: Lanczos4 pre-stretch, min-max depth
normalization, bilinear super-sampling, kornia-style gaussian edge
softening (normalized kernel, reflect padding), depth gamma, depth-sorted
two-pass splat warp, cv2 bilateral + Telea inpaint post-processing,
convergence crop, unsharp mask, area downscale. Its code is the test
oracle's, with the port's ``StereoParams``.
"""

from __future__ import annotations

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from vsc_tpu_torch.config import StereoParams


def gaussian_blur2d(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """kornia.filters.gaussian_blur2d semantics: normalized centered 1-D
    gaussian, separable, reflect padding."""
    coords = torch.arange(ksize, dtype=torch.float32) - (ksize - 1) / 2.0
    k = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    k = k / k.sum()
    c = x.shape[1]
    kx = k.view(1, 1, 1, ksize).repeat(c, 1, 1, 1)
    ky = k.view(1, 1, ksize, 1).repeat(c, 1, 1, 1)
    r = ksize // 2
    x = F.pad(x, (r, r, 0, 0), mode="reflect")
    x = F.conv2d(x, kx, groups=c)
    x = F.pad(x, (0, 0, r, r), mode="reflect")
    x = F.conv2d(x, ky, groups=c)
    return x


def normalize_depth(depth: torch.Tensor) -> torch.Tensor:
    d_min, d_max = depth.min(), depth.max()
    if d_max - d_min < 1e-6:
        return torch.zeros_like(depth)
    return (depth - d_min) / (d_max - d_min)


def forward_warp_stereo(image: torch.Tensor, depth: torch.Tensor,
                        max_disparity: float):
    """Depth-sorted two-pass splat, exactly the reference scheme
    (stereo_core.py:110-190): floor scatter with weight 1-frac, then ceil
    scatter (frac > 0.3) on top; validity = weight > 0.1."""
    B, C, H, W = image.shape
    src_y, src_x = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    disp = depth.squeeze() * max_disparity

    depth_flat = depth.squeeze().flatten()
    order = torch.argsort(depth_flat)
    y_s = src_y.flatten()[order]
    x_s = src_x.float().flatten()[order]
    d_s = disp.flatten()[order]
    image_flat = image.view(C, -1)

    def one_direction(ds):
        tgt = x_s + ds
        t0 = tgt.floor().long()
        frac = tgt - t0.float()
        warped = torch.zeros_like(image_flat)
        weight = torch.zeros(H * W)

        ok0 = (t0 >= 0) & (t0 < W)
        idx0 = (y_s * W + t0)[ok0]
        for c in range(C):
            warped[c].scatter_(0, idx0, image_flat[c, order[ok0]])
        weight.scatter_(0, idx0, (1.0 - frac)[ok0])

        t1 = t0 + 1
        ok1 = (t1 >= 0) & (t1 < W)
        idx1 = (y_s * W + t1)[ok1]
        w1 = frac[ok1]
        sig = w1 > 0.3
        for c in range(C):
            warped[c].scatter_(0, idx1[sig], image_flat[c, order[ok1][sig]])
        weight.scatter_(0, idx1[sig], w1[sig])

        return warped.view(B, C, H, W), (weight > 0.1).float().view(B, 1, H, W)

    lw, lm = one_direction(d_s)
    rw, rm = one_direction(-d_s)
    return lw, lm, rw, rm


def _to_torch(img: np.ndarray) -> torch.Tensor:
    if img.ndim == 2:
        return torch.from_numpy(img.astype(np.float32))[None, None]
    return torch.from_numpy(img.astype(np.float32)).permute(2, 0, 1)[None]


def _to_u8(t: torch.Tensor) -> np.ndarray:
    return t.squeeze(0).permute(1, 2, 0).clamp(0, 255).numpy().astype(np.uint8)


def _postprocess_view(warped: torch.Tensor, valid_mask: torch.Tensor,
                      smoothing: float) -> torch.Tensor:
    inpaint_mask = ((1 - valid_mask.squeeze(0)) * 255).permute(1, 2, 0)\
        .numpy().astype(np.uint8)
    if smoothing > 0:
        img_np = warped.squeeze().permute(1, 2, 0).numpy()
        img_np = img_np.astype(np.uint8) if img_np.max() > 1.0 \
            else (img_np * 255).astype(np.uint8)
        d = max(5, min(int(smoothing * 4), 15))
        filtered = cv2.bilateralFilter(img_np, d=d, sigmaColor=30,
                                       sigmaSpace=smoothing * 25)
        warped = torch.from_numpy(filtered).permute(2, 0, 1)[None].float()
    result = _to_u8(warped)
    if inpaint_mask.any():
        mask = cv2.dilate(inpaint_mask, np.ones((3, 3), np.uint8), iterations=1)
        result = cv2.inpaint(result, mask, inpaintRadius=3,
                             flags=cv2.INPAINT_TELEA)
    return _to_torch(result)


def process_frame(rgb: np.ndarray, depth: np.ndarray,
                  p: StereoParams) -> np.ndarray:
    """Reference process_frame semantics (stereo_core.py:225-311)."""
    H, W = rgb.shape[:2]
    total_buffer = 2.0 * p.max_disparity + abs(p.convergence)
    stretched_w = int(W * (1.0 + total_buffer / W))

    rgb_s = cv2.resize(rgb, (stretched_w, H), interpolation=cv2.INTER_LANCZOS4)
    depth_s = cv2.resize(depth, (stretched_w, H), interpolation=cv2.INTER_LANCZOS4)

    rgb_t = _to_torch(rgb_s)
    depth_t = _to_torch(depth_s)
    depth_n = normalize_depth(depth_t)

    if p.super_sampling > 1.0:
        nh = int(depth_n.shape[2] * p.super_sampling)
        nw = int(depth_n.shape[3] * p.super_sampling)
        depth_n = F.interpolate(depth_n, size=(nh, nw), mode="bilinear",
                                align_corners=False)
        rgb_t = F.interpolate(rgb_t, size=depth_n.shape[2:], mode="bilinear",
                              align_corners=False)

    if p.edge_softness > 0:
        k = max(5, min(int(p.edge_softness * 6) | 1, 31))
        depth_n = gaussian_blur2d(depth_n, k, p.edge_softness)

    if p.depth_gamma != 1.0:
        depth_n = torch.pow(depth_n.clamp(0.001, 1.0), p.depth_gamma)

    lw, lm, rw, rm = forward_warp_stereo(rgb_t, depth_n, p.max_disparity)
    left = _postprocess_view(lw, lm, p.artifact_smoothing)
    right = _postprocess_view(rw, rm, p.artifact_smoothing)

    base = (stretched_w - W) // 2
    shift = int(round(p.convergence))
    lo, ro = base + shift, base - shift

    def sharpen(img):
        blurred = gaussian_blur2d(img, 5, 1.0)
        return (img + p.sharpen * (img - blurred)).clamp(0, 255)

    if p.super_sampling > 1.0:
        up_w = left.shape[3]
        ratio = up_w / stretched_w
        lo_u, ro_u = int(lo * ratio), int(ro * ratio)
        w_u = int(W * ratio)
        left = left[:, :, :, lo_u:lo_u + w_u]
        right = right[:, :, :, ro_u:ro_u + w_u]
        if p.sharpen > 0:
            left, right = sharpen(left), sharpen(right)
        left = F.interpolate(left, size=(H, W), mode="area")
        right = F.interpolate(right, size=(H, W), mode="area")
    else:
        left = left[:, :, :, lo:lo + W]
        right = right[:, :, :, ro:ro + W]
        if p.sharpen > 0:
            left, right = sharpen(left), sharpen(right)

    return np.hstack([_to_u8(left), _to_u8(right)])


# ------------------------------------------------------------------- SSIM

def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Mean gaussian-windowed SSIM (the standard Wang et al. formulation,
    11x11 gaussian sigma=1.5, L=255), averaged over channels."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    k = cv2.getGaussianKernel(11, 1.5)
    win = (k @ k.T).astype(np.float64)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2

    def filt(x):
        return cv2.filter2D(x, -1, win, borderType=cv2.BORDER_REFLECT)

    vals = []
    for c in range(a.shape[2]):
        x, y = a[..., c], b[..., c]
        mx, my = filt(x), filt(y)
        mx2, my2, mxy = mx * mx, my * my, mx * my
        sx = filt(x * x) - mx2
        sy = filt(y * y) - my2
        sxy = filt(x * y) - mxy
        s = ((2 * mxy + c1) * (2 * sxy + c2)) / ((mx2 + my2 + c1) * (sx + sy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))
