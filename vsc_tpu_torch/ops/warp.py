"""
Forward stereo warp, gather formulation (PyTorch)
=================================================

Port of ``vsc_tpu/ops/warp.py``. Each output pixel gathers over the
disparity window of shifted source candidates and keeps the winner by the
priority key (ceil class 2 + z over floor class z, then nearest depth);
``take = key > best`` is strict, so the first shift in scan order wins a
tie. This is also the plain version of the warp kernel
(ops/warp_cuda.py).
"""

from __future__ import annotations

import math

import torch

__all__ = ["forward_warp_stereo"]


def forward_warp_stereo(image, depth, max_disparity: float):
    """Warp both eyes.

    Args:
      image: [B, H, W, C] float32.
      depth: [B, H, W] float32 in [0, 1] (normalized nearness).
      max_disparity: maximum disparity in pixels.

    Returns:
      (left, left_mask, right, right_mask): warped [B, H, W, C] images
      (raw source colors) and float32 masks [B, H, W] (1 where a source
      landed with weight > 0.1).
    """
    B, H, W, C = image.shape
    D = int(math.floor(max_disparity)) + 1
    P = D + 2
    F = torch.nn.functional

    disp = depth * max_disparity
    neg_inf = float("-inf")
    disp_p = F.pad(disp, (P, P))
    depth_p = F.pad(depth, (P, P))
    valid_p = F.pad(torch.ones_like(depth), (P, P))
    image_p = F.pad(image, (0, 0, P, P))

    def shifted(arr, s):
        if arr.ndim == 4:
            return arr[:, :, P - s: P - s + W, :]
        return arr[:, :, P - s: P - s + W]

    def warp_one(sign):
        best_key = torch.full((B, H, W), neg_inf, dtype=torch.float32,
                              device=image.device)
        best_img = torch.zeros_like(image)
        best_wgt = torch.zeros((B, H, W), dtype=torch.float32,
                               device=image.device)
        s_range = range(0, D + 2) if sign > 0 else range(-D, 2)
        for s in s_range:
            d_s = shifted(disp_p, s) * sign
            z_s = shifted(depth_p, s)
            v_s = shifted(valid_p, s)
            k = torch.floor(d_s)
            frac = d_s - k
            is_floor = (k == s) & (v_s > 0)
            is_ceil = (k == s - 1) & (frac > 0.3) & (v_s > 0)
            key = torch.where(is_ceil, 2.0 + z_s,
                              torch.where(is_floor, z_s, neg_inf))
            wgt = torch.where(is_ceil, frac, 1.0 - frac)
            take = key > best_key
            best_key = torch.where(take, key, best_key)
            best_wgt = torch.where(take, wgt, best_wgt)
            best_img = torch.where(take[..., None], shifted(image_p, s),
                                   best_img)
        mask = (best_wgt > 0.1) & (best_key > neg_inf)
        return best_img, mask.to(torch.float32)

    left, left_mask = warp_one(+1)
    right, right_mask = warp_one(-1)
    return left, left_mask, right, right_mask
