"""
Stub depth model (PyTorch)
==========================

Port of ``vsc_tpu/models/stub.py``: weight-free depth estimators with
DepthPro's contract ([B, S, S, 3] in [-1, 1] -> [B, S, S] nearness), for
CPU tests and runs without a model.
"""

from __future__ import annotations

import torch

__all__ = ["luminance_depth", "gradient_depth"]


def luminance_depth(images):
    """Brightness as nearness, lightly smoothed (5x5 box, zero padding)."""
    lum = (0.299 * images[..., 0] + 0.587 * images[..., 1]
           + 0.114 * images[..., 2])
    k = torch.full((1, 1, 5, 5), 1.0 / 25.0, dtype=lum.dtype,
                   device=lum.device)
    x = torch.nn.functional.conv2d(lum[:, None], k, padding=2)
    return (x[:, 0] + 1.0) * 0.5


def gradient_depth(images):
    """Synthetic top-far/bottom-near ramp: content-independent, for
    deterministic golden tests of the downstream stereo stages."""
    B, H, W, _ = images.shape
    # jnp.linspace as XLA compiles it: i * (1 / (H - 1)), the end exact
    ramp = torch.arange(H, dtype=torch.float32, device=images.device)
    if H > 1:
        ramp = ramp * (1.0 / (H - 1))
        ramp[-1] = 1.0
    return ramp[None, :, None].expand(B, H, W)
