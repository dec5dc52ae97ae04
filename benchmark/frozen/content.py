"""
Synthetic frames and depth maps with real-video statistics
==========================================================

``bench_content`` is a frozen copy of ``vsc_tpu_torch/bench.py``'s recipe
as of commit 0b643e2 (the JAX package's bench content): smooth regions,
block edges and fine texture rather than noise, whose every pixel would be
a depth discontinuity, and a smooth scene-like depth map (a plane and
blocks).

``content_pool`` draws a pool of such frames for one seed, made on the
device in a few large calls: the seed sets the pattern's phase and the
texture, and frame i of the pool is the pattern panned by i * ``pan_px``
columns, as a camera pan moves a scene.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bench_content", "content_pool"]


def bench_content(H: int, W: int):
    """(frame [H, W, 3] u8, depth [H, W] u8), the bench's recipe."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 0.5 + 0.5 * np.sin(xx / 97.0) * np.cos(yy / 53.0)
    blocks = ((xx // 240).astype(int) % 3 == (yy // 135).astype(int) % 3)
    tex = rng.normal(0, 0.04, (H, W)).astype(np.float32)
    plane = np.clip(base * 0.6 + blocks * 0.3 + tex, 0, 1)
    frame = np.stack([plane, 0.8 * plane + 0.1, 1.0 - 0.7 * plane], -1)
    frame = (frame * 255).astype(np.uint8)
    d = 0.45 + 0.35 * np.sin(xx / 311.0) * np.cos(yy / 173.0) + blocks * 0.15
    depth = (np.clip(d, 0, 1) * 255).astype(np.uint8)
    return frame, depth


def _phase(seed: int) -> tuple[float, float]:
    """The pattern's offset (columns, rows) for ``seed``, any size of int."""
    rng = np.random.default_rng(abs(int(seed)))
    return float(rng.uniform(0, 4096)), float(rng.uniform(0, 4096))


@torch.no_grad()
def content_pool(n: int, H: int, W: int, seed: int, pan_px: float,
                 device) -> tuple[np.ndarray, np.ndarray]:
    """``n`` frames [n, H, W, 3] u8 and their depth [n, H, W] u8 as host
    numpy arrays: ``bench_content``'s formulas at the seed's phase, frame i
    panned by i * ``pan_px`` columns, the texture drawn from the seed."""
    px, py = _phase(seed)
    g = torch.Generator(device=device).manual_seed(abs(int(seed)) % 2**63)
    f32 = torch.float32
    xx = (torch.arange(W, device=device, dtype=f32)[None, None, :] + px
          + pan_px * torch.arange(n, device=device, dtype=f32)[:, None, None])
    yy = torch.arange(H, device=device, dtype=f32)[None, :, None] + py
    base = 0.5 + 0.5 * torch.sin(xx / 97.0) * torch.cos(yy / 53.0)
    blocks = (torch.floor(xx / 240.0) % 3 == torch.floor(yy / 135.0) % 3
              ).to(f32)
    tex = torch.randn((n, H, W), generator=g, device=device, dtype=f32) * 0.04
    plane = torch.clamp(base * 0.6 + blocks * 0.3 + tex, 0, 1)
    frame = torch.stack([plane, 0.8 * plane + 0.1, 1.0 - 0.7 * plane], -1)
    frame = (frame * 255).to(torch.uint8)
    d = 0.45 + 0.35 * torch.sin(xx / 311.0) * torch.cos(yy / 173.0) \
        + blocks * 0.15
    depth = (torch.clamp(d, 0, 1) * 255).to(torch.uint8)
    return frame.cpu().numpy(), depth.cpu().numpy()
